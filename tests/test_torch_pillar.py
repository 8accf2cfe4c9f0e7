"""Kernel 1 (pillar tables) and the PointPillars encoder: port vs JAX.

The port runs on CPU torch, where ``pillar_tables`` takes its plain
version. References: the Pallas kernel in interpret mode (the cases of
tests/test_pallas_pillar.py) and the JAX encoder with and without
HEAL_TPU_FORCE_PALLAS=1 (Pallas interpret vs the XLA fused path).
Tolerance 2e-5 relative and absolute, as test_pallas_pillar.py states
for its kernel: f32 sums in a different order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.models.encoders import PointPillarEncoder as JaxEncoder
from heal_tpu.ops import pallas_pillar as pp
from heal_tpu_torch.models.encoders import PointPillarEncoder
from heal_tpu_torch.ops.pillar import (
    PillarGrid,
    pillar_rows_plain,
    pillar_tables,
)
from heal_tpu_torch.utils.bridge import load_flax

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _case_inputs(fi, u, g4, w1, w2, b_aff, nx, vx, vy, geom0, stride, cells,
                 canvas_space):
    """Pad to P_BLOCK and build the Pallas kernel's inputs, as
    test_pallas_pillar.py does (table-space cells, or the encoder's
    canvas-space convention)."""
    f = u.shape[1]
    s_total = (int(fi.max()) // cells + 1) * cells
    npad = -len(fi) % pp.P_BLOCK
    fi_p = np.concatenate([fi, np.full(npad, s_total, np.int32)])
    u_p = np.pad(u, ((0, npad), (0, 0)))
    g4_p = np.pad(g4, ((0, npad), (0, 0)))
    prev = np.concatenate([fi_p[:1] - 1, fi_p[:-1]])
    cidx = (np.cumsum(fi_p != prev) - 1).astype(np.int32)
    nxt = np.concatenate([fi_p[1:], fi_p[-1:] + 1])
    ends = (fi_p != nxt).astype(np.int32)
    samp = fi_p // cells
    cellf = (fi_p - samp).astype(np.float32) if canvas_space else (
        fi_p.astype(np.float32))
    geom = np.zeros(f, np.float32)
    geom[:8] = [vx, vy, geom0[0], geom0[1], geom0[2], float(nx),
                float(stride), 0.0]
    consts = np.concatenate(
        [w1, w2, b_aff[None], geom[None]], 0).astype(np.float32)
    return fi_p, u_p, g4_p, cidx, ends, cellf, samp.astype(np.float32), consts


def _check_rows_and_canvas(fi, u, g4, w1, w2, b_aff, nx, vx, vy, geom0,
                           stride, cells, batch, canvas_space):
    fi_p, u_p, g4_p, cidx, ends, cellf, sampf, consts = _case_inputs(
        fi, u, g4, w1, w2, b_aff, nx, vx, vy, geom0, stride, cells,
        canvas_space)
    vals, cells_tab = pp.pillar_tables(
        jnp.asarray(u_p), jnp.asarray(g4_p), jnp.asarray(cidx),
        jnp.asarray(ends), jnp.asarray(cellf), jnp.asarray(sampf),
        jnp.asarray(consts), interpret=True,
    )
    t = torch.from_numpy
    got_vals, got_cells = pillar_rows_plain(
        t(u_p), t(g4_p), t(cidx), t(ends), t(cellf), t(sampf), t(consts))
    np.testing.assert_array_equal(got_cells.numpy(), np.asarray(cells_tab))
    np.testing.assert_allclose(got_vals.numpy(), np.asarray(vals), **TOL)

    # the port's canvas (one row per pillar) against the Pallas rows
    # expanded the way the JAX encoder does (sorted scatter-add, drop)
    n_rows = batch * stride
    want = jnp.zeros((n_rows, u.shape[1]), jnp.float32).at[
        np.asarray(cells_tab)[:, 0]].add(
            vals.astype(jnp.float32), indices_are_sorted=True, mode="drop")
    grid = PillarGrid(nx=nx, stride=stride, cells=cells, vx=vx, vy=vy,
                      cx0=geom0[0], cy0=geom0[1], cz=geom0[2])
    canvas = pillar_tables(t(u_p), t(g4_p), t(fi_p.astype(np.int32)),
                           t(consts[:7]), grid, batch)
    assert canvas.shape == (n_rows, u.shape[1])
    np.testing.assert_allclose(canvas.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seed,n_pts,f,cells_hw", [
    (0, 2048, 64, (32, 16)),
    (1, 1536 + 512, 64, (8, 8)),   # dense runs: few cells, long runs
    (2, 512, 128, (64, 32)),       # single block
])
def test_rows_match_pallas_interpret(seed, n_pts, f, cells_hw):
    nx, ny = cells_hw
    cells = nx * ny + 1
    b = 2
    rng = np.random.RandomState(seed)
    ids = np.sort(rng.randint(0, cells, n_pts // b * b).reshape(b, -1), 1)
    fi = (ids + np.arange(b)[:, None] * cells).reshape(-1).astype(np.int32)
    u = rng.randn(len(fi), f).astype(np.float32)
    g4 = np.concatenate(
        [rng.randn(len(fi), 3).astype(np.float32),
         (rng.rand(len(fi), 1) > 0.2).astype(np.float32)], axis=1)
    w1 = rng.randn(3, f).astype(np.float32)
    w2 = rng.randn(3, f).astype(np.float32)
    b_aff = rng.randn(f).astype(np.float32)
    # table-space convention of test_pallas_pillar.run_kernel: the stride
    # lane is `cells`, so no bucket is suppressed and the canvas is the
    # whole (b * cells)-row table
    _check_rows_and_canvas(fi, u, g4, w1, w2, b_aff, nx, 0.4, 0.4,
                           (0.2, 0.2, -1.0), cells, cells, b, False)


def test_canvas_space_drop_bucket_suppression():
    f = 64
    nx, ny = 16, 8
    stride = nx * ny
    cells = stride + 1
    b = 2
    rng = np.random.RandomState(3)
    n_real = 2 * pp.P_BLOCK - 37  # forces sentinel padding
    ids = rng.randint(0, cells, n_real // b * b)
    ids[:3] = 0
    ids[3:6] = stride
    ids = np.sort(ids.reshape(b, -1), 1)
    fi = (ids + np.arange(b)[:, None] * cells).reshape(-1).astype(np.int32)
    n = len(fi)
    u = rng.randn(n, f).astype(np.float32)
    g4 = np.concatenate(
        [rng.randn(n, 3).astype(np.float32), np.ones((n, 1), np.float32)], 1)
    w1 = rng.randn(3, f).astype(np.float32)
    w2 = rng.randn(3, f).astype(np.float32)
    b_aff = rng.randn(f).astype(np.float32)
    _check_rows_and_canvas(fi, u, g4, w1, w2, b_aff, nx, 0.4, 0.4,
                           (0.2, 0.2, -1.0), stride, cells, b, True)


def test_run_spanning_many_blocks():
    f = 64
    pb = pp.P_BLOCK
    n = 4 * pb
    rng = np.random.RandomState(0)
    fi = np.concatenate([
        np.full(3 * pb + 17, 5, np.int32),
        np.sort(rng.randint(6, 200, n - 3 * pb - 17)),
    ]).astype(np.int32)
    u = rng.randn(n, f).astype(np.float32)
    g4 = np.concatenate(
        [rng.randn(n, 3).astype(np.float32), np.ones((n, 1), np.float32)], 1)
    z3 = np.zeros((3, f), np.float32)
    _check_rows_and_canvas(fi, u, g4, z3, z3, np.zeros(f, np.float32), 256,
                           1.0, 1.0, (0.0, 0.0, 0.0), 257, 257, 1, False)


def _points(seed, b, n, lidar_range, voxel, presort):
    """Seeded points, a few outside the range and some masked out; with
    ``presort`` ordered per sample by pillar id as the host assembler
    orders them (drop-bucket points last)."""
    rng = np.random.RandomState(seed)
    x0, y0, z0, x1, y1, z1 = lidar_range
    pts = np.stack([
        rng.uniform(x0 - 1, x1 + 1, (b, n)),
        rng.uniform(y0 - 1, y1 + 1, (b, n)),
        rng.uniform(z0 - 0.5, z1 + 0.5, (b, n)),
        rng.uniform(0, 1, (b, n)),
    ], -1).astype(np.float32)
    mask = rng.rand(b, n) > 0.1
    # clusters: several points per pillar
    pts[:, : n // 2, :2] = pts[:, : n // 4, :2].repeat(2, axis=1) + 0.01
    if presort:
        nx = int(round((x1 - x0) / voxel[0]))
        ny = int(round((y1 - y0) / voxel[1]))
        for i in range(b):
            xi = np.floor((pts[i, :, 0] - x0) / voxel[0]).astype(np.int64)
            yi = np.floor((pts[i, :, 1] - y0) / voxel[1]).astype(np.int64)
            ok = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
                  & (pts[i, :, 2] >= z0) & (pts[i, :, 2] <= z1) & mask[i])
            ids = np.where(ok, yi * nx + xi, nx * ny)
            order = np.argsort(ids, kind="stable")
            pts[i], mask[i] = pts[i, order], mask[i, order]
    return pts, mask


@pytest.mark.parametrize("force_pallas", [False, True])
@pytest.mark.parametrize("presorted", [False, True])
def test_encoder_canvas_matches_jax(monkeypatch, force_pallas, presorted):
    if force_pallas:
        monkeypatch.setenv("HEAL_TPU_FORCE_PALLAS", "1")
    else:
        monkeypatch.delenv("HEAL_TPU_FORCE_PALLAS", raising=False)
    lidar_range = (-9.6, -6.4, -3.0, 9.6, 6.4, 1.0)
    voxel = (0.8, 0.8, 4.0)
    pts, mask = _points(7, 2, 700, lidar_range, voxel, presorted)
    jenc = JaxEncoder(voxel_size=voxel, lidar_range=lidar_range,
                      num_filters=(16,), presorted=presorted)
    v = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                                 jnp.asarray(mask)))
    rng = np.random.RandomState(1)
    params = dict(v["params"])
    params["bn_scale"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    params["bn_bias"] = rng.uniform(-0.3, 0.3, 16).astype(np.float32)
    stats = {"bn_mean": rng.uniform(-0.3, 0.3, 16).astype(np.float32),
             "bn_var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    want = np.asarray(jenc.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(pts), jnp.asarray(mask)))

    enc = PointPillarEncoder(voxel, lidar_range, (16,),
                             presorted=presorted).eval()
    load_flax(enc, params, stats)
    with torch.no_grad():
        got = enc(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 16)
    assert (want != 0).any(axis=-1).sum() > 50  # many pillars filled
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
