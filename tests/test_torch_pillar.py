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
from heal_tpu_torch.kernels.cases import dense_counts, dense_inputs
from heal_tpu_torch.models.encoders import PointPillarEncoder
from heal_tpu_torch.ops.pillar import (
    PillarGrid,
    pillar_rows_plain,
    pillar_tables,
    pillar_work,
)
from heal_tpu_torch.utils.bridge import load_flax
from torch_pillar_cases import CASES, make_case

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _case_inputs(fi, u, g4, w1, w2, b_aff, nx, vx, vy, geom0, stride, cells,
                 batch, canvas_space):
    """Pad to P_BLOCK (a whole block of sentinels when there are no
    points) and build the Pallas kernel's inputs, as test_pallas_pillar.py
    does (table-space cells, or the encoder's canvas-space convention)."""
    f = u.shape[1]
    # sentinels sort after every id, the case's own past-the-end ones too
    s_total = max(batch * cells, int(fi.max()) + 1 if len(fi) else 0)
    npad = -len(fi) % pp.P_BLOCK or (pp.P_BLOCK if len(fi) == 0 else 0)
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
        fi, u, g4, w1, w2, b_aff, nx, vx, vy, geom0, stride, cells, batch,
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


@pytest.mark.parametrize("name", CASES)
def test_edge_cases_match_pallas_interpret(name):
    """The shared edge cases (tests/torch_pillar_cases.py; the card's
    tests run the same ones through the CUDA kernel): rows against the
    Pallas kernel in interpret mode, and the canvas against its rows
    expanded as the JAX encoder expands them."""
    c = make_case(name)
    stride = c["nx"] * c["ny"]
    _check_rows_and_canvas(c["fi"], c["u"], c["g4"], c["w1"], c["w2"],
                           c["b_aff"], c["nx"], c["vx"], c["vy"], c["geom0"],
                           stride, stride + 1, c["batch"], True)


def _points(seed, b, n, lidar_range, voxel, presort, masked=(), outside=()):
    """Seeded points, a few outside the range and some masked out; with
    ``presort`` ordered per sample by pillar id as the host assembler
    orders them (drop-bucket points last). Samples in ``masked`` are all
    padding (mask False); those in ``outside`` lie wholly beyond x1."""
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
    for i in masked:
        mask[i] = False
    for i in outside:
        pts[i, :, 0] = x1 + 1 + rng.uniform(0, 3, n)
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


def _encoders(pts, mask, lidar_range, voxel, f, presorted):
    """The JAX encoder's and the port's canvases on the same points, with
    the same seeded BN affine and statistics."""
    jenc = JaxEncoder(voxel_size=voxel, lidar_range=lidar_range,
                      num_filters=(f,), presorted=presorted)
    v = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                                 jnp.asarray(mask)))
    rng = np.random.RandomState(1)
    params = dict(v["params"])
    params["bn_scale"] = rng.uniform(0.5, 1.5, f).astype(np.float32)
    params["bn_bias"] = rng.uniform(-0.3, 0.3, f).astype(np.float32)
    stats = {"bn_mean": rng.uniform(-0.3, 0.3, f).astype(np.float32),
             "bn_var": rng.uniform(0.5, 1.5, f).astype(np.float32)}
    want = np.asarray(jenc.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(pts), jnp.asarray(mask)))

    enc = PointPillarEncoder(voxel, lidar_range, (f,),
                             presorted=presorted).eval()
    load_flax(enc, params, stats)
    with torch.no_grad():
        got = enc(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    return got, want


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
    got, want = _encoders(pts, mask, lidar_range, voxel, 16, presorted)
    assert got.shape == want.shape == (2, 16, 24, 16)
    assert (want != 0).any(axis=-1).sum() > 50  # many pillars filled
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,lidar_range,batch,f,masked,outside", [
    # a 13 x 7 grid: the card's 256-row tiles span several samples
    ("straddle", (-5.2, -2.8, -3.0, 5.2, 2.8, 1.0), 3, 16, (), ()),
    ("padding_slot", (-9.6, -6.4, -3.0, 9.6, 6.4, 1.0), 3, 16, (1,), ()),
    ("all_drop_slot", (-9.6, -6.4, -3.0, 9.6, 6.4, 1.0), 3, 16, (), (1,)),
    ("f10", (-9.6, -6.4, -3.0, 9.6, 6.4, 1.0), 2, 10, (), ()),
])
def test_encoder_edge_canvas_matches_pallas(monkeypatch, name, lidar_range,
                                            batch, f, masked, outside):
    """The eval encoder on the edge cases of a served frame, against the
    JAX encoder through its Pallas kernel (interpret mode)."""
    monkeypatch.setenv("HEAL_TPU_FORCE_PALLAS", "1")
    voxel = (0.8, 0.8, 4.0)
    pts, mask = _points(11, batch, 500, lidar_range, voxel, True, masked,
                        outside)
    got, want = _encoders(pts, mask, lidar_range, voxel, f, True)
    nx = int(round((lidar_range[3] - lidar_range[0]) / voxel[0]))
    ny = int(round((lidar_range[4] - lidar_range[1]) / voxel[1]))
    assert got.shape == want.shape == (batch, ny, nx, f)
    for i in (*masked, *outside):
        assert not want[i].any()  # no point lands: an all-zero canvas
    assert (want != 0).any(axis=-1).sum() > 30
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("points,pillars,most", [
    (30000, 20000, 32),  # the measured dense frame's density
    (500, 100, 8),
    (64, 64, 1),
])
def test_dense_counts_hold_their_totals(points, pillars, most):
    """The dense measurement case (heal_tpu_torch/kernels/cases.py): every
    point real, every pillar 1 to ``most`` points."""
    counts = dense_counts(np.random.default_rng(0), points, pillars, most)
    assert counts.shape == (pillars,) and counts.sum() == points
    assert counts.min() >= 1 and counts.max() <= most


def test_dense_inputs_and_pillar_work():
    """Sorted ids, one run per pillar, and the work of the function: the
    landed points, the weights and the canvas once; the earlier count
    also read the points that land nowhere."""
    grid = PillarGrid(16, 128, 129, 0.4, 0.4, 0.2, 0.2, -1.0)
    u, g4, fi, w, grid, b = dense_inputs(grid, 2, 8, torch.float32, "cpu",
                                         points=300, pillars=100)
    assert fi.dtype == torch.int32 and (fi[1:] >= fi[:-1]).all()
    assert u.shape == (600, 8) and g4.shape == (600, 4)
    work = pillar_work((u, g4, fi, w, grid, b))
    assert work["landed"] == 600 and work["runs"] == 200
    canvas = 2 * 128 * 8 * 4
    assert work["bytes"] == work["bytes_all"] == 600 * (32 + 20) + 224 + canvas
    # the same frame with 50 points in a drop bucket and 10 past the end
    fi2 = torch.cat([fi, torch.full((50,), 128, dtype=torch.int32),
                     torch.full((10,), 2 * 129, dtype=torch.int32)])
    fi2 = torch.sort(fi2).values
    u2, g42 = torch.zeros((660, 8)), torch.zeros((660, 4))
    work2 = pillar_work((u2, g42, fi2, w, grid, b))
    assert work2["landed"] == 600 and work2["runs"] == 200
    assert work2["bytes"] == work["bytes"]
    assert work2["bytes_all"] == work["bytes"] + 60 * (32 + 20)
