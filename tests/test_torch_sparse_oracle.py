"""The voxel "oracle" engine and SecondRefEncoder, port vs JAX, on the CPU.

Seeded numpy clouds go through ``heal_tpu.ops.sparse_conv`` and
``heal_tpu_torch.ops.sparse_conv``, function for function: site sets,
keys, coordinates and tables EXACTLY (the INVALID padding, the dz-major
tap order and the sites' key order are JAX's bit for bit), features
within 1e-6 relative (f32). The port's oracle is held to the port's
column engine as tests/test_sparse_conv.py holds JAX's (same sites, the
conv values within 1e-5). ``models.second.SecondRefEncoder`` with
heal_tpu's variables bridged (utils/bridge.py, strictly) matches JAX's
within 1e-5 relative in eval mode (two samples) and in train mode (one
sample, against JAX's ``SecondRefStack``: JAX's vmapped encoder cannot
write per-sample statistics into its shared ones), the running
statistics included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.models import second as jax_second
from heal_tpu.ops import sparse_conv as jsc
from heal_tpu_torch.models.second import SecondRefEncoder
from heal_tpu_torch.ops import column_conv as cc
from heal_tpu_torch.ops import sparse_conv as sc
from heal_tpu_torch.utils.bridge import load_flax, to_flax

torch.set_num_threads(1)
RANGE = (0.0, 0.0, 0.0, 3.2, 3.2, 1.6)
VOXEL = (0.2, 0.2, 0.2)  # grid (8, 16, 16)
FEAT_TOL = 1e-6


def _cloud(seed: int, n: int = 700, dense: bool = True):
    """(n, 4) points, a share out of range, some duplicated voxels, and a
    mask with padding rows."""
    rng = np.random.default_rng(seed)
    hi = np.array(RANGE[3:]) * (1.0 if dense else 3.0)
    xyz = rng.uniform(-0.3, hi + 0.3, (n, 3))
    pts = np.concatenate([xyz, rng.uniform(0, 1, (n, 1))], 1)
    pts[n // 2:n // 2 + 40] = pts[:40] + 0.01  # voxels with several points
    mask = rng.uniform(size=n) < 0.9
    return pts.astype(np.float32), mask


def _both(seed: int, cap: int, dense: bool = True):
    pts, mask = _cloud(seed, dense=dense)
    got = sc.voxelize_points(torch.from_numpy(pts), torch.from_numpy(mask),
                             RANGE, VOXEL, cap)
    want = jsc.voxelize_points(jnp.asarray(pts), jnp.asarray(mask), RANGE,
                               VOXEL, cap)
    return got, want


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (1.0 + np.abs(want).max()))


def _same_sites(got: dict, want: dict):
    assert tuple(got["grid"]) == tuple(want["grid"])
    for k in ("keys", "coords", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _jax_sp(sp: dict) -> dict:
    return {k: (v if k == "grid" else jnp.asarray(v.numpy()))
            for k, v in sp.items()}


def test_offsets_and_taps_equal_heal_tpu():
    assert sc._offsets() == jsc._offsets()
    for kernel in ((3, 3, 3), (3, 1, 1), (1, 3, 2)):
        assert sc._taps(kernel) == jsc._taps(kernel)
    assert sc.INVALID == int(jsc.INVALID)


@pytest.mark.parametrize("cap,dense", [(512, True), (96, True),
                                       (256, False)])
def test_voxelize_points_equal_heal_tpu(cap, dense):
    got, want = _both(3, cap, dense)
    _same_sites(got, want)
    assert _rel(got["feats"].numpy(), want["feats"]) <= FEAT_TOL
    assert int(got["valid"].sum()) > 0


@pytest.mark.parametrize("cap", [256])
def test_tables_and_sites_equal_heal_tpu(cap):
    got, want = _both(4, cap)
    keys, coords, valid = got["keys"], got["coords"], got["valid"]
    np.testing.assert_array_equal(
        sc.neighbor_table(got).numpy(), np.asarray(jsc.neighbor_table(want)))
    for off in ((0, 0, 0), (-1, 1, 0), (1, -1, 1)):
        g, f = sc.gather_neighbor(keys, coords, valid, got["grid"], off)
        jg, jf = jsc.gather_neighbor(want["keys"], want["coords"],
                                     want["valid"], want["grid"], off)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    q = torch.from_numpy(np.random.default_rng(0).integers(
        -5, 3000, 200).astype(np.int32))
    ok = q % 3 != 0
    np.testing.assert_array_equal(
        sc._lookup_batched(keys, q, ok).numpy(),
        np.asarray(jsc._lookup_batched(want["keys"], jnp.asarray(q.numpy()),
                                       jnp.asarray(ok.numpy()))))
    for pad in ((1, 1, 1), (0, 1, 1)):
        out = sc.downsample_sites(got, 2 * cap, padding=pad)
        jout = jsc.downsample_sites(want, 2 * cap, padding=pad)
        _same_sites(out, jout)
        np.testing.assert_array_equal(
            sc.strided_table(got, out, padding=pad).numpy(),
            np.asarray(jsc.strided_table(want, jout, padding=pad)))
    for geo in (((3, 1, 1), (2, 1, 1), (0, 0, 0)),
                ((3, 3, 3), (2, 2, 2), (0, 1, 1)),
                ((2, 3, 1), (1, 2, 1), (0, 1, 0))):
        out = sc.downsample_sites_nd(got, 2 * cap, *geo)
        jout = jsc.downsample_sites_nd(want, 2 * cap, *geo)
        _same_sites(out, jout)
        np.testing.assert_array_equal(
            sc.strided_table_nd(got, out, *geo).numpy(),
            np.asarray(jsc.strided_table_nd(want, jout, *geo)))


def test_convs_and_bev_equal_heal_tpu():
    got, _ = _both(5, 400)
    want = _jax_sp(got)  # the same sites and features on both sides
    rng = np.random.default_rng(9)
    w = rng.normal(0, 0.5, (27, 4, 6)).astype(np.float32)
    bias = rng.normal(0, 0.1, 6).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    tb, jb = torch.from_numpy(bias), jnp.asarray(bias)
    o = sc.subm_conv(got, tw, tb)
    assert _rel(o.numpy(), jsc.subm_conv(want, jw, jb)) <= FEAT_TOL
    t = sc.neighbor_table(got)
    assert _rel(sc.apply_table_conv(got["feats"], t, tw, got["valid"]).numpy(),
                jsc.apply_table_conv(want["feats"], jnp.asarray(t.numpy()),
                                     jw, want["valid"])) <= FEAT_TOL
    sites = sc.downsample_sites(got, 800)
    jsites = _jax_sp(sites)
    o2 = sc.strided_conv(got, sites, tw, tb)
    assert _rel(o2.numpy(),
                jsc.strided_conv(want, jsites, jw, jb)) <= FEAT_TOL
    assert _rel(sc.to_dense_bev(sites, o2).numpy(),
                jsc.to_dense_bev(jsites, jnp.asarray(o2.numpy()))) <= FEAT_TOL
    geo = ((3, 1, 1), (2, 1, 1), (0, 0, 0))
    w3 = rng.normal(0, 0.5, (3, 4, 5)).astype(np.float32)
    out = sc.downsample_sites_nd(got, 800, *geo)
    o3 = sc.strided_conv_nd(got, out, torch.from_numpy(w3), *geo)
    assert _rel(o3.numpy(), jsc.strided_conv_nd(
        want, _jax_sp(out), jnp.asarray(w3), *geo)) <= FEAT_TOL
    assert float(o3.abs().max()) > 0


def _dense_cols(cols, feats):
    d, h, w = cols["grid"]
    dense = np.zeros((d, h, w, feats.shape[-1]), np.float32)
    ck, occ = cols["ckeys"][0].numpy(), cols["occ"][0].numpy()
    f = feats[0].numpy()
    for i in np.flatnonzero(cols["cvalid"][0].numpy()):
        for z in np.flatnonzero(occ[i]):
            dense[z, ck[i] // w, ck[i] % w] = f[i, z]
    return dense


def _dense_sites(sp, feats):
    dense = np.zeros(tuple(sp["grid"]) + (feats.shape[-1],), np.float32)
    c = sp["coords"][sp["valid"]].numpy()
    dense[c[:, 0], c[:, 1], c[:, 2]] = feats[sp["valid"]].numpy()
    return dense


def test_oracle_matches_the_column_engine():
    pts, mask = _cloud(6)
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    sp = sc.voxelize_points(tp, tm, RANGE, VOXEL, 1024)
    cols = cc.voxelize_columns(tp[None], tm[None], RANGE, VOXEL, 256)
    assert int(cols["occ"].sum()) == int(sp["valid"].sum())
    np.testing.assert_allclose(_dense_cols(cols, cols["feats"]),
                               _dense_sites(sp, sp["feats"]), atol=1e-6)
    gen = torch.Generator().manual_seed(7)
    w = 0.5 * torch.randn((27, 4, 6), generator=gen)
    np.testing.assert_allclose(
        _dense_cols(cols, cc.subm_conv(cols, w)),
        _dense_sites(sp, sc.subm_conv(sp, w)), rtol=1e-5, atol=1e-5)
    w2 = 0.5 * torch.randn((27, 4, 5), generator=gen)
    sites = sc.downsample_sites(sp, 1024)
    cols2 = cc.strided_conv(cols, cc.downsample_columns(cols, 256), w2)
    assert tuple(cols2["grid"]) == tuple(sites["grid"])
    o = sc.strided_conv(sp, sites, w2)
    w_out = cols2["grid"][2]
    ck, occ = cols2["ckeys"][0].tolist(), cols2["occ"][0]
    cset = {(z, ck[i] // w_out, ck[i] % w_out)
            for i in torch.nonzero(cols2["cvalid"][0]).flatten().tolist()
            for z in torch.nonzero(occ[i]).flatten().tolist()}
    assert cset == {tuple(r) for r in
                    sites["coords"][sites["valid"]].tolist()}
    np.testing.assert_allclose(_dense_cols(cols2, cols2["feats"]),
                               _dense_sites(sites, o), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cc.to_dense_bev(cols2)[0].numpy(),
                               sc.to_dense_bev(sites, o).numpy(), rtol=1e-5,
                               atol=1e-5)


REF_RANGE = (-8.0, -3.2, -3.0, 8.0, 3.2, 1.0)
REF_VOXEL = (0.4, 0.4, 4.0 / 24)  # nx 40, ny 16, nz 24 (+1)
REF_CAPS = (512, 2304, 512, 64, 16)


def _ref_points(b: int, n: int = 300):
    rng = np.random.default_rng(12)
    lo, hi = np.array(REF_RANGE[:3]), np.array(REF_RANGE[3:])
    xyz = rng.uniform(lo, hi, (b, n, 3))
    pts = np.concatenate([xyz, rng.uniform(0, 1, (b, n, 1))], -1)
    mask = rng.uniform(size=(b, n)) < 0.95
    return pts.astype(np.float32), mask


@pytest.fixture(scope="module")
def ref_variables():
    pts, mask = _ref_points(2)
    jm = jax_second.SecondRefEncoder(voxel_size=REF_VOXEL,
                                     lidar_range=REF_RANGE,
                                     max_voxels=REF_CAPS)
    v = jax.device_get(jax.jit(lambda p, m: jm.init(
        jax.random.PRNGKey(0), p, m, train=False))(pts, mask))
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape) if p[-1].key == "var"
                      else rng.uniform(-0.1, 0.1, s.shape)).astype(
                          np.float32), v["batch_stats"])
    return jm, v["params"], stats


def test_second_ref_encoder_eval_matches_jax(ref_variables):
    jm, params, stats = ref_variables
    pts, mask = _ref_points(2)
    want = np.asarray(jax.jit(lambda p, m: jm.apply(
        {"params": params, "batch_stats": stats}, p, m, train=False))(
            pts, mask))
    tm = load_flax(SecondRefEncoder(REF_VOXEL, REF_RANGE, REF_CAPS),
                   params, stats).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape and want.shape[0] == 2
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-5


def test_second_ref_encoder_train_matches_jax(ref_variables):
    jm, params, stats = ref_variables
    pts, mask = _ref_points(1)
    stack = jax_second.SecondRefStack(lidar_range=REF_RANGE,
                                      voxel_size=REF_VOXEL,
                                      max_voxels=REF_CAPS)
    (name,) = params
    want, upd = jax.jit(lambda p, m: stack.apply(
        {"params": params[name], "batch_stats": stats[name]}, p, m,
        train=True, mutable=["batch_stats"]))(pts[0], mask[0])
    tm = load_flax(SecondRefEncoder(REF_VOXEL, REF_RANGE, REF_CAPS),
                   params, stats).train()
    got = tm(torch.from_numpy(pts), torch.from_numpy(mask))
    assert np.abs(np.asarray(want)).max() > 0
    assert _rel(got[0].detach().numpy(), want) <= 1e-5
    _, new_stats = to_flax(tm.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(upd["batch_stats"])
    assert len(flat) == 2 * 12  # mean and var of the 12 layers
    for path, leaf in flat:
        node = new_stats[name]
        for p in path:
            node = node[p.key]
        assert _rel(node, leaf) <= 1e-5
    got.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in tm.parameters())
