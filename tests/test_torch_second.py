"""The SECOND encoder's column engine and stack, port vs JAX, on the CPU.

Every function of heal_tpu/ops/column_conv.py against its counterpart in
heal_tpu_torch/ops/column_conv.py, on seeded numpy inputs at a tiny grid:
the port takes two agents at once (a leading agent axis), JAX one at a
time under ``jax.vmap``, as its encoder runs them. Stated tolerances:

  * integer outputs (``ckeys``, ``coords2``, ``cvalid``, ``occ``, the rank
    map's cells ``dmap[:, :H*W]`` and both tables) exactly equal; the
    rank map's dump slot H*W takes every invalid column's write, and
    nothing reads it, so it is not compared;
  * f32 outputs within 1e-5 of 1 + max |JAX| (max |d| / (1 + max |ref|)):
    the segment sums and products add in another order;
  * bf16 within 1e-2 of 1 + max |JAX|: the compute dtype rounds the
    running sum of the nine partial products, in both.

Cases: presorted and unsorted points; more active columns than
``max_cols`` and output columns than ``max_out`` (the same columns are
dropped); a presorted agent whose points are out of order (a straggler
merges into the voxel before it) and with an out-of-range point at the
grid's far edge amid them (the running max saturates at INVALID and
drops every later point, ADVICE r5's account of ``column_conv.py:102``).
``SecondEncoder`` with weights bridged from a JAX init: f32, bf16 (the
f32 ``conv_input`` included) and ``dense_tail``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.models.second import SecondEncoder as JaxSecondEncoder
from heal_tpu.ops import column_conv as jcc
from heal_tpu.ops import sparse_conv as jsc
from heal_tpu_torch.models.second import SecondEncoder
from heal_tpu_torch.ops import column_conv as cc
from heal_tpu_torch.ops import sparse_conv as sc
from heal_tpu_torch.utils.bridge import load_flax

torch.set_num_threads(1)
RANGE = (-4.8, -4.8, -3.0, 4.8, 4.8, 1.0)
VOXEL = (0.3, 0.3, 0.5)  # a (Z, H, W) = (8, 32, 32) grid
GRID = (8, 32, 32)
N_POINTS = 600
INT_KEYS = ("ckeys", "coords2", "cvalid", "occ")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (1.0 + np.abs(want).max()))


def _points(seed, n=N_POINTS):
    """Two agents' points: clusters (several points a voxel), uniform
    scatter, and points past the range; agent 1 pads its last third."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array(RANGE[:3]), np.array(RANGE[3:])
    pts = np.zeros((2, n, 4), np.float32)
    for a in range(2):
        centers = rng.uniform(lo, hi, (n // 6, 3))
        cl = centers[rng.integers(0, len(centers), n // 2)] + rng.normal(
            0, 0.08, (n // 2, 3))
        far = rng.uniform(lo - 0.6, hi + 0.6, (n - n // 2, 3))
        pts[a, :, :3] = np.concatenate([cl, far])
        pts[a, :, 3] = rng.uniform(0, 1, n)
    mask = np.ones((2, n), bool)
    mask[1, 2 * n // 3:] = False
    return pts, mask


def _host_sorted(pts):
    """Each agent's points by the full voxel key, as data/scene.py
    ``_presort_voxel`` orders them (out of range last)."""
    nz, ny, nx = GRID
    out = pts.copy()
    for a in range(len(pts)):
        p = pts[a]
        idx = [np.floor((p[:, i] - RANGE[i]) / VOXEL[i]).astype(np.int64)
               for i in range(3)]
        ok = ((idx[0] >= 0) & (idx[0] < nx) & (idx[1] >= 0) & (idx[1] < ny)
              & (idx[2] >= 0) & (idx[2] < nz))
        key = np.where(ok, (idx[1] * nx + idx[0]) * nz + idx[2], 2**31 - 1)
        out[a] = p[np.argsort(key, kind="stable")]
    return out


def _jax_voxelize(pts, mask, max_cols, presorted):
    fn = jax.vmap(lambda p, m: {
        k: v for k, v in jcc.voxelize_columns(
            p, m, RANGE, VOXEL, max_cols, presorted=presorted).items()
        if k != "grid"})
    return jax.device_get(jax.jit(fn)(jnp.asarray(pts), jnp.asarray(mask)))


def _port_voxelize(pts, mask, max_cols, presorted):
    return cc.voxelize_columns(torch.from_numpy(pts), torch.from_numpy(mask),
                               RANGE, VOXEL, max_cols, presorted=presorted)


def _same_cols(got, want, keys=INT_KEYS):
    for k in keys:
        assert got[k].dtype == (torch.bool if want[k].dtype == bool
                                else torch.int32), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def _jax_cols(cols):
    """The port's cols as JAX's per-agent arrays (stacked on axis 0)."""
    return {k: jnp.asarray(v.numpy()) for k, v in cols.items()
            if k != "grid"}


def _vmapped(fn, *trees):
    return jax.device_get(jax.jit(jax.vmap(fn))(*trees))


# ------------------------------------------------------------ voxelize
@pytest.mark.parametrize("presorted", [False, True], ids=["sorted_on_device",
                                                          "presorted"])
@pytest.mark.parametrize("max_cols", [512, 40], ids=["room", "overflow"])
def test_voxelize_columns_matches_jax(presorted, max_cols):
    pts, mask = _points(0)
    if presorted:
        pts = _host_sorted(pts)
    got = _port_voxelize(pts, mask, max_cols, presorted)
    want = _jax_voxelize(pts, mask, max_cols, presorted)
    assert got["grid"] == GRID
    _same_cols(got, want)
    assert got["feats"].shape == (2, max_cols, GRID[0], 4)
    assert _rel(got["feats"].numpy(), want["feats"]) <= 1e-5
    active = got["cvalid"].sum(1)
    if max_cols == 40:  # overflow: the first 40 columns of each agent
        assert active.tolist() == [40, 40]
    else:
        assert (active > 100).all() and (active < max_cols).all()
    # a voxel mean of several points
    assert (got["occ"].sum() < mask.sum())


def test_presorted_stragglers_and_saturation_match_jax():
    """A presorted agent whose order is broken twice: two points of
    different voxels swapped (the running max merges the straggler into
    the voxel before it), and, in agent 1, an out-of-range point at the
    far x edge (x = x1 bins to nx) placed two thirds in: every later point
    of that agent is dropped. Both packages drop the same points."""
    pts, mask = _points(1)
    mask[:] = True
    pts = _host_sorted(pts)
    good = _port_voxelize(pts, mask, 512, True)
    inside = int(good["occ"][0].sum())
    pts[0, [100, 101]] = pts[0, [101, 100]]
    k = 2 * N_POINTS // 5
    pts[1, k] = [RANGE[3], 0.1, -1.0, 0.5]
    got = _port_voxelize(pts, mask, 512, True)
    want = _jax_voxelize(pts, mask, 512, True)
    _same_cols(got, want)
    assert _rel(got["feats"].numpy(), want["feats"]) <= 1e-5
    unsorted = _port_voxelize(pts, mask, 512, False)
    assert int(got["occ"][1].sum()) < int(unsorted["occ"][1].sum())
    assert int(got["occ"][0].sum()) <= inside


# --------------------------------------------------- rank map and tables
@pytest.fixture(scope="module")
def level0():
    pts, mask = _points(2)
    return _port_voxelize(pts, mask, 512, False)


def test_rank_map_and_column_table_match_jax(level0):
    h, w = GRID[1:]
    dmap = cc.rank_map(level0)
    want = _vmapped(lambda c: jcc.rank_map(dict(c, grid=GRID)),
                    _jax_cols(level0))
    assert dmap.shape == (2, h * w + 1) and dmap.dtype == torch.int32
    np.testing.assert_array_equal(dmap[:, :h * w].numpy(), want[:, :h * w])
    table = cc.column_table(level0, dmap=dmap)
    want_t = _vmapped(lambda c: jcc.column_table(dict(c, grid=GRID)),
                      _jax_cols(level0))
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), want_t)
    np.testing.assert_array_equal(cc.column_table(level0).numpy(), want_t)
    assert (table[..., 4] < 512).sum() == level0["cvalid"].sum()  # itself
    assert (table < 512).sum() > level0["cvalid"].sum() * 2  # neighbours


@pytest.mark.parametrize("max_out", [256, 30], ids=["room", "overflow"])
def test_downsample_and_strided_table_match_jax(level0, max_out):
    out = cc.downsample_columns(level0, max_out)
    want = _vmapped(lambda c: {k: v for k, v in jcc.downsample_columns(
        dict(c, grid=GRID), max_out).items() if k != "grid"},
        _jax_cols(level0))
    assert out["grid"] == (4, 16, 16)
    _same_cols(out, want, ("ckeys", "coords2", "cvalid"))
    if max_out == 30:
        assert out["cvalid"].sum(1).tolist() == [30, 30]
    st = cc.strided_table(level0, out)
    want_t = _vmapped(
        lambda c, o: jcc.strided_table(dict(c, grid=GRID),
                                       dict(o, grid=(4, 16, 16))),
        _jax_cols(level0), _jax_cols(out))
    np.testing.assert_array_equal(st.numpy(), want_t)


# --------------------------------------------------------------- convs
def _weights(seed, cin, cout, dtype=np.float32):
    return np.random.default_rng(seed).normal(
        0, 0.3, (27, cin, cout)).astype(dtype)


def _tol(dtype):
    return 1e-5 if dtype == torch.float32 else 1e-2


def test_regroup_zstack_and_zwindows_match_jax():
    w = _weights(3, 5, 7)
    got = cc._regroup_weights(torch.from_numpy(w))
    want = np.stack(jax.device_get(jcc._regroup_weights(jnp.asarray(w))))
    np.testing.assert_array_equal(got.numpy(), want)
    g = np.random.default_rng(4).normal(size=(6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(cc._zstack(torch.from_numpy(g)).numpy(),
                                  jax.device_get(jcc._zstack(jnp.asarray(g))))
    for z in (8, 7, 5, 1):
        z2 = (z - 1) // 2 + 1
        np.testing.assert_array_equal(
            cc._zwindows(torch.from_numpy(g[:, :z]), z2).numpy(),
            jax.device_get(jcc._zwindows(jnp.asarray(g[:, :z]), z2)))
    assert [o[0] for o in sc._offsets()][:9] == [-1] * 9
    assert sc._offsets() == jsc._offsets() and sc.INVALID == jsc.INVALID
    coords = np.array([[1, 2, 3], [7, 31, 0]], np.int32)
    np.testing.assert_array_equal(
        sc.linear_key(torch.from_numpy(coords), GRID).numpy(),
        jax.device_get(jsc.linear_key(jnp.asarray(coords), GRID)))


def _with_feats(cols, seed, c, dtype):
    """cols with random (B, Vc, Z, c) features, zero where ``occ`` is
    not set, as a conv layer leaves them."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=tuple(cols["occ"].shape) + (c,)).astype(np.float32)
    f *= cols["occ"].numpy()[..., None]
    return dict(cols, feats=torch.from_numpy(f).to(dtype))


def _jax_dtype(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_subm_conv_matches_jax(level0, dtype):
    cols = _with_feats(level0, 5, 6, dtype)
    w, bias = _weights(6, 6, 10), np.linspace(-1, 1, 10, dtype=np.float32)
    got = cc.subm_conv(cols, torch.from_numpy(w),
                       bias=torch.from_numpy(bias).to(dtype))
    jc = dict(_jax_cols(level0), feats=jnp.asarray(
        cols["feats"].float().numpy()).astype(_jax_dtype(dtype)))
    want = _vmapped(lambda c: jcc.subm_conv(
        dict(c, grid=GRID), jnp.asarray(w),
        bias=jnp.asarray(bias).astype(_jax_dtype(dtype))), jc)
    assert got.dtype == dtype and got.shape == (2, 512, 8, 10)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= \
        _tol(dtype)
    assert float(got.float().abs().max()) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("max_out", [256, 30], ids=["room", "overflow"])
def test_strided_conv_matches_jax(level0, dtype, max_out):
    cols = _with_feats(level0, 7, 6, dtype)
    out = cc.downsample_columns(level0, max_out)
    w = _weights(8, 6, 12)
    got = cc.strided_conv(cols, out, torch.from_numpy(w))
    jc = dict(_jax_cols(level0), feats=jnp.asarray(
        cols["feats"].float().numpy()).astype(_jax_dtype(dtype)))
    want = _vmapped(lambda c, o: {k: v for k, v in jcc.strided_conv(
        dict(c, grid=GRID), dict(o, grid=(4, 16, 16)),
        jnp.asarray(w)).items() if k in ("feats", "occ")},
        jc, _jax_cols(out))
    np.testing.assert_array_equal(got["occ"].numpy(), want["occ"])
    assert got["feats"].dtype == dtype
    assert got["feats"].shape == (2, max_out, 4, 12)
    assert _rel(got["feats"].float().numpy(),
                np.asarray(want["feats"], np.float32)) <= _tol(dtype)
    assert int(got["occ"].sum()) > int(out["cvalid"].sum())


def test_dense_outputs_match_jax(level0):
    cols = _with_feats(level0, 9, 5, torch.float32)
    jc = dict(_jax_cols(level0), feats=jnp.asarray(cols["feats"].numpy()))
    bev = cc.to_dense_bev(cols)
    want = _vmapped(lambda c: jcc.to_dense_bev(dict(c, grid=GRID)), jc)
    assert bev.shape == (2, 32, 32, 8 * 5)
    np.testing.assert_array_equal(bev.numpy(), want)
    # channel z*C + c holds voxel z's channel c
    k = int(level0["ckeys"][0, 3])
    np.testing.assert_array_equal(bev[0, k // 32, k % 32].reshape(8, 5),
                                  cols["feats"][0, 3])
    dense, docc = cc.to_dense_voxels(cols)
    wd, wo = _vmapped(lambda c: jcc.to_dense_voxels(dict(c, grid=GRID)), jc)
    np.testing.assert_array_equal(dense.numpy(), wd)
    np.testing.assert_array_equal(docc.numpy(), wo)
    w = _weights(10, 5, 4)
    got = cc.dense_subm_conv(dense, docc, torch.from_numpy(w))
    want_c = _vmapped(lambda d, o: jcc.dense_subm_conv(d, o, jnp.asarray(w)),
                      jnp.asarray(wd), jnp.asarray(wo))
    assert _rel(got.numpy(), want_c) <= 1e-5
    # the dense conv on the canvas equals the column conv, densified
    sub = cc.to_dense_voxels(dict(cols, feats=cc.subm_conv(
        cols, torch.from_numpy(w))))[0]
    assert _rel(got.numpy(), sub.numpy()) <= 1e-5


# ---------------------------------------------------------- the encoder
ENC = dict(voxel_size=(0.15, 0.15, 0.5),
           lidar_range=(-19.2, -19.2, -3.0, 19.2, 19.2, 1.0),
           channels=(8, 16, 16, 16), max_voxels=(2048, 1536, 1024, 768))


@pytest.fixture(scope="module")
def encoder_inputs():
    """tests/configs/entry_m3_single.yaml's encoder on heal_tpu's first
    test batch of that config (2 agents of up to 1024 points)."""
    from heal_tpu.config import load_yaml
    from heal_tpu.data import build_dataset

    cfg = load_yaml("tests/configs/entry_m3_single.yaml")
    batch = next(build_dataset(cfg, train=False).batches(
        2, shuffle=False, process_split=False))
    pts = batch["inputs_m3"]["points"][:, 0]
    mask = batch["inputs_m3"]["point_mask"][:, 0]
    assert mask.sum(1).min() > 50
    return pts, mask


@pytest.mark.parametrize("case", ["f32", "bf16", "dense_tail",
                                  "presorted"])
def test_second_encoder_matches_jax(encoder_inputs, case):
    pts, mask = encoder_inputs
    dense_tail = case == "dense_tail"
    presorted = case == "presorted"
    jm = JaxSecondEncoder(**ENC, dense_tail=dense_tail, presorted=presorted)
    jp, jmask = jnp.asarray(pts), jnp.asarray(mask)
    params = jax.device_get(jax.jit(lambda p, m: jm.init(
        jax.random.PRNGKey(4), p, m))(jp, jmask))["params"]
    if case == "bf16":
        jparams = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                               params)
    else:
        jparams = params
    want = np.asarray(jax.device_get(jax.jit(lambda v, p, m: jm.apply(
        {"params": v}, p, m))(jparams, jp, jmask)), np.float32)
    model = load_flax(SecondEncoder(**ENC, dense_tail=dense_tail,
                                    presorted=presorted), params)
    assert "VmapSecondStack_0.stage3_subm1.LayerNorm_0.scale" in \
        model.state_dict()
    if case == "bf16":
        model = model.to(torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(pts), torch.from_numpy(mask))
    assert got.shape == want.shape == (2, 32, 32, model.out_channels)
    assert model.out_channels == 16  # nz 8 -> 4 -> 2 -> 1, times 16
    tol = 1e-2 if case == "bf16" else 1e-5
    assert _rel(got.float().numpy(), want) <= tol, _rel(got.float().numpy(),
                                                       want)
    assert (np.abs(want) > 0).mean() > 0.05


def test_second_encoder_bf16_keeps_conv_input_f32(encoder_inputs):
    """Under bf16 weights ``conv_input`` convolves the f32 point features
    with the bf16-rounded kernel in f32, then casts: its output equals the
    f32 layer's with that rounded kernel, cast to bf16."""
    pts, mask = encoder_inputs
    model = SecondEncoder(**ENC)
    from heal_tpu_torch.models.layers import init_weights
    init_weights(model, torch.Generator().manual_seed(0))
    stack = model.VmapSecondStack_0
    cols = cc.voxelize_columns(torch.from_numpy(pts), torch.from_numpy(mask),
                               ENC["lidar_range"], ENC["voxel_size"], 2048)
    table = cc.column_table(cols)
    layer16 = stack.conv_input.to(torch.bfloat16)
    with torch.no_grad():
        got = layer16(cols, table)["feats"]
        layer32 = stack.conv_input.float()
        want = layer32(cols, table)["feats"]
    assert got.dtype == torch.bfloat16
    assert cols["feats"].dtype == torch.float32
    assert _rel(got.float().numpy(), want.numpy()) <= 1e-2
    assert torch.equal(got, want.to(torch.bfloat16))


# ------------------------------------ kernel 3's plain version, dispatch
# the published (Cin, Cout, strided) of each SECOND layer kind
PUBLISHED = sorted(cc.KERNEL3_SHAPES)


def _layer_inputs(level0, cin, strided, seed):
    """Random features of width ``cin`` on the tiny grid, the level's
    table and, for a strided layer, its output columns."""
    cols = _with_feats(level0, seed, cin, torch.float32)
    if not strided:
        return cols, cc.column_table(cols), None
    out = cc.downsample_columns(level0, 256)
    return cols, cc.strided_table(cols, out), out


def _layer_params(seed, cin, cout):
    rng = np.random.default_rng(seed)
    return (_weights(seed, cin, cout), rng.uniform(0.5, 1.5, cout).astype(
        np.float32), rng.normal(0, 0.3, cout).astype(np.float32))


@pytest.mark.parametrize("cin,cout,strided", PUBLISHED,
                         ids=[f"{a}_{b}_{'s2' if s else 'subm'}"
                              for a, b, s in PUBLISHED])
def test_fused_layer_plain_matches_jax_layer(level0, cin, cout, strided):
    """``column_conv_layer_plain`` (conv, LayerNorm, ReLU, mask) against
    JAX's ``ColumnConvLayer`` on each published channel pair, two agents
    at the tiny grid; the CPU wrapper takes the plain version."""
    from heal_tpu.models.second import ColumnConvLayer as JaxLayer

    cols, table, out = _layer_inputs(level0, cin, strided, 20 + cin)
    w, scale, bias = _layer_params(30 + cout, cin, cout)
    got = cc.column_conv_layer_plain(
        cols, table, torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), 1e-3, out)
    with torch.no_grad():
        again = cc.column_conv_layer(
            cols, table, torch.from_numpy(w), torch.from_numpy(scale),
            torch.from_numpy(bias), 1e-3, out)
    params = {"kernel": jnp.asarray(w), "LayerNorm_0": {
        "scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    layer = JaxLayer(cout=cout, strided=strided)
    jc = dict(_jax_cols(level0), feats=jnp.asarray(cols["feats"].numpy()))
    if strided:
        want = _vmapped(lambda c, o: {k: v for k, v in layer.apply(
            {"params": params}, c, GRID, out=o, out_grid=(4, 16, 16)).items()
            if k in ("feats", "occ")}, jc, _jax_cols(out))
        np.testing.assert_array_equal(got["occ"].numpy(), want["occ"])
        assert got["feats"].shape == (2, 256, 4, cout)
    else:
        want = _vmapped(lambda c: {k: v for k, v in layer.apply(
            {"params": params}, c, GRID).items() if k == "feats"}, jc)
        assert got["feats"].shape == (2, 512, 8, cout)
        assert got["occ"] is cols["occ"]
    assert _rel(got["feats"].numpy(), want["feats"]) <= 1e-5
    assert (got["feats"] > 0).sum() > 100  # ReLU leaves real outputs
    assert torch.equal(again["feats"], got["feats"])


@pytest.mark.parametrize("cin,cout,strided", PUBLISHED,
                         ids=[f"{a}_{b}_{'s2' if s else 'subm'}"
                              for a, b, s in PUBLISHED])
def test_layer_dispatch_on_the_cpu(level0, monkeypatch, cin, cout, strided):
    """On the CPU, in eval, in training, frozen or in bf16,
    ColumnConvLayer makes one call of ``column_conv_layer`` and the op
    takes the plain version, whose values are bit-equal to the conv,
    ``LayerNorm``, ReLU and mask composed op by op, and which training
    differentiates; no kernel-3 launch is counted."""
    from heal_tpu_torch import trace
    from heal_tpu_torch.models import second

    calls, plain = [], []
    op, plain_fn = cc.column_conv_layer, cc.column_conv_layer_plain
    monkeypatch.setattr(cc, "column_conv_layer",
                        lambda *a, **k: calls.append(1) or op(*a, **k))
    monkeypatch.setattr(cc, "column_conv_layer_plain",
                        lambda *a, **k: plain.append(1) or plain_fn(*a, **k))
    trace.clear()
    layer = second.ColumnConvLayer(cin, cout, strided=strided)
    w, scale, bias = _layer_params(40 + cin, cin, cout)
    with torch.no_grad():
        layer.kernel.copy_(torch.from_numpy(w))
        layer.LayerNorm_0.scale.copy_(torch.from_numpy(scale))
        layer.LayerNorm_0.bias.copy_(torch.from_numpy(bias))
    cols, table, out = _layer_inputs(level0, cin, strided, 50 + cin)
    with torch.no_grad():
        eval_out = layer(cols, table, out=out)
        if strided:
            conv = cc.strided_conv(cols, out, layer.kernel, table=table)
            occ = conv["occ"]
        else:
            conv = dict(cols, feats=cc.subm_conv(cols, layer.kernel,
                                                 table=table))
            occ = cols["occ"]
        want = torch.relu(layer.LayerNorm_0(conv["feats"])) * occ[..., None]
    assert torch.equal(eval_out["feats"], want)
    assert torch.equal(eval_out["occ"], occ)
    trained = layer(cols, table, out=out)  # grad on, parameters need it
    assert trained["feats"].requires_grad
    assert torch.equal(eval_out["feats"], trained["feats"].detach())
    trained["feats"].sum().backward()
    assert float(layer.kernel.grad.abs().sum()) > 0
    layer.requires_grad_(False)  # a frozen layer under grad: no gradient
    frozen = layer(cols, table, out=out)
    assert torch.equal(frozen["feats"], eval_out["feats"])
    with torch.no_grad():
        layer.to(torch.bfloat16)(cols, table, out=out)
    assert len(calls) == len(plain) == 4
    assert trace.counters().get("kernel3.launches", 0) == 0


def test_layer_dispatch_keeps_other_widths_and_refuses_grad(level0):
    """On the CPU a width kernel 3 is not built for runs the plain version
    (on the card the op raises there: tests/test_torch_kernels_cuda.py);
    under a gradient ``column_conv_layer`` returns the plain version's
    output, and its gradient is the plain version's."""
    from heal_tpu_torch.models import second

    layer = second.ColumnConvLayer(6, 10)
    torch.nn.init.normal_(layer.kernel, 0, 0.3)
    cols, table, _ = _layer_inputs(level0, 6, False, 60)
    with torch.no_grad():
        got = layer(cols, table)
        want = cc.column_conv_layer(cols, table, layer.kernel,
                                    torch.ones(10), torch.zeros(10), 1e-3)
    assert got["feats"].shape == (2, 512, 8, 10)
    assert torch.equal(got["feats"], want["feats"])
    w = layer.kernel.detach().clone().requires_grad_()
    args = (cols, table, w, torch.ones(10), torch.zeros(10), 1e-3)
    got = cc.column_conv_layer(*args)["feats"]
    want = cc.column_conv_layer_plain(*args)["feats"]
    assert torch.equal(got, want)
    g = torch.from_numpy(np.random.default_rng(61).standard_normal(
        tuple(got.shape)).astype(np.float32))
    (grad,) = torch.autograd.grad(got, w, g)
    assert torch.equal(grad, torch.autograd.grad(want, w, g)[0])
    assert grad.any()


def test_profiler_counts_kernel_3_apart():
    """tools/profiler.flop_count runs a published-width SECOND layer's
    ``column_conv_layer`` outside its FlopCounterMode (as kernel 3 runs
    on the card) and reports 2*27*Cin*Cout an output voxel apart; the
    counter then sees none of the convs' products."""
    from heal_tpu_torch.models.layers import init_weights
    from heal_tpu_torch.tools import profiler

    enc = init_weights(SecondEncoder(
        (0.3, 0.3, 0.1), (-4.8, -4.8, -3.0, 4.8, 4.8, 1.0),
        max_voxels=(256, 192, 128, 64)), torch.Generator().manual_seed(0))

    class Frame(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.enc = enc

        def forward(self, x):
            return self.enc(x["points"], x["mask"])

    pts, mask = _points(11)
    got = profiler.flop_count(Frame().eval(), {
        "points": torch.from_numpy(pts), "mask": torch.from_numpy(mask)})
    z = (40, 20, 10, 5)
    caps = (256, 192, 128, 64)
    chans = (4, 16, 32, 64, 64)
    want = 2 * 27 * 4 * 16 * 2 * 256 * 40
    for si in range(1, 4):
        want += 2 * 27 * 2 * caps[si] * z[si] * chans[si + 1] * (
            chans[si] + 2 * chans[si + 1])
    assert got["kernel_ops"]["column_conv"] == want
    assert not any("mm" in op for op in got["by_op"]), got["by_op"]
