"""The models' remaining options, port vs JAX, on the CPU.

Seeded numpy inputs, flax inits (norm parameters and running statistics
randomised) bridged strictly into the port:

  * group norm (``Norm("group")``: min(32, C) groups halved until they
    divide C, eps 1e-3), the strided-down deblock (a bias-free s x s
    conv of stride s under flax's SAME padding, H and W divisible by s
    or not) and ``ResNetBEVBackbone``'s trailing deblock over the
    concatenated levels: outputs in eval mode, and in train mode the
    output, the running statistics and the input and parameter
    gradients of a seeded cotangent;
  * the PointPillars encoder's general path (``_decorate`` + ``pfn_i``
    layers + the pillar max): several layers, batch / group / no norm,
    relative xyz, the distance channel, and duplicated points that tie
    in their pillar's max (the tied points carry identical features, so
    the parameter gradients agree however a tie is split); both modes,
    kernel 1 never called;
  * ``aligned_boxes_iou3d`` and ``box2d_to_corners``;
  * the IoU branch of ``point_pillar_loss``, with fewer and with more
    than ``max_positive_anchors`` (512) positives a sample: the top-K
    ties broken towards the lower index, as ``jax.lax.top_k``;
  * the four other ``yaml_parser`` passes on config dicts (equal).

Stated tolerance: 1e-5 relative and absolute (f32 sums in another
order), elementwise for outputs, running statistics and losses; for a
gradient leaf as max |d| / (1 + max |JAX|), since its small elements
are sums of terms as large as its largest (the backbone's deblock
kernels reach ~75, and f32 reordering moves a ~1 element by 2e-5). The
parsers exact.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.config.loader import PARSER_REGISTRY as JAX_PARSERS
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import layers as jl
from heal_tpu.models.encoders import PointPillarEncoder as JaxEncoder
from heal_tpu.models.resnet_bev import ResNetBEVBackbone as JaxBackbone
from heal_tpu.utils import rotated_iou as jiou
from heal_tpu_torch.config.loader import PARSER_REGISTRY
from heal_tpu_torch.models import build_loss
from heal_tpu_torch.models import encoders as tenc
from heal_tpu_torch.models import layers as tl
from heal_tpu_torch.models.resnet_bev import ResNetBEVBackbone
from heal_tpu_torch.parallel.trainer import _label_targets
from heal_tpu_torch.tools.train import build_trainer
from heal_tpu_torch.utils import rotated_iou as tiou
from heal_tpu_torch.utils.bridge import load_flax, to_flax
from test_torch_pillar import _points
from test_torch_train_layers import _check_tree, _random_stats

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _close_grads(got: dict, want: dict):
    """Each gradient leaf within 1e-5 of JAX's, relative to the leaf's
    scale."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, a), (_, b) in zip(fg, fw):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape, path
        err = np.abs(a - b).max() / (1.0 + np.abs(b).max())
        assert err <= 1e-5, (path, err)


def _randomise(params, rng):
    def leaf(path, x):
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if path[-1].key == "bias":
            return rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(params))


def _both_modes(fm, tm, x, cot, rng):
    """The module in eval and train mode, port against flax (NHWC numpy
    in, NCHW torch)."""
    v = jax.device_get(jax.jit(fm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)))
    v = {"params": _randomise(v.get("params", {}), rng),
         "batch_stats": _random_stats(v.get("batch_stats", {}), rng)}
    load_flax(tm, v["params"], v["batch_stats"])
    want = jax.device_get(jax.jit(lambda vv, xx: fm.apply(
        vv, xx, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)

    def f(params, xx):
        out, mut = fm.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut["batch_stats"])

    (_, (out, stats)), (gp, gx) = jax.device_get(jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tm.train()(xt)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               out, **TOL)
    _check_tree(to_flax(tm.state_dict())[1], stats)
    _close_grads(to_flax({k: p.grad for k, p in tm.named_parameters()})[0],
                 gp)
    _close_grads({"x": xt.grad.permute(0, 2, 3, 1).numpy()}, {"x": gx})
    return out


@pytest.mark.parametrize("channels,groups", [(8, 8), (40, 8), (48, 16)])
def test_group_norm_matches_flax(channels, groups):
    """``Norm_0.GroupNorm_0`` with flax's group count and eps 1e-3
    whatever the call site's batch-norm eps."""
    rng = np.random.RandomState(channels)
    x = (rng.randn(2, 5, 6, channels) * 2 + 0.5).astype(np.float32)
    cot = rng.randn(2, 5, 6, channels).astype(np.float32)
    tm = tl.Norm(channels, "group", epsilon=1e-5)
    assert tm.GroupNorm_0.num_groups == groups == tl.group_count(channels)
    _both_modes(jl.Norm("group", epsilon=1e-5), tm, x, cot, rng)
    assert not list(tm.buffers())


@pytest.mark.parametrize("stride,hw,norm", [
    (0.5, (8, 12), "batch"), (0.5, (7, 9), "batch"), (0.25, (5, 11), "group"),
])
def test_strided_down_deblock_matches_flax(stride, hw, norm):
    """SAME padding pads (-H) % s rows, half before (rounded down) and
    the rest after: at the end when one is missing."""
    rng = np.random.RandomState(int(1 / stride) + hw[0])
    s = int(round(1 / stride))
    x = rng.randn(2, *hw, 16).astype(np.float32)
    out_hw = (-(-hw[0] // s), -(-hw[1] // s))
    cot = rng.randn(2, *out_hw, 8).astype(np.float32)
    tm = tl.DeconvNormAct(16, 8, stride, norm=norm)
    assert not hasattr(tm, "ConvTranspose_0")
    out = _both_modes(jl.DeconvNormAct(8, stride, norm=norm), tm, x, cot,
                      rng)
    assert out.shape == (2, *out_hw, 8)


@pytest.mark.parametrize("upsample,norm", [
    ((1, 2, 2), "batch"), ((0.5, 1, 2), "group"),
])
def test_backbone_trailing_deblock_matches_flax(upsample, norm):
    """One more upsample stride than levels: the last deblock runs on
    the concatenated levels (its input their summed width)."""
    rng = np.random.RandomState(len(norm))
    kw = dict(layer_nums=(1, 1), layer_strides=(1, 2), num_filters=(8, 16),
              upsample_strides=upsample, num_upsample_filter=(8, 8, 12),
              norm=norm)
    x = rng.randn(2, 8, 12, 8).astype(np.float32)
    tm = ResNetBEVBackbone(8, **kw)
    assert tm.out_channels == 12 and tm.trailing == "deblocks_2"
    # the levels meet at 8 x 12 (4 x 6), then the trailing stride 2
    h, w = (16, 24) if upsample[0] == 1 else (8, 12)
    cot = rng.randn(2, h, w, 12).astype(np.float32)
    out = _both_modes(JaxBackbone(**kw), tm, x, cot, rng)
    assert out.shape == (2, h, w, 12)


# (num_filters, norm, use_absolute_xyz, with_distance, duplicates)
ENCODERS = {
    "group": ((16,), "group", True, False, False),
    "batch_two_layers": ((8, 16), "batch", True, False, False),
    "none_relative_distance": ((16,), "none", False, True, False),
    "batch_distance": ((16,), "batch@0.99", True, True, False),
    "group_ties": ((16,), "group", True, False, True),
}


@pytest.mark.parametrize("case", list(ENCODERS))
def test_general_encoder_matches_jax(case, monkeypatch):
    filters, norm, absolute, distance, dup = ENCODERS[case]
    lidar_range = (-9.6, -6.4, -3.0, 9.6, 6.4, 1.0)
    voxel = (0.8, 0.8, 4.0)
    pts, mask = _points(21, 2, 700, lidar_range, voxel, False)
    if dup:
        pts[:, 300:340] = pts[:, 200:240]
        mask[:, 300:340] = mask[:, 200:240] = True
    kw = dict(voxel_size=voxel, lidar_range=lidar_range, num_filters=filters,
              use_absolute_xyz=absolute, with_distance=distance, norm=norm)
    jenc = JaxEncoder(**kw)
    v = jax.device_get(jax.jit(jenc.init)(
        jax.random.PRNGKey(0), jnp.asarray(pts), jnp.asarray(mask)))
    rng = np.random.RandomState(3)
    v = {"params": _randomise(v["params"], rng),
         "batch_stats": _random_stats(v.get("batch_stats", {}), rng)}
    enc = tenc.PointPillarEncoder(**kw)
    assert not enc.fused and not hasattr(enc, "pfn_kernel")
    load_flax(enc, v["params"], v["batch_stats"])

    def no_kernel(*a, **k):
        raise AssertionError("the general path called kernel 1")

    monkeypatch.setattr(tenc._pillar, "pillar_tables", no_kernel)
    want = jax.device_get(jax.jit(lambda vv, p, m: jenc.apply(
        vv, p, m, train=False))(v, jnp.asarray(pts), jnp.asarray(mask)))
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(pts), torch.from_numpy(mask))
    assert got.shape == want.shape == (2, 16, 24, filters[-1])
    assert (want != 0).any(axis=-1).sum() > 50
    np.testing.assert_allclose(got.numpy(), want, **TOL)

    cot = np.random.RandomState(2).randn(*want.shape).astype(np.float32)

    def f(p):
        out, mut = jenc.apply({"params": p, "batch_stats": v["batch_stats"]},
                              jnp.asarray(pts), jnp.asarray(mask),
                              train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut["batch_stats"])

    (_, (want, want_stats)), gp = jax.device_get(
        jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"]))
    got = enc.train()(torch.from_numpy(pts), torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    _check_tree(to_flax(enc.state_dict())[1], want_stats)
    _close_grads(to_flax({k: p.grad for k, p in enc.named_parameters()})[0],
                 gp)
    assert all(p.grad.abs().max() > 0 for p in enc.parameters())


def test_aligned_boxes_iou3d_matches_jax():
    """Random hwl boxes, each against a jittered copy of itself (partial
    overlaps at every yaw), against itself (IoU 1) and against a far box
    (IoU 0)."""
    rng = np.random.RandomState(0)
    n = 300
    a = np.concatenate([rng.uniform(-20, 20, (n, 2)),
                        rng.uniform(-2, 0, (n, 1)),
                        rng.uniform(1.2, 2.0, (n, 1)),
                        rng.uniform(1.5, 2.5, (n, 1)),
                        rng.uniform(3.5, 5.0, (n, 1)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    b = a + rng.normal(0, [0.8, 0.8, 0.3, 0.2, 0.3, 0.5, 0.6], (n, 7))
    b[:20] = a[:20]
    b[20:40, :2] += 50.0
    a, b = a.astype(np.float32), b.astype(np.float32)
    want = np.asarray(jiou.aligned_boxes_iou3d(jnp.asarray(a),
                                               jnp.asarray(b), xp=jnp))
    got = tiou.aligned_boxes_iou3d(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:20], 1.0, atol=1e-5)
    assert (got[20:40] == 0).all() and ((got > 0.05) & (got < 0.95)).sum() > 100
    corners = tiou.box2d_to_corners(torch.from_numpy(a[:, [0, 1, 5, 4, 6]]))
    np.testing.assert_allclose(
        corners.numpy(),
        np.asarray(jiou.box2d_to_corners(jnp.asarray(a[:, [0, 1, 5, 4, 6]]),
                                         xp=jnp)), **TOL)


@pytest.fixture(scope="module")
def tiny_labels():
    cfg = jax_load_yaml("tests/configs/entry_tiny.yaml")
    ds = jax_build_dataset(cfg, train=True)
    batch = next(ds.batches(2, shuffle=False, process_split=False))
    return cfg, batch, ds.anchors


@pytest.mark.parametrize("positives", [0, 700])
def test_iou_loss_matches_jax(tiny_labels, positives):
    """The IoU term, total and gradients (every prediction) against
    JAX's. 700 positives a sample (of 2048 anchors, all of one weight):
    the top 512 are the lowest-index ones in both, and an iou head that
    differs anchor by anchor shows any other pick. 0: the batch's own
    labels (two positives)."""
    cfg, batch, anchors = tiny_labels
    rng = np.random.RandomState(positives)
    targets = {k: np.array(v) for k, v in _label_targets(batch).items()}
    b, h, w, a = targets["pos_equal_one"].shape
    if positives:
        pos = np.zeros((b, h * w * a), np.float32)
        for i in range(b):
            pos[i, rng.choice(h * w * a, positives, replace=False)] = 1.0
        targets["pos_equal_one"] = pos.reshape(b, h, w, a)
        targets["neg_equal_one"] = 1.0 - targets["pos_equal_one"]
        targets["targets"] = (rng.randn(b, h, w, 7 * a) * 0.2).astype(
            np.float32)
    reg = targets["targets"] + rng.randn(b, h, w, 7 * a).astype(
        np.float32) * 0.1
    preds = {"cls_preds": rng.randn(b, h, w, a).astype(np.float32),
             "reg_preds": reg.astype(np.float32),
             "dir_preds": rng.randn(b, h, w, 2 * a).astype(np.float32),
             "iou_preds": rng.randn(b, h, w, a).astype(np.float32)}
    args = {k: v for k, v in cfg["loss"]["args"].items()
            if k not in ("depth", "pyramid", "single_weight")}
    loss_cfg = {"core_method": "point_pillar_loss",
                "args": dict(args, iou={"weight": 1.5, "sigma": 1.0})}
    jloss = build_jax_loss(loss_cfg)
    jloss.set_anchors(anchors)

    def jf(p):
        return jloss(p, jax.tree.map(jnp.asarray, targets))

    (jtotal, jaux), jgrad = jax.device_get(
        jax.jit(jax.value_and_grad(jf, has_aux=True))(preds))
    loss = build_loss(loss_cfg)
    assert loss.iou_cap == 512
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    total, aux = loss(tp, {k: torch.from_numpy(v)
                           for k, v in targets.items()})
    assert "iou_loss" not in aux  # no anchors yet: no term, as JAX
    loss.set_anchors(anchors)
    total, aux = loss(tp, {k: torch.from_numpy(v)
                           for k, v in targets.items()})
    total.backward()
    assert sorted(aux) == sorted(jaux) and aux["iou_loss"].item() > 0
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), v, err_msg=k, **TOL)
    _close_grads({k: t.grad.numpy() for k, t in tp.items()}, jgrad)
    n_iou = (tp["iou_preds"].grad != 0).sum().item()
    assert n_iou == (2 * 512 if positives else 2)


def test_trainer_takes_the_dataset_anchors():
    """``build_trainer`` hands the IoU branch the assemblers' anchors,
    as JAX's train.py hands ``train_ds.anchors``."""
    from heal_tpu_torch.data import build_dataset
    from heal_tpu_torch.tools.train import load_config

    cfg = load_config("tests/configs/entry_tiny.yaml")
    cfg["loss"]["args"]["iou"] = {"weight": 1.0, "sigma": 1.0}
    tr = build_trainer(cfg, "cpu", 1)
    np.testing.assert_array_equal(
        tr.criterion.anchors.numpy(),
        build_dataset(cfg, train=True).anchors.astype(np.float32))


def _raw(path: str) -> dict:
    """A config as its YAML file holds it, before any parser."""
    import yaml

    from heal_tpu_torch.config.loader import _Loader

    with open(path) as f:
        return yaml.load(f, Loader=_Loader)


def _parser_cfgs() -> dict:
    base = _raw("tests/configs/entry_tiny.yaml")
    bev = copy.deepcopy(base)
    bev["preprocess"]["args"].update(res=0.2, downsample_rate=4)
    del bev["postprocess"]["anchor_args"]
    lss = copy.deepcopy(base)
    lss["fusion"]["args"]["grid_conf"] = {
        "xbound": [-48.0, 48.0, 0.6], "ybound": [-38.4, 38.4, 0.8],
        "zbound": [-10, 10, 20.0], "ddiscr": [2, 50, 48], "mode": "LID"}
    lss_range = copy.deepcopy(lss)
    lss_range["postprocess"]["anchor_args"]["cav_lidar_range"] = [
        -48.0, -38.4, -3, 48.0, 38.4, 1]
    return {"load_second_params": copy.deepcopy(base),
            "load_voxel_params": copy.deepcopy(base),
            "load_bev_params": bev,
            "load_lift_splat_shoot_params": lss,
            "load_lift_splat_shoot_params_with_range": lss_range}


@pytest.mark.parametrize("name", list(_parser_cfgs()))
def test_parsers_match_jax(name):
    cfg = _parser_cfgs()[name]
    parser = name.replace("_with_range", "")
    want = JAX_PARSERS[parser](copy.deepcopy(cfg))
    got = PARSER_REGISTRY[parser](copy.deepcopy(cfg))

    def same(a, b, path=""):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), path
        else:
            assert a == b, path

    same(got, want)
    anchor_args = got["postprocess"]["anchor_args"]
    assert "cav_lidar_range" in anchor_args
    if parser == "load_second_params":
        assert got["model"]["args"]["backbone_3d"]["grid_size"].tolist() \
            == [64, 64, 1]
    if parser == "load_lift_splat_shoot_params":
        assert (anchor_args["W"], anchor_args["H"]) == (160, 96)
