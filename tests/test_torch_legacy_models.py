"""The last single-stage detectors, port vs JAX, on the CPU: the
multiscale PointPillars baseline, DiscoNet's student and teacher,
VoxelNet, PIXOR, CIA-SSD and SECOND-SSFA (with and without its
uncertainty head), and their losses.

tests/configs/tiny_intermediate.yaml (a 128 x 128 grid of 0.6 m cells,
backbone 32 / 64, shrink 64, a 64 x 64 head map, three agent slots with a
padded one, 6000 points an agent) with its model switched in code
(``legacy_cfg``): VoxelNet on 0.6 x 0.6 x 1.0 m voxels (4 z layers, its
own widths 32 / 64 as JAX fixes them); PIXOR at 0.6 m over 8 z slabs;
CIA-SSD and SECOND-SSFA on SECOND at the widths of JAX's
tests/test_two_stage.py (0.6 x 0.6 x 0.5 m voxels, channels 8 / 16 / 16
/ 16, SSFA 32) with the anchors re-derived at stride 8 (16 x 16). One
numpy batch of heal_tpu's host side goes to both packages (its C++
anchor IoU off), one set of flax variables (the port's seeded init,
running statistics randomised) is bridged strictly. Stated tolerances,
as max |d| / (1 + max |JAX|):

  * eval heads (and ``spatial_features_2d``, DiscoNet's ``feature`` /
    ``teacher_feature``, ``iou_preds``, ``unc_preds``): 1e-4; the
    multiscale max baseline with JAX's encoder on its Pallas kernel 1 in
    interpret mode;
  * modules (``VoxelNetEncoder``, ``bev_rasterize``, ``SSFA``): 1e-5;
  * the losses (voxel_net, pixor, ciassd with its IoU term): 1e-6
    relative;
  * the PIXOR label map and the rasterizer's occupancy: exact;
  * one train step each of VoxelNet and CIA-SSD against JAX's own step
    in f64 (the witness of tests/test_torch_train.py): the port's f64
    step at 1e-5, its f32 step's loss terms 1e-5 relative and every f32
    gradient leaf within 1e-4, but VoxelNet's two conv biases before a
    train-mode batch norm, whose gradient is zero by construction
    (``ZERO_BY_CONSTRUCTION``: below 1e-9 in both f64 steps; in f32 the
    rounding of a sum over every voxel, 1.3e-3 and 9.2e-5).

Also: JAX's variables of every model here (shapes by ``jax.eval_shape``)
map key for key onto the port's, and both registries hold the same 29
model and 9 loss names.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.config.loader import PARSER_REGISTRY
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.models.pixor import bev_rasterize as jax_rasterize
from heal_tpu.models.registry import LOSS_REGISTRY as JAX_LOSSES
from heal_tpu.models.registry import MODEL_REGISTRY as JAX_MODELS
from heal_tpu.models.voxel_net import VoxelNetEncoder as JaxVoxelNetEncoder
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.postprocess import targets as jax_targets
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models import registry
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.models.pixor import bev_rasterize
from heal_tpu_torch.models.voxel_net import VoxelNetEncoder
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.postprocess import targets
from heal_tpu_torch.utils.bridge import from_flax, load_flax, to_flax
from test_torch_point_pillar import _model_batch, _random_stats
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
TINY = "tests/configs/tiny_intermediate.yaml"
TOL = 1e-4
OUT_KEYS = ("cls_preds", "reg_preds", "dir_preds", "iou_preds", "unc_preds",
            "cls", "reg", "spatial_features_2d", "feature", "teacher_feature")
SECOND_ARGS = {"voxel_size": [0.6, 0.6, 0.5],
               "second": {"channels": [8, 16, 16, 16],
                          "max_voxels": [4000, 3000, 2000, 1500]},
               "ssfa": {"feature_num": 32}}
STAGE1_LOSS = {"pos_cls_weight": 2.0,
               "cls": {"alpha": 0.25, "gamma": 2.0, "weight": 1.0},
               "reg": {"sigma": 3.0, "weight": 2.0},
               "iou": {"sigma": 3.0, "weight": 1.0}}

# name -> (core_method, model args it sets, one agent (the ego) or all)
MODELS = {
    "multiscale_max": ("point_pillar_baseline_multiscale",
                       {"fusion_method": "max"}, False),
    "multiscale_att": ("point_pillar_baseline_multiscale",
                       {"fusion_method": "att"}, False),
    "multiscale_disconet": ("point_pillar_baseline_multiscale",
                            {"fusion_method": "disconet",
                             "compression": 2}, False),
    "disconet": ("point_pillar_disconet", {}, False),
    "disconet_teacher": ("point_pillar_disconet_teacher", {}, True),
    "voxel_net": ("voxel_net", {"voxel_size": [0.6, 0.6, 1.0]}, True),
    "voxel_net_intermediate": ("voxel_net_intermediate",
                               {"voxel_size": [0.6, 0.6, 1.0]}, False),
    "pixor": ("pixor", {"bev_res": 0.6, "z_slabs": 8}, True),
    "pixor_head": ("pixor", {"bev_res": 0.6, "z_slabs": 8,
                             "pixor_head": True}, True),
    "pixor_intermediate": ("pixor_intermediate",
                           {"bev_res": 0.6, "z_slabs": 8}, False),
    "ciassd": ("ciassd", SECOND_ARGS, True),
    "ciassd_agents": ("ciassd", SECOND_ARGS, False),
    "second_ssfa": ("second_ssfa", SECOND_ARGS, True),
    "second_ssfa_shrink": ("second_ssfa", dict(
        SECOND_ARGS, shrink_header={"kernal_size": [3], "stride": [1],
                                    "padding": [1], "dim": [24]}), True),
    "second_ssfa_uncertainty": ("second_ssfa_uncertainty", SECOND_ARGS,
                                True),
}


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    # heal_tpu on its numpy host path, built library or not
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def legacy_cfg(name: str) -> dict:
    core, args, _ = MODELS[name]
    cfg = jax_load_yaml(TINY)
    a = cfg["model"]["args"]
    cfg["model"]["core_method"] = core
    if "second" in args:  # SECOND's 8x map: anchors at stride 8
        for k in ("pillar_vfe", "point_pillar_scatter", "base_bev_backbone",
                  "shrink_header"):
            a.pop(k)
        cfg["preprocess"]["args"]["max_points"] = 2048
        cfg["postprocess"]["anchor_args"]["feature_stride"] = 8
        cfg = PARSER_REGISTRY[cfg["yaml_parser"]](cfg)
        a = cfg["model"]["args"]
        cfg["loss"] = {"core_method": "ciassd_loss",
                       "args": copy.deepcopy(STAGE1_LOSS)}
    a.update(copy.deepcopy(args))
    if core.startswith("voxel_net"):
        cfg["loss"] = {"core_method": "voxel_net_loss",
                       "args": {"alpha": 1.5, "beta": 1.0, "reg": 2.0}}
    if core == "point_pillar_disconet":
        cfg["loss"]["core_method"] = "point_pillar_disconet_loss"
        cfg["loss"]["args"]["kd"] = {"weight": 10000}
    return cfg


def legacy_batch(cfg, name, train=False, size=1):
    """heal_tpu's first batch of ``cfg`` (numpy's global seed 0 first);
    a one-agent model reads the ego's points."""
    np.random.seed(0)
    batch = next(jax_build_dataset(cfg, train=train).batches(
        size, shuffle=False, process_split=False))
    if MODELS.get(name, (None, None, False))[2]:
        batch = dict(batch, points=batch["points"][:, 0],
                     point_mask=batch["point_mask"][:, 0])
    return batch


def port_variables(cfg, seed):
    """The port's seeded init in flax layout, running statistics
    randomised."""
    model = init_weights(build_model(cfg["model"],
                                     max_cav=cfg["train_params"]["max_cav"]),
                         torch.Generator().manual_seed(seed))
    params, stats = to_flax(model.state_dict())
    return params, _random_stats(stats, seed)


def port_model(cfg, params, stats):
    return load_flax(build_model(cfg["model"],
                                 max_cav=cfg["train_params"]["max_cav"]),
                     params, stats)


def jax_outputs(cfg, params, stats, batch, keys=OUT_KEYS):
    jm = build_flax(cfg["model"])
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return jax.device_get(jax.jit(lambda v, b: {
        k: x for k, x in jm.apply(v, b, train=False).items() if k in keys})(
            variables, jax.tree.map(jnp.asarray, batch)))


def assert_outputs_match(got: dict, want: dict, tol: float = TOL):
    assert sorted(k for k in got if k in want) == sorted(want)
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        assert g.shape == np.shape(w), (k, g.shape, np.shape(w))
        assert _rel(g, w) <= tol, (k, _rel(g, w))


def assert_bridges_strictly(cfg, batch):
    """JAX's init variables (shapes only) map key for key onto the
    port's state_dict."""
    jm = build_flax(cfg["model"])
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False),
                            jax.tree.map(jnp.asarray, batch))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = build_model(cfg["model"], max_cav=cfg["train_params"]["max_cav"])
    from_flax(zeros["params"], zeros.get("batch_stats"),
              expected=model.state_dict())
    return sorted(zeros["params"])


def test_registries_hold_heal_tpus_names():
    import heal_tpu.losses  # noqa: F401
    import heal_tpu_torch.losses  # noqa: F401
    for mod in ("center_point", "ciassd", "fpvrcnn", "heter_baseline",
                "heter_pyramid", "lift_splat_shoot", "pixor", "point_pillar",
                "second_model", "voxel_net"):
        __import__(f"heal_tpu.models.{mod}")
    assert len(JAX_MODELS) == 29 and len(JAX_LOSSES) == 9
    for name in JAX_MODELS:
        registry.model_class(name)
    assert sorted(registry.MODEL_REGISTRY) == sorted(JAX_MODELS)
    assert sorted(registry.LOSS_REGISTRY) == sorted(JAX_LOSSES)


@pytest.mark.parametrize("name", list(MODELS))
def test_heads_match_jax(name, monkeypatch):
    cfg = legacy_cfg(name)
    batch = legacy_batch(cfg, name)
    if name == "disconet_teacher":  # the early-fused view of the frame
        batch = legacy_batch(dict(cfg, kd_flag=True), name)
        batch = {"points": batch["teacher_points"],
                 "point_mask": batch["teacher_point_mask"]}
    if name == "multiscale_max":  # JAX's kernel 1 in interpret mode
        monkeypatch.setenv("HEAL_TPU_FORCE_PALLAS", "1")
    top = assert_bridges_strictly(cfg, batch)
    if name == "multiscale_disconet":
        assert {"DiscoFusion_0", "DiscoFusion_1",
                "NaiveCompressor_0"} <= set(top)
    params, stats = port_variables(cfg, seed=list(MODELS).index(name))
    want = jax_outputs(cfg, params, stats, batch)
    with torch.no_grad():
        got = port_model(cfg, params, stats)(_model_batch(batch))
    assert_outputs_match(got, want)
    if MODELS[name][0].startswith("pixor") and "pixor_head" not in name:
        assert got["anchor_free"] is True
    if name.startswith("ciassd") or name == "second_ssfa":
        assert "iou_preds" in want
    if name == "second_ssfa_uncertainty":
        assert "unc_preds" in want and "iou_preds" not in want


def test_voxel_net_encoder_matches_jax():
    """The encoder alone in train mode (batch statistics), 1e-5; its
    voxel ids against JAX's formula, exact."""
    cfg = legacy_cfg("voxel_net")
    batch = legacy_batch(cfg, "voxel_net", train=True, size=2)
    a = cfg["model"]["args"]
    enc = VoxelNetEncoder(a["voxel_size"], a["lidar_range"])
    init_weights(enc, torch.Generator().manual_seed(3))
    params, stats = to_flax(enc.state_dict())
    jenc = JaxVoxelNetEncoder(voxel_size=tuple(a["voxel_size"]),
                              lidar_range=tuple(a["lidar_range"]))
    pts, msk = jnp.asarray(batch["points"]), jnp.asarray(batch["point_mask"])
    want, mutated = jax.device_get(jax.jit(
        lambda v: jenc.apply(v, pts, msk, True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}))
    enc.train()
    got = enc(torch.from_numpy(batch["points"]),
              torch.from_numpy(batch["point_mask"]))
    assert got.shape == want.shape == (2, 128, 128, 64)
    assert _rel(got.detach().numpy(), want) <= 1e-5
    _, got_stats = to_flax(enc.state_dict())
    for k, v in _leaves(mutated["batch_stats"]).items():
        assert _rel(_leaves(got_stats)[k], v) <= 1e-5, k
    ids, ok = enc.voxel_ids(torch.from_numpy(batch["points"]),
                            torch.from_numpy(batch["point_mask"]))
    p = batch["points"]
    idx = [np.floor((p[..., i] - a["lidar_range"][i]) / a["voxel_size"][i])
           .astype(np.int32) for i in range(3)]
    inside = batch["point_mask"] & np.all(
        [(v >= 0) & (v < n) for v, n in zip(idx, (128, 128, 4))], axis=0)
    want_ids = np.where(inside, (idx[2] * 128 + idx[1]) * 128 + idx[0],
                        128 * 128 * 4)
    assert np.array_equal(ids.numpy(), want_ids)
    assert np.array_equal(ok.numpy(), inside)


def test_bev_rasterize_matches_jax():
    """Occupancy exact, the mean intensity 1e-5, with padded points and
    points out of range."""
    cfg = legacy_cfg("pixor")
    batch = legacy_batch(cfg, "pixor", size=1)
    pts = batch["points"].copy()
    pts[0, :50, 2] = 5.0  # above the range: dropped
    mask = batch["point_mask"]
    lr = cfg["model"]["args"]["lidar_range"]
    want = np.asarray(jax_rasterize(jnp.asarray(pts), jnp.asarray(mask), lr,
                                    0.6, 8))
    got = bev_rasterize(torch.from_numpy(pts), torch.from_numpy(mask), lr,
                        0.6, 8).numpy()
    assert got.shape == want.shape == (1, 128, 128, 9)
    assert np.array_equal(got[..., :8], want[..., :8])
    assert got[..., :8].sum() > 100
    assert _rel(got[..., 8], want[..., 8]) <= 1e-5


def test_pixor_label_map_and_loss_match_jax():
    """``generate_pixor_label_map`` exact on the frame's ground truth
    (and on an empty one); ``pixor_loss`` on the PIXOR heads' outputs
    against it, 1e-6."""
    cfg = legacy_cfg("pixor_head")
    batch = legacy_batch(cfg, "pixor_head")
    gt, gm = batch["gt_boxes"][0], batch["gt_mask"][0]
    lr = cfg["model"]["args"]["lidar_range"]
    shape = (64, 64, 7)
    for mask in (gm, np.zeros_like(gm)):
        want = jax_targets.generate_pixor_label_map(gt, mask, lr, 0.6, 2,
                                                    shape, "hwl")
        got = targets.generate_pixor_label_map(gt, mask, lr, 0.6, 2, shape,
                                               "hwl")
        assert got.dtype == want.dtype and np.array_equal(got, want)
    label = targets.generate_pixor_label_map(gt, gm, lr, 0.6, 2, shape,
                                             "hwl")
    assert label[..., 0].sum() > 10
    rng = np.random.RandomState(0)
    out = {"cls": rng.randn(1, 64, 64, 1).astype(np.float32),
           "reg": rng.randn(1, 64, 64, 6).astype(np.float32)}
    args = {"alpha": 1.0, "beta": 1.0}
    want_total, want_aux = build_jax_loss(
        {"core_method": "pixor_loss", "args": args})(
            jax.tree.map(jnp.asarray, out), {"label_map": label[None]})
    total, aux = build_loss({"core_method": "pixor_loss", "args": args})(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {"label_map": torch.from_numpy(label[None])})
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-6)
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["voxel_net", "ciassd", "multiscale_max"])
def test_losses_match_jax(name):
    """voxel_net_loss, ciassd_loss (with its IoU term, anchors set) and
    the PointPillars loss of the multiscale baseline on seeded random
    heads against the frames' labels, 1e-6 relative."""
    cfg = legacy_cfg(name)
    batch = legacy_batch(cfg, name, train=True, size=2)
    tgt = {k: batch[k] for k in ("pos_equal_one", "neg_equal_one",
                                 "targets")}
    rng = np.random.RandomState(5)
    b, h, w, a = tgt["pos_equal_one"].shape
    widths = {"cls_preds": a, "reg_preds": 7 * a, "dir_preds": 2 * a}
    if name == "ciassd":
        widths["iou_preds"] = a
    want_out = {k: rng.randn(b, h, w, c).astype(np.float32)
                for k, c in widths.items()}
    out = {k: torch.from_numpy(v) for k, v in want_out.items()}
    jcrit, crit = build_jax_loss(cfg["loss"]), build_loss(cfg["loss"])
    if hasattr(jcrit, "set_anchors"):
        anchors = jax_build_dataset(cfg, train=False).anchors
        jcrit.set_anchors(anchors)
        crit.set_anchors(anchors)
    want_total, want_aux = jcrit(jax.tree.map(jnp.asarray, want_out),
                                 jax.tree.map(jnp.asarray, tgt))
    total, aux = crit(out, {k: torch.from_numpy(v) for k, v in tgt.items()})
    assert sorted(aux) == sorted(want_aux)
    if name == "ciassd":
        assert float(want_aux["iou_loss"]) > 0
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-6,
                                   err_msg=k)


# gradients that are zero by construction: a conv bias feeding a
# train-mode batch norm, whose mean subtraction removes it (VoxelNet's
# two 3D convs). JAX's f64 step gives |g| ~ 1e-13 and the port's f64 step
# agrees; the port's f32 value is the rounding of a sum over every voxel
# (measured 1.3e-3 and 9.2e-5), so it is held to 0 in f64 only
ZERO_BY_CONSTRUCTION = {
    "voxel_net": ("['VoxelNetEncoder_0']['Conv_0']['bias']",
                  "['VoxelNetEncoder_0']['Conv_1']['bias']"),
}


def _port_step(cfg, params, stats, crit, batch, dtype):
    """One port step in ``dtype`` -> (aux, the gradient leaves)."""
    model = port_model(cfg, params, stats).to(dtype)
    opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                    cfg["lr_scheduler"], 4)
    port = Trainer(model, crit, opt, schedule, rng_seed=None)
    b = to_device(batch, "cpu")
    if dtype == torch.float64:
        b = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
             else v for k, v in b.items()}
    aux = port.train_step(b)
    # a parameter the loss never reads (the direction head without a
    # direction term) has no gradient here and a zero one in JAX
    grads = _leaves(to_flax({
        k: p.grad if p.grad is not None else torch.zeros_like(p)
        for k, p in model.named_parameters()})[0])
    return aux, grads


def train_step_matches_jax(cfg, name, size=2):
    """One port step against JAX's f64 step from the same variables: the
    port's f64 step at 1e-5 (loss terms relative, every gradient leaf);
    its f32 step's loss terms 1e-5 relative and every gradient leaf
    within 1e-4 but the ones zero by construction
    (ZERO_BY_CONSTRUCTION, below 1e-9 in both f64 steps). -> JAX's aux."""
    batch = legacy_batch(cfg, name, train=True, size=size)
    params, stats = port_variables(cfg, seed=1)
    jcrit, crit = build_jax_loss(cfg["loss"]), build_loss(cfg["loss"])
    if hasattr(jcrit, "set_anchors"):
        anchors = jax_build_dataset(cfg, train=False).anchors
        jcrit.set_anchors(anchors)
        crit.set_anchors(anchors)
    jt = JaxTrainer(model=build_flax(cfg["model"]), criterion=jcrit, tx=None)
    want_aux, _, grads = _jax_f64_step(jt, params, stats, batch)
    want = _leaves(grads)
    zero = ZERO_BY_CONSTRUCTION.get(name, ())
    for dtype, tol in ((torch.float64, 1e-5), (torch.float32, 1e-4)):
        aux, got = _port_step(cfg, params, stats, crit, batch, dtype)
        assert sorted(aux) == sorted(want_aux)
        for k, w in want_aux.items():
            np.testing.assert_allclose(aux[k].item(), w, rtol=1e-5,
                                       err_msg=k)
        assert got.keys() == want.keys()
        for k in zero:
            assert np.abs(want[k]).max() < 1e-9, k
            if dtype == torch.float64:
                assert np.abs(got[k]).max() < 1e-9, k
        errs = {k: _rel(g, want[k]) for k, g in got.items()
                if dtype == torch.float64 or k not in zero}
        assert max(errs.values()) <= tol, (dtype, max(errs.items(),
                                                      key=lambda x: x[1]))
    return want_aux


@pytest.mark.parametrize("name", ["voxel_net", "ciassd"])
def test_train_step_matches_jax_f64(name):
    """VoxelNet (its 3D convs, the voxel max's gradient) and CIA-SSD (the
    SSFA neck, the IoU term) at batch 2."""
    aux = train_step_matches_jax(legacy_cfg(name), name)
    if name == "ciassd":
        assert float(aux["iou_loss"]) > 0
