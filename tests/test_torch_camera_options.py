"""The camera-only table, the standalone Lift-Splat-Shoot detectors and
the models' options, port vs JAX, on the CPU.

One numpy batch feeds both packages and one set of flax variables (JAX's
init, running statistics randomised) is bridged strictly into the port.
Tolerances as max |d| / (1 + max |JAX|):

  * ``lift_splat_shoot``, ``lift_splat_shoot_voxel`` (the max pool) and
    ``lift_splat_shoot_intermediate`` (max fusion, a padded slot, moved
    agents) on heal_tpu's tests/test_zoo_variants.py ``LSS_ARGS``:
    heads, depth logits and the map, 1e-5;
  * opv2v/camera_only/attfuse.yaml cut narrow in code (``_camera_only``:
    16 image features, 8 depth bins, a one-block 16-channel branch, the
    camera grid covering the 16x32 label grid) on a synthetic test
    frame: heads, their ``_single`` twins and the depth logits, 1e-5;
    with a camera grid half the lidar range (as the published 128x128
    one against 128x256) the port pads the camera BEV to the label grid
    and trains, while heal_tpu's baseline leaves it short and its loss
    fails on the shapes;
  * ``heter_model_late`` on JAX's default group norm (every branch
    norm group, the m1 PointPillars encoder on its general path, no
    kernel 1) with ``use_iou``: heads, ``iou_preds`` and the depth logits,
    1e-5;
  * ``use_iou`` in the collab, single and baseline models: JAX's
    variables (``eval_shape``, ``iou_head`` among them) load strictly.
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
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu_torch.data.scene import collate
from heal_tpu_torch.models import build_model
from heal_tpu_torch.models import encoders as tenc
from heal_tpu_torch.parallel import to_device
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.utils.bridge import load_flax, to_flax
from test_torch_camera_slice import _seeded_images
from test_torch_late_inference import _late_samples, late_heter_cfg
from test_torch_point_pillar import _random_stats, _rel, _tensors
from test_zoo_variants import LSS_ARGS, _camera_batch

torch.set_num_threads(1)
TOL = 1e-5
HEADS = ("cls_preds", "reg_preds", "dir_preds")
ATTFUSE = "heal_tpu/configs/opv2v/camera_only/attfuse.yaml"


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def _jax_variables(jm, jb, seed=0):
    v = jax.device_get(jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(seed), b, train=False))(jb))
    return {"params": v["params"],
            "batch_stats": _random_stats(v.get("batch_stats", {}), seed)}


def _compare(got: dict, want: dict):
    for k, w in want.items():
        g = got[k].detach().numpy()
        assert g.shape == np.shape(w), (k, g.shape, np.shape(w))
        assert _rel(g, w) <= TOL, (k, _rel(g, w))


def _lss_batch(name: str):
    rng = np.random.default_rng(8)
    if name != "lift_splat_shoot_intermediate":
        return {"camera": _camera_batch(rng, 2)}
    b, l = 1, 3
    aff = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32),
                  (b, l, l, 1, 1))
    # agent 1 turned and moved in the ego's normalised frame
    c, s = np.cos(0.3), np.sin(0.3)
    aff[0, 0, 1] = [[c, -s, 0.2], [s, c, -0.1]]
    return {"inputs_m2": _camera_batch(rng, b, l),
            "agent_mask": jnp.asarray([[True, True, False]]),
            "pairwise_affine": jnp.asarray(aff)}


@pytest.mark.parametrize("name", ["lift_splat_shoot",
                                  "lift_splat_shoot_voxel",
                                  "lift_splat_shoot_intermediate"])
def test_standalone_lss_matches_jax(name):
    args = dict(LSS_ARGS, fusion_method="max") if "inter" in name \
        else LSS_ARGS
    cfg = {"core_method": name, "args": copy.deepcopy(args)}
    batch = _lss_batch(name)
    jm = build_flax(cfg)
    v = _jax_variables(jm, batch, seed=3)
    keys = HEADS + ("depth_items", "spatial_features_2d")
    want = jax.device_get(jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items()
        if k in keys})(v, batch))
    model = load_flax(build_model(cfg, max_cav=3), v["params"],
                      v["batch_stats"]).eval()
    if name == "lift_splat_shoot_voxel":
        assert model.lss_max.encoder.pool == "max"
    with torch.no_grad():
        got = model(_tensors(jax.tree.map(np.array, batch)))
    # LSS_ARGS has no dir_args
    assert sorted(want) == sorted(set(keys) - {"dir_preds"})
    _compare(got, want)
    lead = 1 if "inter" in name else 2
    assert got["cls_preds"].shape == (lead, 16, 16, 2)


def _camera_only(covered: bool = True):
    """camera_only/attfuse.yaml at CPU size on the synthetic backend (3
    agents, 6 vehicles): the lidar range +-51.2 x +-25.6 m in 1.6 m
    pillars (a 16x32 label grid); 4 cameras at 64x96, 8 depth bins, 16
    image features; the m2 branch one 16-channel block and one ConvNeXt
    block, the shrink, the heads and ``att`` at 16. ``covered``: a
    3.2 m camera grid over the whole range (16x32 cells), else over
    +-25.6 m (16x16, padded to 16x32 as the published 128x128 grid is
    to 128x256)."""
    cfg = jax_load_yaml(ATTFUSE)
    rng = [-51.2, -25.6, -3, 51.2, 25.6, 1]
    cfg["cav_lidar_range"] = rng
    cfg["preprocess"]["cav_lidar_range"] = rng
    cfg["preprocess"]["args"].update(voxel_size=[1.6, 1.6, 4],
                                     max_points=2000)
    cfg["postprocess"]["gt_range"] = rng
    cfg["postprocess"]["anchor_args"]["cav_lidar_range"] = rng
    cfg["train_params"].update(max_cav=3, batch_size=2)
    cfg["fusion"]["dataset"] = "synthetic"
    cfg["fusion"]["args"].update(num_scenes_train=2, num_scenes_test=1,
                                 num_agents=3, num_vehicles=6)
    half = 51.2 if covered else 25.6
    grid = {"xbound": [-half, half, 3.2], "ybound": [-25.6, 25.6, 3.2],
            "zbound": [-10, 10, 20.0], "ddiscr": [2, 50, 8], "mode": "LID"}
    setting = cfg["heter"]["modality_setting"]["m2"]
    setting["grid_conf"] = grid
    setting["data_aug_conf"]["final_dim"] = [64, 96]
    a = cfg["model"]["args"]
    a["lidar_range"] = rng
    enc = a["m2"]["encoder_args"]
    enc.update(grid_conf=grid, img_features=16)
    enc["data_aug_conf"]["final_dim"] = [64, 96]
    a["m2"]["camera_mask_args"]["grid_conf"] = grid
    a["m2"]["backbone_args"].update(layer_nums=[1], num_filters=[16])
    a["m2"]["aligner_args"]["args"]["num_of_blocks"] = 1
    a["shrink_header"].update(dim=[16], input_dim=16)
    a["in_head"] = 16
    a["att"] = {"in_channels": 16}
    return PARSER_REGISTRY[cfg["yaml_parser"]](cfg)


def _frame(cfg, train=False, size=1):
    np.random.seed(0)
    batch = next(jax_build_dataset(copy.deepcopy(cfg), train=train).batches(
        size, shuffle=False, process_split=False))
    return _seeded_images(batch)


def _inputs(batch):
    return _tensors({k: v for k, v in batch.items()
                     if k.startswith(("inputs_", "slots_"))
                     or k in ("agent_mask", "pairwise_affine")})


def test_camera_only_attfuse_matches_jax():
    cfg = _camera_only()
    batch = _frame(cfg)
    assert batch["inputs_m2"]["imgs"].shape == (1, 3, 4, 64, 96, 3)
    assert batch["agent_mask"].sum() == 3
    jm = build_flax(cfg["model"])
    jb = jax.tree.map(jnp.asarray, batch)
    v = _jax_variables(jm, jb, seed=1)
    keys = HEADS + tuple(f"{k}_single" for k in HEADS) + ("depth_items_m2",)
    want = jax.device_get(jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items()
        if k in keys})(v, jb))
    model = load_flax(build_model(cfg["model"], max_cav=3), v["params"],
                      v["batch_stats"]).eval()
    with torch.no_grad():
        got = model(_inputs(batch))
    assert sorted(want) == sorted(keys)
    assert got["cls_preds"].shape == (1, 16, 32, 2)
    _compare(got, want)


def test_camera_only_baseline_pads_where_heal_tpu_fails():
    """A camera grid half the lidar range: the port pads the 16x16
    camera BEV to the 16x32 label grid and trains; JAX's heads stay
    16x16 and its loss fails on the shapes."""
    cfg = _camera_only(covered=False)
    batch = _frame(cfg, train=True, size=2)
    assert batch["pos_equal_one"].shape[1:3] == (16, 32)
    tr = train_tool.build_trainer(cfg, "cpu", 1)
    aux = tr.train_step(to_device(batch, "cpu"))
    assert np.isfinite(aux["total_loss"].item())
    with torch.no_grad():
        out = tr.model.eval()(_inputs(batch))
    assert tuple(out["cls_preds"].shape[:3]) == (2, 16, 32)
    jm = build_flax(cfg["model"])
    params, stats = to_flax(tr.model.state_dict())
    want = jax.device_get(jax.jit(lambda vv, b: jm.apply(vv, b))(
        {"params": params, "batch_stats": stats},
        jax.tree.map(jnp.asarray, batch)))
    assert want["cls_preds"].shape[1:3] == (16, 16)
    jt = JaxTrainer(model=jm, criterion=build_jax_loss(cfg["loss"]),
                    tx=None)
    with pytest.raises((TypeError, ValueError)):
        jax.jit(jt._loss_fn)(params, stats, jax.tree.map(jnp.asarray, batch))


def test_late_group_norm_with_iou_matches_jax(monkeypatch):
    """tests/configs/tiny_heter_m1m2.yaml as late fusion with no
    ``norm`` (JAX's default, group) and ``use_iou``: an m1 and an m2
    sample. Group norm keeps no running statistics; the m1 encoder
    takes the general path and never calls kernel 1."""
    cfg = late_heter_cfg()
    a = cfg["model"]["args"]
    a.pop("norm", None)
    a["use_iou"] = True
    samples = _late_samples(cfg)
    batch = collate([jax.tree.map(lambda x: x[0], s) for s in samples])
    jm = build_flax(cfg["model"])
    jb = jax.tree.map(jnp.asarray, batch)
    v = _jax_variables(jm, jb)
    assert not jax.tree.leaves(v["batch_stats"])
    assert "GroupNorm_0" in v["params"]["branch_m1"]["backbone"][
        "stages_0"]["BasicBlock_0"]["ConvNormAct_0"]["Norm_0"]
    keys = HEADS + ("iou_preds", "depth_items_m2")
    want = jax.device_get(jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items()
        if k in keys})(v, jb))
    model = load_flax(build_model(cfg["model"]), v["params"])
    assert not model.branch_m1.encoder.fused

    def no_kernel(*args, **kw):
        raise AssertionError("kernel 1 on the general path")

    monkeypatch.setattr(tenc._pillar, "pillar_tables", no_kernel)
    with torch.no_grad():
        got = model.eval()(_tensors({
            k: v for k, v in batch.items()
            if k.startswith("inputs_") or k == "modality_flags"}))
    assert sorted(want) == sorted(keys)
    _compare(got, want)


@pytest.mark.parametrize("path", [
    "tests/configs/entry_tiny.yaml", "tests/configs/entry_m4_single.yaml",
    "tests/configs/tiny_heter_m1m2.yaml"])
def test_use_iou_variables_bridge_strictly(path):
    """JAX's variable tree of the model with ``use_iou`` (shapes only)
    maps onto the port's, ``heads.iou_head`` with one output an anchor;
    the last config as ``heter_model_baseline`` with max fusion."""
    cfg = jax_load_yaml(path)
    a = cfg["model"]["args"]
    a["use_iou"] = True
    if "m1m2" in path:
        cfg["model"]["core_method"] = "heter_model_baseline"
        a.pop("fusion_backbone")
        a.update(fusion_method="max", max={})
        a["shrink_header"].update(dim=[32], input_dim=32)
    np.random.seed(0)
    batch = next(jax_build_dataset(copy.deepcopy(cfg), train=False).batches(
        1, shuffle=False, process_split=False))
    jm = build_flax(cfg["model"])
    shapes = jax.eval_shape(
        lambda b: jm.init(jax.random.PRNGKey(0), b, train=False),
        jax.tree.map(jnp.asarray, batch))
    v = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = load_flax(build_model(cfg["model"], max_cav=cfg["train_params"]
                                  .get("max_cav", 5)),
                      v["params"], v.get("batch_stats", {}))
    assert v["params"]["heads"]["iou_head"]["kernel"].shape[-1] \
        == a["anchor_number"]
    assert model.heads.iou_head is not None
