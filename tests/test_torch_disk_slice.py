"""The disk datasets through the models, port vs JAX, on the CPU.

The trees of tests/test_torch_backends.py (an OPV2V-layout tree with
camera PNGs, heal_tpu's library pinned to one built with the port's
flags); batches equal between the packages (held there), so one numpy
batch feeds both models, with JAX's init bridged into the port and its
running statistics randomised. Tolerances as max |d| / (1 + max |JAX|).

  * tests/configs/tiny_heter_collab.yaml pointed at the tree: the
    ``heter_pyramid_collab`` heads on a disk test batch, JAX's m1 encoder
    on its Pallas kernel in interpret mode (``HEAL_TPU_FORCE_PALLAS=1``),
    1e-5;
  * opv2v/camera_only/m2_pyramid.yaml, a camera-only
    ``heter_pyramid_collab`` (every agent m2, its images read from the
    PNGs, the four ``data_aug_conf`` keys added) cut narrow in code
    (``_camera_only``): the camera BEV (16x16 here, 128x128 as published)
    padded to the label grid (16x32, 128x256), heads and depth logits
    1e-5;
  * the published camera configs as they are: heal_tpu raises
    ``KeyError: 'H'`` (ROADMAP §3), the port a ValueError naming the
    missing keys; with the keys added the two packages' batches are
    equal;
  * ``tools/train.py`` one epoch of the tiny config on the disk tree
    (the prefetch pipeline, the backend reinitialised each epoch), its
    final inference and ``run_inference`` on the test split.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.config.loader import PARSER_REGISTRY
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.models import build_model as build_flax
from heal_tpu_torch.config import save_yaml
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.models import build_model
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.tools.inference import run_inference
from heal_tpu_torch.utils.bridge import load_flax
from test_torch_backends import (  # noqa: F401 (fixtures)
    CONFIGS, TINY, _add_aug_keys, _point_at, _same, jax_native, trees)

torch.set_num_threads(1)
HEADS = ("cls_preds", "reg_preds", "dir_preds")
CAMERA_ONLY = os.path.join(CONFIGS, "opv2v", "camera_only", "m2_pyramid.yaml")
ALLIANCE = os.path.join(CONFIGS, "opv2v", "heal", "final_infer",
                        "m1m2m3m4.yaml")


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _random_stats(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape)
                      if p[-1].key in ("var", "bn_var")
                      else rng.uniform(-0.3, 0.3, s.shape)).astype(np.float32),
        jax.device_get(tree))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (1.0 + np.abs(want).max()))


def _test_batch(cfg):
    """The first test batch of 1, both packages' (equal), and JAX's."""
    got = next(build_dataset(copy.deepcopy(cfg), train=False).batches(
        1, shuffle=False))
    want = next(jax_build_dataset(copy.deepcopy(cfg), train=False).batches(
        1, shuffle=False, process_split=False))
    _same(got, want)
    return want


def _heads(cfg, batch, keys, seed):
    """JAX's heads from its init, and the port's with those weights."""
    jb = jax.tree.map(jnp.asarray, batch)
    jm = build_flax(cfg["model"])
    v = jax.device_get(jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(seed), b, train=False))(jb))
    variables = {"params": v["params"],
                 "batch_stats": _random_stats(v["batch_stats"], seed)}
    want = jax.device_get(jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items()
        if k in keys})(variables, jb))
    model = load_flax(build_model(cfg["model"]), variables["params"],
                      variables["batch_stats"]).eval()
    inputs = {k: batch[k] for k in batch
              if k.startswith(("inputs_", "slots_"))
              or k in ("agent_mask", "pairwise_affine")}
    with torch.no_grad():
        got = model(_tensors(inputs))
    return got, want


def test_tiny_collab_heads_on_a_disk_batch(trees, jax_native, monkeypatch):
    cfg = _point_at(jax_load_yaml(TINY), "opv2v", trees)
    batch = _test_batch(cfg)
    assert batch["agent_mask"].sum() == 3 and batch["gt_mask"].sum() > 0
    monkeypatch.setenv("HEAL_TPU_FORCE_PALLAS", "1")
    got, want = _heads(cfg, batch, HEADS, seed=2)
    for k in HEADS:
        assert tuple(got[k].shape) == want[k].shape, k
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, (
            k, _rel(got[k].numpy(), want[k]))


def _camera_only(trees):
    """opv2v/camera_only/m2_pyramid.yaml at CPU size, pointed at the
    tree, with the four aug keys (the written images' size, the demo's
    crop policy): a 16x16 camera grid (3.2 m over +-25.6 m) of 4 cameras
    at 64x96 with 8 depth bins and 16 image features, a one-block
    16/24/32 pyramid; the lidar range +-51.2 x +-25.6 m in 1.6 m pillars,
    so that the camera BEV covers half the 16x32 label grid and is padded,
    as the published 128x128 one is to 128x256; 3 agents."""
    cfg = _add_aug_keys(jax_load_yaml(CAMERA_ONLY))
    rng = [-51.2, -25.6, -3, 51.2, 25.6, 1]
    cfg["cav_lidar_range"] = rng
    cfg["preprocess"]["cav_lidar_range"] = rng
    cfg["preprocess"]["args"].update(voxel_size=[1.6, 1.6, 4],
                                     max_points=4000)
    cfg["postprocess"]["gt_range"] = rng
    cfg["postprocess"]["anchor_args"]["cav_lidar_range"] = rng
    cfg["train_params"]["max_cav"] = 3
    grid = {"xbound": [-25.6, 25.6, 3.2], "ybound": [-25.6, 25.6, 3.2],
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
    a["fusion_backbone"].update(layer_nums=[1, 1, 1],
                                num_filters=[16, 24, 32],
                                num_upsample_filter=[16, 16, 16])
    a["shrink_header"].update(dim=[32], input_dim=48)
    a["in_head"] = 32
    cfg = PARSER_REGISTRY[cfg["yaml_parser"]](cfg)
    return _point_at(cfg, "opv2v", trees)


def test_camera_only_collab_on_disk_images(trees, jax_native):
    cfg = _camera_only(trees)
    batch = _test_batch(cfg)
    # every agent is a camera agent reading its PNGs
    assert batch["agent_mask"].sum() == 3
    assert (batch["slots_m2"][0] == [0, 1, 2]).all()
    assert np.abs(batch["inputs_m2"]["imgs"]).sum() > 0
    assert (batch["inputs_m2"]["depth_bins"] < 8).any()
    assert batch["pos_equal_one"].shape[1:3] == (16, 32)
    keys = (*HEADS, "depth_items_m2")
    got, want = _heads(cfg, batch, keys, seed=5)
    assert tuple(got["cls_preds"].shape)[1:3] == (16, 32)
    for k in keys:
        assert tuple(got[k].shape) == want[k].shape, k
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, (
            k, _rel(got[k].numpy(), want[k]))


@pytest.mark.parametrize("path", [CAMERA_ONLY, ALLIANCE],
                         ids=["camera_only_m2_pyramid", "final_m1m2m3m4"])
def test_published_camera_configs_need_the_image_size(path, trees,
                                                      jax_native):
    cfg = _point_at(jax_load_yaml(path), "opv2v", trees)
    with pytest.raises(KeyError, match="'H'"):
        jax_build_dataset(copy.deepcopy(cfg), train=False)[0]
    with pytest.raises(ValueError, match=r"m2\.data_aug_conf lacks \['H', "
                                         r"'W', 'bot_pct_lim'\]"):
        build_dataset(copy.deepcopy(cfg), train=False)[0]
    with pytest.raises(ValueError, match="'resize_lim'"):
        build_dataset(copy.deepcopy(cfg), train=True)[0]
    batch = _test_batch(_add_aug_keys(cfg))
    assert np.abs(batch["inputs_m2"]["imgs"]).sum() > 0


def test_train_tool_on_a_disk_tree(trees, tmp_path):
    """One epoch of the tiny config on the OPV2V tree through
    tools/train.py (prefetch, reinitialised backend), its final inference
    on the test split, then run_inference from the run dir."""
    cfg = _point_at(jax_load_yaml(TINY), "opv2v", trees)
    path = str(tmp_path / "tiny_opv2v.yaml")
    save_yaml(cfg, path)
    run = str(tmp_path / "run")
    train_tool.main(["-y", path, "--model_dir", run, "--epochs", "1",
                     "--device", "cpu"])
    assert os.path.exists(os.path.join(run, "eval_intermediate.yaml"))
    epoch, ckpt = ckpt_lib.find_checkpoint(run)
    assert epoch == 1
    start = build_model(cfg["model"])
    sd = torch.load(ckpt, weights_only=True)
    assert sd.keys() == start.state_dict().keys()
    result = run_inference(run, device="cpu")
    assert result["frames"] == 4 and 0.0 <= result["ap_30"] <= 1.0
