"""The port's own numpy host side against heal_tpu's, on the CPU.

heal_tpu_torch keeps a copy of the numpy host side it needs (config/,
data/, postprocess/anchors.py and targets.py, utils/*_np.py) and imports
nothing of heal_tpu. Both sides are the same numpy arithmetic on the same
seeds, so every comparison here is exact: same keys, dtypes and shapes,
``np.array_equal``. heal_tpu labels the anchors with its C++ host
loader's f32 IoU where its library is built and with numpy's otherwise,
and the two differ on a few flagship labels (ROADMAP §3, fault 4). The
port has both: its own native library (heal_tpu_torch/native, the
default) and ``native_iou=False``. So each comparison pins both packages
to one path: numpy (heal_tpu's library turned off), or the native
libraries (heal_tpu's built from its source into a temporary directory
with the same flags).
"""
import copy
import os
import subprocess

import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.config import load_yaml
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.utils import box_np as jax_box_np
from heal_tpu.utils import eval_np as jax_eval_np
from heal_tpu_torch import native
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.tools.train import load_config
from heal_tpu_torch.utils import box_np, eval_np

torch.set_num_threads(1)
CONFIGS = ["tests/configs/entry_tiny.yaml",
           "heal_tpu/configs/opv2v_m1_pyramid.yaml"]


def _assert_same(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    assert np.array_equal(got, want), path


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("path", CONFIGS, ids=["entry_tiny", "flagship"])
def test_collated_batches_equal_heal_tpu(path, train, monkeypatch):
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)
    cfg = load_yaml(path)
    cfg["fusion"]["args"].update(num_scenes_train=2, num_scenes_test=2)

    got, got_anchors = _first_batch(build_dataset, cfg, train,
                                    native_iou=False)
    want, want_anchors = _first_batch(jax_build_dataset, cfg, train,
                                      process_split=False)
    assert want["agent_mask"].sum() >= 3  # collaborations on both scenes
    _assert_same(got, want)
    _assert_same(got_anchors, want_anchors)


def _first_batch(build, cfg, train, native_iou=None, **kw):
    """``native_iou`` for the port's dataset; ``kw`` for heal_tpu's
    ``batches``."""
    np.random.seed(0)  # the train split's point subsampling
    build_kw = {} if native_iou is None else {"native_iou": native_iou}
    ds = build(copy.deepcopy(cfg), train=train, **build_kw)
    return next(ds.batches(2, shuffle=train, seed=3, **kw)), ds.anchors


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", np.asarray(v)


# elements that the C++ f32 anchor IoU labels differently from the numpy
# IoU: a few flagship single-agent labels near the matching thresholds,
# in the test split's first batch (ROADMAP §3, fault 4)
NATIVE_DIFF = {
    ("flagship", False): {"/pos_equal_one_single": 8,
                          "/neg_equal_one_single": 2,
                          "/targets_single": 56},
}


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("path", CONFIGS, ids=["entry_tiny", "flagship"])
def test_native_anchor_iou_label_differences(path, train, tmp_path,
                                             monkeypatch):
    """The port's native labels equal heal_tpu's native labels: both
    libraries built from their sources with the same flags (heal_tpu's
    into tmp_path, not beside its sources, where another test may be
    building it). Each differs from its numpy labels by NATIVE_DIFF, the
    labels a JAX run trains on when its library is built."""
    src = os.path.join(os.path.dirname(heal_tpu.native.__file__),
                       "loader.cpp")
    lib = tmp_path / "libheal_loader.so"
    subprocess.run(["g++", *native.GXX_FLAGS, src, "-o", str(lib)],
                   check=True)
    monkeypatch.setattr(heal_tpu.native, "_LIB_PATH", str(lib))
    monkeypatch.setattr(heal_tpu.native, "_LIB", None)
    assert heal_tpu.native.available()
    cfg = load_yaml(path)
    cfg["fusion"]["args"].update(num_scenes_train=2, num_scenes_test=2)
    got = dict(_leaves(_first_batch(build_dataset, cfg, train)[0]))
    want = dict(_leaves(_first_batch(jax_build_dataset, cfg, train,
                                     process_split=False)[0]))
    _assert_same(got, want)
    numpy_labels = dict(_leaves(_first_batch(build_dataset, cfg, train,
                                             native_iou=False)[0]))
    diff = {key: int((numpy_labels[key] != g).sum())
            for key, g in got.items()
            if not np.array_equal(numpy_labels[key], g)}
    name = "entry_tiny" if path == CONFIGS[0] else "flagship"
    assert diff == NATIVE_DIFF.get((name, train), {})


CAMERA_KEYS = ("intrins", "rots", "trans", "post_rots", "post_trans",
               "depth_bins", "splat_ids", "splat_widx", "splat_cell",
               "splat_dperm")


@pytest.mark.parametrize("labels", ["lidar", "camera"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_camera_batches_equal_heal_tpu(train, labels, monkeypatch):
    """tests/configs/tiny_heter_m1m2.yaml (an m1 ego and an m2 camera
    agent): every key equal to heal_tpu's, the camera calibration, depth
    targets and splat plans exactly; the images by shape, dtype, padding
    and moments only, since both packages seed the synthetic rig from
    ``id(scene)`` (ROADMAP §3). ``label_type: camera`` keeps the GT the
    rig can see (the visibility rasters, equal)."""
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)
    cfg = load_yaml("tests/configs/tiny_heter_m1m2.yaml")
    cfg["label_type"] = labels
    got, _ = _first_batch(build_dataset, cfg, train, native_iou=False)
    want, _ = _first_batch(jax_build_dataset, cfg, train,
                           process_split=False)
    imgs, want_imgs = got["inputs_m2"].pop("imgs"), want["inputs_m2"].pop(
        "imgs")
    _assert_same(got, want)
    assert sorted(got["inputs_m2"]) == sorted(CAMERA_KEYS)
    assert imgs.dtype == want_imgs.dtype and imgs.shape == want_imgs.shape
    real = want_imgs.reshape(want_imgs.shape[:2] + (-1,)).any(-1)
    np.testing.assert_array_equal(
        imgs.reshape(imgs.shape[:2] + (-1,)).any(-1), real)
    assert real.sum() >= 2  # a camera agent in each sample
    for a, b in ((imgs[real], want_imgs[real]),):
        assert abs(a.mean() - b.mean()) < 5e-3
        assert abs(a.std() - b.std()) < 5e-3
    assert not np.array_equal(imgs, want_imgs)  # the id(scene) seed
    assert (got["inputs_m2"]["depth_bins"] < 8).any()  # depth targets


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("path", ["tests/configs/entry_m3_single.yaml",
                                  "tests/configs/entry_m1m2m3m4_final.yaml"],
                         ids=["m3_single", "m1m2m3m4"])
def test_second_batches_equal_heal_tpu(path, train, monkeypatch):
    """SECOND agents (m3): their points sorted by the full voxel key at the
    modality's voxel size, never aliased to the top-level arrays, every
    key equal to heal_tpu's; ``_presort_voxel`` itself equal on points
    with some out of range."""
    from heal_tpu.data.scene import IntermediateAssembler as JaxAssembler
    from heal_tpu_torch.data.scene import IntermediateAssembler

    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)
    cfg = load_yaml(path)
    got, _ = _first_batch(build_dataset, cfg, train, native_iou=False)
    want, _ = _first_batch(jax_build_dataset, cfg, train,
                           process_split=False)
    _assert_same(got, want)
    m3 = got["inputs_m3"]
    assert m3["points"] is not got["points"] and m3["point_mask"].any()
    vs = cfg["heter"]["modality_setting"]["m3"]["preprocess"]["args"][
        "voxel_size"]
    ours, theirs = (cls(cfg, train=train) for cls in (IntermediateAssembler,
                                                      JaxAssembler))
    rng = np.random.default_rng(0)
    r = np.array(cfg["preprocess"]["cav_lidar_range"], np.float32)
    pts = rng.uniform(r[:3] - 1, r[3:] + 1, (500, 3)).astype(np.float32)
    pts = np.concatenate([pts, rng.uniform(0, 1, (500, 1))], 1).astype(
        np.float32)
    _assert_same(ours._presort_voxel(pts, vs), theirs._presort_voxel(pts, vs))
    assert not np.array_equal(ours._presort_voxel(pts, vs), ours._presort(pts))


@pytest.mark.parametrize("path", CONFIGS, ids=["entry_tiny", "flagship"])
def test_load_config_equals_heal_tpu(path):
    assert load_config(path) == load_yaml(path)


def _random_boxes(rng, n):
    """(n, 7) hwl boxes around the ego, some overlapping."""
    b = np.zeros((n, 7))
    b[:, :2] = rng.uniform(-20, 20, (n, 2))
    b[:, 2] = rng.uniform(-1.5, 0.0, n)
    b[:, 3:6] = rng.uniform([1.4, 1.5, 3.5], [1.8, 2.0, 4.8], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_box_ious_equal_heal_tpu():
    rng = np.random.default_rng(0)
    a, g = _random_boxes(rng, 40), _random_boxes(rng, 25)
    g[:10] = a[:10] + rng.normal(0, 0.3, (10, 7))  # near matches
    ca, cg = (box_np.boxes_to_corners_3d(x, "hwl") for x in (a, g))
    _assert_same(ca, jax_box_np.boxes_to_corners_3d(a, "hwl"))
    poly = box_np.polygon_iou_matrix(ca, cg)
    assert poly.max() > 0.3
    _assert_same(poly, jax_box_np.polygon_iou_matrix(ca, cg))
    sa, sg = (box_np.corners_to_standup_2d(c[:, :4]) for c in (ca, cg))
    _assert_same(box_np.standup_iou_matrix(sa, sg),
                 jax_box_np.standup_iou_matrix(sa, sg))


def test_eval_ap_equals_heal_tpu():
    rng = np.random.default_rng(1)
    stats = [m.new_result_stat((0.3, 0.5, 0.7)) for m in (eval_np, jax_eval_np)]
    for _ in range(4):  # frames
        gt = _random_boxes(rng, 12)
        det = np.concatenate([gt[:9] + rng.normal(0, 0.2, (9, 7)),
                              _random_boxes(rng, 5)])
        scores = rng.uniform(0.2, 1.0, len(det))
        cd, cg = (box_np.boxes_to_corners_3d(x, "hwl") for x in (det, gt))
        for t in (0.3, 0.5, 0.7):
            eval_np.calculate_tp_fp(cd, scores, cg, stats[0], t)
            jax_eval_np.calculate_tp_fp(cd, scores, cg, stats[1], t)
    got = eval_np.eval_final_results(stats[0])
    want = jax_eval_np.eval_final_results(stats[1])
    assert 0.2 < got["ap_50"] < 1.0
    assert got == want


def _set(key, value):
    def edit(cfg):
        node = cfg
        *head, last = key.split(".")
        for k in head:
            node = node[k]
        node[last] = value
    return edit


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("edit", [
    _set("fusion.core_method", "intermediate2stage"),
    _set("kd_flag", True),
], ids=["two_stage", "kd_teacher"])
def test_two_stage_and_kd_batches_equal_heal_tpu(edit, train, monkeypatch):
    """The two host paths ported last: FPV-RCNN's ``intermediate2stage``
    (the intermediate assembler with the per-agent labels forced on) and
    DiscoNet's ``kd_flag`` teacher view (every agent's points merged in
    the ego frame, subsampled by numpy's global random state), exactly
    equal to heal_tpu's with numpy's seed set before each package."""
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)
    cfg = load_yaml(CONFIGS[0])
    cfg["fusion"]["args"].update(num_scenes_train=2, num_scenes_test=2)
    edit(cfg)
    got, _ = _first_batch(build_dataset, cfg, train, native_iou=False)
    want, _ = _first_batch(jax_build_dataset, cfg, train,
                           process_split=False)
    extra = ("pos_equal_one_single" if "kd_flag" not in cfg
             else "teacher_points")
    assert extra in want
    _assert_same(got, want)
