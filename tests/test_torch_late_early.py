"""Late and early fusion's host side, port vs heal_tpu, on the CPU.

heal_tpu_torch/data/{augmentor,late_early}.py, the late-heter packing,
``collate`` of late fusion's ``agent_samples`` and the
``load_point_pillar_params`` parser against their heal_tpu copies. Both
are the same numpy arithmetic on the same seeds, so each comparison is
exact (keys, dtypes, shapes, ``np.array_equal``), with heal_tpu's C++
anchor IoU turned off (tests/test_torch_host.py) and numpy's global
state seeded before each package draws (``LateAssembler`` picks its
train agent and ``EarlyAssembler`` subsamples with it). The camera
images alone are compared by shape, dtype, padding and moments: both
packages seed the synthetic rig from ``id(scene)`` (ROADMAP §3). The
published ``data_augment`` draws from OS entropy in both packages
(ROADMAP §3), so the augmentor is held with a fixed seed and the
assemblers' augmentation by what it must keep.
"""
import copy

import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.data import augmentor as jax_aug
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu_torch.config import load_yaml
from heal_tpu_torch.data import augmentor, build_dataset
from heal_tpu_torch.data.scene import collate
from heal_tpu_torch.parallel import pin, to_device

torch.set_num_threads(1)
TINY = "tests/configs/tiny_late.yaml"
M1M2 = "tests/configs/tiny_heter_m1m2.yaml"
PUBLISHED_AUG = jax_load_yaml(
    "heal_tpu/configs/opv2v/lidar_only/late_fusion.yaml")["data_augment"]


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def _assert_same(got, want, path=""):
    assert type(got) is type(want) or not isinstance(want, (dict, list)), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    assert np.array_equal(got, want), path


def _batches(build, cfg, train, size=2, **kw):
    np.random.seed(11)
    return list(build(cfg, train=train).batches(size, shuffle=False, **kw))


def _pair(cfg, train, size=2):
    return (_batches(build_dataset, copy.deepcopy(cfg), train, size),
            _batches(jax_build_dataset, copy.deepcopy(cfg), train, size,
                     process_split=False))


def _points_boxes(seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, (500, 4)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-30, 30, (12, 3)),
                            rng.uniform(1, 5, (12, 3)),
                            rng.uniform(-3, 3, (12, 1))], axis=1)
    return pts, boxes


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", ["flip", "rotation", "scaling", "chain"])
def test_augmentations_equal_heal_tpu(name, seed):
    pts, boxes = _points_boxes(seed)
    if name == "chain":
        got = augmentor.DataAugmentor(PUBLISHED_AUG + [
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]}])(
                pts, boxes, seed=seed)
        want = jax_aug.DataAugmentor(PUBLISHED_AUG + [
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]}])(
                pts, boxes, seed=seed)
    else:
        fn, args = {"flip": ("random_flip", (("x", "y"),)),
                    "rotation": ("global_rotation", ((-0.5, 0.9),)),
                    "scaling": ("global_scaling", ((0.9, 1.1),))}[name]
        got = getattr(augmentor, fn)(pts.copy(), boxes.copy(),
                                     np.random.default_rng(seed), *args)
        want = getattr(jax_aug, fn)(pts.copy(), boxes.copy(),
                                    np.random.default_rng(seed), *args)
    for g, w in zip(got, want):
        _assert_same(g, w)
    if name == "chain":  # a copy, never in place
        assert not np.array_equal(got[0], pts)
        assert np.array_equal(pts, _points_boxes(seed)[0])


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("method", ["late", "early"])
def test_assembled_batches_equal_heal_tpu(method, train):
    cfg = jax_load_yaml(TINY)
    assert "data_augment" not in cfg
    cfg["fusion"]["core_method"] = method
    got, want = _pair(cfg, train)
    assert len(got) == len(want) == (4 if train else 2)
    _assert_same(got, want)
    first = got[0]
    assert first["points"].shape == (2, 6000, 4)
    if method == "late" and not train:
        # the ego's sample, and each other agent's with its transform
        assert [len(a) for a in first["agent_samples"]] == [1, 1]
        other = first["agent_samples"][0][0]
        assert other["points"].shape == (6000, 4)
        assert not np.allclose(other["transformation_matrix"], np.eye(4))
        np.testing.assert_array_equal(first["transformation_matrix"][0],
                                      np.eye(4, dtype=np.float32))
    else:
        assert "agent_samples" not in first
    if method == "early":  # both agents' points, merged before the range cut
        single = _pair(dict(cfg, fusion=dict(cfg["fusion"],
                                             core_method="late")),
                       False)[0][0]
        assert first["point_mask"][0].sum() > single["point_mask"][0].sum()


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_late_heter_packing_equal_heal_tpu(train):
    """tiny_heter_m1m2.yaml as lateheter: each sample carries both types'
    inputs (zeros for the type it is not) and its one-hot flags; m2
    agents' camera arrays equal but for the images' draw."""
    cfg = jax_load_yaml(M1M2)
    cfg["fusion"]["core_method"] = "lateheter"
    got, want = _pair(cfg, train, size=1)
    samples = lambda bs: [b for b in bs] + [  # noqa: E731
        collate([s]) for b in bs for s in b.get("agent_samples", [[]])[0]]
    got, want = samples(got), samples(want)
    assert len(got) == len(want)
    flags = []
    for g, w in zip(got, want):
        g = copy.deepcopy(g)
        w = copy.deepcopy(w)
        g.pop("agent_samples", None)
        w.pop("agent_samples", None)
        gi, wi = g["inputs_m2"].pop("imgs"), w["inputs_m2"].pop("imgs")
        _assert_same(g, w)
        assert gi.dtype == wi.dtype and gi.shape == wi.shape == (
            1, 4, 128, 192, 3)
        real = bool(wi.any())
        assert bool(gi.any()) == real == (g["modality_flags"][0, 1] == 1)
        if real:
            assert abs(gi.mean() - wi.mean()) < 5e-3
            assert abs(gi.std() - wi.std()) < 5e-3
        else:  # an m1 sample: zero camera inputs, its own points
            assert np.array_equal(g["inputs_m1"]["points"], g["points"])
        flags.append(g["modality_flags"][0].tolist())
    assert [1.0, 0.0] in flags and [0.0, 1.0] in flags
    for f in flags:
        assert sum(f) == 1.0


@pytest.mark.parametrize("method", ["late", "early"])
def test_packed_points_are_pillar_sorted(method):
    """The presort contract of every packing site (heal_tpu's
    tests/test_late_inference.py::TestLatePresortContract)."""
    cfg = load_yaml(TINY)
    cfg["fusion"]["core_method"] = method
    for train in (True, False):
        s = build_dataset(cfg, train=train)[0]
        for sample in [s] + s.get("agent_samples", []):
            pts = sample["points"][sample["point_mask"]]
            r = cfg["preprocess"]["cav_lidar_range"]
            vx, vy = cfg["preprocess"]["args"]["voxel_size"][:2]
            nx = int(round((r[3] - r[0]) / vx))
            ids = (np.floor((pts[:, 1] - r[1]) / vy).astype(np.int64) * nx
                   + np.floor((pts[:, 0] - r[0]) / vx).astype(np.int64))
            assert len(ids) > 100 and (np.diff(ids) >= 0).all()


def test_collate_keeps_agent_samples_on_the_host():
    cfg = load_yaml(TINY)
    ds = build_dataset(cfg, train=False)
    batch = collate([ds[0], ds[1]])
    assert isinstance(batch["agent_samples"], list)
    assert [len(a) for a in batch["agent_samples"]] == [1, 1]
    assert batch["points"].shape == (2, 6000, 4)
    for conv in (lambda b: pin(b, "cpu"), lambda b: to_device(b, "cpu")):
        out = conv(batch)
        assert isinstance(out["points"], torch.Tensor)
        assert out["agent_samples"] is batch["agent_samples"]
        assert isinstance(out["agent_samples"][0][0]["points"], np.ndarray)


@pytest.mark.parametrize("path", [TINY, "tests/configs/tiny_intermediate.yaml",
                                  "heal_tpu/configs/demo_synthetic.yaml"])
def test_point_pillar_params_equal_heal_tpu(path):
    got, want = load_yaml(path), jax_load_yaml(path)
    assert got["yaml_parser"] == "load_point_pillar_params"
    grid = got["model"]["args"]["point_pillar_scatter"]["grid_size"]
    assert grid.dtype == np.int64 and grid.shape == (3,)
    _assert_same(got, want)


@pytest.mark.parametrize("method", ["late", "early"])
def test_published_augmentation_keeps_the_boxes(method):
    """The published chain (flip along x, rotation, scaling) in train
    samples: the same GT boxes, each scaled by one common factor in
    [0.95, 1.05], every point in range; drawn from OS entropy, so two
    assemblies of one scene differ (ROADMAP §3)."""
    cfg = load_yaml(TINY)
    cfg["fusion"]["core_method"] = method
    plain = copy.deepcopy(cfg)
    cfg["data_augment"] = copy.deepcopy(PUBLISHED_AUG)
    ds, ref = build_dataset(cfg, train=True), build_dataset(plain,
                                                            train=True)
    np.random.seed(5)
    a = ds[0]
    np.random.seed(5)
    b = ds[0]
    np.random.seed(5)
    c = ref[0]
    assert not np.array_equal(a["points"], b["points"])
    r = cfg["preprocess"]["cav_lidar_range"]
    for s in (a, b):
        pts = s["points"][s["point_mask"]]
        assert (pts[:, 0] >= r[0]).all() and (pts[:, 0] <= r[3]).all()
        assert (pts[:, 1] >= r[1]).all() and (pts[:, 1] <= r[4]).all()
    # the labels follow the augmented boxes (late: the picked agent's)
    n = int(c["gt_mask"].sum())
    assert n > 0
    aug_boxes = _train_boxes(ds, seed=5)
    plain_boxes = _train_boxes(ref, seed=5)
    assert len(aug_boxes) == len(plain_boxes)
    ratio = aug_boxes[:, 3:6] / plain_boxes[:, 3:6]
    assert np.allclose(ratio, ratio[0, 0], rtol=1e-6)
    assert 0.95 <= ratio[0, 0] <= 1.05


def _train_boxes(ds, seed):
    """The (n, 7) hwl boxes the train sample's labels were made from:
    ``_gt_in_frame`` as the assembler augments it."""
    from heal_tpu_torch.data import late_early

    seen = []
    real = late_early.generate_targets

    def spy(gt, mask, *a, **k):
        seen.append(np.asarray(gt)[np.asarray(mask) > 0])
        return real(gt, mask, *a, **k)

    late_early.generate_targets = spy
    try:
        np.random.seed(seed)
        ds[0]
    finally:
        late_early.generate_targets = real
    return seen[0]


def test_late_m3_presort_with_presorted_encoder_merges_voxels():
    """ROADMAP §3 (high): the published single/m3_pretrain.yaml sets the
    SECOND encoder's ``presorted``, but ``LateAssembler`` orders points by
    the 2-D pillar key only, so the encoder's running max merges points
    into wrong voxels and raises nothing. The port inherits it: its BEV
    on the late sample equals JAX's (same weights, same points) and
    differs from the BEV of the same points in voxel-key order."""
    import jax
    import jax.numpy as jnp

    from heal_tpu.models.second import SecondEncoder as JaxSecondEncoder
    from heal_tpu_torch.models import build_model
    from heal_tpu_torch.models.layers import init_weights
    from heal_tpu_torch.utils.bridge import to_flax

    cfg = load_yaml("tests/configs/entry_m3_single.yaml")
    cfg["fusion"]["core_method"] = "lateheter"
    a = cfg["model"]["args"]["m3"]["encoder_args"]
    a["presorted"] = True
    got, want = _pair(cfg, False, size=2)
    _assert_same(got, want)
    pts, mask = got[0]["inputs_m3"]["points"], got[0]["inputs_m3"][
        "point_mask"]
    ds = build_dataset(cfg, train=False)
    vs = cfg["heter"]["modality_setting"]["m3"]["preprocess"]["args"][
        "voxel_size"]
    voxel_sorted = pts.copy()
    for i in range(len(pts)):
        n = int(mask[i].sum())
        voxel_sorted[i, :n] = ds.assembler._presort_voxel(pts[i, :n], vs)
    assert not np.array_equal(voxel_sorted, pts)
    enc = init_weights(build_model(cfg["model"]),
                       torch.Generator().manual_seed(3)).branch_m3.encoder
    params, _ = to_flax(enc.state_dict())
    jenc = JaxSecondEncoder(
        voxel_size=tuple(a["voxel_size"]), lidar_range=tuple(a["lidar_range"]),
        channels=tuple(a["second"]["channels"]),
        max_voxels=tuple(a["second"]["max_voxels"]), presorted=True)
    with torch.no_grad():
        bev, good = (enc(torch.from_numpy(p), torch.from_numpy(mask)).numpy()
                     for p in (pts, voxel_sorted))
    ref = np.asarray(jax.device_get(jax.jit(lambda p, m: jenc.apply(
        {"params": params}, p, m))(jnp.asarray(pts), jnp.asarray(mask))))
    scale = 1.0 + np.abs(ref).max()
    assert np.abs(bev - ref).max() / scale <= 1e-5
    assert np.abs(bev - good).max() / scale > 1e-2
