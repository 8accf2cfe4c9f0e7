"""The port's disk dataset backends against heal_tpu's, on the CPU.

Small trees are written by the writers both packages ship (the port's,
held to write heal_tpu's files byte for byte): an OPV2V-layout tree with
camera PNGs, whose first scenario and its agents carry the names of the
shipped modality assignment (heal_tpu/configs/modality_assign), so that
both the assignment and the random draws are exercised, with a 16-line
sweep for the m4 agent, BEV visibility rasters and a ``_``-prefixed
folder and a ``*camera*.yaml`` file that the scan skips; the same tree
with its images packed into hdf5 by tools/img2hdf5.py; a V2XSet tree
named after its assignment; a DAIR-V2X-C tree and a V2X-Sim pickle.

heal_tpu reads points and labels anchors with its C++ library where it
finds one, with numpy otherwise. Here it is pinned either way: its
library is built into a temporary directory with the port's flags and
set as its ``_LIB_PATH``, or its ``load`` returns None; the port takes
``native_iou=False`` for the numpy labels. Every comparison is exact:
the scene dicts (agent order, modalities, poses, points, objects, camera
calibration and images) and the collated batches, leaf by leaf, dtypes
and shapes included. Train-mode camera augmentation draws from OS
entropy in both packages (ROADMAP §3), so the camera batches are held
in test mode.

tests/test_torch_disk_configs.py assembles every published config that
names a disk dataset on these trees.
"""
import copy
import filecmp
import glob
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import heal_tpu.native
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.data import dairv2x as jax_dairv2x
from heal_tpu.data import opv2v as jax_opv2v
from heal_tpu.data import v2xsim as jax_v2xsim
from heal_tpu.tools import img2hdf5 as jax_img2hdf5
from heal_tpu_torch import native
from heal_tpu_torch.data import build_dataset, dairv2x, opv2v, v2xsim
from heal_tpu_torch.tools import img2hdf5
from heal_tpu_torch.tools.train import load_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "heal_tpu", "configs")
TINY = os.path.join(REPO, "tests", "configs", "tiny_heter_collab.yaml")
ALLIANCE = os.path.join(CONFIGS, "opv2v", "heal", "final_infer",
                        "m1m2m3m4.yaml")
STAGE1 = os.path.join(CONFIGS, "opv2v", "heal", "stage1", "m1_pyramid.yaml")
V2XSET = os.path.join(CONFIGS, "v2xset", "heal", "final_infer",
                      "m1m2m3m4.yaml")
# the writer's image size and the demo alliance's policy
# (heal_tpu/configs/demo_heal_full/final_m1m2m3m4.yaml:72-83)
IMG_HW = (150, 200)
AUG_KEYS = {"H": IMG_HW[0], "W": IMG_HW[1], "resize_lim": [0.97, 1.03],
            "bot_pct_lim": [0.0, 0.05], "rot_lim": [0.0, 0.0],
            "rand_flip": False}
# scenarios of the shipped assignments: name -> its agents
OPV2V_SCENARIO = ("2021_08_18_19_11_02", ("1188", "1197", "1206", "1215"))
V2XSET_SCENARIO = ("2021_08_18_19_11_02", ("3242", "3251", "3260", "3269"))


def _name_scenario(root, name, cavs):
    """Rename the writer's first scenario and its agents."""
    src = os.path.join(root, "2021_synth_00")
    for i, cav in enumerate(cavs):
        os.rename(os.path.join(src, str(200 + i)), os.path.join(src, cav))
    os.rename(src, os.path.join(root, name))


def _opv2v_tree(root):
    opv2v.write_synthetic_opv2v_tree(root, num_scenarios=2, num_cavs=4,
                                     num_timestamps=2, seed=7, cameras=True,
                                     img_hw=IMG_HW)
    name, cavs = OPV2V_SCENARIO
    _name_scenario(root, name, cavs)
    rng = np.random.default_rng(11)
    for cdir in sorted(glob.glob(os.path.join(root, "*", "*"))):
        for ts in ("000000", "000001"):
            vis = (rng.random((256, 256)) > 0.3).astype(np.uint8) * 255
            Image.fromarray(vis).save(
                os.path.join(cdir, f"{ts}_bev_visibility.png"))
    # the m4 agent's 16-line sweep: every third point
    m4 = os.path.join(root, name, cavs[3])
    for ts in ("000000", "000001"):
        pts = opv2v._load_pcd_numpy(os.path.join(m4, f"{ts}.pcd"))[::3]
        with open(os.path.join(m4, f"{ts}_16.pcd"), "w") as f:
            f.write("VERSION .7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
                    "TYPE F F F F\nCOUNT 1 1 1 1\n"
                    f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                    f"POINTS {len(pts)}\nDATA ascii\n")
            np.savetxt(f, pts, fmt="%.4f")
    # what the scan skips: a "_" folder, a camera yaml beside the frames
    os.makedirs(os.path.join(root, name, "_unused"))
    with open(os.path.join(root, name, cavs[1], "000000_camera0.yaml"),
              "w") as f:
        yaml.safe_dump({"note": "not a frame"}, f)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("trees")
    out = {"opv2v": str(base / "opv2v"), "opv2v_h5": str(base / "opv2v_h5"),
           "v2xset": str(base / "v2xset"), "dair": str(base / "dair"),
           "v2xsim": str(base / "v2xsim")}
    _opv2v_tree(out["opv2v"])
    shutil.copytree(out["opv2v"], out["opv2v_h5"])
    assert img2hdf5.convert_tree(out["opv2v_h5"], rm_png=True) == 16
    opv2v.write_synthetic_opv2v_tree(out["v2xset"], num_cavs=4,
                                     num_timestamps=1, seed=3, cameras=True,
                                     img_hw=IMG_HW)
    _name_scenario(out["v2xset"], *V2XSET_SCENARIO)
    out["dair_split"] = dairv2x.write_synthetic_dair_tree(out["dair"], 2,
                                                          seed=5)
    out["v2xsim_pkl"] = v2xsim.write_synthetic_v2xsim_pickle(
        out["v2xsim"], num_frames=2, num_agents=3, seed=9)
    return out


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """heal_tpu.native on a library built here with the port's flags."""
    src = os.path.join(os.path.dirname(heal_tpu.native.__file__),
                       "loader.cpp")
    lib = tmp_path_factory.mktemp("jax_native") / "libheal_loader.so"
    subprocess.run(["g++", *native.GXX_FLAGS, src, "-o", str(lib)],
                   check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(heal_tpu.native, "_LIB_PATH", str(lib))
    mp.setattr(heal_tpu.native, "_LIB", None)
    assert heal_tpu.native.available()
    yield heal_tpu.native
    mp.undo()


def _same(got, want, path=""):
    """Equal trees: dict keys, list lengths, python types, array dtypes,
    shapes and values."""
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, (
            path, got.dtype, want.dtype, got.shape, want.shape)
        assert np.array_equal(got, want), path
    else:
        assert got == want, (path, got, want)


def _point_at(cfg, dataset, trees):
    """``cfg`` reading ``dataset``'s tree (only its directories change)."""
    cfg = copy.deepcopy(cfg)
    cfg["fusion"]["dataset"] = dataset
    if dataset in ("opv2v", "v2xset"):
        root = trees["v2xset" if dataset == "v2xset" else "opv2v"]
        cfg.update(root_dir=root, validate_dir=root, test_dir=root)
    elif dataset == "dairv2x":
        split = trees["dair_split"]
        cfg.update(root_dir=split, validate_dir=split, test_dir=split,
                   data_dir=trees["dair"])
    else:
        pkl = trees["v2xsim_pkl"]
        cfg.update(root_dir=pkl, validate_dir=pkl, test_dir=pkl)
    return cfg


def _add_aug_keys(cfg):
    for setting in cfg["heter"]["modality_setting"].values():
        if "data_aug_conf" in setting:
            setting["data_aug_conf"].update(copy.deepcopy(AUG_KEYS))
    return cfg


# ------------------------------------------------------------------ scenes
def _scene_cfg(name, trees):
    if name == "v2xset":
        return _point_at(load_config(V2XSET), "v2xset", trees)
    cfg = _point_at(load_config(ALLIANCE), "opv2v", trees)
    if name == "opv2v_h5":
        cfg.update(root_dir=trees["opv2v_h5"], test_dir=trees["opv2v_h5"])
    if name == "camera_labels":
        cfg["label_type"] = "camera"
    return cfg


@pytest.mark.parametrize("name", ["opv2v", "camera_labels", "opv2v_h5",
                                  "v2xset"])
def test_opv2v_scenes_equal_heal_tpu(name, trees, jax_native):
    """Agent order, modalities (the assignment's and the draws of
    ``reinitialize``), poses, points (the 16-line swap), objects,
    cameras (PNG or hdf5) and the BEV visibility rasters."""
    cfg = _scene_cfg(name, trees)
    got = opv2v.OPV2VBackend(cfg, train=False)
    want = jax_opv2v.OPV2VBackend(cfg, train=False)
    for seed in (0, 1):
        got.reinitialize(seed)
        want.reinitialize(seed)
        _same(got.frames, want.frames)
        for i in range(len(want)):
            _same(got.scene(i), want.scene(i), f"scene {i}")
    scenes = [got.scene(i) for i in range(len(got))]
    agents = [a for s in scenes for a in s["agents"]]
    assert all("cameras_raw" in a for a in agents if a["modality"] == "m2")
    assert any(a["modality"] == "m2" for a in agents)
    if name == "camera_labels":
        assert all(a["bev_visibility"].shape == (256, 256) for a in agents)
    if name != "v2xset":
        # the shipped assignment: m1 ego first, m4 reads its 16-line file
        assert [a["modality"] for a in scenes[0]["agents"]] == [
            "m1", "m3", "m2", "m4"]
        assert len(scenes[0]["agents"][3]["points"]) < len(
            scenes[0]["agents"][0]["points"]) / 2
    assert len(got) == (1 if name == "v2xset" else 4)


def test_generate_modality_assignment_equals_heal_tpu(trees, tmp_path):
    for kw in ({}, {"in_order": True}, {"seed": 5}):
        got = opv2v.generate_modality_assignment(
            trees["opv2v"], output_path=str(tmp_path / "got.json"), **kw)
        want = jax_opv2v.generate_modality_assignment(
            trees["opv2v"], output_path=str(tmp_path / "want.json"), **kw)
        _same(got, want)
        assert filecmp.cmp(tmp_path / "got.json", tmp_path / "want.json",
                           shallow=False)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_dair_scenes_equal_heal_tpu(train, trees, jax_native):
    cfg = _point_at(load_config(TINY), "dairv2x", trees)
    got = dairv2x.DAIRV2XBackend(cfg, train=train)
    want = jax_dairv2x.DAIRV2XBackend(cfg, train=train)
    assert len(got) == len(want) == 2
    for i in range(len(want)):
        scene = got.scene(i)
        _same(scene, want.scene(i), f"scene {i}")
        assert len(scene["agents"]) == 2
    # the roadside unit stands where the writer put it
    np.testing.assert_allclose(scene["agents"][1]["pose"][:2], [25.0, 5.0],
                               atol=1e-9)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_v2xsim_scenes_equal_heal_tpu(train, trees):
    """In training the agent order is 1 + permutation(n) from the
    backend's default_rng(seed)."""
    cfg = _point_at(load_config(TINY), "v2xsim", trees)
    got = v2xsim.V2XSimBackend(cfg, train=train)
    want = jax_v2xsim.V2XSimBackend(cfg, train=train)
    orders = []
    for seed in (0, 4):
        got.reinitialize(seed)
        want.reinitialize(seed)
        for i in range(len(want)):
            scene = got.scene(i)
            _same(scene, want.scene(i), f"scene {i}")
            orders.append([a["pose"][0] for a in scene["agents"]])
            assert len(scene["agents"]) == 3  # max_cav
    assert (len({tuple(o) for o in orders}) > 2) == train


def test_v2xsim_pads_xyz_sweeps_and_caps_agents(trees, tmp_path):
    """An xyz sweep gets intensity 1; agents past max_cav are dropped."""
    root = str(tmp_path / "v2xsim")
    pkl = v2xsim.write_synthetic_v2xsim_pickle(root, 1, 4, seed=2)
    for k in range(1, 5):
        path = os.path.join(root, f"frame0_agent{k}.npy")
        np.save(path, np.load(path)[:, :3].astype(np.float64))
    cfg = {"root_dir": pkl, "train_params": {"max_cav": 3}}
    got = v2xsim.V2XSimBackend(cfg, train=False).scene(0)
    _same(got, jax_v2xsim.V2XSimBackend(cfg, train=False).scene(0))
    assert len(got["agents"]) == 3
    pts = got["agents"][0]["points"]
    assert pts.dtype == np.float32 and (pts[:, 3] == 1).all()


# ----------------------------------------------------------------- writers
def _same_files(a, b):
    files = sorted(os.path.relpath(p, a) for p in glob.glob(
        os.path.join(a, "**", "*"), recursive=True) if os.path.isfile(p))
    assert files == sorted(os.path.relpath(p, b) for p in glob.glob(
        os.path.join(b, "**", "*"), recursive=True) if os.path.isfile(p))
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f
    return files


@pytest.mark.parametrize("kind", ["opv2v", "opv2v_cameras", "dair",
                                  "v2xsim"])
def test_writers_equal_heal_tpu(kind, tmp_path):
    got, want = str(tmp_path / "got"), str(tmp_path / "want")
    if kind.startswith("opv2v"):
        for fn, root in ((opv2v.write_synthetic_opv2v_tree, got),
                         (jax_opv2v.write_synthetic_opv2v_tree, want)):
            fn(root, 1, 2, 1, cameras=kind == "opv2v_cameras")
    elif kind == "dair":
        assert os.path.basename(dairv2x.write_synthetic_dair_tree(got)) == (
            os.path.basename(jax_dairv2x.write_synthetic_dair_tree(want)))
    else:
        v2xsim.write_synthetic_v2xsim_pickle(got)
        jax_v2xsim.write_synthetic_v2xsim_pickle(want)
    files = _same_files(got, want)
    assert len(files) >= 4


def test_img2hdf5_equals_heal_tpu(trees, tmp_path):
    import h5py

    got, want = str(tmp_path / "got"), str(tmp_path / "want")
    shutil.copytree(trees["v2xset"], got)
    shutil.copytree(trees["v2xset"], want)
    assert img2hdf5.convert_tree(got) == jax_img2hdf5.convert_tree(want) == 4
    h5 = sorted(glob.glob(os.path.join(got, "*", "*", "*_imgs.hdf5")))
    assert len(h5) == 4
    for path in h5:
        other = os.path.join(want, os.path.relpath(path, got))
        with h5py.File(path, "r") as f, h5py.File(other, "r") as g:
            assert sorted(f) == sorted(g) == [f"camera{i}" for i in range(4)]
            for key in f:
                _same(np.asarray(f[key]), np.asarray(g[key]), key)
        assert os.path.exists(path.replace("_imgs.hdf5", "_camera0.png"))


# ----------------------------------------------------------------- batches
def _batch(build, cfg, train, build_kw=(), **kw):
    np.random.seed(0)  # the train split's point subsampling
    ds = build(copy.deepcopy(cfg), train=train, **dict(build_kw))
    return next(ds.batches(2, shuffle=train, seed=3, **kw))


BATCHES = [
    # (config, dataset, anchor IoU, train)
    ("tiny", "opv2v", "native", True), ("tiny", "opv2v", "native", False),
    ("tiny", "opv2v", "numpy", True), ("tiny", "opv2v", "numpy", False),
    ("tiny", "dairv2x", "native", True), ("tiny", "dairv2x", "native", False),
    ("tiny", "v2xsim", "native", True), ("tiny", "v2xsim", "native", False),
    ("stage1", "opv2v", "native", True), ("stage1", "opv2v", "numpy", False),
    ("alliance", "opv2v", "native", False),
    ("alliance", "opv2v", "numpy", False),
]


@pytest.mark.parametrize(
    "name,dataset,iou,train", BATCHES,
    ids=["-".join([n, d, i, "train" if t else "test"])
         for n, d, i, t in BATCHES])
def test_collated_batches_equal_heal_tpu(name, dataset, iou, train, trees,
                                         jax_native, monkeypatch):
    """tests/configs/tiny_heter_collab.yaml on each dataset,
    opv2v/heal/stage1/m1_pyramid.yaml, and the alliance of
    final_infer/m1m2m3m4.yaml with AUG_KEYS (its m2 agents read their
    PNGs), both packages on one anchor IoU."""
    cfg = {"tiny": TINY, "stage1": STAGE1, "alliance": ALLIANCE}[name]
    cfg = _point_at(load_config(cfg), dataset, trees)
    if name == "alliance":
        _add_aug_keys(cfg)
    if iou == "numpy":
        monkeypatch.setattr(heal_tpu.native, "load", lambda: None)
    got = _batch(build_dataset, cfg, train,
                 build_kw={"native_iou": iou == "native"})
    want = _batch(jax_build_dataset, cfg, train, process_split=False)
    _same(got, want)
    assert got["agent_mask"].sum() >= 3 and got["pos_equal_one"].sum() > 0
    if name == "alliance":
        imgs = got["inputs_m2"]["imgs"]
        assert imgs.shape[-3:] == (384, 512, 3) and np.abs(imgs).sum() > 0
