"""The port's native host loader (heal_tpu_torch/native) against
heal_tpu's, on the CPU.

heal_tpu's library is built from its own source into a temporary
directory and pinned by its module's ``_LIB_PATH`` / ``_LIB``, so these
tests never depend on whether heal_tpu/native/libheal_loader.so exists
and never write beside heal_tpu's sources. The port's library is built
with the same g++ flags on the same host, so every output is held to
heal_tpu's bit for bit (``np.array_equal``, dtypes and shapes), and
to its plain numpy version at heal_tpu's own tolerances
(tests/test_native.py: IoU 1e-5, PCD values 1e-4, the range filter
exactly).
"""
import os
import struct
import subprocess

import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.data import opv2v as jax_opv2v
from heal_tpu.utils import box_np as jax_box_np
from heal_tpu_torch import native
from heal_tpu_torch.data import opv2v
from heal_tpu_torch.postprocess import targets
from heal_tpu_torch.utils import box_np

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """heal_tpu.native on a library built here, with the port's flags."""
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


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert np.array_equal(got, want)


def _boxes(rng, n):
    a = rng.uniform(0, 50, (n, 2))
    b = rng.uniform(1, 8, (n, 2))
    return np.concatenate([a, a + b], 1).astype(np.float32)


@pytest.mark.parametrize("plus_one", [True, False])
def test_bbox_overlaps_equals_heal_tpu(jax_native, plus_one):
    rng = np.random.default_rng(0)
    boxes = _boxes(rng, 300)
    query = np.concatenate([boxes[rng.permutation(300)][:40],
                            _boxes(rng, 20)])
    got = native.bbox_overlaps(boxes, query, plus_one)
    _same(got, jax_native.bbox_overlaps(boxes, query, plus_one))
    assert got.dtype == np.float32 and (got > 0).sum() > 40
    np.testing.assert_allclose(
        got, box_np.standup_iou_matrix(boxes, query, plus_one), atol=1e-5)


@pytest.mark.parametrize("native_iou", [True, False],
                         ids=["native", "numpy"])
def test_generate_targets_takes_either_iou(jax_native, native_iou,
                                           monkeypatch):
    """The port's ``native_iou`` switch against heal_tpu's library on
    and off: labels, negatives and regression targets equal."""
    from heal_tpu.postprocess.anchors import generate_anchor_box as jax_anch
    from heal_tpu.postprocess.targets import generate_targets as jax_gt

    if not native_iou:
        monkeypatch.setattr(heal_tpu.native, "load", lambda: None)
    args = {"cav_lidar_range": [-51.2, -25.6, -3, 51.2, 25.6, 1],
            "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90], "num": 2,
            "feature_stride": 2, "vw": 0.4, "vh": 0.4, "vd": 4,
            "W": 256, "H": 128, "D": 1}
    anchors = jax_anch(args, "hwl")
    rng = np.random.default_rng(3)
    gt = np.zeros((20, 7))
    gt[:9, 0] = rng.uniform(-45, 45, 9)
    gt[:9, 1] = rng.uniform(-22, 22, 9)
    gt[:9, 2] = -1.0
    gt[:9, 3:6] = rng.uniform([1.4, 1.5, 3.6], [1.7, 1.9, 4.6], (9, 3))
    gt[:9, 6] = rng.uniform(-np.pi, np.pi, 9)
    mask = (np.arange(20) < 9).astype(np.float64)
    got = targets.generate_targets(gt, mask, anchors, 0.6, 0.45,
                                   native_iou=native_iou)
    want = jax_gt(gt, mask, anchors, 0.6, 0.45)
    for key in want:
        _same(got[key], want[key])
    assert got["pos_equal_one"].sum() >= 9


def _tree_pcd(tmp_path):
    root = str(tmp_path / "tree")
    opv2v.write_synthetic_opv2v_tree(root, 1, 1, 1)
    return os.path.join(root, "2021_synth_00", "200", "000000.pcd")


def _binary_pcd(path, pts, fields, sizes, types):
    """A binary PCD of ``pts`` (rows of python numbers)."""
    fmt = "<" + "".join({("F", 4): "f", ("F", 8): "d", ("U", 1): "B",
                         ("I", 2): "h", ("U", 4): "I"}[(t, s)]
                        for t, s in zip(types, sizes))
    body = b"".join(struct.pack(fmt, *p) for p in pts)
    header = (
        "VERSION 0.7\nFIELDS " + " ".join(fields) + "\nSIZE "
        + " ".join(map(str, sizes)) + "\nTYPE " + " ".join(types)
        + "\nCOUNT " + " ".join("1" for _ in fields)
        + f"\nWIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode() + body)
    return str(path)


def _pcds(tmp_path):
    """The four layouts: the writer's ascii, binary f32, binary f64 with
    a uint8 intensity (DAIR-V2X's exports), binary with no intensity."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-60, 60, (700, 4)).tolist()
    return {
        "ascii": _tree_pcd(tmp_path),
        "binary_f32": _binary_pcd(tmp_path / "f32.pcd", pts,
                                  "x y z intensity".split(), [4] * 4,
                                  ["F"] * 4),
        "binary_f64": _binary_pcd(
            tmp_path / "f64.pcd", [p[:3] + [int(abs(p[3])) % 256]
                                   for p in pts],
            "x y z intensity".split(), [8, 8, 8, 1], ["F", "F", "F", "U"]),
        "no_intensity": _binary_pcd(tmp_path / "xyz.pcd",
                                    [p[:3] for p in pts], "x y z".split(),
                                    [4] * 3, ["F"] * 3),
    }


@pytest.mark.parametrize("layout", ["ascii", "binary_f32", "binary_f64",
                                    "no_intensity"])
def test_read_pcd_equals_heal_tpu(jax_native, tmp_path, layout):
    path = _pcds(tmp_path)[layout]
    got = native.read_pcd(path)
    _same(got, jax_native.read_pcd(path))
    _same(opv2v.load_pcd(path), jax_opv2v.load_pcd(path))
    assert got.dtype == np.float32 and got.shape[1] == 4 and len(got) > 100
    if layout == "no_intensity":
        assert (got[:, 3] == 1).all()
    if layout == "binary_f64":
        # the numpy reader reads float fields only
        assert (got[:, 3] == np.round(got[:, 3])).all()
        return
    want = opv2v._load_pcd_numpy(path)
    _same(want, jax_opv2v._load_pcd_numpy(path))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_read_pcd_grows_its_cap(jax_native, tmp_path):
    path = _tree_pcd(tmp_path)
    want = opv2v._load_pcd_numpy(path)
    got = native.read_pcd(path, cap=max(4, len(want) // 3))
    _same(got, jax_native.read_pcd(path, cap=max(4, len(want) // 3)))
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_read_pcd_rejects_missing_xyz(jax_native, tmp_path):
    p = tmp_path / "bad.pcd"
    p.write_text("VERSION 0.7\nFIELDS a b\nSIZE 4 4\nTYPE F F\nCOUNT 1 1\n"
                 "WIDTH 1\nHEIGHT 1\nPOINTS 1\nDATA ascii\n1.0 2.0\n")
    with pytest.raises(IOError):
        jax_native.read_pcd(str(p))
    with pytest.raises(IOError):
        native.read_pcd(str(p))


def test_range_filter_pad_equals_heal_tpu(jax_native):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-120, 120, (5000, 4)).astype(np.float32)
    pts[:, 2] = rng.uniform(-4, 2, 5000)
    lim = [-102.4, -51.2, -3, 102.4, 51.2, 1]
    for cap in (600, 4000):
        got = native.range_filter_pad(pts, lim, cap)
        want = jax_native.range_filter_pad(pts, lim, cap)
        plain = native.range_filter_pad_numpy(pts, lim, cap)
        for g, w, p in zip(got, want, plain):
            _same(g, w)
            _same(g, p)
    assert got[1].sum() > 600  # the larger cap keeps every point in range


def _voxelize_numpy(pts, lim, vs, max_voxels, max_points):
    """A plain version: the voxels in order of their first point."""
    grid = [int(round((lim[i + 3] - lim[i]) / vs[i])) for i in range(3)]
    ids, voxels, coords, counts = {}, [], [], []
    for p in pts:
        idx = [int(np.floor((np.float32(p[i]) - np.float32(lim[i]))
                            / np.float32(vs[i]))) for i in range(3)]
        if any(v < 0 or v >= g for v, g in zip(idx, grid)):
            continue
        key = tuple(idx[::-1])
        if key not in ids:
            if len(ids) >= max_voxels:
                continue
            ids[key] = len(ids)
            voxels.append(np.zeros((max_points, 4), np.float32))
            coords.append(key)
            counts.append(0)
        v = ids[key]
        if counts[v] < max_points:
            voxels[v][counts[v]] = p
            counts[v] += 1
    return (np.stack(voxels), np.asarray(coords, np.int32),
            np.asarray(counts, np.int32))


@pytest.mark.parametrize("max_voxels", [4000, 150])
def test_voxelize_equals_heal_tpu(jax_native, max_voxels):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (3000, 4)).astype(np.float32)
    args = ([-5, -5, -5, 5, 5, 5], [1.0, 1.0, 1.0], max_voxels, 8)
    got = native.voxelize(pts, *args)
    for g, w in zip(got, jax_native.voxelize(pts, *args)):
        _same(g, w)
    for g, p in zip(got, _voxelize_numpy(pts, *args)):
        _same(g, p)
    # full voxels cut at 8 points; the small cap cuts voxels too
    assert got[2].max() == 8
    assert len(got[0]) == 150 if max_voxels == 150 else len(got[0]) > 900


def test_build_is_keyed_by_host_and_raises(tmp_path, monkeypatch):
    """The library's directory changes with the host (a -march=native
    build never loads on another CPU); a failed build raises."""
    here = native.library_path()
    assert here.startswith(native.BUILD_ROOT)
    monkeypatch.setattr(native.platform, "node", lambda: "another-host")
    assert native.library_path() != here
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(str(tmp_path / "out" / "lib.so"))
    assert not os.path.exists(tmp_path / "out" / "lib.so")


def test_bindings_refuse_other_layouts():
    """The library reads (N, 4) f32 rows and 6 range values: anything
    else raises before a pointer is passed."""
    pts = np.zeros((5, 3), np.float32)
    with pytest.raises(ValueError, match="points"):
        native.range_filter_pad(pts, [-1, -1, -1, 1, 1, 1], 4)
    with pytest.raises(ValueError, match="limit_range"):
        native.voxelize(np.zeros((5, 4)), [-1, -1, 1, 1], [1, 1, 1], 4, 2)
    with pytest.raises(ValueError, match="query"):
        native.bbox_overlaps(np.zeros((2, 4)), np.zeros((3, 5)))


def test_standup_iou_numpy_equals_heal_tpu():
    rng = np.random.default_rng(4)
    boxes, query = _boxes(rng, 50), _boxes(rng, 10)
    _same(box_np.standup_iou_matrix(boxes, query, True),
          jax_box_np.standup_iou_matrix(boxes, query, True))
