"""The port's visualization package against heal_tpu's, on the CPU.

Seeded numpy points, boxes and features go through
``heal_tpu.visualization`` and ``heal_tpu_torch.visualization``: the BEV
and pinhole canvases and the headless 3D renders must be the same arrays
exactly; CKA, MMD and pairwise distances within 1e-12 (float64); the
t-SNE embedding (scikit-learn) and its PCA stand-in equal at the same
seed; ``visualize`` writes its PNG; the 3D viewer against an open3d stub
as tests/test_visualization.py does it for heal_tpu.
"""
import sys
import types

import numpy as np
import pytest
import torch

from heal_tpu.utils import box_np as jax_box
from heal_tpu.visualization import canvas as jax_canvas
from heal_tpu.visualization import feature_analysis as jax_fa
from heal_tpu.visualization import viewer3d as jax_v3d
from heal_tpu_torch.utils import box_np
from heal_tpu_torch.visualization import canvas, feature_analysis, viewer3d

torch.set_num_threads(1)
RNG_SEED = 11


def _scene(seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-30, 30, (600, 3)),
                          rng.uniform(0, 1, (600, 1))], axis=1)
    boxes = np.stack([
        rng.uniform(-20, 20, 5), rng.uniform(-20, 20, 5),
        rng.uniform(-1, 0, 5), rng.uniform(1.4, 1.7, 5),
        rng.uniform(1.5, 2.0, 5), rng.uniform(3.5, 4.5, 5),
        rng.uniform(-np.pi, np.pi, 5)], axis=1)
    return pts, boxes


@pytest.mark.parametrize("radius,per_point", [(0, False), (1, True)])
def test_canvas_bev_equals_heal_tpu(radius, per_point):
    pts, boxes = _scene()
    corners = box_np.boxes_to_corners_3d(boxes, "hwl")
    np.testing.assert_array_equal(corners,
                                  jax_box.boxes_to_corners_3d(boxes, "hwl"))
    colors = ((np.random.default_rng(1).integers(0, 255, (len(pts), 3))
               .astype(np.uint8)) if per_point else (255, 255, 255))
    out = []
    for mod in (canvas, jax_canvas):
        cv = mod.CanvasBEV(canvas_shape=(200, 300),
                           canvas_range=(-32, -24, 32, 24))
        cv.draw_canvas_points(pts, radius=radius, colors=colors)
        cv.draw_boxes(corners, colors=(0, 255, 0))
        cv.draw_boxes(corners[:2, :4, :2], colors=(255, 0, 0))
        out.append(cv.get_canvas())
    assert out[0].any()
    np.testing.assert_array_equal(out[0], out[1])


def test_canvas_3d_equals_heal_tpu():
    pts, boxes = _scene(5)
    corners = box_np.boxes_to_corners_3d(boxes, "lwh")
    colors = np.random.default_rng(2).integers(0, 255, (len(pts), 3))
    out = []
    for mod in (canvas, jax_canvas):
        cv = mod.Canvas3D(canvas_shape=(120, 160),
                          camera_center=(-25.0, 0.0, 12.0),
                          target=(10.0, 0.0, 0.0))
        cv.draw_canvas_points(pts[:, :3], radius=1, colors=colors)
        cv.draw_boxes(corners, colors=(0, 0, 255))
        out.append(cv.get_canvas())
    assert out[0].any()
    np.testing.assert_array_equal(out[0], out[1])


def test_save_canvas_and_visualize_write_pngs(tmp_path):
    from heal_tpu_torch.visualization import visualize

    pts, boxes = _scene()
    corners = box_np.boxes_to_corners_3d(boxes, "hwl")
    cv = canvas.CanvasBEV(canvas_shape=(64, 96))
    cv.draw_boxes(corners)
    canvas.save_canvas(cv.get_canvas(), str(tmp_path / "c.png"))
    p = visualize(corners[:2], corners, pts, [-32, -32, -3, 32, 32, 1],
                  str(tmp_path / "vis" / "bev.png"))
    for f in (tmp_path / "c.png", tmp_path / "vis" / "bev.png"):
        assert f.stat().st_size > 0
    assert p == str(tmp_path / "vis" / "bev.png")


def test_color_encoding_and_headless_render_equal_heal_tpu():
    pts, boxes = _scene(3)
    v = np.linspace(-2, 2, 17)
    for mode in ("intensity", "z-value", "constant"):
        np.testing.assert_array_equal(viewer3d.color_encoding(v, mode),
                                      jax_v3d.color_encoding(v, mode))
    with pytest.raises(ValueError):
        viewer3d.color_encoding(v, "nope")
    imgs = []
    for mod in (viewer3d, jax_v3d):
        scene = (mod.Scene3D().add_points(pts, mode="intensity")
                 .add_points(pts[:100], mode="z-value")
                 .add_boxes(boxes, color=(1, 0, 0), order="hwl")
                 .add_boxes(np.zeros((0, 7))))
        imgs.append(scene.render(canvas_shape=(120, 160)))
    assert imgs[0].shape == (120, 160, 3) and imgs[0].any()
    np.testing.assert_array_equal(imgs[0], imgs[1])


def test_viewer_entry_points_headless(tmp_path, monkeypatch):
    monkeypatch.setattr(viewer3d, "_open3d", lambda: None)
    monkeypatch.setattr(jax_v3d, "_open3d", lambda: None)
    pts, boxes = _scene(4)
    out = []
    for mod in (viewer3d, jax_v3d):
        out.append(mod.visualize_single_sample_output_gt(
            boxes[:2], boxes, pts, show_vis=False,
            save_path=str(tmp_path / f"{mod.__name__}.png")))
        out.append(mod.visualize_inference_sample_dataloader(
            boxes[:1], boxes, [pts[:300], pts[300:]]))
    np.testing.assert_array_equal(out[0], out[2])
    np.testing.assert_array_equal(out[1], out[3])
    assert (tmp_path / "heal_tpu_torch.visualization.viewer3d.png").exists()
    frames = [{"points": _scene(i)[0], "gt_boxes": _scene(i)[1][:2],
               "pred_boxes": _scene(i)[1][2:]} for i in range(3)]
    assert viewer3d.visualize_sequence(frames, save_dir=str(
        tmp_path / "seq")) == 3
    assert len(list((tmp_path / "seq").glob("frame_*.png"))) == 3


def test_open3d_geometry_via_stub(monkeypatch):
    created = {"pc": [], "ls": []}

    class _Vec:
        def __init__(self, data):
            self.data = np.asarray(data)

    class _PointCloud:
        def __init__(self):
            created["pc"].append(self)

    class _LineSet:
        def __init__(self):
            created["ls"].append(self)

    stub = types.ModuleType("open3d")
    stub.geometry = types.SimpleNamespace(PointCloud=_PointCloud,
                                          LineSet=_LineSet)
    stub.utility = types.SimpleNamespace(Vector3dVector=_Vec,
                                         Vector2iVector=_Vec)
    monkeypatch.setitem(sys.modules, "open3d", stub)
    pts, boxes = _scene(6)
    geoms = (viewer3d.Scene3D().add_points(pts)
             .add_boxes(boxes[:2], color=(1, 0, 0)).to_open3d())
    assert len(created["pc"]) == 1 and len(created["ls"]) == 2
    assert len(geoms) == 3
    np.testing.assert_allclose(geoms[0].points.data[:, 0], -pts[:, 0],
                               rtol=1e-6)
    np.testing.assert_allclose(geoms[0].points.data[:, 1:], pts[:, 1:3],
                               rtol=1e-6)
    assert geoms[1].lines.data.shape == (12, 2)
    want = jax_v3d.Scene3D().add_points(pts).add_boxes(
        boxes[:2], color=(1, 0, 0)).to_open3d()
    for g, w in zip(geoms, want):
        np.testing.assert_array_equal(g.points.data, w.points.data)
        np.testing.assert_array_equal(g.colors.data, w.colors.data)


def _features(seed=0, n=96):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (n, 24))
    y = 0.6 * x[:, :16] @ rng.normal(0, 1, (16, 16)) + rng.normal(
        0, 0.5, (n, 16))
    return x, y


def test_cka_mmd_pairwise_within_1e_12_of_heal_tpu():
    x, y = _features()
    checks = [
        ("linear_cka", (x, y), {}), ("linear_cka", (x, x), {}),
        ("kernel_cka", (x, y), {}), ("kernel_cka", (x, y), {"sigma": 2.0}),
        ("mmd_linear", (x, y[:, :16].repeat(2, 1)[:, :24]), {}),
        ("mmd_rbf", (x[:, :16], y), {"gamma": 0.1}),
    ]
    for name, args, kw in checks:
        got = getattr(feature_analysis, name)(*args, **kw)
        want = getattr(jax_fa, name)(*args, **kw)
        assert abs(got - want) <= 1e-12, name
    assert abs(feature_analysis.linear_cka(x, x) - 1.0) <= 1e-12
    np.testing.assert_allclose(feature_analysis.pairwise_l2(x, x[:10]),
                               jax_fa.pairwise_l2(x, x[:10]), rtol=0,
                               atol=1e-12)


def test_tsne_embed_equal_heal_tpu_at_the_same_seed(monkeypatch):
    pytest.importorskip("sklearn")
    x, _ = _features(1, n=60)
    got = feature_analysis.tsne_embed(x, perplexity=10.0, seed=3)
    np.testing.assert_array_equal(got, jax_fa.tsne_embed(x, perplexity=10.0,
                                                         seed=3))
    assert got.shape == (60, 2)
    # without scikit-learn both take the top-2 PCA projection
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    got = feature_analysis.tsne_embed(x)
    np.testing.assert_array_equal(got, jax_fa.tsne_embed(x))


def test_scatter_by_label_writes_png(tmp_path):
    x, _ = _features(2, n=40)
    feature_analysis.scatter_by_label(x[:, :2], np.arange(40) % 3,
                                      str(tmp_path / "s.png"), title="t")
    assert (tmp_path / "s.png").stat().st_size > 0
