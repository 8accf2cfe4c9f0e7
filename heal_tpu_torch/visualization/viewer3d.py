"""Interactive 3D viewer (open3d-backed, headless canvas backend).

The port's copy of heal_tpu/visualization/viewer3d.py, capability parity
with the reference's open3d stack (opencood/visualization/vis_utils.py
:22-606): box wireframe linesets, intensity / z / constant point-color
encodings, single-sample prediction-vs-GT scenes, inference scenes with
per-agent point clouds, sequence playback, and save-to-image, around
the port's numpy box utilities (utils/box_np.py).

open3d is an optional dependency, imported when a scene is shown: every
entry point takes numpy arrays (detections on the card are taken to the
host first), builds a backend-neutral scene description, and only then
hands it to open3d. Where open3d is not installed (or with
``backend="canvas"``), the same scene renders through the numpy pinhole
``Canvas3D``: PNG dumps and sequence frames are still produced; only the
interactive window needs open3d.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np

from ..utils.box_np import boxes_to_corners_3d
from .canvas import Canvas3D, save_canvas

# box wireframe edge list (corner layout of utils/box_np)
BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _open3d():
    """Import open3d lazily; None when unavailable (headless pods)."""
    try:
        return importlib.import_module("open3d")
    except ImportError:
        return None


def color_encoding(values: np.ndarray, mode: str = "intensity"):
    """(N,) scalars -> (N, 3) float colors in [0, 1].

    Modes (reference vis_utils.color_encoding:200-246): ``intensity``
    maps reflectance onto a red-tinted ramp, ``z-value`` maps height onto
    a blue-green ramp, ``constant`` paints everything one color.
    """
    values = np.asarray(values, np.float32)
    if mode == "constant":
        return np.tile(
            np.array([[1.0, 0.0, 0.0]], np.float32), (len(values), 1)
        )
    if mode == "intensity":
        # perceptual log ramp: low intensity -> dark red, high -> white
        v = np.clip(values, 0.0, 1.0)
        v = np.clip(np.log1p(v * 9.0) / np.log(10.0), 0.0, 1.0)
        return np.stack([np.ones_like(v), v, v], axis=-1)
    if mode == "z-value":
        lo, hi = -1.5, 1.0
        v = np.clip((values - lo) / (hi - lo), 0.0, 1.0)
        return np.stack([0.2 * np.ones_like(v), v, 1.0 - v], axis=-1)
    raise ValueError(f"unknown color mode {mode!r}")


def _to_corners(boxes: np.ndarray, order: str = "hwl") -> np.ndarray:
    boxes = np.asarray(boxes, np.float32)
    if boxes.size == 0:
        return np.zeros((0, 8, 3), np.float32)
    if boxes.ndim == 2 and boxes.shape[-1] == 7:
        return boxes_to_corners_3d(boxes, order)
    return boxes.reshape(-1, 8, 3)


@dataclass
class Scene3D:
    """Backend-neutral scene: point clouds + colored box wireframes."""

    points: list = field(default_factory=list)  # [(xyz (N,3), rgb (N,3))]
    boxes: list = field(default_factory=list)  # [(corners (M,8,3), rgb)]

    def add_points(self, pts: np.ndarray, mode: str = "intensity"):
        pts = np.asarray(pts, np.float32)
        if pts.size == 0:
            return self
        scalars = pts[:, -1] if mode == "intensity" else pts[:, 2]
        self.points.append((pts[:, :3], color_encoding(scalars, mode)))
        return self

    def add_boxes(self, boxes, color=(0.0, 1.0, 0.0), order="hwl"):
        corners = _to_corners(boxes, order)
        if len(corners):
            self.boxes.append((corners, tuple(color)))
        return self

    # -- open3d backend ---------------------------------------------
    def to_open3d(self, o3d=None):
        """-> list of open3d geometries (left->right-handed flip, as the
        reference viewer, vis_utils.py:60-63)."""
        o3d = o3d or _open3d()
        if o3d is None:
            raise ImportError(
                "open3d is not installed; use render()/show(backend="
                "'canvas') for the headless numpy path"
            )
        geoms = []
        for xyz, rgb in self.points:
            pc = o3d.geometry.PointCloud()
            flipped = xyz.copy()
            flipped[:, 0] = -flipped[:, 0]
            pc.points = o3d.utility.Vector3dVector(flipped)
            pc.colors = o3d.utility.Vector3dVector(rgb)
            geoms.append(pc)
        lines = np.asarray(BOX_EDGES, np.int32)
        for corners, color in self.boxes:
            for box in corners:
                flipped = box.copy()
                flipped[:, 0] = -flipped[:, 0]
                ls = o3d.geometry.LineSet()
                ls.points = o3d.utility.Vector3dVector(flipped)
                ls.lines = o3d.utility.Vector2iVector(lines)
                ls.colors = o3d.utility.Vector3dVector(
                    np.tile(np.asarray(color, np.float64), (len(lines), 1))
                )
                geoms.append(ls)
        return geoms

    # -- headless numpy backend --------------------------------------
    def render(
        self,
        canvas_shape=(720, 1280),
        camera_center=(-25.0, 0.0, 20.0),
        target=(20.0, 0.0, 0.0),
    ) -> np.ndarray:
        """Rasterize through the pinhole Canvas3D -> (H, W, 3) uint8."""
        canvas = Canvas3D(
            canvas_shape=canvas_shape,
            camera_center=camera_center,
            target=target,
        )
        for xyz, rgb in self.points:
            canvas.draw_canvas_points(
                xyz, colors=(rgb * 255).astype(np.uint8)
            )
        for corners, color in self.boxes:
            canvas.draw_boxes(
                corners, colors=tuple(int(c * 255) for c in color)
            )
        return canvas.get_canvas()

    def show(self, backend: str = "auto", save_path: str = ""):
        """Open an interactive window (open3d) or save a rendered PNG.

        backend: "auto" uses open3d when importable, else the numpy
        canvas; "open3d"/"canvas" force one. Returns the rendered image
        for the canvas path, None for the interactive path.
        """
        o3d = _open3d() if backend in ("auto", "open3d") else None
        if backend == "open3d" and o3d is None:
            raise ImportError("backend='open3d' but open3d is missing")
        if o3d is not None:
            geoms = self.to_open3d(o3d)
            if save_path:
                _save_open3d(o3d, geoms, save_path)
            else:
                vis = o3d.visualization.Visualizer()
                vis.create_window()
                opt = vis.get_render_option()
                opt.background_color = np.asarray([0, 0, 0])
                opt.point_size = 1.0
                for g in geoms:
                    vis.add_geometry(g)
                vis.run()
                vis.destroy_window()
            return None
        img = self.render()
        if save_path:
            save_canvas(img, save_path)
        return img


def _save_open3d(o3d, geoms, save_path: str):
    """Offscreen capture (reference save_o3d_visualization:564-586)."""
    vis = o3d.visualization.Visualizer()
    vis.create_window(visible=False)
    for g in geoms:
        vis.add_geometry(g)
        vis.update_geometry(g)
    vis.poll_events()
    vis.update_renderer()
    vis.capture_screen_image(save_path)
    vis.destroy_window()


def visualize_single_sample_output_gt(
    pred_boxes,
    gt_boxes,
    pcd,
    show_vis: bool = True,
    save_path: str = "",
    mode: str = "constant",
    order: str = "hwl",
):
    """Prediction (red) vs GT (green) over the point cloud
    (reference vis_utils.visualize_single_sample_output_gt:249-317)."""
    scene = Scene3D()
    scene.add_points(np.asarray(pcd, np.float32), mode=mode)
    if pred_boxes is not None:
        scene.add_boxes(pred_boxes, color=(1.0, 0.0, 0.0), order=order)
    if gt_boxes is not None:
        scene.add_boxes(gt_boxes, color=(0.0, 1.0, 0.0), order=order)
    return scene.show(
        backend="auto" if show_vis or save_path else "canvas",
        save_path=save_path,
    )


def visualize_inference_sample_dataloader(
    pred_boxes,
    gt_boxes,
    agent_points,
    save_path: str = "",
    mode: str = "constant",
    order: str = "hwl",
):
    """Ego-frame scene with per-agent point clouds in distinct constant
    colors (reference :455-504 colors each CAV's cloud separately)."""
    palette = [
        (1.0, 1.0, 1.0), (0.2, 0.6, 1.0), (1.0, 0.8, 0.2),
        (0.4, 1.0, 0.4), (1.0, 0.4, 1.0),
    ]
    scene = Scene3D()
    if isinstance(agent_points, np.ndarray):
        agent_points = [agent_points]
    for i, pts in enumerate(agent_points):
        pts = np.asarray(pts, np.float32)
        if pts.size == 0:
            continue
        if mode == "constant":
            rgb = np.tile(
                np.asarray(palette[i % len(palette)], np.float32),
                (len(pts), 1),
            )
            scene.points.append((pts[:, :3], rgb))
        else:
            scene.add_points(pts, mode=mode)
    if pred_boxes is not None:
        scene.add_boxes(pred_boxes, color=(1.0, 0.0, 0.0), order=order)
    if gt_boxes is not None:
        scene.add_boxes(gt_boxes, color=(0.0, 1.0, 0.0), order=order)
    return scene.show(backend="auto", save_path=save_path)


def visualize_sequence(frames, save_dir: str = "", order: str = "hwl"):
    """Sequence playback (reference visualize_sequence_dataloader:507-561).

    frames: iterable of dicts with keys ``points`` (N, 4), optional
    ``pred_boxes`` / ``gt_boxes``. With open3d, plays in one window via
    non-blocking geometry swaps; headless, renders one PNG per frame
    into save_dir. Returns the number of frames shown.
    """
    import os

    o3d = _open3d()
    shown = 0
    if o3d is not None and not save_dir:
        vis = o3d.visualization.Visualizer()
        vis.create_window()
        prev = []
        for frame in frames:
            scene = Scene3D().add_points(frame["points"], mode="constant")
            if frame.get("gt_boxes") is not None:
                scene.add_boxes(frame["gt_boxes"], (0, 1, 0), order)
            if frame.get("pred_boxes") is not None:
                scene.add_boxes(frame["pred_boxes"], (1, 0, 0), order)
            for g in prev:
                vis.remove_geometry(g, reset_bounding_box=False)
            prev = scene.to_open3d(o3d)
            for g in prev:
                vis.add_geometry(g, reset_bounding_box=shown == 0)
            vis.poll_events()
            vis.update_renderer()
            shown += 1
        vis.destroy_window()
        return shown
    for i, frame in enumerate(frames):
        scene = Scene3D().add_points(frame["points"], mode="constant")
        if frame.get("gt_boxes") is not None:
            scene.add_boxes(frame["gt_boxes"], (0, 1, 0), order)
        if frame.get("pred_boxes") is not None:
            scene.add_boxes(frame["pred_boxes"], (1, 0, 0), order)
        img = scene.render()
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            save_canvas(img, os.path.join(save_dir, f"frame_{i:05d}.png"))
        shown += 1
    return shown
