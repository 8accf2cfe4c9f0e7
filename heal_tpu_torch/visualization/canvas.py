"""Numpy raster canvases for point clouds + boxes (BEV and pinhole 3D).

The port's copy of heal_tpu/visualization/canvas.py (numpy; matplotlib
only in ``save_canvas``, imported there): array-backed canvases you
scatter lidar points and box wireframes onto, then save as a PNG (the
reference's visualization/simple_plot3d/{canvas_bev.py, canvas_3d.py}).
Line rasterization is a vectorized numpy linspace walk instead of
cv2.line, and the 3D canvas uses an explicit look-at pinhole camera.
Detections and points on the card are taken to the host first
(``x.float().cpu().numpy()``).
"""
from __future__ import annotations

import numpy as np

# box wireframe: 4 bottom edges, 4 top edges, 4 pillars (corner layout of
# utils/box_np.boxes_to_corners_3d)
_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _draw_lines(canvas, p0, p1, color, samples_per_px: float = 1.5):
    """Rasterize line segments p0->p1 ((N, 2) int arrays, row/col)."""
    if len(p0) == 0:
        return
    h, w = canvas.shape[:2]
    lengths = np.abs(p1 - p0).max(axis=1)
    n = int(min(max(lengths.max() * samples_per_px, 2), 4096))
    t = np.linspace(0.0, 1.0, n)[None, :, None]
    pts = p0[:, None, :] * (1 - t) + p1[:, None, :] * t  # (N, n, 2)
    pts = np.round(pts).astype(np.int64).reshape(-1, 2)
    ok = (
        (pts[:, 0] >= 0) & (pts[:, 0] < h)
        & (pts[:, 1] >= 0) & (pts[:, 1] < w)
    )
    pts = pts[ok]
    canvas[pts[:, 0], pts[:, 1]] = color


class CanvasBEV:
    """Top-down canvas over a metric window (ref canvas_bev.py:13-257).

    canvas_shape is (H, W) pixels covering ``canvas_range``
    (xmin, ymin, xmax, ymax) meters; +x right, +y up by default.
    """

    def __init__(
        self,
        canvas_shape=(800, 1600),
        canvas_range=(-102.4, -51.2, 102.4, 51.2),
        bg_color=(0, 0, 0),
    ):
        self.shape = tuple(canvas_shape)
        self.range = tuple(canvas_range)
        self.bg_color = np.array(bg_color, np.uint8)
        self.clear_canvas()

    def get_canvas(self):
        return self.canvas

    def clear_canvas(self):
        self.canvas = np.tile(
            self.bg_color, (self.shape[0], self.shape[1], 1)
        ).astype(np.uint8)

    def get_canvas_coords(self, xy):
        """(N, 2+) metric -> (rows, cols, valid_mask)."""
        xy = np.asarray(xy, np.float64)
        x0, y0, x1, y1 = self.range
        h, w = self.shape
        cols = (xy[:, 0] - x0) / (x1 - x0) * (w - 1)
        rows = (1.0 - (xy[:, 1] - y0) / (y1 - y0)) * (h - 1)
        rows_i = np.round(rows).astype(np.int64)
        cols_i = np.round(cols).astype(np.int64)
        valid = (rows_i >= 0) & (rows_i < h) & (cols_i >= 0) & (cols_i < w)
        return rows_i, cols_i, valid

    def draw_canvas_points(self, points, radius=0, colors=(255, 255, 255)):
        """Scatter (N, 2+) metric points; radius grows them to squares."""
        rows, cols, valid = self.get_canvas_coords(points)
        rows, cols = rows[valid], cols[valid]
        colors = np.asarray(colors, np.uint8)
        if colors.ndim == 2:
            colors = colors[valid]
        for dr in range(-radius, radius + 1):
            for dc in range(-radius, radius + 1):
                r = np.clip(rows + dr, 0, self.shape[0] - 1)
                c = np.clip(cols + dc, 0, self.shape[1] - 1)
                self.canvas[r, c] = colors

    def draw_boxes(self, corners, colors=(0, 255, 0), texts=None):
        """corners: (K, 4, 2+) or (K, 8, 3) box corners in metric frame."""
        corners = np.asarray(corners, np.float64)
        if corners.size == 0:
            return
        if corners.shape[1] == 8:  # use bottom face of 3D corners
            corners = corners[:, :4, :2]
        k = corners.shape[0]
        nxt = np.roll(np.arange(4), -1)
        for i in range(k):
            rows, cols, _ = self.get_canvas_coords(corners[i, :, :2])
            p = np.stack([rows, cols], axis=1).astype(np.float64)
            _draw_lines(self.canvas, p, p[nxt], np.asarray(colors, np.uint8))


class Canvas3D:
    """Pinhole-projected 3D canvas (ref canvas_3d.py:14-343).

    A look-at camera at ``camera_center`` pointing at ``target`` renders
    points and 12-edge box wireframes with painter's-order depth.
    """

    def __init__(
        self,
        canvas_shape=(600, 800),
        camera_center=(-20.0, 0.0, 15.0),
        target=(15.0, 0.0, 0.0),
        focal=None,
        bg_color=(0, 0, 0),
    ):
        self.shape = tuple(canvas_shape)
        self.bg_color = np.array(bg_color, np.uint8)
        self.focal = focal or canvas_shape[1] / 2.0
        c = np.asarray(camera_center, np.float64)
        t = np.asarray(target, np.float64)
        fwd = t - c
        fwd = fwd / np.linalg.norm(fwd)
        up0 = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up0)
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)
        # world -> camera (rows: right, -up, forward)
        self.rot = np.stack([right, -up, fwd], axis=0)
        self.trans = -self.rot @ c
        self.clear_canvas()

    def get_canvas(self):
        return self.canvas

    def clear_canvas(self):
        self.canvas = np.tile(
            self.bg_color, (self.shape[0], self.shape[1], 1)
        ).astype(np.uint8)

    def get_canvas_coords(self, xyz):
        """(N, 3) world -> (rows, cols, valid, depth)."""
        xyz = np.asarray(xyz, np.float64)
        cam = xyz @ self.rot.T + self.trans
        z = cam[:, 2]
        ok = z > 0.5
        zs = np.where(ok, z, 1.0)
        u = cam[:, 0] / zs * self.focal + self.shape[1] / 2.0
        v = cam[:, 1] / zs * self.focal + self.shape[0] / 2.0
        rows = np.round(v).astype(np.int64)
        cols = np.round(u).astype(np.int64)
        ok &= (
            (rows >= 0) & (rows < self.shape[0])
            & (cols >= 0) & (cols < self.shape[1])
        )
        return rows, cols, ok, z

    def draw_canvas_points(self, points, radius=0, colors=(255, 255, 255)):
        rows, cols, ok, z = self.get_canvas_coords(points)
        order = np.argsort(-z)  # far first: near points overwrite
        rows, cols, oko = rows[order], cols[order], ok[order]
        colors = np.asarray(colors, np.uint8)
        if colors.ndim == 2:
            colors = colors[order][oko]
        rows, cols = rows[oko], cols[oko]
        for dr in range(-radius, radius + 1):
            for dc in range(-radius, radius + 1):
                r = np.clip(rows + dr, 0, self.shape[0] - 1)
                c = np.clip(cols + dc, 0, self.shape[1] - 1)
                self.canvas[r, c] = colors

    def draw_boxes(self, corners3d, colors=(0, 255, 0)):
        """corners3d: (K, 8, 3) box corners in world frame."""
        corners3d = np.asarray(corners3d, np.float64)
        colors = np.asarray(colors, np.uint8)
        for i in range(corners3d.shape[0]):
            rows, cols, ok, _ = self.get_canvas_coords(corners3d[i])
            p = np.stack([rows, cols], axis=1).astype(np.float64)
            for a, b in _EDGES:
                if ok[a] or ok[b]:
                    _draw_lines(self.canvas, p[a : a + 1], p[b : b + 1], colors)


def save_canvas(canvas, path: str):
    """Write a canvas array as PNG (matplotlib backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.imsave(path, canvas)
