"""Numpy bounding-box geometry (host side).

The port's copy of heal_tpu/utils/box_np.py, trimmed to what the host
side of intermediate fusion uses: corners, standup boxes and their "+1"
IoU (anchor targets), rotated polygon IoU (AP matching), range masks,
point projection and the camera-visibility filter of camera labels. Same numerical conventions, so labels and AP match the
JAX package's exactly.

Box parameterization: ``(x, y, z, d1, d2, d3, yaw)`` with ``order``:
  * ``'lwh'``: d1=length(x-extent), d2=width(y-extent), d3=height(z-extent)
  * ``'hwl'``: d1=height, d2=width, d3=length  (PointPillars convention)
Yaw rotates around +z; corners follow the CCW bottom-face template
(+,-)(+,+)(-,+)(-,-) then the top face.
"""
from __future__ import annotations

import numpy as np

from .common_np import rotate_points_along_z
from .rotated_iou_np import rotated_iou_matrix

# bottom face CCW then top face
CORNER_TEMPLATE = (
    np.array(
        [
            [1, -1, -1],
            [1, 1, -1],
            [-1, 1, -1],
            [-1, -1, -1],
            [1, -1, 1],
            [1, 1, 1],
            [-1, 1, 1],
            [-1, -1, 1],
        ],
        dtype=np.float64,
    )
    / 2.0
)


def _to_lwh(boxes: np.ndarray, order: str) -> np.ndarray:
    if order == "lwh":
        return boxes
    if order == "hwl":
        return boxes[:, [0, 1, 2, 5, 4, 3, 6]]
    raise ValueError(f"unknown box order {order!r}")


def boxes_to_corners_3d(boxes3d: np.ndarray, order: str) -> np.ndarray:
    """(N, 7) center boxes -> (N, 8, 3) corners."""
    boxes = _to_lwh(np.asarray(boxes3d, dtype=np.float64), order)
    corners = boxes[:, None, 3:6] * CORNER_TEMPLATE[None]
    corners = rotate_points_along_z(corners, boxes[:, 6])
    return corners + boxes[:, None, 0:3]


def corners_to_standup_2d(corners: np.ndarray) -> np.ndarray:
    """(N, K, 2+) corners -> (N, 4) [x1, y1, x2, y2] axis-aligned hulls."""
    return np.stack(
        [
            corners[..., 0].min(axis=1),
            corners[..., 1].min(axis=1),
            corners[..., 0].max(axis=1),
            corners[..., 1].max(axis=1),
        ],
        axis=1,
    )


def standup_iou_matrix(
    boxes: np.ndarray, query: np.ndarray, plus_one: bool = True
) -> np.ndarray:
    """Axis-aligned IoU matrix, (N, 4) x (K, 4) -> (N, K).

    ``plus_one=True`` is the Pascal-VOC "+1" convention of anchor target
    assignment.
    """
    off = 1.0 if plus_one else 0.0
    boxes = np.asarray(boxes, dtype=np.float64)
    query = np.asarray(query, dtype=np.float64)
    area_b = (boxes[:, 2] - boxes[:, 0] + off) * (boxes[:, 3] - boxes[:, 1] + off)
    area_q = (query[:, 2] - query[:, 0] + off) * (query[:, 3] - query[:, 1] + off)
    iw = (
        np.minimum(boxes[:, None, 2], query[None, :, 2])
        - np.maximum(boxes[:, None, 0], query[None, :, 0])
        + off
    )
    ih = (
        np.minimum(boxes[:, None, 3], query[None, :, 3])
        - np.maximum(boxes[:, None, 1], query[None, :, 1])
        + off
    )
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    union = area_b[:, None] + area_q[None, :] - inter
    return np.where((iw > 0) & (ih > 0), inter / union, 0.0)


def polygon_iou_matrix(corners_a: np.ndarray, corners_b: np.ndarray) -> np.ndarray:
    """Rotated-rect IoU matrix from BEV corners.

    Accepts (N, 4, 2), (N, 4, 3) or (N, 8, 3) corner sets; only the first
    four corners' xy are used.
    """
    ca = np.asarray(corners_a, dtype=np.float64)[:, :4, :2]
    cb = np.asarray(corners_b, dtype=np.float64)[:, :4, :2]
    if ca.shape[0] == 0 or cb.shape[0] == 0:
        return np.zeros((ca.shape[0], cb.shape[0]))
    return rotated_iou_matrix(ca, cb)


def mask_boxes_outside_range(
    boxes: np.ndarray,
    limit_range,
    order: str | None,
    min_num_corners: int = 8,
    return_mask: bool = False,
):
    """Keep boxes with >= min_num_corners corners inside the xyz range.

    ``boxes`` may be (N, 7) centers (converted with ``order``) or (N, 8, 3)
    corners already.
    """
    boxes = np.asarray(boxes)
    corners = boxes if boxes.ndim == 3 else boxes_to_corners_3d(boxes, order)
    limit = np.asarray(limit_range, dtype=np.float64)
    inside = (corners >= limit[0:3]) & (corners <= limit[3:6])
    mask = inside.all(axis=2).sum(axis=1) >= min_num_corners
    if return_mask:
        return boxes[mask], mask
    return boxes[mask]


def project_points(points: np.ndarray, tfm: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points."""
    homo = np.concatenate([points, np.ones((points.shape[0], 1))], axis=1)
    return (homo @ tfm.T)[:, :3]


def camera_visible_mask(boxes: np.ndarray, visibility_map: np.ndarray):
    """Which boxes a camera rig can see, per the ego BEV visibility map.

    Vectorization of the reference's box_is_visible
    (box_utils.py:1236-1266): the map is 256x256 at 0.39 m/pixel,
    ego-centered, heading up (py = 127 - x/0.39, px = 127 + y/0.39);
    a box is visible iff the map is non-zero at its center cell.
    boxes: (N, >=2) with ego-frame x, y in the first two columns.
    """
    if len(boxes) == 0:
        return np.zeros(0, dtype=bool)
    x = boxes[:, 0]
    y = boxes[:, 1]
    py = 127 - (x / 0.39).astype(np.int64)
    px = 127 + (y / 0.39).astype(np.int64)
    h, w = visibility_map.shape[:2]
    inside = (py >= 0) & (py < h) & (px >= 0) & (px < w)
    vis = np.zeros(len(boxes), dtype=bool)
    vis[inside] = visibility_map[py[inside], px[inside]] > 0
    return vis
