"""Torch box geometry: corners, decode, projection (device side).

Counterpart of heal_tpu/ops/geometry.py, with the same conventions as the
shared numpy heal_tpu.utils.box_np.
"""
from __future__ import annotations

import math

import torch

from .. import trace
from ..utils.common import limit_period

_CORNER_TEMPLATE = [
    [1, -1, -1],
    [1, 1, -1],
    [-1, 1, -1],
    [-1, -1, -1],
    [1, -1, 1],
    [1, 1, 1],
    [-1, 1, 1],
    [-1, -1, 1],
]


def boxes_to_corners_3d(boxes: torch.Tensor, order: str) -> torch.Tensor:
    """(..., 7) -> (..., 8, 3); same template as box_np. The index list
    and the template cross to the device as pageable copies
    (``host_sync.const``)."""
    if order == "hwl":
        boxes = boxes[..., [0, 1, 2, 5, 4, 3, 6]]
        trace.count("host_sync.const")
    elif order != "lwh":
        raise ValueError(f"unknown order {order!r}")
    template = torch.tensor(
        _CORNER_TEMPLATE, dtype=boxes.dtype, device=boxes.device
    ) / 2.0
    trace.count("host_sync.const")
    dims = boxes[..., None, 3:6] * template  # (..., 8, 3)
    yaw = boxes[..., 6]
    c, s = torch.cos(yaw), torch.sin(yaw)
    x = dims[..., 0] * c[..., None] - dims[..., 1] * s[..., None]
    y = dims[..., 0] * s[..., None] + dims[..., 1] * c[..., None]
    rot = torch.stack([x, y, dims[..., 2]], dim=-1)
    return rot + boxes[..., None, 0:3]


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Residual decode; deltas/anchors (..., 7), anchors in hwl order."""
    d = torch.sqrt(anchors[..., 4] ** 2 + anchors[..., 5] ** 2)
    xy = deltas[..., 0:2] * d[..., None] + anchors[..., 0:2]
    z = deltas[..., 2:3] * anchors[..., 3:4] + anchors[..., 2:3]
    dims = torch.exp(deltas[..., 3:6]) * anchors[..., 3:6]
    yaw = deltas[..., 6:7] + anchors[..., 6:7]
    return torch.cat([xy, z, dims, yaw], dim=-1)


def correct_direction(
    yaw: torch.Tensor,
    dir_labels: torch.Tensor,
    dir_offset: float = 0.7853,
    num_bins: int = 2,
) -> torch.Tensor:
    """Snap yaw into the classified direction bin."""
    period = 2 * math.pi / num_bins
    dir_rot = limit_period(yaw - dir_offset, 0.0, period)
    yaw = dir_rot + dir_offset + period * dir_labels.to(yaw.dtype)
    return limit_period(yaw, 0.5, 2 * math.pi)


def project_points(points: torch.Tensor, tfm: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points through (..., 4, 4) transform."""
    return points @ tfm[..., :3, :3].transpose(-1, -2) + tfm[..., None, :3, 3]


def project_corners(corners: torch.Tensor, tfm: torch.Tensor) -> torch.Tensor:
    """(N, 8, 3) corners through a (4, 4) transform."""
    flat = corners.reshape(-1, 3)
    return project_points(flat, tfm).reshape(corners.shape)
