"""What the port's two hand-written kernels' functions need, counted
each input read once and each output written once.

Kernel 1 (the PointPillars scatter: per-point features to the BEV
canvas). After heal_tpu_torch/kernels/cases.py ``pillar_work`` at
commit 067a829, counted from a frame's points rather than from the
kernel's arguments: per landed point (valid and inside the grid) its F
features, its four geometry floats and its pillar id are read; the
seven F-wide weight rows are read; the whole canvas (every agent slot of
the branch, every cell, F channels) is written once. Operations: the
channel max and four sums a landed point, and the 14-operation epilogue
a channel of a non-empty pillar.

Kernel 2 (a fractional shift of every row or column of N images,
zero-filled). After chip_smoke.py's kernel-2 count at commit 067a829:
the image read once and written once, one f32 shift a row or column,
three operations an element.
"""
from __future__ import annotations

import numpy as np


def landed(points: np.ndarray, mask: np.ndarray, lidar_range, voxel_size):
    """(landed points, non-empty pillars) of a (S, N, 4) branch input."""
    x0, y0, z0, x1, y1, z1 = lidar_range
    nx = int(round((x1 - x0) / voxel_size[0]))
    ny = int(round((y1 - y0) / voxel_size[1]))
    p = points.astype(np.float32)
    xi = np.floor((p[..., 0] - np.float32(x0)) / np.float32(voxel_size[0]))
    yi = np.floor((p[..., 1] - np.float32(y0)) / np.float32(voxel_size[1]))
    ok = (mask & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
          & (p[..., 2] >= z0) & (p[..., 2] <= z1))
    sample = np.broadcast_to(np.arange(p.shape[0])[:, None], ok.shape)
    ids = (sample * (nx * ny) + yi * nx + xi)[ok]
    return int(ok.sum()), int(np.unique(ids).size), nx * ny


def pillar_work(points, mask, lidar_range, voxel_size, features: int,
                elem: int = 4) -> dict:
    n_land, runs, cells = landed(points, mask, lidar_range, voxel_size)
    canvas = points.shape[0] * cells * features * elem
    row = features * elem + 4 * 4 + 4
    return {"bytes": n_land * row + 7 * features * 4 + canvas,
            "flops": n_land * (features + 4) + runs * features * 14}


def shift_work(shape, elem: int = 4, axis: int = 0) -> dict:
    """One shift of an (N, H, W, C) image, rows (axis 0) or columns."""
    n, h, w, c = shape
    size = n * h * w * c
    return {"bytes": 2 * size * elem + n * (h if axis == 0 else w) * 4,
            "flops": 3 * size}
