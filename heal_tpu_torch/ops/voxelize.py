"""Device-side pillar binning (torch).

Counterpart of heal_tpu/ops/voxelize.py ``pillar_ids`` (:28-61).
"""
from __future__ import annotations

import torch


def pillar_ids(points: torch.Tensor, mask: torch.Tensor, lidar_range,
               voxel_size, grid_nx: int, grid_ny: int):
    """Per-point pillar index into the flattened (ny, nx) BEV grid.

    points (..., N, >=3); mask (..., N) bool. Returns (ids int32, valid):
    ids in [0, ny*nx) for valid in-range points, ny*nx (the drop bucket)
    otherwise. Binning is in f32 whatever the points' dtype, so it agrees
    with the host presort (data/scene.py).
    """
    x0, y0, z0, x1, y1, z1 = lidar_range
    vx, vy = voxel_size[0], voxel_size[1]
    px = points[..., 0].to(torch.float32)
    py = points[..., 1].to(torch.float32)
    xi = torch.floor((px - x0) / vx).to(torch.int32)
    yi = torch.floor((py - y0) / vy).to(torch.int32)
    in_range = (
        (xi >= 0)
        & (xi < grid_nx)
        & (yi >= 0)
        & (yi < grid_ny)
        & (points[..., 2] >= z0)
        & (points[..., 2] <= z1)
        & mask
    )
    ids = torch.where(in_range, yi * grid_nx + xi,
                      torch.full_like(xi, grid_nx * grid_ny))
    return ids, in_range
