"""Sparse-conv constants shared with the column engine (torch).

A trimmed counterpart of heal_tpu/ops/sparse_conv.py: only what
ops/column_conv.py needs, the padding key, the 27 kernel offsets in the
(27, Cin, Cout) weight layout, and the linear voxel key. The voxel
"oracle" engine of that module (``voxelize_points``, ``neighbor_table``,
``downsample_sites*``, ``strided_table*``, ``apply_table_conv``), whose
only user is the reference-exact ``SecondRefEncoder``, is ROADMAP queue 1,
item 17.
"""
from __future__ import annotations

INVALID = 2**31 - 1  # int32 max: the key of padding columns and points


def linear_key(coords, grid_zyx):
    """coords (..., 3) [z, y, x] -> the linear key z*H*W + y*W + x."""
    _, h, w = grid_zyx
    return coords[..., 0] * (h * w) + coords[..., 1] * w + coords[..., 2]


def _offsets(k: int = 3):
    """The kernel's (dz, dy, dx) offsets, dz-major: row i of a
    (27, Cin, Cout) weight is offset i."""
    r = range(-(k // 2), k // 2 + 1)
    return [(dz, dy, dx) for dz in r for dy in r for dx in r]
