"""Small numpy helpers of the host side.

The port's copies of heal_tpu/utils/common.py ``limit_period``,
``rotate_points_along_z`` and ``update_dict``, numpy in and numpy out (the
JAX package's ``limit_period`` sends any other input to jax.numpy). The torch
``limit_period`` of the device side is utils/common.py.
"""
from __future__ import annotations

import numpy as np


def limit_period(val, offset: float = 0.5, period: float = 2 * np.pi):
    """Wrap ``val`` into ``[-offset*period, (1-offset)*period)``."""
    val = np.asarray(val)
    return val - np.floor(val / period + offset) * period


def update_dict(base: dict, override: dict) -> dict:
    """Recursively override keys of ``base`` with ``override``, in place
    (the config-override mechanism of the inference tools)."""
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            update_dict(base[key], value)
        else:
            base[key] = value
    return base


def rotate_points_along_z(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotate batches of points around +z.

    points: (B, N, 3[+C]) ; angle: (B,) radians. Returns same shape.
    """
    cosa = np.cos(angle)
    sina = np.sin(angle)
    zeros = np.zeros_like(angle)
    ones = np.ones_like(angle)
    rot = np.stack(
        [cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], axis=1
    ).reshape(-1, 3, 3)
    xyz = points[:, :, 0:3] @ rot
    return np.concatenate([xyz, points[:, :, 3:]], axis=-1)
