"""World augmentations for late and early fusion training (host, numpy).

The port's copy of heal_tpu/data/augmentor.py (the reference's
data_utils/augmentor): random flip along x / y, global rotation around z
and global scaling, applied jointly to points and (K, 7) lwh GT boxes,
drawn from ``np.random.default_rng(seed)`` in the config's order, as JAX
draws them. Intermediate fusion never augments: it keeps the agents'
geometry consistent with each other.
"""
from __future__ import annotations

import numpy as np


def random_flip(points, boxes, rng, axes=("x",)):
    """Flip along world axes. boxes: (K, 7) lwh with yaw."""
    for axis in axes:
        if rng.random() < 0.5:
            continue
        if axis == "x":  # flip y coordinate
            points[:, 1] = -points[:, 1]
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
        elif axis == "y":  # flip x coordinate
            points[:, 0] = -points[:, 0]
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = np.pi - boxes[:, 6]
    return points, boxes


def global_rotation(points, boxes, rng, rot_range=(-0.78539816, 0.78539816)):
    angle = rng.uniform(*rot_range)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    points[:, :2] = points[:, :2] @ rot.T
    boxes[:, :2] = boxes[:, :2] @ rot.T
    boxes[:, 6] += angle
    return points, boxes


def global_scaling(points, boxes, rng, scale_range=(0.95, 1.05)):
    scale = rng.uniform(*scale_range)
    points[:, :3] *= scale
    boxes[:, :6] *= scale
    return points, boxes


class DataAugmentor:
    """Config-driven augmentation chain (``data_augment``: a list of
    ``{"NAME": ..., <its range>}`` or bare names)."""

    def __init__(self, config: list | None):
        self.config = config or []

    def __call__(self, points: np.ndarray, boxes: np.ndarray, seed=None):
        """-> augmented copies of (points, boxes). ``seed=None`` seeds the
        generator from the OS, as JAX's assemblers call it (ROADMAP §3)."""
        if not self.config:
            return points, boxes
        rng = np.random.default_rng(seed)
        points = np.array(points, copy=True)
        boxes = np.array(boxes, copy=True)
        for aug in self.config:
            opts = aug if isinstance(aug, dict) else {}
            name = aug["NAME"] if isinstance(aug, dict) else aug
            if name == "random_world_flip":
                points, boxes = random_flip(
                    points, boxes, rng, opts.get("ALONG_AXIS_LIST", ["x"]))
            elif name == "random_world_rotation":
                points, boxes = global_rotation(
                    points, boxes, rng,
                    opts.get("WORLD_ROT_ANGLE", [-0.78539816, 0.78539816]))
            elif name == "random_world_scaling":
                points, boxes = global_scaling(
                    points, boxes, rng,
                    opts.get("WORLD_SCALE_RANGE", [0.95, 1.05]))
        return points, boxes
