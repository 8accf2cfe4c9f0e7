"""Pose-noise injection (host side, numpy).

The port's copy of heal_tpu/utils/pose_noise.py: Gaussian, Laplace, or
von-Mises noise on (x, y, yaw) of every agent pose, driven by the
config's ``noise_setting``. Draws from numpy's global generator, as the
JAX package does, so both give the same poses from the same seed.
"""
from __future__ import annotations

import numpy as np


def generate_noise(
    pos_std: float, rot_std: float, pos_mean: float = 0.0, rot_mean: float = 0.0
) -> np.ndarray:
    """Gaussian (x, y, yaw) noise as a 6-dof pose delta (degrees for yaw)."""
    xy = np.random.normal(pos_mean, pos_std, size=2)
    yaw = np.random.normal(rot_mean, rot_std, size=1)
    return np.array([xy[0], xy[1], 0.0, 0.0, yaw[0], 0.0])


def generate_noise_laplace(
    pos_b: float, rot_b: float, pos_mu: float = 0.0, rot_mu: float = 0.0
) -> np.ndarray:
    """Laplace (x, y, yaw) noise as a 6-dof pose delta."""
    xy = np.random.laplace(pos_mu, pos_b, size=2)
    yaw = np.random.laplace(rot_mu, rot_b, size=1)
    return np.array([xy[0], xy[1], 0.0, 0.0, yaw[0], 0.0])


def generate_noise_von_mises(
    pos_std: float, rot_std: float, pos_mean: float = 0.0, rot_mean: float = 0.0
) -> np.ndarray:
    """Gaussian position + von-Mises yaw noise as a 6-dof pose delta.

    The concentration is ``(180 / (pi * rot_std))**2``, i.e. kappa =
    1/sigma_rad^2, the circular analogue of a Gaussian with std ``rot_std``
    degrees; the sample (radians) is converted to degrees.
    """
    xy = np.random.normal(pos_mean, pos_std, size=2)
    if rot_std <= 0:
        yaw_deg = rot_mean
    else:
        kappa = (180.0 / (np.pi * rot_std)) ** 2
        yaw_deg = np.degrees(
            np.random.vonmises(np.radians(rot_mean), kappa)
        )
    return np.array([xy[0], xy[1], 0.0, 0.0, yaw_deg, 0.0])


def add_pose_noise(poses: list, args: dict) -> list:
    """Apply noise to every agent pose, the ego's included."""
    if args.get("laplace", False):
        gen = generate_noise_laplace
    elif args.get("von_mises", False):
        gen = generate_noise_von_mises
    else:
        gen = generate_noise
    out = []
    for pose in poses:
        delta = gen(
            args["pos_std"], args["rot_std"],
            args.get("pos_mean", 0.0), args.get("rot_mean", 0.0),
        )
        out.append(np.asarray(pose, dtype=np.float64) + delta)
    return out
