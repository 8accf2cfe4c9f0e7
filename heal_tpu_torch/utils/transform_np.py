"""SE(3)/pose math (host side, numpy).

The port's copy of heal_tpu/utils/transform_np.py, trimmed to what the
host side uses: x_to_world (CARLA pose -> world transform with its
roll/pitch sign conventions) and its inverse ``tfm_to_pose`` (the
DAIR-V2X and V2X-Sim poses), x1_to_x2 (late and early fusion, camera
calibration), the pairwise transforms and their normalised BEV affines.

Poses are 6-dof lists/arrays ``[x, y, z, roll, yaw, pitch]`` in DEGREES
(CARLA convention).
"""
from __future__ import annotations

import numpy as np


def x_to_world(pose) -> np.ndarray:
    """Pose -> 4x4 transform to world (T_world_x), CARLA angle convention."""
    x, y, z, roll, yaw, pitch = pose
    c_y, s_y = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    c_r, s_r = np.cos(np.radians(roll)), np.sin(np.radians(roll))
    c_p, s_p = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))
    m = np.identity(4)
    m[0, 3], m[1, 3], m[2, 3] = x, y, z
    m[0, 0] = c_p * c_y
    m[0, 1] = c_y * s_p * s_r - s_y * c_r
    m[0, 2] = -c_y * s_p * c_r - s_y * s_r
    m[1, 0] = s_y * c_p
    m[1, 1] = s_y * s_p * s_r + c_y * c_r
    m[1, 2] = -s_y * s_p * c_r + c_y * s_r
    m[2, 0] = s_p
    m[2, 1] = -c_p * s_r
    m[2, 2] = c_p * c_r
    return m


def x1_to_x2(x1, x2) -> np.ndarray:
    """T_x2_x1: maps coordinates in the frame of pose x1 into that of x2."""
    return np.linalg.solve(x_to_world(x2), x_to_world(x1))


def tfm_to_pose(tfm: np.ndarray):
    """4x4 -> [x, y, z, roll, yaw, pitch] degrees (CARLA sign convention)."""
    yaw = np.degrees(np.arctan2(tfm[1, 0], tfm[0, 0]))
    roll = np.degrees(np.arctan2(-tfm[2, 1], tfm[2, 2]))
    pitch = np.degrees(
        np.arctan2(tfm[2, 0], np.sqrt(tfm[2, 1] ** 2 + tfm[2, 2] ** 2))
    )
    x, y, z = tfm[:3, 3]
    return [x, y, z, roll, yaw, pitch]


def get_pairwise_transformation(lidar_poses: list, max_cav: int) -> np.ndarray:
    """Pairwise (L, L, 4, 4) transforms; [i, j] = T_j_i (frame i -> frame j).

    ``lidar_poses`` is a list of 6-dof poses (only the first ``len`` slots are
    real agents; the rest stay identity, the fixed-L padding that makes the
    downstream fusion shapes static).
    """
    pairwise = np.tile(np.eye(4), (max_cav, max_cav, 1, 1))
    t_list = [x_to_world(p) for p in lidar_poses]
    for i in range(len(t_list)):
        for j in range(len(t_list)):
            if i != j:
                pairwise[i, j] = np.linalg.solve(t_list[j], t_list[i])
    return pairwise


def normalize_pairwise_tfm(
    pairwise_t_matrix: np.ndarray,
    H: int,
    W: int,
    discrete_ratio: float,
    downsample_rate: float = 1.0,
) -> np.ndarray:
    """(..., L, L, 4, 4) SE(3) -> (..., L, L, 2, 3) normalized BEV affines.

    ``F.affine_grid``-style normalized coordinates in [-1, 1] over a (H, W)
    feature map whose pixel size is ``discrete_ratio * downsample_rate``
    meters; consumed by heal_tpu_torch.ops.warp.
    """
    m = np.array(pairwise_t_matrix[..., [0, 1], :][..., [0, 1, 3]])
    m[..., 0, 1] = m[..., 0, 1] * H / W
    m[..., 1, 0] = m[..., 1, 0] * W / H
    m[..., 0, 2] = m[..., 0, 2] / (downsample_rate * discrete_ratio * W) * 2
    m[..., 1, 2] = m[..., 1, 2] / (downsample_rate * discrete_ratio * H) * 2
    return m
