"""The benchmark's scene generator: raw collaborative-perception scenes
from a seed.

Frozen copy of heal_tpu_torch/data/synthetic.py (``simulate_lidar``,
``make_scene``), of ``utils/transform_np.x_to_world`` and of
utils/camera.py's ``default_camera_rig`` and ``default_intrinsics``, at commit
067a829, with the densities taken from the traffic file instead of
defaults. A scene is what a recording gives: each agent's pose, modality
and lidar sweep in its own frame (N, 4), and the world-frame vehicle
boxes (K, 7). Camera agents also carry their rig (``cameras``): seeded
images and the calibration of utils/camera.py's default rig, so that
both the program and the reference read the same pixels.

Scene ``k`` of a run with ``--seed s`` draws from
``SeedSequence([s, k])`` alone: the same seed gives the same scenes, and
every seed gives scenes of the same sizes (agents, vehicles, point
counts up to the padding), so a seed changes the content and not the
work.
"""
from __future__ import annotations

import numpy as np


def x_to_world(pose) -> np.ndarray:
    """Pose [x, y, z, roll, yaw, pitch] (degrees, CARLA) -> T_world_x."""
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


def simulate_lidar(objects_world, agent_pose, rng, points_per_box: int,
                   ground_points: int, max_range: float, channels: int):
    """A sweep (N, 4) [x y z intensity] in the agent's frame: box faces
    and roof sampled with density falling off with distance and with the
    channel count, and a ground disk."""
    t_agent_world = np.linalg.inv(x_to_world(agent_pose))
    clouds = []
    density_scale = channels / 64.0
    for box in objects_world:
        x, y, z, l, w, h, yaw = box
        d = np.linalg.norm([x - agent_pose[0], y - agent_pose[1]])
        if d > max_range:
            continue
        n = int(points_per_box * density_scale / max(1.0, (d / 10.0) ** 1.5))
        if n < 5:
            continue
        face = rng.integers(0, 5, n)
        u = rng.uniform(-0.5, 0.5, n)
        v = rng.uniform(-0.5, 0.5, n)
        px = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u)) * l
        py = np.where(face == 2, 0.5, np.where(face == 3, -0.5, u)) * w
        py = np.where(face < 2, v * w, py)
        pz = np.where(face == 4, 0.5, rng.uniform(-0.5, 0.5, n)) * h
        c, s = np.cos(yaw), np.sin(yaw)
        clouds.append(np.stack([x + px * c - py * s, y + px * s + py * c,
                                z + pz], axis=1))
    r = np.sqrt(rng.uniform(2.0 ** 2, max_range ** 2, ground_points))
    theta = rng.uniform(-np.pi, np.pi, ground_points)
    clouds.append(np.stack([agent_pose[0] + r * np.cos(theta),
                            agent_pose[1] + r * np.sin(theta),
                            rng.normal(0, 0.02, ground_points)], axis=1))
    pts_w = np.concatenate(clouds, axis=0)
    homo = np.concatenate([pts_w, np.ones((len(pts_w), 1))], axis=1)
    pts_a = (homo @ t_agent_world.T)[:, :3]
    intensity = rng.uniform(0.1, 1.0, (len(pts_a), 1))
    pts = np.concatenate([pts_a, intensity], axis=1).astype(np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    return pts


def default_rig(ncam: int, height: float = 1.9):
    """(rotation camera->agent, translation) of a surround rig at yaw 0,
    90, 180, 270 degrees (utils/camera.default_camera_rig)."""
    rig = []
    for i in range(ncam):
        yaw = np.radians(90.0 * i)
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[-s, 0.0, c], [c, 0.0, s], [0.0, -1.0, 0.0]])
        rig.append((rot, np.array([0.0, 0.0, height])))
    return rig


def default_intrinsics(h: int, w: int, fov_deg: float = 100.0):
    """A centred pinhole of ``fov_deg`` across the width
    (utils/camera.default_intrinsics)."""
    f = w / (2 * np.tan(np.radians(fov_deg) / 2))
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])


def make_scene(rng, traffic: dict, modalities, lidar_channels: dict,
               cameras: dict):
    """One scene: ``traffic``'s agents on a rough line around the ego,
    its vehicles scattered over the area. ``modalities`` (sorted agent
    types) cycle over the agents, the ego first; ``cameras`` maps a
    camera type to (ncam, image height, image width)."""
    nv, area = traffic["vehicles"], traffic["area_m"]
    objects = np.zeros((nv, 7))
    objects[:, 0] = rng.uniform(-area, area, nv)
    objects[:, 1] = rng.uniform(-area / 2, area / 2, nv)
    objects[:, 2] = 0.75
    objects[:, 3] = rng.uniform(3.6, 4.6, nv)
    objects[:, 4] = rng.uniform(1.5, 1.9, nv)
    objects[:, 5] = rng.uniform(1.4, 1.7, nv)
    objects[:, 6] = rng.uniform(-np.pi, np.pi, nv)
    agents = []
    for i in range(traffic["agents"]):
        pose = [rng.uniform(-20, 20) if i else 0.0,
                rng.uniform(-10, 10) if i else 0.0, 1.9, 0.0,
                rng.uniform(-180, 180) if i else 0.0, 0.0]
        modality = modalities[i % len(modalities)]
        agent = {"pose": pose, "modality": modality,
                 "points": simulate_lidar(
                     objects, pose, rng, traffic["points_per_box"],
                     traffic["ground_points"], traffic["max_range_m"],
                     lidar_channels.get(modality, 64))}
        if modality in cameras:
            ncam, ih, iw = cameras[modality]
            rig = default_rig(ncam)
            agent["cameras"] = {
                "imgs": rng.normal(0.45, 0.2, (ncam, ih, iw, 3)).astype(
                    np.float32),
                "intrins": np.stack([default_intrinsics(ih, iw)] * ncam
                                    ).astype(np.float32),
                "rots": np.stack([r for r, _ in rig]).astype(np.float32),
                "trans": np.stack([t for _, t in rig]).astype(np.float32),
            }
        agents.append(agent)
    return {"agents": agents, "objects": objects}


def scene_kinds(hypes: dict):
    """(sorted agent types, lidar channels by type, camera shapes by
    type) of a configuration's ``heter`` block."""
    heter = hypes.get("heter") or {}
    setting = heter.get("modality_setting") or {"m1": {}}
    cameras = {}
    for m, s in setting.items():
        if s.get("sensor_type") == "camera":
            aug = s["data_aug_conf"]
            cameras[m] = (aug.get("Ncams", 4), *aug["final_dim"])
    return sorted(setting), heter.get("lidar_channels_dict") or {}, cameras


def scenes(hypes: dict, traffic: dict, seed: int, count: int,
           first: int = 0) -> list:
    """Scenes ``first`` .. ``first + count - 1`` of ``seed``."""
    kinds = scene_kinds(hypes)
    return [make_scene(np.random.default_rng(np.random.SeedSequence(
        [int(seed), k])), traffic, *kinds)
        for k in range(first, first + count)]
