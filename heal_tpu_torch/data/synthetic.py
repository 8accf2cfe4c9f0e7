"""Synthetic collaborative-perception scenes (no disk data needed).

The port's copy of heal_tpu/data/synthetic.py: procedurally generated
worlds with vehicles (GT boxes) and agents whose "lidar" samples box
surfaces and ground with distance-dependent density. The same seed gives
the same scenes as the JAX package, and with ``label_type: camera`` each
agent's BEV visibility raster (``bev_visibility_map``).
"""
from __future__ import annotations

import numpy as np

from ..utils import transform_np


def simulate_lidar(
    objects_world: np.ndarray,
    agent_pose,
    rng: np.random.Generator,
    points_per_box: int = 400,
    ground_points: int = 2000,
    max_range: float = 100.0,
    channels: int = 64,
):
    """Simulate a point cloud in the agent's frame.

    objects_world: (K, 7) lwh world boxes. Density falls off with distance
    and with lidar channel count (16/32/64-line heterogeneity hook).
    Returns (N, 4) [x y z intensity].
    """
    t_world_agent = transform_np.x_to_world(agent_pose)
    t_agent_world = np.linalg.inv(t_world_agent)
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
        # sample on the 4 vertical faces + roof
        face = rng.integers(0, 5, n)
        u = rng.uniform(-0.5, 0.5, n)
        v = rng.uniform(-0.5, 0.5, n)
        px = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u)) * l
        py = np.where(face == 2, 0.5, np.where(face == 3, -0.5, u)) * w
        py = np.where(face < 2, v * w, py)
        pz = np.where(face == 4, 0.5, rng.uniform(-0.5, 0.5, n)) * h
        c, s = np.cos(yaw), np.sin(yaw)
        wx = x + px * c - py * s
        wy = y + px * s + py * c
        wz = z + pz
        pts_w = np.stack([wx, wy, wz], axis=1)
        clouds.append(pts_w)
    # ground plane
    r = np.sqrt(rng.uniform(2.0**2, max_range**2, ground_points))
    theta = rng.uniform(-np.pi, np.pi, ground_points)
    gx = agent_pose[0] + r * np.cos(theta)
    gy = agent_pose[1] + r * np.sin(theta)
    gz = np.zeros(ground_points) + rng.normal(0, 0.02, ground_points)
    clouds.append(np.stack([gx, gy, gz], axis=1))

    pts_w = np.concatenate(clouds, axis=0)
    homo = np.concatenate([pts_w, np.ones((len(pts_w), 1))], axis=1)
    pts_a = (homo @ t_agent_world.T)[:, :3]
    intensity = rng.uniform(0.1, 1.0, (len(pts_a), 1))
    pts = np.concatenate([pts_a, intensity], axis=1).astype(np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    return pts


def make_scene(
    rng: np.random.Generator,
    num_agents: int = 3,
    num_vehicles: int = 10,
    area: float = 60.0,
    modalities=("m1",),
    lidar_channels: dict | None = None,
):
    """One random scene: agents on a rough line, vehicles scattered."""
    objects = np.zeros((num_vehicles, 7))
    objects[:, 0] = rng.uniform(-area, area, num_vehicles)
    objects[:, 1] = rng.uniform(-area / 2, area / 2, num_vehicles)
    objects[:, 2] = 0.75
    objects[:, 3] = rng.uniform(3.6, 4.6, num_vehicles)  # l
    objects[:, 4] = rng.uniform(1.5, 1.9, num_vehicles)  # w
    objects[:, 5] = rng.uniform(1.4, 1.7, num_vehicles)  # h
    objects[:, 6] = rng.uniform(-np.pi, np.pi, num_vehicles)

    agents = []
    for i in range(num_agents):
        pose = [
            rng.uniform(-20, 20) if i else 0.0,
            rng.uniform(-10, 10) if i else 0.0,
            1.9,
            0.0,
            rng.uniform(-180, 180) if i else 0.0,
            0.0,
        ]
        modality = modalities[i % len(modalities)]
        channels = (lidar_channels or {}).get(modality, 64)
        agents.append(
            {
                "pose": pose,
                "modality": modality,
                "points": simulate_lidar(
                    objects, pose, rng, channels=channels
                ),
            }
        )
    return {"agents": agents, "objects": objects}


class SyntheticDataset:
    """Deterministic synthetic scene collection (seeded per index)."""

    def __init__(
        self,
        params: dict,
        train: bool = True,
        num_scenes: int = 32,
        num_agents: int = 3,
        num_vehicles: int = 10,
        seed: int = 0,
    ):
        self.params = params
        self.train = train
        self.num_scenes = num_scenes
        self.num_agents = num_agents
        self.num_vehicles = num_vehicles
        self.seed = seed
        heter = params.get("heter")
        self.modalities = (
            sorted(heter["modality_setting"].keys()) if heter else ["m1"]
        )
        self.lidar_channels = (heter or {}).get("lidar_channels_dict", {})

    def __len__(self):
        return self.num_scenes

    def scene(self, idx: int) -> dict:
        rng = np.random.default_rng(
            self.seed * 100003 + idx + (0 if self.train else 10_000_019)
        )
        scene = make_scene(
            rng,
            num_agents=self.num_agents,
            num_vehicles=self.num_vehicles,
            modalities=tuple(self.modalities),
            lidar_channels=self.lidar_channels,
        )
        if self.params.get("label_type") == "camera":
            # camera-visible GT needs per-agent visibility rasters
            # (ref ships bev_visibility.png per frame)
            for agent in scene["agents"]:
                agent["bev_visibility"] = bev_visibility_map(
                    scene["objects"], agent["pose"]
                )
        return scene


def bev_visibility_map(objects, pose, max_range=50.0, size=256, res=0.39):
    """Synthesize the ego-centered BEV visibility raster the reference
    ships as bev_visibility.png (256x256 at 0.39 m/px, heading up:
    py = 127 - x/res, px = 127 + y/res — box_utils.py:1236-1266).

    Angular occlusion from a surround camera rig: the nearest object
    along each viewing ray is visible; objects behind it, or beyond
    max_range, are not. Visible objects paint a small disk at their
    center (the reference's filter samples the map at box centers).
    """
    vis = np.zeros((size, size), np.uint8)
    t = np.linalg.inv(transform_np.x_to_world(pose))
    centers = (t[:3, :3] @ np.asarray(objects)[:, :3].T).T + t[:3, 3]
    x, y = centers[:, 0], centers[:, 1]
    r = np.hypot(x, y)
    theta = np.arctan2(y, x)
    half = np.arctan2(
        np.maximum(objects[:, 3], objects[:, 4]) / 2.0, np.maximum(r, 1e-3)
    )

    def wrap(a):
        return (a + np.pi) % (2 * np.pi) - np.pi

    order = np.argsort(r)
    blockers = []  # (theta, half_width, range) of every nearer object
    for i in order:
        if r[i] > max_range:
            continue
        occluded = any(
            rb < r[i] and abs(wrap(theta[i] - tb)) < 0.8 * hb
            for tb, hb, rb in blockers
        )
        if not occluded:
            py = 127 - int(x[i] / res)
            px = 127 + int(y[i] / res)
            if 0 <= py < size and 0 <= px < size:
                vis[
                    max(py - 2, 0) : py + 3, max(px - 2, 0) : px + 3
                ] = 255
        blockers.append((theta[i], half[i], r[i]))
    # the rig always sees its own immediate surroundings
    vis[125:130, 125:130] = 255
    return vis
