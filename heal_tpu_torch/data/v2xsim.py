"""V2X-Sim 2.0 backend (nuScenes-style info pickle).

The port's copy of heal_tpu/data/v2xsim.py: a pickle of per-frame
dicts, ``agent_num``, per agent ``lidar_path_{k}`` (an .npy sweep, xyz
or xyzi; an xyz sweep gets intensity 1), ``lidar_pose_{k}`` (a 4x4
world transform) and ``labels_{k}`` with ``gt_boxes_global`` (N, 7
world boxes) and ``gt_object_ids``. Agent ids start at 1; in training
their order is ``1 + permutation(n)`` from the backend's
``default_rng(seed)`` (``reinitialize``), so that any agent can be the
ego; at most ``max_cav`` agents.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..utils import transform_np


class V2XSimBackend:
    def __init__(self, params: dict, train: bool = True):
        self.params = params
        self.train = train
        if train:
            self.pkl_path = params["root_dir"]
        else:
            self.pkl_path = (
                params.get("validate_dir")
                or params.get("test_dir")
                or params["root_dir"]
            )
        with open(self.pkl_path, "rb") as f:
            self.infos = pickle.load(f)
        self.base_dir = os.path.dirname(self.pkl_path)
        self.max_cav = params.get("train_params", {}).get("max_cav", 5)
        self.reinitialize()

    def reinitialize(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.infos)

    def _load_points(self, path: str) -> np.ndarray:
        if not os.path.isabs(path) and not os.path.exists(path):
            path = os.path.join(self.base_dir, path)
        pts = np.load(path)
        if pts.shape[1] == 3:
            pts = np.concatenate(
                [pts, np.ones((len(pts), 1), pts.dtype)], axis=1
            )
        return pts[:, :4].astype(np.float32)

    def scene(self, idx: int) -> dict:
        info = self.infos[idx]
        n = int(info["agent_num"])
        ids = list(range(1, n + 1))
        if self.train:
            ids = list(1 + self.rng.permutation(n))
        ids = ids[: self.max_cav]

        agents = []
        objects = None
        for cav_id in ids:
            pose_tfm = np.asarray(info[f"lidar_pose_{cav_id}"], np.float64)
            agents.append(
                {
                    "pose": transform_np.tfm_to_pose(pose_tfm),
                    "modality": "m1",
                    "points": self._load_points(info[f"lidar_path_{cav_id}"]),
                }
            )
            if objects is None:
                boxes = np.asarray(
                    info[f"labels_{cav_id}"]["gt_boxes_global"], np.float64
                )
                objects = boxes.reshape(-1, 7)
        return {"agents": agents, "objects": objects}


def write_synthetic_v2xsim_pickle(
    root: str, num_frames: int = 2, num_agents: int = 3, seed: int = 0,
    ground_points: int = 300, points_per_box: int = 400,
):
    """A small V2X-Sim info pickle and its .npy sweeps; ``ground_points``
    / ``points_per_box`` set the lidar's density."""
    from .synthetic import simulate_lidar

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    infos = []
    for i in range(num_frames):
        objects = np.zeros((5, 7))
        objects[:, 0] = rng.uniform(-30, 30, 5)
        objects[:, 1] = rng.uniform(-15, 15, 5)
        objects[:, 2] = 0.75
        objects[:, 3:6] = [4.2, 1.8, 1.5]
        objects[:, 6] = rng.uniform(-np.pi, np.pi, 5)
        info = {"agent_num": num_agents}
        for k in range(1, num_agents + 1):
            pose = [
                float(rng.uniform(-15, 15)) if k > 1 else 0.0,
                float(rng.uniform(-8, 8)) if k > 1 else 0.0,
                1.9,
                0.0,
                float(rng.uniform(-90, 90)) if k > 1 else 0.0,
                0.0,
            ]
            pts = simulate_lidar(objects, pose, rng,
                                 points_per_box=points_per_box,
                                 ground_points=ground_points)
            rel = f"frame{i}_agent{k}.npy"
            np.save(os.path.join(root, rel), pts)
            info[f"lidar_path_{k}"] = rel
            info[f"lidar_pose_{k}"] = transform_np.x_to_world(pose)
            info[f"labels_{k}"] = {
                "gt_boxes_global": objects.copy(),
                "gt_object_ids": np.arange(len(objects)),
            }
        infos.append(info)
    pkl = os.path.join(root, "infos.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(infos, f)
    return pkl
