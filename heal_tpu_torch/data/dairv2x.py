"""DAIR-V2X-C backend: two agents (a vehicle and a roadside unit).

The port's copy of heal_tpu/data/dairv2x.py: a split json of vehicle
frame ids, the cooperative ``data_info.json`` keyed by vehicle frame,
the calibration chains (vehicle: lidar -> novatel -> world;
infrastructure: virtuallidar -> world plus the system error offset) in
f64, and the cooperative world-frame labels {3d_dimensions, 3d_location,
rotation}, merged already, so that the assembler needs no
cross-view deduplication. Point clouds come from the native reader
(``opv2v.load_pcd``). ``write_synthetic_dair_tree`` writes a small tree,
the JAX package's writer's files with the default arguments.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..utils import transform_np
from .opv2v import load_pcd


def read_json(path: str):
    with open(path, "r") as f:
        return json.load(f)


def _rot_trans_to_tfm(rotation, translation) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = np.asarray(rotation, dtype=np.float64)
    m[:3, 3] = np.asarray(translation, dtype=np.float64).reshape(3)
    return m


def veh_lidar_to_world(lidar_to_novatel: dict, novatel_to_world: dict):
    """Chain lidar -> novatel -> world."""
    a = _rot_trans_to_tfm(
        lidar_to_novatel["transform"]["rotation"],
        lidar_to_novatel["transform"]["translation"],
    )
    b = _rot_trans_to_tfm(
        novatel_to_world["rotation"], novatel_to_world["translation"]
    )
    return b @ a


def inf_virtuallidar_to_world(calib: dict, offset: dict):
    """virtuallidar -> world with the system error offset."""
    m = _rot_trans_to_tfm(calib["rotation"], calib["translation"])
    m[0, 3] += offset.get("delta_x", 0.0)
    m[1, 3] += offset.get("delta_y", 0.0)
    return m


def objects_from_labels(labels: list) -> np.ndarray:
    """Cooperative label list -> (K, 7) world lwh boxes."""
    out = []
    for obj in labels:
        dim = obj["3d_dimensions"]
        loc = obj["3d_location"]
        out.append(
            [
                float(loc["x"]),
                float(loc["y"]),
                float(loc["z"]),
                float(dim["l"]),
                float(dim["w"]),
                float(dim["h"]),
                float(obj.get("rotation", 0.0)),
            ]
        )
    return np.asarray(out, dtype=np.float64).reshape(-1, 7)


class DAIRV2XBackend:
    def __init__(self, params: dict, train: bool = True):
        self.params = params
        self.train = train
        split_path = params["root_dir" if train else "validate_dir"]
        self.root = params.get("data_dir", os.path.dirname(split_path))
        self.split = read_json(split_path)
        co_info = read_json(
            os.path.join(self.root, "cooperative", "data_info.json")
        )
        self.co_data = {}
        for info in co_info:
            frame_id = (
                os.path.basename(info["vehicle_image_path"]).split(".")[0]
            )
            self.co_data[frame_id] = info

    def reinitialize(self, seed: int = 0):
        pass

    def __len__(self):
        return len(self.split)

    def scene(self, idx: int) -> dict:
        veh_id = self.split[idx]
        info = self.co_data[veh_id]
        offset = info.get("system_error_offset", {})

        veh_pose_tfm = veh_lidar_to_world(
            read_json(
                os.path.join(
                    self.root,
                    "vehicle-side/calib/lidar_to_novatel",
                    f"{veh_id}.json",
                )
            ),
            read_json(
                os.path.join(
                    self.root,
                    "vehicle-side/calib/novatel_to_world",
                    f"{veh_id}.json",
                )
            ),
        )
        inf_id = os.path.basename(info["infrastructure_image_path"]).split(
            "."
        )[0]
        inf_pose_tfm = inf_virtuallidar_to_world(
            read_json(
                os.path.join(
                    self.root,
                    "infrastructure-side/calib/virtuallidar_to_world",
                    f"{inf_id}.json",
                )
            ),
            offset,
        )

        objects = objects_from_labels(
            read_json(os.path.join(self.root, info["cooperative_label_path"]))
        )

        agents = []
        for pose_tfm, pcd_key in (
            (veh_pose_tfm, "vehicle_pointcloud_path"),
            (inf_pose_tfm, "infrastructure_pointcloud_path"),
        ):
            points = load_pcd(os.path.join(self.root, info[pcd_key]))
            agents.append(
                {
                    "pose": transform_np.tfm_to_pose(pose_tfm),
                    "modality": "m1",
                    "points": points,
                }
            )
        return {"agents": agents, "objects": objects}


def write_synthetic_dair_tree(root: str, num_frames: int = 2, seed: int = 0,
                              ground_points: int = 400,
                              points_per_box: int = 400):
    """A small DAIR-V2X-C layout; ``ground_points`` / ``points_per_box``
    set the lidar's density (``synthetic.simulate_lidar``)."""
    from .synthetic import simulate_lidar

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "cooperative", "label"), exist_ok=True)
    for sub in (
        "vehicle-side/calib/lidar_to_novatel",
        "vehicle-side/calib/novatel_to_world",
        "vehicle-side/velodyne",
        "infrastructure-side/calib/virtuallidar_to_world",
        "infrastructure-side/velodyne",
        "vehicle-side/image",
        "infrastructure-side/image",
    ):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    infos = []
    split = []
    for i in range(num_frames):
        vid = f"{i:06d}"
        iid = f"9{i:05d}"
        objects = np.zeros((4, 7))
        objects[:, 0] = rng.uniform(-30, 30, 4)
        objects[:, 1] = rng.uniform(-15, 15, 4)
        objects[:, 2] = 0.75
        objects[:, 3:6] = [4.2, 1.8, 1.5]
        objects[:, 6] = rng.uniform(-np.pi, np.pi, 4)

        veh_pose = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
        inf_pose = [25.0, 5.0, 4.0, 0.0, 180.0, 0.0]
        veh_tfm = transform_np.x_to_world(veh_pose)
        inf_tfm = transform_np.x_to_world(inf_pose)

        with open(
            os.path.join(
                root, "vehicle-side/calib/lidar_to_novatel", f"{vid}.json"
            ),
            "w",
        ) as f:
            json.dump(
                {
                    "transform": {
                        "rotation": np.eye(3).tolist(),
                        "translation": [[0.0], [0.0], [0.0]],
                    }
                },
                f,
            )
        with open(
            os.path.join(
                root, "vehicle-side/calib/novatel_to_world", f"{vid}.json"
            ),
            "w",
        ) as f:
            json.dump(
                {
                    "rotation": veh_tfm[:3, :3].tolist(),
                    "translation": veh_tfm[:3, 3:4].tolist(),
                },
                f,
            )
        with open(
            os.path.join(
                root,
                "infrastructure-side/calib/virtuallidar_to_world",
                f"{iid}.json",
            ),
            "w",
        ) as f:
            json.dump(
                {
                    "rotation": inf_tfm[:3, :3].tolist(),
                    "translation": inf_tfm[:3, 3:4].tolist(),
                },
                f,
            )

        label = [
            {
                "3d_dimensions": {"l": o[3], "w": o[4], "h": o[5]},
                "3d_location": {"x": o[0], "y": o[1], "z": o[2]},
                "rotation": o[6],
            }
            for o in objects
        ]
        label_rel = f"cooperative/label/{vid}.json"
        with open(os.path.join(root, label_rel), "w") as f:
            json.dump(label, f)

        for pose, side, fid in (
            (veh_pose, "vehicle-side", vid),
            (inf_pose, "infrastructure-side", iid),
        ):
            pts = simulate_lidar(objects, pose, rng,
                                 points_per_box=points_per_box,
                                 ground_points=ground_points)
            pcd_rel = f"{side}/velodyne/{fid}.pcd"
            with open(os.path.join(root, pcd_rel), "w") as f:
                f.write(
                    "VERSION .7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
                    "TYPE F F F F\nCOUNT 1 1 1 1\n"
                    f"WIDTH {len(pts)}\nHEIGHT 1\n"
                    "VIEWPOINT 0 0 0 1 0 0 0\n"
                    f"POINTS {len(pts)}\nDATA ascii\n"
                )
                np.savetxt(f, pts, fmt="%.4f")

        infos.append(
            {
                "vehicle_image_path": f"vehicle-side/image/{vid}.jpg",
                "infrastructure_image_path": f"infrastructure-side/image/{iid}.jpg",
                "vehicle_pointcloud_path": f"vehicle-side/velodyne/{vid}.pcd",
                "infrastructure_pointcloud_path": f"infrastructure-side/velodyne/{iid}.pcd",
                "cooperative_label_path": label_rel,
                "system_error_offset": {"delta_x": 0.0, "delta_y": 0.0},
            }
        )
        split.append(vid)
    with open(os.path.join(root, "cooperative", "data_info.json"), "w") as f:
        json.dump(infos, f)
    split_path = os.path.join(root, "split.json")
    with open(split_path, "w") as f:
        json.dump(split, f)
    return split_path
