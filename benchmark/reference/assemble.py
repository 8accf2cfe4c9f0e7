"""Plain host assembly: a raw scene -> the arrays a HEAL intermediate-
fusion model reads, worked out again from the scene alone.

After heal_tpu_torch/data/scene.py (``IntermediateAssembler``) at commit
067a829, cut to what the benchmark's configurations use: the ego and the
agents within ``comm_range`` (ego first, at most ``max_cav``), their
pairwise transforms as normalised BEV affines, each lidar sweep
range-filtered and padded to ``max_points`` (the first points when
serving; a random subset drawn from numpy's global state when training,
as the program draws it), each agent type packed with the slots it
fills (with a ``heter`` block) or every slot's sweep as ``points`` and
``point_mask`` (without one), camera agents with their images and
calibration, and for training the anchor labels (``labels.py``). None
of the program's host-side preparations (the presort, the splat plans)
is made here: the reference model does not need them.
"""
from __future__ import annotations

import numpy as np

from . import labels


def x_to_world(pose) -> np.ndarray:
    x, y, z, roll, yaw, pitch = pose
    c_y, s_y = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    c_r, s_r = np.cos(np.radians(roll)), np.sin(np.radians(roll))
    c_p, s_p = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))
    return np.array([
        [c_p * c_y, c_y * s_p * s_r - s_y * c_r, -c_y * s_p * c_r - s_y * s_r,
         x],
        [s_y * c_p, s_y * s_p * s_r + c_y * c_r, -s_y * s_p * c_r + c_y * s_r,
         y],
        [s_p, -c_p * s_r, c_p * c_r, z],
        [0.0, 0.0, 0.0, 1.0]])


def pairwise_affine(poses, slots: int, rng) -> np.ndarray:
    """(L, L, 2, 3): [i, j] maps receiver i's normalised BEV coordinates
    into sender j's frame (identity for padded slots), on a map of the
    lidar range ``rng`` at one metre a pixel."""
    t = np.tile(np.eye(4), (slots, slots, 1, 1))
    worlds = [x_to_world(p) for p in poses]
    for i, ti in enumerate(worlds):
        for j, tj in enumerate(worlds):
            if i != j:
                t[i, j] = np.linalg.solve(tj, ti)
    h, w = rng[4] - rng[1], rng[3] - rng[0]
    m = t[..., [0, 1], :][..., [0, 1, 3]].copy()
    m[..., 0, 1] *= h / w
    m[..., 1, 0] *= w / h
    m[..., 0, 2] *= 2 / w
    m[..., 1, 2] *= 2 / h
    return m.astype(np.float32)


def in_range(points, rng):
    keep = ((points[:, 0] >= rng[0]) & (points[:, 0] <= rng[3])
            & (points[:, 1] >= rng[1]) & (points[:, 1] <= rng[4])
            & (points[:, 2] >= rng[2]) & (points[:, 2] <= rng[5]))
    return points[keep]


def assemble(hypes: dict, scene: dict, train: bool) -> dict:
    """One sample (unbatched numpy arrays)."""
    agents = scene["agents"]
    slots = hypes["train_params"].get("max_cav", 5)
    rng = hypes["preprocess"]["cav_lidar_range"]
    max_points = hypes["preprocess"]["args"]["max_points"]
    poses = [np.asarray(a["pose"], np.float64) for a in agents]
    keep = [0] + [i for i in range(1, len(agents))
                  if np.linalg.norm(poses[i][:2] - poses[0][:2])
                  <= hypes.get("comm_range", 70)]
    keep = keep[:slots]
    mask = np.zeros(slots, bool)
    mask[:len(keep)] = True
    pts = np.zeros((slots, max_points, 4), np.float32)
    pmask = np.zeros((slots, max_points), bool)
    for s, i in enumerate(keep):
        p = in_range(np.asarray(agents[i]["points"], np.float32), rng)
        if train and len(p) > max_points:
            p = p[np.random.choice(len(p), max_points, replace=False)]
        n = min(len(p), max_points)
        pts[s, :n], pmask[s, :n] = p[:n], True
    sample = {"agent_mask": mask,
              "pairwise_affine": pairwise_affine([poses[i] for i in keep],
                                                 slots, rng)}
    if not hypes.get("heter"):
        # one agent type: the model reads every slot's points
        sample["points"], sample["point_mask"] = pts, pmask
    setting = (hypes.get("heter") or {}).get("modality_setting") or {}
    kinds = [agents[i].get("modality", "m1") for i in keep]
    for m in sorted(setting):
        cap = int(setting[m].get("max_agents", slots))
        entries = [s for s, k in enumerate(kinds) if k == m][:cap]
        slot_of = np.full(cap, slots, np.int32)
        slot_of[:len(entries)] = entries
        sample[f"slots_{m}"] = slot_of
        if setting[m].get("sensor_type") == "camera":
            sample[f"inputs_{m}"] = cameras(scene, keep, entries, setting[m],
                                            cap)
            continue
        packed_pts = np.zeros((cap, max_points, 4), np.float32)
        packed_mask = np.zeros((cap, max_points), bool)
        for j, s in enumerate(entries):
            packed_pts[j], packed_mask[j] = pts[s], pmask[s]
        sample[f"inputs_{m}"] = {"points": packed_pts,
                                 "point_mask": packed_mask}
    if train:
        sample.update(labels.sample_labels(hypes, scene, keep, slots))
    return sample


def cameras(scene, keep, entries, setting, cap) -> dict:
    """A camera type's images and calibration, zero images and identity
    calibration in unused entries."""
    aug = setting["data_aug_conf"]
    ih, iw = aug["final_dim"]
    ncam = aug.get("Ncams", 4)
    out = {"imgs": np.zeros((cap, ncam, ih, iw, 3), np.float32),
           "intrins": np.tile(np.eye(3, dtype=np.float32), (cap, ncam, 1, 1)),
           "rots": np.tile(np.eye(3, dtype=np.float32), (cap, ncam, 1, 1)),
           "trans": np.zeros((cap, ncam, 3), np.float32)}
    for j, s in enumerate(entries):
        cams = scene["agents"][keep[s]]["cameras"]
        for k in out:
            out[k][j] = cams[k]
    return out


def collate(samples: list) -> dict:
    def stack(values):
        if isinstance(values[0], dict):
            return {k: stack([v[k] for v in values]) for k in values[0]}
        return np.stack(values)
    return stack(samples)


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    import torch

    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)
