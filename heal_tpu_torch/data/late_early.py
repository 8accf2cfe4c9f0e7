"""Late- and early-fusion sample assembly (host, numpy).

The port's copy of heal_tpu/data/late_early.py (the reference's
late_fusion_dataset.py and early_fusion_dataset.py):

  * ``LateAssembler``: every agent is an independent single-agent
    sample. Train takes one random agent (``np.random.randint``, numpy's
    global state, as JAX draws it) in its own frame with its own labels;
    test takes the ego's sample and, in ``agent_samples``, one sample per
    other agent in communication range with its ``transformation_matrix``
    to the ego, whose detections are projected and merged by one
    cross-agent NMS (tools/inference.py). With a ``heter`` section each
    sample carries every agent type's inputs (zeros for the types it is
    not) and a one-hot ``modality_flags``;
  * ``EarlyAssembler``: the points of every agent in range projected into
    the ego frame and merged before one voxelization; train subsamples
    past ``max_points`` with ``np.random.choice``, test keeps the first
    ``max_points`` of the ego-first concatenation (ROADMAP §3).

Both augment in train mode with the config's ``data_augment``
(data/augmentor.py), seeded from the OS as JAX seeds it (ROADMAP §3), and
presort points by the 2-D pillar key whatever the encoder (a SECOND
encoder with ``presorted: true`` then merges voxels, as in JAX; ROADMAP
§3).
"""
from __future__ import annotations

import numpy as np

from ..postprocess.targets import generate_targets
from ..utils import transform_np
from .augmentor import DataAugmentor
from .scene import IntermediateAssembler


def _maybe_augment(assembler, points, gt_hwl, gt_mask):
    """Joint point / box augmentation (train only, as the reference)."""
    aug_cfg = assembler.params.get("data_augment")
    if not aug_cfg or not assembler.train:
        return points, gt_hwl
    n = int(gt_mask.sum())
    boxes_lwh = gt_hwl[:n][:, [0, 1, 2, 5, 4, 3, 6]].copy()
    points, boxes_lwh = DataAugmentor(aug_cfg)(points, boxes_lwh)
    out = gt_hwl.copy()
    out[:n] = boxes_lwh[:, [0, 1, 2, 5, 4, 3, 6]]
    return points, out


class LateAssembler(IntermediateAssembler):
    """Late fusion: each agent is an independent single-agent sample."""

    late = True
    single_labels = False

    def assemble(self, scene: dict) -> dict:
        agents = scene["agents"]
        clean_poses = [np.asarray(a["pose"], dtype=np.float64) for a in agents]
        if self.train:
            idx = int(np.random.randint(len(agents)))
            return self._single_sample(scene, idx, clean_poses, np.eye(4))
        sample = self._single_sample(scene, 0, clean_poses, np.eye(4))
        others = []
        for i in range(1, len(agents)):
            d = np.linalg.norm(clean_poses[i][:2] - clean_poses[0][:2])
            if d > self.comm_range:
                continue
            t = transform_np.x1_to_x2(clean_poses[i], clean_poses[0])
            others.append(self._single_sample(scene, i, clean_poses, t))
        sample["agent_samples"] = others
        return sample

    def _single_sample(self, scene, idx, poses, t_to_ego):
        agent = scene["agents"][idx]
        pts = self._range_filter(
            np.asarray(agent["points"], dtype=np.float32)
        )
        gt, gt_mask = self._gt_in_frame(
            scene["objects"], poses[idx], self.gt_range
        )
        pts, gt = _maybe_augment(self, pts, gt, gt_mask)
        pts = self._range_filter(pts)
        n = min(len(pts), self.max_points)
        points = np.zeros((self.max_points, 4), dtype=np.float32)
        pmask = np.zeros(self.max_points, dtype=bool)
        # presort after truncation: a presorted encoder reads the ids as
        # sorted, so every packing site sorts
        points[:n] = self._presort(pts[:n])
        pmask[:n] = True
        label = generate_targets(
            gt, gt_mask, self.anchors, self.pos_thr, self.neg_thr, self.order,
            native_iou=self.native_iou,
        )
        # the evaluation GT is the ego's, in the ego frame
        gt_ego, gt_ego_mask = self._gt_in_frame(
            scene["objects"], poses[0], self.gt_range
        )
        sample = {
            "points": points,
            "point_mask": pmask,
            "pos_equal_one": label["pos_equal_one"],
            "neg_equal_one": label["neg_equal_one"],
            "targets": label["targets"],
            "gt_boxes": gt_ego.astype(np.float32),
            "gt_mask": gt_ego_mask.astype(np.float32),
            "transformation_matrix": t_to_ego.astype(np.float32),
        }
        if self.params.get("heter"):
            self._pack_heter_single(sample, scene, idx, agent)
        return sample

    def _pack_heter_single(self, sample, scene, idx, agent):
        """Late-heter packing: every type's inputs (zeros where the agent
        is another type) and the one-hot ``modality_flags``, so that mixed
        batches keep one shape."""
        mod = agent.get("modality", "m1")
        flags = np.zeros(len(self.modalities), np.float32)
        for k, m in enumerate(self.modalities):
            active = m == mod
            if active:
                flags[k] = 1.0
            if self.sensor_type(m) == "lidar":
                pick = (lambda x: x) if active else np.zeros_like
                sample[f"inputs_{m}"] = {
                    "points": pick(sample["points"]),
                    "point_mask": pick(sample["point_mask"]),
                }
            else:
                if active:
                    cams = self._pack_cameras(scene, [idx], [0], m, 1)
                else:
                    cams = self._pack_cameras(scene, [], [], m, 1)
                sample[f"inputs_{m}"] = {k: v[0] for k, v in cams.items()}
        sample["modality_flags"] = flags


class EarlyAssembler(IntermediateAssembler):
    """Early fusion: every in-range agent's points in the ego frame,
    merged before a single voxelization."""

    single_labels = False

    def assemble(self, scene: dict) -> dict:
        agents = scene["agents"]
        clean_poses = [np.asarray(a["pose"], dtype=np.float64) for a in agents]
        merged = []
        for i, agent in enumerate(agents):
            d = np.linalg.norm(clean_poses[i][:2] - clean_poses[0][:2])
            if i > 0 and d > self.comm_range:
                continue
            pts = np.asarray(agent["points"], dtype=np.float64)
            t = transform_np.x1_to_x2(clean_poses[i], clean_poses[0])
            xyz = (
                np.concatenate([pts[:, :3], np.ones((len(pts), 1))], axis=1)
                @ t.T
            )[:, :3]
            merged.append(
                np.concatenate([xyz, pts[:, 3:4]], axis=1).astype(np.float32)
            )
        pts = self._range_filter(np.concatenate(merged, axis=0))
        gt, gt_mask = self._gt_in_frame(
            scene["objects"], clean_poses[0], self.gt_range
        )
        pts, gt = _maybe_augment(self, pts, gt, gt_mask)
        pts = self._range_filter(pts)
        if self.train and len(pts) > self.max_points:
            sel = np.random.choice(len(pts), self.max_points, replace=False)
            pts = pts[sel]
        n = min(len(pts), self.max_points)
        points = np.zeros((self.max_points, 4), dtype=np.float32)
        pmask = np.zeros(self.max_points, dtype=bool)
        points[:n] = self._presort(pts[:n])
        pmask[:n] = True
        label = generate_targets(
            gt, gt_mask, self.anchors, self.pos_thr, self.neg_thr, self.order,
            native_iou=self.native_iou,
        )
        return {
            "points": points,
            "point_mask": pmask,
            "pos_equal_one": label["pos_equal_one"],
            "neg_equal_one": label["neg_equal_one"],
            "targets": label["targets"],
            "gt_boxes": gt.astype(np.float32),
            "gt_mask": gt_mask.astype(np.float32),
            "transformation_matrix": np.eye(4, dtype=np.float32),
        }
