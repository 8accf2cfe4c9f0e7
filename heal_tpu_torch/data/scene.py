"""Scene -> fixed-shape samples for intermediate fusion (host side, numpy).

The port's copy of heal_tpu/data/scene.py, lidar path: ``assemble``
takes a raw scene (agent poses, lidar points, world-frame object boxes)
to the static-shape arrays the model consumes, with the same
mask/padding conventions:

  * agents padded to ``max_cav`` (slot 0 = ego), ``agent_mask`` marks real
    slots; per-modality packing uses flat ``slots_mX`` indices into the
    (B*L + 1) scatter space (last slot = dump for padding);
  * per-agent point clouds padded to ``max_points``, presorted by pillar;
  * GT boxes padded to ``max_num``.

The same scene (and numpy's global random state) gives the same arrays
as the JAX package. Branches the slice does not run raise
NotImplementedError and name the ROADMAP item (queue 1) that ports them:
camera modalities and camera labels (item 10), SECOND voxel presort
(item 11), CoAlign box alignment (item 9), CenterPoint targets and the
distillation teacher view (item 13).
"""
from __future__ import annotations

import numpy as np

from ..postprocess.anchors import generate_anchor_box
from ..postprocess.targets import generate_targets
from ..utils import box_np, transform_np
from ..utils.common_np import limit_period
from ..utils.pose_noise import add_pose_noise

MODALITY_KEYS = ("m1", "m2", "m3", "m4")


class IntermediateAssembler:
    """Heterogeneous intermediate-fusion sample assembly (lidar agents)."""

    def __init__(self, params: dict, train: bool = True):
        self.params = params
        self.train = train
        post = params["postprocess"]
        self.order = post["order"]
        self.anchors = generate_anchor_box(post["anchor_args"], self.order)
        self.pos_thr = post["target_args"]["pos_threshold"]
        self.neg_thr = post["target_args"]["neg_threshold"]
        self.max_num = post.get("max_num", 100)
        self.max_cav = params["train_params"].get("max_cav", 5)
        self.comm_range = params.get("comm_range", 70)
        self.gt_range = post.get(
            "gt_range", post["anchor_args"]["cav_lidar_range"]
        )
        self.cav_range = params["preprocess"]["cav_lidar_range"]
        self.max_points = params["preprocess"]["args"].get(
            "max_points", 30000
        )
        self.voxel_size = params["preprocess"]["args"].get(
            "voxel_size", [0.4, 0.4, 4]
        )
        self.presort = params["preprocess"]["args"].get("presort", True)
        self.supervise_single = params.get("model", {}).get("args", {}).get(
            "supervise_single", False
        )
        self.noise_setting = params.get("noise_setting", {"add_noise": False})
        heter = params.get("heter")
        self.modalities = (
            sorted(heter["modality_setting"].keys()) if heter else ["m1"]
        )
        self.modality_setting = (heter or {}).get("modality_setting", {})
        # static per-modality agent capacity (heter.modality_setting.mX.
        # max_agents), max_cav by default; agents of a modality beyond it
        # are dropped like agents beyond comm range
        self.modality_cap = {
            m: int(self.modality_setting.get(m, {}).get(
                "max_agents", self.max_cav
            ))
            for m in self.modalities
        }
        if params.get("label_type", "lidar") == "camera":
            raise NotImplementedError(
                "label_type 'camera' (camera-visible GT) is not ported: "
                "ROADMAP queue 1, item 10 (m2 camera)"
            )
        if params.get("kd_flag"):
            raise NotImplementedError(
                "kd_flag (the early-fusion teacher view) is not ported: "
                "ROADMAP queue 1, item 13 (tools/train_w_kd.py)"
            )
        for m in self.modalities:
            setting = self.modality_setting.get(m, {})
            if self.presort and setting.get("core_method") == "second":
                raise NotImplementedError(
                    f"modality {m}: the SECOND voxel presort is not ported: "
                    "ROADMAP queue 1, item 11 (m3 SECOND)"
                )

    def sensor_type(self, modality: str) -> str:
        return self.modality_setting.get(modality, {}).get(
            "sensor_type", "lidar"
        )

    # ------------------------------------------------------------------
    def assemble(self, scene: dict) -> dict:
        """scene: {'agents': [{'pose', 'modality', 'points' (N,4)}...],
        'objects': (K, 7) world-frame lwh boxes}. Agent 0 is the ego.

        Returns a dict of numpy arrays for ONE sample (unbatched).
        """
        agents = scene["agents"]
        clean_poses = [np.asarray(a["pose"], dtype=np.float64) for a in agents]
        # noisy poses drive the feature warps; labels stay on clean poses
        if self.noise_setting.get("add_noise", False):
            poses = add_pose_noise(clean_poses, self.noise_setting["args"])
        else:
            poses = clean_poses

        if self.params.get("box_align") and all(
            "pred_centers" in a for a in agents
        ):
            raise NotImplementedError(
                "CoAlign box alignment is not ported: ROADMAP queue 1, "
                "item 9 (pose_graph_pre_calc, utils/box_align.py)"
            )

        # comm-range + modality filters w.r.t. ego, ego first, cap at max_cav
        heter = self.params.get("heter") or {}
        allowed = heter.get("allowed_modalities")
        keep = [0]
        for i in range(1, len(agents)):
            d = np.linalg.norm(poses[i][:2] - poses[0][:2])
            if d > self.comm_range:
                continue
            if allowed and agents[i].get("modality", "m1") not in allowed:
                continue
            keep.append(i)
        # agents-added-in-order eval: only the FIRST use_cav agents
        # collaborate while GT still comes from the whole scene
        use_cav = heter.get("use_cav")
        cap = min(self.max_cav, use_cav) if use_cav else self.max_cav
        keep = keep[:cap]

        L = self.max_cav
        n_valid = len(keep)
        agent_mask = np.zeros(L, dtype=bool)
        agent_mask[:n_valid] = True
        modality = [agents[i].get("modality", "m1") for i in keep]

        pairwise = transform_np.get_pairwise_transformation(
            [poses[i] for i in keep], L
        )
        # metric normalization (H, W in meters, voxel size 1) makes the
        # affine resolution-independent
        metric_h = self.cav_range[4] - self.cav_range[1]
        metric_w = self.cav_range[3] - self.cav_range[0]
        pairwise_affine = transform_np.normalize_pairwise_tfm(
            pairwise, metric_h, metric_w, 1.0
        )

        # per-agent padded points (own frame)
        pts = np.zeros((L, self.max_points, 4), dtype=np.float32)
        pmask = np.zeros((L, self.max_points), dtype=bool)
        for slot, i in enumerate(keep):
            p = np.asarray(agents[i]["points"], dtype=np.float32)
            p = self._range_filter(p)
            n = min(len(p), self.max_points)
            if self.train and len(p) > self.max_points:
                sel = np.random.choice(len(p), self.max_points, replace=False)
                p = p[sel]
            pts[slot, :n] = self._presort(p[:n])
            pmask[slot, :n] = True

        # fused labels in (clean) ego frame
        gt_ego, gt_mask = self._gt_in_frame(
            scene["objects"], clean_poses[0], self.gt_range
        )
        label = generate_targets(
            gt_ego, gt_mask, self.anchors, self.pos_thr, self.neg_thr,
            self.order,
        )
        core = self.params.get("model", {}).get("core_method", "")
        if core.startswith("center_point"):
            raise NotImplementedError(
                "CenterPoint targets are not ported: ROADMAP queue 1, "
                "item 13 (center_point)"
            )

        sample = {
            # agents in comm range but beyond a per-modality packing
            # capacity (see _pack_modalities)
            "dropped_agent_count": np.int32(0),
            "agent_mask": agent_mask,
            "agent_modality": np.array(
                [MODALITY_KEYS.index(m) for m in modality]
                + [len(MODALITY_KEYS)] * (L - n_valid),
                dtype=np.int32,
            ),
            "points": pts,
            "point_mask": pmask,
            "pairwise_t_matrix": pairwise.astype(np.float32),
            "pairwise_affine": pairwise_affine.astype(np.float32),
            "pos_equal_one": label["pos_equal_one"],
            "neg_equal_one": label["neg_equal_one"],
            "targets": label["targets"],
            "gt_boxes": gt_ego.astype(np.float32),
            "gt_mask": gt_mask.astype(np.float32),
            "transformation_matrix": np.eye(4, dtype=np.float32),
        }

        self._pack_modalities(sample, keep, modality)

        if self.supervise_single:
            pos_s, neg_s, tgt_s = [], [], []
            for slot in range(L):
                if slot < n_valid:
                    gt_a, m_a = self._gt_in_frame(
                        scene["objects"], clean_poses[keep[slot]],
                        self.gt_range,
                    )
                    lab = generate_targets(
                        gt_a, m_a, self.anchors, self.pos_thr, self.neg_thr,
                        self.order,
                    )
                    pos_s.append(lab["pos_equal_one"])
                    neg_s.append(lab["neg_equal_one"])
                    tgt_s.append(lab["targets"])
                else:
                    # padded slot: zero pos AND zero neg -> zero loss weight
                    pos_s.append(np.zeros_like(label["pos_equal_one"]))
                    neg_s.append(np.zeros_like(label["neg_equal_one"]))
                    tgt_s.append(np.zeros_like(label["targets"]))
            sample["pos_equal_one_single"] = np.stack(pos_s)
            sample["neg_equal_one_single"] = np.stack(neg_s)
            sample["targets_single"] = np.stack(tgt_s)
        return sample

    # ------------------------------------------------------------------
    def _pack_modalities(self, sample, keep, modality):
        """Emit per-sample per-modality packed inputs + slot indices.

        slots_mX: (cap,) agent slot per packed entry (dump slot = L);
        inputs_mX: (points, point_mask) of those agents.
        """
        L = self.max_cav
        for m in self.modalities:
            if self.sensor_type(m) != "lidar":
                raise NotImplementedError(
                    f"modality {m}: camera inputs are not ported: ROADMAP "
                    "queue 1, item 10 (m2 camera, utils/camera.py)"
                )
            cap = self.modality_cap[m]
            slots = np.full(cap, L, dtype=np.int32)
            all_entries = [
                slot for slot, _ in enumerate(keep) if modality[slot] == m
            ]
            entries = all_entries[:cap]
            # agents beyond the modality capacity leave the collaboration
            # entirely; counted so that none is lost silently
            for slot in all_entries[cap:]:
                sample["agent_mask"][slot] = False
                sample["dropped_agent_count"] += np.int32(1)
            for j, slot in enumerate(entries):
                slots[j] = slot
            sample[f"slots_{m}"] = slots
            if cap == L and entries == list(range(len(entries))):
                # identity packing (single-modality case): ALIAS the
                # top-level arrays; collate stacks them once per batch
                sample[f"inputs_{m}"] = {
                    "points": sample["points"],
                    "point_mask": sample["point_mask"],
                }
                continue
            pts = np.zeros((cap,) + sample["points"].shape[1:], np.float32)
            msk = np.zeros((cap,) + sample["point_mask"].shape[1:], bool)
            for j, slot in enumerate(entries):
                pts[j] = sample["points"][slot]
                msk[j] = sample["point_mask"][slot]
            sample[f"inputs_{m}"] = {"points": pts, "point_mask": msk}

    def _range_filter(self, points: np.ndarray) -> np.ndarray:
        r = self.cav_range
        m = (
            (points[:, 0] >= r[0])
            & (points[:, 0] <= r[3])
            & (points[:, 1] >= r[1])
            & (points[:, 1] <= r[4])
            & (points[:, 2] >= r[2])
            & (points[:, 2] <= r[5])
        )
        return points[m]

    def _presort(self, points: np.ndarray) -> np.ndarray:
        """Order an agent's points by BEV pillar id on the host, so that
        the pillar encoder (``presorted``) skips its device sort.
        Out-of-range points sort last, matching the drop-bucket id the
        device assigns them."""
        if not self.presort or len(points) == 0:
            return points
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        r = self.cav_range
        nx = int(round((r[3] - r[0]) / vx))
        ny = int(round((r[4] - r[1]) / vy))
        xi = np.floor((points[:, 0] - r[0]) / vx).astype(np.int64)
        yi = np.floor((points[:, 1] - r[1]) / vy).astype(np.int64)
        ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
        ids = np.where(ok, yi * nx + xi, nx * ny)
        return points[np.argsort(ids, kind="stable")]

    def _gt_in_frame(self, objects_world, pose, limit_range):
        """World lwh boxes -> padded hwl boxes in the given agent frame."""
        out = np.zeros((self.max_num, 7), dtype=np.float64)
        mask = np.zeros(self.max_num, dtype=np.float64)
        if objects_world is None or len(objects_world) == 0:
            return out, mask
        objs = np.asarray(objects_world, dtype=np.float64)
        t = np.linalg.inv(transform_np.x_to_world(pose))
        centers = box_np.project_points(objs[:, :3], t)
        # rotate yaw by the frame change (assume near-planar transforms)
        dyaw = np.arctan2(t[1, 0], t[0, 0])
        boxes = np.concatenate(
            [centers, objs[:, 3:6], limit_period(objs[:, 6:7] + dyaw)], axis=1
        )
        _, m = box_np.mask_boxes_outside_range(
            boxes, limit_range, "lwh", min_num_corners=1, return_mask=True
        )
        boxes = boxes[m][: self.max_num]
        n = len(boxes)
        # to hwl order for the label pipeline
        out[:n] = boxes[:, [0, 1, 2, 5, 4, 3, 6]]
        mask[:n] = 1.0
        return out, mask


def _stack(values, memo=None):
    if isinstance(values[0], dict):
        return {k: _stack([v[k] for v in values], memo) for k in values[0]}
    if memo is None:
        return np.stack(values)
    # aliased per-sample arrays (identity modality packing) stack once
    key = tuple(id(v) for v in values)
    if key not in memo:
        memo[key] = np.stack(values)
    return memo[key]


def collate(samples: list) -> dict:
    """Stack samples (including nested per-modality input dicts) into
    batch-major (B, ...) arrays."""
    memo: dict = {}
    return {k: _stack([s[k] for s in samples], memo) for k in samples[0]}
