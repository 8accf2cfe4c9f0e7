"""Scene -> fixed-shape samples for intermediate fusion (host side, numpy).

The port's copy of heal_tpu/data/scene.py: ``assemble`` takes a raw
scene (agent poses, lidar points, world-frame object boxes) to the
static-shape arrays the model consumes, with the same mask/padding
conventions:

  * agents padded to ``max_cav`` (slot 0 = ego), ``agent_mask`` marks real
    slots; per-modality packing uses flat ``slots_mX`` indices into the
    (B*L + 1) scatter space (last slot = dump for padding);
  * per-agent point clouds padded to ``max_points``, presorted by pillar;
  * GT boxes padded to ``max_num``;
  * camera agents (disk images or the synthetic rig) packed as images,
    calibration, depth-bin targets and the host-presorted splat plans
    (``_pack_cameras``); ``label_type: camera`` keeps the GT a camera rig
    can see.

The same scene (and numpy's global random state) gives the same arrays
as the JAX package, but for the synthetic rig's images: like JAX, they
are drawn from a seed of ``id(scene)``, a memory address, so they differ
between processes and packages (ROADMAP §3, known faults in the
reference). Camera agents of the disk backends carry their images
(``cameras_raw``), augmented and normalised here (``_disk_cameras``),
with their depth targets from the agent's own lidar. SECOND agents (m3)
get their points in their own order, by the encoder's full voxel key
(``_presort_voxel``). With ``kd_flag`` (DiscoNet's distillation) a
sample also carries the teacher's early-fusion view: every kept agent's
points moved into the ego frame (on the poses the warps use) and
merged, range-filtered, subsampled to ``max_points`` by
``np.random.choice`` (numpy's global random state, as JAX's) when
there are more, and padded into ``teacher_points`` /
``teacher_point_mask`` (not presorted). CenterPoint configs (``center_point*``) also get the anchor-free labels
``heatmap``, ``box_targets`` and ``reg_mask`` on the anchor grid. With
``box_align`` in the config and every agent carrying its stage-1
detections (``pred_centers``), the noisy poses are refined by CoAlign's
box alignment (utils/box_align.py) before the comm-range filter; the
labels stay on the clean poses.
"""
from __future__ import annotations

import numpy as np

from ..postprocess.anchors import generate_anchor_box
from ..postprocess.targets import generate_center_targets, generate_targets
from ..utils import box_np, transform_np
from ..utils import camera as cam_utils
from ..utils.box_align import box_alignment_relative
from ..utils.common_np import limit_period
from ..utils.pose_noise import add_pose_noise

MODALITY_KEYS = ("m1", "m2", "m3", "m4")


class IntermediateAssembler:
    """Heterogeneous intermediate-fusion sample assembly."""

    # one forward per agent sample (late fusion) rather than one a frame
    late = False
    # emits the per-agent ``*_single`` labels that ``supervise_single`` reads
    single_labels = True

    def __init__(self, params: dict, train: bool = True,
                 native_iou: bool = True):
        self.params = params
        self.train = train
        # anchor IoU of the labels: the native library's, or numpy's
        # (postprocess/targets.py)
        self.native_iou = native_iou
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
        # label_type 'camera': GT supervised only on objects a camera rig
        # can see, filtered by the ego's BEV visibility map
        self.label_type = params.get("label_type", "lidar")
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

        # CoAlign: the noisy poses refined from the agents' shared stage-1
        # detections (data/builder.py sets them from the pre-calc dump)
        if self.params.get("box_align") and all(
            "pred_centers" in a for a in agents
        ):
            refined = box_alignment_relative(
                [np.asarray(a["pred_centers"]) for a in agents],
                np.stack(poses),
                uncertainties=[a.get("pred_uncertainty") for a in agents]
                if all("pred_uncertainty" in a for a in agents) else None,
                **(self.params["box_align"].get("args", {}) or {}),
            )
            poses = [refined[i] for i in range(len(agents))]

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
        def vis_of(agent_idx):
            if self.label_type != "camera":
                return None
            return agents[agent_idx].get("bev_visibility")

        gt_ego, gt_mask = self._gt_in_frame(
            scene["objects"], clean_poses[0], self.gt_range,
            visibility_map=vis_of(keep[0]),
        )
        label = generate_targets(
            gt_ego, gt_mask, self.anchors, self.pos_thr, self.neg_thr,
            self.order, native_iou=self.native_iou,
        )
        core = self.params.get("model", {}).get("core_method", "")
        if core.startswith("center_point"):
            # anchor-free labels on the anchor grid: one cell a
            # feature-map pixel, vw * feature_stride metres wide
            aa = self.params["postprocess"]["anchor_args"]
            stride_m = aa["vw"] * aa.get("feature_stride", 2)
            label.update(generate_center_targets(
                gt_ego, gt_mask, self.anchors.shape[:2], self.cav_range,
                stride_m, self.order))

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
            **{k: label[k] for k in ("heatmap", "box_targets", "reg_mask")
               if k in label},
            "gt_boxes": gt_ego.astype(np.float32),
            "gt_mask": gt_mask.astype(np.float32),
            "transformation_matrix": np.eye(4, dtype=np.float32),
        }

        self._pack_modalities(sample, scene, keep, modality)

        if self.params.get("kd_flag"):
            self._teacher_view(sample, agents, keep, poses)

        if self.supervise_single:
            pos_s, neg_s, tgt_s = [], [], []
            for slot in range(L):
                if slot < n_valid:
                    gt_a, m_a = self._gt_in_frame(
                        scene["objects"], clean_poses[keep[slot]],
                        self.gt_range, visibility_map=vis_of(keep[slot]),
                    )
                    lab = generate_targets(
                        gt_a, m_a, self.anchors, self.pos_thr, self.neg_thr,
                        self.order, native_iou=self.native_iou,
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

    def _teacher_view(self, sample, agents, keep, poses):
        """DiscoNet's early-fusion teacher input: the kept agents' points
        in the ego frame, merged, range-filtered, subsampled and padded
        (ref intermediate_fusion_dataset's kd option)."""
        merged = []
        for i in keep:
            p = np.asarray(agents[i]["points"], dtype=np.float64)
            t = transform_np.x1_to_x2(poses[i], poses[0])
            xyz = (np.concatenate([p[:, :3], np.ones((len(p), 1))], axis=1)
                   @ t.T)[:, :3]
            merged.append(np.concatenate([xyz, p[:, 3:4]], axis=1)
                          .astype(np.float32))
        mp = self._range_filter(np.concatenate(merged, axis=0))
        if len(mp) > self.max_points:
            mp = mp[np.random.choice(len(mp), self.max_points, False)]
        tpts = np.zeros((self.max_points, 4), np.float32)
        tmask = np.zeros(self.max_points, bool)
        tpts[:len(mp)] = mp
        tmask[:len(mp)] = True
        sample["teacher_points"] = tpts
        sample["teacher_point_mask"] = tmask

    # ------------------------------------------------------------------
    def _pack_modalities(self, sample, scene, keep, modality):
        """Emit per-sample per-modality packed inputs + slot indices.

        slots_mX: (cap,) agent slot per packed entry (dump slot = L).
        Lidar modalities pack (points, point_mask); camera modalities pack
        (imgs, intrins, rots, trans, post_rots, post_trans, depth_bins)
        and the splat plans.
        """
        L = self.max_cav
        for m in self.modalities:
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
            if self.sensor_type(m) != "lidar":
                sample[f"inputs_{m}"] = self._pack_cameras(
                    scene, keep, entries, m, cap
                )
                continue
            # SECOND agents sort by the encoder's full voxel key at the
            # modality's voxel size (the encoder's ``presorted``), so their
            # points never alias the top-level arrays
            setting = self.modality_setting.get(m, {})
            second_vs = None
            if self.presort and setting.get("core_method") == "second":
                second_vs = (setting.get("preprocess", {}).get("args", {})
                             .get("voxel_size"))
            if (second_vs is None and cap == L
                    and entries == list(range(len(entries)))):
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
                if second_vs is not None:
                    n = int(msk[j].sum())
                    pts[j, :n] = self._presort_voxel(pts[j, :n], second_vs)
            sample[f"inputs_{m}"] = {"points": pts, "point_mask": msk}

    def _pack_cameras(self, scene, keep, entries, m, L):
        """Assemble fixed-shape camera arrays for modality m."""
        setting = self.modality_setting[m]
        aug = setting["data_aug_conf"]
        ih, iw = aug["final_dim"]
        ncam = aug.get("Ncams", 4)
        gc = setting["grid_conf"]
        d_min, d_max, n_bins = gc["ddiscr"]
        ds = setting.get("img_downsample", 16)
        fh, fw = ih // ds, iw // ds

        depth_vals = cam_utils.depth_discretization(
            d_min, d_max, n_bins, gc["mode"]
        )
        _, _, g_nx = cam_utils.gen_dx_bx(
            gc["xbound"], gc["ybound"], gc["zbound"]
        )
        cells = int(g_nx[0]) * int(g_nx[1])
        n_pts = ncam * fh * fw * n_bins
        out = {
            "imgs": np.zeros((L, ncam, ih, iw, 3), np.float32),
            "intrins": np.tile(np.eye(3, dtype=np.float32), (L, ncam, 1, 1)),
            "rots": np.tile(np.eye(3, dtype=np.float32), (L, ncam, 1, 1)),
            "trans": np.zeros((L, ncam, 3), np.float32),
            "post_rots": np.tile(np.eye(3, dtype=np.float32), (L, ncam, 1, 1)),
            "post_trans": np.zeros((L, ncam, 3), np.float32),
            "depth_bins": np.full((L, ncam, fh, fw), n_bins, np.int32),
            # host-presorted splat plans (utils/camera): the port's splat
            # reduces the flat plan (splat_ids, splat_widx); the W-matrix
            # plan (splat_cell, splat_dperm) is JAX's sum-pool form, kept
            # so that the batch is JAX's. Padded agent slots keep every
            # point on the dump cell
            "splat_ids": np.full((L, n_pts), cells, np.int32),
            "splat_widx": np.zeros((L, n_pts), np.int32),
            "splat_cell": np.full(
                (L, ncam * fh * fw, n_bins), cells, np.int32
            ),
            "splat_dperm": np.tile(
                np.arange(n_bins, dtype=np.int32),
                (L, ncam * fh * fw, 1),
            ),
        }
        for j, slot in enumerate(entries):
            agent = scene["agents"][keep[slot]]
            cams = agent.get("cameras")
            if cams is None and agent.get("cameras_raw") is not None:
                cams = self._disk_cameras(agent["cameras_raw"], aug, m, ncam)
            if cams is None:
                # synthesize a rig: structured noise images + exact calib,
                # depth maps rendered from the agent's own lidar geometry.
                # The seed is JAX's formula: id(scene) is an address, so
                # the images differ between runs and between packages
                rng = np.random.default_rng(
                    abs(hash((id(scene) % 997, slot))) % (2**31)
                )
                rig = cam_utils.default_camera_rig(ncam)
                K = cam_utils.default_intrinsics(ih, iw)
                imgs, intr, rots, trans = [], [], [], []
                for rot, tr in rig:
                    imgs.append(
                        rng.normal(0.45, 0.2, (ih, iw, 3)).astype(np.float32)
                    )
                    intr.append(K)
                    rots.append(rot)
                    trans.append(tr)
                cams = {
                    "imgs": np.stack(imgs),
                    "intrins": np.stack(intr).astype(np.float32),
                    "rots": np.stack(rots).astype(np.float32),
                    "trans": np.stack(trans).astype(np.float32),
                }
            for key in ("imgs", "intrins", "rots", "trans"):
                out[key][j] = cams[key]
            if "post_rots" in cams:
                out["post_rots"][j] = cams["post_rots"]
                out["post_trans"][j] = cams["post_trans"]
            # splat plans from the FINAL calibration (aug folded in)
            out["splat_ids"][j], out["splat_widx"][j] = (
                cam_utils.frustum_splat_plan(
                    out["rots"][j], out["trans"][j], out["intrins"][j],
                    out["post_rots"][j], out["post_trans"][j],
                    depth_vals, ih, iw, ds, gc,
                )
            )
            out["splat_cell"][j], out["splat_dperm"][j] = (
                cam_utils.frustum_splat_matrix_plan(
                    out["rots"][j], out["trans"][j], out["intrins"][j],
                    out["post_rots"][j], out["post_trans"][j],
                    depth_vals, ih, iw, ds, gc,
                    flat_plan=(out["splat_ids"][j], out["splat_widx"][j]),
                )
            )
            # depth supervision from the agent's (simulated or real) lidar,
            # rendered in FINAL image pixels: fold the aug homography into
            # the intrinsics (u' = post_rot[:2,:2] @ u + post_tran[:2])
            pts = np.asarray(agent.get("points"), np.float32)
            if pts is not None and len(pts):
                for ci in range(ncam):
                    P = np.asarray(out["post_rots"][j, ci], np.float64).copy()
                    P[:2, 2] += np.asarray(
                        out["post_trans"][j, ci], np.float64
                    )[:2]
                    k_eff = P @ np.asarray(
                        out["intrins"][j, ci], np.float64
                    )
                    depth = cam_utils.render_depth_map(
                        pts,
                        out["rots"][j, ci],
                        out["trans"][j, ci],
                        k_eff,
                        ih,
                        iw,
                        ds,
                    )
                    bins, mask = cam_utils.bin_depths(
                        np.where(depth > 0, depth, np.nan),
                        gc["mode"],
                        d_min,
                        d_max,
                        n_bins,
                        target=True,
                    )
                    out["depth_bins"][j, ci] = bins
        return out

    def _disk_cameras(self, raw: dict, aug: dict, m: str, ncam: int):
        """Images read from disk (the backend's ``cameras_raw``): each
        camera's resize / crop / flip / rotate policy applied with its
        pixel homography, then normalised; the calibration padded with
        identities to ``ncam`` cameras."""
        need = ("H", "W", "bot_pct_lim") + (("resize_lim",) if self.train
                                            else ())
        missing = [k for k in need if k not in aug]
        if missing:
            # the JAX package stops at a bare KeyError on the first one
            raise ValueError(
                f"heter.modality_setting.{m}.data_aug_conf lacks "
                f"{missing}: camera images from disk need the original "
                "image size (H, W) and the crop policy; the published "
                "configs give only final_dim, cams and Ncams (ROADMAP §3)")
        ih, iw = aug["final_dim"]
        n_real = min(len(raw["imgs"]), ncam)
        imgs = np.zeros((ncam, ih, iw, 3), np.float32)
        post_rots = np.tile(np.eye(3, dtype=np.float32), (ncam, 1, 1))
        post_trans = np.zeros((ncam, 3), np.float32)
        for ci in range(n_real):
            policy = cam_utils.sample_augmentation(aug, self.train)
            img_t, pr, pt = cam_utils.img_transform(raw["imgs"][ci],
                                                    *policy[1:])
            imgs[ci] = cam_utils.normalize_img(img_t)
            post_rots[ci] = pr.astype(np.float32)
            post_trans[ci] = pt.astype(np.float32)
        cams = {
            "imgs": imgs,
            "intrins": np.asarray(raw["intrins"], np.float32)[:ncam],
            "rots": np.asarray(raw["rots"], np.float32)[:ncam],
            "trans": np.asarray(raw["trans"], np.float32)[:ncam],
            "post_rots": post_rots,
            "post_trans": post_trans,
        }
        # a rig of fewer than ncam cameras: identity calibration pads it
        for key in ("intrins", "rots"):
            if len(cams[key]) < ncam:
                pad = np.tile(np.eye(3, dtype=np.float32),
                              (ncam - len(cams[key]), 1, 1))
                cams[key] = np.concatenate([cams[key], pad])
        if len(cams["trans"]) < ncam:
            cams["trans"] = np.concatenate(
                [cams["trans"],
                 np.zeros((ncam - len(cams["trans"]), 3), np.float32)])
        return cams

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

    def _presort_voxel(self, points: np.ndarray, voxel_size) -> np.ndarray:
        """Order points by the SECOND engine's full voxel key
        ((y*nx + x) * nz + z at ``voxel_size``) on the host, so that the
        encoder (``presorted``) skips its device sort. Out-of-range points
        sort last under INT32_MAX, the engine's INVALID."""
        if len(points) == 0:
            return points
        vx, vy, vz = voxel_size
        r = self.cav_range
        nx = int(round((r[3] - r[0]) / vx))
        ny = int(round((r[4] - r[1]) / vy))
        nz = int(round((r[5] - r[2]) / vz))
        xi = np.floor((points[:, 0] - r[0]) / vx).astype(np.int64)
        yi = np.floor((points[:, 1] - r[1]) / vy).astype(np.int64)
        zi = np.floor((points[:, 2] - r[2]) / vz).astype(np.int64)
        ok = ((xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
              & (zi >= 0) & (zi < nz))
        key = np.where(ok, (yi * nx + xi) * nz + zi, np.int64(2**31 - 1))
        return points[np.argsort(key, kind="stable")]

    def _gt_in_frame(self, objects_world, pose, limit_range,
                     visibility_map=None):
        """World lwh boxes -> padded hwl boxes in the given agent frame.

        visibility_map: optional (256, 256) ego BEV visibility raster
        (label_type 'camera'): objects whose center falls on a zero cell
        are dropped before the range mask.
        """
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
        if visibility_map is not None:
            boxes = boxes[box_np.camera_visible_mask(boxes, visibility_map)]
            if len(boxes) == 0:
                return out, mask
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
    batch-major (B, ...) arrays. Late fusion's test-time
    ``agent_samples`` stay a list (one list of sample dicts a sample),
    which the device copies (parallel.to_device, pin) leave on the
    host."""
    memo: dict = {}
    return {k: [s[k] for s in samples] if k == "agent_samples"
            else _stack([s[k] for s in samples], memo) for k in samples[0]}
