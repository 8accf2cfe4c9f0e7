"""FPV-RCNN (torch): the two-stage collaborative detector.

Counterpart of heal_tpu/models/fpvrcnn.py. Stage 1 is CIA-SSD on every
agent slot (``encoder``: SECOND on the column engine, ``input_proj``,
``ssfa``, ``heads`` with the IoU branch); its outputs are also the
``*_single`` outputs. Stage 2, without gradient through its choices (JAX
wraps them in ``stop_gradient``; the reference's matcher is no_grad):
  * each agent's top ``stage2.proposals_per_agent`` (16) anchors by
    sigmoid(cls) times the rectified IoU ((iou + 1) / 2, clipped), taken
    by a stable descending sort (``lax.top_k`` keeps the lower index
    among equal scores), decoded against their anchors; valid above
    ``stage2.score_threshold`` (0.15);
  * ``KeypointEncoder`` (``kp_encoder``): ``stage2.num_keypoints`` (512)
    farthest-point samples of each agent's points (all agents in one FPS
    loop), a set abstraction of the raw points around them (ball query
    0.8 m, 16 neighbours, ``sa_mlp`` 32 / 32) and the SSFA map sampled
    bilinearly under them, joined and projected (``proj``, 128);
  * proposals and keypoints moved to the ego frame by
    ``pairwise_t_matrix[:, j, 0]`` (agent j -> ego), padded agents'
    scores zeroed, and each frame's proposals fused by
    ``fuse_proposals`` (the matcher's Algorithm 1, fixed shape);
  * ``RoIGridHead`` (``roi_head``): ``grid_size``^3 (4^3) points in each
    fused RoI, each pooling its ball-query neighbours among the frame's
    keypoints (1.6 m, 8, ``pool_mlp`` 64 / 64), then ``fc_0`` / ``fc_1``
    (256) and the ``cls`` (quality logit) and ``reg`` (roi-frame
    residual) layers.
Outputs add ``boxes_fused``, ``scores_fused``, ``valid_fused``,
``rcnn_cls``, ``rcnn_reg`` (losses/fpvrcnn_loss.py,
postprocess/decode.decode_stage2). No kernel runs on this path: it
moves boxes and keypoints, not maps. Names are flax's (the modules of
JAX's ``setup``), so heal_tpu variables bridge strictly.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from ..ops import geometry
from ..ops.nms import nms_rotated_fixed
from ..ops.pointnet import ball_query, farthest_point_sample, group_and_pool
from ..postprocess.anchors import generate_anchor_box
from ..utils.rotated_iou import box2d_to_corners, rotated_iou_matrix
from .ciassd import SSFA, second_encoder
from .heads import DetectionHeads
from .layers import ConvNormAct, Dense
from .registry import register_model


def transform_boxes(boxes: torch.Tensor, tfm: torch.Tensor) -> torch.Tensor:
    """Rigid-transform (..., P, 7) hwl boxes by (..., 4, 4) matrices."""
    center = (boxes[..., :3] @ tfm[..., :3, :3].transpose(-1, -2)
              + tfm[..., None, :3, 3])
    dyaw = torch.atan2(tfm[..., 1, 0], tfm[..., 0, 0])
    return torch.cat([center, boxes[..., 3:6],
                      boxes[..., 6:7] + dyaw[..., None, None]], dim=-1)


class PointMLP(nn.Module):
    """Per-point shared MLP: ``Dense_{i}`` + ReLU over the channel axis,
    computed in the weights' dtype."""

    def __init__(self, cin: int, features: tuple):
        super().__init__()
        for i, f in enumerate(features):
            setattr(self, f"Dense_{i}", Dense(cin, f))
            cin = f
        self.num_layers = len(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.Dense_0.kernel.dtype)
        for i in range(self.num_layers):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return x


class KeypointEncoder(nn.Module):
    """points (B, N, 4) + mask + the SSFA map (B, h, w, C) NHWC ->
    (keypoints (B, K, 3), features (B, K, 4 * sa_features[-1]), mask
    (B, K))."""

    def __init__(self, bev_channels: int, num_keypoints: int = 512,
                 sa_radius: float = 0.8, sa_nsample: int = 16,
                 sa_features: tuple = (32, 32), bev_stride: float = 0.8):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.sa_radius = sa_radius
        self.sa_nsample = sa_nsample
        self.bev_stride = bev_stride
        self.sa_mlp = PointMLP(4, sa_features)
        self.out_channels = sa_features[-1] * 4
        self.proj = Dense(sa_features[-1] + bev_channels, self.out_channels)

    def forward(self, points, mask, bev, lidar_range):
        xyz = points[..., :3]
        kp_idx = farthest_point_sample(xyz, mask, self.num_keypoints).long()
        kp = torch.gather(xyz, 1, kp_idx[..., None].expand(-1, -1, 3))
        kp_mask = torch.gather(mask, 1, kp_idx)
        idx, valid = ball_query(kp, xyz, mask, self.sa_radius,
                                self.sa_nsample)
        sa = group_and_pool(kp, xyz, points[..., 3:4], idx, valid,
                            self.sa_mlp)
        # the BEV map sampled bilinearly at the keypoints' xy
        b, h, w, _ = bev.shape
        u = (kp[..., 0] - lidar_range[0]) / self.bev_stride - 0.5
        v = (kp[..., 1] - lidar_range[1]) / self.bev_stride - 0.5
        ui = torch.clamp(torch.floor(u).to(torch.int64), 0, w - 2)
        vi = torch.clamp(torch.floor(v).to(torch.int64), 0, h - 2)
        fu = torch.clamp(u - ui, 0.0, 1.0)[..., None]
        fv = torch.clamp(v - vi, 0.0, 1.0)[..., None]
        rows = torch.arange(b, device=bev.device)[:, None]
        f00 = bev[rows, vi, ui]
        f01 = bev[rows, vi, ui + 1]
        f10 = bev[rows, vi + 1, ui]
        f11 = bev[rows, vi + 1, ui + 1]
        interp = (f00 * (1 - fu) * (1 - fv) + f01 * fu * (1 - fv)
                  + f10 * (1 - fu) * fv + f11 * fu * fv)
        feats = torch.cat([sa, interp.to(sa.dtype)], dim=-1)
        feats = torch.relu(self.proj(feats))
        return kp, feats * kp_mask[..., None].to(feats.dtype), kp_mask


def fuse_proposals(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, iou_thresh: float = 0.1):
    """The matcher's Algorithm 1, fixed shape (ref sub_modules/matcher.py
    :25-160): score-ordered leaders (greedy rotated NMS at
    ``iou_thresh``), each member assigned to its best-overlapping leader
    (the first among equal IoUs), the fused box the score-weighted mean
    with each member's yaw turned by pi toward its leader's.

    boxes (M, 7) hwl in the ego frame, scores (M,), valid (M,) ->
    (fused (M, 7), fused scores (M,), leaders (M,) bool), in score order.
    """
    m = boxes.shape[0]
    order = torch.argsort(-torch.where(valid, scores,
                                       torch.full_like(scores, -1.0)),
                          stable=True)
    b, s, va = boxes[order], scores[order], valid[order]
    corners = box2d_to_corners(b[:, [0, 1, 5, 4, 6]])
    leaders = nms_rotated_fixed(corners, s, va, iou_thresh)
    iou = rotated_iou_matrix(corners, corners)
    iou_to_leader = torch.where(leaders[None, :] & va[:, None], iou,
                                torch.full_like(iou, -1.0))
    assign = torch.argmax(iou_to_leader, dim=1)
    best = torch.gather(iou_to_leader, 1, assign[:, None])[:, 0]
    attached = (best > iou_thresh) | leaders
    member_w = torch.where(va & attached, s, torch.zeros_like(s))
    onehot = (torch.nn.functional.one_hot(assign, m).to(boxes.dtype)
              * member_w[:, None])
    wsum = onehot.sum(0)
    lead_yaw = b[assign, 6]
    dyaw = torch.remainder(b[:, 6] - lead_yaw + math.pi / 2,
                           math.pi) - math.pi / 2
    aligned = torch.cat([b[:, :6], (lead_yaw + dyaw)[:, None]], dim=-1)
    fused = (onehot.T @ aligned) / torch.clamp(wsum[:, None], min=1e-6)
    fused = torch.where(leaders[:, None], fused, b)
    return (fused, torch.where(leaders, s, torch.zeros_like(s)),
            leaders & va)


class RoIGridHead(nn.Module):
    """RoI grid pooling and refinement (ref sub_modules/roi_head.py).
    rois (B, R, 7) hwl ego frame; keypoints (B, K, 3), their features
    (B, K, C) and mask -> (cls (B, R), reg (B, R, 7))."""

    def __init__(self, kp_channels: int, grid_size: int = 4,
                 radius: float = 1.6, nsample: int = 8,
                 fc: tuple = (256, 256)):
        super().__init__()
        self.grid_size = grid_size
        self.radius = radius
        self.nsample = nsample
        self.pool_mlp = PointMLP(3 + kp_channels, (64, 64))
        cin = grid_size ** 3 * 64
        for i, f in enumerate(fc):
            setattr(self, f"fc_{i}", Dense(cin, f))
            cin = f
        self.num_fc = len(fc)
        self.cls = Dense(cin, 1)
        self.reg = Dense(cin, 7)

    def forward(self, rois, kp_xyz, kp_feats, kp_mask):
        b, r = rois.shape[:2]
        g = self.grid_size
        lin = (torch.arange(g, dtype=torch.float32, device=rois.device)
               + 0.5) / g - 0.5
        gz, gy, gx = torch.meshgrid(lin, lin, lin, indexing="ij")
        grid = torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)
        dims = rois[..., [5, 4, 3]]  # l, w, h
        local = grid * dims[..., None, :]  # (B, R, g^3, 3)
        c = torch.cos(rois[..., 6])[..., None]
        s = torch.sin(rois[..., 6])[..., None]
        rx = local[..., 0] * c - local[..., 1] * s
        ry = local[..., 0] * s + local[..., 1] * c
        pts = torch.stack([rx + rois[..., 0:1], ry + rois[..., 1:2],
                           local[..., 2] + rois[..., 2:3]], dim=-1)
        pts = pts.reshape(b, r * g ** 3, 3)
        idx, valid = ball_query(pts, kp_xyz, kp_mask, self.radius,
                                self.nsample)
        pooled = group_and_pool(pts, kp_xyz, kp_feats, idx, valid,
                                self.pool_mlp)
        feat = pooled.reshape(b, r, -1)
        for i in range(self.num_fc):
            feat = torch.relu(getattr(self, f"fc_{i}")(feat))
        return self.cls(feat)[..., 0], self.reg(feat)


@register_model("fpvrcnn")
class FPVRCNN(nn.Module):
    """args: voxel_size, lidar_range, second {...}, ssfa {feature_num},
    anchor_args (the grid the stage-1 proposals decode against),
    anchor_number, dir_args, stage2 {proposals_per_agent, num_keypoints,
    grid_size, score_threshold}, activate_stage2 (true). Batch: points
    (B, L, N, 4) or (B, N, 4), point_mask, agent_mask,
    pairwise_t_matrix."""

    batch_keys = ("points", "point_mask", "agent_mask", "pairwise_t_matrix")

    def __init__(self, args: dict):
        super().__init__()
        a = args
        self.args = a
        norm = a.get("norm", "batch")
        self.encoder = second_encoder(a)
        feat_num = a.get("ssfa", {}).get("feature_num", 128)
        self.input_proj = ConvNormAct(self.encoder.out_channels, feat_num, 3,
                                      1, norm=norm)
        self.ssfa = SSFA(feat_num, feat_num, norm)
        self.heads = DetectionHeads(
            feat_num, anchor_number=a["anchor_number"],
            use_dir="dir_args" in a,
            num_bins=a.get("dir_args", {}).get("num_bins", 2),
            use_iou=True)
        s2 = a.get("stage2", {})
        self.num_proposals = s2.get("proposals_per_agent", 16)
        self.kp_encoder = KeypointEncoder(
            feat_num, num_keypoints=s2.get("num_keypoints", 512),
            bev_stride=8 * a["voxel_size"][0])
        self.roi_head = RoIGridHead(self.kp_encoder.out_channels,
                                    grid_size=s2.get("grid_size", 4))
        # not a buffer: a bf16 copy of the model keeps f32 anchors
        self._anchors = torch.from_numpy(np.asarray(
            generate_anchor_box(a["anchor_args"], a.get("order", "hwl")),
            np.float32)).reshape(-1, 7)
        self.activate_stage2 = a.get("activate_stage2", True)
        self.score_threshold = s2.get("score_threshold", 0.15)

    def _stage1_decode(self, out1: dict):
        """Each agent's top proposals from the stage-1 heads (no NMS: the
        matcher's clustering subsumes it) -> boxes (N, P, 7), scores,
        valid."""
        n = out1["cls_preds"].shape[0]
        if self._anchors.device != out1["cls_preds"].device:
            self._anchors = self._anchors.to(out1["cls_preds"].device)
        acc = torch.promote_types(out1["cls_preds"].dtype, torch.float32)
        prob = torch.sigmoid(out1["cls_preds"].reshape(n, -1).to(acc))
        iou = torch.clamp((out1["iou_preds"].reshape(n, -1).to(acc) + 1.0)
                          / 2.0, 0.0, 1.0)
        top, idx = torch.sort(prob * iou, dim=1, descending=True,
                              stable=True)
        top, idx = top[:, :self.num_proposals], idx[:, :self.num_proposals]
        reg = torch.gather(out1["reg_preds"].reshape(n, -1, 7).to(acc), 1,
                           idx[..., None].expand(-1, -1, 7))
        boxes = geometry.decode_boxes(reg, self._anchors[idx].to(acc))
        return boxes, top, top > self.score_threshold

    def forward(self, batch: dict) -> dict:
        points, mask = batch["points"], batch["point_mask"]
        single_agent = points.dim() == 3
        if single_agent:
            points, mask = points[:, None], mask[:, None]
        b, l, n = points.shape[:3]
        flat_p = points.reshape(b * l, n, -1)
        flat_m = mask.reshape(b * l, n)

        bev = self.encoder(flat_p, flat_m)
        feat = self.ssfa(self.input_proj(bev.permute(0, 3, 1, 2)))
        out1 = self.heads(feat)
        feat = feat.permute(0, 2, 3, 1)
        out = {f"{k}_single": v for k, v in out1.items()}
        out.update(out1)
        out["spatial_features_2d"] = feat
        if not self.activate_stage2:
            return out

        with torch.no_grad():
            boxes, scores, valid = self._stage1_decode(out1)
        kp, kp_feat, kp_mask = self.kp_encoder(
            flat_p, flat_m, feat, tuple(self.args["lidar_range"]))

        # pairwise[i, j] maps frame i -> frame j, so agent j -> ego is
        # [:, j, 0]
        dev = points.device
        if "pairwise_t_matrix" in batch and not single_agent:
            t_to_ego = batch["pairwise_t_matrix"][:, :, 0].reshape(
                b * l, 4, 4).to(points.dtype)
        else:
            t_to_ego = torch.eye(4, dtype=points.dtype,
                                 device=dev).expand(b * l, 4, 4)
        agent_mask = (batch["agent_mask"].reshape(b * l)
                      if "agent_mask" in batch and not single_agent
                      else torch.ones(b * l, dtype=torch.bool, device=dev))
        with torch.no_grad():
            boxes = transform_boxes(boxes, t_to_ego.to(boxes.dtype))
            boxes = boxes.reshape(b, l * self.num_proposals, 7)
            scores = scores.reshape(b, -1) * agent_mask.reshape(
                b, l).repeat_interleave(self.num_proposals, dim=1)
            valid = valid.reshape(b, -1) & (scores > 0)
            fused = [fuse_proposals(boxes[i], scores[i], valid[i])
                     for i in range(b)]
            fused, fused_scores, fused_valid = (
                torch.stack(x) for x in zip(*fused))
        kp = geometry.project_points(kp, t_to_ego).reshape(b, -1, 3)
        k = kp_feat.shape[1]
        kp_feat = kp_feat.reshape(b, l * k, -1)
        kp_mask = (kp_mask.reshape(b, l, k)
                   & agent_mask.reshape(b, l)[:, :, None]).reshape(b, l * k)
        rcnn_cls, rcnn_reg = self.roi_head(fused, kp, kp_feat, kp_mask)
        out.update({"boxes_fused": fused, "scores_fused": fused_scores,
                    "valid_fused": fused_valid, "rcnn_cls": rcnn_cls,
                    "rcnn_reg": rcnn_reg})
        return out
