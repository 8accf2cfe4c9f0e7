"""CIA-SSD's and FPV-RCNN's losses (torch).

Counterparts of heal_tpu/losses/fpvrcnn_loss.py:
  * ``ciassd_loss``: the PointPillars loss (focal cls, sin-difference
    smooth-L1, direction bins, and with ``iou`` the IoU term);
  * ``fpvrcnn_loss``: stage 1 (``ciassd_loss`` of ``stage1``) on the
    per-agent ``*_single`` outputs against the ``*_single`` labels, plus
    stage 2 on the fused RoIs against the ego-frame ground truth: each
    RoI's best rotated-BEV IoU with a real box (the first among equal
    ones), its quality target (IoU - bg) / (fg - bg) clipped to [0, 1]
    under a BCE over the valid RoIs, and for the RoIs above
    ``fg_thresh`` the roi-frame residual (xyz over [diag, diag, h], log
    dimension ratio, yaw delta) under a sin-difference smooth-L1 (sigma
    3) over their count; each averaged over the batch and weighted
    (``cls_weight``, ``reg_weight``), as ``rcnn_cls_loss`` /
    ``rcnn_reg_loss``. Stage-1 terms are prefixed ``stage1_``.
"""
from __future__ import annotations

import torch

from ..models.registry import register_loss
from ..utils.rotated_iou import box2d_to_corners, rotated_iou_corners
from .point_pillar_loss import (PointPillarLoss, add_sin_difference,
                                bce_with_logits, weighted_smooth_l1)


@register_loss("ciassd_loss")
class CiassdLoss(PointPillarLoss):
    """Stage 1: the PointPillars loss with the IoU branch."""


@register_loss("fpvrcnn_loss")
class FpvrcnnLoss:
    def __init__(self, args: dict):
        self.stage1 = CiassdLoss(args["stage1"])
        s2 = args.get("stage2", {})
        self.cls_weight = s2.get("cls_weight", 1.0)
        self.reg_weight = s2.get("reg_weight", 1.0)
        self.fg_thresh = s2.get("fg_thresh", 0.55)
        self.bg_thresh = s2.get("bg_thresh", 0.25)

    def set_anchors(self, anchors):
        self.stage1.set_anchors(anchors)

    def _stage2(self, output_dict, target_dict):
        rois = output_dict["boxes_fused"]  # (B, R, 7) hwl, ego frame
        care = output_dict["valid_fused"]
        cls_l = output_dict["rcnn_cls"]  # (B, R)
        reg_l = output_dict["rcnn_reg"]  # (B, R, 7)
        gt = target_dict["gt_boxes"]  # (B, G, 7) hwl
        gm = target_dict["gt_mask"] > 0
        order = [0, 1, 5, 4, 6]
        rc = box2d_to_corners(rois[..., order])
        gc = box2d_to_corners(gt[..., order])
        r, g = rc.shape[1], gc.shape[1]
        iou = rotated_iou_corners(rc[:, :, None].expand(-1, -1, g, 4, 2),
                                  gc[:, None].expand(-1, r, -1, 4, 2))
        iou = torch.where(gm[:, None, :], iou, torch.full_like(iou, -1.0))
        best = iou.amax(dim=2)
        best_idx = torch.argmax(iou, dim=2)
        matched = torch.gather(gt, 1, best_idx[..., None].expand(-1, -1, 7))

        # the quality target: the scaled IoU between the bg and fg
        # thresholds (ref roi_head.assign_targets)
        q = torch.clamp((best - self.bg_thresh)
                        / (self.fg_thresh - self.bg_thresh), 0.0, 1.0)
        bce = bce_with_logits(cls_l, q)
        caref = care.to(bce.dtype)
        n_care = torch.clamp(caref.sum(1), min=1.0)
        cls_loss = (bce * caref).sum(1) / n_care

        # the residual targets in the roi frame, for the fg rois
        fg = care & (best > self.fg_thresh)
        diag = torch.sqrt(rois[..., 4] ** 2 + rois[..., 5] ** 2)
        t_xyz = (matched[..., :3] - rois[..., :3]) / torch.clamp(
            torch.stack([diag, diag, rois[..., 3]], dim=-1), min=1e-3)
        t_dim = torch.log(torch.clamp(matched[..., 3:6], min=1e-3)
                          / torch.clamp(rois[..., 3:6], min=1e-3))
        t_yaw = matched[..., 6:7] - rois[..., 6:7]
        target = torch.cat([t_xyz, t_dim, t_yaw], dim=-1)
        p, t = add_sin_difference(reg_l, target)
        reg = weighted_smooth_l1(p, t, fg[..., None].float(), 3.0)
        n_fg = torch.clamp(fg.sum(1).float(), min=1.0)
        reg_loss = reg.sum((1, 2)) / n_fg
        return (cls_loss.mean() * self.cls_weight,
                reg_loss.mean() * self.reg_weight)

    def __call__(self, output_dict, target_dict, suffix: str = ""):
        # stage 1 on the per-agent single outputs when present
        s1_out = {k[:-len("_single")]: v for k, v in output_dict.items()
                  if k.endswith("_single")}
        s1_tgt = target_dict
        if "pos_equal_one_single" in target_dict:
            s1_tgt = {"pos_equal_one": target_dict["pos_equal_one_single"],
                      "neg_equal_one": target_dict["neg_equal_one_single"],
                      "targets": target_dict["targets_single"]}
        total, aux = self.stage1(s1_out or output_dict, s1_tgt)
        aux = {f"stage1_{k}": v for k, v in aux.items()}
        if "rcnn_cls" in output_dict and "gt_boxes" in target_dict:
            cls2, reg2 = self._stage2(output_dict, target_dict)
            total = total + cls2 + reg2
            aux["rcnn_cls_loss"] = cls2
            aux["rcnn_reg_loss"] = reg2
        aux["total_loss"] = total
        return total, aux
