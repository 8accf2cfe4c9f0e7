"""HEAL Pyramid-Fusion loss (torch): detection loss + per-level occupancy
focal loss.

Counterpart of heal_tpu/losses/point_pillar_pyramid_loss.py:
  * collab mode, no suffix: the detection loss on the fused output;
  * collab mode, "_single" suffix: only the per-agent occupancy loss over
    the pyramid's per-level occupancy maps;
  * single mode: detection + occupancy (stage-2 training).
Occupancy labels: the any-anchor-positive map, max-pooled per level.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.registry import register_loss
from .point_pillar_loss import PointPillarLoss, sigmoid_focal_loss


def _max_pool2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, 1) max pool with kernel = stride = k (valid)."""
    if k == 1:
        return x
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


@register_loss("point_pillar_pyramid_loss")
class PointPillarPyramidLoss(PointPillarLoss):
    def __init__(self, args: dict):
        super().__init__(args)
        self.relative_downsample = args["pyramid"]["relative_downsample"]
        self.pyramid_weight = args["pyramid"]["weight"]

    def occ_loss(self, occ_single_list, positives, negatives):
        """occ_single_list: per-level (B, H_l, W_l, 1) logits (NHWC);
        positives / negatives: (B, H, W, A) anchor maps at level-0 stride."""
        b = positives.shape[0]
        occ_pos = (positives > 0).any(-1, keepdim=True).float()
        occ_neg = (negatives > 0).all(-1, keepdim=True).float()
        total = 0.0
        for i, occ_preds in enumerate(occ_single_list):
            k = self.relative_downsample[i]
            pos_l = _max_pool2d(occ_pos, k).reshape(b, -1, 1)
            neg_l = (1.0 - _max_pool2d(1.0 - occ_neg, k)).reshape(b, -1, 1)
            pos_normalizer = torch.clamp(pos_l.sum(1, keepdim=True), min=1.0)
            w = (pos_l * self.pos_cls_weight + neg_l) / pos_normalizer
            loss = sigmoid_focal_loss(
                occ_preds.reshape(b, -1, 1), pos_l, w,
                alpha=self.cls["alpha"], gamma=self.cls["gamma"])
            total = total + loss.sum() / b * self.pyramid_weight[i]
        return total

    def __call__(self, output_dict, target_dict, suffix: str = ""):
        mode = output_dict.get("pyramid", "collab")
        if mode == "collab":
            if suffix == "":
                return super().__call__(output_dict, target_dict)
            if suffix != "_single":
                raise ValueError(f"unknown loss suffix {suffix!r}")
            occ = self.occ_loss(output_dict["occ_single_list"],
                                target_dict["pos_equal_one"],
                                target_dict["neg_equal_one"])
            return occ, {"pyramid_loss": occ, "total_loss": occ}
        # single (stage-2): detection + occupancy
        total, aux = super().__call__(output_dict, target_dict, suffix)
        occ = self.occ_loss(output_dict["occ_single_list"],
                            target_dict["pos_equal_one"],
                            target_dict["neg_equal_one"])
        total = total + occ
        return total, dict(aux, pyramid_loss=occ, total_loss=total)
