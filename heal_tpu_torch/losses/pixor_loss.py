"""PIXOR's loss (torch).

Counterpart of heal_tpu/losses/pixor_loss.py (ref loss/pixor_loss.py
:13-66): the mean binary cross-entropy over every pixel of the
objectness map (the reference's class-balance weights are computed but
not applied), plus the smooth-L1 of the objectness-masked 6-channel
regression, summed and divided by the positive pixels when there are
any. ``total = alpha * cls + beta * loc``. Preds ``cls`` (B, H, W, 1)
logits and ``reg`` (B, H, W, 6) (or ``cls_preds`` / ``reg_preds``);
target ``label_map`` (B, H, W, 7) from
``postprocess.targets.generate_pixor_label_map``.
"""
from __future__ import annotations

import torch

from ..models.registry import register_loss
from .point_pillar_loss import bce_with_logits


def smooth_l1(x, y):
    """torch's smooth-L1 at beta 1: 0.5 d^2 below 1, else |d| - 0.5."""
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


@register_loss("pixor_loss")
class PixorLoss:
    """args: alpha (cls weight), beta (reg weight)."""

    def __init__(self, args: dict):
        self.alpha = args["alpha"]
        self.beta = args["beta"]

    def __call__(self, output_dict, target_dict, suffix: str = ""):
        targets = target_dict["label_map"]
        cls_preds = output_dict.get(f"cls{suffix}",
                                    output_dict.get(f"cls_preds{suffix}"))
        loc_preds = output_dict.get(f"reg{suffix}",
                                    output_dict.get(f"reg_preds{suffix}"))
        cls_targets = targets[..., :1]
        loc_targets = targets[..., 1:]
        cls_loss = bce_with_logits(
            cls_preds, cls_targets.to(cls_preds.dtype)).mean()
        pos_pixels = cls_targets.sum()
        loc_sum = smooth_l1(cls_targets * loc_preds,
                            cls_targets * loc_targets).sum()
        # ref :57-58: divide by the positives only when there are any
        loc_loss = torch.where(pos_pixels > 0, loc_sum / pos_pixels, loc_sum)
        total = self.alpha * cls_loss + self.beta * loc_loss
        return total, {"total_loss": total, "cls_loss": cls_loss,
                       "reg_loss": loc_loss}
