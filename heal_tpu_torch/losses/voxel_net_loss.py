"""VoxelNet's loss (torch).

Counterpart of heal_tpu/losses/voxel_net_loss.py (ref
loss/voxel_net_loss.py:12-62): the sigmoid probability split into a
positive and a negative cross-entropy term, each normalised by its own
anchor count (+ 1e-6), and the smooth-L1 of the positive-masked
residuals over the positive count.
``total = reg * reg_loss + alpha * cls_pos + beta * cls_neg``. Preds
``psm`` / ``rm`` (or ``cls_preds`` / ``reg_preds``), NHWC; targets the
anchor labels ``pos_equal_one``, ``neg_equal_one``, ``targets``.
"""
from __future__ import annotations

import torch

from ..models.registry import register_loss
from .pixor_loss import smooth_l1


@register_loss("voxel_net_loss")
class VoxelNetLoss:
    """args: alpha, beta (positive / negative cls weights), reg."""

    def __init__(self, args: dict):
        self.alpha = args["alpha"]
        self.beta = args["beta"]
        self.reg_coe = args["reg"]

    def __call__(self, output_dict, target_dict, suffix: str = ""):
        psm = output_dict.get(f"psm{suffix}",
                              output_dict.get(f"cls_preds{suffix}"))
        rm = output_dict.get(f"rm{suffix}",
                             output_dict.get(f"reg_preds{suffix}"))
        pos = target_dict["pos_equal_one"].float()
        neg = target_dict["neg_equal_one"].float()
        targets = target_dict["targets"]
        p_pos = torch.sigmoid(psm.float())
        rm = rm.reshape(rm.shape[:3] + (-1, 7)).float()
        tgt = targets.reshape(targets.shape[:3] + (-1, 7)).float()
        pos5 = pos[..., None]
        cls_pos_loss = (-(pos * torch.log(p_pos + 1e-6)).sum()
                        / (pos.sum() + 1e-6))
        cls_neg_loss = (-(neg * torch.log(1.0 - p_pos + 1e-6)).sum()
                        / (neg.sum() + 1e-6))
        reg_loss = smooth_l1(rm * pos5, tgt * pos5).sum() / (pos.sum() + 1e-6)
        conf_loss = self.alpha * cls_pos_loss + self.beta * cls_neg_loss
        total = self.reg_coe * reg_loss + conf_loss
        return total, {"total_loss": total, "reg_loss": reg_loss,
                       "conf_loss": conf_loss}
