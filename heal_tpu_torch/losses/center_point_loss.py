"""CenterPoint anchor-free loss (torch): Gaussian-focal heatmap + box
smooth-L1 at the GT centres.

Counterpart of heal_tpu/losses/center_point_loss.py. The weights are
read as JAX reads them, ``args["cls"]["weight"]`` and
``args["reg"]["weight" | "sigma"]`` (defaults 1.0, 2.0, 3.0); the
published configs' flat ``cls_weight`` / ``reg_weight`` are not read by
either package (ROADMAP §3, known faults in the reference).
"""
from __future__ import annotations

import torch

from ..models.registry import register_loss
from .point_pillar_loss import batch_divisor, weighted_smooth_l1


def gaussian_focal_loss(pred_logits, heatmap, alpha: float = 2.0,
                        beta: float = 4.0, mesh=None):
    """CornerNet's penalty-reduced focal loss; heatmap in [0, 1], its
    positives where it is >= 1 - 1e-4; normalised by the positives of the
    whole batch (point_pillar_loss.batch_divisor)."""
    p = torch.sigmoid(pred_logits)
    eps = 1e-6
    pos = (heatmap >= 1.0 - 1e-4).to(p.dtype)
    neg = 1.0 - pos
    pos_loss = -torch.log(p + eps) * (1 - p) ** alpha * pos
    neg_loss = (-torch.log(1 - p + eps) * p ** alpha
                * (1 - heatmap) ** beta * neg)
    num_pos = batch_divisor(pos.sum(), mesh)
    return (pos_loss.sum() + neg_loss.sum()) / num_pos


@register_loss("center_point_loss")
class CenterPointLoss:
    mesh = None  # parallel/sharding.Mesh: the batch-wide normalisers

    def __init__(self, args: dict):
        self.args = args
        self.cls_weight = args.get("cls", {}).get("weight", 1.0)
        self.reg_weight = args.get("reg", {}).get("weight", 2.0)
        self.sigma = args.get("reg", {}).get("sigma", 3.0)

    def __call__(self, output_dict, target_dict, suffix: str = ""):
        hm_logits = output_dict[f"cls_preds{suffix}"]  # (B, H, W, 1)
        box_preds = output_dict[f"reg_preds{suffix}"]  # (B, H, W, 7)
        heatmap = target_dict["heatmap"]
        box_t = target_dict["box_targets"]
        m = target_dict["reg_mask"][..., None]

        cls_loss = gaussian_focal_loss(hm_logits, heatmap,
                                       mesh=self.mesh) * self.cls_weight
        reg = weighted_smooth_l1(box_preds, box_t, m, self.sigma)
        reg_loss = (reg.sum() / batch_divisor(m.sum(), self.mesh)
                    * self.reg_weight)
        total = cls_loss + reg_loss
        return total, {"cls_loss": cls_loss, "reg_loss": reg_loss,
                       "total_loss": total}
