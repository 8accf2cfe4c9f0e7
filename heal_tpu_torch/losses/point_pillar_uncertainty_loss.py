"""Aleatoric-uncertainty detection loss (von Mises angle likelihood).

Counterpart of heal_tpu/losses/point_pillar_uncertainty_loss.py, the
loss of CoAlign's stage-1 detector (``point_pillar_uncertainty``): the
PointPillars loss plus negative log-likelihoods with learned
heteroscedastic uncertainty over the positives, a Laplace-style term for
x and y (|e| exp(-s) + s) and a von Mises term for the yaw, weighted by
``uncertainty.weight`` (default 0.5). log I0(kappa) is taken as
log(i0e(kappa)) + kappa, finite at large kappa and differentiable
(``torch.special.i0e``).

Prediction layout NHWC, as in JAX: unc_preds (B, H, W, A*3), log-var x,
log-var y and log-kappa yaw per anchor, read as (B, H*W*A, 3).
"""
from __future__ import annotations

import math

import torch

from ..models.registry import register_loss
from .point_pillar_loss import PointPillarLoss


def log_i0(kappa: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.special.i0e(kappa)) + kappa


def von_mises_nll(pred_angle, target_angle, log_kappa):
    """-log VM(target; pred, kappa), kappa = exp(log_kappa)."""
    kappa = torch.exp(log_kappa)
    return (-kappa * torch.cos(pred_angle - target_angle) + log_i0(kappa)
            + math.log(2 * math.pi))


@register_loss("point_pillar_uncertainty_loss")
class PointPillarUncertaintyLoss(PointPillarLoss):
    """Expects output_dict['unc_preds'] (B, H, W, A*3)."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.unc_weight = args.get("uncertainty", {}).get("weight", 0.5)

    def __call__(self, output_dict, target_dict, suffix: str = ""):
        total, aux = super().__call__(output_dict, target_dict, suffix)
        key = f"unc_preds{suffix}"
        if key not in output_dict:
            return total, aux
        b = output_dict[f"cls_preds{suffix}"].shape[0]
        unc = output_dict[key].reshape(b, -1, 3)
        reg_preds = output_dict[f"reg_preds{suffix}"].reshape(b, -1, 7)
        reg_targets = target_dict["targets"].reshape(b, -1, 7)
        positives = target_dict["pos_equal_one"].reshape(b, -1) > 0
        pos_norm = torch.clamp(
            positives.sum(dim=1, keepdim=True).float(), min=1.0)
        w = positives.float() / pos_norm

        # heteroscedastic position NLL: |e| / exp(s) + s (Laplace-style)
        err_xy = torch.abs(reg_preds[..., :2] - reg_targets[..., :2])
        s_xy = unc[..., :2]
        nll_xy = (err_xy * torch.exp(-s_xy) + s_xy).sum(-1)
        nll_yaw = von_mises_nll(reg_preds[..., 6], reg_targets[..., 6],
                                unc[..., 2])
        unc_loss = ((nll_xy + nll_yaw) * w).sum() / b * self.unc_weight
        total = total + unc_loss
        aux = dict(aux, unc_loss=unc_loss, total_loss=total)
        return total, aux
