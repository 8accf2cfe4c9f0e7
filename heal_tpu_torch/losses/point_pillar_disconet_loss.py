"""DiscoNet's knowledge-distillation loss (torch).

Counterpart of heal_tpu/losses/point_pillar_disconet_loss.py: the
PointPillars loss plus ``kd.weight`` (1 by default) times the mean
squared difference of the student's fused map (``spatial_features_2d``)
and the frozen teacher's (``teacher_feature``, added to the outputs by
tools/train_w_kd.py), reported as ``kd_loss``. Without a teacher feature
it is the PointPillars loss.
"""
from __future__ import annotations

from ..models.registry import register_loss
from .point_pillar_loss import PointPillarLoss


@register_loss("point_pillar_disconet_loss")
class PointPillarDiscoNetLoss(PointPillarLoss):
    def __init__(self, args: dict):
        super().__init__(args)
        self.kd_weight = args.get("kd", {}).get("weight", 1.0)

    def __call__(self, output_dict, target_dict, suffix: str = ""):
        total, aux = super().__call__(output_dict, target_dict, suffix)
        if ("teacher_feature" in output_dict
                and "spatial_features_2d" in output_dict):
            diff = (output_dict["spatial_features_2d"]
                    - output_dict["teacher_feature"])
            kd = (diff * diff).mean() * self.kd_weight
            total = total + kd
            aux = dict(aux, kd_loss=kd, total_loss=total)
        return total, aux
