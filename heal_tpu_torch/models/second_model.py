"""The SECOND detectors (torch): ``second``, ``second_intermediate``,
``second_ssfa`` and ``second_ssfa_uncertainty``.

Counterparts of heal_tpu/models/second_model.py: the SECOND sparse-conv
encoder (models/second.py, the column engine) -> ResNet BEV backbone ->
shrink -> anchor ``DetectionHeads``; the intermediate variant runs the
chain on every agent slot of a (B, L) batch and fuses the maps with the
config's ``fusion_method`` before the heads. Its fusion's
``in_channels`` defaults to ``in_head`` (else 64), not the map's width,
as JAX's does, and no fusion is gated by confidence (JAX passes none).
Modules carry flax's auto-names (``SecondEncoder_0``,
``ResNetBEVBackbone_0``, ``DownsampleConv_0``, the fusion's
``<Class>_0``, ``DetectionHeads_0``). ``second_ssfa`` (ref
models/second_ssfa.py) runs the agents' slots through the encoder, a 3x3
``input_proj`` and CIA-SSD's ``SSFA`` neck (models/ciassd.py), the
shrink when set, then the heads, whose IoU branch is on unless
``use_iou`` says otherwise; ``second_ssfa_uncertainty`` is the same
model under ``ssfa_unc`` with the IoU branch off by default and the
1x1 ``unc_head`` (``uncertainty_dim`` (3) values an anchor: log-var x,
log-var y, log-kappa yaw) as ``unc_preds``, NHWC.
"""
from __future__ import annotations

import torch.nn as nn

from .ciassd import SSFA, flat_agents, second_encoder
from .heads import DetectionHeads
from .layers import Conv, ConvNormAct
from .point_pillar import DetectorChain, IntermediateChain, _shrink_from_args
from .registry import register_model
from .second import SecondEncoder


def _encoder(a: dict) -> SecondEncoder:
    return second_encoder(a, presorted=a.get("presorted", False))


@register_model("second")
class Second(DetectorChain):
    """args: voxel_size, lidar_range, (second {channels, max_voxels}),
    base_bev_backbone, (shrink_header), anchor_number, (dir_args). Batch:
    points (B, N, 4), point_mask (B, N)."""

    def __init__(self, args: dict):
        super().__init__()
        self.DetectionHeads_0 = self._heads(self._build_chain(
            args, _encoder(args)))

    def forward(self, batch: dict) -> dict:
        feat = self.features(batch["points"], batch["point_mask"])
        out = self.DetectionHeads_0(feat)
        out["spatial_features_2d"] = feat.permute(0, 2, 3, 1)
        return out


@register_model("second_intermediate")
class SecondIntermediate(IntermediateChain):
    """args: Second's + fusion_method (default max) and its block. Batch:
    points (B, L, N, 4), point_mask (B, L, N), agent_mask (B, L),
    pairwise_affine (B, L, L, 2, 3)."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        width = self._build_chain(args, _encoder(args))
        method = args.get("fusion_method", "max")
        fusion_args = dict(args.get(method, {}) or {})
        fusion_args.setdefault("in_channels", args.get("in_head", 64))
        width = self._build_fusion(method, fusion_args, width, max_cav)
        self.DetectionHeads_0 = self._heads(width)

    def forward(self, batch: dict) -> dict:
        feat, b, l = self.agent_features(batch)
        nhwc = feat.permute(0, 2, 3, 1)
        fused = self.fusion(nhwc.reshape((b, l) + nhwc.shape[1:]),
                            batch["pairwise_affine"], batch["agent_mask"])
        out = self.DetectionHeads_0(fused.permute(0, 3, 1, 2))
        out["spatial_features_2d"] = fused
        return out


@register_model("second_ssfa")
class SecondSSFA(nn.Module):
    """args: Second's + ssfa {feature_num} (128), (use_iou),
    (uncertainty_dim). Batch: points (B, N, 4) (or (B, L, N, 4), every
    slot a sample), point_mask."""

    batch_keys = ("points", "point_mask")

    def __init__(self, args: dict, use_uncertainty: bool = False):
        super().__init__()
        a = args
        norm = a.get("norm", "batch")
        self.SecondEncoder_0 = _encoder(a)
        feat_num = a.get("ssfa", {}).get("feature_num", 128)
        width = feat_num
        shrink = _shrink_from_args(a, width)
        if shrink is not None:
            self.DownsampleConv_0 = shrink
            width = a["shrink_header"]["dim"][-1]
        self.input_proj = ConvNormAct(self.SecondEncoder_0.out_channels,
                                      feat_num, 3, 1, norm=norm)
        self.ssfa = SSFA(feat_num, feat_num, norm)
        self.DetectionHeads_0 = DetectionHeads(
            width, anchor_number=a["anchor_number"],
            use_dir="dir_args" in a,
            num_bins=a.get("dir_args", {}).get("num_bins", 2),
            use_iou=a.get("use_iou", not use_uncertainty))
        self.unc_head = (Conv(width, a.get("uncertainty_dim", 3)
                              * a["anchor_number"])
                         if use_uncertainty else None)

    def forward(self, batch: dict) -> dict:
        bev = self.SecondEncoder_0(*flat_agents(batch))
        feat = self.ssfa(self.input_proj(bev.permute(0, 3, 1, 2)))
        shrink = getattr(self, "DownsampleConv_0", None)
        if shrink is not None:
            feat = shrink(feat)
        out = self.DetectionHeads_0(feat)
        if self.unc_head is not None:
            out["unc_preds"] = self.unc_head(feat).permute(0, 2, 3, 1)
        out["spatial_features_2d"] = feat.permute(0, 2, 3, 1)
        return out


@register_model("second_ssfa_uncertainty")
class SecondSSFAUncertainty(nn.Module):
    """``SecondSSFA`` with the uncertainty head, under ``ssfa_unc`` (ref
    models/second_ssfa_uncertainty.py)."""

    batch_keys = SecondSSFA.batch_keys

    def __init__(self, args: dict):
        super().__init__()
        self.ssfa_unc = SecondSSFA(args, use_uncertainty=True)

    def forward(self, batch: dict) -> dict:
        return self.ssfa_unc(batch)
