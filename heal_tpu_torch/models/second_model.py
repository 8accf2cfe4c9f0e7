"""The SECOND detectors (torch): ``second`` and ``second_intermediate``.

Counterparts of heal_tpu/models/second_model.py: the SECOND sparse-conv
encoder (models/second.py, the column engine) -> ResNet BEV backbone ->
shrink -> anchor ``DetectionHeads``; the intermediate variant runs the
chain on every agent slot of a (B, L) batch and fuses the maps with the
config's ``fusion_method`` before the heads. Its fusion's
``in_channels`` defaults to ``in_head`` (else 64), not the map's width,
as JAX's does, and no fusion is gated by confidence (JAX passes none).
Modules carry flax's auto-names (``SecondEncoder_0``,
``ResNetBEVBackbone_0``, ``DownsampleConv_0``, the fusion's
``<Class>_0``, ``DetectionHeads_0``). ``second_ssfa`` and
``second_ssfa_uncertainty`` (the SSFA neck) are not ported yet.
"""
from __future__ import annotations

from .point_pillar import DetectorChain, IntermediateChain
from .registry import register_model
from .second import SecondEncoder


def _encoder(a: dict) -> SecondEncoder:
    sec = a.get("second", {})
    return SecondEncoder(
        voxel_size=tuple(a["voxel_size"]),
        lidar_range=tuple(a["lidar_range"]),
        channels=tuple(sec.get("channels", (16, 32, 64, 64))),
        max_voxels=tuple(sec.get("max_voxels", (24000, 16000, 12000, 8000))),
        norm=a.get("norm", "batch"),
        presorted=a.get("presorted", False),
    )


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
