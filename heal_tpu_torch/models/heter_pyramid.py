"""HEAL heterogeneous pyramid collaboration model (torch), eval mode.

Counterpart of heal_tpu/models/heter_pyramid.py ``HeterPyramidCollab``
for lidar agents with the PointPillars encoder (m1): per-modality encoder
-> BEV backbone -> aligner -> slot scatter into the (B, L) agent axis ->
Pyramid Fusion -> shrink conv -> cls/reg/dir heads.

Batching is the JAX package's: ``inputs_mX`` arrays hold a fixed
per-modality agent capacity and ``slots_mX`` maps each packed agent to its
global slot in (B, L+1), where slot L is a dump slot for padding.
Camera branches, the SECOND encoder, the compressor and the IoU head are
not ported yet and raise.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .aligner import AlignNet
from .encoders import PointPillarEncoder
from .fuse.pyramid import PyramidFusion
from .heads import DetectionHeads
from .point_pillar import _shrink_from_args
from .registry import register_model
from .resnet_bev import ResNetBEVBackbone

MODALITY_KEYS = ("m1", "m2", "m3", "m4")


def modality_list(args: dict):
    return [m for m in MODALITY_KEYS if m in args]


class ModalityBranch(nn.Module):
    """encoder -> backbone -> aligner for one agent type."""

    def __init__(self, cfg: dict, norm: str = "batch"):
        super().__init__()
        if cfg.get("sensor_type", "lidar") != "lidar":
            raise NotImplementedError("camera branches are not ported yet")
        if cfg["core_method"] != "point_pillar":
            raise NotImplementedError(
                f"lidar encoder {cfg['core_method']!r} is not ported yet"
            )
        enc = cfg["encoder_args"]
        self.encoder = PointPillarEncoder(
            voxel_size=tuple(enc["voxel_size"]),
            lidar_range=tuple(enc["lidar_range"]),
            num_filters=tuple(enc["pillar_vfe"]["num_filters"]),
            use_absolute_xyz=enc["pillar_vfe"].get("use_absolute_xyz", True),
            with_distance=enc["pillar_vfe"].get("with_distance", False),
            norm=norm,
            presorted=enc.get("presorted", False),
        )
        bb = cfg["backbone_args"]
        self.backbone = ResNetBEVBackbone(
            self.encoder.out_channels,
            layer_nums=tuple(bb["layer_nums"]),
            layer_strides=tuple(bb["layer_strides"]),
            num_filters=tuple(bb["num_filters"]),
            upsample_strides=tuple(bb.get("upsample_strides", ())),
            num_upsample_filter=tuple(bb.get("num_upsample_filter", ())),
            norm=norm,
        )
        self.aligner = AlignNet(cfg.get("aligner_args"))
        self.out_channels = self.backbone.out_channels

    def forward(self, inputs: dict) -> torch.Tensor:
        """inputs: points (N, P, 4), point_mask (N, P) with a flat agent
        axis. Returns the (N, C, h, w) aligned BEV features (NCHW)."""
        feat = self.encoder(inputs["points"], inputs["point_mask"])
        feat = self.backbone(feat.permute(0, 3, 1, 2))
        return self.aligner(feat)


@register_model("heter_pyramid_collab")
class HeterPyramidCollab(nn.Module):
    """args: per-modality blocks (m1..m4) + fusion_backbone + shrink_header
    + anchor_number + dir_args."""

    def __init__(self, args: dict):
        super().__init__()
        a = args
        for key in ("compressor", "use_iou"):
            if a.get(key):
                raise NotImplementedError(f"{key} is not ported yet")
        norm = a.get("norm", "batch")
        self.modalities = modality_list(a)
        for m in self.modalities:
            self.add_module(f"branch_{m}", ModalityBranch(a[m], norm=norm))
        width = getattr(self, f"branch_{self.modalities[0]}").out_channels
        self.pyramid_backbone = PyramidFusion(
            a["fusion_backbone"], width, norm=norm
        )
        self.shrink = _shrink_from_args(a, self.pyramid_backbone.out_channels)
        head_in = (a["shrink_header"]["dim"][-1] if self.shrink is not None
                   else self.pyramid_backbone.out_channels)
        self.heads = DetectionHeads(
            head_in,
            anchor_number=a["anchor_number"],
            use_dir="dir_args" in a,
            num_bins=a.get("dir_args", {}).get("num_bins", 2),
        )

    def forward(self, batch: dict) -> dict:
        """batch (tensors): inputs_mX {points (B, L_m, P, 4), point_mask},
        slots_mX (B, L_m) int, agent_mask (B, L) bool, pairwise_affine
        (B, L, L, 2, 3). Returns the NHWC head outputs plus
        ``occ_single_list``."""
        agent_mask = batch["agent_mask"]
        b, l = agent_mask.shape
        feat_all = None
        for m in self.modalities:
            if f"inputs_{m}" not in batch:
                continue
            inputs = batch[f"inputs_{m}"]
            lm = inputs["points"].shape[1]
            flat = {k: v.reshape((b * lm,) + v.shape[2:])
                    for k, v in inputs.items()}
            feat = getattr(self, f"branch_{m}")(flat)  # (B*L_m, C, h, w)
            feat = feat.permute(0, 2, 3, 1)  # NHWC view
            feat = feat.reshape((b, lm) + feat.shape[1:])
            if feat_all is None:
                h, w, c = feat.shape[2:]
                feat_all = feat.new_zeros((b * (l + 1), h, w, c))
            # per-sample scatter-add into global agent slots
            slots = batch[f"slots_{m}"].long()
            rows = (slots + torch.arange(b, device=slots.device)[:, None]
                    * (l + 1)).reshape(-1)
            feat_all.index_add_(0, rows, feat.reshape((b * lm,)
                                                      + feat.shape[2:]))
        if feat_all is None:
            raise ValueError("no modality inputs in batch")
        feat_all = feat_all.reshape((b, l + 1) + feat_all.shape[1:])[:, :l]

        fused, occ_list = self.pyramid_backbone.forward_collab(
            feat_all, batch["pairwise_affine"], agent_mask
        )
        fused = fused.permute(0, 3, 1, 2)
        if self.shrink is not None:
            fused = self.shrink(fused)
        out = self.heads(fused)
        out["occ_single_list"] = occ_list
        return out
