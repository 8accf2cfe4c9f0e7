"""Pyramid Fusion, HEAL's collaboration base (torch).

Counterpart of heal_tpu/models/fuse/pyramid.py: a ResNeXt multiscale BEV
backbone whose per-level features carry 1x1 occupancy heads;
collaboration is a foreground-score softmax-weighted sum of ego-warped
per-agent features at every level, then the deblock decode.

Public functions keep the JAX layout, (B, L, h, w, C) and NHWC outputs;
the convolutions run NCHW on ``channels_last`` memory, so the layout
changes at the boundary are views.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ... import trace
from ...ops.warp import warp_agents_to_ego
from ..layers import Conv
from ..resnet_bev import ResNetBEVBackbone

NEG_INF = -1e9


def weighted_fuse(
    features: torch.Tensor,
    scores: torch.Tensor,
    affine: torch.Tensor,
    agent_mask: torch.Tensor,
    align_corners: bool = False,
) -> torch.Tensor:
    """Softmax(score)-weighted sum of ego-warped features.

    features (B, L, h, w, C); scores (B, L, h, w, 1) in (0, 1];
    affine (B, L, L, 2, 3) at this level's scale; agent_mask (B, L) bool.
    Returns (B, h, w, C).
    """
    # one warp for features + score (concatenated on channels)
    cat = torch.cat([features, scores.to(features.dtype)], dim=-1)
    warped = warp_agents_to_ego(cat, affine, align_corners)
    warped_f, warped_s = warped[..., :-1], warped[..., -1:]
    # exact zeros mean "outside the sender's FOV" (scores are > 0 inside)
    logit = torch.where(warped_s == 0.0, NEG_INF, warped_s)
    logit = torch.where(agent_mask[:, :, None, None, None], logit, NEG_INF)
    weight = torch.softmax(logit, dim=1)
    weight = torch.where(torch.isnan(weight), 0.0, weight)
    return (warped_f * weight).sum(dim=1)


class PyramidFusion(nn.Module):
    """args: the fusion_backbone block of the config."""

    def __init__(self, args: dict, cin: int, norm: str = "batch"):
        super().__init__()
        a = args
        self.backbone = ResNetBEVBackbone(
            cin,
            layer_nums=tuple(a["layer_nums"]),
            layer_strides=tuple(a["layer_strides"]),
            num_filters=tuple(a["num_filters"]),
            upsample_strides=tuple(a.get("upsample_strides", ())),
            num_upsample_filter=tuple(a.get("num_upsample_filter", ())),
            resnext=a.get("resnext", False),
            width_per_group=a.get("width_per_group", 4),
            norm=norm,
        )
        self.align_corners = a.get("align_corners", False)
        self.num_levels = len(a["layer_nums"])
        for i in range(self.num_levels):
            self.add_module(f"single_head_{i}", Conv(a["num_filters"][i], 1))
        self.out_channels = self.backbone.out_channels

    def _heads(self):
        return [getattr(self, f"single_head_{i}")
                for i in range(self.num_levels)]

    def forward_single(self, x: torch.Tensor):
        """x (N, H, W, C) -> (decoded (N, H, W, C'), occ list (N, h, w, 1))."""
        with trace.span("fusion"):
            feats = self.backbone.encode(x.permute(0, 3, 1, 2))
            occ = [head(f).permute(0, 2, 3, 1) for head, f in
                   zip(self._heads(), feats)]
            return self.backbone.decode(feats).permute(0, 2, 3, 1), occ

    def forward_collab(self, x: torch.Tensor, affine: torch.Tensor,
                       agent_mask: torch.Tensor, crop_mask_list=None):
        """x (B, L, H, W, C) per-agent features; affine (B, L, L, 2, 3);
        crop_mask_list: optional per-level (B, L, h, w, 1) multiplicative
        score masks (the camera field of view, at eval).

        Returns (fused (B, H, W, C'), occ_map list at (B*L, h, w, 1)).
        """
        with trace.span("fusion"):
            b, l = x.shape[:2]
            flat = x.reshape((b * l,) + x.shape[2:]).permute(0, 3, 1, 2)
            feats = self.backbone.encode(flat)
            fused_levels = []
            occ_maps = []
            for i, (head, f) in enumerate(zip(self._heads(), feats)):
                occ = head(f).permute(0, 2, 3, 1)  # (B*L, h, w, 1)
                occ_maps.append(occ)
                score = torch.sigmoid(occ) + 1e-4
                if crop_mask_list is not None:
                    score = score * crop_mask_list[i].reshape(score.shape)
                fl = f.permute(0, 2, 3, 1)
                fl = fl.reshape((b, l) + fl.shape[1:])
                sl = score.reshape((b, l) + score.shape[1:])
                fused = weighted_fuse(fl, sl, affine, agent_mask,
                                      self.align_corners)
                fused_levels.append(fused.permute(0, 3, 1, 2))
            fused = self.backbone.decode(fused_levels)
            return fused.permute(0, 2, 3, 1), occ_maps
