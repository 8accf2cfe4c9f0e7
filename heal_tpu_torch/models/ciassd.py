"""CIA-SSD (torch): the SSFA neck and the IoU-aware single-stage detector.

Counterpart of heal_tpu/models/ciassd.py: the SECOND encoder (the column
engine, models/second.py; no kernel runs here, as in JAX) -> a 3x3
``input_proj`` to ``ssfa.feature_num`` (128) channels -> ``SSFA`` ->
anchor heads with the IoU branch (``heads``). ``SSFA`` (ref
cia_ssd_utils.SSFA): a spatial branch of three stride-1 convs
(``bu0_{i}``) and a semantic branch of three convs at twice the stride
(``bu1_{i}``, the first strided), 1x1 transitions (``trans_{0,1}``),
the semantic map upsampled twice (``deconv_{0,1}``), the first added to
the spatial one, 3x3 convs (``conv_{0,1}``) and a per-pixel softmax
over two 1x1 weight convs (``w_{0,1}``) merging the two. Names are
flax's, so heal_tpu variables bridge strictly.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .heads import DetectionHeads
from .layers import Conv, ConvNormAct, DeconvNormAct
from .registry import register_model
from .second import SecondEncoder


class SSFA(nn.Module):
    """NCHW (N, C, H, W) -> (N, features, H, W)."""

    def __init__(self, cin: int, features: int = 128, norm: str = "batch"):
        super().__init__()
        f = features
        for i in range(3):
            setattr(self, f"bu0_{i}", ConvNormAct(cin if i == 0 else f, f, 3,
                                                  1, norm=norm))
        for i in range(3):
            setattr(self, f"bu1_{i}", ConvNormAct(f if i == 0 else 2 * f,
                                                  2 * f, 3, 2 if i == 0 else 1,
                                                  norm=norm))
        self.trans_0 = ConvNormAct(f, f, 1, 1, norm=norm)
        self.trans_1 = ConvNormAct(2 * f, 2 * f, 1, 1, norm=norm)
        self.deconv_0 = DeconvNormAct(2 * f, f, 2, norm=norm)
        self.deconv_1 = DeconvNormAct(2 * f, f, 2, norm=norm)
        self.conv_0 = ConvNormAct(f, f, 3, 1, norm=norm)
        self.conv_1 = ConvNormAct(f, f, 3, 1, norm=norm)
        self.w_0 = Conv(f, 1)
        self.w_1 = Conv(f, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        for i in range(3):
            x0 = getattr(self, f"bu0_{i}")(x0)
        x1 = x0
        for i in range(3):
            x1 = getattr(self, f"bu1_{i}")(x1)
        t0 = self.trans_0(x0)
        t1 = self.trans_1(x1)
        m0 = self.deconv_0(t1) + t0
        m1 = self.deconv_1(t1)
        o0 = self.conv_0(m0)
        o1 = self.conv_1(m1)
        w = torch.softmax(torch.cat([self.w_0(o0), self.w_1(o1)], dim=1),
                          dim=1)
        return o0 * w[:, 0:1] + o1 * w[:, 1:2]


def second_encoder(a: dict, presorted: bool = False) -> SecondEncoder:
    """The config's SECOND encoder (``second`` {channels, max_voxels})."""
    sec = a.get("second", {})
    return SecondEncoder(
        voxel_size=tuple(a["voxel_size"]),
        lidar_range=tuple(a["lidar_range"]),
        channels=tuple(sec.get("channels", (16, 32, 64, 64))),
        max_voxels=tuple(sec.get("max_voxels", (24000, 16000, 12000, 8000))),
        norm=a.get("norm", "batch"),
        presorted=presorted,
    )


def flat_agents(batch: dict):
    """points (B, N, 4) or (B, L, N, 4) (every agent slot) -> the
    (B or B*L, N, 4) points and their mask."""
    points, mask = batch["points"], batch["point_mask"]
    if points.dim() == 4:
        b, l = points.shape[:2]
        points = points.reshape((b * l,) + points.shape[2:])
        mask = mask.reshape((b * l,) + mask.shape[2:])
    return points, mask


@register_model("ciassd")
class CIASSD(nn.Module):
    """args: voxel_size, lidar_range, second {channels, max_voxels},
    ssfa {feature_num}, anchor_number, dir_args. Batch: points (B, N, 4)
    (or (B, L, N, 4), every slot a sample), point_mask."""

    batch_keys = ("points", "point_mask")

    def __init__(self, args: dict):
        super().__init__()
        a = args
        norm = a.get("norm", "batch")
        self.SecondEncoder_0 = second_encoder(a)
        feat_num = a.get("ssfa", {}).get("feature_num", 128)
        self.input_proj = ConvNormAct(self.SecondEncoder_0.out_channels,
                                      feat_num, 3, 1, norm=norm)
        self.ssfa = SSFA(feat_num, feat_num, norm)
        self.heads = DetectionHeads(
            feat_num, anchor_number=a["anchor_number"],
            use_dir="dir_args" in a,
            num_bins=a.get("dir_args", {}).get("num_bins", 2),
            use_iou=True)  # the IoU-aware branch is CIA-SSD's point

    def forward(self, batch: dict) -> dict:
        bev = self.SecondEncoder_0(*flat_agents(batch))
        feat = self.ssfa(self.input_proj(bev.permute(0, 3, 1, 2)))
        out = self.heads(feat)
        out["spatial_features_2d"] = feat.permute(0, 2, 3, 1)
        return out
