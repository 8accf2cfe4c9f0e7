"""ResNet BEV backbone with the multiscale encode/decode split (torch).

Counterpart of heal_tpu/models/resnet_bev.py: ResNet stages producing
per-level features, transposed-conv deblocks upsampling each level back
to the level-0 stride, concatenated along channels; with more
``upsample_strides`` than levels, the last deblock runs on the
concatenation (resnet_bev.py:74-75; flax builds no parameters for the
ones in between, which are never called). NCHW.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import DeconvNormAct, ResNetStage


class ResNetBEVBackbone(nn.Module):
    def __init__(self, cin: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[int] = (),
                 num_upsample_filter: Sequence[int] = (),
                 resnext: bool = False, norm: str = "batch",
                 width_per_group: int = 4):
        super().__init__()
        self.num_levels = len(layer_nums)
        c = cin
        for i in range(self.num_levels):
            self.add_module(f"stages_{i}", ResNetStage(
                c, num_filters[i], layer_nums[i], stride=layer_strides[i],
                norm=norm, bottleneck_x=resnext,
                width_per_group=width_per_group,
            ))
            c = num_filters[i]
        self.num_deblocks = len(upsample_strides)
        for i in range(min(self.num_deblocks, self.num_levels)):
            self.add_module(f"deblocks_{i}", DeconvNormAct(
                num_filters[i], num_upsample_filter[i], upsample_strides[i],
                norm=norm,
            ))
        self.out_channels = sum(
            num_upsample_filter[i] if i < self.num_deblocks else num_filters[i]
            for i in range(self.num_levels)
        )
        self.trailing = None
        if self.num_deblocks > self.num_levels:
            self.trailing = f"deblocks_{self.num_deblocks - 1}"
            self.add_module(self.trailing, DeconvNormAct(
                self.out_channels, num_upsample_filter[-1],
                upsample_strides[-1], norm=norm,
            ))
            self.out_channels = num_upsample_filter[-1]

    def encode(self, x: torch.Tensor) -> list[torch.Tensor]:
        """-> list of per-level features (NCHW)."""
        feats = []
        for i in range(self.num_levels):
            x = getattr(self, f"stages_{i}")(x)
            feats.append(x)
        return feats

    def decode(self, feats: list[torch.Tensor]) -> torch.Tensor:
        """Upsample each level and concat channels -> (N, sum C, H0, W0)."""
        ups = []
        for i in range(self.num_levels):
            f = feats[i]
            if i < self.num_deblocks:
                f = getattr(self, f"deblocks_{i}")(f)
            ups.append(f)
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if self.trailing is not None:
            x = getattr(self, self.trailing)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))
