"""Feature aligner (torch): heal_tpu/models/aligner.py ``AlignNet``.

The adapter HEAL's stage 2 trains for a new agent type so that its BEV
features land in the frozen base's feature space. Backends, by
``core_method``, with ``args.num_of_blocks`` (or ``depth``, default 3)
blocks, named as flax's compact modules name them:

  * ``identity``;
  * ``res1x1`` / ``res3x3``: ``ResBlock1x1_i`` / ``ResBlock3x3_i``, two
    ``ConvNormAct`` (the second without ReLU) and relu(x + h);
  * ``convnext``: ``ConvNeXtBlock_i``, a depthwise 7x7 ``Conv_0`` ->
    ``LayerNorm_0`` -> ``Dense_0`` (4x) -> tanh GELU -> ``Dense_1`` ->
    x + ``gamma`` * h.

These are the aligners the shipped configs use. ``scaligner``, ``sdta``,
``cbam`` and ``fanet`` (aligner.py:58-236) are not ported yet and raise.
Modules take NCHW, as the rest of the port.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, ConvNormAct, Dense, LayerNorm

_NOT_PORTED = ("scaligner", "sdta", "cbam", "fanet")


class _ResBlock(nn.Module):
    def __init__(self, dim: int, kernel: int, norm: str = "batch"):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(dim, dim, kernel, 1, norm=norm)
        self.ConvNormAct_1 = ConvNormAct(dim, dim, kernel, 1, norm=norm,
                                         act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x + self.ConvNormAct_1(self.ConvNormAct_0(x)))


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.Conv_0 = Conv(dim, dim, 7, groups=dim)
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim)
        self.Dense_1 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(self.Conv_0(x).permute(0, 2, 3, 1))
        h = self.Dense_1(F.gelu(self.Dense_0(h), approximate="tanh"))
        return x + (self.gamma * h).permute(0, 3, 1, 2)


class AlignNet(nn.Module):
    """args: ``{core_method, args: {num_of_blocks | depth}}`` (None:
    identity); ``dim``: the channels of the features it aligns (JAX passes
    the branch backbone's last ``num_filters``)."""

    def __init__(self, args: dict | None, dim: int = 64,
                 norm: str = "batch"):
        super().__init__()
        method = (args or {}).get("core_method", "identity")
        sub = (args or {}).get("args", {}) or {}
        depth = sub.get("num_of_blocks", sub.get("depth", 3))
        if method in ("res1x1", "res3x3"):
            kernel, name = (1, "ResBlock1x1") if method == "res1x1" else (
                3, "ResBlock3x3")
            for i in range(depth):
                self.add_module(f"{name}_{i}", _ResBlock(dim, kernel, norm))
        elif method == "convnext":
            for i in range(depth):
                self.add_module(f"ConvNeXtBlock_{i}", ConvNeXtBlock(dim))
        elif method in _NOT_PORTED:
            raise NotImplementedError(
                f"aligner core_method {method!r} is not ported yet: ROADMAP "
                "queue 1, item 12"
            )
        elif method != "identity":
            raise KeyError(f"unknown aligner core_method {method!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x
