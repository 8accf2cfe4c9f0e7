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
    x + ``gamma`` * h;
  * ``scaligner``: ``ResMLPBlock_i``, ``LayerNorm_0`` then
    ``args.num_of_layers`` (default 2) ``Dense_j`` + GELU, residual;
  * ``sdta``: ``SDTABlock_i``, two per-channel 1x1 convs ``dwconv_j``
    with ReLU, cross-covariance attention over the channels (``xca``:
    the H*W tokens L2-normalised, a per-head ``temperature``) scaled by
    ``gamma_xca``, then an inverted-bottleneck MLP scaled by ``gamma``,
    residual on the block's input;
  * ``cbam``: ``CBAMBlock_i``, two 1x1 ``ConvNormAct``, channel then
    spatial attention (CBAM), relu(x + h);
  * ``fanet``: one ``FANet_0``, a U of five ``FALayer`` (``fa1`` ..
    ``fa5``) modulated by per-pixel gamma / beta from the detached input
    and its 2x max-pools, two ``skip`` convs; H and W must be multiples
    of 4.

flax's LayerNorm eps is 1e-6 and its GELU the tanh form. Modules take
NCHW, as the rest of the port.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, ConvNormAct, Dense, LayerNorm, SameConv, gelu


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


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class ResMLPBlock(nn.Module):
    """SCAligner's block (heal_tpu aligner.py:58-71)."""

    def __init__(self, dim: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        self.LayerNorm_0 = LayerNorm(dim)
        for j in range(num_layers):
            self.add_module(f"Dense_{j}", Dense(dim, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.LayerNorm_0(_nhwc(x))
        for j in range(self.num_layers):
            h = gelu(getattr(self, f"Dense_{j}")(h))
        return x + _nchw(h)


class XCA(nn.Module):
    """Cross-covariance attention over the channel axis with the N
    tokens as features (heal_tpu aligner.py:74-103): (B, N, C) ->
    (B, N, C)."""

    flax_init = {"temperature": ("constant", 1.0)}

    def __init__(self, dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h)
        # (B, h, d, N) each, L2-normalised over the N tokens
        q, k, v = (qkv[:, :, i].permute(0, 2, 3, 1) for i in range(3))
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1,
                                                     keepdim=True), min=1e-6)
        k = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1,
                                                     keepdim=True), min=1e-6)
        attn = torch.softmax(
            torch.einsum("bhdn,bhen->bhde", q, k) * self.temperature, dim=-1)
        out = torch.einsum("bhde,bhen->bhdn", attn, v)
        return self.proj(out.permute(0, 3, 1, 2).reshape(b, n, c))


class SDTABlock(nn.Module):
    """Split-depthwise-transpose-attention block (heal_tpu aligner.py
    :106-139)."""

    flax_init = {"gamma_xca": ("constant", 1e-6)}

    def __init__(self, dim: int, expan_ratio: int = 4, num_conv: int = 2,
                 num_heads: int = 4):
        super().__init__()
        self.num_conv = num_conv
        for j in range(num_conv):
            self.add_module(f"dwconv_{j}", Conv(dim, dim, 1, groups=dim))
        self.gamma_xca = nn.Parameter(torch.full((dim,), 1e-6))
        self.norm_xca = LayerNorm(dim)
        self.xca = XCA(dim, num_heads)
        self.norm = LayerNorm(dim)
        self.pwconv1 = Dense(dim, expan_ratio * dim)
        self.pwconv2 = Dense(expan_ratio * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        for j in range(self.num_conv):
            x = F.relu(getattr(self, f"dwconv_{j}")(x))
        b, c, hh, ww = x.shape
        tokens = _nhwc(x).reshape(b, hh * ww, c)
        tokens = tokens + self.gamma_xca * self.xca(self.norm_xca(tokens))
        h = self.norm(tokens.reshape(b, hh, ww, c))
        h = self.pwconv2(gelu(self.pwconv1(h)))
        return inp + _nchw(self.gamma * h)


class ChannelAttention(nn.Module):
    """CBAM's channel attention: a shared bias-free MLP on the spatial
    mean and max, sigmoid of the sum -> (B, C, 1, 1)."""

    def __init__(self, dim: int, ratio: int = 16):
        super().__init__()
        hidden = max(dim // ratio, 1)
        self.Dense_0 = Dense(dim, hidden, use_bias=False)
        self.Dense_1 = Dense(hidden, dim, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(t):
            return self.Dense_1(F.relu(self.Dense_0(t)))

        att = torch.sigmoid(mlp(x.mean((2, 3))) + mlp(x.amax((2, 3))))
        return att[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM's spatial attention: a bias-free 7x7 conv of the channel mean
    and max, sigmoid -> (B, 1, H, W)."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = SameConv(2, 1, 7)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stat = torch.cat([x.mean(1, keepdim=True),
                          x.amax(1, keepdim=True)], dim=1)
        return torch.sigmoid(self.Conv_0(stat))


class CBAMBlock(nn.Module):
    """heal_tpu aligner.py:168-183."""

    def __init__(self, dim: int, norm: str = "batch"):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(dim, dim, 1, 1, norm=norm)
        self.ConvNormAct_1 = ConvNormAct(dim, dim, 1, 1, norm=norm,
                                         act=False)
        self.ChannelAttention_0 = ChannelAttention(dim)
        self.SpatialAttention_0 = SpatialAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.ConvNormAct_1(self.ConvNormAct_0(x))
        h = h * self.ChannelAttention_0(h)
        h = h * self.SpatialAttention_0(h)
        return F.relu(x + h)


class FALayer(nn.Module):
    """An ARNet block (1x1, grouped 3x3 with 8 groups, 1x1) modulated by
    per-pixel gamma / beta from the guidance map (heal_tpu aligner.py
    :186-207)."""

    def __init__(self, in_dim: int, out_dim: int, img_dim: int):
        super().__init__()
        self.ar1 = Conv(in_dim, in_dim, 1)
        self.ar2 = Conv(in_dim, in_dim, 3, groups=8)
        self.ar3 = Conv(in_dim, out_dim, 1)
        self.conv1 = Conv(img_dim, img_dim, 1)
        self.conv2 = Conv(img_dim, out_dim, 1)
        self.conv3 = Conv(img_dim, out_dim, 1)

    def forward(self, feat: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        h = self.ar3(F.relu(self.ar2(F.relu(self.ar1(feat)))))
        inter = F.relu(self.conv1(img))
        return h * self.conv2(inter) + self.conv3(inter)


class FANet(nn.Module):
    """The U-shaped gamma / beta aligner (heal_tpu aligner.py:210-236);
    the guidance pyramid is the detached input and its 2x max-pools
    (VALID), the upsampling ``jax.image.resize`` bilinear, which is
    ``F.interpolate(align_corners=False)`` at 2x."""

    def __init__(self, dim: int):
        super().__init__()
        d = dim
        self.fa1 = FALayer(d, d, d)
        self.fa2 = FALayer(d, 2 * d, d)
        self.fa3 = FALayer(2 * d, 4 * d, d)
        self.fa4 = FALayer(4 * d, 2 * d, d)
        self.skip1 = Conv(2 * d, 2 * d, 1)
        self.fa5 = FALayer(2 * d, d, d)
        self.skip2 = Conv(d, d, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2] % 4 or x.shape[-1] % 4:
            raise ValueError(f"fanet needs H and W divisible by 4, got "
                             f"{tuple(x.shape[-2:])}")

        def pool(t):
            return F.max_pool2d(t, 2, 2)

        def up(t):
            return F.interpolate(t, scale_factor=2, mode="bilinear",
                                 align_corners=False)

        img0 = x.detach()
        img1 = pool(img0)
        img2 = pool(img1)
        f0 = self.fa1(x, img0)
        f1 = self.fa2(pool(f0), img1)
        f2 = self.fa3(pool(f1), img2)
        f3 = self.fa4(up(f2), img1) + self.skip1(f1)
        return self.fa5(up(f3), img0) + self.skip2(f0)


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
        elif method == "scaligner":
            layers = sub.get("num_of_layers", 2)
            for i in range(depth):
                self.add_module(f"ResMLPBlock_{i}", ResMLPBlock(dim, layers))
        elif method == "sdta":
            for i in range(depth):
                self.add_module(f"SDTABlock_{i}", SDTABlock(dim))
        elif method == "cbam":
            for i in range(depth):
                self.add_module(f"CBAMBlock_{i}", CBAMBlock(dim, norm))
        elif method == "fanet":
            self.FANet_0 = FANet(dim)
        elif method != "identity":
            raise KeyError(f"unknown aligner core_method {method!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.children():
            x = block(x)
        return x
