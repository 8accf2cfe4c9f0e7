"""Single-scale collaborative fusion methods (torch).

Counterpart of heal_tpu/models/fuse/fusion_in_one.py: MaxFusion
(F-Cooper), AttFusion (AttFuse), DiscoFusion (DiscoNet), V2VNetFusion,
Where2commFusion, Who2comFusion; V2X-ViT and CoBEVT live in v2xvit.py and
cobevt.py, When2com and TransformerFusion in legacy.py.

The contract is JAX's: features (B, L, H, W, C) NHWC with agent_mask
(B, L) bool, slot 0 the ego, affine (B, L, L, 2, 3) normalized pairwise
matrices. Every module first warps all agents into the ego frame
(ops/warp.py; on a CUDA tensor that is the shear warp on kernel 2) and
masks padded slots out of its reduction: softmaxes get NEG_INF logits,
maxes NEG_INF features, means divide by the true agent count. Each module
returns the fused (B, H, W, C') map. Unlike flax, a torch module needs its
input width when it is built: ``channels`` is the width of ``features``.
Submodule names follow the flax paths (``ConvNormAct_0``, ``msg_cnn``,
``mha``, ``Dense_1`` ...), so utils/bridge.py loads a heal_tpu
checkpoint strictly.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.warp import warp_agents_to_ego, warp_pairwise
from ..layers import (Conv, ConvNormAct, Dense, LayerNorm,
                      MultiHeadDotProductAttention)
from .where2comm_comm import CommMask, apply_comm_mask

NEG_INF = -1e9


def build_fusion(method: str, args: dict, channels: int,
                 max_cav: int | None = None) -> nn.Module:
    """The fusion module of the config's ``fusion_method`` (heal_tpu
    fusion_in_one.py:30-69, the same keys and defaults). ``channels``: the
    width of the features it fuses; ``max_cav``: the agent axis L, which
    sizes CoBEVT's relative-position table."""
    args = dict(args or {})
    if method == "v2xvit":
        from .v2xvit import V2XViTFusion

        return V2XViTFusion(args, channels)
    if method == "cobevt":
        from .cobevt import CoBEVTFusion

        return CoBEVTFusion(args, channels, max_cav)
    if method == "when2com":
        from .legacy import When2comFusion

        return When2comFusion(args, channels)
    if method == "transformer":
        from .legacy import TransformerFusion

        return TransformerFusion(args, channels)
    agg = args.get("agg_operator") or {}
    table = {
        "max": lambda: MaxFusion(),
        "att": lambda: AttFusion(),
        "disconet": lambda: DiscoFusion(args.get("in_channels", 64),
                                        channels),
        "v2vnet": lambda: V2VNetFusion(args, channels),
        "where2comm": lambda: Where2commFusion(
            channels,
            threshold=args.get("threshold", 0.01),
            gaussian_smooth=args.get("gaussian_smooth", True),
            smooth_sigma=args.get("smooth_sigma", 1.0),
            agg_mode=str(agg.get("mode", "transformer")).lower(),
            num_heads=agg.get("n_head", 8),
            with_spe=agg.get("with_spe", False),
        ),
        "who2com": lambda: Who2comFusion(args.get("in_channels", 64),
                                         channels),
    }
    if method not in table:
        raise KeyError(f"unknown fusion method {method!r}")
    return table[method]()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _agents(agent_mask: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, L, 1, 1, 1), broadcastable over (B, L, H, W, C)."""
    return agent_mask[:, :, None, None, None]


class MaxFusion(nn.Module):
    """Elementwise max over ego-warped agent features (F-Cooper)."""

    def forward(self, features, affine, agent_mask):
        warped = warp_agents_to_ego(features, affine)
        return torch.where(_agents(agent_mask), warped, NEG_INF).amax(1)


class ScaledDotProductAttention(nn.Module):
    """Per-pixel agent-axis self-attention (ref fuse_modules/self_attn.py):
    x (B, L, H, W, C), mask (B, L) -> (B, L, H, W, C)."""

    def forward(self, x, mask):
        c = x.shape[-1]
        logits = torch.einsum("blhwc,bmhwc->bhwlm", x, x) / math.sqrt(c)
        logits = torch.where(mask[:, None, None, None, :], logits, NEG_INF)
        attn = torch.softmax(logits, dim=-1)
        return torch.einsum("bhwlm,bmhwc->blhwc", attn, x)


class AttFusion(nn.Module):
    """Per-pixel scaled-dot-product attention across agents; ego output."""

    def __init__(self):
        super().__init__()
        self.ScaledDotProductAttention_0 = ScaledDotProductAttention()

    def forward(self, features, affine, agent_mask):
        warped = warp_agents_to_ego(features, affine)
        warped = warped * _agents(agent_mask)
        return self.ScaledDotProductAttention_0(warped, agent_mask)[:, 0]


class DiscoFusion(nn.Module):
    """Pixel-weight MLP over (neighbour, ego) concat + agent softmax
    (DiscoNet; ref disco_fuse.PixelWeightLayer)."""

    def __init__(self, feature_dims: int, channels: int,
                 norm: str = "batch"):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(2 * channels, feature_dims, 1,
                                         norm=norm)
        self.ConvNormAct_1 = ConvNormAct(feature_dims, 32, 1, norm=norm)
        self.Conv_0 = Conv(32, 1, 1)

    def forward(self, features, affine, agent_mask):
        b, l, h, w, c = features.shape
        warped = warp_agents_to_ego(features, affine)
        ego = warped[:, 0:1].expand(warped.shape)
        cat = torch.cat([warped, ego], dim=-1).reshape(b * l, h, w, 2 * c)
        x = self.ConvNormAct_1(self.ConvNormAct_0(_nchw(cat)))
        logit = _nhwc(self.Conv_0(x)).reshape(b, l, h, w, 1)
        logit = torch.where(_agents(agent_mask), logit, NEG_INF)
        weight = torch.softmax(logit, dim=1)
        return (warped * weight).sum(1)


class ConvGRUCell(nn.Module):
    """Convolutional GRU cell (ref sub_modules/convgru.py), NHWC."""

    def __init__(self, cin: int, hidden_dim: int, kernel: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.Conv_0 = Conv(cin + hidden_dim, 2 * hidden_dim, kernel)
        self.Conv_1 = Conv(cin + hidden_dim, hidden_dim, kernel)

    def forward(self, x, h):
        zr = _nhwc(self.Conv_0(_nchw(torch.cat([x, h], dim=-1))))
        z, r = torch.split(torch.sigmoid(zr), self.hidden_dim, dim=-1)
        n = torch.tanh(_nhwc(self.Conv_1(_nchw(torch.cat([x, r * h],
                                                         dim=-1)))))
        return (1 - z) * h + z * n


class V2VNetFusion(nn.Module):
    """Iterative ConvGRU message passing over the agent graph
    (ref fusion_in_one.py:203-318), all pairs in one ``warp_pairwise``
    call per iteration; the senders' fields of view are a pairwise warp of
    ones (one more call)."""

    def __init__(self, args: dict, channels: int):
        super().__init__()
        c = args["in_channels"]
        self.num_iter = args.get("num_iteration", 2)
        self.agg = args.get("agg_operator", "avg")
        self.gru_flag = args.get("gru_flag", True)
        k = args.get("conv_gru", {}).get("kernel_size", [[3, 3]])[0][0]
        self.msg_cnn = Conv(2 * channels, c, 3)
        # flax creates no parameters for the GRU when it never runs
        self.ConvGRUCell_0 = ConvGRUCell(c, c, k) if self.gru_flag else None
        self.mlp = Dense(c, c)

    def forward(self, features, affine, agent_mask):
        b, l, h, w, c = features.shape
        ones = features.new_ones((b, l, h, w, 1))
        roi = warp_pairwise(ones, affine)  # (B, I, J, h, w, 1)
        mvalid = agent_mask[:, None, :, None, None, None].to(features.dtype)
        node = features
        for _ in range(self.num_iter):
            warped = warp_pairwise(node, affine)  # (B, I, J, h, w, C)
            ego_i = node[:, :, None].expand(warped.shape)
            msg = self.msg_cnn(_nchw(torch.cat([warped, ego_i], dim=-1)
                                     .reshape(b * l * l, h, w, 2 * c)))
            msg = _nhwc(msg).reshape(b, l, l, h, w, -1) * roi * mvalid
            if self.agg == "avg":
                denom = torch.clamp(agent_mask.sum(1).to(msg.dtype), min=1.0)
                agg_f = msg.sum(2) / denom[:, None, None, None, None]
            else:
                agg_f = torch.where(mvalid > 0, msg, NEG_INF).amax(2)
            if self.gru_flag:
                new = self.ConvGRUCell_0(agg_f.reshape(b * l, h, w, -1),
                                         node.reshape(b * l, h, w, c))
            else:
                new = node + agg_f
            node = new.reshape(b, l, h, w, -1)
        return self.mlp(node[:, 0])


def sinusoidal_pe(h: int, w: int, c: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """2D sine/cosine positional map (H, W, C) (ref where2comm_attn.py
    add_pe_map): C/2 dims encode y, C/2 x, sin on even and cos on odd
    slots over a 10000^k ladder. Needs C % 4 == 0."""
    assert c % 4 == 0, f"sinusoidal_pe needs channels % 4 == 0, got {c}"
    d = c // 2
    dim_t = 10000.0 ** (2 * (torch.arange(d, device=device) // 2) / d)
    y = torch.arange(1, h + 1, dtype=torch.float32,
                     device=device)[:, None] / dim_t
    x = torch.arange(1, w + 1, dtype=torch.float32,
                     device=device)[:, None] / dim_t

    def interleave(p):
        return torch.stack([torch.sin(p[:, 0::2]), torch.cos(p[:, 1::2])],
                           dim=-1).reshape(p.shape[0], -1)

    py, px = interleave(y), interleave(x)
    pos = torch.cat([py[:, None, :].expand(h, w, d),
                     px[None, :, :].expand(h, w, d)], dim=-1)
    return pos.to(dtype)


class Where2commFusion(nn.Module):
    """Confidence-masked transmission + configurable aggregation
    (ref where2comm_attn.py agg modes MAX / ATTEN / Transformer and
    comm_modules/where2comm.py).

    With ``confidence`` (B, L, H, W, 1), non-ego agents send only the
    cells whose smoothed confidence exceeds the threshold (CommMask), and
    the call returns (fused, comm_rate); with ``comm_mask`` that mask is
    applied as it is; with neither, the features go as they are.
    """

    def __init__(self, channels: int, num_heads: int = 8,
                 threshold: float = 0.01, gaussian_smooth: bool = True,
                 smooth_sigma: float = 1.0, agg_mode: str = "transformer",
                 with_spe: bool = False):
        super().__init__()
        self.agg_mode = agg_mode
        self.with_spe = with_spe
        self.CommMask_0 = CommMask(threshold=threshold,
                                   gaussian_smooth=gaussian_smooth,
                                   smooth_sigma=smooth_sigma)
        if agg_mode == "atten":
            self.ScaledDotProductAttention_0 = ScaledDotProductAttention()
        elif agg_mode not in ("max",):
            c = channels
            self.mha = MultiHeadDotProductAttention(c, num_heads)
            self.LayerNorm_0 = LayerNorm(c)
            # flax names the outer Dense first: Dense_1 runs first
            self.Dense_1 = Dense(c, c)
            self.Dense_0 = Dense(c, c)
            self.LayerNorm_1 = LayerNorm(c)

    def forward(self, features, affine, agent_mask, confidence=None,
                comm_mask=None):
        b, l, h, w, c = features.shape
        comm_rate = None
        if comm_mask is not None:
            features = apply_comm_mask(features, comm_mask)
        elif confidence is not None:
            mask, comm_rate = self.CommMask_0(confidence)
            # gate in the SENDER frame, before the warp
            features = apply_comm_mask(features, mask)
        warped = warp_agents_to_ego(features, affine)
        if self.agg_mode == "max":
            out = torch.where(_agents(agent_mask), warped, NEG_INF).amax(1)
        elif self.agg_mode == "atten":
            gated = warped * _agents(agent_mask)
            out = self.ScaledDotProductAttention_0(gated, agent_mask)[:, 0]
        else:
            q, k = warped[:, 0:1], warped
            if self.with_spe:
                pe = sinusoidal_pe(h, w, c, warped.dtype, warped.device)
                q, k = q + pe, k + pe  # values stay raw
            q_ = q.permute(0, 2, 3, 1, 4).reshape(b * h * w, 1, c)
            k_ = k.permute(0, 2, 3, 1, 4).reshape(b * h * w, l, c)
            v_ = warped.permute(0, 2, 3, 1, 4).reshape(b * h * w, l, c)
            kv_mask = agent_mask[:, None, None, :].expand(b, h * w, 1, l)
            kv_mask = kv_mask.reshape(b * h * w, 1, 1, l)
            fused = self.mha(q_, k_, v_, mask=kv_mask).reshape(b, h, w, c)
            y = self.LayerNorm_0(fused + q[:, 0])
            ff = self.Dense_0(F.relu(self.Dense_1(y)))
            out = self.LayerNorm_1(y + ff)
        if comm_rate is not None:
            return out, comm_rate
        return out


class Who2comFusion(nn.Module):
    """Agent attention + a conv decode of the (ego, attended) concat
    (ref fusion_in_one.py:486-538)."""

    def __init__(self, feature_dims: int, channels: int):
        super().__init__()
        self.ScaledDotProductAttention_0 = ScaledDotProductAttention()
        self.decode_layer = Conv(2 * channels, feature_dims, 3)

    def forward(self, features, affine, agent_mask):
        warped = warp_agents_to_ego(features, affine)
        warped = warped * _agents(agent_mask)
        att = self.ScaledDotProductAttention_0(warped, agent_mask)[:, 0]
        cat = torch.cat([features[:, 0], att], dim=-1)
        return _nhwc(self.decode_layer(_nchw(cat)))
