"""V2X-ViT fusion (torch): the heterogeneous multi-agent transformer.

Counterpart of heal_tpu/models/fuse/v2xvit.py (ref sub_modules/
v2xvit_basic.py, hmsa.py, mswin.py, split_attn.py):

* HMSA is typed: each agent takes the q / k / v / out projections of its
  agent TYPE, and each sender -> receiver edge a learned relation matrix
  of its (receiver type, sender type) pair, inside both the attention
  bilinear form and the message transform. Shuffling which slot holds
  which type permutes the fusion and never changes it.
* MSwin: window attention at several window sizes, each with a relative
  position bias, fused by radix split-attention.
* Block structure: depth x [num_blocks x (PreNorm HMSA + residual,
  PreNorm MSwin + residual), PreNorm FFN + residual], then the ego's
  LayerNorm.

The L x L edges are batched in one contraction per projection, where JAX
unrolls them (same terms, another summation order).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.warp import warp_agents_to_ego
from ..layers import (Dense, Dropout, LayerNorm, MultiHeadDotProductAttention,
                      gelu)

NEG_INF = -1e9


def type_onehot(agent_types, num_types: int, l: int, dtype):
    """(B, L) int types -> (B, L, T) one-hot, clipped to num_types - 1;
    None -> None (every agent type 0)."""
    if agent_types is None:
        return None
    t = torch.clamp(agent_types[:, :l].long(), 0, num_types - 1)
    return F.one_hot(t, num_types).to(dtype)


class TypedDense(nn.Module):
    """Per-agent-type linear layer: kernel (T, C, D) and bias (T, D),
    the type's row picked by a (B, L, T) one-hot."""

    def __init__(self, cin: int, features: int, num_types: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_types, cin, features))
        self.bias = nn.Parameter(torch.zeros(num_types, features))
        self.flax_init = {"kernel": ("lecun", num_types * cin)}

    def forward(self, x, type_oh):
        # x (B, L, H, W, C); type_oh (B, L, T) or None
        if type_oh is None:
            return x @ self.kernel[0] + self.bias[0]
        w = torch.einsum("blt,tcd->blcd", type_oh, self.kernel)
        b = torch.einsum("blt,td->bld", type_oh, self.bias)
        return (torch.einsum("blhwc,blcd->blhwd", x, w)
                + b[:, :, None, None, :])


class HMSA(nn.Module):
    """Heterogeneous multi-agent self-attention (HGT-style): per-pixel
    attention over the agent axis with typed projections and per-edge
    relation matrices (ref hmsa.py HGTCavAttention)."""

    def __init__(self, dim: int, heads: int = 8, num_types: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        self.dim, self.heads, self.num_types = dim, heads, num_types
        dh = dim // heads
        self.q = TypedDense(dim, dim, num_types)
        self.k = TypedDense(dim, dim, num_types)
        self.v = TypedDense(dim, dim, num_types)
        shape = (num_types, num_types, heads, dh, dh)
        self.relation_att = nn.Parameter(torch.empty(shape))
        self.relation_msg = nn.Parameter(torch.empty(shape))
        # flax xavier_uniform over (..., dh_in, dh_out): the leading axes
        # are its receptive field
        field = num_types * num_types * heads
        self.flax_init = {"relation_att": ("xavier", dh * field, dh * field),
                          "relation_msg": ("xavier", dh * field, dh * field)}
        self.proj = TypedDense(dim, dim, num_types)
        self.Dropout_0 = Dropout(dropout)

    def forward(self, x, mask, agent_types=None):
        b, l, h, w, c = x.shape
        m, dh = self.heads, self.dim // self.heads
        type_oh = type_onehot(agent_types, self.num_types, l, x.dtype)
        q = self.q(x, type_oh).reshape(b, l, h, w, m, dh)
        k = self.k(x, type_oh).reshape(b, l, h, w, m, dh)
        v = self.v(x, type_oh).reshape(b, l, h, w, m, dh)
        if type_oh is None:
            w_att = self.relation_att[0, 0].expand(b, l, l, m, dh, dh)
            w_msg = self.relation_msg[0, 0].expand(b, l, l, m, dh, dh)
        else:
            # (B, I, J, T, T): one-hot of (type_i, type_j) per edge
            edge = torch.einsum("bit,bju->bijtu", type_oh, type_oh)
            w_att = torch.einsum("bijtu,tumde->bijmde", edge,
                                 self.relation_att)
            w_msg = torch.einsum("bijtu,tumde->bijmde", edge,
                                 self.relation_msg)
        scale = 1.0 / np.sqrt(dh)
        # logits[b, m, h, w, i, j] = (q_i W_att[i, j]) . k_j
        qw = torch.einsum("bihwmd,bijmde->bijhwme", q, w_att)
        logits = torch.einsum("bijhwme,bjhwme->bmhwij", qw, k) * scale
        logits = torch.where(mask[:, None, None, None, None, :], logits,
                             NEG_INF)
        attn = torch.softmax(logits, dim=-1)
        # msgs[b, i, j] = v_j W_msg[i, j]
        msgs = torch.einsum("bjhwmd,bijmde->bijhwme", v, w_msg)
        out = torch.einsum("bmhwij,bijhwme->bihwme", attn, msgs)
        out = self.proj(out.reshape(b, l, h, w, self.dim), type_oh)
        return self.Dropout_0(out)


def window_rel_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index of the (dy, dx) offset between two window
    tokens into the (2 ws - 1)^2 table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"), -1).reshape(-1, 2)
    rel = coords[None, :, :] - coords[:, None, :] + ws - 1
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


class WindowAttention(nn.Module):
    """Non-overlapping window self-attention with a relative-position
    bias (ref mswin.py BaseWindowAttention)."""

    def __init__(self, dim: int, window: int, heads: int = 8,
                 dropout: float = 0.0):
        super().__init__()
        self.window, self.heads = window, heads
        self.rel_pos_bias = nn.Parameter(torch.empty((2 * window - 1) ** 2,
                                                     heads))
        self.flax_init = {"rel_pos_bias": ("normal", 0.02)}
        self.register_buffer("rel_idx", torch.from_numpy(
            window_rel_index(window).reshape(-1)), persistent=False)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads)
        self.Dropout_0 = Dropout(dropout)

    def forward(self, x):
        # x (N, H, W, C), H and W multiples of the window (caller pads)
        n, h, w, c = x.shape
        ws = self.window
        x = x.reshape(n, h // ws, ws, w // ws, ws, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        t = ws * ws
        bias = self.rel_pos_bias[self.rel_idx].reshape(t, t, self.heads)
        bias = bias.permute(2, 0, 1)[None].to(x.dtype)
        attn = self.Dropout_0(self.MultiHeadDotProductAttention_0(
            x, bias=bias))
        attn = attn.reshape(n, h // ws, w // ws, ws, ws, c)
        return attn.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)


class SplitAttn(nn.Module):
    """Radix split-attention over parallel branches: a per-channel radix
    softmax from the globally pooled branch sum (ref split_attn.py)."""

    def __init__(self, dim: int, radix: int):
        super().__init__()
        self.dim, self.radix = dim, radix
        self.Dense_0 = Dense(dim, dim, use_bias=False)
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_1 = Dense(dim, radix * dim, use_bias=False)

    def forward(self, branches):
        gap = sum(branches).mean(dim=(1, 2), keepdim=True)  # (N, 1, 1, C)
        gap = F.relu(self.LayerNorm_0(self.Dense_0(gap)))
        logits = self.Dense_1(gap)
        n = logits.shape[0]
        gate = torch.softmax(logits.reshape(n, 1, 1, self.radix, self.dim),
                             dim=3)
        return sum(gate[:, :, :, r] * br for r, br in enumerate(branches))


class MSwin(nn.Module):
    """Multi-scale window attention: parallel branches at several window
    sizes fused by split-attention (ref mswin.py PyramidWindowAttention)."""

    def __init__(self, dim: int, windows=(2, 4, 8), dropout: float = 0.0):
        super().__init__()
        self.windows = tuple(windows)
        for ws in self.windows:
            self.add_module(f"win{ws}", WindowAttention(dim, ws,
                                                        dropout=dropout))
        self.split_attn = SplitAttn(dim, len(self.windows))

    def forward(self, x):
        n, h, w, c = x.shape
        outs = []
        for ws in self.windows:
            xp = F.pad(x, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
            outs.append(getattr(self, f"win{ws}")(xp)[:, :h, :w])
        return self.split_attn(outs)


class V2XViTBlock(nn.Module):
    """num_blocks x (PreNorm HMSA -> PreNorm MSwin), each residual
    (ref v2xvit_basic.py V2XFusionBlock)."""

    def __init__(self, dim: int, num_blocks: int = 1, num_types: int = 4,
                 windows=(2, 4, 8), dropout: float = 0.0):
        super().__init__()
        self.num_blocks = num_blocks
        for n in range(num_blocks):
            self.add_module(f"LayerNorm_{2 * n}", LayerNorm(dim))
            self.add_module(f"hmsa_{n}", HMSA(dim, num_types=num_types,
                                              dropout=dropout))
            self.add_module(f"LayerNorm_{2 * n + 1}", LayerNorm(dim))
            self.add_module(f"mswin_{n}", MSwin(dim, windows,
                                                dropout=dropout))

    def forward(self, x, mask, agent_types=None):
        b, l, h, w, c = x.shape
        for n in range(self.num_blocks):
            y = getattr(self, f"LayerNorm_{2 * n}")(x)
            x = x + getattr(self, f"hmsa_{n}")(y, mask, agent_types)
            flat = x.reshape(b * l, h, w, c)
            y = getattr(self, f"LayerNorm_{2 * n + 1}")(flat)
            flat = flat + getattr(self, f"mswin_{n}")(y)
            x = flat.reshape(b, l, h, w, c)
        return x


class V2XViTFusion(nn.Module):
    """args: transformer {encoder {num_blocks, depth, cav_att_config
    {dropout}}} or flat {depth, num_blocks, num_types, windows, dropout}."""

    def __init__(self, args: dict, channels: int):
        super().__init__()
        cfg = args or {}
        enc = cfg.get("transformer", {}).get("encoder", {})
        self.depth = enc.get("depth", cfg.get("depth", 2))
        num_blocks = enc.get("num_blocks", cfg.get("num_blocks", 1))
        num_types = cfg.get("num_types", 4)
        windows = tuple(cfg.get("windows", (2, 4, 8)))
        dropout = float(enc.get("cav_att_config", {}).get(
            "dropout", cfg.get("cav_att_config", {}).get(
                "dropout", cfg.get("dropout", 0.0))))
        c = channels
        for i in range(self.depth):
            self.add_module(f"block_{i}", V2XViTBlock(
                c, num_blocks=num_blocks, num_types=num_types,
                windows=windows, dropout=dropout))
            self.add_module(f"LayerNorm_{i}", LayerNorm(c))
            self.add_module(f"Dense_{2 * i}", Dense(c, 2 * c))
            self.add_module(f"Dense_{2 * i + 1}", Dense(2 * c, c))
            self.add_module(f"Dropout_{2 * i}", Dropout(dropout))
            self.add_module(f"Dropout_{2 * i + 1}", Dropout(dropout))
        self.add_module(f"LayerNorm_{self.depth}", LayerNorm(c))

    def forward(self, features, affine, agent_mask, agent_types=None):
        x = warp_agents_to_ego(features, affine)
        x = x * agent_mask[:, :, None, None, None]
        b, l, h, w, c = x.shape
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, agent_mask, agent_types)
            flat = x.reshape(b * l, h, w, c)
            y = getattr(self, f"LayerNorm_{i}")(flat)
            y = getattr(self, f"Dropout_{2 * i}")(
                gelu(getattr(self, f"Dense_{2 * i}")(y)))
            y = getattr(self, f"Dropout_{2 * i + 1}")(
                getattr(self, f"Dense_{2 * i + 1}")(y))
            x = (flat + y).reshape(b, l, h, w, c)
        return getattr(self, f"LayerNorm_{self.depth}")(x[:, 0])
