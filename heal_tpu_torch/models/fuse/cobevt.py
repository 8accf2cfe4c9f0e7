"""CoBEVT fusion (torch): window and grid ("swap") attention over agents
and pixels.

Counterpart of heal_tpu/models/fuse/cobevt.py (ref fusion_in_one.py:
374-429 + swap_fusion_modules.py SwapFusionBlockMask): alternating local
window and dilated global grid attention whose token set spans every
agent (L * s^2 tokens), with the 3-D (agent, dy, dx) relative-position
bias; the head averages the valid agents and projects. As in JAX,
padded agents are zeroed before the first block but not masked out of
the attention (see SwapAttention). The (2L-1)(2s-1)^2 bias table is sized by the agent
axis L, so the module is built for the config's ``max_cav``.

The attention is plain torch (flax's ``dot_product_attention``): at the
published width a window holds 5 * 8^2 = 320 tokens, and the softmax
probabilities of one pass over a batch of 2 take ~3.4 GB.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.warp import warp_agents_to_ego
from ..layers import (Dense, Dropout, LayerNorm, MultiHeadDotProductAttention,
                      gelu)


def rel_pos_index(l: int, s: int) -> np.ndarray:
    """(L s^2, L s^2) index into the (2L-1)(2s-1)^2 table of the
    (agent, dy, dx) offset between two window tokens."""
    coords = np.stack(np.meshgrid(np.arange(l), np.arange(s), np.arange(s),
                                  indexing="ij"), -1).reshape(-1, 3)
    rel = coords[None, :, :] - coords[:, None, :]
    rel += np.array([l - 1, s - 1, s - 1])
    return (rel[..., 0] * (2 * s - 1) * (2 * s - 1)
            + rel[..., 1] * (2 * s - 1) + rel[..., 2])


class SwapAttention(nn.Module):
    """One axial attention pass. mode "window": the tokens are the L s^2
    cells of each local s x s window; "grid": those of a dilated global
    grid."""

    def __init__(self, dim: int, size: int, agents: int, heads: int = 8,
                 mode: str = "window", dropout: float = 0.0):
        super().__init__()
        self.size, self.heads, self.mode = size, heads, mode
        self.rel_pos_bias = nn.Parameter(torch.empty(
            (2 * agents - 1) * (2 * size - 1) ** 2, heads))
        self.flax_init = {"rel_pos_bias": ("normal", 0.02)}
        self.register_buffer("rel_idx", torch.from_numpy(
            rel_pos_index(agents, size).reshape(-1)), persistent=False)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads)
        self.Dropout_0 = Dropout(dropout)
        self.agents = agents

    def _bias(self, l: int) -> torch.Tensor:
        if l != self.agents:
            raise ValueError(f"SwapAttention built for {self.agents} agents, "
                             f"called with {l}")
        n = l * self.size ** 2
        bias = self.rel_pos_bias[self.rel_idx].reshape(n, n, self.heads)
        return bias.permute(2, 0, 1)[None]

    def forward(self, x):
        """x (B, L, H, W, C) -> (B, L, H, W, C)."""
        b, l, h, w, c = x.shape
        s = self.size
        ph, pw = (-h) % s, (-w) % s
        xp = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        if self.mode == "window":
            t = xp.reshape(b, l, hp // s, s, wp // s, s, c)
            t = t.permute(0, 2, 4, 1, 3, 5, 6)  # (B, nh, nw, L, s, s, C)
        else:  # grid: dilated partition
            t = xp.reshape(b, l, s, hp // s, s, wp // s, c)
            t = t.permute(0, 3, 5, 1, 2, 4, 6)
        nh, nw = t.shape[1], t.shape[2]
        tokens = t.reshape(b * nh * nw, l * s * s, c)
        # no key mask: JAX builds one, but flax's MHA filters the kwargs
        # of a custom attention_fn by name, and the ``**kw`` of its lambda
        # takes none, so the mask never reaches the softmax; the padded
        # agents' tokens (zeros before the first LayerNorm) are attended
        out = self.MultiHeadDotProductAttention_0(
            tokens, bias=self._bias(l).to(tokens.dtype))
        out = self.Dropout_0(out).reshape(b, nh, nw, l, s, s, c)
        if self.mode == "window":
            out = out.permute(0, 3, 1, 4, 2, 5, 6)
        else:
            out = out.permute(0, 3, 4, 1, 5, 2, 6)
        return out.reshape(b, l, hp, wp, c)[:, :, :h, :w]


class SwapFusionBlock(nn.Module):
    def __init__(self, dim: int, window: int, agents: int,
                 dropout: float = 0.0):
        super().__init__()
        for i in range(4):
            self.add_module(f"LayerNorm_{i}", LayerNorm(dim))
        for i, mode in enumerate(("window", "grid")):
            self.add_module(f"SwapAttention_{i}", SwapAttention(
                dim, window, agents, mode=mode, dropout=dropout))
            self.add_module(f"Dense_{2 * i}", Dense(dim, 2 * dim))
            self.add_module(f"Dense_{2 * i + 1}", Dense(2 * dim, dim))
            for j in range(2):
                self.add_module(f"Dropout_{2 * i + j}", Dropout(dropout))

    def _ffn(self, y, i):
        y = getattr(self, f"Dropout_{2 * i}")(
            gelu(getattr(self, f"Dense_{2 * i}")(y)))
        return getattr(self, f"Dropout_{2 * i + 1}")(
            getattr(self, f"Dense_{2 * i + 1}")(y))

    def forward(self, x):
        for i in range(2):
            y = getattr(self, f"LayerNorm_{2 * i}")(x)
            x = x + getattr(self, f"SwapAttention_{i}")(y)
            y = getattr(self, f"LayerNorm_{2 * i + 1}")(x)
            x = x + self._ffn(y, i)
        return x


class CoBEVTFusion(nn.Module):
    """args: window_size, depth, and the dropout key ``drop_out`` (or
    ``dropout``) of the SwapFusionBlockMask stack."""

    def __init__(self, args: dict, channels: int, max_cav: int | None):
        super().__init__()
        if max_cav is None:
            raise ValueError("CoBEVT's relative-position table is sized by "
                             "the agent axis: build it with max_cav")
        cfg = args or {}
        depth = cfg.get("depth", 2)
        window = cfg.get("window_size", 4)
        dropout = float(cfg.get("drop_out", cfg.get("dropout", 0.0)))
        c = channels
        for i in range(depth):
            self.add_module(f"block_{i}", SwapFusionBlock(c, window, max_cav,
                                                          dropout=dropout))
        self.depth = depth
        self.LayerNorm_0 = LayerNorm(c)
        self.Dense_0 = Dense(c, c)

    def forward(self, features, affine, agent_mask):
        x = warp_agents_to_ego(features, affine)
        x = x * agent_mask[:, :, None, None, None]
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        m = agent_mask[:, :, None, None, None].to(x.dtype)
        pooled = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        return self.Dense_0(self.LayerNorm_0(pooled))
