"""Legacy collaborative-fusion methods (torch): When2com and
TransformerFusion.

Counterpart of heal_tpu/models/fuse/legacy.py (ref when2com_fuse.py,
transformer_fuse.py) on the masked fixed-L contract of fusion_in_one.py.

When2com: each ego-warped agent map is summarised by a policy conv net
and key / query MLPs (the policy map pooled to a fixed 4 x 4 grid first,
the reference's km_generator_v2); a dot-product handshake, softmax over
the agents, weights the warped features. ``mode: activated`` drops the
links under ``threshold``.

TransformerFusion: a 2D sine positional encoding and one encoder layer in
which, per BEV pixel, the ego's token attends over the L agent tokens at
that pixel; senders outside their warped field of view are masked out.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.warp import warp_agents_to_ego
from ..layers import (ConvNormAct, Dense, LayerNorm,
                      MultiHeadDotProductAttention)

NEG_INF = -1e9


def sine_pe_2d(h: int, w: int, c: int, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """2D sinusoidal positional encoding (H, W, C) (ref
    transformer_fuse.add_pe_map): C/2 features for y, C/2 for x,
    interleaved sin / cos, temperature 10000, 1-based coordinates."""
    d = c // 2
    y = torch.arange(1, h + 1, dtype=torch.float32, device=device)
    x = torch.arange(1, w + 1, dtype=torch.float32, device=device)
    dim_t = torch.arange(d, dtype=torch.float32, device=device)
    dim_t = 10000.0 ** (2.0 * torch.div(dim_t, 2, rounding_mode="floor")
                        / d)
    py, px = y[:, None] / dim_t, x[:, None] / dim_t

    def interleave(p):
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                           dim=-1).reshape(*p.shape[:-1], -1)

    pos_y = interleave(py)[:, None, :].expand(h, w, d)
    pos_x = interleave(px)[None, :, :].expand(h, w, d)
    return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


class PolicyNet(nn.Module):
    """Conv summariser of a warped feature map (ref policy_net4): two
    stride-2 stages, NCHW -> (N, width, H/4, W/4)."""

    def __init__(self, cin: int, width: int = 256):
        super().__init__()
        for i, stride in enumerate((1, 2, 1, 2)):
            self.add_module(f"ConvNormAct_{i}",
                            ConvNormAct(cin if i == 0 else width, width, 3,
                                        stride))

    def forward(self, x):
        for i in range(4):
            x = getattr(self, f"ConvNormAct_{i}")(x)
        return x


def resize_weights(size_in: int, size_out: int) -> np.ndarray:
    """(size_in, size_out) weights of ``jax.image.resize(method="linear")``
    along one axis: a triangle kernel widened by the downsampling factor
    (antialiasing), normalised per output sample."""
    scale = size_out / size_in
    inv = 1.0 / scale
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(size_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(size_in)[:, None]) / kernel_scale
    wts = np.maximum(0.0, 1.0 - x)
    total = wts.sum(0, keepdims=True)
    wts = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                   wts / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= size_in - 0.5)
    return np.where(inside[None, :], wts, 0.0).astype(np.float32)


class KMGenerator(nn.Module):
    """Key / query vector from a policy map (ref km_generator_v2): a
    linear resize to a fixed grid, then a 3-layer MLP."""

    def __init__(self, channels: int, out_size: int, pool_hw=(4, 4)):
        super().__init__()
        self.pool_hw = tuple(pool_hw)
        ph, pw = self.pool_hw
        self.Dense_0 = Dense(ph * pw * channels, 256)
        self.Dense_1 = Dense(256, 128)
        self.Dense_2 = Dense(128, out_size)

    def forward(self, x):
        # x (N, h, w, C) NHWC
        n, h, w, _ = x.shape
        ph, pw = self.pool_hw
        if (h, w) != (ph, pw):
            wy = torch.from_numpy(resize_weights(h, ph)).to(x)
            wx = torch.from_numpy(resize_weights(w, pw)).to(x)
            x = torch.einsum("nhwc,hp,wq->npqc", x, wy, wx)
        x = F.relu(self.Dense_0(x.reshape(n, -1)))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class When2comFusion(nn.Module):
    """Learned-handshake fusion (When2com; ref when2com_fuse.py:16-131).
    With ``mode: activated`` the mean number of non-ego links used is
    kept in ``num_connect`` after each call."""

    def __init__(self, args: dict, channels: int):
        super().__init__()
        self.query_size = args.get("query_size", 32)
        self.key_size = args.get("key_size", 256)
        self.mode = args.get("mode", "softmax")
        self.threshold = args.get("threshold", 0.2)
        width = args.get("policy_width", 256)
        self.policy = PolicyNet(channels, width)
        self.key_net = KMGenerator(width, self.key_size)
        self.query_net = KMGenerator(width, self.query_size)
        self.q_proj = Dense(self.query_size, self.key_size)
        self.num_connect = None

    def forward(self, features, affine, agent_mask):
        b, l, h, w, c = features.shape
        warped = warp_agents_to_ego(features, affine)
        warped = warped * agent_mask[:, :, None, None, None]
        pmap = self.policy(warped.reshape(b * l, h, w, c).permute(0, 3, 1, 2))
        pmap = pmap.permute(0, 2, 3, 1)
        pmap = pmap.reshape((b, l) + pmap.shape[1:])
        keys = self.key_net(pmap.reshape((b * l,) + pmap.shape[2:]))
        keys = keys.reshape(b, l, self.key_size)
        query = self.query_net(pmap[:, 0])
        q = self.q_proj(query)
        logits = torch.einsum("blk,bk->bl", keys, q)
        logits = torch.where(agent_mask, logits, NEG_INF)
        attn = torch.softmax(logits, dim=1)
        if self.mode == "activated":
            coef = attn * (attn > self.threshold).to(attn.dtype)
            self.num_connect = (coef[:, 1:] > 0).sum(1).to(attn.dtype).mean()
        else:
            coef = attn
        return (warped * coef[:, :, None, None, None]).sum(1)


class TransformerFusion(nn.Module):
    """Per-pixel agent-axis transformer encoder layer with a 2D sine PE
    (ref transformer_fuse.py:35-206)."""

    def __init__(self, args: dict, channels: int):
        super().__init__()
        c = channels
        self.mha = MultiHeadDotProductAttention(c, args.get("n_head", 8))
        self.LayerNorm_0 = LayerNorm(c)
        # flax names the outer Dense first: Dense_1 runs first
        self.Dense_1 = Dense(c, c)
        self.Dense_0 = Dense(c, c)
        self.LayerNorm_1 = LayerNorm(c)

    def forward(self, features, affine, agent_mask):
        b, l, h, w, c = features.shape
        warped = warp_agents_to_ego(features, affine)
        # the senders' fields of view in the ego frame (ref roi_mask)
        roi = warp_agents_to_ego(features.new_ones((b, l, h, w, 1)), affine)
        valid = (roi[..., 0] > 0.5) & agent_mask[:, :, None, None]
        pe = sine_pe_2d(h, w, c, features.dtype, features.device)
        with_pe = warped + pe[None, None]
        q_ = with_pe[:, 0].reshape(b * h * w, 1, c)
        k_ = with_pe.permute(0, 2, 3, 1, 4).reshape(b * h * w, l, c)
        v_ = warped.permute(0, 2, 3, 1, 4).reshape(b * h * w, l, c)
        kv_mask = valid.permute(0, 2, 3, 1).reshape(b * h * w, 1, 1, l)
        ctx = self.mha(q_, k_, v_, mask=kv_mask).reshape(b, h, w, c)
        y = self.LayerNorm_0(ctx + warped[:, 0])
        ff = self.Dense_0(F.relu(self.Dense_1(y)))
        return self.LayerNorm_1(y + ff)
