"""Reference of the ``v2xvit`` configuration: V2X-ViT (Xu et al., ECCV
2022, arXiv:2203.10638) as HEAL runs it in its OPV2V LiDAROnly family,
over PointPillars agents: every agent's points -> PillarVFE -> ResNet
BEV backbone -> shrink (``model.py``), the maps warped into the ego's
frame (``warp.py``), V2X-ViT, the ego's fused map -> cls / reg / dir
heads.

V2X-ViT is written here from its published description (the paper's
section 3 and the source's ``v2xvit_basic.py``, ``hmsa.py``,
``mswin.py``, ``split_attn.py``), with the program's parameter names and
layouts, so that one seeded state dict loads strictly into both. It
imports nothing of the program and calls no kernel. Each layer of
``depth``, ``num_blocks`` times then once:

  * HMSA (``hmsa.py`` HGTCavAttention), pre-norm, residual: per pixel,
    attention of each receiver i over the senders j (padded slots get no
    weight), with the q / k / v / out projections of each agent's type
    and, on each edge, the (type i, type j) relation matrices, inside
    the bilinear form (q_i W_att k_j / sqrt(dh)) and the message
    (v_j W_msg); written as an explicit loop over the edges;
  * MSwin (``mswin.py`` PyramidWindowAttention), pre-norm, residual:
    one window self-attention a branch, each with its own window, heads
    and head width and a relative-position bias, each its own reshape
    into windows and softmax; the branches fused by split attention
    (``split_attn.py``: the pooled branch sum -> linear -> LayerNorm ->
    ReLU -> linear to 3C -> a softmax over the branches per channel);
  * the feed-forward, pre-norm, residual: linear to ``mlp_dim``, GELU,
    linear back.

Departures from the source, each also under the configuration's
``assumed`` (``configs/v2xvit.json``):

  * the relative-position bias: one table a head, ((2 ws - 1)^2, heads),
    where the source shares one (2 ws - 1, 2 ws - 1) table among a
    branch's heads. The program keeps the layout of the repo's JAX
    package; a shared table is the case of equal columns;
  * the window attention's q / k / v projections carry a bias, where
    the source's ``to_qkv`` has none (its output projection has one, as
    here). Also the JAX package's layout: seeded weights set the biases
    apart from zero;
  * the mask: whole agents (``agent_mask``) in HMSA, where the source
    with ``use_roi_mask`` true masks each sender's pixels outside its
    warped range. In the served scenes every collaborator lies within
    20 m of the ego, so its range covers most of the ego's map;
  * the GELU is the tanh form (flax's ``nn.gelu``, as the program takes
    it), where the source's ``nn.GELU`` is exact;
  * every LayerNorm takes eps 1e-6 (flax's), the source's PyTorch ones
    1e-5;
  * the ego's fused map is LayerNormed after the last layer, as the
    program does; the source's ``V2XTransformer`` returns the ego's
    slice as it is;
  * the warp into the ego's frame comes before V2X-ViT (``warp.py``),
    where the source's STTF warps inside the encoder; the time-delay
    encoding (``use_RTE``) is off, as the configuration sets it, and
    the prior encoding's types are all 0 (every agent a vehicle, as the
    source runs OPV2V).

Windows must divide the map (the source's rearrange needs it too).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import warp
from .assemble import to_device  # noqa: F401  (the harness's entry)
from .model import Backbone, Dense, Heads, LayerNorm, PillarVFE, Shrink


class Linear(nn.Module):
    """x @ kernel (in, out), no bias."""

    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))

    def forward(self, x):
        return x @ self.kernel


class Typed(nn.Module):
    """One linear map an agent type: kernel (T, in, out), bias (T, out)."""

    def __init__(self, types, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(types, cin, cout))
        self.bias = nn.Parameter(torch.zeros(types, cout))

    def forward(self, x, t):
        """x (B, ..., in) of agents of types t (B,) -> (B, ..., out)."""
        w = self.kernel[t]
        y = (x.reshape(x.shape[0], -1, x.shape[-1]) @ w).reshape(
            x.shape[:-1] + (w.shape[-1],))
        return y + self.bias[t].reshape((-1,) + (1,) * (x.dim() - 2)
                                        + (w.shape[-1],))


class HMSA(nn.Module):
    """Heterogeneous multi-agent self-attention over the agent axis."""

    def __init__(self, dim, heads, dim_head, types):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dh = heads, dim_head
        self.q = Typed(types, dim, inner)
        self.k = Typed(types, dim, inner)
        self.v = Typed(types, dim, inner)
        shape = (types, types, heads, dim_head, dim_head)
        self.relation_att = nn.Parameter(torch.empty(shape))
        self.relation_msg = nn.Parameter(torch.empty(shape))
        self.proj = Typed(types, inner, dim)

    def forward(self, x, agent_mask, types):
        """x (B, L, H, W, C); agent_mask (B, L); types (B, L) ->
        (B, L, H, W, C)."""
        b, l, h, w, _ = x.shape
        m, dh = self.heads, self.dh
        split = (b, h, w, m, dh)
        q = [self.q(x[:, i], types[:, i]).reshape(split) for i in range(l)]
        k = [self.k(x[:, j], types[:, j]).reshape(split) for j in range(l)]
        v = [self.v(x[:, j], types[:, j]).reshape(split) for j in range(l)]
        out = []
        for i in range(l):                      # receiver
            logits, msgs = [], []
            for j in range(l):                  # sender
                w_att = self.relation_att[types[:, i], types[:, j]]
                w_msg = self.relation_msg[types[:, i], types[:, j]]
                # (B, H, W, M, dh) x (B, M, dh, dh), head by head
                qa = torch.einsum("bhwmp,bmpq->bhwmq", q[i], w_att)
                logits.append((qa * k[j]).sum(-1) / math.sqrt(dh))
                msgs.append(torch.einsum("bhwmp,bmpq->bhwmq", v[j], w_msg))
            logits = torch.stack(logits, -1)    # (B, H, W, M, L)
            logits = logits.masked_fill(
                ~agent_mask[:, None, None, None, :], float("-inf"))
            a = torch.softmax(logits, -1)
            o = sum(a[..., j, None] * msgs[j] for j in range(l))
            out.append(self.proj(o.reshape(b, h, w, m * dh), types[:, i]))
        return torch.stack(out, 1)


class Attention(nn.Module):
    """The q / k / v / out projections of one window branch, by the
    program's names: query, key, value kernels (C, heads, dh) with
    (heads, dh) biases; out kernel (heads, dh, C) with a (C,) bias."""

    def __init__(self, dim, heads, dh):
        super().__init__()
        for name in ("query", "key", "value"):
            self.add_module(name, _Proj((dim, heads, dh), (heads, dh)))
        self.out = _Proj((heads, dh, dim), (dim,))


class _Proj(nn.Module):
    def __init__(self, kernel, bias):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel))
        self.bias = nn.Parameter(torch.zeros(bias))


class WindowBranch(nn.Module):
    """Self-attention inside non-overlapping ws x ws windows, with a
    learned bias for each (dy, dx) offset between two tokens, a head."""

    def __init__(self, dim, ws, heads, dh):
        super().__init__()
        self.ws, self.heads, self.dh = ws, heads, dh
        self.rel_pos_bias = nn.Parameter(torch.empty((2 * ws - 1) ** 2,
                                                     heads))
        self.MultiHeadDotProductAttention_0 = Attention(dim, heads, dh)

    def forward(self, x):
        """x (N, H, W, C) -> (N, H, W, C)."""
        n, h, w, c = x.shape
        ws, m, dh = self.ws, self.heads, self.dh
        if h % ws or w % ws:
            raise ValueError(f"window {ws} does not divide the {h}x{w} map")
        att = self.MultiHeadDotProductAttention_0

        def project(p):
            y = torch.einsum("nhwc,cmd->nhwmd", x, p.kernel) + p.bias
            # -> (N, windows down, windows across, M, ws*ws, dh)
            y = y.reshape(n, h // ws, ws, w // ws, ws, m, dh)
            return y.permute(0, 1, 3, 5, 2, 4, 6).reshape(
                n, h // ws, w // ws, m, ws * ws, dh)

        q, k, v = project(att.query), project(att.key), project(att.value)
        # offset (dy, dx) of token j from token i, each in [0, 2 ws - 2]
        r = torch.arange(ws, device=x.device)
        yy, xx = torch.meshgrid(r, r, indexing="ij")
        yy, xx = yy.reshape(-1), xx.reshape(-1)
        dy = yy[None, :] - yy[:, None] + ws - 1
        dx = xx[None, :] - xx[:, None] + ws - 1
        table = self.rel_pos_bias.reshape(2 * ws - 1, 2 * ws - 1, m)
        bias = table[dy, dx].permute(2, 0, 1)          # (M, T, T)
        dots = q @ k.transpose(-1, -2) / math.sqrt(dh) + bias
        o = torch.softmax(dots, -1) @ v                 # (N, nh, nw, M, T, dh)
        o = o.reshape(n, h // ws, w // ws, m, ws, ws, dh)
        o = o.permute(0, 1, 4, 2, 5, 3, 6).reshape(n, h, w, m * dh)
        return o @ att.out.kernel.reshape(m * dh, c) + att.out.bias


class SplitAttn(nn.Module):
    def __init__(self, dim, radix):
        super().__init__()
        self.dim, self.radix = dim, radix
        self.Dense_0 = Linear(dim, dim)
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_1 = Linear(dim, radix * dim)

    def forward(self, branches):
        gap = torch.stack(branches).sum(0).mean((1, 2), keepdim=True)
        gap = F.relu(self.LayerNorm_0(self.Dense_0(gap)))
        logits = self.Dense_1(gap)                      # (N, 1, 1, R*C)
        gate = torch.softmax(logits.unflatten(-1, (self.radix, self.dim)),
                             -2)
        return sum(gate[..., r, :] * br for r, br in enumerate(branches))


class MSwin(nn.Module):
    def __init__(self, dim, windows, heads, dim_heads):
        super().__init__()
        self.windows = list(windows)
        for ws, m, dh in zip(windows, heads, dim_heads):
            self.add_module(f"win{ws}", WindowBranch(dim, ws, m, dh))
        self.split_attn = SplitAttn(dim, len(self.windows))

    def forward(self, x):
        return self.split_attn([getattr(self, f"win{ws}")(x)
                                for ws in self.windows])


class Block(nn.Module):
    """num_blocks x (x + HMSA(LN x), then x + MSwin(LN x))."""

    def __init__(self, dim, enc, types):
        super().__init__()
        cav, win = enc["cav_att_config"], enc["pwindow_att_config"]
        self.n = enc["num_blocks"]
        for i in range(self.n):
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(dim))
            self.add_module(f"hmsa_{i}", HMSA(dim, cav["heads"],
                                              cav["dim_head"], types))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(dim))
            self.add_module(f"mswin_{i}", MSwin(
                dim, win["window_size"], win["heads"], win["dim_head"]))

    def forward(self, x, agent_mask, types):
        b, l, h, w, c = x.shape
        for i in range(self.n):
            x = x + getattr(self, f"hmsa_{i}")(
                getattr(self, f"LayerNorm_{2 * i}")(x), agent_mask, types)
            flat = x.reshape(b * l, h, w, c)
            flat = flat + getattr(self, f"mswin_{i}")(
                getattr(self, f"LayerNorm_{2 * i + 1}")(flat))
            x = flat.reshape(b, l, h, w, c)
        return x


class V2XViT(nn.Module):
    """The published ``transformer.encoder`` block over the agents' maps
    in the ego's frame -> the ego's fused map (B, H, W, C)."""

    def __init__(self, args, dim):
        super().__init__()
        enc = args["transformer"]["encoder"]
        types = args["num_types"]
        self.depth = enc["depth"]
        mlp = enc["feed_forward"]["mlp_dim"]
        for i in range(self.depth):
            self.add_module(f"block_{i}", Block(dim, enc, types))
            self.add_module(f"LayerNorm_{i}", LayerNorm(dim))
            self.add_module(f"Dense_{2 * i}", Dense(dim, mlp))
            self.add_module(f"Dense_{2 * i + 1}", Dense(mlp, dim))
        self.add_module(f"LayerNorm_{self.depth}", LayerNorm(dim))

    def forward(self, x, affine, agent_mask, types=None):
        """x (B, L, H, W, C) every agent's map in its own frame; types
        (B, L) agent types (None: all 0)."""
        if types is None:
            types = torch.zeros(agent_mask.shape, dtype=torch.long,
                                device=x.device)
        x = warp.to_ego(x, affine) * agent_mask[:, :, None, None, None]
        b, l, h, w, c = x.shape
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, agent_mask, types.long())
            flat = x.reshape(b * l, h, w, c)
            y = getattr(self, f"LayerNorm_{i}")(flat)
            y = getattr(self, f"Dense_{2 * i + 1}")(F.gelu(
                getattr(self, f"Dense_{2 * i}")(y), approximate="tanh"))
            x = (flat + y).reshape(b, l, h, w, c)
        return getattr(self, f"LayerNorm_{self.depth}")(x[:, 0])


class PointPillarV2XViT(nn.Module):
    """``point_pillar_baseline`` with ``fusion_method: v2xvit``: the
    program's module names (PointPillarEncoder_0, ResNetBEVBackbone_0,
    DownsampleConv_0, V2XViTFusion_0, DetectionHeads_0)."""

    def __init__(self, args: dict):
        super().__init__()
        self.PointPillarEncoder_0 = PillarVFE(args)
        self.ResNetBEVBackbone_0 = Backbone(
            self.PointPillarEncoder_0.out_channels, args["base_bev_backbone"])
        self.DownsampleConv_0 = Shrink(self.ResNetBEVBackbone_0.out_channels,
                                       args["shrink_header"])
        dim = args["shrink_header"]["dim"][-1]
        self.V2XViTFusion_0 = V2XViT(args["v2xvit"], dim)
        self.DetectionHeads_0 = Heads(dim, args["anchor_number"],
                                      args["dir_args"]["num_bins"])

    def forward(self, batch: dict) -> dict:
        mask = batch["agent_mask"]
        b, l = mask.shape
        bev = self.PointPillarEncoder_0(batch["points"].flatten(0, 1),
                                        batch["point_mask"].flatten(0, 1))
        feat = self.DownsampleConv_0(self.ResNetBEVBackbone_0(
            bev.permute(0, 3, 1, 2)))
        feat = feat.permute(0, 2, 3, 1).unflatten(0, (b, l))
        fused = self.V2XViTFusion_0(feat, batch["pairwise_affine"], mask)
        return self.DetectionHeads_0(fused.permute(0, 3, 1, 2))


def build(hypes: dict):
    args = hypes["model"]["args"]
    if hypes["model"]["core_method"] != "point_pillar_baseline" or \
            args.get("fusion_method") != "v2xvit":
        raise ValueError("the v2xvit reference builds point_pillar_baseline "
                         "with fusion_method v2xvit")
    return PointPillarV2XViT(args)
