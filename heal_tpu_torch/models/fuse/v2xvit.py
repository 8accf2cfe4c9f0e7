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

Widths come from the config in either of two forms (``V2XViTFusion``):
the flat form the repo's generated configs use (8 HMSA heads of C/8,
MSwin windows (2, 4, 8) with 8 heads of C/8 each, a 2C feed-forward),
or the published ``transformer.encoder`` block, whose HMSA heads and
head width, per-branch MSwin windows, heads and head widths and
feed-forward width are read as written.

The L x L edges are batched in one contraction per projection, where JAX
unrolls them (same terms, another summation order).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ... import trace
from ...ops import window_attention as wa
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
                 dropout: float = 0.0, dim_head: int | None = None):
        super().__init__()
        dh = dim // heads if dim_head is None else dim_head
        self.heads, self.dim_head, self.num_types = heads, dh, num_types
        inner = heads * dh
        self.q = TypedDense(dim, inner, num_types)
        self.k = TypedDense(dim, inner, num_types)
        self.v = TypedDense(dim, inner, num_types)
        shape = (num_types, num_types, heads, dh, dh)
        self.relation_att = nn.Parameter(torch.empty(shape))
        self.relation_msg = nn.Parameter(torch.empty(shape))
        # flax xavier_uniform over (..., dh_in, dh_out): the leading axes
        # are its receptive field
        field = num_types * num_types * heads
        self.flax_init = {"relation_att": ("xavier", dh * field, dh * field),
                          "relation_msg": ("xavier", dh * field, dh * field)}
        self.proj = TypedDense(inner, dim, num_types)
        self.Dropout_0 = Dropout(dropout)

    def forward(self, x, mask, agent_types=None):
        b, l, h, w, c = x.shape
        m, dh = self.heads, self.dim_head
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
        out = self.proj(out.reshape(b, l, h, w, m * dh), type_oh)
        return self.Dropout_0(out)


class WindowAttention(nn.Module):
    """Non-overlapping window self-attention with a relative-position
    bias (ref mswin.py BaseWindowAttention): ``heads`` heads of
    ``dim_head`` (default dim / heads) over ``window`` x ``window``
    tokens, projected back to ``dim``.

    The q, k and v projections run as one product into a (N, H, W, 3,
    heads, dim_head) buffer (the three kernels joined at call time, so
    the parameters keep flax's layout), the out projection as its own
    module over the tokens. The attention is one call of
    ``ops/window_attention.window_attention``, which takes kernel 4 or
    its plain version (which reads the offsets through ``rel_idx``)."""

    def __init__(self, dim: int, window: int, heads: int = 8,
                 dropout: float = 0.0, dim_head: int | None = None):
        super().__init__()
        dim_head = dim // heads if dim_head is None else dim_head
        self.window, self.heads, self.dim_head = window, heads, dim_head
        self.rel_pos_bias = nn.Parameter(torch.empty((2 * window - 1) ** 2,
                                                     heads))
        self.flax_init = {"rel_pos_bias": ("normal", 0.02)}
        self.register_buffer("rel_idx", wa.window_rel_index(window).reshape(
            -1), persistent=False)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, heads, heads * dim_head)
        self.Dropout_0 = Dropout(dropout)

    def _qkv(self, x):
        """(N, H, W, C) -> (N, H, W, 3, heads, dh): the q, k and v
        projections in one product (each its own under a model axis,
        where each gathers its slice)."""
        mha = self.MultiHeadDotProductAttention_0
        parts = (mha.query, mha.key, mha.value)
        if any(p.tp is not None for p in parts):
            return torch.stack([p(x) for p in parts], -3)
        c, m, dh = mha.query.kernel.shape
        kernel = torch.cat([p.kernel.reshape(c, m * dh) for p in parts], 1)
        bias = torch.cat([p.bias.reshape(m * dh) for p in parts])
        y = torch.addmm(bias, x.reshape(-1, c), kernel)
        return y.reshape(*x.shape[:-1], 3, m, dh)

    def forward(self, x):
        # x (N, H, W, C), H and W multiples of the window (caller pads)
        m, dh = self.heads, self.dim_head
        o = wa.window_attention(self._qkv(x), self.rel_pos_bias,
                                self.window, m, dh, self.rel_idx)
        return self.Dropout_0(self.MultiHeadDotProductAttention_0.out(
            o.unflatten(-1, (m, dh))))


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
    sizes fused by split-attention (ref mswin.py PyramidWindowAttention).

    ``windows``: the branches' window sizes, one branch ``win<size>``
    each. ``heads`` and ``dim_head``: one per branch (the published
    form: [16, 8, 4] heads of [16, 32, 64] over windows [4, 8, 16]), or
    one for every branch; the flat form's default is 8 heads of
    dim / 8 in each."""

    def __init__(self, dim: int, windows=(2, 4, 8), dropout: float = 0.0,
                 heads=8, dim_head=None):
        super().__init__()
        self.windows = tuple(windows)
        n = len(self.windows)
        heads = _per_branch(heads, n, "heads")
        dim_head = _per_branch(dim_head, n, "dim_head")
        if len(set(self.windows)) != n:
            raise ValueError(f"MSwin windows {self.windows} repeat a size")
        for ws, m, dh in zip(self.windows, heads, dim_head):
            self.add_module(f"win{ws}", WindowAttention(
                dim, ws, heads=m, dropout=dropout, dim_head=dh))
        self.split_attn = SplitAttn(dim, n)

    def forward(self, x):
        n, h, w, c = x.shape
        outs = []
        for ws in self.windows:
            ph, pw = (-h) % ws, (-w) % ws
            xp = F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x
            outs.append(getattr(self, f"win{ws}")(xp)[:, :h, :w])
        return self.split_attn(outs)


def _per_branch(value, n: int, name: str) -> list:
    """One value a branch: a list of ``n`` as it is, a scalar (or None)
    repeated."""
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"MSwin {name} {list(value)} is not one a "
                             f"window ({n} windows)")
        return [int(v) for v in value]
    return [value] * n


class V2XViTBlock(nn.Module):
    """num_blocks x (PreNorm HMSA -> PreNorm MSwin), each residual
    (ref v2xvit_basic.py V2XFusionBlock). ``hmsa`` and ``mswin``: the
    keyword arguments of each block's :class:`HMSA` and :class:`MSwin`
    beyond ``dim``."""

    def __init__(self, dim: int, num_blocks: int = 1,
                 hmsa: dict | None = None, mswin: dict | None = None):
        super().__init__()
        self.num_blocks = num_blocks
        for n in range(num_blocks):
            self.add_module(f"LayerNorm_{2 * n}", LayerNorm(dim))
            self.add_module(f"hmsa_{n}", HMSA(dim, **(hmsa or {})))
            self.add_module(f"LayerNorm_{2 * n + 1}", LayerNorm(dim))
            self.add_module(f"mswin_{n}", MSwin(dim, **(mswin or {})))

    def forward(self, x, mask, agent_types=None):
        b, l, h, w, c = x.shape
        for n in range(self.num_blocks):
            with trace.span("v2xvit.hmsa"):
                y = getattr(self, f"LayerNorm_{2 * n}")(x)
                x = x + getattr(self, f"hmsa_{n}")(y, mask, agent_types)
            with trace.span("v2xvit.mswin"):
                flat = x.reshape(b * l, h, w, c)
                y = getattr(self, f"LayerNorm_{2 * n + 1}")(flat)
                flat = flat + getattr(self, f"mswin_{n}")(y)
                x = flat.reshape(b, l, h, w, c)
        return x


# keys of the published ``transformer.encoder`` block that the port reads
# no value from, each with the reason
NOT_ACTED_ON = {
    "sttf": "the port warps every agent into the ego's frame before the "
            "fusion (ops/warp.warp_agents_to_ego), where the source's STTF "
            "warps inside the encoder",
    "use_roi_mask": "the port masks whole agents (agent_mask), where the "
                    "source with true masks each sender's pixels outside "
                    "its warped range",
    "use_RTE": "the time-delay encoding: the port's frames carry no delay; "
               "true raises, since the source then adds a learned term",
    "RTE_ratio": "the time-delay encoding's scale, read only with use_RTE",
}
# the keys each nested group of the published block may hold
_GROUPS = {
    "cav_att_config": {"dim", "heads", "dim_head", "dropout", "use_hetero",
                       "use_RTE", "RTE_ratio"},
    "pwindow_att_config": {"dim", "heads", "dim_head", "window_size",
                           "relative_pos_embedding", "fusion_method",
                           "dropout"},
    "feed_forward": {"mlp_dim", "dropout"},
}
_ENCODER = {"depth", "num_blocks", *_GROUPS, *NOT_ACTED_ON}


def _unknown(where: str, keys, known) -> None:
    extra = sorted(set(keys) - set(known))
    if extra:
        raise ValueError(f"V2X-ViT: unknown key(s) {extra} in {where}; "
                         f"known: {sorted(known)}")


def published_widths(cfg: dict, channels: int) -> dict:
    """The fusion's widths from ``cfg`` (``V2XViTFusion``'s args): the
    flat form's defaults, replaced by whatever the ``transformer.encoder``
    block states. Raises on a key the port does not know, on a width
    other than ``channels``, and on a choice it does not build
    (``use_hetero`` false, ``use_RTE`` true, ``relative_pos_embedding``
    false, a ``fusion_method`` other than ``split_attn``)."""
    tr = cfg.get("transformer")
    enc = {}
    if tr is not None:
        _unknown("transformer", tr, {"encoder"})
        enc = tr.get("encoder") or {}
        _unknown("transformer.encoder", enc, _ENCODER)
        for group, known in _GROUPS.items():
            _unknown(f"transformer.encoder.{group}", enc.get(group) or {},
                     known)
    cav = enc.get("cav_att_config") or {}
    win = enc.get("pwindow_att_config") or {}
    ff = enc.get("feed_forward") or {}
    for where, group in (("cav_att_config", cav),
                         ("pwindow_att_config", win)):
        if group.get("dim", channels) != channels:
            raise ValueError(f"V2X-ViT: {where}.dim {group['dim']} is not "
                             f"the fused maps' width {channels}")
    for where, group, key, need in (
            ("cav_att_config.", cav, "use_hetero", True),
            ("cav_att_config.", cav, "use_RTE", False),
            ("", enc, "use_RTE", False),
            ("pwindow_att_config.", win, "relative_pos_embedding", True),
            ("pwindow_att_config.", win, "fusion_method", "split_attn")):
        if key in group and group[key] != need:
            raise ValueError(f"V2X-ViT: {where}{key} {group[key]!r} is not "
                             f"built by the port (only {need!r})")
    if "windows" in cfg and "window_size" in win:
        raise ValueError("V2X-ViT: windows given twice (flat windows and "
                         "pwindow_att_config.window_size)")
    # flat form: one dropout for every part
    dropout = float(cav.get("dropout", (cfg.get("cav_att_config") or {})
                            .get("dropout", cfg.get("dropout", 0.0))))
    return {
        "depth": int(enc.get("depth", cfg.get("depth", 2))),
        "num_blocks": int(enc.get("num_blocks", cfg.get("num_blocks", 1))),
        "num_types": int(cfg.get("num_types", 4)),
        "hmsa": {"heads": int(cav.get("heads", 8)),
                 "dim_head": cav.get("dim_head"), "dropout": dropout},
        "mswin": {"windows": tuple(int(v) for v in win.get(
                      "window_size", cfg.get("windows", (2, 4, 8)))),
                  "heads": win.get("heads", 8),
                  "dim_head": win.get("dim_head"),
                  "dropout": float(win.get("dropout", dropout))},
        "mlp_dim": int(ff.get("mlp_dim", 2 * channels)),
        "ffn_dropout": float(ff.get("dropout", dropout)),
    }


class V2XViTFusion(nn.Module):
    """V2X-ViT over the agents' maps warped into the ego's frame.

    ``args`` in either form:

      * flat, as the repo's generated configs write it: ``depth`` (2),
        ``num_blocks`` (1), ``num_types`` (4), ``windows`` ((2, 4, 8)),
        ``dropout`` (0) or ``cav_att_config.dropout``; HMSA takes 8 heads
        of C/8, each MSwin branch 8 heads of C/8, the feed-forward 2C.
        Other keys at this level (the baselines' ``in_channels``) are not
        read;
      * published: ``transformer.encoder`` as V2X-ViT's yaml writes it
        (``depth``, ``num_blocks``, ``cav_att_config`` {dim, heads,
        dim_head, dropout, use_hetero}, ``pwindow_att_config`` {dim,
        heads, dim_head, window_size, relative_pos_embedding,
        fusion_method, dropout}, ``feed_forward`` {mlp_dim, dropout}), with
        ``num_types`` beside ``transformer`` as in the flat form. Each
        MSwin branch takes its own window, heads and head width; heads x
        dim_head may differ from C (projected back to C). The keys of
        :data:`NOT_ACTED_ON` are accepted and read no value; any other
        key in the block raises (:func:`published_widths`). A key the
        block leaves out takes the flat form's value.
    """

    def __init__(self, args: dict, channels: int):
        super().__init__()
        widths = published_widths(args or {}, channels)
        self.depth = widths["depth"]
        c, mlp = channels, widths["mlp_dim"]
        for i in range(self.depth):
            self.add_module(f"block_{i}", V2XViTBlock(
                c, num_blocks=widths["num_blocks"],
                hmsa=dict(widths["hmsa"], num_types=widths["num_types"]),
                mswin=widths["mswin"]))
            self.add_module(f"LayerNorm_{i}", LayerNorm(c))
            self.add_module(f"Dense_{2 * i}", Dense(c, mlp))
            self.add_module(f"Dense_{2 * i + 1}", Dense(mlp, c))
            self.add_module(f"Dropout_{2 * i}",
                            Dropout(widths["ffn_dropout"]))
            self.add_module(f"Dropout_{2 * i + 1}",
                            Dropout(widths["ffn_dropout"]))
        self.add_module(f"LayerNorm_{self.depth}", LayerNorm(c))

    def forward(self, features, affine, agent_mask, agent_types=None):
        with trace.span("fusion"):
            x = warp_agents_to_ego(features, affine)
            x = x * agent_mask[:, :, None, None, None]
            b, l, h, w, c = x.shape
            for i in range(self.depth):
                x = getattr(self, f"block_{i}")(x, agent_mask, agent_types)
                with trace.span("v2xvit.ffn"):
                    flat = x.reshape(b * l, h, w, c)
                    y = getattr(self, f"LayerNorm_{i}")(flat)
                    y = getattr(self, f"Dropout_{2 * i}")(
                        gelu(getattr(self, f"Dense_{2 * i}")(y)))
                    y = getattr(self, f"Dropout_{2 * i + 1}")(
                        getattr(self, f"Dense_{2 * i + 1}")(y))
                    x = (flat + y).reshape(b, l, h, w, c)
            return getattr(self, f"LayerNorm_{self.depth}")(x[:, 0])
