"""Window self-attention of V2X-ViT's MSwin branches (torch).

``window_attention`` is the core of one branch, softmax(q k^T / sqrt(dh)
+ bias) v inside every window x window tile of the map. For f32 eval
forwards on the card it is kernel 4 (csrc/window_attention.cu), one
launch. It reads q, k and v from the fused projection's token layout
(N, H, W, 3, heads, dh) in place, computes each logit's relative-position
bias index from the two tokens' offset, keeps the logits on chip and
writes (N, H, W, heads * dh). ``window_attention_plain`` is its plain
version: the windows' partition, the bias gathered through
:func:`window_rel_index`, ``models/layers.dot_product_attention`` (so
``_BiasedAttention``'s chunked backward) and the merge; it is the path
of the CPU, of training and of bf16.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import build
from ..models.layers import dot_product_attention

# the (window, head width) pairs kernel 4 is built for: V2X-ViT's
# published branches (4, 16), (8, 32) and (16, 64), and the flat form's
# windows 2, 4 and 8 at 8 heads of C / 8, C = 64 to 512
KERNEL4_SHAPES = frozenset(
    [(ws, dh) for ws in (2, 4, 8) for dh in (8, 16, 32, 64)] + [(16, 64)])


def window_rel_index(ws: int, device=None) -> torch.Tensor:
    """(ws^2, ws^2) int64 index of the (dy, dx) offset of token j from
    token i of a window into the (2 ws - 1)^2 table:
    (yj - yi + ws - 1) * (2 ws - 1) + (xj - xi + ws - 1)."""
    r = torch.arange(ws, device=device)
    y, x = (t.reshape(-1) for t in torch.meshgrid(r, r, indexing="ij"))
    return ((y[None, :] - y[:, None] + ws - 1) * (2 * ws - 1)
            + x[None, :] - x[:, None] + ws - 1)


def window_attention_plain(qkv, table, window: int, heads: int, dh: int,
                           rel_idx=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_attention` (same arguments),
    in any dtype and with gradients; ``rel_idx`` is the flat offset index
    (:func:`window_rel_index`, made on the table's device when None)."""
    n, h, w = qkv.shape[:3]
    ws, t = window, window * window
    if rel_idx is None:
        rel_idx = window_rel_index(ws, table.device).reshape(-1)
    win = qkv.reshape(n, h // ws, ws, w // ws, ws, 3, heads, dh)
    win = win.permute(0, 1, 3, 2, 4, 5, 6, 7).reshape(-1, t, 3, heads, dh)
    q, k, v = win.unbind(2)
    bias = table[rel_idx].reshape(t, t, heads).permute(2, 0, 1)[None]
    o = dot_product_attention(q, k, v, bias=bias.to(qkv.dtype))
    o = o.reshape(n, h // ws, w // ws, ws, ws, heads * dh)
    return o.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, heads * dh)


def window_attention(qkv, table, window: int, heads: int, dh: int,
                     rel_idx=None) -> torch.Tensor:
    """Window self-attention of the fused projection ``qkv`` (N, H, W, 3,
    heads, dh), H and W multiples of ``window``, with the relative-position
    ``table`` ((2 window - 1)^2, heads) -> (N, H, W, heads * dh).

    On the card, in f32, with no gradient wanted, it is kernel 4
    (csrc/window_attention.cu): one launch, only for the (window, head
    width) pairs of ``KERNEL4_SHAPES`` (it raises at others and at a map
    that is not whole windows); q is scaled by the f32 reciprocal of
    sqrt(dh), as the plain version's division by a Python scalar is
    computed on the card; the tracer counts each launch as
    ``kernel4.launches``. Everywhere else (the CPU, training, bf16) it is
    :func:`window_attention_plain`, which reads the offsets through
    ``rel_idx``."""
    if not build.takes_kernel(qkv, table):
        return window_attention_plain(qkv, table, window, heads, dh, rel_idx)
    if (window, dh) not in KERNEL4_SHAPES:
        raise ValueError(f"window_attention: no kernel for window {window}, "
                         f"head width {dh}")
    n, h, w = qkv.shape[:3]
    span = 2 * window - 1
    build.expect("window_attention", (
        (qkv, (n, h, w, 3, heads, dh), torch.float32),
        (table, (span * span, heads), torch.float32)), aligned=(qkv,))
    if h % window or w % window:
        raise ValueError(f"window_attention: window {window} does not "
                         f"divide the {h}x{w} map")
    out = torch.empty((n, h, w, heads * dh), dtype=torch.float32,
                      device=qkv.device)
    scale = float(np.float32(1.0) / np.float32(math.sqrt(dh)))
    build.launch("window_attention", "window_attention", "kernel4.launches",
                 out, qkv, table, out, n, h, w, heads, window, dh, scale)
    return out


def window_attention_ops(qkv, table, window: int, heads: int, dh: int,
                         rel_idx=None) -> int:
    """Operations of one :func:`window_attention` call (same arguments):
    the q k^T and P V products, as the plain version's."""
    n, h, w = qkv.shape[:3]
    return 4 * n * h * w * window * window * heads * dh
