"""Window self-attention of V2X-ViT's MSwin branches (torch).

``window_attention`` is kernel 4 (csrc/window_attention.cu): the core of
one branch, softmax(q k^T / sqrt(dh) + bias) v inside every window x
window tile of the map, in one launch for f32 eval forwards on the card.
It reads q, k and v from the fused projection's token layout
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

from .. import trace
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


def window_attention(qkv, table, window: int, heads: int,
                     dh: int) -> torch.Tensor:
    """Kernel 4: window self-attention of the fused projection ``qkv``
    (N, H, W, 3, heads, dh), H and W multiples of ``window``, with the
    relative-position ``table`` ((2 window - 1)^2, heads) -> (N, H, W,
    heads * dh). q is scaled by the f32 reciprocal of sqrt(dh), as the
    plain version's division by a Python scalar is computed on the card.

    f32 only, eval only: under a gradient it raises. On a CPU tensor it
    takes :func:`window_attention_plain`; on a CUDA tensor it launches
    csrc/window_attention.cu once or raises; only the (window, head
    width) pairs of ``KERNEL4_SHAPES`` are built. The tracer counts each
    launch as ``kernel4.launches``."""
    if torch.is_grad_enabled() and (qkv.requires_grad
                                    or table.requires_grad):
        raise RuntimeError(
            "window_attention has no backward (eval only): call it under "
            "torch.no_grad() / inference_mode, or use "
            "window_attention_plain")
    if qkv.device.type == "cpu":
        return window_attention_plain(qkv, table, window, heads, dh)
    if (window, dh) not in KERNEL4_SHAPES:
        raise ValueError(f"window_attention: no kernel for window {window}, "
                         f"head width {dh}")
    n, h, w = qkv.shape[:3]
    span = 2 * window - 1
    for t, shape in ((qkv, (n, h, w, 3, heads, dh)),
                     (table, (span * span, heads))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"window_attention: expected {shape} "
                             f"torch.float32, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.device != qkv.device:
            raise ValueError("window_attention: inputs must be contiguous, "
                             "one device")
    if h % window or w % window:
        raise ValueError(f"window_attention: window {window} does not "
                         f"divide the {h}x{w} map")
    if qkv.data_ptr() % 16:
        raise ValueError("window_attention: qkv must be 16-byte aligned")
    out = torch.empty((n, h, w, heads * dh), dtype=torch.float32,
                      device=qkv.device)
    scale = float(np.float32(1.0) / np.float32(math.sqrt(dh)))
    code = build.library().heal_window_attention_f32(
        qkv.data_ptr(), table.data_ptr(), out.data_ptr(), n, h, w, heads,
        window, dh, scale, build.stream_ptr(qkv.device))
    build.check(code, "window_attention")
    if out.numel():  # an empty batch launches nothing
        trace.count("kernel4.launches")
    return out
