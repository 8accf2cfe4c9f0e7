"""Kernel 2: per-row / per-column fractional shift with zero fill.

The building block of the 3-shear warp (ops/warp.affine_warp_shear). It
replaces the TPU kernel heal_tpu/ops/pallas_shear.py ``shift_rows_pallas``
and its custom VJP, and has the semantics of heal_tpu.ops.warp._shift_rows,
the form JAX runs off the TPU:

    out[n, i, j] = (1-f) * x[n, i, j+r] + f * x[n, i, j+r+1]

with b = clip(floor(s[n, i]), -pad, pad), f = s[n, i] - b, r = min(b,
pad-1), pad = max_shift + 2 (the row width + 2 without a bound), and
zeros outside the row. Callers clip shifts to +-max_shift, where r = b;
past that, r and f reproduce the clamped read of JAX's padded-row
dynamic slice. ``shift_cols`` is the same along columns with a shift per
(n, j).

Backward, as in the Pallas VJP (pallas_shear.py:71-72): the gradient of x
is the same shift run with -s on the output gradient, with the same
max_shift; the shifts get none (they come from the data's pairwise
affines, never from parameters). Where |s| <= max_shift this is the exact
transpose of the forward: with b = floor(s) and f = s - b > 0, the shift
by -s has floor -b-1 and fraction 1-f, so

    g_x[k] = f * g[k-b-1] + (1-f) * g[k-b],

which is what the forward's taps (1-f) at j+b and f at j+b+1 transpose
to, zero fill included (f = 0 gives g[k-b]). Beyond the clip, autodiff
of JAX's CPU form (whose read position clamps but whose fraction does
not) and the shift by -s differ; no caller goes there (ops/warp.py clips
every shift).

On a CUDA tensor both directions launch csrc/shift_rows.cu (16-byte
vectors of each row's positions, rows staged through shared memory,
columns walked down bands; all images in one launch; notes on design and
bounds there); the tracer counts forward launches as
``kernel2.launches`` and backward ones as ``kernel2.backward_launches``
(heal_tpu_torch/trace.py). On a CPU tensor both take
``shift_rows_plain`` / ``shift_cols_plain``.
"""
from __future__ import annotations

import torch

from ..kernels import build


def _pad(size: int, max_shift: int | None) -> int:
    return (int(max_shift) + 2) if max_shift is not None else (size + 2)


def shift_rows_plain(
    x: torch.Tensor, shifts: torch.Tensor, max_shift: int | None = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`shift_rows` (same arguments)."""
    n, h, w, c = x.shape
    pad = _pad(w, max_shift)
    s = shifts.float()
    base = torch.clamp(torch.floor(s), -pad, pad)
    frac = (s - base)[..., None, None]  # (N, H, 1, 1)
    read = torch.clamp(base, max=pad - 1).long()
    q0 = read[..., None] + torch.arange(w, device=x.device)  # (N, H, W)
    xf = x.float()

    def tap(q):
        inside = ((q >= 0) & (q < w))[..., None]
        idx = q.clamp(0, w - 1)[..., None].expand(n, h, w, c)
        return torch.gather(xf, 2, idx) * inside

    return (tap(q0) * (1 - frac) + tap(q0 + 1) * frac).to(x.dtype)


def shift_cols_plain(
    x: torch.Tensor, shifts: torch.Tensor, max_shift: int | None = None
) -> torch.Tensor:
    """Plain PyTorch version of :func:`shift_cols` (transpose + row shift)."""
    return shift_rows_plain(
        x.transpose(1, 2), shifts, max_shift
    ).transpose(1, 2).contiguous()


def _shift_plain(x, shifts, max_shift, axis, backward=False):
    """Plain version of :func:`_shift` (same arguments)."""
    plain = shift_rows_plain if axis == 0 else shift_cols_plain
    return plain(x, shifts, max_shift)


def _shift(x, shifts, max_shift, axis, backward=False):
    """One direction of the shift: the plain version on the CPU, the
    kernel on CUDA (no autograd here)."""
    if x.device.type == "cpu":
        return _shift_plain(x, shifts, max_shift, axis)
    n, h, w, c = x.shape
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads 16-byte vectors
        x = x.clone()
    shifts = shifts.contiguous()
    build.expect("shift_rows", ((x, (n, h, w, c), x.dtype),
                                (shifts, (n, h) if axis == 0 else (n, w),
                                 torch.float32)))
    out = torch.empty_like(x)
    build.launch("shift_rows", "shift_rows", "kernel2.backward_launches"
                 if backward else "kernel2.launches", out, x, shifts, out,
                 n, h, w, c, axis, _pad(x.shape[2 - axis], max_shift))
    return out


def shift_ops(x, shifts, max_shift, axis, backward=False) -> int:
    """Operations of one :func:`_shift` call (same arguments): three a
    blended element."""
    return 3 * x.numel()


class _Shift(torch.autograd.Function):
    """Kernel 2 with its VJP: forward shifts by s, backward by -s."""

    @staticmethod
    def forward(ctx, x, shifts, max_shift, axis):
        ctx.save_for_backward(shifts)
        ctx.max_shift, ctx.axis = max_shift, axis
        return _shift(x, shifts, max_shift, axis)

    @staticmethod
    def backward(ctx, g):
        (shifts,) = ctx.saved_tensors
        gx = _shift(g, -shifts, ctx.max_shift, ctx.axis, backward=True)
        return gx, None, None, None


def shift_rows(
    x: torch.Tensor, shifts: torch.Tensor, max_shift: int | None = None
) -> torch.Tensor:
    """Fractional shift of every row: x (N, H, W, C), shifts (N, H) f32
    -> (N, H, W, C); out[n, i, j] = x[n, i, j + shifts[n, i]].
    Differentiable in x."""
    return _Shift.apply(x, shifts, max_shift, 0)


def shift_cols(
    x: torch.Tensor, shifts: torch.Tensor, max_shift: int | None = None
) -> torch.Tensor:
    """Fractional shift of every column: x (N, H, W, C), shifts (N, W) f32
    -> (N, H, W, C); out[n, i, j] = x[n, i + shifts[n, j], j].
    Differentiable in x."""
    return _Shift.apply(x, shifts, max_shift, 1)

