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

On a CUDA tensor both directions launch csrc/shift_rows.cu (one thread
per output element, all images in one launch; notes on design and bounds
there); ``shift_rows.launches`` counts forward launches and
``shift_rows.backward_launches`` backward ones. On a CPU tensor both take
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


def _launch(x: torch.Tensor, shifts: torch.Tensor, axis: int, pad: int,
            backward: bool):
    n, h, w, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"shift_rows: x must be f32 or bf16, got {x.dtype}")
    want = (n, h) if axis == 0 else (n, w)
    if tuple(shifts.shape) != want or shifts.dtype != torch.float32:
        raise ValueError(f"shift_rows: shifts must be {want} f32")
    if shifts.device != x.device:
        raise ValueError("shift_rows: x and shifts must be on one device")
    x = x.contiguous()
    shifts = shifts.contiguous()
    out = torch.empty_like(x)
    lib = build.library()
    entry = (lib.heal_shift_rows_f32 if x.dtype == torch.float32
             else lib.heal_shift_rows_bf16)
    code = entry(
        x.data_ptr(), shifts.data_ptr(), out.data_ptr(), n, h, w, c, axis,
        pad, build.stream_ptr(x.device),
    )
    build.check(code, "shift_rows")
    if backward:
        shift_rows.backward_launches += 1
    else:
        shift_rows.launches += 1
    return out


def _shift(x, shifts, max_shift, axis, backward=False):
    """One direction of the shift: the plain version on the CPU, the
    kernel on CUDA (no autograd here)."""
    if x.device.type == "cpu":
        plain = shift_rows_plain if axis == 0 else shift_cols_plain
        return plain(x, shifts, max_shift)
    return _launch(x, shifts, axis, _pad(x.shape[2 - axis], max_shift),
                   backward)


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


# kernel launches (rows and columns), counted where they happen
shift_rows.launches = 0
shift_rows.backward_launches = 0
