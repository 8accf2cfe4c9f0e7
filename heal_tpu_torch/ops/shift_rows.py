"""Kernel 2: per-row / per-column fractional shift with zero fill.

The building block of the 3-shear warp (ops/warp.affine_warp_shear). It
replaces the TPU kernel heal_tpu/ops/pallas_shear.py ``shift_rows_pallas``
(forward only; its backward comes with training), and has the semantics
of heal_tpu.ops.warp._shift_rows, the form JAX runs off the TPU:

    out[n, i, j] = (1-f) * x[n, i, j+r] + f * x[n, i, j+r+1]

with b = clip(floor(s[n, i]), -pad, pad), f = s[n, i] - b, r = min(b,
pad-1), pad = max_shift + 2 (the row width + 2 without a bound), and
zeros outside the row. Callers clip shifts to +-max_shift, where r = b;
past that, r and f reproduce the clamped read of JAX's padded-row
dynamic slice. ``shift_cols`` is the same along columns with a shift per
(n, j).

On a CUDA tensor both launch csrc/shift_rows.cu (one thread per output
element, all images in one launch; notes on design and bounds there). On
a CPU tensor they take ``shift_rows_plain`` / ``shift_cols_plain``.
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


def _launch(x: torch.Tensor, shifts: torch.Tensor, axis: int, pad: int):
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
    shift_rows.launches += 1
    return out


def shift_rows(
    x: torch.Tensor, shifts: torch.Tensor, max_shift: int | None = None
) -> torch.Tensor:
    """Fractional shift of every row: x (N, H, W, C), shifts (N, H) f32
    -> (N, H, W, C); out[n, i, j] = x[n, i, j + shifts[n, i]]."""
    if x.device.type == "cpu":
        return shift_rows_plain(x, shifts, max_shift)
    return _launch(x, shifts, 0, _pad(x.shape[2], max_shift))


def shift_cols(
    x: torch.Tensor, shifts: torch.Tensor, max_shift: int | None = None
) -> torch.Tensor:
    """Fractional shift of every column: x (N, H, W, C), shifts (N, W) f32
    -> (N, H, W, C); out[n, i, j] = x[n, i + shifts[n, j], j]."""
    if x.device.type == "cpu":
        return shift_cols_plain(x, shifts, max_shift)
    return _launch(x, shifts, 1, _pad(x.shape[1], max_shift))


shift_rows.launches = 0  # kernel launches (rows and columns), counted here
