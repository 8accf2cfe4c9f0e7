"""BEV affine warp, NHWC, fixed shapes (torch).

Counterpart of heal_tpu/ops/warp.py with a batch dimension written out
where JAX vmaps: every function takes (N, H, W, C) images and (N, 2, 3)
normalized output->input affines (the ``t_matrix[0, j]`` layout of
utils/transform_np.normalize_pairwise_tfm).

Two methods, as in JAX:
  * "exact": bilinear gather with zero padding, ``F.grid_sample``
    (JAX's ``affine_warp`` is tested equal to it);
  * "shear": the 3-shear (Paeth) decomposition of a rigid warp into row
    and column shifts on kernel 2 (ops/shift_rows.py).
``method="auto"`` is "shear" for CUDA tensors and "exact" for CPU ones,
mirroring JAX's TPU / CPU split.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import shift_rows as _sr


def affine_warp(
    src: torch.Tensor, M: torch.Tensor, align_corners: bool = False
) -> torch.Tensor:
    """Exact bilinear warp. src (N, H, W, C); M (N, 2, 3) -> (N, H, W, C).

    Sampling positions are computed in f32 whatever src's dtype (as JAX
    does), so bf16 features are blended in f32 and cast back.
    """
    n, h, w, c = src.shape
    grid = F.affine_grid(
        M.float(), [n, c, h, w], align_corners=align_corners
    )
    out = F.grid_sample(
        src.permute(0, 3, 1, 2).float(),
        grid,
        mode="bilinear",
        padding_mode="zeros",
        align_corners=align_corners,
    )
    return out.permute(0, 2, 3, 1).to(src.dtype)


def _crop(x: torch.Tensor, off_y, off_x, h: int, w: int) -> torch.Tensor:
    """Per-image (h, w) window of x (N, S, S, C) at (off_y[n], off_x[n])."""
    n = x.shape[0]
    dev = x.device
    rows = off_y[:, None] + torch.arange(h, device=dev)  # (N, h)
    cols = off_x[:, None] + torch.arange(w, device=dev)  # (N, w)
    nidx = torch.arange(n, device=dev)[:, None, None]
    return x[nidx, rows[:, :, None], cols[:, None, :]]


def affine_warp_shear(src: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Rigid-affine warp by 3-shear decomposition, gather-free.

    src (N, h, w, C); M (N, 2, 3), whose pixel-space linear part is a
    rotation. Follows heal_tpu.ops.warp.affine_warp_shear step by step:
    embed in a square canvas, reduce the angle by an exact multiple of 90
    degrees (flip / rot90 selects on the small source), shear_x . shear_y
    . shear_x with the fractional translation riding in passes 2 and 3,
    crop at the integer translation, then constant shifts for what the
    crop could not reach. All angles stay on the device (no host sync).
    """
    n, h, w, c = src.shape
    dev = src.device
    r = int(math.ceil(math.sqrt(h * h + w * w) / 2.0))
    side = 2 * r + 4
    cy, cx = (side - h) // 2, (side - w) // 2

    M = M.float()
    theta = torch.atan2(M[:, 1, 0] * h / w, M[:, 0, 0])
    tx = M[:, 0, 2] * w / 2.0
    ty = M[:, 1, 2] * h / 2.0

    k = torch.round(theta / (math.pi / 2)).to(torch.int32)
    kf = k.to(torch.float32)
    theta_r = theta - kf * (math.pi / 2)
    km = torch.remainder(k, 4)
    flip180 = ((km == 2) | (km == 3))[:, None, None, None]
    do90 = ((km == 1) | (km == 3))[:, None, None, None]
    src0 = torch.where(flip180, src.flip(1, 2), src)
    src_t = torch.rot90(src0, 1, dims=(1, 2))  # (N, w, h, C)
    canvas0 = src.new_zeros((n, side, side, c))
    canvas0[:, cy : cy + h, cx : cx + w] = src0
    cy_t, cx_t = (side - w) // 2, (side - h) // 2
    canvas_t = src.new_zeros((n, side, side, c))
    canvas_t[:, cy_t : cy_t + w, cx_t : cx_t + h] = src_t
    canvas = torch.where(do90, canvas_t, canvas0)
    # t' = R(-k pi/2) t
    ck = torch.cos(-kf * math.pi / 2)
    sk = torch.sin(-kf * math.pi / 2)
    tx_p = ck * tx - sk * ty
    ty_p = sk * tx + ck * ty

    a = -torch.tan(theta_r / 2.0)
    b = torch.sin(theta_r)
    coords = torch.arange(side, dtype=torch.float32, device=dev) - (
        side - 1
    ) / 2.0
    # |theta_r| <= pi/4 -> |a| <= tan(pi/8), |b| <= sin(pi/4), +1 frac
    ms = int(math.ceil(0.7072 * side / 2)) + 2

    cr, sr = torch.cos(-theta_r), torch.sin(-theta_r)
    gx = cr * tx_p - sr * ty_p
    gy = sr * tx_p + cr * ty_p
    gx_i = torch.floor(gx)
    gy_i = torch.floor(gy)
    gx_f = gx - gx_i
    gy_f = gy - gy_i

    x1 = _sr.shift_rows(
        canvas, torch.clamp(a[:, None] * coords, -ms, ms), ms
    )
    x2 = _sr.shift_cols(
        x1, torch.clamp(b[:, None] * coords + gy_f[:, None], -ms, ms), ms
    )
    x3 = _sr.shift_rows(
        x2, torch.clamp(a[:, None] * coords + gx_f[:, None], -ms, ms), ms
    )

    want_y = cy + gy_i.to(torch.int32)
    want_x = cx + gx_i.to(torch.int32)
    off_y = torch.clamp(want_y, 0, side - h)
    off_x = torch.clamp(want_x, 0, side - w)
    out = _crop(x3, off_y.long(), off_x.long(), h, w)
    # translations beyond the canvas margin: constant integer shifts
    # (zero-filled) for the clipped remainder, on the small output
    rem_y = (want_y - off_y).to(torch.float32)
    rem_x = (want_x - off_x).to(torch.float32)
    out = _sr.shift_rows(
        out, torch.clamp(rem_x, -w, w)[:, None].expand(n, h), w
    )
    return _sr.shift_cols(
        out, torch.clamp(rem_y, -h, h)[:, None].expand(n, w), h
    )


def _method(features: torch.Tensor, method: str) -> str:
    if method == "auto":
        method = "shear" if features.is_cuda else "exact"
    if method not in ("shear", "exact"):
        raise ValueError(f"unknown warp method {method!r}")
    return method


def warp_pairwise(
    features: torch.Tensor, affine: torch.Tensor, method: str = "auto"
) -> torch.Tensor:
    """All-pairs warp: sender j's map into every receiver i's frame.

    features (B, L, H, W, C); affine (B, I, J, 2, 3), where affine[b, i, j]
    maps receiver i's pixel coords into sender j's frame. Returns
    (B, I, J, H, W, C). All B·I·J maps warp in one call (one batch of
    kernel-2 launches for "shear"); the diagonal is warped too, as in
    JAX, where its identity affine makes the warp a copy.
    """
    method = _method(features, method)
    b, l, h, w, c = features.shape
    i = affine.shape[1]
    x = features[:, None].expand(b, i, l, h, w, c).reshape(b * i * l, h, w, c)
    m = affine.reshape(b * i * l, 2, 3)
    moved = (affine_warp_shear(x, m) if method == "shear"
             else affine_warp(x, m))
    return moved.reshape(b, i, l, h, w, c)


def warp_agents_to_ego(
    features: torch.Tensor,
    affine: torch.Tensor,
    align_corners: bool = False,
    method: str = "auto",
    skip_ego: bool = True,
) -> torch.Tensor:
    """Warp every agent's BEV map into the ego (slot-0) frame.

    features (B, L, H, W, C); affine (B, L, L, 2, 3) normalized pairwise
    matrices (affine[b, 0, j] maps ego pixel coords into agent j's frame).
    Returns (B, L, H, W, C). All agents of the batch warp in one call.

    skip_ego: the ego->ego affine is the identity, so slot 0 passes
    through untouched.
    """
    method = _method(features, method)
    b, l, h, w, c = features.shape
    to_ego = affine[:, 0]  # (B, L, 2, 3)
    first = 1 if (skip_ego and l > 1) else 0
    x = features[:, first:].reshape(b * (l - first), h, w, c)
    m = to_ego[:, first:].reshape(b * (l - first), 2, 3)
    moved = (affine_warp_shear(x, m) if method == "shear"
             else affine_warp(x, m, align_corners))
    moved = moved.reshape(b, l - first, h, w, c)
    if first:
        return torch.cat([features[:, :1], moved], dim=1)
    return moved
