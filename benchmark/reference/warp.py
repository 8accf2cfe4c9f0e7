"""Plain warp of the agents' BEV maps into the ego frame.

Frozen copy of heal_tpu_torch/ops/warp.py (``affine_warp``,
``affine_warp_shear``, ``warp_agents_to_ego``) and of the plain shifts of
ops/shift_rows.py (``shift_rows_plain``, ``shift_cols_plain``) at
commit 067a829. The port warps by the 3-shear (Paeth) decomposition on
CUDA and by a bilinear ``grid_sample`` on the CPU, as heal_tpu does on
and off the TPU; the two are different functions (each shear rounds
by linear interpolation), so the reference takes the same method on the
same device, with plain gathers where the port launches kernel 2.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def shift_rows(x, shifts, max_shift=None):
    """out[n, i, j] = (1-f) x[n, i, j+r] + f x[n, i, j+r+1], zero fill."""
    n, h, w, c = x.shape
    pad = (int(max_shift) + 2) if max_shift is not None else (w + 2)
    s = shifts.float()
    base = torch.clamp(torch.floor(s), -pad, pad)
    frac = (s - base)[..., None, None]
    read = torch.clamp(base, max=pad - 1).long()
    q0 = read[..., None] + torch.arange(w, device=x.device)

    def tap(q):
        inside = ((q >= 0) & (q < w))[..., None]
        idx = q.clamp(0, w - 1)[..., None].expand(n, h, w, c)
        return torch.gather(x, 2, idx) * inside

    return tap(q0) * (1 - frac) + tap(q0 + 1) * frac


def shift_cols(x, shifts, max_shift=None):
    return shift_rows(x.transpose(1, 2), shifts, max_shift).transpose(1, 2)


def affine_warp(src, m):
    """Bilinear warp, zero padding. src (N, H, W, C); m (N, 2, 3)."""
    n, h, w, c = src.shape
    grid = F.affine_grid(m.float(), [n, c, h, w], align_corners=False)
    out = F.grid_sample(src.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


def _crop(x, off_y, off_x, h, w):
    n, dev = x.shape[0], x.device
    rows = off_y[:, None] + torch.arange(h, device=dev)
    cols = off_x[:, None] + torch.arange(w, device=dev)
    return x[torch.arange(n, device=dev)[:, None, None], rows[:, :, None],
             cols[:, None, :]]


def affine_warp_shear(src, m):
    """Rigid warp by three shears: embed in a square canvas, take out a
    multiple of 90 degrees exactly, shear x . shear y . shear x with the
    fractional translation in passes 2 and 3, crop at the integer
    translation, then integer shifts for what the crop cannot reach."""
    n, h, w, c = src.shape
    dev = src.device
    r = int(math.ceil(math.sqrt(h * h + w * w) / 2.0))
    side = 2 * r + 4
    cy, cx = (side - h) // 2, (side - w) // 2
    m = m.float()
    theta = torch.atan2(m[:, 1, 0] * h / w, m[:, 0, 0])
    tx = m[:, 0, 2] * w / 2.0
    ty = m[:, 1, 2] * h / 2.0
    k = torch.round(theta / (math.pi / 2)).to(torch.int32)
    kf = k.to(torch.float32)
    theta_r = theta - kf * (math.pi / 2)
    km = torch.remainder(k, 4)
    flip180 = ((km == 2) | (km == 3))[:, None, None, None]
    do90 = ((km == 1) | (km == 3))[:, None, None, None]
    src0 = torch.where(flip180, src.flip(1, 2), src)
    src_t = torch.rot90(src0, 1, dims=(1, 2))
    canvas0 = src.new_zeros((n, side, side, c))
    canvas0[:, cy:cy + h, cx:cx + w] = src0
    cy_t, cx_t = (side - w) // 2, (side - h) // 2
    canvas_t = src.new_zeros((n, side, side, c))
    canvas_t[:, cy_t:cy_t + w, cx_t:cx_t + h] = src_t
    canvas = torch.where(do90, canvas_t, canvas0)
    ck, sk = torch.cos(-kf * math.pi / 2), torch.sin(-kf * math.pi / 2)
    tx_p = ck * tx - sk * ty
    ty_p = sk * tx + ck * ty
    a = -torch.tan(theta_r / 2.0)
    b = torch.sin(theta_r)
    coords = torch.arange(side, dtype=torch.float32, device=dev) - (
        side - 1) / 2.0
    ms = int(math.ceil(0.7072 * side / 2)) + 2
    cr, sr = torch.cos(-theta_r), torch.sin(-theta_r)
    gx = cr * tx_p - sr * ty_p
    gy = sr * tx_p + cr * ty_p
    gx_i, gy_i = torch.floor(gx), torch.floor(gy)
    gx_f, gy_f = gx - gx_i, gy - gy_i
    x1 = shift_rows(canvas, torch.clamp(a[:, None] * coords, -ms, ms), ms)
    x2 = shift_cols(x1, torch.clamp(b[:, None] * coords + gy_f[:, None],
                                    -ms, ms), ms)
    x3 = shift_rows(x2, torch.clamp(a[:, None] * coords + gx_f[:, None],
                                    -ms, ms), ms)
    want_y = cy + gy_i.to(torch.int32)
    want_x = cx + gx_i.to(torch.int32)
    off_y = torch.clamp(want_y, 0, side - h)
    off_x = torch.clamp(want_x, 0, side - w)
    out = _crop(x3, off_y.long(), off_x.long(), h, w)
    rem_y = (want_y - off_y).to(torch.float32)
    rem_x = (want_x - off_x).to(torch.float32)
    out = shift_rows(out, torch.clamp(rem_x, -w, w)[:, None].expand(n, h), w)
    return shift_cols(out, torch.clamp(rem_y, -h, h)[:, None].expand(n, w), h)


def to_ego(feat, affine):
    """feat (B, L, H, W, C), affine (B, L, L, 2, 3): each non-ego agent's
    map in the ego's frame; slot 0 passes through."""
    b, l, h, w, c = feat.shape
    if l == 1:
        return feat
    x = feat[:, 1:].reshape(b * (l - 1), h, w, c)
    m = affine[:, 0, 1:].reshape(b * (l - 1), 2, 3)
    warp = affine_warp_shear if feat.is_cuda else affine_warp
    return torch.cat([feat[:, :1], warp(x, m).reshape(b, l - 1, h, w, c)], 1)
