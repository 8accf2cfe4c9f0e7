"""Plain detection decode: head outputs -> boxes, scores and the
greedy rotated NMS.

After heal_tpu_torch/postprocess/decode.py (``post_process_single``),
ops/geometry.py and utils/rotated_iou.py at commit 067a829: sigmoid
scores; boxes decoded from their anchors (xy over the anchor's BEV
diagonal, z over its height, log sizes, yaw residual), the yaw snapped
into the direction bin; corners to the ego frame; candidates above the
score threshold, the ``max_det`` best of them, kept where their extent
and height are sane and every corner lies in range; then NMS greedily
in score order, on the exact rotated IoU of the BEV rectangles.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_TEMPLATE = [[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
             [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1]]


def limit_period(v, offset, period):
    return v - torch.floor(v / period + offset) * period


def box_corners(boxes):
    """(N, 7) hwl -> (N, 8, 3)."""
    b = boxes[:, [0, 1, 2, 5, 4, 3, 6]]
    local = b[:, None, 3:6] * (torch.tensor(_TEMPLATE, dtype=b.dtype,
                                            device=b.device) / 2)
    c, s = torch.cos(b[:, 6])[:, None], torch.sin(b[:, 6])[:, None]
    return torch.stack([local[..., 0] * c - local[..., 1] * s,
                        local[..., 0] * s + local[..., 1] * c,
                        local[..., 2]], -1) + b[:, None, :3]


def decode_all(cls, reg, dirs, anchors, hypes: dict) -> dict:
    """Every anchor of one sample: ``scores`` (N,), ``corners`` (N, 8, 3)
    in the ego frame (an identity transform here), ``ok`` (N,) the
    candidates (above the threshold, sane and in range)."""
    post = hypes["postprocess"]
    n = cls.numel()
    prob = torch.sigmoid(cls.reshape(n))
    d, a = reg.reshape(n, 7), anchors.reshape(n, 7)
    diag = torch.sqrt(a[:, 4] ** 2 + a[:, 5] ** 2)
    boxes = torch.cat([d[:, :2] * diag[:, None] + a[:, :2],
                       d[:, 2:3] * a[:, 3:4] + a[:, 2:3],
                       torch.exp(d[:, 3:6]) * a[:, 3:6],
                       d[:, 6:7] + a[:, 6:7]], 1)
    da = post["dir_args"]
    bins, off = da["num_bins"], da["dir_offset"]
    label = torch.argmax(dirs.reshape(n, bins), -1)
    period = 2 * math.pi / bins
    yaw = limit_period(boxes[:, 6] - off, 0.0, period) + off + period * label
    boxes = torch.cat([boxes[:, :6], limit_period(yaw, 0.5, 2 * math.pi)[:, None]
                       ], 1)
    c = box_corners(boxes)
    lo, hi = c.amin(1), c.amax(1)
    sane = ((hi[:, 0] - lo[:, 0] <= 6.0) & (hi[:, 1] - lo[:, 1] <= 6.0)
            & (lo[:, 2] >= -3.0) & (hi[:, 2] <= 1.0))
    rng = torch.tensor(post["gt_range"], dtype=c.dtype, device=c.device)
    inside = ((c >= rng[:3]) & (c <= rng[3:])).all(-1).all(-1)
    thr = post["target_args"]["score_threshold"]
    return {"scores": prob, "corners": c, "ok": (prob > thr) & sane & inside,
            "above": prob > thr}


def polygon_area(p):
    x, y = p[..., 0], p[..., 1]
    return 0.5 * (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(-1)


def _clip(ca, cb, boundary):
    """Signed area contributed by ca's edges inside cb (Liang-Barsky)."""
    r = torch.roll(ca, -1, -2) - ca
    e = torch.roll(cb, -1, -2) - cb
    p, ri = ca[..., :, None, :], r[..., :, None, :]
    bk, ek = cb[..., None, :, :], e[..., None, :, :]
    num = ek[..., 0] * (p[..., 1] - bk[..., 1]) - ek[..., 1] * (p[..., 0]
                                                                 - bk[..., 0])
    den = ek[..., 0] * ri[..., 1] - ek[..., 1] * ri[..., 0]
    par = den.abs() < 1e-8
    t = -num / torch.where(par, torch.ones_like(den), den)
    pin = num >= -1e-6 if boundary else num > 1e-6
    zero, one = torch.zeros_like(den), torch.ones_like(den)
    lo = torch.where(par, torch.where(pin, zero, one),
                     torch.where(den > 0, t, zero))
    hi = torch.where(par, torch.where(pin, one, zero),
                     torch.where(den < 0, t, one))
    t0 = lo.amax(-1).clamp(0, 1)
    t1 = hi.amin(-1).clamp(0, 1)
    p0 = ca + t0[..., None] * r
    p1 = ca + t1[..., None] * r
    part = 0.5 * (p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1])
    return (part * (t1 > t0)).sum(-1)


def iou_matrix(a, b):
    """Rotated IoU of (N, 4, 2) against (M, 4, 2) BEV rectangles."""
    ca = a[:, None].expand(len(a), len(b), 4, 2)
    cb = b[None].expand(len(a), len(b), 4, 2)
    inter = (_clip(ca, cb, True) + _clip(cb, ca, False)).clamp(min=0)
    union = polygon_area(ca).abs() + polygon_area(cb).abs() - inter
    return inter / union.clamp(min=1e-8)


def nms(dec: dict, hypes: dict, max_det: int = 300) -> np.ndarray:
    """Indices (into all anchors) of the kept detections, best first."""
    order = torch.argsort(torch.where(dec["above"], dec["scores"],
                                      torch.zeros_like(dec["scores"])),
                          descending=True, stable=True)[:max_det]
    order = order[dec["ok"][order]]
    iou = iou_matrix(dec["corners"][order, :4, :2],
                     dec["corners"][order, :4, :2]).cpu().numpy()
    thr = hypes["postprocess"]["nms_thresh"]
    kept: list[int] = []
    for i in range(len(order)):
        if all(iou[k, i] <= thr for k in kept):
            kept.append(i)
    return order.cpu().numpy()[kept]
