"""Rotated-rectangle intersection / IoU on torch tensors.

The same sort-free line-integral clipper as heal_tpu/utils/rotated_iou.py
(:66-146): the boundary of A∩B for convex CCW polygons is {parts of ∂A
inside B} ∪ {parts of ∂B inside A}; each edge is Liang-Barsky-clipped
against the other rectangle's four half-planes and its shoelace
contribution ½·cross(P(t0), P(t1)) is summed. The numpy module picks its
array backend by input type and sends torch tensors to jax.numpy, so the
port keeps this torch version, with ``box2d_to_corners`` and the IoU
loss's ``aligned_boxes_iou3d`` (rotated_iou.py:37-55, 148-169).
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def box2d_to_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 5) [x, y, dx, dy, yaw] -> (..., 4, 2) CCW corners, in the
    reference template's order (+,-), (+,+), (-,+), (-,-)."""
    x, y, dx, dy, yaw = boxes.unbind(-1)
    template = torch.tensor([[0.5, -0.5], [0.5, 0.5], [-0.5, 0.5],
                             [-0.5, -0.5]], dtype=boxes.dtype,
                            device=boxes.device)
    local = torch.stack([dx, dy], dim=-1)[..., None, :] * template
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    cx = local[..., 0] * c - local[..., 1] * s
    cy = local[..., 0] * s + local[..., 1] * c
    return torch.stack([cx + x[..., None], cy + y[..., None]], dim=-1)


def polygon_area(corners: torch.Tensor) -> torch.Tensor:
    """Shoelace area of (..., K, 2) polygons (positive for CCW)."""
    x = corners[..., 0]
    y = corners[..., 1]
    x2 = torch.roll(x, -1, dims=-1)
    y2 = torch.roll(y, -1, dims=-1)
    return 0.5 * torch.sum(x * y2 - x2 * y, dim=-1)


def _clipped_edge_contributions(ca, cb, include_boundary: bool):
    """Line-integral contribution of ∂A∩B: each A edge clipped to B."""
    p = ca
    r = torch.roll(ca, -1, dims=-2) - ca
    b0 = cb
    e = torch.roll(cb, -1, dims=-2) - cb

    pi = p[..., :, None, :]
    ri = r[..., :, None, :]
    bk = b0[..., None, :, :]
    ek = e[..., None, :, :]
    num = ek[..., 0] * (pi[..., 1] - bk[..., 1]) - ek[..., 1] * (
        pi[..., 0] - bk[..., 0]
    )
    den = ek[..., 0] * ri[..., 1] - ek[..., 1] * ri[..., 0]

    parallel = torch.abs(den) < _EPS
    safe_den = torch.where(parallel, torch.ones_like(den), den)
    t_hit = -num / safe_den
    btol = 1e-6
    par_inside = (num >= -btol) if include_boundary else (num > btol)
    zero = torch.zeros_like(den)
    one = torch.ones_like(den)
    lo = torch.where(
        parallel,
        torch.where(par_inside, zero, one),
        torch.where(den > 0, t_hit, zero),
    )
    hi = torch.where(
        parallel,
        torch.where(par_inside, one, zero),
        torch.where(den < 0, t_hit, one),
    )
    t0 = torch.clamp(torch.amax(lo, dim=-1), 0.0, 1.0)
    t1 = torch.clamp(torch.amin(hi, dim=-1), 0.0, 1.0)
    keep = (t1 > t0).to(ca.dtype)

    p0 = p + t0[..., None] * r
    p1 = p + t1[..., None] * r
    contrib = 0.5 * (p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1])
    return torch.sum(contrib * keep, dim=-1)


def rect_intersection_area(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """Intersection area of two convex CCW quads given corners (..., 4, 2)."""
    area = _clipped_edge_contributions(
        ca, cb, include_boundary=True
    ) + _clipped_edge_contributions(cb, ca, include_boundary=False)
    return torch.clamp(area, min=0.0)


def rotated_iou_corners(ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """IoU of two rotated rects from corners (..., 4, 2) each."""
    inter = rect_intersection_area(ca, cb)
    area_a = torch.abs(polygon_area(ca))
    area_b = torch.abs(polygon_area(cb))
    union = area_a + area_b - inter
    return inter / torch.clamp(union, min=_EPS)


def rotated_iou_matrix(
    corners_a: torch.Tensor, corners_b: torch.Tensor
) -> torch.Tensor:
    """Pairwise IoU matrix between (N, 4, 2) and (M, 4, 2) -> (N, M)."""
    n, m = corners_a.shape[0], corners_b.shape[0]
    ca = corners_a[:, None].expand(n, m, 4, 2)
    cb = corners_b[None, :].expand(n, m, 4, 2)
    return rotated_iou_corners(ca, cb)


def aligned_boxes_iou3d(boxes_a: torch.Tensor,
                        boxes_b: torch.Tensor) -> torch.Tensor:
    """Element-wise 3D IoU of (..., 7) hwl boxes [x, y, z, h, w, l, yaw]:
    the BEV polygon intersection times the z overlap, over the union
    (floored at 1e-8)."""
    order = [0, 1, 5, 4, 6]
    inter_bev = rect_intersection_area(box2d_to_corners(boxes_a[..., order]),
                                       box2d_to_corners(boxes_b[..., order]))
    ha, hb = boxes_a[..., 3], boxes_b[..., 3]
    za0, za1 = boxes_a[..., 2] - ha / 2, boxes_a[..., 2] + ha / 2
    zb0, zb1 = boxes_b[..., 2] - hb / 2, boxes_b[..., 2] + hb / 2
    inter_z = torch.clamp(torch.minimum(za1, zb1) - torch.maximum(za0, zb0),
                          min=0.0)
    inter = inter_bev * inter_z
    vol_a = boxes_a[..., 4] * boxes_a[..., 5] * ha
    vol_b = boxes_b[..., 4] * boxes_b[..., 5] * hb
    return inter / torch.clamp(vol_a + vol_b - inter, min=_EPS)
