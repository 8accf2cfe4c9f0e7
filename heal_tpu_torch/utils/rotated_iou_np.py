"""Rotated-rectangle intersection / IoU on numpy arrays (host side).

The port's copy of the numpy path of heal_tpu/utils/rotated_iou.py
(``rotated_iou_matrix`` and what it calls), numpy in and numpy out; the
JAX module picks jax.numpy for any non-numpy input. The torch twin for
the device side is utils/rotated_iou.py.

The boundary of A∩B for convex CCW polygons is {parts of ∂A inside B} ∪
{parts of ∂B inside A}; the shoelace area is the line integral
∮ (x dy − y dx)/2, which is order-independent over directed boundary
segments, so each edge is Liang-Barsky-clipped against the other
rectangle's four half-planes and its contribution ½·cross(P(t0), P(t1))
is summed directly: no sorting, exact for convex polygons.
"""
from __future__ import annotations

import numpy as np

_EPS = 1e-8


def polygon_area(corners: np.ndarray) -> np.ndarray:
    """Shoelace area of (..., K, 2) polygons (positive for CCW)."""
    x = corners[..., 0]
    y = corners[..., 1]
    x2 = np.roll(x, -1, axis=-1)
    y2 = np.roll(y, -1, axis=-1)
    return 0.5 * np.sum(x * y2 - x2 * y, axis=-1)


def _clipped_edge_contributions(ca, cb, include_boundary=True):
    """Line-integral contribution of ∂A∩B: each A edge clipped to B.

    ``include_boundary`` controls whether an A edge lying exactly ON ∂B
    counts as inside; the two passes use opposite settings so coincident
    boundary segments (identical boxes) are counted exactly once.
    """
    p = ca
    r = np.roll(ca, -1, axis=-2) - ca
    b0 = cb
    e = np.roll(cb, -1, axis=-2) - cb

    pi = p[..., :, None, :]
    ri = r[..., :, None, :]
    bk = b0[..., None, :, :]
    ek = e[..., None, :, :]
    num = ek[..., 0] * (pi[..., 1] - bk[..., 1]) - ek[..., 1] * (
        pi[..., 0] - bk[..., 0]
    )
    den = ek[..., 0] * ri[..., 1] - ek[..., 1] * ri[..., 0]

    safe_den = np.where(np.abs(den) < _EPS, 1.0, den)
    t_hit = -num / safe_den
    parallel = np.abs(den) < _EPS
    btol = 1e-6
    par_inside = (num >= -btol) if include_boundary else (num > btol)
    lo = np.where(
        parallel, np.where(par_inside, 0.0, 1.0), np.where(den > 0, t_hit, 0.0)
    )
    hi = np.where(
        parallel, np.where(par_inside, 1.0, 0.0), np.where(den < 0, t_hit, 1.0)
    )
    t0 = np.clip(np.max(lo, axis=-1), 0.0, 1.0)
    t1 = np.clip(np.min(hi, axis=-1), 0.0, 1.0)
    keep = (t1 > t0).astype(ca.dtype)

    p0 = p + t0[..., None] * r
    p1 = p + t1[..., None] * r
    contrib = 0.5 * (p0[..., 0] * p1[..., 1] - p1[..., 0] * p0[..., 1])
    return np.sum(contrib * keep, axis=-1)


def rect_intersection_area(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """Intersection area of two convex CCW quads given corners (..., 4, 2)."""
    area = _clipped_edge_contributions(
        ca, cb, include_boundary=True
    ) + _clipped_edge_contributions(cb, ca, include_boundary=False)
    return np.maximum(area, 0.0)


def rotated_iou_corners(ca: np.ndarray, cb: np.ndarray) -> np.ndarray:
    """IoU of two rotated rects from corners (..., 4, 2) each."""
    inter = rect_intersection_area(ca, cb)
    area_a = np.abs(polygon_area(ca))
    area_b = np.abs(polygon_area(cb))
    union = area_a + area_b - inter
    return inter / np.maximum(union, _EPS)


def rotated_iou_matrix(corners_a: np.ndarray, corners_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU matrix between (N, 4, 2) and (M, 4, 2) -> (N, M)."""
    n, m = corners_a.shape[0], corners_b.shape[0]
    ca = np.broadcast_to(corners_a[:, None], (n, m, 4, 2))
    cb = np.broadcast_to(corners_b[None, :], (n, m, 4, 2))
    return rotated_iou_corners(ca, cb)
