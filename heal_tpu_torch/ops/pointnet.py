"""PointNet++-style point operators (torch), batched over a leading axis.

Counterparts of heal_tpu/ops/pointnet.py (FPV-RCNN's keypoints and RoI
grid pooling), with the same semantics on fixed shapes; padded points
(``mask`` False) are never sampled or grouped. JAX vmaps them over the
agents; here every function takes a leading batch axis, so all the
agents of a frame run in one pass:

  * ``farthest_point_sample``: iterative FPS, every row at once, with no
    host sync inside the loop (one short launch sequence a step); the
    first valid point starts, ``argmax`` takes the first maximum, padded
    points carry -BIG and never win; with fewer valid points than
    samples the picks repeat;
  * ``ball_query``: the ``nsample`` nearest valid points of each query
    (``lax.top_k`` of -d^2: ascending d^2, the lower index first among
    equal ones, here by a stable sort), valid where d^2 <= radius^2;
    computed in query chunks, which bound the distance matrix and do not
    change the result;
  * ``group_and_pool``: the neighbours' xyz relative to the query, their
    features, a per-point MLP, and the max over the valid neighbours
    (``amax``: ties share the gradient, as JAX's max), 0 for a query with
    none.

These are plain PyTorch, as JAX's are XLA ops: no TPU kernel stands
behind them.
"""
from __future__ import annotations

from typing import Callable

import torch

BIG = 1e9


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b, c = x.shape[0], x.shape[-1]
    flat = idx.reshape(b, -1, 1).expand(-1, -1, c)
    return torch.gather(x, 1, flat).reshape(idx.shape + (c,))


def farthest_point_sample(points: torch.Tensor, mask: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """points (B, N, 3), mask (B, N) -> (B, num_samples) int32 indices."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    neg = torch.full((), -BIG, dtype=points.dtype, device=points.device)
    dist = torch.where(mask, torch.full_like(neg, BIG), neg)
    idx = torch.zeros((b, num_samples), dtype=torch.int64,
                      device=points.device)
    last = torch.argmax(mask.to(torch.int32), dim=1)  # the first valid point
    idx[:, 0] = last
    for i in range(1, num_samples):
        delta = points - points[rows, last][:, None, :]
        nd = (delta * delta).sum(-1)
        dist = torch.minimum(dist, torch.where(mask, nd, neg))
        last = torch.argmax(dist, dim=1)
        idx[:, i] = last
    return idx.to(torch.int32)


def ball_query(queries: torch.Tensor, points: torch.Tensor,
               mask: torch.Tensor, radius: float, nsample: int,
               chunk: int = 256):
    """queries (B, K, 3), points (B, N, 3), mask (B, N) -> (neighbors
    (B, K, nsample) int32, valid (B, K, nsample) bool)."""
    r2 = radius * radius
    idx_out, valid_out = [], []
    for start in range(0, queries.shape[1], chunk):
        qc = queries[:, start:start + chunk]
        d2 = ((qc[:, :, None, :] - points[:, None, :, :]) ** 2).sum(-1)
        d2 = torch.where(mask[:, None, :], d2,
                         torch.full((), BIG, dtype=d2.dtype,
                                    device=d2.device))
        near, idx = torch.sort(d2, dim=-1, stable=True)
        idx_out.append(idx[..., :nsample].to(torch.int32))
        valid_out.append(near[..., :nsample] <= r2)
    return torch.cat(idx_out, dim=1), torch.cat(valid_out, dim=1)


def group_and_pool(queries: torch.Tensor, points: torch.Tensor,
                   feats: torch.Tensor | None, idx: torch.Tensor,
                   valid: torch.Tensor,
                   mlp: Callable[[torch.Tensor], torch.Tensor]):
    """queries (B, K, 3); points (B, N, 3); feats (B, N, C) or None;
    idx / valid (B, K, S); mlp: (B, K, S, C_in) -> (B, K, S, C_out).
    -> (B, K, C_out)."""
    idx = idx.long()
    rel = _gather(points, idx) - queries[:, :, None, :]
    parts = [rel]
    if feats is not None:
        parts.append(_gather(feats, idx))
    out = mlp(torch.cat(parts, dim=-1))
    out = torch.where(valid[..., None], out,
                      torch.full((), -BIG, dtype=out.dtype,
                                 device=out.device))
    pooled = out.amax(dim=2)
    any_valid = valid.any(dim=2, keepdim=True)
    return torch.where(any_valid, pooled, torch.zeros_like(pooled))
