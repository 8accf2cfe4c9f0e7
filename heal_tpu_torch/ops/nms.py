"""Fixed-shape rotated NMS (torch).

Counterpart of heal_tpu/ops/nms.py: score-sorted top-K candidates, a K×K
rotated-IoU matrix, and greedy NMS solved as a fixpoint of
``keep_j = valid_j & not any_{i<j}(keep_i & iou_ij > thr)``.
"""
from __future__ import annotations

import torch

from .. import trace
from ..utils.rotated_iou import rotated_iou_matrix


def nms_rotated_fixed(
    corners_bev: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
) -> torch.Tensor:
    """Greedy rotated NMS over a fixed-size candidate set.

    corners_bev (K, 4, 2) score-sorted descending; scores (K,) (documents
    the order only); valid (K,) bool. Returns the (K,) bool keep mask.

    Any fixpoint of the recurrence equals the greedy solution, and each
    iteration extends the correct prefix by at least one index, so it
    converges in about the depth of the longest suppression chain. The
    loop runs on the host and reads ``changed`` back once per iteration:
    one device sync per iteration, a few per frame, each counted as
    ``host_sync.nms`` (JAX runs the same fixpoint inside a
    ``lax.while_loop``).
    """
    del scores
    k = corners_bev.shape[0]
    iou = rotated_iou_matrix(corners_bev, corners_bev)
    order = torch.arange(k, device=corners_bev.device)
    sup = (
        (iou > iou_threshold) & (order[:, None] < order[None, :])
    ).to(torch.float32)  # sup[i, j]: kept i would suppress later j
    keep = valid
    for _ in range(k):
        hit = keep.to(torch.float32) @ sup
        new = valid & (hit < 0.5)
        changed = bool(torch.any(new != keep))
        trace.count("host_sync.nms")
        keep = new
        if not changed:
            break
    return keep
