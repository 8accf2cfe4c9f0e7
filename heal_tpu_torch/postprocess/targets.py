"""Anchor target assignment (host side, vectorized numpy).

The port's copy of heal_tpu/postprocess/targets.py ``generate_targets``:
  * IoU between anchor and GT *standup* (axis-aligned hull) BEV boxes,
    with the Pascal-VOC "+1" convention;
  * positives: IoU > pos_threshold, plus the highest-IoU anchor per GT
    (force-matched even below threshold, if IoU > 0);
  * negatives: anchors whose IoU with every GT < neg_threshold, minus
    force-matched ones;
  * regression targets: VoxelNet residual encoding vs the matched anchor.
The IoU matrix is numpy's (the JAX package's fallback when its C++ host
loader is not built; the loader is not ported).
"""
from __future__ import annotations

import numpy as np

from ..utils import box_np


def generate_targets(
    gt_box_center: np.ndarray,
    mask: np.ndarray,
    anchors: np.ndarray,
    pos_threshold: float,
    neg_threshold: float,
    order: str = "hwl",
) -> dict:
    """Dense training targets.

    gt_box_center (max_num, 7) padded GT boxes in ``order``; mask (max_num,)
    1 for real boxes; anchors (H, W, num_anchor, 7) from
    generate_anchor_box. Returns pos_equal_one / neg_equal_one (H, W, A)
    and targets (H, W, A*7).
    """
    assert order == "hwl", "target assignment follows the hwl convention"
    feature_shape = anchors.shape[:2]
    num_anchor = anchors.shape[2]
    anchors_flat = anchors.reshape(-1, 7)
    # anchor BEV diagonal (w, l at indices 4, 5 in hwl)
    anchors_d = np.sqrt(anchors_flat[:, 4] ** 2 + anchors_flat[:, 5] ** 2)

    pos_equal_one = np.zeros((*feature_shape, num_anchor), dtype=np.float32)
    neg_equal_one = np.zeros((*feature_shape, num_anchor), dtype=np.float32)
    targets = np.zeros((*feature_shape, num_anchor * 7), dtype=np.float32)

    gt_valid = gt_box_center[mask == 1]
    if gt_valid.shape[0] == 0:
        neg_equal_one[...] = 1.0
        return {
            "pos_equal_one": pos_equal_one,
            "neg_equal_one": neg_equal_one,
            "targets": targets,
        }

    gt_corners = box_np.boxes_to_corners_3d(gt_valid, order)
    anchor_corners = box_np.boxes_to_corners_3d(anchors_flat, order)
    anchor_standup = box_np.corners_to_standup_2d(anchor_corners[:, :4, :])
    gt_standup = box_np.corners_to_standup_2d(gt_corners[:, :4, :])

    # (num_anchors, num_gt), +1 convention, in f32 as the JAX package's
    iou = box_np.standup_iou_matrix(
        anchor_standup.astype(np.float32),
        gt_standup.astype(np.float32),
        plus_one=True,
    ).astype(np.float32)

    # highest-IoU anchor per GT (force match when IoU > 0)
    id_highest = np.argmax(iou, axis=0)  # (num_gt,)
    id_highest_gt = np.arange(iou.shape[1])
    keep = iou[id_highest, id_highest_gt] > 0
    id_highest, id_highest_gt = id_highest[keep], id_highest_gt[keep]

    id_pos, id_pos_gt = np.where(iou > pos_threshold)
    id_neg = np.where((iou < neg_threshold).all(axis=1))[0]

    id_pos = np.concatenate([id_pos, id_highest])
    id_pos_gt = np.concatenate([id_pos_gt, id_highest_gt])
    id_pos, index = np.unique(id_pos, return_index=True)
    id_pos_gt = id_pos_gt[index]

    ix, iy, iz = np.unravel_index(id_pos, (*feature_shape, num_anchor))
    pos_equal_one[ix, iy, iz] = 1

    # residual encoding (gt vs matched anchor), on the compacted GT
    deltas = np.zeros((len(id_pos), 7), dtype=np.float64)
    a = anchors_flat[id_pos]
    g = gt_valid[id_pos_gt]
    d = anchors_d[id_pos]
    deltas[:, 0] = (g[:, 0] - a[:, 0]) / d
    deltas[:, 1] = (g[:, 1] - a[:, 1]) / d
    deltas[:, 2] = (g[:, 2] - a[:, 2]) / a[:, 3]
    deltas[:, 3:6] = np.log(g[:, 3:6] / a[:, 3:6])
    deltas[:, 6] = g[:, 6] - a[:, 6]
    for k in range(7):
        targets[ix, iy, iz * 7 + k] = deltas[:, k]

    ix, iy, iz = np.unravel_index(id_neg, (*feature_shape, num_anchor))
    neg_equal_one[ix, iy, iz] = 1
    # anchors force-matched to a GT are never negative
    ix, iy, iz = np.unravel_index(id_highest, (*feature_shape, num_anchor))
    neg_equal_one[ix, iy, iz] = 0

    return {
        "pos_equal_one": pos_equal_one,
        "neg_equal_one": neg_equal_one,
        "targets": targets,
    }
