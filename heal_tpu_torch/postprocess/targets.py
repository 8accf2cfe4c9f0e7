"""Anchor target assignment (host side, vectorized numpy).

The port's copy of heal_tpu/postprocess/targets.py ``generate_targets``:
  * IoU between anchor and GT *standup* (axis-aligned hull) BEV boxes,
    with the Pascal-VOC "+1" convention;
  * positives: IoU > pos_threshold, plus the highest-IoU anchor per GT
    (force-matched even below threshold, if IoU > 0);
  * negatives: anchors whose IoU with every GT < neg_threshold, minus
    force-matched ones;
  * regression targets: VoxelNet residual encoding vs the matched anchor;
and CenterPoint's anchor-free targets (``gaussian_radius``,
``generate_center_targets``): a Gaussian heatmap, and the box itself at
each GT centre's cell. The IoU matrix is numpy's (the JAX package's
fallback when its C++ host loader is not built; the loader is not
ported).
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


def gaussian_radius(h: float, w: float, min_overlap: float = 0.5) -> float:
    """CornerNet-style radius so boxes IoU>=min_overlap still hit."""
    a1, b1 = 1, h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - np.sqrt(max(b1**2 - 4 * a1 * c1, 0))) / 2
    a2, b2 = 4, 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - np.sqrt(max(b2**2 - 4 * a2 * c2, 0))) / 2
    a3, b3 = 4 * min_overlap, -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + np.sqrt(max(b3**2 - 4 * a3 * c3, 0))) / 2
    return max(min(r1, r2, r3), 0)


def generate_center_targets(
    gt_box_center: np.ndarray,
    mask: np.ndarray,
    grid_hw: tuple,
    lidar_range,
    stride_m: float,
    order: str = "hwl",
) -> dict:
    """Anchor-free CenterPoint targets (capability of reference
    center_point target assignment in loss/center_point_loss.py):
    per-cell gaussian heatmap + direct box regression at centers.

    Returns heatmap (H, W, 1), box_targets (H, W, 7), reg_mask (H, W).
    """
    h, w = grid_hw
    heatmap = np.zeros((h, w, 1), np.float32)
    boxes = np.zeros((h, w, 7), np.float32)
    reg_mask = np.zeros((h, w), np.float32)
    x0, y0 = lidar_range[0], lidar_range[1]
    gt = gt_box_center[mask == 1]
    for box in gt:
        cx = (box[0] - x0) / stride_m
        cy = (box[1] - y0) / stride_m
        if not (0 <= cx < w and 0 <= cy < h):
            continue
        # BEV dims: order hwl -> l at 5, w at 4
        bl = box[5] / stride_m
        bw = box[4] / stride_m
        radius = max(int(gaussian_radius(bw, bl)), 1)
        ci, cj = int(cy), int(cx)
        ys, xs = np.ogrid[-radius : radius + 1, -radius : radius + 1]
        g = np.exp(-(xs * xs + ys * ys) / (2 * (radius / 3 + 1e-6) ** 2))
        t, b = max(0, ci - radius), min(h, ci + radius + 1)
        l_, r = max(0, cj - radius), min(w, cj + radius + 1)
        gt_, gb = radius - (ci - t), radius + (b - ci)
        gl, gr = radius - (cj - l_), radius + (r - cj)
        heatmap[t:b, l_:r, 0] = np.maximum(
            heatmap[t:b, l_:r, 0], g[gt_:gb, gl:gr]
        )
        boxes[ci, cj] = box
        reg_mask[ci, cj] = 1.0
    return {"heatmap": heatmap, "box_targets": boxes, "reg_mask": reg_mask}
