"""Inference post-processing (torch, fixed shapes).

Counterpart of heal_tpu/postprocess/decode.py ``post_process_single``:
sigmoid score -> threshold -> residual decode -> direction correction ->
project to ego -> sanity filters (extent / z band) -> rotated NMS ->
range mask, over a fixed top-K candidate set with a validity mask.

Prediction layout is NHWC, as in the JAX package: cls (H, W, A),
reg (H, W, A*7), dir (H, W, A*num_bins) per sample.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry
from ..ops.nms import nms_rotated_fixed


def post_process_single(
    cls_preds: torch.Tensor,
    reg_preds: torch.Tensor,
    dir_preds: torch.Tensor | None,
    anchors: torch.Tensor,
    transformation_matrix: torch.Tensor,
    gt_range: torch.Tensor,
    order: str = "hwl",
    score_threshold: float = 0.2,
    nms_threshold: float = 0.15,
    max_det: int = 300,
    dir_offset: float = 0.7853,
    num_bins: int = 2,
) -> dict:
    """Decode one sample's head outputs into padded detections.

    cls_preds (H, W, A) logits; reg_preds (H, W, A*7); dir_preds
    (H, W, A*num_bins) or None; anchors (H, W, A, 7) hwl;
    transformation_matrix (4, 4) to the ego frame; gt_range (6,).

    Returns dict: corners (max_det, 8, 3) in the ego frame, scores
    (max_det,), boxes (max_det, 7), valid (max_det,) bool.
    """
    h, w, a = cls_preds.shape
    n = h * w * a
    prob = torch.sigmoid(cls_preds.reshape(n))
    deltas = reg_preds.reshape(n, 7)
    boxes = geometry.decode_boxes(deltas, anchors.reshape(n, 7))

    if dir_preds is not None:
        dir_labels = torch.argmax(dir_preds.reshape(n, num_bins), dim=-1)
        yaw = geometry.correct_direction(
            boxes[:, 6], dir_labels, dir_offset, num_bins
        )
        boxes = torch.cat([boxes[:, :6], yaw[:, None]], dim=-1)

    cand_scores = torch.where(
        prob > score_threshold, prob, torch.zeros_like(prob)
    )
    top_scores, top_idx = torch.topk(cand_scores, max_det)
    top_boxes = boxes[top_idx]
    top_valid = top_scores > score_threshold

    corners = geometry.boxes_to_corners_3d(top_boxes, order)  # (K, 8, 3)
    corners = geometry.project_corners(corners, transformation_matrix)

    # extent sanity + z band (ref remove_large_pred_bbx / abnormal z)
    x_len = corners[..., 0].amax(-1) - corners[..., 0].amin(-1)
    y_len = corners[..., 1].amax(-1) - corners[..., 1].amin(-1)
    z_lo = corners[..., 2].amin(-1)
    z_hi = corners[..., 2].amax(-1)
    sane = (x_len <= 6.0) & (y_len <= 6.0) & (z_lo >= -3.0) & (z_hi <= 1.0)

    # range mask: all 8 corners inside gt_range
    inside = (
        (corners >= gt_range[0:3]) & (corners <= gt_range[3:6])
    ).all(-1).all(-1)

    valid = top_valid & sane & inside
    keep = nms_rotated_fixed(
        corners[:, :4, :2], top_scores, valid, nms_threshold
    )
    return {
        "corners": corners,
        "scores": torch.where(keep, top_scores, torch.zeros_like(top_scores)),
        "boxes": top_boxes,
        "valid": keep,
    }


def strip_padding(result: dict) -> dict:
    """Host side: padded result dict of tensors -> dense numpy arrays,
    kept detections only, sorted by descending score."""
    valid = result["valid"].cpu().numpy()
    out = {
        k: v.detach().float().cpu().numpy()[valid]
        for k, v in result.items()
        if k != "valid"
    }
    order = np.argsort(-out["scores"])
    return {k: v[order] for k, v in out.items()}
