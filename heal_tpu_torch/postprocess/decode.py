"""Inference post-processing (torch, fixed shapes).

Counterpart of heal_tpu/postprocess/decode.py ``post_process_single``:
sigmoid score -> threshold -> residual decode -> direction correction ->
project to ego -> sanity filters (extent / z band) -> rotated NMS ->
range mask, over a fixed top-K candidate set with a validity mask;
``decode_stage2``, FPV-RCNN's refined detections; and ``fuse_and_nms``,
late fusion's cross-agent merge of those sets.

Each decode runs in the tracer's ``decode`` span, and ``strip_padding``
in ``to_host`` (heal_tpu_torch/trace.py).

Prediction layout is NHWC, as in the JAX package: cls (H, W, A),
reg (H, W, A*7), dir (H, W, A*num_bins) per sample.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace
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
    anchor_free: bool = False,
    unc_preds: torch.Tensor | None = None,
) -> dict:
    """Decode one sample's head outputs into padded detections.

    cls_preds (H, W, A) logits; reg_preds (H, W, A*7); dir_preds
    (H, W, A*num_bins) or None; anchors (H, W, A, 7) hwl;
    transformation_matrix (4, 4) to the ego frame; gt_range (6,);
    unc_preds (H, W, A*udim) or None, the uncertainty detector's.
    ``anchor_free`` (CenterPoint): the regression is the box itself, and
    ``anchors`` is not read.

    Returns dict: corners (max_det, 8, 3) in the ego frame, scores
    (max_det,), boxes (max_det, 7), valid (max_det,) bool, and with
    ``unc_preds`` each candidate's ``uncertainty`` (max_det, udim):
    log-var x / y and log-kappa yaw, which CoAlign's box alignment turns
    into landmark weights.
    """
    with trace.span("decode"):
        h, w, a = cls_preds.shape
        n = h * w * a
        prob = torch.sigmoid(cls_preds.reshape(n))
        deltas = reg_preds.reshape(n, 7)
        if anchor_free:
            boxes = deltas
        else:
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
        out = {
            "corners": corners,
            "scores": torch.where(keep, top_scores,
                                  torch.zeros_like(top_scores)),
            "boxes": top_boxes,
            "valid": keep,
        }
        if unc_preds is not None:
            udim = unc_preds.numel() // n
            out["uncertainty"] = unc_preds.reshape(n, udim)[top_idx]
        return out


def decode_stage2(rois: torch.Tensor, valid: torch.Tensor,
                  rcnn_cls: torch.Tensor, rcnn_reg: torch.Tensor,
                  gt_range: torch.Tensor, score_threshold: float = 0.2,
                  nms_threshold: float = 0.15) -> dict:
    """FPV-RCNN's second-stage refinements -> padded detections, as
    ``post_process_single``'s.

    rois (R, 7) hwl ego-frame fused proposals, valid (R,); rcnn_cls (R,)
    quality logits; rcnn_reg (R, 7) roi-frame residuals in the loss's
    convention (xyz over [diag, diag, h], log dimension ratio, yaw
    delta). Scores are sigmoid(cls) on the valid RoIs; boxes inside
    ``gt_range`` above ``score_threshold`` are sorted by score (stably,
    as ``jnp.argsort``) and go through the rotated NMS."""
    with trace.span("decode"):
        scores = torch.sigmoid(rcnn_cls) * valid.to(rcnn_cls.dtype)
        diag = torch.sqrt(rois[:, 4] ** 2 + rois[:, 5] ** 2)
        scale = torch.stack([diag, diag, rois[:, 3]], dim=-1)
        xyz = rois[:, :3] + rcnn_reg[:, :3] * torch.clamp(scale, min=1e-3)
        dims = rois[:, 3:6] * torch.exp(
            torch.clamp(rcnn_reg[:, 3:6], -4.0, 4.0))
        yaw = rois[:, 6:7] + rcnn_reg[:, 6:7]
        boxes = torch.cat([xyz, dims, yaw], dim=-1)
        corners = geometry.boxes_to_corners_3d(boxes, "hwl")
        inside = ((corners >= gt_range[0:3]) & (corners <= gt_range[3:6])
                  ).all(-1).all(-1)
        ok = valid & inside & (scores > score_threshold)
        masked = torch.where(ok, scores, torch.zeros_like(scores))
        order = torch.argsort(-masked, stable=True)
        corners, scores_s = corners[order], masked[order]
        boxes_s = boxes[order]
        keep = nms_rotated_fixed(corners[:, :4, :2], scores_s, scores_s > 0.0,
                                 nms_threshold)
        return {
            "corners": corners,
            "scores": torch.where(keep, scores_s, torch.zeros_like(scores_s)),
            "boxes": boxes_s,
            "valid": keep,
        }


def fuse_and_nms(corners_list, scores_list, valid_list,
                 nms_threshold: float = 0.15, max_det: int = 300) -> dict:
    """Late fusion's merge: the agents' padded detection sets (corners
    already in the ego frame) pooled, the top ``max_det`` of the masked
    scores taken, and one rotated NMS over them (ref
    inference_utils.py:18-47). Ties keep the lower index first, as
    ``lax.top_k`` does. -> corners (max_det, 8, 3), scores, valid."""
    with trace.span("decode"):
        corners = torch.cat(list(corners_list), dim=0)
        scores = torch.cat(list(scores_list), dim=0)
        valid = torch.cat(list(valid_list), dim=0)
        masked = torch.where(valid, scores, torch.zeros_like(scores))
        top_scores, idx = torch.sort(masked, descending=True, stable=True)
        top_scores, idx = top_scores[:max_det], idx[:max_det]
        top_corners = corners[idx]
        keep = nms_rotated_fixed(top_corners[:, :4, :2], top_scores,
                                 top_scores > 0.0, nms_threshold)
        return {
            "corners": top_corners,
            "scores": torch.where(keep, top_scores,
                                  torch.zeros_like(top_scores)),
            "valid": keep,
        }


def strip_padding(result: dict) -> dict:
    """Host side: padded result dict of tensors -> dense numpy arrays,
    kept detections only, sorted by descending score. Each array's copy
    to the host is a readback (``host_sync.to_host``)."""
    with trace.span("to_host"):
        valid = result["valid"].cpu().numpy()
        out = {
            k: v.detach().float().cpu().numpy()[valid]
            for k, v in result.items()
            if k != "valid"
        }
        trace.count("host_sync.to_host", len(result))
        order = np.argsort(-out["scores"])
        return {k: v[order] for k, v in out.items()}
