"""Detection evaluation: greedy TP/FP matching + VOC-2010 AP (numpy).

The port's copy of heal_tpu/utils/eval_np.py: greedy matching in score
order by 2D polygon IoU over BEV corners (matched GT removed), and the
VOC-2010 all-points AP, so the port's AP is the JAX package's.
"""
from __future__ import annotations

import numpy as np

from .box_np import polygon_iou_matrix


def new_result_stat(iou_threshs=(0.3, 0.5, 0.7)) -> dict:
    return {
        t: {"tp": [], "fp": [], "gt": 0, "score": []} for t in iou_threshs
    }


def calculate_tp_fp(
    det_boxes, det_score, gt_boxes, result_stat: dict, iou_thresh: float
) -> None:
    """Accumulate TP/FP flags for one frame.

    det_boxes/gt_boxes: (N, 8, 3) or (N, 4, 2) corners (BEV xy of the first
    4 corners is used); det_score: (N,). ``det_boxes=None`` means no
    detections this frame.
    """
    stat = result_stat[iou_thresh]
    stat["gt"] += int(gt_boxes.shape[0]) if gt_boxes is not None else 0
    if det_boxes is None or det_boxes.shape[0] == 0:
        return
    det_boxes = np.asarray(det_boxes)
    det_score = np.asarray(det_score)
    gt_boxes = np.asarray(gt_boxes) if gt_boxes is not None else np.zeros((0, 4, 2))

    order = np.argsort(-det_score)
    iou = polygon_iou_matrix(det_boxes[order], gt_boxes)  # (N, G)
    gt_alive = np.ones(gt_boxes.shape[0], dtype=bool)
    tp, fp = [], []
    for i in range(order.shape[0]):
        ious = np.where(gt_alive, iou[i], -1.0)
        if ious.size == 0 or ious.max() < iou_thresh:
            fp.append(1)
            tp.append(0)
            continue
        fp.append(0)
        tp.append(1)
        gt_alive[int(np.argmax(ious))] = False
    stat["score"] += det_score[order].tolist()
    stat["tp"] += tp
    stat["fp"] += fp


def voc_ap(rec: list, prec: list):
    """VOC-2010 all-points AP from recall/precision sequences."""
    mrec = [0.0] + list(rec) + [1.0]
    mpre = [0.0] + list(prec) + [0.0]
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    ap = 0.0
    for i in range(1, len(mrec)):
        if mrec[i] != mrec[i - 1]:
            ap += (mrec[i] - mrec[i - 1]) * mpre[i]
    return ap, mrec, mpre


def calculate_ap(result_stat: dict, iou_thresh: float):
    """AP for one IoU threshold from accumulated stats."""
    stat = result_stat[iou_thresh]
    fp = np.asarray(stat["fp"], dtype=np.float64)
    tp = np.asarray(stat["tp"], dtype=np.float64)
    score = np.asarray(stat["score"], dtype=np.float64)
    assert len(fp) == len(tp) == len(score)
    if len(tp) == 0 or stat["gt"] == 0:
        return 0.0, [], []
    order = np.argsort(-score)
    fp_cum = np.cumsum(fp[order])
    tp_cum = np.cumsum(tp[order])
    rec = (tp_cum / stat["gt"]).tolist()
    prec = (tp_cum / np.maximum(fp_cum + tp_cum, 1e-12)).tolist()
    return voc_ap(rec, prec)


def eval_final_results(result_stat: dict, save_path=None, infer_info=None) -> dict:
    """Compute AP@all accumulated thresholds; optionally dump a YAML."""
    out = {}
    for t in result_stat:
        ap, mrec, mpre = calculate_ap(result_stat, t)
        key = str(int(round(t * 100)))  # reference keys: ap_30/ap_50/ap_70
        out[f"ap_{key}"] = float(ap)
        out[f"mpre_{key}"] = list(map(float, mpre))
        out[f"mrec_{key}"] = list(map(float, mrec))
    if save_path is not None:
        import os
        import yaml

        name = f"eval{('_' + infer_info) if infer_info else ''}.yaml"
        with open(os.path.join(save_path, name), "w") as f:
            yaml.safe_dump({k: v for k, v in out.items() if k.startswith("ap")}, f)
    aps = [v for k, v in out.items() if k.startswith("ap_")]
    if aps:
        summary = " | ".join(
            f"ap@{t}: {out['ap_' + str(int(round(t * 100)))]:.4f}"
            for t in result_stat
        )
        print(f"[eval] {summary}")
    return out
