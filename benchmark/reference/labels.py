"""Plain anchor grid and anchor labels (host, numpy).

After heal_tpu_torch/postprocess/anchors.py (``generate_anchor_box``),
postprocess/targets.py (``generate_targets`` on its numpy IoU path) and
data/scene.py (``_gt_in_frame``, the ``*_single`` labels) at commit
067a829: anchors on a linspace over the range inset by a voxel, two yaws
a cell; a vehicle box labels every anchor whose axis-aligned BEV IoU
("+1" convention) passes ``pos_threshold``, and its best anchor; anchors
below ``neg_threshold`` to every box are negatives; the regression
target is the residual of the box against its anchor.
"""
from __future__ import annotations

import math

import numpy as np

from . import assemble

_TEMPLATE = np.array([[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
                      [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1]]) / 2.0


def anchor_grid(hypes: dict) -> np.ndarray:
    """(H', W', A, 7) hwl anchors."""
    a = hypes["postprocess"]["anchor_args"]
    rng = a["cav_lidar_range"]
    vw, vh = hypes["preprocess"]["args"]["voxel_size"][:2]
    nx = int(round((rng[3] - rng[0]) / vw))
    ny = int(round((rng[4] - rng[1]) / vh))
    stride = a.get("feature_stride", 2)
    x = np.linspace(rng[0] + vw, rng[3] - vw, nx // stride)
    y = np.linspace(rng[1] + vh, rng[4] - vh, ny // stride)
    cx, cy = np.meshgrid(x, y)
    yaws = [math.radians(r) for r in a["r"]]
    out = np.zeros(cx.shape + (len(yaws), 7))
    out[..., 0] = cx[..., None]
    out[..., 1] = cy[..., None]
    out[..., 2] = -1.0
    out[..., 3], out[..., 4], out[..., 5] = a["h"], a["w"], a["l"]
    out[..., 6] = np.array(yaws)
    return out


def corners(boxes_hwl: np.ndarray) -> np.ndarray:
    """(N, 7) hwl boxes -> (N, 8, 3) corners."""
    b = np.asarray(boxes_hwl, np.float64)[:, [0, 1, 2, 5, 4, 3, 6]]
    local = b[:, None, 3:6] * _TEMPLATE[None]
    c, s = np.cos(b[:, 6])[:, None], np.sin(b[:, 6])[:, None]
    x = local[..., 0] * c - local[..., 1] * s
    y = local[..., 0] * s + local[..., 1] * c
    return np.stack([x, y, local[..., 2]], -1) + b[:, None, 0:3]


def boxes_in_frame(hypes: dict, objects, pose) -> tuple:
    """World lwh boxes -> (max_num, 7) hwl boxes in the frame of
    ``pose`` with at least one corner inside the range, and their mask."""
    max_num = hypes["postprocess"].get("max_num", 100)
    rng = np.asarray(hypes["postprocess"]["gt_range"], np.float64)
    out, mask = np.zeros((max_num, 7)), np.zeros(max_num)
    objs = np.asarray(objects, np.float64)
    t = np.linalg.inv(assemble.x_to_world(pose))
    centers = objs[:, :3] @ t[:3, :3].T + t[:3, 3]
    yaw = objs[:, 6] + np.arctan2(t[1, 0], t[0, 0])
    yaw = yaw - np.floor(yaw / (2 * np.pi) + 0.5) * 2 * np.pi
    hwl = np.concatenate([centers, objs[:, [5, 4, 3]], yaw[:, None]], 1)
    c = corners(hwl)
    inside = ((c >= rng[:3]) & (c <= rng[3:])).all(2).sum(1) >= 1
    hwl = hwl[inside][:max_num]
    out[:len(hwl)], mask[:len(hwl)] = hwl, 1.0
    return out, mask


def targets(boxes, mask, anchors, pos_thr, neg_thr) -> dict:
    shape, na = anchors.shape[:2], anchors.shape[2]
    flat = anchors.reshape(-1, 7)
    pos = np.zeros((*shape, na), np.float32)
    neg = np.zeros((*shape, na), np.float32)
    tgt = np.zeros((*shape, na * 7), np.float32)
    gt = boxes[mask == 1]
    if len(gt) == 0:
        neg[...] = 1.0
        return {"pos_equal_one": pos, "neg_equal_one": neg, "targets": tgt}

    def standup(b):
        c = corners(b)[:, :4, :2]
        return np.concatenate([c.min(1), c.max(1)], 1).astype(np.float32
                                                              ).astype(float)

    sa, sg = standup(flat), standup(gt)
    area_a = (sa[:, 2] - sa[:, 0] + 1) * (sa[:, 3] - sa[:, 1] + 1)
    area_g = (sg[:, 2] - sg[:, 0] + 1) * (sg[:, 3] - sg[:, 1] + 1)
    iw = (np.minimum(sa[:, None, 2], sg[None, :, 2])
          - np.maximum(sa[:, None, 0], sg[None, :, 0]) + 1)
    ih = (np.minimum(sa[:, None, 3], sg[None, :, 3])
          - np.maximum(sa[:, None, 1], sg[None, :, 1]) + 1)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    iou = np.where((iw > 0) & (ih > 0),
                   inter / (area_a[:, None] + area_g[None] - inter),
                   0.0).astype(np.float32)
    best = np.argmax(iou, 0)
    best_gt = np.arange(iou.shape[1])
    hit = iou[best, best_gt] > 0
    best, best_gt = best[hit], best_gt[hit]
    ip, ipg = np.where(iou > pos_thr)
    ineg = np.where((iou < neg_thr).all(1))[0]
    ip, index = np.unique(np.concatenate([ip, best]), return_index=True)
    ipg = np.concatenate([ipg, best_gt])[index]
    ix, iy, iz = np.unravel_index(ip, (*shape, na))
    pos[ix, iy, iz] = 1
    a, g = flat[ip], gt[ipg]
    d = np.sqrt(a[:, 4] ** 2 + a[:, 5] ** 2)
    res = np.stack([(g[:, 0] - a[:, 0]) / d, (g[:, 1] - a[:, 1]) / d,
                    (g[:, 2] - a[:, 2]) / a[:, 3],
                    *np.log(g[:, 3:6] / a[:, 3:6]).T, g[:, 6] - a[:, 6]], 1)
    for k in range(7):
        tgt[ix, iy, iz * 7 + k] = res[:, k]
    ix, iy, iz = np.unravel_index(ineg, (*shape, na))
    neg[ix, iy, iz] = 1
    ix, iy, iz = np.unravel_index(best, (*shape, na))
    neg[ix, iy, iz] = 0
    return {"pos_equal_one": pos, "neg_equal_one": neg, "targets": tgt}


def sample_labels(hypes: dict, scene: dict, keep, slots: int) -> dict:
    """The ego's labels and each agent slot's own (``*_single``; padded
    slots all zero)."""
    anchors = anchor_grid(hypes)
    ta = hypes["postprocess"]["target_args"]
    thr = (ta["pos_threshold"], ta["neg_threshold"])
    poses = [scene["agents"][i]["pose"] for i in keep]
    out = targets(*boxes_in_frame(hypes, scene["objects"], poses[0]),
                  anchors, *thr)
    single = [targets(*boxes_in_frame(hypes, scene["objects"], p), anchors,
                      *thr) for p in poses]
    for key in ("pos_equal_one", "neg_equal_one", "targets"):
        rows = [s[key] for s in single]
        rows += [np.zeros_like(out[key])] * (slots - len(rows))
        out[f"{key}_single"] = np.stack(rows)
    return out
