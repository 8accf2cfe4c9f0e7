"""PointPillars detection loss (torch).

Counterpart of heal_tpu/losses/point_pillar_loss.py: sigmoid focal cls
loss with pos_cls_weight and per-sample positive normalisation,
smooth-L1 reg loss with the sin-difference yaw encoding, softmax
direction-bin loss, and the categorical focal depth loss of camera agent
types (LSS depth supervision, ``depth`` in the config). All reductions
are mask-based over fixed shapes.

Prediction layout NHWC: cls (B, H, W, A), reg (B, H, W, A*7),
dir (B, H, W, A*bins), depth_items_mX (N, fH, fW, D); targets from
postprocess/targets.py and the camera packing's ``depth_bins``.

The IoU-quality branch (``iou`` in the config, the heads' ``iou_preds``;
point_pillar_loss.py:111-155,213-222) runs once ``set_anchors`` gave it
the anchor grid, as JAX's trainer does: per sample the top K =
``max_positive_anchors`` (512) anchors by regression weight, taken by a
stable descending sort (JAX's ``lax.top_k`` keeps the lower index among
equal weights, and every positive of a sample weighs the same), the
detached predictions and the targets decoded against their anchors, and
a smooth-L1 of the IoU head on 2 * IoU - 1, weighted by the top weights.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..models.registry import register_loss
from ..ops.geometry import decode_boxes
from ..utils.common import limit_period
from ..utils.rotated_iou import aligned_boxes_iou3d


def bce_with_logits(logits, labels):
    """Elementwise, numerically stable binary cross-entropy of logits,
    max(x, 0) - x * y + log1p(exp(-|x|)), with JAX's gradient at a logit
    of exactly 0 (a zero bias on dead features, as at a seeded init):
    ``jnp.clip(x, 0, None)`` gives 0.5 there and ``jnp.abs`` 1, where
    ``torch.clamp`` gives 1 and ``torch.abs`` 0."""
    relu = torch.maximum(logits, torch.zeros_like(logits))
    abs_ = torch.where(logits >= 0, logits, -logits)
    return relu - logits * labels + torch.log1p(torch.exp(-abs_))


def sigmoid_focal_loss(logits, labels, weights, alpha: float, gamma: float):
    """Per-element focal loss, weighted."""
    pred_sigmoid = torch.sigmoid(logits)
    alpha_weight = labels * alpha + (1 - labels) * (1 - alpha)
    pt = labels * (1.0 - pred_sigmoid) + (1.0 - labels) * pred_sigmoid
    focal_weight = alpha_weight * torch.pow(pt, gamma)
    bce = bce_with_logits(logits, labels)
    return bce * focal_weight * weights


def weighted_smooth_l1(preds, targets, weights, sigma: float):
    """Huber with its transition at 1/sigma^2."""
    diff = preds - targets
    abs_diff = torch.abs(diff)
    cut = 1.0 / (sigma ** 2)
    loss = torch.where(abs_diff < cut, 0.5 * (sigma * diff) ** 2,
                       abs_diff - 0.5 * cut)
    return loss * weights


def add_sin_difference(preds, targets, dim: int = 6):
    """Replace the yaw residuals with the sin(p - t) factorisation."""
    p, t = preds[..., dim:dim + 1], targets[..., dim:dim + 1]
    rad_pred = torch.sin(p) * torch.cos(t)
    rad_tgt = torch.cos(p) * torch.sin(t)
    preds = torch.cat([preds[..., :dim], rad_pred, preds[..., dim + 1:]], -1)
    targets = torch.cat([targets[..., :dim], rad_tgt, targets[..., dim + 1:]],
                        -1)
    return preds, targets


def direction_targets(reg_targets, anchor_yaw_deg, dir_offset: float,
                      num_bins: int):
    """One-hot direction bins from the yaw residual + anchor yaw.

    reg_targets: (B, N, 7) where N = H*W*A and anchors cycle fastest.
    """
    anchor_yaw = torch.from_numpy(
        np.radians(np.asarray(anchor_yaw_deg, np.float64)).astype(np.float32)
    ).to(reg_targets.device)
    n = reg_targets.shape[1]
    anchor_map = anchor_yaw.repeat(n // anchor_yaw.shape[0])
    rot_gt = reg_targets[..., -1] + anchor_map[None, :]
    offset_rot = limit_period(rot_gt - dir_offset, 0.0, 2 * math.pi)
    bins = torch.clamp(
        torch.floor(offset_rot / (2 * math.pi / num_bins)).long(),
        0, num_bins - 1)
    return F.one_hot(bins, num_bins).to(reg_targets.dtype)


def clamp1(n):
    return torch.clamp(n, min=1.0)


def batch_divisor(count, mesh, fn=clamp1):
    """The divisor of a sum normalised over the whole batch: ``fn`` of
    ``count``. Under a device mesh (parallel/sharding.py) ``fn`` of the
    global batch's count (all-reduced over the data group, outside the
    graph) over the data size, so that the data ranks' losses average to
    the one-process loss, as JAX's global reduction gives it."""
    if mesh is None:
        return fn(count)
    return fn(mesh.data_sum(count)) / mesh.shape["data"]


def depth_focal_loss(logits, gt_bins, alpha: float = 0.25,
                     gamma: float = 2.0, mesh=None):
    """Categorical focal loss over depth bins; gt == num_bins means "no
    lidar return" and is ignored. logits (N, fH, fW, D); gt_bins
    (N, fH, fW) int. Normalised by the valid pixels of the whole batch
    (:func:`batch_divisor`)."""
    d = logits.shape[-1]
    valid = (gt_bins < d).to(logits.dtype)
    onehot = F.one_hot(torch.clamp(gt_bins.long(), 0, d - 1), d).to(
        logits.dtype)
    logp = F.log_softmax(logits, dim=-1)
    focal = alpha * (1.0 - torch.exp(logp)) ** gamma * (-logp)
    loss = (onehot * focal).sum(-1) * valid
    return loss.sum() / batch_divisor(valid.sum(), mesh)


@register_loss("point_pillar_loss")
class PointPillarLoss:
    mesh = None  # parallel/sharding.Mesh: the depth term's normaliser

    def __init__(self, args: dict):
        self.args = args
        self.pos_cls_weight = args["pos_cls_weight"]
        self.cls = args["cls"]
        self.reg = args["reg"]
        self.dir = args.get("dir")
        self.iou = args.get("iou")
        self.iou_cap = (self.iou or {}).get("max_positive_anchors", 512)
        self.anchors = None

    def set_anchors(self, anchors):
        """The (H, W, A, 7) anchor grid the IoU branch decodes against
        (tools/train.py passes the dataset's)."""
        self.anchors = torch.as_tensor(np.asarray(anchors, np.float32))

    def _iou_loss(self, output_dict, target_dict, suffix, reg_weights, b):
        # one copy to the loss's device, kept
        self.anchors = self.anchors.to(reg_weights.device)
        anchors = self.anchors.reshape(-1, 7)
        iou_preds = output_dict[f"iou_preds{suffix}"].reshape(b, -1)
        reg_preds = output_dict[f"reg_preds{suffix}"].reshape(b, -1, 7)
        reg_targets = target_dict["targets"].reshape(b, -1, 7)
        w = reg_weights.squeeze(-1)  # (B, N), > 0 at the positives
        k = min(self.iou_cap, w.shape[1])
        top_w, idx = torch.sort(w, dim=1, descending=True, stable=True)
        top_w, idx = top_w[:, :k], idx[:, :k]
        anc = anchors[idx]

        def take(t):
            return torch.gather(t, 1, idx[..., None].expand(
                -1, -1, t.shape[-1]))

        boxes_pred = decode_boxes(take(reg_preds.detach()), anc)
        boxes_tgt = decode_boxes(take(reg_targets), anc)
        iou = aligned_boxes_iou3d(boxes_pred.float(), boxes_tgt.float())
        loss = weighted_smooth_l1(torch.gather(iou_preds, 1, idx),
                                  2.0 * iou - 1.0, top_w, self.iou["sigma"])
        return loss.sum() * self.iou["weight"] / b

    def __call__(self, output_dict, target_dict, suffix: str = ""):
        cls_preds = output_dict[f"cls_preds{suffix}"]
        b = cls_preds.shape[0]
        cls_labels = target_dict["pos_equal_one"].reshape(b, -1, 1)
        positives = cls_labels > 0
        negatives = target_dict["neg_equal_one"].reshape(b, -1, 1) > 0
        pos_normalizer = torch.clamp(
            positives.sum(dim=1, keepdim=True).float(), min=1.0)

        cls_preds = cls_preds.reshape(b, -1, 1)
        cls_weights = (positives * self.pos_cls_weight
                       + negatives * 1.0) / pos_normalizer
        cls_loss = sigmoid_focal_loss(
            cls_preds, cls_labels.to(cls_preds.dtype), cls_weights,
            alpha=self.cls["alpha"], gamma=self.cls["gamma"])
        cls_loss = cls_loss.sum() * self.cls["weight"] / b

        reg_weights = positives.float() / pos_normalizer
        reg_preds = output_dict[f"reg_preds{suffix}"].reshape(b, -1, 7)
        reg_targets = target_dict["targets"].reshape(b, -1, 7)
        reg_preds_sin, reg_targets_sin = add_sin_difference(reg_preds,
                                                            reg_targets)
        reg_loss = weighted_smooth_l1(reg_preds_sin, reg_targets_sin,
                                      reg_weights, self.reg["sigma"])
        reg_loss = reg_loss.sum() * self.reg["weight"] / b

        total = cls_loss + reg_loss
        aux = {"cls_loss": cls_loss, "reg_loss": reg_loss}

        if self.dir is not None and f"dir_preds{suffix}" in output_dict:
            num_bins = self.dir["args"]["num_bins"]
            dir_tgt = direction_targets(
                reg_targets, self.dir["args"]["anchor_yaw"],
                self.dir["args"]["dir_offset"], num_bins)
            dir_logits = output_dict[f"dir_preds{suffix}"].reshape(
                b, -1, num_bins)
            ce = -(dir_tgt * F.log_softmax(dir_logits, dim=-1)).sum(-1)
            dir_loss = ((ce * reg_weights.squeeze(-1)).sum()
                        * self.dir["weight"] / b)
            total = total + dir_loss
            aux["dir_loss"] = dir_loss

        if (self.iou is not None and f"iou_preds{suffix}" in output_dict
                and self.anchors is not None):
            iou_loss = self._iou_loss(output_dict, target_dict, suffix,
                                      reg_weights, b)
            total = total + iou_loss
            aux["iou_loss"] = iou_loss
        # LSS depth supervision of every camera type present
        if "depth" in self.args:
            terms = [
                depth_focal_loss(logits, target_dict[f"depth_bins_{m}"]
                                 .reshape((-1,) + logits.shape[1:3]),
                                 mesh=self.mesh)
                for key, logits in output_dict.items()
                if key.startswith("depth_items_")
                for m in [key.rsplit("_", 1)[-1]]
                if f"depth_bins_{m}" in target_dict
            ]
            if terms:
                dloss = sum(terms) * self.args["depth"]["weight"]
                total = total + dloss
                aux["depth_loss"] = dloss

        aux["total_loss"] = total
        return total, aux
