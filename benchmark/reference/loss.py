"""Plain loss of HEAL's Pyramid Fusion training, and one plain train
step.

After heal_tpu_torch/losses/point_pillar_loss.py,
point_pillar_pyramid_loss.py and parallel/trainer.py at commit 067a829:
the fused output's sigmoid focal classification loss (positives weighted
``pos_cls_weight``, both over the sample's positive count), smooth-L1
regression on the sin-difference yaw encoding, the direction-bin cross
entropy; plus, times ``single_weight``, each agent's occupancy focal
loss at every pyramid level against its own labels, max-pooled to the
level. One step: forward in train mode, the loss, backward, Adam.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def focal(logits, labels, weights, alpha, gamma):
    p = torch.sigmoid(logits)
    a = labels * alpha + (1 - labels) * (1 - alpha)
    pt = labels * (1 - p) + (1 - labels) * p
    bce = (torch.clamp(logits, min=0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    return bce * a * pt ** gamma * weights


def smooth_l1(diff, weights, sigma):
    cut = 1.0 / sigma ** 2
    d = diff.abs()
    return torch.where(d < cut, 0.5 * (sigma * diff) ** 2, d - 0.5 * cut) \
        * weights


def detection(out, tgt, a: dict):
    b = out["cls_preds"].shape[0]
    labels = tgt["pos_equal_one"].reshape(b, -1, 1)
    pos = labels > 0
    neg = tgt["neg_equal_one"].reshape(b, -1, 1) > 0
    norm = pos.sum(1, keepdim=True).float().clamp(min=1)
    cls = focal(out["cls_preds"].reshape(b, -1, 1), labels.float(),
                (pos * a["pos_cls_weight"] + neg * 1.0) / norm,
                a["cls"]["alpha"], a["cls"]["gamma"])
    cls = cls.sum() * a["cls"]["weight"] / b
    rw = pos.float() / norm
    rp = out["reg_preds"].reshape(b, -1, 7)
    rt = tgt["targets"].reshape(b, -1, 7)
    yaw_p = torch.sin(rp[..., 6:]) * torch.cos(rt[..., 6:])
    yaw_t = torch.cos(rp[..., 6:]) * torch.sin(rt[..., 6:])
    diff = torch.cat([rp[..., :6] - rt[..., :6], yaw_p - yaw_t], -1)
    reg = smooth_l1(diff, rw, a["reg"]["sigma"]).sum() * a["reg"][
        "weight"] / b
    d = a["dir"]["args"]
    bins = d["num_bins"]
    yaws = torch.tensor(np.radians(d["anchor_yaw"]), dtype=torch.float32,
                        device=rt.device)
    rot = rt[..., 6] + yaws.repeat(rt.shape[1] // len(yaws))[None]
    off = rot - d["dir_offset"]
    off = off - torch.floor(off / (2 * math.pi)) * 2 * math.pi
    label = torch.clamp(torch.floor(off / (2 * math.pi / bins)).long(), 0,
                        bins - 1)
    logp = F.log_softmax(out["dir_preds"].reshape(b, -1, bins), -1)
    ce = -logp.gather(-1, label[..., None])[..., 0]
    dirl = (ce * rw[..., 0]).sum() * a["dir"]["weight"] / b
    return cls + reg + dirl


def occupancy(occs, pos, neg, a: dict):
    b = pos.shape[0]
    occ_pos = (pos > 0).any(-1, keepdim=True).float().permute(0, 3, 1, 2)
    occ_neg = (neg > 0).all(-1, keepdim=True).float().permute(0, 3, 1, 2)
    total = 0.0
    for i, logits in enumerate(occs):
        k = a["pyramid"]["relative_downsample"][i]
        p = F.max_pool2d(occ_pos, k, k) if k > 1 else occ_pos
        n = 1 - F.max_pool2d(1 - occ_neg, k, k) if k > 1 else occ_neg
        p, n = p.reshape(b, -1, 1), n.reshape(b, -1, 1)
        w = (p * a["pos_cls_weight"] + n) / p.sum(1, keepdim=True).clamp(
            min=1)
        loss = focal(logits.reshape(b, -1, 1), p, w, a["cls"]["alpha"],
                     a["cls"]["gamma"])
        total = total + loss.sum() / b * a["pyramid"]["weight"][i]
    return total


def total_loss(out, batch, a: dict):
    single = {k: batch[f"{k}_single"].flatten(0, 1)
              for k in ("pos_equal_one", "neg_equal_one")}
    return detection(out, batch, a) + a.get("single_weight", 1.0) * \
        occupancy(out["occ_single_list"], single["pos_equal_one"],
                  single["neg_equal_one"], a)


def adam(model, hypes: dict):
    o = hypes["optimizer"]
    return torch.optim.Adam(model.parameters(), lr=o["lr"],
                            eps=float(o["args"]["eps"]),
                            weight_decay=float(o["args"]["weight_decay"]))


def step(model, opt, batch, hypes: dict) -> torch.Tensor:
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = total_loss(model(batch), batch, hypes["loss"]["args"])
    loss.backward()
    opt.step()
    return loss.detach()
