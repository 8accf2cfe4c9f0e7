"""Where2comm communication module (torch): confidence-masked sharing.

Counterpart of heal_tpu/models/fuse/where2comm_comm.py (ref
comm_modules/where2comm.py:34-79): each sender transmits only the BEV
cells whose smoothed detection confidence exceeds a threshold, as a
multiplicative 0/1 gate; the comm rate is the fraction of cells sent.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class CommMask(nn.Module):
    """Per-agent transmission masks from confidence maps.

    The smoothing kernel is the reference's UNNORMALISED Gaussian,
    exp(-r^2 / 2 sigma^2) / (2 pi sigma), applied with SAME zero padding;
    a cell is sent where the smoothed confidence is strictly above the
    threshold. In train mode with a ``comm`` stream (the trainer's,
    layers.rng_streams) the threshold is drawn per call as
    thr * 10^U(-lo, hi), so the fusion trains against the whole sweep of
    bandwidth budgets; without a stream it stays fixed, as in JAX.
    """

    stream = "comm"

    def __init__(self, threshold: float = 0.01, gaussian_smooth: bool = True,
                 smooth_kernel: int = 5, smooth_sigma: float = 1.0,
                 train_sample_exp_lo: float = 1.0,
                 train_sample_exp_hi: float = 1.0):
        super().__init__()
        self.threshold = threshold
        self.gaussian_smooth = gaussian_smooth
        self.smooth_kernel = smooth_kernel
        self.smooth_sigma = smooth_sigma
        self.exp_lo = train_sample_exp_lo
        self.exp_hi = train_sample_exp_hi
        self.generator = None

    def kernel(self, dtype, device) -> torch.Tensor:
        k, s = self.smooth_kernel, self.smooth_sigma
        ax = torch.arange(k, dtype=torch.float32, device=device) - (k - 1) / 2
        g1 = torch.exp(-(ax ** 2) / (2 * s ** 2))
        g2 = torch.outer(g1, g1) / (2 * math.pi * s)
        return g2[None, None].to(dtype)

    def forward(self, confidence: torch.Tensor):
        """confidence (B, L, H, W, 1) in [0, 1] -> (mask (B, L, H, W, 1)
        in {0, 1}, comm_rate: the mean of the mask over every slot)."""
        conf = confidence
        if self.gaussian_smooth:
            b, l, h, w, _ = conf.shape
            flat = conf.reshape(b * l, 1, h, w)
            flat = F.conv2d(flat, self.kernel(conf.dtype, conf.device),
                            padding=self.smooth_kernel // 2)
            conf = flat.reshape(b, l, h, w, 1)
        thr = torch.full((), self.threshold, dtype=torch.float32,
                         device=conf.device)
        gen = self.generator
        if self.training and gen is not None:
            u = torch.rand((), generator=gen, device=gen.device)
            u = u.to(conf.device) * (self.exp_lo + self.exp_hi) - self.exp_lo
            thr = thr * torch.pow(10.0, u)
        mask = (conf > thr).to(confidence.dtype)
        return mask, mask.mean()


def apply_comm_mask(features: torch.Tensor, mask: torch.Tensor,
                    ego_slot: int = 0) -> torch.Tensor:
    """Gate the non-ego agents' features by their transmission masks; the
    ego keeps its own full features."""
    gated = features * mask
    keep = torch.zeros(features.shape[1], dtype=torch.bool,
                       device=features.device)
    keep[ego_slot] = True
    return torch.where(keep[None, :, None, None, None], features, gated)
