"""Plain Lift-Splat-Shoot camera encoder (Philion and Fidler, ECCV
2020): an image CNN with a categorical depth head and a feature head at
stride 16, each pixel's features lifted along its depth bins through the
calibration, and summed into the BEV cell of each lifted point, weighted
by the depth probability.

After heal_tpu_torch/models/lift_splat_shoot.py (``Up``,
``CameraEncoder``, ``LiftSplatShootEncoder`` without a host plan) and
utils/camera.py (``gen_dx_bx``, ``depth_discretization``) at commit
067a829, with their parameter names. The splat is computed here from the
geometry of every frustum point; the program splats along plans its host
side prepares. The images carry no augmentation (post-rotation identity,
post-translation zero), as the benchmark's rigs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .model import Conv, ConvNormAct


def depth_bins(d_min, d_max, n, mode):
    if mode == "LID":
        size = 2 * (d_max - d_min) / (n * (1 + n))
        return d_min + size * (np.arange(n) * np.arange(1, 1 + n)) / 2
    if mode == "UD":
        return d_min + (d_max - d_min) / n * np.arange(n)
    raise ValueError(f"depth mode {mode!r} is not in the benchmark's "
                     "configurations")


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(cin, cout, 3, 1)
        self.ConvNormAct_1 = ConvNormAct(cout, cout, 3, 1)

    def forward(self, x, skip):
        x = F.interpolate(x, size=tuple(skip.shape[-2:]), mode="bilinear",
                          align_corners=False)
        return self.ConvNormAct_1(self.ConvNormAct_0(torch.cat([x, skip], 1)))


class CameraCNN(nn.Module):
    WIDTHS = (32, 48, 96, 160, 320)

    def __init__(self, depth: int, features: int):
        super().__init__()
        w = self.WIDTHS
        self.ConvNormAct_0 = ConvNormAct(3, w[0], 3, 2)
        for i in range(1, len(w)):
            self.add_module(f"ConvNormAct_{2 * i - 1}",
                            ConvNormAct(w[i - 1], w[i], 3, 2))
            self.add_module(f"ConvNormAct_{2 * i}",
                            ConvNormAct(w[i], w[i], 3, 1))
        self.Up_0 = Up(w[4] + w[3], 512)
        self.depth_head = Conv(512, depth, 1)
        self.image_head = Conv(512, features, 1)

    def forward(self, x):
        x = self.ConvNormAct_0(x)
        skips = []
        for i in range(1, len(self.WIDTHS)):
            x = getattr(self, f"ConvNormAct_{2 * i}")(
                getattr(self, f"ConvNormAct_{2 * i - 1}")(x))
            skips.append(x)
        x = self.Up_0(skips[3], skips[2])
        return self.depth_head(x), self.image_head(x)


class LiftSplat(nn.Module):
    """inputs: imgs (N, cams, H, W, 3), rots and intrins (N, cams, 3, 3),
    trans (N, cams, 3) -> (BEV (N, ny, nx, C), depth logits (N*cams, fH,
    fW, D))."""

    def __init__(self, enc: dict):
        super().__init__()
        g = enc["grid_conf"]
        self.depths = depth_bins(*g["ddiscr"], g["mode"])
        self.ds = int(enc.get("img_downsample", 16))
        self.C = int(enc["img_features"])
        rows = (g["xbound"], g["ybound"], g["zbound"])
        self.dx = np.array([r[2] for r in rows])
        self.lo = np.array([r[0] for r in rows])
        self.n = [int(round((r[1] - r[0]) / r[2])) for r in rows]
        self.cam_encoder = CameraCNN(len(self.depths), self.C)
        self.out_channels = self.C

    def forward(self, inputs):
        imgs = inputs["imgs"]
        b, cams, ih, iw, _ = imgs.shape
        fh, fw = ih // self.ds, iw // self.ds
        logits, feat = self.cam_encoder(
            imgs.flatten(0, 1).permute(0, 3, 1, 2))
        prob = torch.softmax(logits, 1)                   # (b*cams, D, h, w)
        dev = imgs.device
        d = torch.tensor(self.depths, dtype=torch.float32, device=dev)
        u = torch.linspace(0, fw * self.ds - 1, fw, device=dev)
        v = torch.linspace(0, fh * self.ds - 1, fh, device=dev)
        dd, vv, uu = torch.meshgrid(d, v, u, indexing="ij")
        pix = torch.stack([uu * dd, vv * dd, dd], -1)     # (D, h, w, 3)
        m = inputs["rots"].float() @ torch.linalg.inv(inputs["intrins"]
                                                      .float())
        pts = torch.einsum("bcij,dhwj->bcdhwi", m, pix) + inputs[
            "trans"].float()[:, :, None, None, None]
        lo = torch.tensor(self.lo, dtype=torch.float32, device=dev)
        dx = torch.tensor(self.dx, dtype=torch.float32, device=dev)
        cell = torch.floor((pts - lo) / dx).long()
        nx, ny, nz = self.n
        ok = ((cell[..., 0] >= 0) & (cell[..., 0] < nx) & (cell[..., 1] >= 0)
              & (cell[..., 1] < ny) & (cell[..., 2] >= 0)
              & (cell[..., 2] < nz))
        agent = torch.arange(b, device=dev)[:, None, None, None, None]
        ids = (agent * (ny * nx) + cell[..., 1] * nx + cell[..., 0])[ok]
        vol = prob.unflatten(0, (b, cams))[..., None] * feat.unflatten(
            0, (b, cams))[:, :, None].permute(0, 1, 2, 4, 5, 3)
        bev = torch.zeros(b * ny * nx, self.C, device=dev).index_add(
            0, ids, vol[ok])
        return bev.reshape(b, ny, nx, self.C), logits.permute(0, 2, 3, 1)
