"""Lift-Splat-Shoot camera encoder (multi-camera images -> BEV), torch.

Counterpart of heal_tpu/models/lift_splat_shoot.py (``Up``,
``CameraEncoder``, ``LiftSplatShootEncoder``): a CNN image backbone with
a categorical depth head, the frustum lifted through the intrinsics and
extrinsics, and a depth-weighted splat of the pixel features into the BEV
grid. Module and parameter names are the flax paths
(``cam_encoder.ConvNormAct_0`` .. ``_8``, ``cam_encoder.Up_0``,
``cam_encoder.depth_head``, ``cam_encoder.image_head``), so
utils/bridge.py maps a heal_tpu m2 checkpoint onto them.

The splat, BEV(cell, c) = sum over frustum points p in the cell of
depth_prob(p) * feat(pixel(p), c), runs in one of three forms:
  * sum or max pool with the host-presorted flat plan (``splat_ids``,
    ``splat_widx``: utils/camera.frustum_splat_plan): one gather of a
    depth weight and a feature row per frustum point, then a segment sum
    (``index_add_``, deterministic on CUDA under
    ``torch.use_deterministic_algorithms``) or a segment max over the
    cell ids. JAX's sum-pool form, the dense W matrix of
    ``_splat_matrix`` ((Ncam*fH*fW) x (cells+1), 201 MB an agent at the
    published size) contracted on the MXU, is a TPU device and is not
    carried over; the function is the same, and the parity tests hold it
    against that form;
  * without a plan (``_splat``), the frustum's geometry on the device and
    the same segment reduction over the whole depth x feature volume.
The sum accumulates in f32 (f64 for f64 inputs) whatever the compute
dtype. There is no hand-written kernel here: JAX's splat is XLA segment
ops, not a Pallas kernel; chip_smoke.py times it on the card.

Layouts are JAX's at the boundary: images (B, N, H, W, 3), the BEV
(B, ny, nx, C) and the depth logits (B*N, fH, fW, D) are NHWC views of
the NCHW convolutions' outputs.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.camera import depth_discretization, gen_dx_bx
from .layers import Conv, ConvNormAct


def _accumulated(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the sum's accumulation dtype: f32, or f64 for f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Up(nn.Module):
    """Bilinear upsample to the skip's size, concat, two ConvNormActs.

    ``jax.image.resize(..., "bilinear")`` samples at half-pixel centres,
    which is ``F.interpolate(align_corners=False)`` when upsampling (the
    only use here, at any ratio)."""

    def __init__(self, cin: int, features: int, norm: str = "batch"):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(cin, features, 3, 1, norm=norm)
        self.ConvNormAct_1 = ConvNormAct(features, features, 3, 1, norm=norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, size=tuple(skip.shape[-2:]), mode="bilinear",
                          align_corners=False)
        return self.ConvNormAct_1(self.ConvNormAct_0(torch.cat([x, skip], 1)))


class CameraEncoder(nn.Module):
    """Image backbone + depth / feature heads: (N, 3, H, W) ->
    (depth logits (N, D, fH, fW), features (N, C, fH, fW)) at stride 16."""

    WIDTHS = (32, 48, 96, 160, 320)

    def __init__(self, depth_bins: int, features: int, norm: str = "batch"):
        super().__init__()
        w = self.WIDTHS
        self.ConvNormAct_0 = ConvNormAct(3, w[0], 3, 2, norm=norm)  # /2
        for i in range(1, len(w)):
            self.add_module(f"ConvNormAct_{2 * i - 1}",
                            ConvNormAct(w[i - 1], w[i], 3, 2, norm=norm))
            self.add_module(f"ConvNormAct_{2 * i}",
                            ConvNormAct(w[i], w[i], 3, 1, norm=norm))
        self.Up_0 = Up(w[4] + w[3], 512, norm=norm)  # /32 up to /16
        self.depth_head = Conv(512, depth_bins, 1)
        self.image_head = Conv(512, features, 1)

    def forward(self, x: torch.Tensor):
        x = self.ConvNormAct_0(x)
        skips = []
        for i in range(1, len(self.WIDTHS)):
            x = getattr(self, f"ConvNormAct_{2 * i}")(
                getattr(self, f"ConvNormAct_{2 * i - 1}")(x))
            skips.append(x)  # strides 4, 8, 16, 32
        x = self.Up_0(skips[3], skips[2])
        return self.depth_head(x), self.image_head(x)


class LiftSplatShootEncoder(nn.Module):
    """args: grid_conf {xbound, ybound, zbound, ddiscr, mode},
    img_downsample, img_features, (pool: 'sum' | 'max')."""

    def __init__(self, args: dict, norm: str = "batch"):
        super().__init__()
        gc = args["grid_conf"]
        self.depth_values = depth_discretization(*gc["ddiscr"], gc["mode"])
        self.D = len(self.depth_values)
        self.C = int(args["img_features"])
        self.downsample = int(args.get("img_downsample", 16))
        self.pool = args.get("pool", "sum")
        dx, bx, nx = gen_dx_bx(gc["xbound"], gc["ybound"], gc["zbound"])
        self.dx, self.bx = dx, bx
        self.nx = tuple(int(v) for v in nx)
        self.cam_encoder = CameraEncoder(self.D, self.C, norm=norm)
        self.out_channels = self.C

    @property
    def cells(self) -> int:
        return self.nx[0] * self.nx[1]

    def frustum(self, fh: int, fw: int, device) -> torch.Tensor:
        """(D, fH, fW, 3) of (u_px, v_px, depth) in final-image pixels."""
        ds = np.asarray(self.depth_values, np.float32)[:, None, None]
        xs = np.linspace(0, fw * self.downsample - 1, fw,
                         dtype=np.float32)[None, None, :]
        ys = np.linspace(0, fh * self.downsample - 1, fh,
                         dtype=np.float32)[None, :, None]
        ds, ys, xs = np.broadcast_arrays(ds, ys, xs)
        return torch.from_numpy(np.stack([xs, ys, ds], axis=-1)).to(device)

    def geometry(self, fh, fw, rots, trans, intrins, post_rots, post_trans):
        """Frustum -> agent-frame points, f32 whatever the inputs' dtype:
        (..., N_cam, 3, 3) calibration -> (..., N_cam, D, fH, fW, 3)."""
        rots, trans, intrins, post_rots, post_trans = (
            a.float() for a in (rots, trans, intrins, post_rots, post_trans))
        pts = self.frustum(fh, fw, rots.device)
        pts = pts - post_trans[..., None, None, None, :]
        pts = torch.einsum("...ij,...dhwj->...dhwi",
                           torch.linalg.inv(post_rots), pts)
        pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], -1)
        combine = rots @ torch.linalg.inv(intrins)
        pts = torch.einsum("...ij,...dhwj->...dhwi", combine, pts)
        return pts + trans[..., None, None, None, :]

    def forward(self, inputs: dict):
        """inputs: imgs (B, N, H, W, 3), rots / post_rots / intrins
        (B, N, 3, 3), trans / post_trans (B, N, 3), and the plan
        (``splat_ids``, ``splat_widx``, (B, N*fH*fW*D)) when the host made
        one. -> (BEV (B, ny, nx, C), depth logits (B*N, fH, fW, D))."""
        imgs = inputs["imgs"]
        b, n, ih, iw, _ = imgs.shape
        fh, fw = ih // self.downsample, iw // self.downsample
        wdt = self.cam_encoder.depth_head.kernel.dtype
        x = imgs.reshape(b * n, ih, iw, 3).permute(0, 3, 1, 2).to(wdt)
        depth_logits, feat = self.cam_encoder(x)
        depth_prob = torch.softmax(depth_logits, dim=1)
        # (cam, v, u, d) point order, as the plans index it
        prob = depth_prob.permute(0, 2, 3, 1).reshape(b, -1)
        feat = feat.permute(0, 2, 3, 1).reshape(b, n * fh * fw, self.C)
        if "splat_ids" in inputs:
            bev = self._splat_presorted(inputs["splat_ids"],
                                        inputs["splat_widx"], prob, feat)
        else:
            geom = self.geometry(fh, fw, inputs["rots"], inputs["trans"],
                                 inputs["intrins"], inputs["post_rots"],
                                 inputs["post_trans"])
            bev = self._splat(geom, prob, feat, fh, fw)
        return bev.to(feat.dtype), depth_logits.permute(0, 2, 3, 1)

    def _segment(self, seg: torch.Tensor, vals: torch.Tensor, b: int):
        """Reduce (P, C) rows into b*(cells+1) segments (the last of each
        agent is the dump cell) -> (b, ny, nx, C) f32."""
        rows = b * (self.cells + 1)
        if self.pool == "max":
            # as JAX: empty cells 0, and the max clamped at 0
            canvas = vals.new_zeros((rows, vals.shape[1])).scatter_reduce(
                0, seg[:, None].expand(-1, vals.shape[1]), vals, "amax",
                include_self=True)
        else:
            canvas = vals.new_zeros((rows, vals.shape[1])).index_add_(
                0, seg, vals)
        canvas = canvas.reshape(b, self.cells + 1, -1)[:, :self.cells]
        return canvas.reshape(b, self.nx[1], self.nx[0], -1)

    def _splat_presorted(self, ids, widx, prob, feat):
        """Host-sorted cell ids + point indices (per agent (P,); dump id =
        cells) -> (b, ny, nx, C): one depth weight and one feature row
        gathered per point, reduced over the cells."""
        b, p = ids.shape
        dev = ids.device
        agent = torch.arange(b, device=dev)[:, None]
        # JAX's safety net (associative_scan max): monotone ids within
        # each agent even if a caller ships unsorted ones
        ids = torch.cummax(ids.long(), dim=1).values
        widx = widx.long()
        w = prob.reshape(-1).index_select(
            0, (widx + agent * prob.shape[1]).reshape(-1))
        f = feat.reshape(-1, self.C).index_select(
            0, (widx // self.D + agent * feat.shape[1]).reshape(-1))
        if self.pool != "max":
            w, f = _accumulated(w), _accumulated(f)
        seg = (ids + agent * (self.cells + 1)).reshape(-1)
        return self._segment(seg, w[:, None] * f, b)

    def _splat(self, geom, prob, feat, fh, fw):
        """No plan: the cell of every frustum point from its geometry
        (B, N, D, fH, fW, 3), and the depth x feature volume reduced over
        the cells."""
        b, n = geom.shape[:2]
        lo = torch.tensor(self.bx - self.dx / 2.0, dtype=torch.float32,
                          device=geom.device)
        dx = torch.tensor(self.dx, dtype=torch.float32, device=geom.device)
        idx = torch.floor((geom - lo) / dx).long()
        n_x, n_y, n_z = self.nx
        xi, yi, zi = idx[..., 0], idx[..., 1], idx[..., 2]
        valid = ((xi >= 0) & (xi < n_x) & (yi >= 0) & (yi < n_y)
                 & (zi >= 0) & (zi < n_z))
        ids = torch.where(valid, yi * n_x + xi, self.cells)  # (B,N,D,fH,fW)
        # the volume in the geometry's (cam, d, v, u) order
        prob = prob.reshape(b, n, fh, fw, self.D).permute(0, 1, 4, 2, 3)
        feat = feat.reshape(b, n, 1, fh, fw, self.C)
        if self.pool != "max":
            prob, feat = _accumulated(prob), _accumulated(feat)
        vals = (prob[..., None] * feat).reshape(-1, self.C)
        agent = torch.arange(b, device=geom.device)[:, None]
        seg = (ids.reshape(b, -1) + agent * (self.cells + 1)).reshape(-1)
        return self._segment(seg, vals, b)
