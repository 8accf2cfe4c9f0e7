"""PIXOR detectors (torch): ``pixor`` and ``pixor_intermediate``.

Counterparts of heal_tpu/models/pixor.py. ``bev_rasterize`` turns the
points into a dense (B, ny, nx, z_slabs + 1) volume: one occupancy
channel a z slab (a sorted segment max of the in-range flags) and the
column's mean intensity (each slab's mean, a sorted segment sum, then
the mean over the slabs); the ids are sorted stably, as ``jnp.argsort``.
A ResNet BEV backbone and the shrink follow, then the heads: by default
CenterPoint's anchor-free ``CenterHeads`` (``anchor_free: True``;
CenterPoint's targets, loss and decode), or with ``pixor_head`` PIXOR's
own 3x3 convs ``cls_head`` (1 channel) and ``reg_head`` (6 channels:
cos, sin, dx, dy, log w, log l), the outputs ``cls`` and ``reg`` that
``pixor_loss`` reads against ``targets.generate_pixor_label_map``. The
intermediate variant fuses the agents' maps with the config's
``fusion_method`` (default max), whose warp runs kernel 2; nothing else
here runs a kernel. Module names follow flax's (``ResNetBEVBackbone_0``,
``DownsampleConv_0``, the fusion's ``<Class>_0``, ``CenterHeads_0``).
"""
from __future__ import annotations

from typing import Sequence

import torch

from .center_point import CenterHeads
from .layers import Conv
from .point_pillar import (IntermediateChain, _backbone_from_args,
                           _shrink_from_args)
from .registry import register_model


def bev_rasterize(points: torch.Tensor, mask: torch.Tensor,
                  lidar_range: Sequence[float], res: float,
                  z_slabs: int) -> torch.Tensor:
    """points (B, N, 4) + mask (B, N) -> (B, ny, nx, z_slabs + 1) f32:
    occupancy per z slab, then the mean intensity over the column."""
    b = points.shape[0]
    x0, y0, z0, x1, y1, z1 = lidar_range
    nx = int(round((x1 - x0) / res))
    ny = int(round((y1 - y0) / res))
    dz = (z1 - z0) / z_slabs
    xi = torch.floor((points[..., 0] - x0) / res).to(torch.int32)
    yi = torch.floor((points[..., 1] - y0) / res).to(torch.int32)
    zi = torch.floor((points[..., 2] - z0) / dz).to(torch.int32)
    ok = (mask & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
          & (zi >= 0) & (zi < z_slabs))
    cells = ny * nx * z_slabs + 1
    ids = torch.where(ok, (yi * nx + xi) * z_slabs + zi,
                      torch.full_like(xi, ny * nx * z_slabs))
    offs = torch.arange(b, dtype=ids.dtype, device=ids.device)[:, None]
    flat = (ids + offs * cells).reshape(-1)
    order = torch.argsort(flat, stable=True)
    idx = flat[order].long()
    okf = ok.reshape(-1)[order].to(points.dtype)
    inten = points[..., 3].reshape(-1)[order] * okf
    occ = torch.full((b * cells,), float("-inf"), dtype=okf.dtype,
                     device=okf.device).scatter_reduce(
        0, idx, okf, "amax", include_self=True)
    zero = torch.zeros((), dtype=okf.dtype, device=okf.device)
    occ = torch.maximum(torch.where(torch.isfinite(occ), occ, zero), zero)
    isum = torch.zeros((b * cells, 2), dtype=okf.dtype,
                       device=okf.device).index_add(
        0, idx, torch.stack([inten, okf], 1))
    imean = isum[:, 0] / torch.clamp(isum[:, 1], min=1.0)
    occ = occ.reshape(b, cells)[:, :-1].reshape(b, ny, nx, z_slabs)
    im = imean.reshape(b, cells)[:, :-1].reshape(b, ny, nx, z_slabs)
    im = im.mean(-1, keepdim=True)
    return torch.cat([occ, im], dim=-1)


class _PixorChain(IntermediateChain):
    """Rasterizer -> backbone -> shrink, and the heads; the fusion of
    ``IntermediateChain`` for the intermediate variant."""

    def _build_pixor(self, a: dict) -> int:
        self.args = a
        norm = a.get("norm", "batch")
        self.res = a.get("bev_res", a.get("voxel_size", [0.4])[0])
        self.z_slabs = a.get("z_slabs", 10)
        self.ResNetBEVBackbone_0 = _backbone_from_args(a, self.z_slabs + 1,
                                                       norm)
        width = self.ResNetBEVBackbone_0.out_channels
        shrink = _shrink_from_args(a, width)
        if shrink is not None:
            self.DownsampleConv_0 = shrink
            width = a["shrink_header"]["dim"][-1]
        return width

    def _build_heads(self, width: int) -> None:
        """PIXOR's own heads (ref models/pixor.py:233-234,250-253), biased
        3x3 convs ``cls_head`` and ``reg_head``, or ``CenterHeads``."""
        self.pixor_head = bool(self.args.get("pixor_head"))
        if self.pixor_head:
            self.cls_head = Conv(width, 1, kernel=3)
            self.reg_head = Conv(width, 6, kernel=3)
        else:
            self.CenterHeads_0 = CenterHeads(width)

    def features(self, points: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        """(N, P, 4) points -> the (N, C, H, W) map after the shrink."""
        bev = bev_rasterize(points, mask, self.args["lidar_range"],
                            self.res, self.z_slabs)
        wdt = next(self.ResNetBEVBackbone_0.parameters()).dtype
        # contiguous NCHW: torch's CPU conv backward corrupts its heap on
        # this 9- or 11-channel input in the channels-last strides of the
        # permute
        bev = bev.permute(0, 3, 1, 2).to(wdt).contiguous()
        feat = self.ResNetBEVBackbone_0(bev)
        shrink = getattr(self, "DownsampleConv_0", None)
        return feat if shrink is None else shrink(feat)

    def heads(self, feat: torch.Tensor) -> dict:
        if self.pixor_head:
            return {"cls": self.cls_head(feat).permute(0, 2, 3, 1),
                    "reg": self.reg_head(feat).permute(0, 2, 3, 1)}
        out = self.CenterHeads_0(feat)
        out["anchor_free"] = True
        return out


@register_model("pixor")
class Pixor(_PixorChain):
    """args: lidar_range, bev_res (else voxel_size[0], else 0.4),
    z_slabs (10), base_bev_backbone, (shrink_header), (pixor_head).
    Batch: points (B, N, 4), point_mask (B, N)."""

    needs_max_cav = False
    batch_keys = ("points", "point_mask")

    def __init__(self, args: dict):
        super().__init__()
        self._build_heads(self._build_pixor(args))

    def forward(self, batch: dict) -> dict:
        feat = self.features(batch["points"], batch["point_mask"])
        out = self.heads(feat)
        out["spatial_features_2d"] = feat.permute(0, 2, 3, 1)
        return out


@register_model("pixor_intermediate")
class PixorIntermediate(_PixorChain):
    """``Pixor``'s chain on every agent slot of a (B, L) batch, the
    config's ``fusion_method`` (default max; ``in_channels`` the map's
    width) under flax's auto-name, then the heads."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        width = self._build_pixor(args)
        method = args.get("fusion_method", "max")
        fusion_args = dict(args.get(method, {}) or {})
        fusion_args.setdefault("in_channels", width)
        self._build_heads(self._build_fusion(method, fusion_args, width,
                                             max_cav))

    def forward(self, batch: dict) -> dict:
        points, pmask = batch["points"], batch["point_mask"]
        b, l = points.shape[:2]
        feat = self.features(points.reshape((b * l,) + points.shape[2:]),
                             pmask.reshape((b * l,) + pmask.shape[2:]))
        return self.fused_heads(feat, b, l, batch, self.heads)
