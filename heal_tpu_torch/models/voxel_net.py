"""VoxelNet detectors (torch): ``voxel_net`` and ``voxel_net_intermediate``.

Counterparts of heal_tpu/models/voxel_net.py. ``VoxelNetEncoder``:
  1. each point's 3D voxel id, points out of range (or padded) sent to
     the trash cell ``nx * ny * nz`` of their sample;
  2. a stable sort of the batch-wide ids (``jnp.argsort``'s order);
  3. the VFE: ``PFNLayer`` (Dense -> masked batch norm -> ReLU) on the
     masked raw points;
  4. the voxel max (``scatter_reduce`` "amax" from -inf, JAX's sorted
     ``segment_max``; empty voxels 0, ties share the gradient);
  5. the dense (nz, ny, nx, C) grid;
  6. two 3D convs, (3, 3, 3) kernels of stride (2, 1, 1) with a bias,
     under flax's SAME padding (``SameConv3d``), each followed by the
     norm and a ReLU;
  7. z folded into channels z-major: (B, ny, nx, nz' * C) NHWC, as JAX.
No kernel runs here: the VFE is not the pillar path. The intermediate
variant fuses the agents' maps with the config's ``fusion_method``
(default max; ``in_channels`` the map's width), whose warp runs kernel
2. Modules carry flax's auto-names (``VoxelNetEncoder_0`` with
``PFNLayer_0``, ``Conv_0``, ``Norm_0``, ``Conv_1``, ``Norm_1``;
``ResNetBEVBackbone_0``, ``DownsampleConv_0``, the fusion's
``<Class>_0``, ``DetectionHeads_0``); the 3D kernels bridge DHWIO ->
OIDHW (utils/bridge.py).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoders import PFNLayer
from .heads import DetectionHeads
from .layers import Norm
from .point_pillar import DetectorChain, IntermediateChain
from .registry import register_model


class SameConv3d(nn.Module):
    """flax ``nn.Conv(features, (k, k, k), strides)`` with its bias,
    under SAME padding: ceil(size / s) outputs on each axis, the missing
    (ceil(size / s) - 1) * s + k - size planes padded total // 2 before
    and the rest after (stride (2, 1, 1) over an even depth pads the end
    only). NCDHW."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 strides: Sequence[int] = (1, 1, 1)):
        super().__init__()
        self.strides = tuple(strides)
        self.kernel = nn.Parameter(
            torch.empty(features, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[-1]
        pads = []
        # F.pad's order: the last axis first
        for size, s in zip(reversed(x.shape[2:]), reversed(self.strides)):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv3d(F.pad(x, pads), self.kernel, self.bias,
                        self.strides)


class VoxelNetEncoder(nn.Module):
    """points (B, N, 4) + mask (B, N) -> BEV (B, ny, nx, nz' * C) NHWC,
    in the conv weights' dtype."""

    def __init__(self, voxel_size: Sequence[float],
                 lidar_range: Sequence[float], vfe_features: int = 32,
                 conv3d_features: int = 64, norm: str = "batch"):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.lidar_range = tuple(float(v) for v in lidar_range)
        x0, y0, z0, x1, y1, z1 = self.lidar_range
        vx, vy, vz = self.voxel_size
        self.nx = int(round((x1 - x0) / vx))
        self.ny = int(round((y1 - y0) / vy))
        self.nz = int(round((z1 - z0) / vz))
        self.PFNLayer_0 = PFNLayer(4, vfe_features, norm)
        self.Conv_0 = SameConv3d(vfe_features, conv3d_features, 3, (2, 1, 1))
        self.Norm_0 = Norm(conv3d_features, norm)
        self.Conv_1 = SameConv3d(conv3d_features, conv3d_features, 3,
                                 (2, 1, 1))
        self.Norm_1 = Norm(conv3d_features, norm)
        depth = math.ceil(math.ceil(self.nz / 2) / 2)
        self.out_channels = depth * conv3d_features

    def voxel_ids(self, points: torch.Tensor, mask: torch.Tensor):
        """-> (ids (B, N) in [0, nx * ny * nz], the last the trash cell;
        ok (B, N))."""
        x0, y0, z0 = self.lidar_range[:3]
        vx, vy, vz = self.voxel_size
        nx, ny, nz = self.nx, self.ny, self.nz
        xi = torch.floor((points[..., 0] - x0) / vx).to(torch.int32)
        yi = torch.floor((points[..., 1] - y0) / vy).to(torch.int32)
        zi = torch.floor((points[..., 2] - z0) / vz).to(torch.int32)
        ok = (mask & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
              & (zi >= 0) & (zi < nz))
        ids = torch.where(ok, (zi * ny + yi) * nx + xi,
                          torch.full_like(xi, nx * ny * nz))
        return ids, ok

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b = points.shape[0]
        nx, ny, nz = self.nx, self.ny, self.nz
        cells = nx * ny * nz + 1
        ids, ok = self.voxel_ids(points, mask)
        offs = torch.arange(b, dtype=ids.dtype, device=ids.device)[:, None]
        flat_ids = (ids + offs * cells).reshape(-1)
        order = torch.argsort(flat_ids, stable=True)
        flat_ids = flat_ids[order]
        flat_ok = ok.reshape(-1)[order]
        pts = points.reshape(-1, 4)[order]
        w = flat_ok.to(pts.dtype)[:, None]
        feats = self.PFNLayer_0(pts * w, flat_ok) * w
        f = feats.shape[1]
        canvas = torch.full((b * cells, f), float("-inf"), dtype=feats.dtype,
                            device=feats.device).scatter_reduce(
            0, flat_ids.long()[:, None].expand(-1, f), feats, "amax",
            include_self=True)
        zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
        canvas = torch.maximum(
            torch.where(torch.isfinite(canvas), canvas, zero), zero)
        grid = canvas.reshape(b, cells, f)[:, :nx * ny * nz]
        grid = grid.reshape(b, nz, ny, nx, f).permute(0, 4, 1, 2, 3)
        h = grid.to(self.Conv_0.kernel.dtype)
        h = F.relu(self.Norm_0(self.Conv_0(h)))
        h = F.relu(self.Norm_1(self.Conv_1(h)))
        bd, c, zd, yd, xd = h.shape
        # (B, C, z, y, x) -> (B, y, x, z * C): channel z * C + c
        return h.permute(0, 3, 4, 2, 1).reshape(bd, yd, xd, zd * c)


def _encoder(a: dict) -> VoxelNetEncoder:
    return VoxelNetEncoder(voxel_size=tuple(a["voxel_size"]),
                           lidar_range=tuple(a["lidar_range"]),
                           norm=a.get("norm", "batch"))


def _heads(a: dict, cin: int) -> DetectionHeads:
    """VoxelNet's heads: no IoU branch, as JAX's."""
    return DetectionHeads(
        cin, anchor_number=a["anchor_number"], use_dir="dir_args" in a,
        num_bins=a.get("dir_args", {}).get("num_bins", 2))


@register_model("voxel_net")
class VoxelNet(DetectorChain):
    """args: voxel_size, lidar_range, base_bev_backbone, (shrink_header),
    anchor_number, (dir_args). Batch: points (B, N, 4), point_mask
    (B, N)."""

    def __init__(self, args: dict):
        super().__init__()
        self.DetectionHeads_0 = _heads(args, self._build_chain(
            args, _encoder(args)))

    def forward(self, batch: dict) -> dict:
        feat = self.features(batch["points"], batch["point_mask"])
        out = self.DetectionHeads_0(feat)
        out["spatial_features_2d"] = feat.permute(0, 2, 3, 1)
        return out


@register_model("voxel_net_intermediate")
class VoxelNetIntermediate(IntermediateChain):
    """``VoxelNet``'s chain on every agent slot of a (B, L) batch, the
    config's ``fusion_method`` (default max; ``in_channels`` the map's
    width), then the heads."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        width = self._build_chain(args, _encoder(args))
        method = args.get("fusion_method", "max")
        fusion_args = dict(args.get(method, {}) or {})
        fusion_args.setdefault("in_channels", width)
        width = self._build_fusion(method, fusion_args, width, max_cav)
        self.DetectionHeads_0 = _heads(args, width)

    def forward(self, batch: dict) -> dict:
        feat, b, l = self.agent_features(batch)
        return self.fused_heads(feat, b, l, batch, self.DetectionHeads_0)
