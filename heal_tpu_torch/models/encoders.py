"""PointPillars encoder (lidar -> BEV), eval mode (torch).

Counterpart of heal_tpu/models/encoders.py ``PointPillarEncoder`` for the
standard PointPillars configuration (one PFN layer, batch norm, absolute
xyz, no distance channel), which takes the gather-free fused path:

The PFN is linear per point and BatchNorm is a per-channel affine, so the
decorated features' pillar-constant parts (cluster mean, pillar center)
fold into a PER-PILLAR additive term, and since ReLU and max commute,
    canvas_p = relu(max_{i in p} u_i + t_p),
with u_i = [local_xyz_i, intensity_i] @ (A * s) the per-point GEMM (BN
scale s folded in) and t_p = -(Σ local)/cnt @ W1 + center_p @ W2 + b.
``ops/pillar.pillar_tables`` (kernel 1 on CUDA, ``scatter_reduce`` on the
CPU) computes the max, the sums and t_p and fills the canvas.

The general decorate + PFNLayer path and the train-mode BN moments of
the fused path are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops import pillar as _pillar
from ..ops import voxelize
from .layers import parse_norm


class PointPillarEncoder(nn.Module):
    """points (B, N, 4) + mask (B, N) -> BEV (B, ny, nx, C), the JAX layout.

    Parameters carry the flax names: ``pfn_kernel`` (10, F), ``bn_scale``,
    ``bn_bias`` and the buffers ``bn_mean`` / ``bn_var``.
    """

    def __init__(self, voxel_size: Sequence[float],
                 lidar_range: Sequence[float],
                 num_filters: Sequence[int] = (64,),
                 use_absolute_xyz: bool = True, with_distance: bool = False,
                 norm: str = "batch", presorted: bool = False):
        super().__init__()
        if not (len(num_filters) == 1 and parse_norm(norm)[0] == "batch"
                and use_absolute_xyz and not with_distance):
            raise NotImplementedError(
                "only the fused PointPillars encoder is ported (one PFN "
                "layer, batch norm, absolute xyz, no distance)"
            )
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.lidar_range = tuple(float(v) for v in lidar_range)
        self.presorted = presorted
        f = int(num_filters[0])
        self.out_channels = f
        self.pfn_kernel = nn.Parameter(torch.empty(10, f))
        self.bn_scale = nn.Parameter(torch.ones(f))
        self.bn_bias = nn.Parameter(torch.zeros(f))
        self.register_buffer("bn_mean", torch.zeros(f))
        self.register_buffer("bn_var", torch.ones(f))

    @property
    def grid_nx(self) -> int:
        return int(round((self.lidar_range[3] - self.lidar_range[0])
                         / self.voxel_size[0]))

    @property
    def grid_ny(self) -> int:
        return int(round((self.lidar_range[4] - self.lidar_range[1])
                         / self.voxel_size[1]))

    def grid(self) -> _pillar.PillarGrid:
        nx, ny = self.grid_nx, self.grid_ny
        vx, vy, vz = self.voxel_size
        x0, y0, z0 = self.lidar_range[:3]
        return _pillar.PillarGrid(
            nx=nx, stride=nx * ny, cells=nx * ny + 1, vx=vx, vy=vy,
            cx0=x0 + vx / 2, cy0=y0 + vy / 2, cz=z0 + vz / 2,
        )

    def kernel_inputs(self, points: torch.Tensor, mask: torch.Tensor):
        """The arguments of ``pillar_tables`` for this batch:
        (u, g4, fi, weights, grid, batch)."""
        if self.training:
            raise NotImplementedError("train-mode PFN statistics are not ported")
        b, n, _ = points.shape
        grid = self.grid()
        ids, valid = voxelize.pillar_ids(
            points, mask, self.lidar_range, self.voxel_size, grid.nx,
            grid.stride // grid.nx,
        )
        offs = torch.arange(b, dtype=torch.int32, device=points.device)
        fi = (ids + offs[:, None] * grid.cells).reshape(-1)
        fv = valid.reshape(-1)
        fp = points.reshape(-1, points.shape[-1])
        if self.presorted:
            # safety net for host/device rounding disagreement at bin
            # edges: the running max keeps ids monotone; a rare straggler
            # merges into the previous pillar
            fi = torch.cummax(fi, dim=0).values
        else:
            order = torch.argsort(fi, stable=True)
            fi, fv, fp = fi[order], fv[order], fp[order]

        # compute dtype follows the weights (bf16 serving), never the
        # points': pillar binning stays f32, and only pillar-LOCAL offsets
        # and intensity enter the per-point GEMM
        kdt = self.pfn_kernel.dtype
        cdt = kdt if kdt == torch.bfloat16 else fp.dtype
        w = fv.to(cdt)[:, None]
        k32 = self.pfn_kernel.float()
        w_raw, w_mu, w_c = k32[:4], k32[4:7], k32[7:10]
        # decorated = [p, p_xyz - mean, p_xyz - center]: rows 0-2 apply
        # to LOCAL xyz, the center part moves to the pillar term
        a_mat = torch.cat([w_raw[:3] + (w_mu + w_c), w_raw[3:4]], dim=0)

        cell = fi % grid.cells
        yi = torch.div(cell, grid.nx, rounding_mode="floor")
        xi = cell - yi * grid.nx
        center = torch.stack(
            [xi.float() * grid.vx + grid.cx0, yi.float() * grid.vy + grid.cy0,
             torch.full_like(xi, 0, dtype=torch.float32) + grid.cz],
            dim=-1,
        )
        local = (fp[:, :3] - center).to(cdt) * w
        pfeat = torch.cat([local, fp[:, 3:4].to(cdt) * w], dim=-1)  # (N, 4)

        s_aff = self.bn_scale.float() * torch.rsqrt(self.bn_var.float() + 1e-3)
        b_aff = self.bn_bias.float() - s_aff * self.bn_mean.float()
        u = pfeat @ (a_mat * s_aff).to(cdt)  # (N, F), BN scale folded in
        g4 = torch.cat([local.float(), w.float()], dim=-1).contiguous()
        weights = torch.cat(
            [w_mu * s_aff, w_raw[:3] * s_aff, b_aff[None]], dim=0
        ).contiguous()
        return u.contiguous(), g4, fi.contiguous(), weights, grid, b

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        u, g4, fi, weights, grid, b = self.kernel_inputs(points, mask)
        canvas = _pillar.pillar_tables(u, g4, fi, weights, grid, b)
        return canvas.reshape(b, grid.stride // grid.nx, grid.nx, -1)
