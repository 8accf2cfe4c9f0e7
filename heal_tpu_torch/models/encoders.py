"""PointPillars encoder (lidar -> BEV), train and eval (torch).

Counterpart of heal_tpu/models/encoders.py ``PointPillarEncoder`` for the
standard PointPillars configuration (one PFN layer, batch norm, absolute
xyz, no distance channel), which takes the gather-free fused path:

The PFN is linear per point and BatchNorm is a per-channel affine, so the
decorated features' pillar-constant parts (cluster mean, pillar center)
fold into a PER-PILLAR additive term, and since ReLU and max commute,
    canvas_p = relu(max_{i in p} u_i + t_p),
with u_i = [local_xyz_i, intensity_i] @ (A * s) the per-point GEMM (BN
scale s folded in) and t_p = -(Σ local)/cnt @ W1 + center_p @ W2 + b.

Eval mode: ``ops/pillar.pillar_tables`` (kernel 1 on CUDA,
``scatter_reduce`` on the CPU) computes the max, the sums and t_p and
fills the canvas. Train mode never calls kernel 1 (JAX uses its Pallas
kernel only when ``not train``, encoders.py:255-259): the BN moments
come from the same algebra over point sums and per-pillar table sums
(encoders.py:268-329), stay in the graph, and the segment sums and max
are plain ``index_add_`` / ``scatter_reduce`` (XLA segment ops in JAX).

The general decorate + PFNLayer path is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops import pillar as _pillar
from ..ops import voxelize
from .layers import DEFAULT_BN_MOMENTUM, parse_norm, update_running


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
        mom = parse_norm(norm)[1]
        self.momentum = DEFAULT_BN_MOMENTUM if mom is None else mom
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

    def _point_terms(self, points: torch.Tensor, mask: torch.Tensor):
        """Pillar ids and the per-point GEMM operands shared by both
        modes: (grid, fi, w, pfeat, local, cdt), sorted by id."""
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
        cell = fi % grid.cells
        local = (fp[:, :3] - self._centers(cell, grid)).to(cdt) * w
        pfeat = torch.cat([local, fp[:, 3:4].to(cdt) * w], dim=-1)  # (N, 4)
        return grid, fi, w, pfeat, local, cdt

    @staticmethod
    def _centers(cell: torch.Tensor, grid) -> torch.Tensor:
        """Pillar centers (.., 3) of within-sample table ids."""
        yi = torch.div(cell, grid.nx, rounding_mode="floor")
        xi = cell - yi * grid.nx
        return torch.stack(
            [xi.float() * grid.vx + grid.cx0, yi.float() * grid.vy + grid.cy0,
             torch.full_like(xi, 0, dtype=torch.float32) + grid.cz],
            dim=-1,
        )

    def _weights(self):
        """(w_raw, w_mu, a_mat) of the f32 PFN kernel: decorated =
        [p, p_xyz - mean, p_xyz - center], so rows 0-2 apply to LOCAL xyz
        and the center part moves to the pillar term."""
        k32 = self.pfn_kernel.float()
        w_raw, w_mu, w_c = k32[:4], k32[4:7], k32[7:10]
        a_mat = torch.cat([w_raw[:3] + (w_mu + w_c), w_raw[3:4]], dim=0)
        return w_raw, w_mu, a_mat

    def kernel_inputs(self, points: torch.Tensor, mask: torch.Tensor):
        """The arguments of ``pillar_tables`` for this batch (eval mode):
        (u, g4, fi, weights, grid, batch)."""
        if self.training:
            raise RuntimeError("kernel 1 is eval-only")
        grid, fi, w, pfeat, local, cdt = self._point_terms(points, mask)
        w_raw, w_mu, a_mat = self._weights()
        s_aff = self.bn_scale.float() * torch.rsqrt(self.bn_var.float() + 1e-3)
        b_aff = self.bn_bias.float() - s_aff * self.bn_mean.float()
        u = pfeat @ (a_mat * s_aff).to(cdt)  # (N, F), BN scale folded in
        g4 = torch.cat([local.float(), w.float()], dim=-1).contiguous()
        weights = torch.cat(
            [w_mu * s_aff, w_raw[:3] * s_aff, b_aff[None]], dim=0
        ).contiguous()
        return u.contiguous(), g4, fi.contiguous(), weights, grid, \
            points.shape[0]

    def _train_canvas(self, points: torch.Tensor, mask: torch.Tensor):
        """Train-mode fused path with batch BN moments (encoders.py
        :268-329): -> (batch*cells, F) table, drop buckets included."""
        grid, fi, w, pfeat, local, cdt = self._point_terms(points, mask)
        w_raw, w_mu, a_mat = self._weights()
        f = self.out_channels
        s_total = points.shape[0] * grid.cells
        dev = points.device
        idx = fi.long()

        def seg_sum(x):
            return torch.zeros((s_total, x.shape[1]), dtype=x.dtype,
                               device=dev).index_add(0, idx, x).float()

        center = self._centers(
            torch.arange(s_total, device=dev) % grid.cells, grid)
        a_pt = pfeat @ a_mat.to(cdt)  # (N, F), invalid -> 0
        seg = seg_sum(torch.cat([local @ w_mu.to(cdt), w], dim=-1))
        cnt = seg[:, f:f + 1]
        # per-pillar term t_p = center @ Wraw_xyz - local mean @ Wmu
        t_tab = -seg[:, :f] / torch.clamp(cnt, min=1.0) + center @ w_raw[:3]

        # E[y], E[y^2] of y_i = a_i + t_p over the valid points
        n_valid = torch.clamp(w.float().sum(), min=1.0)
        a32 = a_pt.float()
        seg_a = seg_sum(a_pt)
        mean_y = (a32.sum(0) + (cnt * t_tab).sum(0)) / n_valid
        e2 = ((a32 * a32).sum(0) + 2.0 * (seg_a * t_tab).sum(0)
              + (cnt * t_tab * t_tab).sum(0)) / n_valid
        var_y = torch.clamp(e2 - mean_y * mean_y, min=0.0)
        update_running(self.bn_mean, mean_y, self.momentum)
        update_running(self.bn_var, var_y, self.momentum)

        s_aff = self.bn_scale.float() * torch.rsqrt(var_y + 1e-3)
        b_aff = self.bn_bias.float() - s_aff * mean_y
        u = a_pt * s_aff.to(a_pt.dtype)  # per point
        tb = (t_tab * s_aff + b_aff).to(a_pt.dtype)  # per pillar
        # empty pillars keep -inf, then 0 on the canvas; ties share the
        # gradient evenly, as JAX's segment_max does
        m_seg = torch.full((s_total, f), float("-inf"), dtype=u.dtype,
                           device=dev).scatter_reduce(
            0, idx[:, None].expand(-1, f), u, "amax", include_self=True)
        return torch.where(torch.isfinite(m_seg), torch.relu(m_seg + tb),
                           torch.zeros_like(m_seg))

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b = points.shape[0]
        grid = self.grid()
        ny = grid.stride // grid.nx
        if self.training:
            table = self._train_canvas(points, mask).reshape(b, grid.cells, -1)
            return table[:, : grid.stride].reshape(b, ny, grid.nx, -1)
        canvas = _pillar.pillar_tables(*self.kernel_inputs(points, mask))
        return canvas.reshape(b, ny, grid.nx, -1)
