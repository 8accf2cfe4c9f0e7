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

Every other configuration (several PFN layers, group or no norm,
relative xyz, the distance channel) takes the general path, in both
modes and on every device, as JAX's does (encoders.py:149-175), and
never calls kernel 1: ``_decorate``'s 10 (7 without absolute xyz, + 1
with the distance) channels per point, ``pfn_i`` layers (a Dense, then
the padding-aware ``MaskedBatchNorm``, a LayerNorm with eps 1e-3 under
"group", or nothing and a biased Dense under "none"; ReLU), then the
pillar max (``scatter_reduce`` "amax" from -inf, JAX's ``segment_max``),
non-finite cells 0 and ``torch.maximum(., 0)``: ties at the max split
the gradient evenly, as JAX's ``segment_max`` and ``jnp.maximum`` do.
It computes in f32 and hands the canvas on in the weights' dtype.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops import pillar as _pillar
from ..ops import voxelize
from .layers import (DEFAULT_BN_MOMENTUM, Dense, LayerNorm, parse_norm,
                     update_running, world_sum)


class MaskedBatchNorm(nn.Module):
    """heal_tpu encoders.py ``MaskedBatchNorm``: batch norm over the valid
    points only. Train mode: the mean and the biased variance (two
    passes) of the rows where ``mask`` is set, kept in the graph, and the
    flax running update; eval mode: the running statistics. eps 1e-3.
    Under a device mesh (``mesh``) both passes' sums and the row count
    are all-reduced over every rank (``layers.world_sum``)."""

    mesh = None

    def __init__(self, channels: int, momentum: float | None = None,
                 epsilon: float = 1e-3):
        super().__init__()
        self.momentum = DEFAULT_BN_MOMENTUM if momentum is None else momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            w = mask.to(x.dtype)[:, None]
            s = world_sum(self.mesh, torch.cat([(x * w).sum(0),
                                                w.sum().reshape(1)]))
            denom = torch.clamp(s[-1], min=1.0)
            mean = s[:-1] / denom
            var = world_sum(self.mesh,
                            (((x - mean) ** 2) * w).sum(0)) / denom
            update_running(self.mean, mean, self.momentum)
            update_running(self.var, var, self.momentum)
        else:
            mean, var = self.mean.to(x.dtype), self.var.to(x.dtype)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale.to(x.dtype) + self.bias.to(x.dtype)


class PFNLayer(nn.Module):
    """heal_tpu encoders.py ``PFNLayer``: Dense -> norm -> ReLU per point
    (the max over a pillar comes at the scatter)."""

    def __init__(self, cin: int, features: int, norm: str = "batch"):
        super().__init__()
        self.kind, momentum = parse_norm(norm)
        self.Dense_0 = Dense(cin, features, use_bias=self.kind == "none")
        if self.kind == "batch":
            self.MaskedBatchNorm_0 = MaskedBatchNorm(features, momentum)
        elif self.kind == "group":
            self.LayerNorm_0 = LayerNorm(features, epsilon=1e-3)
        elif self.kind != "none":
            raise ValueError(f"unknown norm kind {norm!r}")

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        d = self.Dense_0
        x = x @ d.kernel.to(x.dtype)
        if d.bias is not None:
            x = x + d.bias.to(x.dtype)
        if d.tp is not None:  # column-parallel (models/layers.Dense)
            x = d.tp.gather(x, -1, "model")
        if self.kind == "batch":
            x = self.MaskedBatchNorm_0(x, mask)
        elif self.kind == "group":
            x = self.LayerNorm_0(x)
        return torch.relu(x)


class PointPillarEncoder(nn.Module):
    """points (B, N, 4) + mask (B, N) -> BEV (B, ny, nx, C), the JAX layout.

    Parameters carry the flax names: ``pfn_kernel`` (10, F), ``bn_scale``,
    ``bn_bias`` and the buffers ``bn_mean`` / ``bn_var``. Under a device
    mesh (``mesh``) the train path's BN moments sum every rank's points.
    """

    mesh = None

    def __init__(self, voxel_size: Sequence[float],
                 lidar_range: Sequence[float],
                 num_filters: Sequence[int] = (64,),
                 use_absolute_xyz: bool = True, with_distance: bool = False,
                 norm: str = "batch", presorted: bool = False):
        super().__init__()
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.lidar_range = tuple(float(v) for v in lidar_range)
        self.presorted = presorted
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        # JAX's condition for the gather-free fused path (kernel 1 in eval)
        self.fused = (len(num_filters) == 1
                      and parse_norm(norm)[0] == "batch"
                      and use_absolute_xyz and not with_distance)
        self.out_channels = int(num_filters[-1])
        if not self.fused:
            cin = (10 if use_absolute_xyz else 7) + int(with_distance)
            self.num_layers = len(num_filters)
            for i, f in enumerate(num_filters):
                self.add_module(f"pfn_{i}", PFNLayer(cin, int(f), norm))
                cin = int(f)
            return
        mom = parse_norm(norm)[1]
        self.momentum = DEFAULT_BN_MOMENTUM if mom is None else mom
        f = self.out_channels
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

    def _sorted_points(self, points: torch.Tensor, mask: torch.Tensor):
        """-> (grid, fi, fv, fp): the flat batch-wide pillar ids, validity
        and points, sorted by id."""
        b = points.shape[0]
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
        return grid, fi, fv, fp

    def _point_terms(self, points: torch.Tensor, mask: torch.Tensor):
        """Pillar ids and the per-point GEMM operands shared by both
        modes of the fused path: (grid, fi, w, pfeat, local, cdt), sorted
        by id."""
        grid, fi, fv, fp = self._sorted_points(points, mask)
        # compute dtype follows the weights (bf16 serving), never the
        # points': pillar binning stays f32, and only pillar-LOCAL offsets
        # and intensity enter the per-point GEMM
        kdt = self.pfn_kernel.dtype
        cdt = kdt if kdt == torch.bfloat16 else fp.dtype
        w = fv.to(cdt)[:, None]
        cell = fi % grid.cells
        local = (fp[:, :3] - self._centers(cell, grid, self._acc())).to(
            cdt) * w
        pfeat = torch.cat([local, fp[:, 3:4].to(cdt) * w], dim=-1)  # (N, 4)
        return grid, fi, w, pfeat, local, cdt

    @staticmethod
    def _centers(cell: torch.Tensor, grid,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Pillar centers (.., 3) of within-sample table ids."""
        yi = torch.div(cell, grid.nx, rounding_mode="floor")
        xi = cell - yi * grid.nx
        return torch.stack(
            [xi.to(dtype) * grid.vx + grid.cx0,
             yi.to(dtype) * grid.vy + grid.cy0,
             torch.full_like(xi, 0, dtype=dtype) + grid.cz],
            dim=-1,
        )

    def _acc(self) -> torch.dtype:
        """The fused path's accumulation dtype: f32 for f32 and bf16
        weights, f64 for f64 ones (the tests' f64 witness steps)."""
        return torch.promote_types(self.pfn_kernel.dtype, torch.float32)

    def _weights(self):
        """(w_raw, w_mu, a_mat) of the PFN kernel in the accumulation
        dtype: decorated = [p, p_xyz - mean, p_xyz - center], so rows 0-2
        apply to LOCAL xyz and the center part moves to the pillar term."""
        k32 = self.pfn_kernel.to(self._acc())
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
        acc = self._acc()
        idx = fi.long()

        def seg_sum(x):
            return torch.zeros((s_total, x.shape[1]), dtype=x.dtype,
                               device=dev).index_add(0, idx, x).to(acc)

        center = self._centers(
            torch.arange(s_total, device=dev) % grid.cells, grid, acc)
        a_pt = pfeat @ a_mat.to(cdt)  # (N, F), invalid -> 0
        seg = seg_sum(torch.cat([local @ w_mu.to(cdt), w], dim=-1))
        cnt = seg[:, f:f + 1]
        # per-pillar term t_p = center @ Wraw_xyz - local mean @ Wmu
        t_tab = -seg[:, :f] / torch.clamp(cnt, min=1.0) + center @ w_raw[:3]

        # E[y], E[y^2] of y_i = a_i + t_p over the valid points (of
        # every rank under a mesh)
        n_pts = w.to(acc).sum()
        a32 = a_pt.to(acc)
        seg_a = seg_sum(a_pt)
        s1 = a32.sum(0) + (cnt * t_tab).sum(0)
        s2 = ((a32 * a32).sum(0) + 2.0 * (seg_a * t_tab).sum(0)
              + (cnt * t_tab * t_tab).sum(0))
        s = world_sum(self.mesh, torch.cat([s1, s2, n_pts.reshape(1)]))
        n_valid = torch.clamp(s[-1], min=1.0)
        mean_y = s[:f] / n_valid
        e2 = s[f:2 * f] / n_valid
        var_y = torch.clamp(e2 - mean_y * mean_y, min=0.0)
        update_running(self.bn_mean, mean_y, self.momentum)
        update_running(self.bn_var, var_y, self.momentum)

        s_aff = self.bn_scale.to(acc) * torch.rsqrt(var_y + 1e-3)
        b_aff = self.bn_bias.to(acc) - s_aff * mean_y
        u = a_pt * s_aff.to(a_pt.dtype)  # per point
        tb = (t_tab * s_aff + b_aff).to(a_pt.dtype)  # per pillar
        # empty pillars keep -inf, then 0 on the canvas; ties share the
        # gradient evenly, as JAX's segment_max does
        m_seg = torch.full((s_total, f), float("-inf"), dtype=u.dtype,
                           device=dev).scatter_reduce(
            0, idx[:, None].expand(-1, f), u, "amax", include_self=True)
        return torch.where(torch.isfinite(m_seg), torch.relu(m_seg + tb),
                           torch.zeros_like(m_seg))

    def _decorate(self, pts, ids, valid, grid, b: int) -> torch.Tensor:
        """PillarVFE's per-point decoration over the flat sorted batch:
        [xyz, intensity] (intensity only without absolute xyz), xyz minus
        the pillar's mean, xyz minus the pillar's center (+ the range
        with the distance); padded rows 0."""
        w = valid.to(pts.dtype)[:, None]
        idx = ids.long()
        seg = torch.zeros((b * grid.cells, 4), dtype=pts.dtype,
                          device=pts.device).index_add(
            0, idx, torch.cat([pts[:, :3] * w, w], dim=-1))
        mean = seg[:, :3] / torch.clamp(seg[:, 3:4], min=1.0)
        f_cluster = pts[:, :3] - mean[idx]
        f_center = pts[:, :3] - self._centers(ids % grid.cells, grid).to(
            pts.dtype)
        feats = [pts if self.use_absolute_xyz else pts[:, 3:], f_cluster,
                 f_center]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(pts[:, :3], dim=-1,
                                                  keepdim=True))
        return torch.cat(feats, dim=-1) * w

    def _general(self, points: torch.Tensor, mask: torch.Tensor):
        """The decorate + PFN layers + pillar-max path (no kernel) ->
        (B, ny, nx, F) in the weights' dtype."""
        b = points.shape[0]
        grid, fi, fv, fp = self._sorted_points(points, mask)
        fp = fp.to(torch.promote_types(fp.dtype, torch.float32))
        feats = self._decorate(fp, fi, fv, grid, b)
        for i in range(self.num_layers):
            feats = getattr(self, f"pfn_{i}")(feats, fv)
        feats = feats * fv.to(feats.dtype)[:, None]
        f = feats.shape[1]
        idx = fi.long()[:, None].expand(-1, f)
        canvas = torch.full((b * grid.cells, f), float("-inf"),
                            dtype=feats.dtype, device=feats.device
                            ).scatter_reduce(0, idx, feats, "amax",
                                             include_self=True)
        zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
        canvas = torch.maximum(
            torch.where(torch.isfinite(canvas), canvas, zero), zero)
        canvas = canvas.reshape(b, grid.cells, f)[:, :grid.stride]
        wdt = self.pfn_0.Dense_0.kernel.dtype
        return canvas.reshape(b, grid.stride // grid.nx, grid.nx, f).to(wdt)

    def forward(self, points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not self.fused:
            return self._general(points, mask)
        b = points.shape[0]
        grid = self.grid()
        ny = grid.stride // grid.nx
        if self.training:
            table = self._train_canvas(points, mask).reshape(b, grid.cells, -1)
            return table[:, : grid.stride].reshape(b, ny, grid.nx, -1)
        canvas = _pillar.pillar_tables(*self.kernel_inputs(points, mask))
        return canvas.reshape(b, ny, grid.nx, -1)
