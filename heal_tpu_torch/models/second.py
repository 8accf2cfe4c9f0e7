"""SECOND encoder: sparse 3D conv backbone -> dense BEV (torch).

Counterpart of heal_tpu/models/second.py ``SecondEncoder`` (MeanVFE ->
VoxelBackBone8x -> HeightCompression) on the column engine of
ops/column_conv.py: 16 -> 32 -> 64 -> 64 channels published, three
stride-2 sparse downsamples, two submanifold convs in each later stage,
then the remaining z layers folded into channels z-major. The norm is a
per-voxel LayerNorm (eps 1e-3), as in JAX; ``norm`` is accepted and
ignored. JAX vmaps one ``SecondStack`` over the agents with shared
parameters; the port runs every agent in one pass (the column engine
stacks the agents' rows), under the flax path ``VmapSecondStack_0``, so
heal_tpu's variables bridge key for key (kernels (27, Cin, Cout),
``LayerNorm_0.{scale,bias}``).

Compute dtype follows the kernel's: bf16 weights give bf16 convs, but
``conv_input`` reads the raw point coordinates in f32 with the
bf16-rounded weights (``precise_input``), then casts after its norm.

``dense_tail`` runs the last stage's submanifold convs as dense conv3d
over the (Z, H, W) canvas (exact: absent neighbours hold zeros and the
outputs are masked). Off in every published config; the port reads it
from ``encoder_args.second.dense_tail``, which heal_tpu's branch does not
pass on (both tails give the same values).

``SecondRefEncoder`` (heal_tpu second.py:196-324) is the reference-exact
variant on the voxel "oracle" engine of ops/sparse_conv.py: spconv's
VoxelBackBone8x layer for layer (conv_input, conv1, conv2-4 with their
strided convs, conv4's (0, 1, 1) padding, the anisotropic conv_out),
BatchNorm'd as the reference is (``MaskedBatchNorm`` over the active
voxels, eps 1e-3), the z grid padded by one layer as the reference's
sparse_shape is, and the reference's C*D channel fold. It hosts
transplanted reference SECOND checkpoints
(utils/transplant.transplant_second_encoder); the column engine stays
the serving path.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops import column_conv as cc
from ..ops import sparse_conv as sc
from .encoders import MaskedBatchNorm
from .layers import LayerNorm


class ColumnConvLayer(nn.Module):
    """One sparse conv (subm or strided) + LayerNorm + ReLU on columns.
    ``table`` is the level's precomputed neighbour table."""

    def __init__(self, cin: int, cout: int, strided: bool = False,
                 precise_input: bool = False):
        super().__init__()
        self.strided = strided
        self.precise_input = precise_input
        self.kernel = nn.Parameter(torch.empty(27, cin, cout))
        self.LayerNorm_0 = LayerNorm(cout, epsilon=1e-3)

    def forward(self, cols: dict, table, out: dict | None = None) -> dict:
        kdt = self.kernel.dtype
        if kdt == torch.bfloat16 and not self.precise_input:
            cols = dict(cols, feats=cols["feats"].to(kdt))
        if self.strided:
            new_cols = cc.strided_conv(cols, out, self.kernel, table=table)
            occ = new_cols["occ"]
        else:
            new_cols = dict(cols, feats=cc.subm_conv(cols, self.kernel,
                                                     table=table))
            occ = cols["occ"]
        h = self.LayerNorm_0(new_cols["feats"])
        if kdt == torch.bfloat16:
            h = h.to(kdt)
        new_cols["feats"] = torch.relu(h) * occ[..., None].to(h.dtype)
        return new_cols


class _DenseSubmLayer(nn.Module):
    """Dense-canvas submanifold conv + LayerNorm + ReLU, with
    ``ColumnConvLayer``'s parameter names and shapes."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(27, cin, cout))
        self.LayerNorm_0 = LayerNorm(cout, epsilon=1e-3)

    def forward(self, dense, docc):
        kdt = self.kernel.dtype
        x = dense.to(kdt) if kdt == torch.bfloat16 else dense
        h = self.LayerNorm_0(cc.dense_subm_conv(x, docc, self.kernel))
        if kdt == torch.bfloat16:
            h = h.to(kdt)
        return torch.relu(h) * docc[..., None].to(h.dtype)


class SecondStack(nn.Module):
    """The column conv stack over the agents' points: conv_input, then
    per later stage ``down_{si}`` and ``stage{si}_subm{0,1}``. One rank
    map per level feeds that level's subm table and the strided table
    into the next level."""

    def __init__(self, lidar_range: Sequence[float],
                 voxel_size: Sequence[float], channels: Sequence[int],
                 max_voxels: Sequence[int], presorted: bool = False,
                 dense_tail: bool = False):
        super().__init__()
        self.lidar_range = tuple(float(v) for v in lidar_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.channels = tuple(int(c) for c in channels)
        self.max_voxels = tuple(int(v) for v in max_voxels)
        self.presorted = presorted
        self.dense_tail = dense_tail
        self.conv_input = ColumnConvLayer(4, self.channels[0],
                                          precise_input=True)
        last = len(self.channels) - 1
        for si in range(1, last + 1):
            c_in, c = self.channels[si - 1], self.channels[si]
            setattr(self, f"down_{si}", ColumnConvLayer(c_in, c,
                                                        strided=True))
            layer = (_DenseSubmLayer if dense_tail and si == last
                     else ColumnConvLayer)
            for j in range(2):
                setattr(self, f"stage{si}_subm{j}", layer(c, c))

    def forward(self, points, mask) -> torch.Tensor:
        """points (B, N, 4), mask (B, N) -> BEV (B, H, W, Z*C)."""
        cols = cc.voxelize_columns(points, mask, self.lidar_range,
                                   self.voxel_size, self.max_voxels[0],
                                   presorted=self.presorted)
        dmap = cc.rank_map(cols)
        table = cc.column_table(cols, dmap=dmap)
        cols = self.conv_input(cols, table)
        last = len(self.channels) - 1
        for si in range(1, last + 1):
            out = cc.downsample_columns(cols, self.max_voxels[si])
            st = cc.strided_table(cols, out, dmap=dmap)
            cols = getattr(self, f"down_{si}")(cols, st, out=out)
            if self.dense_tail and si == last:
                dense, docc = cc.to_dense_voxels(cols)
                for j in range(2):
                    dense = getattr(self, f"stage{si}_subm{j}")(dense, docc)
                b, z, h, w, c = dense.shape
                return dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, z * c)
            dmap = cc.rank_map(cols)
            table = cc.column_table(cols, dmap=dmap)
            for j in range(2):
                cols = getattr(self, f"stage{si}_subm{j}")(cols, table)
        return cc.to_dense_bev(cols)


class SecondEncoder(nn.Module):
    """points (B, N, 4) + mask -> BEV (B, ny/8, nx/8, nz/8 * C_last),
    NHWC as the other encoders return it."""

    def __init__(self, voxel_size: Sequence[float],
                 lidar_range: Sequence[float],
                 channels: Sequence[int] = (16, 32, 64, 64),
                 max_voxels: Sequence[int] = (24000, 16000, 12000, 8000),
                 norm: str = "batch", presorted: bool = False,
                 dense_tail: bool = False):
        super().__init__()
        del norm  # the stack normalises with LayerNorm, as JAX's
        self.VmapSecondStack_0 = SecondStack(
            lidar_range, voxel_size, channels, max_voxels,
            presorted=presorted, dense_tail=dense_tail)
        nz = cc.grid_shape(lidar_range, voxel_size)[0]
        for _ in range(len(channels) - 1):  # each (k=3, s=2, p=1) conv
            nz = (nz - 1) // 2 + 1
        self.out_channels = nz * int(channels[-1])

    def forward(self, points, mask) -> torch.Tensor:
        return self.VmapSecondStack_0(points, mask)


# ---------------------------------------------------------------------
# Reference-exact variant: VoxelBackBone8x mirrored layer for layer on
# the voxel oracle engine. Ref: models/heter_encoders.py:52-81 (SECOND =
# MeanVFE -> VoxelBackBone8x -> HeightCompression), sub_modules/
# sparse_backbone_3d.py:34-152, mean_vfe.py, height_compression.py.
class _OracleConvBN(nn.Module):
    """One sparse conv (subm, strided or anisotropic strided) + BN + ReLU:
    ``kernel`` (taps, Cin, Cout), ``bn`` a MaskedBatchNorm (eps 1e-3)."""

    def __init__(self, cin: int, cout: int, taps: int = 27):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(taps, cin, cout))
        self.bn = MaskedBatchNorm(cout)

    def forward(self, feats, table, valid):
        out = sc.apply_table_conv(feats, table, self.kernel, valid)
        h = self.bn(out, valid)
        return torch.relu(h) * valid[:, None].to(h.dtype)


def _stacked(tables: list, v: int) -> torch.Tensor:
    """Per-sample tables (O, K) into rows of V -> one table into the
    samples' stacked rows (sample b's at b*V), every miss at the zero
    row after the last sample."""
    b = len(tables)
    return torch.cat([torch.where(t == v, b * v, t + i * v)
                      for i, t in enumerate(tables)])


class SecondRefStack(nn.Module):
    """VoxelBackBone8x on the oracle engine (exact spconv site semantics;
    z grid padded +1 like the reference sparse_shape). Each sample's
    sites and tables are its own, as under JAX's vmap; the samples'
    voxels are stacked for the convs, so in train mode the batch
    statistics are taken over the active voxels of every sample, as the
    reference's BatchNorm1d takes them (JAX's vmapped stack cannot write
    per-sample statistics into its shared ones; at one sample the two
    agree)."""

    STAGES = {2: 32, 3: 64, 4: 64}

    def __init__(self, lidar_range: Sequence[float],
                 voxel_size: Sequence[float],
                 max_voxels: Sequence[int] = (24000, 16000, 12000, 8000,
                                              8000),
                 num_features_out: int = 128):
        super().__init__()
        self.lidar_range = tuple(float(v) for v in lidar_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.max_voxels = tuple(int(v) for v in max_voxels)
        self.conv_input = _OracleConvBN(4, 16)
        self.conv1_0 = _OracleConvBN(16, 16)
        cin = 16
        for si, c in self.STAGES.items():
            for j in range(3):
                setattr(self, f"conv{si}_{j}",
                        _OracleConvBN(cin if j == 0 else c, c))
            cin = c
        self.conv_out = _OracleConvBN(cin, num_features_out, taps=3)

    def forward(self, points, mask) -> torch.Tensor:
        """points (B, N, 4), mask (B, N) -> BEV (B, H, W, C*D)."""
        b = points.shape[0]
        sps = []
        for i in range(b):
            sp = sc.voxelize_points(points[i], mask[i], self.lidar_range,
                                    self.voxel_size, self.max_voxels[0])
            d, h, w = sp["grid"]  # ref sparse_shape: one extra z layer
            sps.append(dict(sp, grid=(d + 1, h, w)))

        def run(layer, tables, outs):
            """``layer`` on the stacked features of ``sps`` through the
            per-sample ``tables``, writing each sample's into ``outs``."""
            v = sps[0]["feats"].shape[0]
            valid = torch.cat([o["valid"] for o in outs])
            feats = layer(torch.cat([s["feats"] for s in sps]),
                          _stacked(tables, v), valid)
            o_cap = outs[0]["valid"].shape[0]
            return [dict(o, feats=feats[i * o_cap:(i + 1) * o_cap])
                    for i, o in enumerate(outs)]

        tables = [sc.neighbor_table(sp) for sp in sps]
        sps = run(self.conv_input, tables, sps)
        sps = run(self.conv1_0, tables, sps)
        for si in self.STAGES:
            pad = (0, 1, 1) if si == 4 else (1, 1, 1)
            outs = [sc.downsample_sites(sp, self.max_voxels[si - 1],
                                        padding=pad) for sp in sps]
            st = [sc.strided_table(sp, o, padding=pad)
                  for sp, o in zip(sps, outs)]
            sps = run(getattr(self, f"conv{si}_0"), st, outs)
            tables = [sc.neighbor_table(sp) for sp in sps]
            for j in (1, 2):
                sps = run(getattr(self, f"conv{si}_{j}"), tables, sps)

        # conv_out: kernel (3, 1, 1), stride (2, 1, 1), padding 0
        geo = ((3, 1, 1), (2, 1, 1), (0, 0, 0))
        outs = [sc.downsample_sites_nd(sp, self.max_voxels[4], *geo)
                for sp in sps]
        st = [sc.strided_table_nd(sp, o, *geo) for sp, o in zip(sps, outs)]
        sps = run(self.conv_out, st, outs)
        return torch.stack([_ref_fold(sp) for sp in sps])


def _ref_fold(sp: dict) -> torch.Tensor:
    """HeightCompression with the REFERENCE channel fold: dense
    (C, D, H, W).view(C*D, H, W) -> NHWC channel c*D + d."""
    dd, hh, ww = sp["grid"]
    feats, valid = sp["feats"], sp["valid"]
    c = feats.shape[-1]
    flat = torch.where(valid, sc.linear_key(sp["coords"], sp["grid"]),
                       dd * hh * ww)
    dense = feats.new_zeros((dd * hh * ww + 1, c)).index_add_(
        0, flat.long(), feats * valid[:, None].to(feats.dtype))
    return dense[:-1].reshape(dd, hh, ww, c).permute(1, 2, 3, 0).reshape(
        hh, ww, c * dd)


class SecondRefEncoder(nn.Module):
    """points (B, N, 4) + mask -> BEV (B, H, W, C*D), the reference-exact
    layer stack, under the flax path ``VmapSecondRefStack_0`` (kernels
    (taps, Cin, Cout), ``bn.{scale, bias}`` and the running ``bn.{mean,
    var}``), so heal_tpu's variables bridge key for key."""

    def __init__(self, voxel_size: Sequence[float],
                 lidar_range: Sequence[float],
                 max_voxels: Sequence[int] = (24000, 16000, 12000, 8000,
                                              8000),
                 num_features_out: int = 128):
        super().__init__()
        self.VmapSecondRefStack_0 = SecondRefStack(
            lidar_range, voxel_size, max_voxels, num_features_out)

    def forward(self, points, mask) -> torch.Tensor:
        return self.VmapSecondRefStack_0(points, mask)
