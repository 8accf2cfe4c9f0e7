"""Sparse 3D convolution on active voxels: the voxel "oracle" engine (torch).

Counterpart of heal_tpu/ops/sparse_conv.py, function for function. It is
the reference-exact engine of ``models/second.SecondRefEncoder`` (spconv's
site semantics, layer for layer) and the oracle the column engine of
ops/column_conv.py is held to; the SECOND model serves on the column
engine. Plain torch: JAX's engine is XLA ops, with no Pallas kernel.

  * active voxels of ONE sample live in capacity-``V`` arrays: sorted
    linear ``keys`` (z*H*W + y*W + x; padding = ``INVALID``), ``coords``
    (V, 3) [z, y, x], ``feats`` (V, C) and ``valid`` (V,);
  * the rulebook is implicit: for each of the 27 kernel offsets the
    neighbour's key is formed arithmetically and found by one
    ``torch.searchsorted`` over the sorted keys, all offsets at once
    (:func:`_lookup_batched`); a miss reads slot V, a zero row;
  * a conv is one wide gather and one (O, K*Cin) @ (K*Cin, Cout) product
    (:func:`apply_table_conv`);
  * strided convolution generates spconv's output sites (k=3, s=2, p=1:
    each input reaches <= 8 candidate outputs; per-axis kernels, strides
    and paddings in the ``*_nd`` functions) by a sort and a dedup at
    fixed capacity.

The padding key, the dz-major tap order (row i of a (27, Cin, Cout)
weight is offset i, spconv's (kd, kh, kw, in, out) flattened) and the
key order of the sites are JAX's, bit for bit; the column engine's
tables rely on them. Where JAX drops an out-of-range write
(``mode="drop"``), the port writes to one extra slot and slices it off.
Binning divides by a tensor of voxel sizes in f32, as the column engine
does. Integer keys stay int32 (z*H*W + y*W + x < 2^31 for the published
grids).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

INVALID = 2**31 - 1  # int32 max: the key of padding columns and points


def linear_key(coords, grid_zyx):
    """coords (..., 3) [z, y, x] -> the linear key z*H*W + y*W + x."""
    _, h, w = grid_zyx
    return coords[..., 0] * (h * w) + coords[..., 1] * w + coords[..., 2]


def _offsets(k: int = 3):
    """The kernel's (dz, dy, dx) offsets, dz-major: row i of a
    (27, Cin, Cout) weight is offset i."""
    r = range(-(k // 2), k // 2 + 1)
    return [(dz, dy, dx) for dz in r for dy in r for dx in r]


def _taps(kernel):
    """0-based kernel taps, z-major: input = stride*o - padding + tap."""
    kd, kh, kw = kernel
    return [(tz, ty, tx) for tz in range(kd) for ty in range(kh)
            for tx in range(kw)]


def _grid(lidar_range, voxel_size) -> tuple[int, int, int]:
    x0, y0, z0, x1, y1, z1 = lidar_range
    vx, vy, vz = voxel_size
    return (int(round((z1 - z0) / vz)), int(round((y1 - y0) / vy)),
            int(round((x1 - x0) / vx)))


def _compact(cand: torch.Tensor, max_out: int, grid) -> dict:
    """Sorted candidate keys (INVALID = none) -> the unique sites at
    capacity ``max_out``, in key order (JAX's head/rank compaction)."""
    head = torch.ones_like(cand, dtype=torch.bool)
    head[1:] = cand[1:] != cand[:-1]
    head &= cand != INVALID
    rank = torch.clamp(torch.cumsum(head, 0, dtype=torch.int32) - 1,
                       max=max_out)
    keys = torch.full((max_out + 1,), INVALID, dtype=torch.int32,
                      device=cand.device)
    keys.scatter_(0, torch.where(head, rank, max_out).long(),
                  torch.where(head, cand, INVALID))
    keys = keys[:max_out]
    return _sites(keys, grid)


def _sites(keys: torch.Tensor, grid) -> dict:
    _, oh, ow = grid
    valid = keys != INVALID
    kk = torch.where(valid, keys, 0)
    coords = torch.stack([torch.div(kk, oh * ow, rounding_mode="floor"),
                          torch.div(kk, ow, rounding_mode="floor") % oh,
                          kk % ow], dim=1).to(torch.int32)
    return {"keys": keys, "coords": torch.where(valid[:, None], coords, 0),
            "valid": valid, "grid": tuple(grid)}


def voxelize_points(points, mask, lidar_range, voxel_size,
                    max_voxels: int) -> dict:
    """Points (N, 4) + mask (N,) -> mean-feature voxels (MeanVFE and
    spconv's voxelizer): keys (V,) sorted, coords (V, 3) [z, y, x], feats
    (V, 4) per-voxel means, valid (V,), grid (nz, ny, nx). Voxels past
    ``max_voxels`` in key order are dropped."""
    nz, ny, nx = _grid(lidar_range, voxel_size)
    dev = points.device
    lo = torch.tensor([lidar_range[:3]], dtype=torch.float32, device=dev)
    size = torch.tensor([voxel_size], dtype=torch.float32, device=dev)
    cell = torch.floor((points[:, :3].float() - lo) / size).to(torch.int32)
    xi, yi, zi = cell.unbind(-1)
    ok = (mask & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
          & (zi >= 0) & (zi < nz))
    key = torch.where(ok, zi * (ny * nx) + yi * nx + xi, INVALID)

    key_s, order = torch.sort(key, stable=True)
    pts_s = points[order]
    real = key_s != INVALID
    okf = real.to(points.dtype)[:, None]
    head = torch.ones_like(real)
    head[1:] = key_s[1:] != key_s[:-1]
    head &= real
    rank = torch.cumsum(head, 0, dtype=torch.int32) - 1  # the voxel's id
    rank = torch.clamp(torch.where(real, rank, max_voxels), max=max_voxels)

    seg = torch.zeros((max_voxels + 1, points.shape[1] + 1),
                      dtype=points.dtype, device=dev).index_add_(
        0, rank.long(), torch.cat([pts_s * okf, okf], dim=-1))
    feats = seg[:max_voxels, :4] / torch.clamp(seg[:max_voxels, 4:5],
                                               min=1.0)
    keys = torch.full((max_voxels + 1,), INVALID, dtype=torch.int32,
                      device=dev)
    keys.scatter_(0, torch.where(head, rank, max_voxels).long(),
                  torch.where(head, key_s, INVALID))
    return dict(_sites(keys[:max_voxels], (nz, ny, nx)), feats=feats)


def _lookup_batched(keys, queries, ok):
    """Positions of ``queries`` in the sorted ``keys`` (V,), miss -> V:
    one ``searchsorted`` over every offset's queries."""
    v = keys.shape[0]
    pos = torch.clamp(torch.searchsorted(keys, queries.contiguous()),
                      0, v - 1)
    found = ok & (keys[pos] == queries)
    return torch.where(found, pos, v)


def gather_neighbor(keys, coords, valid, grid_zyx, offset):
    """Index of the active voxel at coords + offset (or V, the miss
    slot), and whether it was found."""
    d, h, w = grid_zyx
    dz, dy, dx = offset
    nz, ny_, nx_ = coords[:, 0] + dz, coords[:, 1] + dy, coords[:, 2] + dx
    in_bounds = (valid & (nz >= 0) & (nz < d) & (ny_ >= 0) & (ny_ < h)
                 & (nx_ >= 0) & (nx_ < w))
    nk = nz * (h * w) + ny_ * w + nx_
    pos = torch.clamp(torch.searchsorted(keys, nk.contiguous()), 0,
                      keys.shape[0] - 1)
    found = in_bounds & (keys[pos] == nk)
    return torch.where(found, pos, keys.shape[0]), found


def _table(keys, valid, cz, cy, cx, grid) -> torch.Tensor:
    """(O, K) positions of the input voxels at (cz, cy, cx) (each (O, K)),
    miss = V."""
    d, h, w = grid
    ok = (valid[:, None] & (cz >= 0) & (cz < d) & (cy >= 0) & (cy < h)
          & (cx >= 0) & (cx < w))
    nk = cz * (h * w) + cy * w + cx
    return _lookup_batched(keys, nk.reshape(-1),
                           ok.reshape(-1)).reshape(nk.shape)


def neighbor_table(sp: dict) -> torch.Tensor:
    """(V, 27) gather indices for the 3x3x3 stencil (miss slot = V),
    built once per resolution level and shared by its submanifold
    convs."""
    coords = sp["coords"]
    offs = torch.tensor(_offsets(), dtype=torch.int32, device=coords.device)
    c = coords[:, None, :] + offs[None]
    return _table(sp["keys"], sp["valid"], c[..., 0], c[..., 1], c[..., 2],
                  sp["grid"])


def apply_table_conv(feats, table, weights, valid, bias=None):
    """One wide gather and ONE product for a K-offset conv: feats
    (V, Cin); table (O, K) rows of feats (V = the zero row); weights
    (K, Cin, Cout) -> (O, Cout), zero where not ``valid``."""
    v, cin = feats.shape
    o, k = table.shape
    cout = weights.shape[-1]
    feats_pad = torch.cat([feats, feats.new_zeros((1, cin))], dim=0)
    g = F.embedding(table.long().reshape(-1), feats_pad,
                    padding_idx=v).reshape(o, k * cin)
    out = g @ weights.reshape(k * cin, cout).to(feats.dtype)
    if bias is not None:
        out = out + bias
    return out * valid[:, None].to(out.dtype)


def subm_conv(sp: dict, weights, bias=None, table=None):
    """Submanifold 3x3x3 conv: outputs only at the existing active sites.
    ``table``: a precomputed :func:`neighbor_table` of ``sp``."""
    if table is None:
        table = neighbor_table(sp)
    return apply_table_conv(sp["feats"], table, weights, sp["valid"], bias)


def downsample_sites(sp: dict, max_out: int, stride=(2, 2, 2),
                     padding=(1, 1, 1)) -> dict:
    """spconv SparseConv3d(k=3, s=2, p=1) output sites: each input coord
    c reaches output o on an axis where 2o - p <= c <= 2o - p + 2, up to
    2 options per axis, 8 candidates; sorted and deduplicated to
    capacity ``max_out``."""
    return downsample_sites_nd(sp, max_out, (3, 3, 3), stride, padding)


def strided_table(sp: dict, out_sites: dict, padding=(1, 1, 1)):
    """(O, 27) gather indices for SparseConv3d k=3 s=2 p=1: out[o] reads
    in[2o - p + d] per stencil offset d."""
    return strided_table_nd(sp, out_sites, (3, 3, 3), (2, 2, 2), padding)


def strided_conv(sp: dict, out_sites: dict, weights, bias=None,
                 padding=(1, 1, 1), table=None):
    """SparseConv3d k=3 s=2 p=1: out[o] = sum_d W_d * in[2o - p + d]."""
    if table is None:
        table = strided_table(sp, out_sites, padding)
    return apply_table_conv(sp["feats"], table, weights, out_sites["valid"],
                            bias)


def to_dense_bev(sp: dict, feats) -> torch.Tensor:
    """Sparse voxels -> dense (ny, nx, nz*C) NHWC map (HeightCompression
    with z folded into channels z-major, channel z*C + c)."""
    d, h, w = sp["grid"]
    c = feats.shape[-1]
    valid = sp["valid"]
    flat = torch.where(valid, linear_key(sp["coords"], sp["grid"]),
                       d * h * w)
    dense = feats.new_zeros((d * h * w + 1, c)).index_add_(
        0, flat.long(), feats * valid[:, None].to(feats.dtype))
    return dense[:-1].reshape(d, h, w, c).permute(1, 2, 0, 3).reshape(
        h, w, d * c)


# The anisotropic generalisations (kernel, stride and padding per axis):
# the reference VoxelBackBone8x's conv4 (k3 s2 padding (0, 1, 1)) and
# conv_out (kernel (3, 1, 1), stride (2, 1, 1), padding 0).
def downsample_sites_nd(sp: dict, max_out: int, kernel, stride,
                        padding) -> dict:
    """spconv SparseConv3d output sites with per-axis kernel, stride and
    padding: output o is active iff an input voxel c has
    stride*o - padding <= c <= stride*o - padding + kernel - 1 on every
    axis; at most ceil(k/s) candidates per axis."""
    coords, valid = sp["coords"], sp["valid"]
    grid = sp["grid"]
    out_grid = tuple((grid[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1
                     for i in range(3))
    od, oh, ow = out_grid
    nopts = [-(-kernel[i] // stride[i]) for i in range(3)]
    cz, cy, cx = coords.unbind(-1)
    cand = []
    for bz in range(nopts[0]):
        for by in range(nopts[1]):
            for bx in range(nopts[2]):
                oz = torch.div(cz + padding[0], stride[0],
                               rounding_mode="floor") - bz
                oy = torch.div(cy + padding[1], stride[1],
                               rounding_mode="floor") - by
                ox = torch.div(cx + padding[2], stride[2],
                               rounding_mode="floor") - bx
                lz = stride[0] * oz - padding[0]
                ly = stride[1] * oy - padding[1]
                lx = stride[2] * ox - padding[2]
                ok = (valid & (oz >= 0) & (oz < od) & (oy >= 0) & (oy < oh)
                      & (ox >= 0) & (ox < ow)
                      & (cz >= lz) & (cz <= lz + kernel[0] - 1)
                      & (cy >= ly) & (cy <= ly + kernel[1] - 1)
                      & (cx >= lx) & (cx <= lx + kernel[2] - 1))
                cand.append(torch.where(ok, oz * (oh * ow) + oy * ow + ox,
                                        INVALID))
    return _compact(torch.sort(torch.cat(cand)).values, max_out, out_grid)


def strided_table_nd(sp: dict, out_sites: dict, kernel, stride, padding):
    """(O, K) gather indices: out[o] tap t reads
    in[stride*o - padding + t]."""
    oc = out_sites["coords"]
    taps = torch.tensor(_taps(kernel), dtype=torch.int32, device=oc.device)
    c = [stride[i] * oc[:, None, i] - padding[i] + taps[None, :, i]
         for i in range(3)]
    return _table(sp["keys"], out_sites["valid"], *c, sp["grid"])


def strided_conv_nd(sp: dict, out_sites: dict, weights, kernel, stride,
                    padding, bias=None):
    """Anisotropic SparseConv3d; weights (K, Cin, Cout), K = prod(kernel),
    taps z-major (spconv's (kd, kh, kw, in, out) flattened)."""
    table = strided_table_nd(sp, out_sites, kernel, stride, padding)
    return apply_table_conv(sp["feats"], table, weights, out_sites["valid"],
                            bias)
