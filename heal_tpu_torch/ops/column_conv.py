"""Column-form sparse 3D convolution for the SECOND encoder (torch).

Counterpart of heal_tpu/ops/column_conv.py, function for function. The
engine keeps z DENSE and is sparse over BEV columns only:

  * active columns live in capacity-``Vc`` arrays: sorted 2D keys
    ``ckeys`` (y*W + x, padding INVALID), ``coords2`` [y, x], ``feats``
    (Z dense) and a per-voxel occupancy ``occ``;
  * a 3x3x3 conv reads nine neighbour COLUMNS (dy, dx) through a table
    built once per resolution level from a dense (H*W,) rank map, and
    folds the z taps into one (rows*Z, 3*Cin) @ (3*Cin, Cout) product per
    (dy, dx) (``_zstack``); the port gathers each tap's products where
    JAX gathers its operands (``subm_conv``); outputs are re-masked with
    ``occ``, so the result is the submanifold conv;
  * the strided conv (k=3, s=2, p=1) takes its output columns from a
    max-pool of the input's 2D occupancy image, compacted in key order,
    and its output occupancy from the input occupancy gathered with the
    features.

Every array carries a leading AGENT axis B (JAX vmaps the per-agent
functions instead): ``ckeys`` (B, Vc), ``coords2`` (B, Vc, 2), ``feats``
(B, Vc, Z, C), ``occ`` (B, Vc, Z), ``cvalid`` (B, Vc); ``grid`` is
(Z, H, W). Rank maps and tables hold each agent's own column ranks, as
JAX's do; the convs move them into one row space (agent b's rows start
at b*Vc, one zero row after the last agent), so a level's gathers and
products are one launch for all agents. Keys stay int32
(col*nz + z <= 2^21 * 40 < 2^31); indices are cast to int64 where an op
needs it.

Where JAX's ``.at[...].set(..., mode="drop")`` drops an out-of-range
write, the port writes to one extra dump row or column and slices it
off; several writes may land there, and nothing reads it. Binning
divides by a tensor of voxel sizes, in f32 on both devices, as the host
presort does (a division by a Python scalar may become a product with
its reciprocal on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .sparse_conv import INVALID, _offsets


def _offsets2d():
    return [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def _regroup_weights(weights: torch.Tensor) -> torch.Tensor:
    """(27, Cin, Cout) dz-major -> (9, 3*Cin, Cout): one block per
    (dy, dx), its rows dz = -1, 0, +1 to match the [z-1, z, z+1] stack."""
    idx = {off: i for i, off in enumerate(_offsets())}
    order = [idx[(dz, dy, dx)] for dy, dx in _offsets2d() for dz in (-1, 0, 1)]
    _, cin, cout = weights.shape
    return weights[order].reshape(9, 3 * cin, cout)


def grid_shape(lidar_range, voxel_size) -> tuple[int, int, int]:
    """(nz, ny, nx) of a voxel grid."""
    x0, y0, z0, x1, y1, z1 = lidar_range
    vx, vy, vz = voxel_size
    return (int(round((z1 - z0) / vz)), int(round((y1 - y0) / vy)),
            int(round((x1 - x0) / vx)))


def _rows_of(table: torch.Tensor, vc: int) -> torch.Tensor:
    """Per-agent column ranks (B, ..., 9), miss = vc -> int64 rows of the
    agents' stacked (B*vc + 1) rows, miss = the zero row B*vc."""
    b = table.shape[0]
    base = torch.arange(b, device=table.device).reshape(
        (b,) + (1,) * (table.dim() - 1)) * vc
    return torch.where(table == vc, b * vc, table.long() + base)


def _take_rows(prod: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """prod[rows] for one tap's rows; prod's last row, which every miss
    reads, is zero. An embedding lookup with that row as ``padding_idx``:
    its backward leaves the misses out. Advanced indexing's backward
    would add every miss's gradient into that one row, and on the card it
    sorts the rows and adds each run one row after another: with most of
    a level's table entries missing, the published m3 stage-2 step took
    2.6 s on an H100."""
    return F.embedding(rows, prod, padding_idx=prod.shape[0] - 1)


def voxelize_columns(points, mask, lidar_range, voxel_size, max_cols: int,
                     presorted: bool = False) -> dict:
    """Points (B, N, 4) + mask (B, N) -> mean-feature voxel columns
    (MeanVFE): ckeys (B, Vc) sorted, coords2 (B, Vc, 2) [y, x], feats
    (B, Vc, Z, 4) per-voxel means, occ (B, Vc, Z), cvalid (B, Vc), grid.

    ``presorted``: each agent's points are already host-ordered by the
    full voxel key (data/scene.py), so the sort is skipped; a running max
    keeps the keys monotone where host and device bin a point apart. An
    out-of-range point amid in-range ones saturates the running max at
    INVALID, and every later point of that agent is dropped, as in JAX.
    Columns past ``max_cols`` are dropped."""
    b, n, d = points.shape
    nz, ny, nx = grid_shape(lidar_range, voxel_size)
    dev = points.device
    lo = torch.tensor([lidar_range[:3]], dtype=torch.float32, device=dev)
    size = torch.tensor([voxel_size], dtype=torch.float32, device=dev)
    cell = torch.floor((points[..., :3].float() - lo) / size).to(torch.int32)
    xi, yi, zi = cell.unbind(-1)
    ok = (mask & (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
          & (zi >= 0) & (zi < nz))
    full = torch.where(ok, (yi * nx + xi) * nz + zi, INVALID)

    if presorted:
        full_s = torch.cummax(full, dim=1).values
        pts_s = points
    else:
        full_s, order = torch.sort(full, dim=1, stable=True)
        pts_s = torch.gather(points, 1, order[..., None].expand(-1, -1, d))
    valid = full_s != INVALID
    okf = valid.to(points.dtype)[..., None]
    col_s = torch.where(valid, torch.div(full_s, nz, rounding_mode="floor"),
                        INVALID)
    z_s = torch.where(valid, full_s % nz, 0)

    chead = torch.ones_like(valid)
    chead[:, 1:] = col_s[:, 1:] != col_s[:, :-1]
    chead &= valid
    crank = torch.cumsum(chead, dim=1, dtype=torch.int32) - 1
    crank = torch.clamp(torch.where(valid, crank, max_cols), max=max_cols)

    seg_rows = max_cols * nz + 1
    slot = torch.where(crank < max_cols, crank * nz + z_s, max_cols * nz)
    slot = slot.long() + torch.arange(b, device=dev)[:, None] * seg_rows
    vals = torch.cat([pts_s * okf, okf], dim=-1).reshape(b * n, d + 1)
    seg = torch.zeros((b * seg_rows, d + 1), dtype=points.dtype, device=dev)
    seg = seg.index_add_(0, slot.reshape(-1), vals).reshape(
        b, seg_rows, d + 1)[:, :max_cols * nz]
    cnt = seg[..., d:]
    feats = (seg[..., :d] / torch.clamp(cnt, min=1.0)).reshape(
        b, max_cols, nz, d)
    occ = (cnt > 0).reshape(b, max_cols, nz)

    ckeys = torch.full((b, max_cols + 1), INVALID, dtype=torch.int32,
                       device=dev)
    ckeys.scatter_(1, torch.where(chead, crank, max_cols).long(),
                   torch.where(chead, col_s, INVALID))
    ckeys = ckeys[:, :max_cols]
    cvalid = ckeys != INVALID
    kk = torch.where(cvalid, ckeys, 0)
    coords2 = torch.stack([torch.div(kk, nx, rounding_mode="floor"),
                           kk % nx], dim=-1)
    return {
        "ckeys": ckeys,
        "coords2": torch.where(cvalid[..., None], coords2, 0),
        "feats": feats,
        "occ": occ & cvalid[..., None],
        "cvalid": cvalid,
        "grid": (nz, ny, nx),
    }


def rank_map(cols: dict) -> torch.Tensor:
    """(B, H*W + 1) int32 map: 2D cell key -> the agent's column rank;
    miss = Vc. Built once per level and shared by that level's
    ``column_table`` and the ``strided_table`` into the next. Every
    invalid column writes the dump slot H*W, which lookups never read
    (their masks exclude it), so only [:, :H*W] is defined."""
    ckeys, cvalid = cols["ckeys"], cols["cvalid"]
    _, h, w = cols["grid"]
    b, vc = ckeys.shape
    kk = torch.where(cvalid, ckeys, h * w).long()
    dmap = torch.full((b, h * w + 1), vc, dtype=torch.int32,
                      device=ckeys.device)
    ranks = torch.arange(vc, dtype=torch.int32, device=ckeys.device)
    return dmap.scatter_(1, kk, ranks.expand(b, vc))


def _lookup(dmap, qy, qx, ok, h, w, miss):
    """dmap at the (B, R, 9) cells (qy, qx) where ``ok``, else ``miss``."""
    b = qy.shape[0]
    okq = ok & (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
    nk = torch.where(okq, qy * w + qx, 0)
    got = torch.gather(dmap, 1, nk.reshape(b, -1).long()).reshape(nk.shape)
    return torch.where(okq, got, miss)


def column_table(cols: dict, dmap=None) -> torch.Tensor:
    """(B, Vc, 9) neighbour-column ranks for the 3x3 BEV stencil; miss =
    Vc. Nine reads of the level's rank map."""
    if dmap is None:
        dmap = rank_map(cols)
    coords2, cvalid = cols["coords2"], cols["cvalid"]
    _, h, w = cols["grid"]
    offs = torch.tensor(_offsets2d(), dtype=torch.int32,
                        device=coords2.device)
    return _lookup(dmap, coords2[..., None, 0] + offs[:, 0],
                   coords2[..., None, 1] + offs[:, 1], cvalid[..., None],
                   h, w, cols["ckeys"].shape[1])


def _zstack(g: torch.Tensor) -> torch.Tensor:
    """(N, Z, C) -> (N, Z, 3C): [in[z-1], in[z], in[z+1]] per z."""
    gp = F.pad(g, (0, 0, 1, 1))
    return torch.cat([gp[:, :-2], gp[:, 1:-1], gp[:, 2:]], dim=-1)


def _zero_row(feats: torch.Tensor) -> torch.Tensor:
    """(B, Vc, Z, C) -> (B*Vc + 1, Z, C): the agents' rows stacked, then
    one zero row, which every table miss reads."""
    b, vc, z, c = feats.shape
    return F.pad(feats.reshape(b * vc, z, c), (0, 0, 0, 0, 0, 1))


def subm_conv(cols: dict, weights, table=None, bias=None) -> torch.Tensor:
    """Submanifold 3x3x3 conv on columns: (B, Vc, Z, Cin) -> (B, Vc, Z,
    Cout) in the features' dtype, re-masked with ``occ``. weights
    (27, Cin, Cout) in ``_offsets()`` order.

    JAX gathers each tap's neighbour rows, z-stacks them and multiplies;
    the port z-stacks every row once, multiplies each tap's (3*Cin, Cout)
    block over all rows, and gathers the PRODUCTS (a row gather commutes
    with the product), so the z-stack is built once a conv, not nine
    times, and autograd keeps one stacked operand, not nine. The values
    are JAX's: the identity tap takes the rows' own products, and the nine
    partial products are summed in the compute dtype, in tap order."""
    if table is None:
        table = column_table(cols)
    feats = cols["feats"]
    b, vc, z, cin = feats.shape
    cout = weights.shape[-1]
    wdt = feats.dtype
    blocks = _regroup_weights(weights.to(wdt))
    stacked = _zstack(_zero_row(feats)).reshape((b * vc + 1) * z, 3 * cin)
    rows = _rows_of(table, vc).reshape(b * vc, 9)
    out = None
    for j, (dy, dx) in enumerate(_offsets2d()):
        prod = (stacked @ blocks[j]).reshape(b * vc + 1, z * cout)
        part = (prod[:b * vc] if dy == 0 and dx == 0
                else _take_rows(prod, rows[:, j]))
        out = part if out is None else out + part
    out = out.reshape(b, vc, z, cout)
    if bias is not None:
        out = out + bias
    return out * cols["occ"][..., None].to(wdt)


def downsample_columns(cols: dict, max_out: int) -> dict:
    """spconv SparseConv3d(k=3, s=2, p=1) output columns: output column
    (oy, ox) is active iff an active input column lies in its 3x3
    stride-2 window, found by a max-pool of the input's 2D occupancy
    image (a float image: CUDA pools no int8; the pool's -inf padding
    acts as JAX's 0, since all values are >= 0) and compacted in key
    order. Columns past ``max_out`` are dropped."""
    ckeys, cvalid = cols["ckeys"], cols["cvalid"]
    z, h, w = cols["grid"]
    z2, h2, w2 = ((s + 2 - 3) // 2 + 1 for s in (z, h, w))
    b = ckeys.shape[0]
    dev = ckeys.device
    kk = torch.where(cvalid, ckeys, h * w).long()
    occ2d = torch.zeros((b, h * w + 1), dtype=torch.float32, device=dev)
    occ2d.scatter_(1, kk, 1.0)
    act = F.max_pool2d(occ2d[:, :h * w].reshape(b, 1, h, w), 3, 2, 1)
    mask = act.reshape(b, h2 * w2) > 0
    rank = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    cell = torch.arange(h2 * w2, dtype=torch.int32, device=dev)
    # each cell not kept writes a dump slot of its own (max_out + cell):
    # no two writes meet, where one shared slot would take ~h2*w2 stores
    kept = mask & (rank < max_out)
    ckeys_o = torch.full((b, max_out + h2 * w2), INVALID, dtype=torch.int32,
                         device=dev)
    ckeys_o.scatter_(1, torch.where(kept, rank, max_out + cell).long(),
                     torch.where(kept, cell, INVALID))
    ckeys_o = ckeys_o[:, :max_out]
    cvalid_o = ckeys_o != INVALID
    kko = torch.where(cvalid_o, ckeys_o, 0)
    coords2_o = torch.stack([torch.div(kko, w2, rounding_mode="floor"),
                             kko % w2], dim=-1)
    return {
        "ckeys": ckeys_o,
        "coords2": torch.where(cvalid_o[..., None], coords2_o, 0),
        "cvalid": cvalid_o,
        "grid": (z2, h2, w2),
    }


def strided_table(cols: dict, out_cols: dict, dmap=None) -> torch.Tensor:
    """(B, O, 9) input-column ranks for the strided conv: output column o
    reads input column (2*oy + dy, 2*ox + dx); miss = Vc. ``dmap`` is the
    INPUT level's rank map."""
    if dmap is None:
        dmap = rank_map(cols)
    _, h, w = cols["grid"]
    oc = out_cols["coords2"]
    offs = torch.tensor(_offsets2d(), dtype=torch.int32, device=oc.device)
    return _lookup(dmap, 2 * oc[..., None, 0] + offs[:, 0],
                   2 * oc[..., None, 1] + offs[:, 1],
                   out_cols["cvalid"][..., None], h, w,
                   cols["ckeys"].shape[1])


def _zwindows(g: torch.Tensor, z2: int) -> torch.Tensor:
    """(O, Z, C) -> (O, Z2, 3C): the strided windows in[2*zo - 1 + k],
    k = 0..2."""
    gp = F.pad(g, (0, 0, 1, 1))
    return torch.cat([gp[:, k:k + 2 * z2 - 1:2] for k in range(3)], dim=-1)


def strided_conv(cols: dict, out_cols: dict, weights, table=None,
                 bias=None) -> dict:
    """SparseConv3d k=3 s=2 p=1 on columns: ``out_cols`` completed with
    feats (B, O, Z2, Cout) and occ (B, O, Z2), the max of the input
    occupancy over each output voxel's 3x3x3 field. As in ``subm_conv``,
    the strided z windows of every input row are built once and each
    tap's products gathered into the output columns; the occupancy's
    windows are max-reduced once, then gathered per tap (JAX carries it
    as Z extra lanes of the feature gather: the same maxima)."""
    if table is None:
        table = strided_table(cols, out_cols)
    feats, occ = cols["feats"], cols["occ"]
    b, vc, z, cin = feats.shape
    z2 = out_cols["grid"][0]
    o = table.shape[1]
    cout = weights.shape[-1]
    wdt = feats.dtype
    blocks = _regroup_weights(weights.to(wdt))
    wins = _zwindows(_zero_row(feats), z2).reshape((b * vc + 1) * z2,
                                                    3 * cin)
    occ_wins = _zwindows(_zero_row(occ[..., None].to(wdt)), z2).amax(-1)
    rows = _rows_of(table, vc).reshape(b * o, 9)
    out = None
    occ_o = None
    for j in range(9):
        prod = (wins @ blocks[j]).reshape(b * vc + 1, z2 * cout)
        part = _take_rows(prod, rows[:, j])
        out = part if out is None else out + part
        got = occ_wins[rows[:, j]]
        occ_o = got if occ_o is None else torch.maximum(occ_o, got)
    out = out.reshape(b, o, z2, cout)
    if bias is not None:
        out = out + bias
    occ_b = (occ_o.reshape(b, o, z2) > 0) & out_cols["cvalid"][..., None]
    out = out * occ_b[..., None].to(wdt)
    return dict(out_cols, feats=out, occ=occ_b)


def _agent_rows(cols: dict) -> torch.Tensor:
    """(B*Vc,) int64 rows of the agents' stacked (B*(H*W+1)) dense cells;
    invalid columns go to their agent's dump cell H*W."""
    ckeys, cvalid = cols["ckeys"], cols["cvalid"]
    _, h, w = cols["grid"]
    b = ckeys.shape[0]
    kk = torch.where(cvalid, ckeys, h * w).long()
    return (kk + torch.arange(b, device=kk.device)[:, None] * (h * w + 1)
            ).reshape(-1)


def to_dense_bev(cols: dict, feats=None) -> torch.Tensor:
    """Columns -> dense (B, H, W, Z*C) NHWC map (HeightCompression): z
    folded into channels z-major, channel z*C + c, as JAX's; the branch
    views it as NCHW (B, Z*C, H, W) with the same channel order."""
    if feats is None:
        feats = cols["feats"]
    z, h, w = cols["grid"]
    b, vc, _, c = feats.shape
    rows = (feats * cols["occ"][..., None].to(feats.dtype)).reshape(
        b * vc, z * c)
    dense = feats.new_zeros((b * (h * w + 1), z * c)).index_put(
        (_agent_rows(cols),), rows)
    return dense.reshape(b, h * w + 1, z * c)[:, :h * w].reshape(
        b, h, w, z * c)


def to_dense_voxels(cols: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Columns -> dense (B, Z, H, W, C) canvas and (B, Z, H, W) occupancy
    (the dense tail of the SECOND stack)."""
    z, h, w = cols["grid"]
    feats, occ, cvalid = cols["feats"], cols["occ"], cols["cvalid"]
    b, vc, _, c = feats.shape
    rows = _agent_rows(cols)
    dense = feats.new_zeros((b * (h * w + 1), z, c)).index_put(
        (rows,), (feats * cvalid[..., None, None].to(feats.dtype)).reshape(
            b * vc, z, c))
    docc = torch.zeros((b * (h * w + 1), z), dtype=torch.bool,
                       device=feats.device).index_put(
        (rows,), (occ & cvalid[..., None]).reshape(b * vc, z))
    dense = dense.reshape(b, h * w + 1, z, c)[:, :h * w].reshape(
        b, h, w, z, c).permute(0, 3, 1, 2, 4)
    docc = docc.reshape(b, h * w + 1, z)[:, :h * w].reshape(
        b, h, w, z).permute(0, 3, 1, 2)
    return dense, docc


def dense_subm_conv(dense, docc, weights) -> torch.Tensor:
    """Dense 3x3x3 conv restricted to active sites, the submanifold conv:
    dense (B, Z, H, W, C), weights (27, Cin, Cout) in ``_offsets()``
    order ((dz, dy, dx), dz-major, the DHW order of a conv3d kernel)."""
    cin, cout = weights.shape[1:]
    k = weights.to(dense.dtype).reshape(3, 3, 3, cin, cout).permute(
        4, 3, 0, 1, 2)
    out = F.conv3d(dense.permute(0, 4, 1, 2, 3), k, padding=1)
    return out.permute(0, 2, 3, 4, 1) * docc[..., None].to(out.dtype)
