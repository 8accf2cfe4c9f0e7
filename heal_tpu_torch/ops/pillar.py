"""Kernel 1: fused segmented max + sum over presorted pillar runs.

``pillar_tables`` turns per-point PFN features into the dense BEV canvas
of the PointPillars encoder in one pass (models/encoders.py). It replaces
the TPU kernel heal_tpu/ops/pallas_pillar.py ``pillar_tables`` and the
sorted scatter-add that expands its rows (heal_tpu/models/encoders.py
``_pallas_eval``). On a CUDA tensor it launches the hand-written kernel of
csrc/pillar_tables.cu once: a block per tile of canvas rows finds its runs
by searching the sorted ids and writes every row exactly once, zeros
included, with no host sync (see the notes there on design and bounds);
the tracer counts each launch as ``kernel1.launches``
(heal_tpu_torch/trace.py). On a CPU tensor it takes
``pillar_tables_plain``, the same result by ``scatter_reduce`` over the
ids.

``pillar_rows_plain`` reproduces the Pallas kernel's own (vals, cells)
row contract, so tests can hold the port against the TPU kernel run in
interpret mode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import build


class PillarGrid(NamedTuple):
    """Geometry of the pillar table.

    Ids are table-space: sample ``s`` owns ids ``[s*cells, (s+1)*cells)``,
    whose last slot (``stride`` = ny*nx <= within-sample id) is the drop
    bucket. The canvas is canvas-space, ``stride`` rows per sample.
    """

    nx: int
    stride: int  # canvas rows per sample (ny*nx)
    cells: int  # table ids per sample (ny*nx + 1 with the drop bucket)
    vx: float
    vy: float
    cx0: float  # x of pillar column 0's center (x0 + vx/2)
    cy0: float  # y of pillar row 0's center (y0 + vy/2)
    cz: float  # z of every pillar center (z0 + vz/2)


def _table_term(sums: torch.Tensor, cell_in: torch.Tensor, weights, grid):
    """Per-pillar additive term: -Σlocal@W1/max(cnt,1) + center@W2 + b."""
    yi = torch.div(cell_in, grid.nx, rounding_mode="floor")
    xi = cell_in - yi * grid.nx
    center = torch.stack(
        [
            xi.to(torch.float32) * grid.vx + grid.cx0,
            yi.to(torch.float32) * grid.vy + grid.cy0,
            torch.full_like(xi, 0, dtype=torch.float32) + grid.cz,
        ],
        dim=-1,
    )
    w1, w2, b_aff = weights[0:3], weights[3:6], weights[6]
    return (
        -(sums[:, :3] @ w1) / torch.clamp(sums[:, 3:4], min=1.0)
        + center @ w2
        + b_aff
    )


def pillar_tables_plain(
    u: torch.Tensor,
    g4: torch.Tensor,
    fi: torch.Tensor,
    weights: torch.Tensor,
    grid: PillarGrid,
    batch: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`pillar_tables` (same arguments)."""
    n, f = u.shape
    s_total = batch * grid.cells
    dev = u.device
    idx = fi.long()
    inb = (idx >= 0) & (idx < s_total)  # padding sentinels fall outside
    idx = torch.where(inb, idx, torch.full_like(idx, s_total))
    m = torch.full((s_total + 1, f), float("-inf"), device=dev).scatter_reduce(
        0, idx[:, None].expand(n, f), u.float(), "amax", include_self=True
    )[:s_total]
    sums = torch.zeros((s_total + 1, 4), device=dev).index_add_(
        0, idx, g4.float()
    )[:s_total]
    cell_in = torch.arange(s_total, device=dev) % grid.cells
    tb = _table_term(sums, cell_in, weights.float(), grid)
    vals = torch.where(
        torch.isfinite(m), torch.relu(m + tb), torch.zeros_like(m)
    )
    vals = vals.reshape(batch, grid.cells, f)[:, : grid.stride]
    return vals.reshape(batch * grid.stride, f).to(u.dtype)


def pillar_tables(
    u: torch.Tensor,
    g4: torch.Tensor,
    fi: torch.Tensor,
    weights: torch.Tensor,
    grid: PillarGrid,
    batch: int,
) -> torch.Tensor:
    """Dense canvas of the segmented max/sum with the pillar epilogue.

    u (N, F) f32 or bf16: per-point PFN features with the BN scale folded
    in; g4 (N, 4) f32: (w*local_xyz, w); fi (N,) int32: table-space ids,
    sorted (runs of equal ids are pillars); weights (7, F) f32: W1, W2 and
    the BN bias (see _table_term). Returns the (batch*stride, F) canvas in
    u's dtype; pillars with no points, the drop bucket and out-of-range
    ids leave zeros.

    Eval only, like the TPU kernel (JAX calls it only when ``not train``,
    heal_tpu/models/encoders.py:255-259): the canvas carries no graph, so
    a call that autograd would differentiate raises instead of silently
    cutting the gradient. The train-mode encoder takes its own path.
    """
    if torch.is_grad_enabled() and (u.requires_grad or weights.requires_grad):
        raise RuntimeError(
            "pillar_tables has no backward (eval only): call it under "
            "torch.no_grad() / inference_mode, or use the encoder in train "
            "mode"
        )
    if u.device.type == "cpu":
        return pillar_tables_plain(u, g4, fi, weights, grid, batch)
    n, f = u.shape
    build.expect("pillar_tables", (
        (u, (n, f), u.dtype), (g4, (n, 4), torch.float32),
        (fi, (n,), torch.int32), (weights, (7, f), torch.float32)),
        aligned=(g4,))
    # the kernel writes every row (zeros where no point lands): no fill
    # beforehand, and nothing is read back, so the call never syncs
    canvas = torch.empty((batch * grid.stride, f), dtype=u.dtype,
                         device=u.device)
    build.launch("pillar_tables", "pillar_tables", "kernel1.launches",
                 canvas, u, g4, fi, weights, canvas, n, f, grid.nx,
                 grid.stride, grid.cells, batch, grid.vx, grid.vy, grid.cx0,
                 grid.cy0, grid.cz)
    return canvas


def pillar_work(args) -> dict:
    """What kernel 1's function needs on these arguments (those of
    :func:`pillar_tables`), whatever implements it: ``bytes`` reads the
    u, g4 and fi rows of the points whose run lands on the canvas, the
    weights, and writes the canvas once; ``flops`` counts the channel max
    and four sums a landed point and the epilogue a landed run (two
    3-term products, bias, ReLU: 14 a channel). ``bytes_all`` is the
    earlier, larger count, which read all of u, g4 and fi, padding and
    drop bucket included."""
    u, g4, fi, weights, grid, batch = args
    n, f = u.shape
    ids = fi.long()
    land = (ids >= 0) & (ids < batch * grid.cells) & (
        ids % grid.cells < grid.stride)
    n_land = int(land.sum())
    runs = int(torch.unique_consecutive(fi[land]).numel())
    canvas = batch * grid.stride * f * u.element_size()
    wbytes = weights.numel() * weights.element_size()
    row = f * u.element_size() + g4.shape[1] * 4 + 4
    return dict(
        bytes=n_land * row + wbytes + canvas,
        bytes_all=n * row + wbytes + canvas,
        flops=n_land * (f + 4) + runs * f * 14,
        landed=n_land, runs=runs,
    )


def pillar_ops(*args) -> int:
    """Operations of one :func:`pillar_tables` call (same arguments):
    :func:`pillar_work`'s ``flops``."""
    return pillar_work(args)["flops"]


def pillar_rows_plain(u, g4, cidx, ends, cellf, sampf, consts):
    """The Pallas kernel's row contract, in plain PyTorch.

    Takes exactly the arguments of heal_tpu.ops.pallas_pillar.pillar_tables
    (consts (8, F): W1, W2, b, and geometry lanes [vx, vy, cx0, cy0, cz,
    nx, stride, -] in row 7) and returns its (vals (N, F), cells (N, 8)):
    a run-END row whose within-sample cell is below ``stride`` holds
    (cell, final value); every other row holds the cell of the latest such
    row before it (0 if none yet) and a zero payload.
    """
    n, f = u.shape
    geom = consts[7].float()
    vx, vy, cx0, cy0, cz, nx, stride = (float(v) for v in geom[:7])
    run = cidx.long()
    n_runs = int(run.max()) + 1 if n else 0
    m = torch.full((n_runs, f), float("-inf")).scatter_reduce(
        0, run[:, None].expand(n, f), u.float(), "amax", include_self=True
    )
    sums = torch.zeros((n_runs, 4)).index_add_(0, run, g4.float())
    cin = cellf.float() - sampf.float() * stride
    has = (ends == 1) & (cin < stride)
    yi = torch.floor(cin / nx)
    xi = cin - yi * nx
    center = torch.stack(
        [xi * vx + cx0, yi * vy + cy0, torch.full_like(xi, cz)], dim=-1
    )
    c32 = consts.float()
    tb = (
        -(sums[run, :3] @ c32[0:3]) / torch.clamp(sums[run, 3:4], min=1.0)
        + center @ c32[3:6]
        + c32[6]
    )
    vals = torch.where(
        has[:, None], torch.relu(m[run] + tb), torch.zeros(n, f)
    )
    # forward fill of the latest finished row's cell (-1 before any)
    rows = torch.arange(n)
    tag = torch.where(has, rows, torch.full_like(rows, -1))
    last = torch.cummax(tag, dim=0).values
    cell = torch.where(
        last >= 0, cellf.float()[last.clamp(min=0)], torch.full((n,), -1.0)
    )
    cells = (cell + 0.5).to(torch.int32)  # truncates toward zero: -1 -> 0
    return vals.to(u.dtype), cells[:, None].expand(n, 8).contiguous()
