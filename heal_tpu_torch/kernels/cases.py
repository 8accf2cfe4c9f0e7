"""Kernel 1's measured inputs and the work they need, for chip_smoke.py and
the kernel A/B (tools/kernel_ab.py). Nothing here runs at import time.

Two cases: the eval encoder's arguments on a served frame
(:func:`frame_inputs`), and a frame at the density of OPV2V lidar, every
point real (:func:`dense_inputs`), which loads the reduction side of the
kernel and not only its canvas writes.
"""
from __future__ import annotations

import copy

import numpy as np


def frame_inputs(encoder, points, mask, dtype):
    """``pillar_tables``' arguments for one frame: ``encoder`` (eval) cast
    to ``dtype`` turns points (B, N, 4) and mask (B, N) into (u, g4, fi,
    weights, grid, batch)."""
    import torch

    enc = copy.deepcopy(encoder).to(dtype).eval()
    with torch.inference_mode():
        return enc.kernel_inputs(points, mask)


def dense_counts(rng, points: int, pillars: int, most: int) -> np.ndarray:
    """Points per pillar for one sample: ``pillars`` counts in [1, most]
    summing to ``points``, mostly geometric (few points a pillar, as far
    from the sensor) with 1% of the pillars holding 16 to ``most`` (as
    near it)."""
    if not pillars <= points <= pillars * most:
        raise ValueError("need pillars <= points <= pillars * most")
    counts = np.minimum(rng.geometric(pillars / points, pillars), most)
    heavy = rng.random(pillars) < 0.01
    counts[heavy] = rng.integers(min(16, most), most + 1, int(heavy.sum()))
    while (diff := points - int(counts.sum())) != 0:
        room = np.flatnonzero(counts < most if diff > 0 else counts > 1)
        pick = rng.choice(room, min(abs(diff), room.size), replace=False)
        counts[pick] += 1 if diff > 0 else -1
    return counts


def dense_inputs(grid, batch: int, f: int, dtype, device, seed: int = 0,
                 points: int = 30000, pillars: int = 20000, most: int = 32):
    """``pillar_tables``' arguments for a dense frame on ``grid``: each of
    ``batch`` samples holds ``points`` real points in ``pillars`` distinct
    pillars (1 to ``most`` points each, :func:`dense_counts`), ids sorted;
    u (N, f) in ``dtype``, g4 (small offsets, weight 1) and the weights
    f32, all seeded and made on ``device``."""
    import torch

    rng = np.random.default_rng(seed)
    fi = np.concatenate([
        np.repeat(np.sort(rng.choice(grid.stride, pillars, replace=False))
                  + s * grid.cells, dense_counts(rng, points, pillars, most))
        for s in range(batch)
    ]).astype(np.int32)
    n = fi.size
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.randn((n, f), generator=gen, device=device).to(dtype)
    g4 = torch.cat([
        0.1 * torch.randn((n, 3), generator=gen, device=device),
        torch.ones((n, 1), device=device),
    ], dim=1).contiguous()
    weights = 0.1 * torch.randn((7, f), generator=gen, device=device)
    return u, g4, torch.from_numpy(fi).to(device), weights, grid, batch


def pillar_work(args) -> dict:
    """What kernel 1's function needs on these arguments, whatever
    implements it: ``bytes`` reads the u, g4 and fi rows of the points
    whose run lands on the canvas, the weights, and writes the canvas once;
    ``flops`` counts the channel max and four sums a landed point and the
    epilogue a landed run (two 3-term products, bias, ReLU: 14 a channel).
    ``bytes_all`` is the earlier, larger count, which read all of u, g4 and
    fi, padding and drop bucket included."""
    import torch

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
