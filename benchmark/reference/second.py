"""Plain SECOND encoder (Yan et al., Sensors 2018) as HEAL's m3 agent
runs it: mean-feature voxels, a submanifold 3x3x3 conv, then stages of
a strided 3x3x3 conv (stride 2, padding 1) and two submanifold convs,
each followed by a per-voxel LayerNorm (eps 1e-3) and ReLU; the last
stage's z layers folded into channels, z-major.

After heal_tpu_torch/models/second.py (``SecondEncoder``, parameter
names ``VmapSecondStack_0.*``) and the semantics of ops/column_conv.py
at commit 067a829, computed here voxel by voxel: each voxel finds its
neighbours by a sorted-key search, where the program works on whole BEV
columns with z dense. The capacities are the program's: an agent keeps
its first ``max_voxels[0]`` BEV columns in key order (y * nx + x), and a
strided conv's output columns, those with an active input column in
their 3x3 window, are capped at ``max_voxels[i]`` the same way.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .model import LayerNorm

OFFSETS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)]


class Layer(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(27, cin, cout))
        self.LayerNorm_0 = LayerNorm(cout)

    def norm_act(self, x):
        m = x.mean(-1, keepdim=True)
        v = x.var(-1, unbiased=False, keepdim=True)
        ln = self.LayerNorm_0
        return F.relu((x - m) / torch.sqrt(v + 1e-3) * ln.scale + ln.bias)


def _key(c, grid):
    nz, ny, nx = grid
    return (c[:, 1] * nx + c[:, 2]) * nz + c[:, 0]


def _conv(layer, feats, coords, grid, out_coords, stride):
    """Sum over the 27 taps of kernel[tap]^T in[stride * o + offset] for
    every output voxel ``o`` whose input neighbour is active."""
    keys = _key(coords, grid)
    order = torch.argsort(keys)
    skeys = keys[order]
    nz, ny, nx = grid
    out = feats.new_zeros(len(out_coords), layer.kernel.shape[2])
    for t, off in enumerate(OFFSETS):
        q = out_coords * stride + torch.tensor(off, device=feats.device)
        inside = ((q[:, 0] >= 0) & (q[:, 0] < nz) & (q[:, 1] >= 0)
                  & (q[:, 1] < ny) & (q[:, 2] >= 0) & (q[:, 2] < nx))
        k = _key(q.clamp(min=0), grid)
        pos = torch.searchsorted(skeys, k).clamp(max=len(skeys) - 1)
        hit = inside & (skeys[pos] == k)
        src = feats[order[pos]] * hit[:, None]
        out = out + src @ layer.kernel[t]
    return out


def _capped_columns(coords, grid, cap):
    """The first ``cap`` BEV columns, in key order, of the voxels."""
    nx = grid[2]
    cols = torch.unique(coords[:, 1] * nx + coords[:, 2])
    return cols[:cap]


class SecondStack(nn.Module):
    def __init__(self, enc: dict):
        super().__init__()
        s = enc.get("second", {})
        self.channels = list(s.get("channels", (16, 32, 64, 64)))
        self.caps = list(s.get("max_voxels", (24000, 16000, 12000, 8000)))
        self.range = [float(v) for v in enc["lidar_range"]]
        self.voxel = [float(v) for v in enc["voxel_size"]]
        ch = self.channels
        self.conv_input = Layer(4, ch[0])
        for si in range(1, len(ch)):
            setattr(self, f"down_{si}", Layer(ch[si - 1], ch[si]))
            for j in range(2):
                setattr(self, f"stage{si}_subm{j}", Layer(ch[si], ch[si]))

    def grid(self):
        return [int(round((self.range[3 + a] - self.range[a])
                          / self.voxel[a])) for a in (2, 1, 0)]

    def one(self, points, mask):
        """One agent's (N, 4) points -> (H, W, Z*C)."""
        grid = self.grid()
        nz, ny, nx = grid
        lo = torch.tensor(self.range[:3], device=points.device)
        size = torch.tensor(self.voxel, device=points.device)
        c = torch.floor((points[:, :3] - lo) / size).long()
        ok = (mask & (c[:, 0] >= 0) & (c[:, 0] < nx) & (c[:, 1] >= 0)
              & (c[:, 1] < ny) & (c[:, 2] >= 0) & (c[:, 2] < nz))
        zyx = c[ok][:, [2, 1, 0]]
        pts = points[ok]
        kept = _capped_columns(zyx, grid, self.caps[0])
        col = zyx[:, 1] * nx + zyx[:, 2]
        keep = torch.isin(col, kept)
        zyx, pts = zyx[keep], pts[keep]
        if len(pts) == 0:
            return self.empty()
        keys, inverse = torch.unique(_key(zyx, grid), return_inverse=True)
        n = len(keys)
        sums = torch.zeros(n, 5, device=points.device).index_add(
            0, inverse, torch.cat([pts, torch.ones_like(pts[:, :1])], 1))
        feats = sums[:, :4] / sums[:, 4:]
        coords = torch.stack([keys % nz, keys // nz // nx,
                              keys // nz % nx], 1)
        feats = self.conv_input.norm_act(_conv(
            self.conv_input, feats, coords, grid, coords, 1))
        for si in range(1, len(self.channels)):
            grid2 = [(g - 1) // 2 + 1 for g in grid]
            cols = torch.unique(coords[:, 1] * grid[2] + coords[:, 2])
            cand = self._out_columns(cols // grid[2], cols % grid[2], grid2)
            out_cols = cand[:self.caps[si]]
            ozyx = torch.stack([
                torch.arange(grid2[0], device=feats.device).repeat(
                    len(out_cols)),
                (out_cols // grid2[2]).repeat_interleave(grid2[0]),
                (out_cols % grid2[2]).repeat_interleave(grid2[0])], 1)
            # an output voxel is active where its 3x3x3 field holds one
            occ = _conv_occ(coords, grid, ozyx)
            layer = getattr(self, f"down_{si}")
            f = _conv(layer, feats, coords, grid, ozyx[occ], 2)
            feats, coords, grid = layer.norm_act(f), ozyx[occ], grid2
            for j in range(2):
                layer = getattr(self, f"stage{si}_subm{j}")
                feats = layer.norm_act(_conv(layer, feats, coords, grid,
                                             coords, 1))
        nz, ny, nx = grid
        c = feats.shape[1]
        dense = feats.new_zeros(ny * nx, nz, c)
        dense[coords[:, 1] * nx + coords[:, 2], coords[:, 0]] = feats
        return dense.reshape(ny, nx, nz * c)

    def empty(self):
        grid, c = self.grid(), self.channels[-1]
        for _ in range(len(self.channels) - 1):
            grid = [(g - 1) // 2 + 1 for g in grid]
        return self.conv_input.kernel.new_zeros(grid[1], grid[2],
                                                grid[0] * c)

    @staticmethod
    def _out_columns(cy, cx, grid2):
        """Sorted output columns with an input column in their window:
        input row i lies in the windows of outputs o with 2o - 1 <= i <=
        2o + 1."""
        h2, w2 = grid2[1], grid2[2]
        ys = torch.stack([torch.div(cy + 1 - k, 2, rounding_mode="floor")
                          for k in range(3)], 1)
        xs = torch.stack([torch.div(cx + 1 - k, 2, rounding_mode="floor")
                          for k in range(3)], 1)
        yok = (2 * ys - 1 + torch.arange(3, device=cy.device) == cy[:, None])
        xok = (2 * xs - 1 + torch.arange(3, device=cx.device) == cx[:, None])
        y = ys[:, :, None].expand(-1, 3, 3)
        x = xs[:, None, :].expand(-1, 3, 3)
        ok = (yok[:, :, None] & xok[:, None, :] & (y >= 0) & (y < h2)
              & (x >= 0) & (x < w2))
        return torch.unique((y * w2 + x)[ok])

    def forward(self, points, mask):
        return torch.stack([self.one(p, m) for p, m in zip(points, mask)])


def _conv_occ(coords, grid, ozyx):
    """Whether each output voxel's stride-2 3x3x3 field holds an active
    input voxel."""
    keys = torch.sort(_key(coords, grid)).values
    nz, ny, nx = grid
    occ = torch.zeros(len(ozyx), dtype=torch.bool, device=coords.device)
    for off in OFFSETS:
        q = ozyx * 2 + torch.tensor(off, device=coords.device)
        inside = ((q[:, 0] >= 0) & (q[:, 0] < nz) & (q[:, 1] >= 0)
                  & (q[:, 1] < ny) & (q[:, 2] >= 0) & (q[:, 2] < nx))
        k = _key(q.clamp(min=0), grid)
        pos = torch.searchsorted(keys, k).clamp(max=len(keys) - 1)
        occ |= inside & (keys[pos] == k)
    return occ


class Second(nn.Module):
    def __init__(self, enc: dict):
        super().__init__()
        self.VmapSecondStack_0 = SecondStack(enc)
        nz = self.VmapSecondStack_0.grid()[0]
        for _ in range(len(self.VmapSecondStack_0.channels) - 1):
            nz = (nz - 1) // 2 + 1
        self.out_channels = nz * self.VmapSecondStack_0.channels[-1]

    def forward(self, points, mask):
        return self.VmapSecondStack_0(points, mask)
