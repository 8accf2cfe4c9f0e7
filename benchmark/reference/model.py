"""Plain PyTorch reference of HEAL's heterogeneous Pyramid Fusion model:
per-type encoder -> BEV backbone -> aligner -> slot scatter -> Pyramid
Fusion (per-level occupancy heads, warp to the ego, softmax-weighted
sum) -> shrink -> cls / reg / dir heads.

Written from the published architecture (HEAL, ICLR 2024) after the
port's modules at commit 067a829 (heal_tpu_torch/models/layers.py,
resnet_bev.py, aligner.py, heads.py, fuse/pyramid.py, heter_pyramid.py,
encoders.py), with their parameter names, so that one set of weights
loads into both. It imports nothing of the port and calls no kernel:
the PointPillars encoder is the textbook PillarVFE (decorate each point,
linear, batch norm, ReLU, max over the pillar) where the port folds it
into kernel 1, and the warp runs plain row and column shifts
(``warp.py``) where the port launches kernel 2. NCHW inside; the heads
return NHWC as the port's do. Batch norm follows flax: momentum 0.9 on
the running statistics, the biased batch variance in train mode.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import warp

BN_MOMENTUM = 0.9


class Norm(nn.Module):
    """Batch norm over N, H, W (train: batch moments; eval: running)."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        if self.training:
            m = x.mean((0, 2, 3))
            v = x.var((0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * m)
                self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * v)
        else:
            m, v = self.mean, self.var
        y = (x - m[:, None, None]) / torch.sqrt(v[:, None, None] + self.eps)
        return y * self.scale[:, None, None] + self.bias[:, None, None]


class Conv(nn.Module):
    """Biased conv, symmetric padding (k - 1) // 2 unless given."""

    def __init__(self, cin, cout, k=1, stride=1, padding=None, groups=1):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.padding = (k - 1) // 2 if padding is None else padding
        self.kernel = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv2d(x, self.kernel, self.bias, self.stride, self.padding,
                        groups=self.groups)


class Dense(nn.Module):
    """x @ kernel (in, out) + bias over the last axis."""

    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class LayerNorm(nn.Module):
    """Over the last axis, eps 1e-6."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        m = x.mean(-1, keepdim=True)
        v = x.var(-1, unbiased=False, keepdim=True)
        return (x - m) / torch.sqrt(v + 1e-6) * self.scale + self.bias


class ConvNormAct(nn.Module):
    """Bias-free conv -> batch norm -> ReLU (or none)."""

    def __init__(self, cin, cout, k=3, stride=1, act=True, eps=1e-3):
        super().__init__()
        self.stride, self.act = stride, act
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k))
        self.Norm_0 = Norm(cout, eps)

    def forward(self, x):
        pad = (self.kernel.shape[-1] - 1) // 2
        y = self.Norm_0(F.conv2d(x, self.kernel, None, self.stride, pad))
        return F.relu(y) if self.act else y


class Deconv(nn.Module):
    """Transposed conv, kernel = stride; kernel (cin, cout, s, s)."""

    def __init__(self, cin, cout, s):
        super().__init__()
        self.s = s
        self.kernel = nn.Parameter(torch.empty(cin, cout, s, s))

    def forward(self, x):
        return F.conv_transpose2d(x, self.kernel, stride=self.s)


class DeconvNormAct(nn.Module):
    def __init__(self, cin, cout, s):
        super().__init__()
        if s < 1:
            raise ValueError("strided-down deblocks are not in the "
                             "benchmark's configurations")
        self.ConvTranspose_0 = Deconv(cin, cout, int(s))
        self.Norm_0 = Norm(cout)

    def forward(self, x):
        return F.relu(self.Norm_0(self.ConvTranspose_0(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride=1):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(cin, planes, 3, stride, eps=1e-5)
        self.ConvNormAct_1 = ConvNormAct(planes, planes, 3, 1, False, 1e-5)
        self.ConvNormAct_2 = (ConvNormAct(cin, planes, 1, stride, False, 1e-5)
                              if stride != 1 or cin != planes else None)

    def forward(self, x):
        out = self.ConvNormAct_1(self.ConvNormAct_0(x))
        skip = x if self.ConvNormAct_2 is None else self.ConvNormAct_2(x)
        return F.relu(out + skip)


class BottleneckX(nn.Module):
    """ResNeXt bottleneck, expansion 1, dense 3x3 at width
    int(planes * wpg / 64) * 32."""

    def __init__(self, cin, planes, stride=1, wpg=4):
        super().__init__()
        width = int(planes * (wpg / 64.0)) * 32
        self.ConvNormAct_0 = ConvNormAct(cin, width, 1, 1, eps=1e-5)
        self.ConvNormAct_1 = ConvNormAct(width, width, 3, stride, eps=1e-5)
        self.ConvNormAct_2 = ConvNormAct(width, planes, 1, 1, False, 1e-5)
        self.ConvNormAct_3 = (ConvNormAct(cin, planes, 1, stride, False, 1e-5)
                              if stride != 1 or cin != planes else None)

    def forward(self, x):
        out = self.ConvNormAct_2(self.ConvNormAct_1(self.ConvNormAct_0(x)))
        skip = x if self.ConvNormAct_3 is None else self.ConvNormAct_3(x)
        return F.relu(out + skip)


class Stage(nn.Module):
    def __init__(self, cin, planes, blocks, stride, resnext, wpg):
        super().__init__()
        for i in range(blocks):
            s, c = (stride, cin) if i == 0 else (1, planes)
            if resnext:
                self.add_module(f"BottleneckX_{i}",
                                BottleneckX(c, planes, s, wpg))
            else:
                self.add_module(f"BasicBlock_{i}", BasicBlock(c, planes, s))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class Backbone(nn.Module):
    """ResNet BEV stages; deblocks bring each level back to level 0's
    stride and the levels are concatenated on channels."""

    def __init__(self, cin, a: dict):
        super().__init__()
        nf, ups = a["num_filters"], a.get("upsample_strides", [])
        self.levels, self.deblocks = len(a["layer_nums"]), len(ups)
        if self.deblocks > self.levels:
            raise ValueError("trailing deblocks are not in the benchmark's "
                             "configurations")
        c = cin
        for i in range(self.levels):
            self.add_module(f"stages_{i}", Stage(
                c, nf[i], a["layer_nums"][i], a["layer_strides"][i],
                a.get("resnext", False), a.get("width_per_group", 4)))
            c = nf[i]
        for i in range(self.deblocks):
            self.add_module(f"deblocks_{i}", DeconvNormAct(
                nf[i], a["num_upsample_filter"][i], ups[i]))
        self.out_channels = sum(
            a["num_upsample_filter"][i] if i < self.deblocks else nf[i]
            for i in range(self.levels))

    def encode(self, x):
        feats = []
        for i in range(self.levels):
            x = getattr(self, f"stages_{i}")(x)
            feats.append(x)
        return feats

    def decode(self, feats):
        ups = [getattr(self, f"deblocks_{i}")(f) if i < self.deblocks else f
               for i, f in enumerate(feats)]
        return torch.cat(ups, 1)

    def forward(self, x):
        return self.decode(self.encode(x))


class ResBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.ConvNormAct_0 = ConvNormAct(dim, dim, 3, 1)
        self.ConvNormAct_1 = ConvNormAct(dim, dim, 3, 1, act=False)

    def forward(self, x):
        return F.relu(x + self.ConvNormAct_1(self.ConvNormAct_0(x)))


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 -> LayerNorm -> Dense 4x -> GELU (tanh) -> Dense ->
    x + gamma * h."""

    def __init__(self, dim):
        super().__init__()
        self.Conv_0 = Conv(dim, dim, 7, groups=dim)
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, 4 * dim)
        self.Dense_1 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        h = self.LayerNorm_0(self.Conv_0(x).permute(0, 2, 3, 1))
        h = self.Dense_1(F.gelu(self.Dense_0(h), approximate="tanh"))
        return x + (self.gamma * h).permute(0, 3, 1, 2)


class Aligner(nn.Module):
    def __init__(self, args, dim):
        super().__init__()
        method = (args or {}).get("core_method", "identity")
        depth = ((args or {}).get("args") or {}).get("num_of_blocks", 3)
        if method == "res3x3":
            for i in range(depth):
                self.add_module(f"ResBlock3x3_{i}", ResBlock(dim))
        elif method == "convnext":
            for i in range(depth):
                self.add_module(f"ConvNeXtBlock_{i}", ConvNeXtBlock(dim))
        elif method != "identity":
            raise KeyError(f"aligner {method!r} is not in the benchmark's "
                           "configurations")

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class PillarVFE(nn.Module):
    """PointPillars: each valid point decorated with [x, y, z, i, xyz -
    pillar mean, xyz - pillar center], a linear map, batch norm (over
    the valid points in train mode, eps 1e-3), ReLU, the max over the
    pillar; empty pillars 0. -> (B, ny, nx, F)."""

    def __init__(self, enc: dict):
        super().__init__()
        self.voxel = [float(v) for v in enc["voxel_size"]]
        self.range = [float(v) for v in enc["lidar_range"]]
        f = int(enc["pillar_vfe"]["num_filters"][-1])
        if len(enc["pillar_vfe"]["num_filters"]) != 1:
            raise ValueError("one PFN layer in the benchmark's configurations")
        self.out_channels = f
        self.nx = int(round((self.range[3] - self.range[0]) / self.voxel[0]))
        self.ny = int(round((self.range[4] - self.range[1]) / self.voxel[1]))
        self.pfn_kernel = nn.Parameter(torch.empty(10, f))
        self.bn_scale = nn.Parameter(torch.ones(f))
        self.bn_bias = nn.Parameter(torch.zeros(f))
        self.register_buffer("bn_mean", torch.zeros(f))
        self.register_buffer("bn_var", torch.ones(f))

    def forward(self, points, mask):
        b, n, _ = points.shape
        (x0, y0, z0, _, _, z1), (vx, vy, vz) = self.range, self.voxel
        xi = torch.floor((points[..., 0] - x0) / vx).long()
        yi = torch.floor((points[..., 1] - y0) / vy).long()
        ok = (mask & (xi >= 0) & (xi < self.nx) & (yi >= 0) & (yi < self.ny)
              & (points[..., 2] >= z0) & (points[..., 2] <= z1))
        pts = points[ok]                                   # (P, 4)
        sample = torch.arange(b, device=points.device)[:, None].expand(b, n)
        pillar = (sample * (self.ny * self.nx) + yi * self.nx + xi)[ok]
        cells = b * self.ny * self.nx
        sums = torch.zeros(cells, 4, device=points.device).index_add(
            0, pillar, torch.cat([pts[:, :3], torch.ones_like(pts[:, :1])], 1))
        mean = sums[:, :3] / sums[:, 3:].clamp(min=1)
        within = pillar % (self.ny * self.nx)
        center = torch.stack([(within % self.nx).float() * vx + x0 + vx / 2,
                              (within // self.nx).float() * vy + y0 + vy / 2,
                              torch.full_like(pts[:, 0], z0 + vz / 2)], 1)
        dec = torch.cat([pts, pts[:, :3] - mean[pillar],
                         pts[:, :3] - center], 1)
        y = dec @ self.pfn_kernel
        if self.training:
            m, v = y.mean(0), y.var(0, unbiased=False)
            with torch.no_grad():
                self.bn_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * m)
                self.bn_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * v)
        else:
            m, v = self.bn_mean, self.bn_var
        y = F.relu((y - m) / torch.sqrt(v + 1e-3) * self.bn_scale
                   + self.bn_bias)
        canvas = torch.zeros(cells, y.shape[1], device=y.device).scatter_reduce(
            0, pillar[:, None].expand_as(y), y, "amax", include_self=True)
        return canvas.reshape(b, self.ny, self.nx, -1)


class Branch(nn.Module):
    """encoder -> backbone -> aligner of one agent type (NCHW out)."""

    def __init__(self, cfg: dict, encoders: dict):
        super().__init__()
        kind = "camera" if cfg.get("sensor_type") == "camera" else \
            cfg["core_method"]
        self.camera = kind == "camera"
        self.encoder = encoders[kind](cfg["encoder_args"])
        bb = cfg["backbone_args"]
        self.backbone = Backbone(self.encoder.out_channels, bb)
        self.aligner = Aligner(cfg.get("aligner_args"), bb["num_filters"][-1])

    def forward(self, inputs):
        if self.camera:
            feat, depth = self.encoder(inputs)
        else:
            feat, depth = self.encoder(inputs["points"],
                                       inputs["point_mask"]), None
        return self.aligner(self.backbone(feat.permute(0, 3, 1, 2))), depth


class Pyramid(nn.Module):
    def __init__(self, a: dict, cin: int):
        super().__init__()
        self.backbone = Backbone(cin, a)
        for i, c in enumerate(a["num_filters"]):
            self.add_module(f"single_head_{i}", Conv(c, 1))
        self.out_channels = self.backbone.out_channels

    def forward(self, x, affine, agent_mask, crop_masks=None):
        """x (B, L, H, W, C) -> fused (B, C', H, W), occupancy logits per
        level (B*L, h, w, 1)."""
        b, l = x.shape[:2]
        feats = self.backbone.encode(x.flatten(0, 1).permute(0, 3, 1, 2))
        fused, occs = [], []
        for i, f in enumerate(feats):
            occ = getattr(self, f"single_head_{i}")(f).permute(0, 2, 3, 1)
            occs.append(occ)
            score = torch.sigmoid(occ) + 1e-4
            if crop_masks is not None:
                score = score * crop_masks[i].reshape(score.shape)
            fl = f.permute(0, 2, 3, 1).unflatten(0, (b, l))
            fused.append(weighted_fuse(fl, score.unflatten(0, (b, l)),
                                       affine, agent_mask).permute(0, 3, 1, 2))
        return self.backbone.decode(fused), occs


def weighted_fuse(feat, score, affine, agent_mask):
    """Every agent's features and score warped into the ego frame, then
    the softmax over agents of the score weighting the features; a
    warped score of exactly 0 (outside the sender's view) and padded
    agents get no weight."""
    cat = torch.cat([feat, score], -1)
    moved = warp.to_ego(cat, affine)
    f, s = moved[..., :-1], moved[..., -1:]
    logit = torch.where(s == 0, torch.full_like(s, float("-inf")), s)
    logit = torch.where(agent_mask[:, :, None, None, None], logit,
                        torch.full_like(s, float("-inf")))
    w = torch.nan_to_num(torch.softmax(logit, 1), nan=0.0)
    return (f * w).sum(1)


class Shrink(nn.Module):
    def __init__(self, cin, sh: dict):
        super().__init__()
        self.n = len(sh["dim"])
        pads = sh.get("padding") or [(k - 1) // 2 for k in sh["kernal_size"]]
        for i, (d, k, s, p) in enumerate(zip(sh["dim"], sh["kernal_size"],
                                             sh["stride"], pads)):
            self.add_module(f"conv_{i}a", Conv(cin, d, k, s, p))
            self.add_module(f"conv_{i}b", Conv(d, d, 3, 1, 1))
            cin = d

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"conv_{i}a")(x))
            x = F.relu(getattr(self, f"conv_{i}b")(x))
        return x


class Heads(nn.Module):
    def __init__(self, cin, anchors, bins):
        super().__init__()
        self.cls_head = Conv(cin, anchors)
        self.reg_head = Conv(cin, 7 * anchors)
        self.dir_head = Conv(cin, bins * anchors)

    def forward(self, x):
        return {k: getattr(self, k.replace("_preds", "_head"))(x)
                .permute(0, 2, 3, 1) for k in
                ("cls_preds", "reg_preds", "dir_preds")}


def camera_canvas(grid: dict, lidar_range, h: int, w: int):
    """The lidar range's canvas at the camera grid's cell size."""
    sh = (lidar_range[4] - lidar_range[1]) / (grid["ybound"][1]
                                               - grid["ybound"][0])
    sw = (lidar_range[3] - lidar_range[0]) / (grid["xbound"][1]
                                               - grid["xbound"][0])
    return int(round(h * sh)), int(round(w * sw))


def center_crop_or_pad(feat, th: int, tw: int):
    """(N, H, W, C) centre-cropped or zero-padded to (N, th, tw, C)."""
    h, w = feat.shape[1:3]
    if h >= th:
        feat = feat[:, (h - th) // 2:(h - th) // 2 + th]
    else:
        feat = F.pad(feat, (0, 0, 0, 0, (th - h) // 2, th - h - (th - h) // 2))
    if w >= tw:
        feat = feat[:, :, (w - tw) // 2:(w - tw) // 2 + tw]
    else:
        feat = F.pad(feat, (0, 0, (tw - w) // 2, tw - w - (tw - w) // 2))
    return feat


def fov_mask(h, w, rh, rw, device):
    """1 inside the camera-covered centre less a 4-pixel guard, else 0."""
    vh, vw = min(h, int(h / rh) - 4), min(w, int(w / rw) - 4)
    m = torch.zeros(h, w, 1, device=device)
    m[(h - vh) // 2:(h - vh) // 2 + vh, (w - vw) // 2:(w - vw) // 2 + vw] = 1
    return m


class HeterPyramid(nn.Module):
    """``heter_pyramid_collab``: every agent type's branch, its features
    scattered into the agents' slots, Pyramid Fusion, shrink, heads."""

    def __init__(self, args: dict, encoders: dict):
        super().__init__()
        self.types = [m for m in ("m1", "m2", "m3", "m4") if m in args]
        self.range = args["lidar_range"]
        self.grids = {m: args[m]["encoder_args"]["grid_conf"]
                      for m in self.types
                      if args[m].get("sensor_type") == "camera"}
        for m in self.types:
            self.add_module(f"branch_{m}", Branch(args[m], encoders))
        fb = args["fusion_backbone"]
        self.strides = [int(s) for s in np.cumprod(fb["layer_strides"])]
        cin = args[self.types[0]]["backbone_args"]["num_filters"][-1]
        self.pyramid_backbone = Pyramid(fb, cin)
        self.shrink = Shrink(self.pyramid_backbone.out_channels,
                             args["shrink_header"])
        self.heads = Heads(args["shrink_header"]["dim"][-1],
                           args["anchor_number"],
                           args["dir_args"]["num_bins"])

    def forward(self, batch: dict) -> dict:
        mask = batch["agent_mask"]
        b, l = mask.shape
        canvas, out, ratios = None, {}, {}
        for m in self.types:
            inputs = batch[f"inputs_{m}"]
            lm = next(iter(inputs.values())).shape[1]
            flat = {k: v.flatten(0, 1) for k, v in inputs.items()}
            feat, depth = getattr(self, f"branch_{m}")(flat)
            feat = feat.permute(0, 2, 3, 1)
            if depth is not None:
                out[f"depth_items_{m}"] = depth
            if m in self.grids:
                g = self.grids[m]
                th, tw = (canvas.shape[2:4] if canvas is not None else
                          camera_canvas(g, self.range, *feat.shape[1:3]))
                feat = center_crop_or_pad(feat, th, tw)
                ratios[m] = (self.range[4] / g["ybound"][1],
                             self.range[3] / g["xbound"][1])
            if canvas is None:
                canvas = feat.new_zeros((b, l + 1) + feat.shape[1:])
            slots = batch[f"slots_{m}"].long()
            canvas = canvas.index_put(
                (torch.arange(b, device=slots.device)[:, None].expand_as(
                    slots), slots), feat.unflatten(0, (b, lm)),
                accumulate=True)
        crop = None
        if not self.training and ratios:
            crop = []
            h, w = canvas.shape[2:4]
            for s in self.strides:
                level = canvas.new_ones((b, l + 1, h // s, w // s, 1))
                for m, (rh, rw) in ratios.items():
                    sl = batch[f"slots_{m}"].long()
                    level[torch.arange(b, device=sl.device)[:, None], sl] = \
                        fov_mask(h // s, w // s, rh, rw, canvas.device)
                crop.append(level[:, :l])
        fused, occs = self.pyramid_backbone(canvas[:, :l],
                                            batch["pairwise_affine"], mask,
                                            crop)
        out.update(self.heads(self.shrink(fused)))
        out["occ_single_list"] = occs
        return out
