"""CenterPoint: the anchor-free BEV detectors (torch).

Counterparts of heal_tpu/models/center_point.py: the PointPillars chain
(encoder -> ResNet BEV backbone -> shrink) and ``CenterHeads``, a
1-channel heatmap and a 7-channel box regression (the box itself, not a
residual: the decode's ``anchor_free`` branch). Every output carries
``anchor_free: True``.

  * ``CenterPoint``: one agent;
  * ``CenterPointBaseline``: every agent slot of a (B, L) batch, then the
    config's ``fusion_method`` (``in_channels`` defaults to the map's
    width). For Where2comm the shared heads run on every agent first and
    their sigmoid is the confidence that gates what is sent; with
    ``where2comm.multi_scale`` each backbone level is fused by its own
    ``Where2commFusion`` (``w2c_fuse_{i}``) under one level-0 mask,
    max-pooled down to the deeper levels, then deblock-decoded;
  * ``CenterPointWhere2comm``: the baseline pinned to Where2comm, under
    ``CenterPointBaseline_0``;
  * ``CenterPointBaselineMultiscale``: each level fused by its own
    fusion (``<Class>_{i}``), then decoded;
  * ``CenterPointIntermediate``: the multiscale model pinned to ``att``,
    under ``ms_att``.

The encoder reads only ``voxel_size``, ``lidar_range``,
``pillar_vfe.num_filters`` and ``norm``, as JAX's ``_encoder`` does.
Module names follow flax's, so heal_tpu variables bridge strictly.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .encoders import PointPillarEncoder
from .fuse.fusion_in_one import Where2commFusion, build_fusion
from .fuse.where2comm_comm import CommMask
from .layers import Conv
from .point_pillar import DetectorChain, IntermediateChain
from .registry import register_model


class CenterHeads(nn.Module):
    """1x1 convs: ``heatmap_head`` (1 channel, its bias starting at -2.19,
    the focal prior) and ``box_head`` (7). NCHW in, NHWC out."""

    def __init__(self, cin: int):
        super().__init__()
        self.heatmap_head = Conv(cin, 1)
        self.heatmap_head.flax_init = {"bias": ("constant", -2.19)}
        self.box_head = Conv(cin, 7)

    def forward(self, x: torch.Tensor) -> dict:
        return {"cls_preds": self.heatmap_head(x).permute(0, 2, 3, 1),
                "reg_preds": self.box_head(x).permute(0, 2, 3, 1)}


def _encoder(a: dict) -> PointPillarEncoder:
    return PointPillarEncoder(
        voxel_size=tuple(a["voxel_size"]),
        lidar_range=tuple(a["lidar_range"]),
        num_filters=tuple(a["pillar_vfe"]["num_filters"]),
        norm=a.get("norm", "batch"),
    )


def _agents(x: torch.Tensor, b: int, l: int) -> torch.Tensor:
    """(B*L, C, H, W) -> (B, L, H, W, C)."""
    x = x.permute(0, 2, 3, 1)
    return x.reshape((b, l) + x.shape[1:])


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(x, ..., "nearest")`` over axes 2 and 3 of
    (B, L, H, W, C): output i reads input floor((i + 0.5) * in / out),
    computed in f32 as JAX computes it (not F.interpolate's rule)."""
    for axis, n in ((2, h), (3, w)):
        m = x.shape[axis]
        if m != n:
            src = (torch.arange(n, dtype=torch.float32, device=x.device)
                   + 0.5) * m / n
            x = x.index_select(axis, torch.floor(src).long())
    return x


@register_model("center_point")
class CenterPoint(DetectorChain):
    """args: voxel_size, lidar_range, pillar_vfe, base_bev_backbone,
    (shrink_header). Batch: points (B, N, 4), point_mask (B, N)."""

    def __init__(self, args: dict):
        super().__init__()
        self.CenterHeads_0 = CenterHeads(self._build_chain(args,
                                                           _encoder(args)))

    def forward(self, batch: dict) -> dict:
        feat = self.features(batch["points"], batch["point_mask"])
        out = self.CenterHeads_0(feat)
        out["spatial_features_2d"] = feat.permute(0, 2, 3, 1)
        out["anchor_free"] = True
        return out


@register_model("center_point_baseline")
class CenterPointBaseline(IntermediateChain):
    """args: CenterPoint's + fusion_method (default max) and its block.
    Batch: points (B, L, N, 4), point_mask (B, L, N), agent_mask (B, L),
    pairwise_affine (B, L, L, 2, 3)."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        width = self._build_chain(args, _encoder(args))
        method = args.get("fusion_method", "max")
        fusion_args = dict(args.get(method, {}) or {})
        fusion_args.setdefault("in_channels", width)
        self.multi_scale = bool(method == "where2comm"
                                and fusion_args.get("multi_scale"))
        if self.multi_scale:
            agg = fusion_args.get("agg_operator") or {}
            self.CommMask_0 = CommMask(
                threshold=fusion_args.get("threshold", 0.01),
                gaussian_smooth=fusion_args.get("gaussian_smooth", True),
                smooth_sigma=fusion_args.get("smooth_sigma", 1.0))
            for i, c in enumerate(args["base_bev_backbone"]["num_filters"]):
                setattr(self, f"w2c_fuse_{i}", Where2commFusion(
                    c, num_heads=agg.get("n_head", 8),
                    agg_mode=str(agg.get("mode", "transformer")).lower(),
                    with_spe=agg.get("with_spe", False)))
        else:
            width = self._build_fusion(method, fusion_args, width, max_cav)
        self.CenterHeads_0 = CenterHeads(width)

    def forward(self, batch: dict) -> dict:
        if self.multi_scale:
            out = self._multiscale_where2comm(batch)
        else:
            feat, b, l = self.agent_features(batch)
            out = self.fused_heads(feat, b, l, batch, self.CenterHeads_0)
        out["anchor_free"] = True
        return out

    def _multiscale_where2comm(self, batch: dict) -> dict:
        """Per-level fusion under one level-0 communication mask, max-pooled
        into the deeper levels (ref where2comm_attn.py:254-310), in JAX's
        order: the whole chain once for the agents' heads, the backbone's
        levels again for the fusion (train-mode running statistics move
        twice, as in JAX)."""
        bev, b, l = self.agent_bev(batch)
        backbone, heads = self.ResNetBEVBackbone_0, self.CenterHeads_0
        single = heads(self.bev_features(bev))
        conf = torch.sigmoid(single["cls_preds"])
        extra = {}
        if self.args.get("supervise_single", False):
            extra = {f"{k}_single": v for k, v in single.items()}
        feats = backbone.encode(bev)
        conf = conf.reshape((b, l) + conf.shape[1:])
        mask, extra["comm_rate"] = self.CommMask_0(
            resize_nearest(conf, *feats[0].shape[2:]))
        fused_levels = []
        cur = mask  # (B, L, h, w, 1)
        for i, f in enumerate(feats):
            hi, wi = f.shape[2:]
            if (hi, wi) != tuple(cur.shape[2:4]):
                k = (cur.shape[2] // hi, cur.shape[3] // wi)
                flat = cur.reshape((b * l,) + cur.shape[2:]).permute(
                    0, 3, 1, 2)
                cur = _agents(F.max_pool2d(flat, k, stride=k), b, l)
            fused = getattr(self, f"w2c_fuse_{i}")(
                _agents(f, b, l), batch["pairwise_affine"],
                batch["agent_mask"], comm_mask=cur)
            fused_levels.append(fused.permute(0, 3, 1, 2))
        fused = self.shrink(backbone.decode(fused_levels))
        out = heads(fused)
        out["spatial_features_2d"] = fused.permute(0, 2, 3, 1)
        out.update(extra)
        return out


@register_model("center_point_where2comm")
class CenterPointWhere2comm(nn.Module):
    """``CenterPointBaseline`` with ``fusion_method: where2comm`` (ref
    models/center_point_where2comm.py)."""

    needs_max_cav = True
    batch_keys = IntermediateChain.batch_keys

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        self.CenterPointBaseline_0 = CenterPointBaseline(
            {**args, "fusion_method": "where2comm"}, max_cav)

    def forward(self, batch: dict) -> dict:
        return self.CenterPointBaseline_0(batch)


@register_model("center_point_baseline_multiscale")
class CenterPointBaselineMultiscale(IntermediateChain):
    """Each backbone level of every agent fused by its own fusion module
    (``<Class>_{i}``, ``in_channels`` the level's width), the fused levels
    deblock-decoded, shrunk and fed to the heads (ref
    models/center_point_baseline_multiscale.py)."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        width = self._build_chain(args, _encoder(args))
        method = args.get("fusion_method", "max")
        self.fusion_names = []
        for c in args["base_bev_backbone"]["num_filters"]:
            fusion_args = dict(args.get(method, {}) or {})
            fusion_args.setdefault("in_channels", c)
            fusion = build_fusion(method, fusion_args, c, max_cav)
            name = f"{type(fusion).__name__}_{len(self.fusion_names)}"
            self.add_module(name, fusion)
            self.fusion_names.append(name)
        self.CenterHeads_0 = CenterHeads(width)

    def forward(self, batch: dict) -> dict:
        bev, b, l = self.agent_bev(batch)
        backbone = self.ResNetBEVBackbone_0
        fused_levels = [
            getattr(self, name)(_agents(f, b, l), batch["pairwise_affine"],
                                batch["agent_mask"]).permute(0, 3, 1, 2)
            for name, f in zip(self.fusion_names, backbone.encode(bev))]
        fused = self.shrink(backbone.decode(fused_levels))
        out = self.CenterHeads_0(fused)
        out["spatial_features_2d"] = fused.permute(0, 2, 3, 1)
        out["anchor_free"] = True
        return out


@register_model("center_point_intermediate")
class CenterPointIntermediate(nn.Module):
    """The multiscale baseline pinned to ``att`` (ref
    models/center_point_intermediate.py's AttBEVBackbone), under
    ``ms_att``."""

    needs_max_cav = True
    batch_keys = IntermediateChain.batch_keys

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        self.ms_att = CenterPointBaselineMultiscale(
            {**args, "fusion_method": "att"}, max_cav)

    def forward(self, batch: dict) -> dict:
        return self.ms_att(batch)
