"""Homogeneous PointPillars detectors (torch).

Counterparts of heal_tpu/models/point_pillar.py:

  * ``PointPillar`` (the reference's point_pillar.py): one agent's
    points -> ``PointPillarEncoder`` -> ``ResNetBEVBackbone`` -> the
    ``DownsampleConv`` shrink header -> ``DetectionHeads``. Late fusion
    runs it once per agent, early fusion once on the merged points;
  * ``PointPillarUncertainty`` (point_pillar_uncertainty.py, CoAlign's
    stage 1): ``PointPillar`` plus a 1x1 conv ``unc_head`` whose
    ``unc_preds`` hold each anchor's log-variance x, log-variance y and
    log-kappa yaw (tools/pose_graph_pre_calc.py exports them with the
    boxes);
  * ``PointPillarBaseline`` (point_pillar_baseline.py): the same chain
    per agent slot of a (B, L) intermediate batch, ``compression``'s
    ``NaiveCompressor`` when set, then the config's ``fusion_method``
    from the zoo (models/fuse), then the heads. For Where2comm the shared
    heads also run on every agent: their confidence gates what is sent
    (``comm_rate`` in the outputs), and with ``supervise_single`` they
    are the ``_single`` outputs;
  * ``PointPillarBaselineMultiscale`` (point_pillar_baseline_multiscale
    .py): the backbone's stages on the UNFUSED agents' maps (after
    ``compression``'s compressor, when set), each level fused by its own
    fusion (``<Class>_{i}``, ``in_channels`` the level's width), then the
    deblocks on the fused levels, shrink and the heads;
  * ``PointPillarDiscoNet`` (point_pillar_disconet.py): the DiscoNet
    student, ``PointPillarBaseline`` with ``fusion_method`` forced to
    ``disconet`` under ``student``, exporting its fused map as
    ``feature``; ``PointPillarDiscoNetTeacher``: ``PointPillar`` under
    ``teacher``, run on the early-fused view, exporting
    ``teacher_feature`` (tools/train_w_kd.py).

Modules carry flax's auto-names (``PointPillarEncoder_0``,
``ResNetBEVBackbone_0``, ``DownsampleConv_0``, the fusion's
``<Class>_0``, ``DetectionHeads_0``, ``NaiveCompressor_0``), so heal_tpu
checkpoints load strictly. Outputs are NHWC, as in JAX, with
``spatial_features_2d`` the map the heads read; ``use_iou`` adds the
heads' IoU branch (``iou_preds``). ``DetectorChain`` (one
agent) and ``IntermediateChain`` (the (B, L) batch and its fusion) are
shared with the CenterPoint (models/center_point.py) and SECOND
(models/second_model.py) detectors.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .. import trace
from .encoders import PointPillarEncoder
from .fuse.fusion_in_one import build_fusion
from .heads import DetectionHeads
from .layers import Conv, DownsampleConv, NaiveCompressor
from .registry import register_model
from .resnet_bev import ResNetBEVBackbone


def _shrink_from_args(args: dict, cin: int):
    if "shrink_header" not in args:
        return None
    sh = args["shrink_header"]
    return DownsampleConv(
        cin,
        dims=tuple(sh["dim"]),
        kernels=tuple(sh["kernal_size"]),
        strides=tuple(sh["stride"]),
        paddings=tuple(sh.get("padding", ())),
    )


def _backbone_from_args(args: dict, cin: int, norm: str) -> ResNetBEVBackbone:
    bb = args["base_bev_backbone"]
    return ResNetBEVBackbone(
        cin,
        layer_nums=tuple(bb["layer_nums"]),
        layer_strides=tuple(bb["layer_strides"]),
        num_filters=tuple(bb["num_filters"]),
        upsample_strides=tuple(bb.get("upsample_strides", ())),
        num_upsample_filter=tuple(bb.get("num_upsample_filter", ())),
        resnext=bb.get("resnext", False),
        norm=norm,
    )


def out_width(fusion: nn.Module, width: int) -> int:
    """The fused map's width: the decode conv's for Who2com, else the
    input's."""
    decode = getattr(fusion, "decode_layer", None)
    return decode.bias.shape[0] if decode is not None else width


def pillar_encoder(args: dict) -> PointPillarEncoder:
    """The config's PointPillars encoder, every ``pillar_vfe`` option
    read (heal_tpu point_pillar.py's encoders)."""
    return PointPillarEncoder(
        voxel_size=tuple(args["voxel_size"]),
        lidar_range=tuple(args["lidar_range"]),
        num_filters=tuple(args["pillar_vfe"]["num_filters"]),
        use_absolute_xyz=args["pillar_vfe"].get("use_absolute_xyz", True),
        with_distance=args["pillar_vfe"].get("with_distance", False),
        norm=args.get("norm", "batch"),
        presorted=args.get("presorted", False),
    )


class DetectorChain(nn.Module):
    """Encoder -> backbone -> shrink of one agent, and the heads. The
    encoder (PointPillars or SECOND) sits under flax's auto-name."""

    # the batch keys the model reads (tools/inference._model_inputs)
    batch_keys = ("points", "point_mask")

    def _build_chain(self, a: dict, encoder: nn.Module) -> int:
        self.args = a
        norm = a.get("norm", "batch")
        self.encoder_name = f"{type(encoder).__name__}_0"
        self.add_module(self.encoder_name, encoder)
        self.ResNetBEVBackbone_0 = _backbone_from_args(
            a, encoder.out_channels, norm)
        width = self.ResNetBEVBackbone_0.out_channels
        shrink = _shrink_from_args(a, width)
        if shrink is not None:
            self.DownsampleConv_0 = shrink
            width = a["shrink_header"]["dim"][-1]
        return width

    @property
    def encoder(self) -> nn.Module:
        return getattr(self, self.encoder_name)

    def _heads(self, cin: int) -> DetectionHeads:
        a = self.args
        return DetectionHeads(
            cin, anchor_number=a["anchor_number"], use_dir="dir_args" in a,
            num_bins=a.get("dir_args", {}).get("num_bins", 2),
            use_iou=a.get("use_iou", False))

    def shrink(self, feat: torch.Tensor) -> torch.Tensor:
        shrink = getattr(self, "DownsampleConv_0", None)
        return feat if shrink is None else shrink(feat)

    def features(self, points: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        """(N, P, 4) points -> the (N, C, H, W) NCHW map the heads (or
        the fusion) read."""
        bev = self.encoder(points, mask)
        return self.bev_features(bev.permute(0, 3, 1, 2))

    def bev_features(self, bev: torch.Tensor) -> torch.Tensor:
        """The encoder's NCHW BEV -> backbone -> shrink."""
        return self.shrink(self.ResNetBEVBackbone_0(bev))


class IntermediateChain(DetectorChain):
    """``DetectorChain`` over every agent slot of a (B, L) intermediate
    batch, a fusion of the zoo (models/fuse) under flax's auto-name, and
    heads shared with the agents for Where2comm. Built for the agent
    axis ``max_cav``, which sizes CoBEVT's bias table."""

    needs_max_cav = True
    batch_keys = ("points", "point_mask", "agent_mask", "pairwise_affine")

    def _build_fusion(self, method: str, fusion_args: dict, width: int,
                      max_cav: int | None) -> int:
        """Register the fusion; -> the fused map's width."""
        self.method = method
        fusion = build_fusion(method, fusion_args, width, max_cav)
        self.fusion_name = f"{type(fusion).__name__}_0"
        self.add_module(self.fusion_name, fusion)
        return out_width(fusion, width)

    @property
    def fusion(self) -> nn.Module:
        return getattr(self, self.fusion_name)

    def agent_bev(self, batch: dict):
        """-> the encoder's (B*L, C, H, W) NCHW BEV of every agent slot,
        B, L."""
        points, pmask = batch["points"], batch["point_mask"]
        b, l = points.shape[:2]
        bev = self.encoder(points.reshape((b * l,) + points.shape[2:]),
                           pmask.reshape((b * l,) + pmask.shape[2:]))
        return bev.permute(0, 3, 1, 2), b, l

    def agent_features(self, batch: dict):
        """-> the (B*L, C, H, W) maps of every agent slot, B, L: encoder,
        backbone and shrink under the span ``encoder.lidar``."""
        with trace.span("encoder.lidar"):
            bev, b, l = self.agent_bev(batch)
            return self.bev_features(bev), b, l

    def fused_heads(self, feat: torch.Tensor, b: int, l: int, batch: dict,
                    heads: nn.Module) -> dict:
        """The agents' (B*L, C, H, W) maps fused, then ``heads``. For
        Where2comm the shared heads also run on every agent: their
        confidence gates what is sent (``comm_rate``), and with
        ``supervise_single`` they are the ``_single`` outputs."""
        nhwc = feat.permute(0, 2, 3, 1)
        nhwc = nhwc.reshape((b, l) + nhwc.shape[1:])
        extra = {}
        if self.method == "where2comm":
            # the shared heads on every agent: the reference's psm, whose
            # confidence gates the transmissions
            single = heads(feat)
            conf = torch.sigmoid(single["cls_preds"]).amax(-1, keepdim=True)
            if self.args.get("supervise_single", False):
                extra = {f"{k}_single": v for k, v in single.items()}
            fused, extra["comm_rate"] = self.fusion(
                nhwc, batch["pairwise_affine"], batch["agent_mask"],
                confidence=conf.reshape((b, l) + conf.shape[1:]))
        else:
            fused = self.fusion(nhwc, batch["pairwise_affine"],
                                batch["agent_mask"])
        out = heads(fused.permute(0, 3, 1, 2))
        out["spatial_features_2d"] = fused
        out.update(extra)
        return out


@register_model("point_pillar")
class PointPillar(DetectorChain):
    """args: voxel_size, lidar_range, pillar_vfe, base_bev_backbone,
    (shrink_header), anchor_number, (dir_args). Batch: points (B, N, 4),
    point_mask (B, N)."""

    def __init__(self, args: dict):
        super().__init__()
        width = self._build_chain(args, pillar_encoder(args))
        self.DetectionHeads_0 = self._heads(width)

    def forward(self, batch: dict) -> dict:
        feat = self.features(batch["points"], batch["point_mask"])
        out = self.DetectionHeads_0(feat)
        out["spatial_features_2d"] = feat.permute(0, 2, 3, 1)
        return out


@register_model("point_pillar_uncertainty")
class PointPillarUncertainty(DetectorChain):
    """``PointPillar`` + the aleatoric-uncertainty head ``unc_head`` (a
    biased 1x1 conv, 3 * anchor_number outputs): ``unc_preds`` (B, H, W,
    3A) NHWC, per anchor log-var x, log-var y, log-kappa yaw."""

    def __init__(self, args: dict):
        super().__init__()
        width = self._build_chain(args, pillar_encoder(args))
        self.DetectionHeads_0 = self._heads(width)
        self.unc_head = Conv(width, 3 * args["anchor_number"])

    def forward(self, batch: dict) -> dict:
        feat = self.features(batch["points"], batch["point_mask"])
        out = self.DetectionHeads_0(feat)
        out["unc_preds"] = self.unc_head(feat).permute(0, 2, 3, 1)
        out["spatial_features_2d"] = feat.permute(0, 2, 3, 1)
        return out


@register_model("point_pillar_baseline")
class PointPillarBaseline(IntermediateChain):
    """args: PointPillar's + fusion_method and its block (``in_channels``
    defaults to the block's ``feat_dim``, else 64). Batch: points
    (B, L, N, 4), point_mask (B, L, N), agent_mask (B, L),
    pairwise_affine (B, L, L, 2, 3)."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        width = self._build_chain(args, pillar_encoder(args))
        if "compression" in args:
            self.NaiveCompressor_0 = NaiveCompressor(
                width, args["compression"], norm=args.get("norm", "batch"))
        method = args["fusion_method"]
        fusion_args = dict(args.get(method, {}) or {})
        fusion_args.setdefault("in_channels",
                               fusion_args.get("feat_dim", 64))
        width = self._build_fusion(method, fusion_args, width, max_cav)
        self.DetectionHeads_0 = self._heads(width)

    def forward(self, batch: dict) -> dict:
        feat, b, l = self.agent_features(batch)
        compressor = getattr(self, "NaiveCompressor_0", None)
        if compressor is not None:
            feat = compressor(feat)
        return self.fused_heads(feat, b, l, batch, self.DetectionHeads_0)


@register_model("point_pillar_baseline_multiscale")
class PointPillarBaselineMultiscale(IntermediateChain):
    """Fusion at every backbone level: the levels are computed on the
    unfused agents' maps, each fused (all agents warped to the ego) by its
    own fusion, then deblock-decoded, shrunk and fed to the heads, in
    JAX's order. args: ``PointPillarBaseline``'s; each level's fusion
    takes the config's block with ``in_channels`` the level's width
    (``base_bev_backbone.num_filters[i]``)."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        width = self._build_chain(args, pillar_encoder(args))
        if "compression" in args:
            self.NaiveCompressor_0 = NaiveCompressor(
                self.encoder.out_channels, args["compression"],
                norm=args.get("norm", "batch"))
        method = args["fusion_method"]
        self.fusion_names = []
        for c in args["base_bev_backbone"]["num_filters"]:
            fusion = build_fusion(
                method, dict(args.get(method, {}) or {}, in_channels=c), c,
                max_cav)
            name = f"{type(fusion).__name__}_{len(self.fusion_names)}"
            self.add_module(name, fusion)
            self.fusion_names.append(name)
        self.DetectionHeads_0 = self._heads(width)

    def forward(self, batch: dict) -> dict:
        x, b, l = self.agent_bev(batch)
        compressor = getattr(self, "NaiveCompressor_0", None)
        if compressor is not None:
            x = compressor(x)
        backbone = self.ResNetBEVBackbone_0
        fused_levels = []
        for name, f in zip(self.fusion_names, backbone.encode(x)):
            nhwc = f.permute(0, 2, 3, 1)
            fused = getattr(self, name)(
                nhwc.reshape((b, l) + nhwc.shape[1:]),
                batch["pairwise_affine"], batch["agent_mask"])
            fused_levels.append(fused.permute(0, 3, 1, 2))
        fused = self.shrink(backbone.decode(fused_levels))
        out = self.DetectionHeads_0(fused)
        out["spatial_features_2d"] = fused.permute(0, 2, 3, 1)
        return out


@register_model("point_pillar_disconet")
class PointPillarDiscoNet(nn.Module):
    """The DiscoNet student: ``PointPillarBaseline`` with DiscoNet's
    fusion, under ``student``; ``feature`` is its fused map, which the
    KD loss pulls toward the teacher's."""

    needs_max_cav = True
    batch_keys = IntermediateChain.batch_keys

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        self.student = PointPillarBaseline(
            {**args, "fusion_method": "disconet"}, max_cav)

    def forward(self, batch: dict) -> dict:
        out = self.student(batch)
        out["feature"] = out["spatial_features_2d"]
        return out


@register_model("point_pillar_disconet_teacher")
class PointPillarDiscoNetTeacher(nn.Module):
    """The DiscoNet teacher: ``PointPillar`` under ``teacher``, on the
    early-fused view (every agent's points in the ego frame, merged);
    ``teacher_feature`` is its map."""

    batch_keys = DetectorChain.batch_keys

    def __init__(self, args: dict):
        super().__init__()
        self.teacher = PointPillar(args)

    def forward(self, batch: dict) -> dict:
        out = self.teacher(batch)
        out["teacher_feature"] = out["spatial_features_2d"]
        return out
