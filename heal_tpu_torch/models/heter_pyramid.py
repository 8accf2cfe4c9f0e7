"""HEAL heterogeneous pyramid models (torch), train and eval.

Counterparts of heal_tpu/models/heter_pyramid.py for lidar agents with
the PointPillars encoder (m1, and the 16-line m4) or the SECOND sparse
conv encoder (m3), and camera agents with the Lift-Splat-Shoot encoder
(m2):

  * ``HeterPyramidCollab`` (stages 1 and 3): per-modality encoder -> BEV
    backbone -> aligner -> slot scatter into the (B, L) agent axis ->
    Pyramid Fusion -> shrink conv -> cls/reg/dir heads;
  * ``HeterPyramidSingle`` (stage 2): one new agent type's branch in
    front of the base's pyramid (``forward_single``, no fusion), shrink
    and heads, which stay frozen (``fix_modules``).

Batching is the JAX package's: ``inputs_mX`` arrays hold a fixed
per-modality agent capacity and ``slots_mX`` maps each packed agent to its
global slot in (B, L+1), where slot L is a dump slot for padding.
Agent types run in ``modality_list`` order (m1, m2, m3, m4), as in JAX:
a camera branch is center-cropped or zero-padded to the canvas of the
lidar branch before it, else to the lidar range at its own stride; in
eval mode its pyramid scores are masked to the camera's field of view
(``crop_mask_list``); its depth logits come out as ``depth_items_mX``.
Train mode follows ``module.train()``: batch-statistics BN everywhere in
the collab model (nothing is frozen, as in JAX without a compressor); in
the single model the frozen pyramid and shrink stay in eval mode.

With a ``compressor`` (``naive``: ``NaiveCompressor``, ``autoencoder``:
``AutoEncoder``; HEAL's bandwidth finetune of a collab base) the
scattered agent features pass through it before the pyramid, and every
other module is in ``fix_modules``: the trainer
(parallel/trainer.py) trains the compressor alone and runs the frozen
modules in eval mode (``freezing.frozen_eval``), as JAX passes
``train=False`` to them. ``use_iou`` adds the heads' IoU branch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import trace
from .aligner import AlignNet
from .encoders import PointPillarEncoder
from .fuse.pyramid import PyramidFusion
from .heads import DetectionHeads
from .layers import AutoEncoder, NaiveCompressor
from .lift_splat_shoot import LiftSplatShootEncoder
from .point_pillar import _shrink_from_args
from .registry import register_model
from .resnet_bev import ResNetBEVBackbone
from .second import SecondEncoder

MODALITY_KEYS = ("m1", "m2", "m3", "m4")


def modality_list(args: dict):
    return [m for m in MODALITY_KEYS if m in args]


def is_camera(cfg: dict) -> bool:
    return cfg.get("sensor_type", "lidar") == "camera"


def lidar_first(modalities, args: dict):
    """Lidar agent types before camera ones (heal_tpu heter_pyramid.py
    :46-54): the lidar grid sets the canvas a camera BEV is cropped or
    padded to."""
    return sorted(modalities, key=lambda m: is_camera(args[m]))


def center_crop_or_pad(feat: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """Center crop / zero-pad (N, H, W, C) to (N, th, tw, C): the
    reference's torchvision CenterCrop of camera BEV features, which pads
    when the camera grid is smaller than the lidar range."""
    h, w = feat.shape[1:3]
    if h > th:
        feat = feat[:, (h - th) // 2:(h - th) // 2 + th]
    elif h < th:
        pad = th - h
        feat = F.pad(feat, (0, 0, 0, 0, pad // 2, pad - pad // 2))
    if w > tw:
        feat = feat[:, :, (w - tw) // 2:(w - tw) // 2 + tw]
    elif w < tw:
        pad = tw - w
        feat = F.pad(feat, (0, 0, pad // 2, pad - pad // 2))
    return feat


def camera_fov_mask(h: int, w: int, crop_ratio_h: float,
                    crop_ratio_w: float) -> torch.Tensor:
    """(h, w, 1) f32 mask: 1 inside the camera-covered central region, 0
    in the zero-padded border less a 4-pixel guard band (the reference's
    eval-time crop mask)."""
    vis_h = min(h, int(h / crop_ratio_h) - 4)
    vis_w = min(w, int(w / crop_ratio_w) - 4)
    mask = torch.zeros((h, w, 1))
    y0, x0 = (h - vis_h) // 2, (w - vis_w) // 2
    mask[y0:y0 + vis_h, x0:x0 + vis_w] = 1.0
    return mask


def camera_crop(cfg: dict, lidar_range) -> tuple[float, float]:
    """(crop ratio h, w) of a camera agent type: the lidar range's half
    extents over its grid's."""
    gc = cfg["encoder_args"]["grid_conf"]
    return lidar_range[4] / gc["ybound"][1], lidar_range[3] / gc["xbound"][1]


def camera_canvas(cfg: dict, lidar_range, h: int, w: int) -> tuple[int, int]:
    """The lidar range's canvas at a camera grid's stride, for a camera
    BEV of (h, w) cells."""
    gc = cfg["encoder_args"]["grid_conf"]
    scale_h = (lidar_range[4] - lidar_range[1]) / (
        gc["ybound"][1] - gc["ybound"][0])
    scale_w = (lidar_range[3] - lidar_range[0]) / (
        gc["xbound"][1] - gc["xbound"][0])
    return int(round(h * scale_h)), int(round(w * scale_w))


def _flatten_agents(inputs: dict, b: int, lm: int) -> dict:
    return {k: v.reshape((b * lm,) + v.shape[2:]) for k, v in inputs.items()}


def agent_branch(model: nn.Module, m: str, inputs: dict, b: int):
    """``model``'s branch of type ``m`` over the packed (B, L_m, ...)
    arrays of ``inputs`` -> ((B*L_m, C, h, w) NCHW features, the camera's
    depth logits or None, L_m). Under a device mesh (``model.mesh``) whose
    agent axis divides L_m (``_fit``'s rule), this rank runs its L_m/A
    agents and the features and depth logits are gathered over the agent
    group: the V2X round of heal_tpu/parallel/sharding.py. Otherwise every
    rank runs all the agents."""
    lm = inputs[sorted(inputs)[0]].shape[1]
    mesh = model.mesh
    split = mesh is not None and mesh.splits("agent", lm)
    if split:
        inputs = {k: mesh.take(v, 1, "agent") for k, v in inputs.items()}
    lm_here = lm // mesh.shape["agent"] if split else lm
    feat, depth = getattr(model, f"branch_{m}")(
        _flatten_agents(inputs, b, lm_here))
    if split:
        feat = mesh.gather(feat.unflatten(0, (b, lm_here)), 1,
                           "agent").flatten(0, 1)
        if depth is not None:  # (B*L_m*cams, fH, fW, D)
            depth = mesh.gather(depth.unflatten(0, (b, lm_here, -1)), 1,
                                "agent").flatten(0, 2)
    return feat, depth, lm


class ModalityBranch(nn.Module):
    """encoder -> backbone -> aligner for one agent type ``key`` (m1..m4);
    the encoder runs in the tracer's span ``encoder.<key>``."""

    def __init__(self, cfg: dict, key: str, norm: str = "batch"):
        super().__init__()
        self.span_name = f"encoder.{key}"
        enc = cfg["encoder_args"]
        self.camera = is_camera(cfg)
        if self.camera:
            self.encoder = LiftSplatShootEncoder(enc, norm=norm)
        elif cfg["core_method"] == "second":
            sec = enc.get("second", {})
            kw = {k: tuple(sec[k]) for k in ("channels", "max_voxels")
                  if k in sec}
            self.encoder = SecondEncoder(
                voxel_size=tuple(enc["voxel_size"]),
                lidar_range=tuple(enc["lidar_range"]),
                norm=norm,
                presorted=enc.get("presorted", False),
                dense_tail=sec.get("dense_tail", False),
                **kw,
            )
        elif cfg["core_method"] != "point_pillar":
            raise KeyError(f"unknown lidar encoder {cfg['core_method']!r}")
        else:
            self.encoder = PointPillarEncoder(
                voxel_size=tuple(enc["voxel_size"]),
                lidar_range=tuple(enc["lidar_range"]),
                num_filters=tuple(enc["pillar_vfe"]["num_filters"]),
                use_absolute_xyz=enc["pillar_vfe"].get("use_absolute_xyz",
                                                       True),
                with_distance=enc["pillar_vfe"].get("with_distance", False),
                norm=norm,
                presorted=enc.get("presorted", False),
            )
        bb = cfg["backbone_args"]
        self.backbone = ResNetBEVBackbone(
            self.encoder.out_channels,
            layer_nums=tuple(bb["layer_nums"]),
            layer_strides=tuple(bb["layer_strides"]),
            num_filters=tuple(bb["num_filters"]),
            upsample_strides=tuple(bb.get("upsample_strides", ())),
            num_upsample_filter=tuple(bb.get("num_upsample_filter", ())),
            norm=norm,
        )
        # JAX sizes the aligner by the backbone's last num_filters
        dim = bb["num_filters"][-1]
        align = cfg.get("aligner_args")
        if ((align or {}).get("core_method", "identity") != "identity"
                and dim != self.backbone.out_channels):
            raise ValueError(
                f"aligner width {dim} != backbone output "
                f"{self.backbone.out_channels} channels"
            )
        self.aligner = AlignNet(align, dim=dim, norm=norm)
        self.out_channels = self.backbone.out_channels

    def forward(self, inputs: dict):
        """inputs: the modality's packed arrays with a flat agent axis
        (lidar: points (N, P, 4), point_mask (N, P); camera: see
        LiftSplatShootEncoder). Returns the (N, C, h, w) aligned BEV
        features (NCHW) and the camera's depth logits (None for lidar)."""
        depth = None
        with trace.span(self.span_name):
            if self.camera:
                feat, depth = self.encoder(inputs)
            else:
                feat = self.encoder(inputs["points"], inputs["point_mask"])
        feat = self.backbone(feat.permute(0, 3, 1, 2))
        return self.aligner(feat), depth


@register_model("heter_pyramid_collab")
class HeterPyramidCollab(nn.Module):
    """args: per-modality blocks (m1..m4) + fusion_backbone + shrink_header
    + anchor_number + dir_args (+ compressor). Under a device mesh
    (``mesh``) the branches split the agent axis (:func:`agent_branch`)."""

    mesh = None

    def __init__(self, args: dict):
        super().__init__()
        a = args
        norm = a.get("norm", "batch")
        self.modalities = modality_list(a)
        self.lidar_range = a["lidar_range"]
        self.cameras = {m: a[m] for m in self.modalities if is_camera(a[m])}
        self.level_strides = [int(s) for s in np.cumprod(
            a["fusion_backbone"]["layer_strides"])]
        for m in self.modalities:
            self.add_module(f"branch_{m}", ModalityBranch(a[m], m, norm=norm))
        width = getattr(self, f"branch_{self.modalities[0]}").out_channels
        self.pyramid_backbone = PyramidFusion(
            a["fusion_backbone"], width, norm=norm
        )
        self.shrink = _shrink_from_args(a, self.pyramid_backbone.out_channels)
        head_in = (a["shrink_header"]["dim"][-1] if self.shrink is not None
                   else self.pyramid_backbone.out_channels)
        self.heads = DetectionHeads(
            head_in,
            anchor_number=a["anchor_number"],
            use_dir="dir_args" in a,
            num_bins=a.get("dir_args", {}).get("num_bins", 2),
            use_iou=a.get("use_iou", False),
        )
        self.compressor = None
        if "compressor" in a:
            comp = a["compressor"]
            if comp.get("core_method", "naive") == "autoencoder":
                self.compressor = AutoEncoder(
                    comp["input_dim"], comp.get("layer_num", 1), norm=norm)
            else:
                self.compressor = NaiveCompressor(
                    comp["input_dim"], comp["compress_ratio"], norm=norm)
        self.fix_modules = () if self.compressor is None else tuple(
            f"branch_{m}" for m in self.modalities) + (
                "pyramid_backbone", "shrink", "heads")

    def forward(self, batch: dict) -> dict:
        """batch (tensors): inputs_mX (packed (B, L_m, ...) arrays),
        slots_mX (B, L_m) int, agent_mask (B, L) bool, pairwise_affine
        (B, L, L, 2, 3). Returns the NHWC head outputs, ``pyramid`` =
        "collab", ``occ_single_list`` (per level, (B*L, h, w, 1)) and each
        camera type's ``depth_items_mX``."""
        agent_mask = batch["agent_mask"]
        b, l = agent_mask.shape
        feat_all = None
        out_aux, cam_ratios = {}, {}
        for m in self.modalities:
            if f"inputs_{m}" not in batch:
                continue
            # (B*L_m, C, h, w)
            feat, depth, lm = agent_branch(self, m, batch[f"inputs_{m}"], b)
            feat = feat.permute(0, 2, 3, 1)  # NHWC view
            if depth is not None:
                out_aux[f"depth_items_{m}"] = depth
            if m in self.cameras:
                # the camera BEV cropped / padded to the lidar canvas
                th, tw = (feat_all.shape[1:3] if feat_all is not None else
                          camera_canvas(self.cameras[m], self.lidar_range,
                                        *feat.shape[1:3]))
                feat = center_crop_or_pad(feat, th, tw)
                cam_ratios[m] = camera_crop(self.cameras[m], self.lidar_range)
            feat = feat.reshape((b, lm) + feat.shape[1:])
            if feat_all is None:
                h, w, c = feat.shape[2:]
                feat_all = feat.new_zeros((b * (l + 1), h, w, c))
            # per-sample scatter-add into global agent slots
            slots = batch[f"slots_{m}"].long()
            rows = (slots + torch.arange(b, device=slots.device)[:, None]
                    * (l + 1)).reshape(-1)
            feat_all.index_add_(0, rows, feat.reshape((b * lm,)
                                                      + feat.shape[2:]))
        if feat_all is None:
            raise ValueError("no modality inputs in batch")
        feat_all = feat_all.reshape((b, l + 1) + feat_all.shape[1:])

        feat = feat_all[:, :l]
        if self.compressor is not None:
            flat = feat.reshape((b * l,) + feat.shape[2:]).permute(0, 3, 1, 2)
            feat = self.compressor(flat).permute(0, 2, 3, 1).reshape(
                feat.shape)

        crop_mask_list = None
        if not self.training and cam_ratios:
            crop_mask_list = self._crop_masks(batch, cam_ratios, feat_all)
        fused, occ_list = self.pyramid_backbone.forward_collab(
            feat, batch["pairwise_affine"], agent_mask,
            crop_mask_list=crop_mask_list,
        )
        fused = fused.permute(0, 3, 1, 2)
        if self.shrink is not None:
            fused = self.shrink(fused)
        out = self.heads(fused)
        out["pyramid"] = "collab"
        out["occ_single_list"] = occ_list
        out.update(out_aux)
        return out

    def _crop_masks(self, batch, cam_ratios, feat_all) -> list:
        """Eval-time per-level (B, L, h, w, 1) score masks: each camera
        agent's slots get its field-of-view mask, the rest ones. Each mask
        is built on the host and copied, pageable (``host_sync.h2d``)."""
        b, l1, h, w = feat_all.shape[:4]
        sample = torch.arange(b, device=feat_all.device)[:, None]
        masks = []
        for s in self.level_strides:
            hl, wl = h // s, w // s
            level = feat_all.new_ones((b, l1, hl, wl, 1))
            for m, (rh, rw) in cam_ratios.items():
                level[sample, batch[f"slots_{m}"].long()] = camera_fov_mask(
                    hl, wl, rh, rw).to(level)
                trace.count("host_sync.h2d")
            masks.append(level[:, :l1 - 1])
        return masks


@register_model("heter_pyramid_single")
class HeterPyramidSingle(nn.Module):
    """Stage-2 model of one new agent type (heal_tpu heter_pyramid.py
    :334-391): its branch, then the base's pyramid ``forward_single``,
    shrink and heads. Those three are ``fix_modules``: the trainer freezes
    them (parallel/freezing.py), and the pyramid and shrink run in eval
    mode whatever ``train()`` says, as JAX passes ``train=False`` to them
    (:383-385), so batch norm uses the stage-1 running statistics and
    never moves them. Gradients still flow through them into the branch.
    """

    fix_modules = ("pyramid_backbone", "shrink", "heads")

    def __init__(self, args: dict):
        super().__init__()
        a = args
        norm = a.get("norm", "batch")
        mods = modality_list(a)
        if len(mods) != 1:
            raise ValueError(
                f"heter_pyramid_single expects one modality, got {mods}")
        self.modality = mods[0]
        self.lidar_range = a["lidar_range"]
        self.camera_cfg = a[self.modality] if is_camera(a[self.modality]) \
            else None
        branch = ModalityBranch(a[self.modality], self.modality, norm=norm)
        self.add_module(f"branch_{self.modality}", branch)
        self.pyramid_backbone = PyramidFusion(
            a["fusion_backbone"], branch.out_channels, norm=norm
        )
        self.shrink = _shrink_from_args(a, self.pyramid_backbone.out_channels)
        head_in = (a["shrink_header"]["dim"][-1] if self.shrink is not None
                   else self.pyramid_backbone.out_channels)
        self.heads = DetectionHeads(
            head_in,
            anchor_number=a["anchor_number"],
            use_dir="dir_args" in a,
            num_bins=a.get("dir_args", {}).get("num_bins", 2),
            use_iou=a.get("use_iou", False),
        )

    def train(self, mode: bool = True):
        super().train(mode)
        self.pyramid_backbone.eval()
        if self.shrink is not None:
            self.shrink.eval()
        return self

    def forward(self, batch: dict) -> dict:
        """batch: ``inputs_mX`` with a (B, L_m) agent axis (flattened
        here, as JAX does when ``agent_mask`` is present) or a flat one.
        Returns the NHWC head outputs, ``pyramid`` = "single",
        ``occ_single_list`` and, for a camera type, ``depth_items_mX``.

        A camera BEV is center-cropped or zero-padded to the lidar range
        at its stride before the pyramid, as in the collab model and in
        the reference's single model. heal_tpu's single model omits this
        (ROADMAP §3, known faults in the reference), so where the camera
        grid does not cover the lidar range (the published
        ``stage2/m2_alignto_m1.yaml``: 128x128 cells against a 128x256
        label grid) JAX's loss fails on the shapes; where it does, the
        two agree."""
        inputs = batch[f"inputs_{self.modality}"]
        lead = inputs[sorted(inputs)[0]]  # JAX's first leaf
        if lead.dim() > 2 and "agent_mask" in batch:
            inputs = _flatten_agents(inputs, *lead.shape[:2])
        feat, depth = getattr(self, f"branch_{self.modality}")(inputs)
        feat = feat.permute(0, 2, 3, 1)
        if self.camera_cfg is not None:
            feat = center_crop_or_pad(feat, *camera_canvas(
                self.camera_cfg, self.lidar_range, *feat.shape[1:3]))
        fused, occ_list = self.pyramid_backbone.forward_single(feat)
        fused = fused.permute(0, 3, 1, 2)
        if self.shrink is not None:
            fused = self.shrink(fused)
        out = self.heads(fused)
        out["pyramid"] = "single"
        out["occ_single_list"] = occ_list
        if depth is not None:
            out[f"depth_items_{self.modality}"] = depth
        return out
