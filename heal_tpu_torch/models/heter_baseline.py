"""Heterogeneous baseline models (torch): any fusion of the zoo.

Counterpart of heal_tpu/models/heter_baseline.py (ref models/
heter_model_baseline.py, heter_model_baseline_ms.py), on the
``ModalityBranch`` and slot packing of heter_pyramid.py:

  * ``HeterModelBaseline``: per-type branches in ``lidar_first`` order
    (a camera BEV is center-cropped or zero-padded to the lidar canvas
    before it, else to the lidar range at its own stride) -> slot
    scatter into (B, L) -> the shrink header PER AGENT ->
    the shared heads on every agent (the ``_single`` outputs, and
    Where2comm's transmission confidence) -> the fusion method -> the
    heads;
  * ``HeterModelBaselineMS``: fuses at every level of ``fusion_backbone``:
    level 0 the raw assembled features, level i >= 1 the output of the
    backbone's stage i, so the backbone has no ``stages_0`` (flax creates
    no parameters for a stage that is never called) -> deblock decode ->
    shrink -> heads.

  * ``HeterModelLate`` (heter_model_late.py): late fusion's per-agent
    detector. Each sample is one agent; every type's branch runs on
    every sample (the types it is not get zero inputs) and its features
    are multiplied by that type's column of ``modality_flags``, then
    summed, shrunk and read by the shared heads.

With no lidar type (the published ``opv2v/camera_only/*.yaml``: a
128x128 camera BEV against a 128x256 label grid) heal_tpu's baselines
leave the camera BEV uncropped, and their heads and loss disagree with
the labels' shape; the port pads it, as the reference (its crop
ratios), the collab, single and late models do. Where the camera grid
covers the lidar range the two packages agree.

Outputs are NHWC, as in JAX: cls / reg / dir preds, their ``_single``
twins, each camera type's ``depth_items_mX``, and for Where2comm
``comm_rate``. The first two models are built for the agent axis
``max_cav`` (the config's ``train_params.max_cav``), which sizes
CoBEVT's bias table.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .fuse.fusion_in_one import build_fusion
from .heads import DetectionHeads
from .heter_pyramid import (ModalityBranch, agent_branch, camera_canvas,
                            center_crop_or_pad, is_camera, lidar_first,
                            modality_list)
from .point_pillar import _shrink_from_args, out_width
from .registry import register_model
from .resnet_bev import ResNetBEVBackbone


def _heads(a: dict, cin: int, use_iou: bool = False) -> DetectionHeads:
    return DetectionHeads(cin, anchor_number=a["anchor_number"],
                          use_dir="dir_args" in a,
                          num_bins=a.get("dir_args", {}).get("num_bins", 2),
                          use_iou=use_iou)


class _Baseline(nn.Module):
    """The branches and the slot scatter both baselines share; under a
    device mesh (``mesh``) the branches split the agent axis
    (heter_pyramid.agent_branch)."""

    needs_max_cav = True
    mesh = None

    def _branches(self, a: dict, norm: str):
        self.modalities = modality_list(a)
        self.args = a
        for m in self.modalities:
            self.add_module(f"branch_{m}", ModalityBranch(a[m], norm=norm))
        return getattr(self, f"branch_{self.modalities[0]}").out_channels

    def assemble(self, batch: dict, out_aux: dict) -> torch.Tensor:
        """-> the (B, L, H, W, C) NHWC features of every agent slot."""
        agent_mask = batch["agent_mask"]
        b, l = agent_mask.shape
        feat_all = None
        for m in lidar_first(self.modalities, self.args):
            if f"inputs_{m}" not in batch:
                continue
            feat, depth, lm = agent_branch(self, m, batch[f"inputs_{m}"], b)
            feat = feat.permute(0, 2, 3, 1)  # NHWC view
            if depth is not None:
                out_aux[f"depth_items_{m}"] = depth
            if is_camera(self.args[m]):
                # to the lidar canvas, else to the lidar range at the
                # camera's stride (the reference's crop ratios)
                feat = center_crop_or_pad(feat, *(
                    feat_all.shape[1:3] if feat_all is not None else
                    camera_canvas(self.args[m], self.args["lidar_range"],
                                  *feat.shape[1:3])))
            feat = feat.reshape((b, lm) + feat.shape[1:])
            if feat_all is None:
                feat_all = feat.new_zeros((b * (l + 1),) + feat.shape[2:])
            slots = batch[f"slots_{m}"].long()
            rows = (slots + torch.arange(b, device=slots.device)[:, None]
                    * (l + 1)).reshape(-1)
            feat_all.index_add_(0, rows, feat.reshape((b * lm,)
                                                      + feat.shape[2:]))
        if feat_all is None:
            raise ValueError("no modality inputs in batch")
        return feat_all.reshape((b, l + 1) + feat_all.shape[1:])[:, :l]

    def _fuse(self, fusion, x, batch):
        """One fusion call: V2X-ViT conditions on each agent's type."""
        extra = ({"agent_types": batch["agent_modality"]}
                 if self.args["fusion_method"] == "v2xvit" else {})
        return fusion(x, batch["pairwise_affine"], batch["agent_mask"],
                      **extra)


@register_model("heter_model_baseline")
class HeterModelBaseline(_Baseline):
    """args: m1..m4 blocks + fusion_method (+ the method's block) +
    shrink_header + in_head + anchor_number + dir_args."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        a = args
        norm = a.get("norm", "batch")
        width = self._branches(a, norm)
        method = a["fusion_method"]
        fusion_args = dict(a.get(method, {}) or {})
        fusion_args.setdefault("in_channels", a.get("in_head", 64))
        self.shrink = _shrink_from_args(a, width)
        if self.shrink is not None:
            width = a["shrink_header"]["dim"][-1]
        self.fusion = build_fusion(method, fusion_args, width, max_cav)
        self.heads = _heads(a, out_width(self.fusion, width),
                            a.get("use_iou", False))

    def forward(self, batch: dict) -> dict:
        a = self.args
        b, l = batch["agent_mask"].shape
        out_aux: dict = {}
        feat_all = self.assemble(batch, out_aux)
        if self.shrink is not None:
            flat = feat_all.reshape((b * l,) + feat_all.shape[2:])
            flat = self.shrink(flat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            feat_all = flat.reshape((b, l) + flat.shape[1:])
        # per-agent predictions of the SHARED heads: the supervise_single
        # outputs and where2comm's transmission confidence
        need_single = a.get("supervise_single", False)
        is_w2c = a["fusion_method"] == "where2comm"
        confidence = None
        if need_single or is_w2c:
            flat = feat_all.reshape((b * l,) + feat_all.shape[2:])
            single = self.heads(flat.permute(0, 3, 1, 2))
            if need_single:
                for k, v in single.items():
                    out_aux[f"{k}_single"] = v
            if is_w2c:
                conf = torch.sigmoid(single["cls_preds"]).amax(-1,
                                                              keepdim=True)
                confidence = conf.reshape((b, l) + conf.shape[1:])
        if is_w2c:
            fused, out_aux["comm_rate"] = self.fusion(
                feat_all, batch["pairwise_affine"], batch["agent_mask"],
                confidence=confidence)
        else:
            fused = self._fuse(self.fusion, feat_all, batch)
        out = self.heads(fused.permute(0, 3, 1, 2))
        out.update(out_aux)
        return out


@register_model("heter_model_baseline_ms")
class HeterModelBaselineMS(_Baseline):
    """args: m1..m4 blocks + fusion_backbone + fusion_method (+ block) +
    shrink_header + anchor_number + dir_args (+ supervise_single)."""

    def __init__(self, args: dict, max_cav: int | None = None):
        super().__init__()
        a = args
        norm = a.get("norm", "batch")
        width = self._branches(a, norm)
        fb = a["fusion_backbone"]
        if width != fb["num_filters"][0]:
            raise ValueError(f"level 0 fuses the {width}-channel branch "
                             f"features; fusion_backbone.num_filters[0] is "
                             f"{fb['num_filters'][0]}")
        self.fusion_backbone = ResNetBEVBackbone(
            width,
            layer_nums=tuple(fb["layer_nums"]),
            layer_strides=tuple(fb["layer_strides"]),
            num_filters=tuple(fb["num_filters"]),
            upsample_strides=tuple(fb.get("upsample_strides", ())),
            num_upsample_filter=tuple(fb.get("num_upsample_filter", ())),
            norm=norm,
        )
        # level 0 fuses the assembled features: stage 0 never runs
        del self.fusion_backbone.stages_0
        method = a["fusion_method"]
        self.num_levels = len(fb["layer_nums"])
        for i in range(self.num_levels):
            self.add_module(f"fusions_{i}", build_fusion(
                method, dict(a.get(method, {}) or {},
                             in_channels=fb["num_filters"][i]),
                fb["num_filters"][i], max_cav))
        cin = self.fusion_backbone.out_channels
        self.shrink = _shrink_from_args(a, cin)
        if self.shrink is not None:
            cin = a["shrink_header"]["dim"][-1]
        self.heads = _heads(a, cin)
        self.heads_single = (_heads(a, width)
                             if a.get("supervise_single", False) else None)

    def forward(self, batch: dict) -> dict:
        b, l = batch["agent_mask"].shape
        out_aux: dict = {}
        feat_all = self.assemble(batch, out_aux)
        x = feat_all.reshape((b * l,) + feat_all.shape[2:]).permute(
            0, 3, 1, 2)  # NCHW
        if self.heads_single is not None:
            for k, v in self.heads_single(x).items():
                out_aux[f"{k}_single"] = v
        fused_levels = []
        for i in range(self.num_levels):
            if i > 0:
                x = getattr(self.fusion_backbone, f"stages_{i}")(x)
            xl = x.permute(0, 2, 3, 1)
            xl = xl.reshape((b, l) + xl.shape[1:])
            fused = self._fuse(getattr(self, f"fusions_{i}"), xl, batch)
            fused_levels.append(fused.permute(0, 3, 1, 2))
        fused = self.fusion_backbone.decode(fused_levels)
        if self.shrink is not None:
            fused = self.shrink(fused)
        out = self.heads(fused)
        out.update(out_aux)
        return out


@register_model("heter_model_late")
class HeterModelLate(nn.Module):
    """args: m1..m4 blocks + shrink_header + anchor_number + dir_args.
    Batch: ``inputs_mX`` with a leading sample axis (lidar points (B, P,
    4); camera images (B, ncam, ...)) and ``modality_flags`` (B, M), one
    column per type in ``modality_list`` order.

    JAX's default norm is group norm (every branch sees the zero inputs
    of the other types' samples, which train-mode batch norm would fold
    into its statistics): per sample, so the PointPillars branches take
    the encoder's general path (no kernel 1). Every published config
    sets ``norm: batch``. ``use_iou`` adds the heads' IoU branch.

    A camera BEV is center-cropped or zero-padded to the lidar branch's
    canvas, and with no lidar type (``single/m2_pretrain.yaml``) to the
    lidar range at its own stride, as the collab and single pyramid
    models do. heal_tpu's late model leaves it uncropped then, so where
    the camera grid does not cover the lidar range (that config: 128x128
    cells against a 128x256 label grid) JAX's loss fails on the shapes;
    where it does, the two agree."""

    batch_keys = ("modality_flags",)

    def __init__(self, args: dict):
        super().__init__()
        a = args
        norm = a.get("norm", "group")
        self.args = a
        self.modalities = modality_list(a)
        for m in self.modalities:
            self.add_module(f"branch_{m}", ModalityBranch(a[m], norm=norm))
        width = getattr(self, f"branch_{self.modalities[0]}").out_channels
        self.shrink = _shrink_from_args(a, width)
        if self.shrink is not None:
            width = a["shrink_header"]["dim"][-1]
        self.heads = _heads(a, width, a.get("use_iou", False))

    def forward(self, batch: dict) -> dict:
        a = self.args
        flags = batch.get("modality_flags")
        feat_sum, target_hw, out_aux = None, None, {}
        for m in lidar_first(self.modalities, a):
            if f"inputs_{m}" not in batch:
                continue
            feat, depth = getattr(self, f"branch_{m}")(batch[f"inputs_{m}"])
            feat = feat.permute(0, 2, 3, 1)  # NHWC view
            if not is_camera(a[m]):
                target_hw = feat.shape[1:3]
            else:
                feat = center_crop_or_pad(feat, *(
                    target_hw if target_hw is not None else camera_canvas(
                        a[m], a["lidar_range"], *feat.shape[1:3])))
            if flags is not None:
                # zero the samples that are not this type: their padded
                # zero inputs still give the norms' bias activations
                k = self.modalities.index(m)
                feat = feat * flags[:, k].to(feat.dtype)[:, None, None, None]
            feat_sum = feat if feat_sum is None else feat_sum + feat
            if depth is not None:
                out_aux[f"depth_items_{m}"] = depth
        if feat_sum is None:
            raise ValueError("no modality inputs in batch")
        feat = feat_sum.permute(0, 3, 1, 2)
        if self.shrink is not None:
            feat = self.shrink(feat)
        out = self.heads(feat)
        out.update(out_aux)
        return out
