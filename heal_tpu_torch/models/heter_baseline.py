"""Heterogeneous baseline models (torch): any fusion of the zoo.

Counterpart of heal_tpu/models/heter_baseline.py (ref models/
heter_model_baseline.py, heter_model_baseline_ms.py), on the
``ModalityBranch`` and slot packing of heter_pyramid.py:

  * ``HeterModelBaseline``: per-type branches in ``lidar_first`` order
    (a camera BEV is cropped or padded only to a lidar canvas that already
    exists) -> slot scatter into (B, L) -> the shrink header PER AGENT ->
    the shared heads on every agent (the ``_single`` outputs, and
    Where2comm's transmission confidence) -> the fusion method -> the
    heads;
  * ``HeterModelBaselineMS``: fuses at every level of ``fusion_backbone``:
    level 0 the raw assembled features, level i >= 1 the output of the
    backbone's stage i, so the backbone has no ``stages_0`` (flax creates
    no parameters for a stage that is never called) -> deblock decode ->
    shrink -> heads.

Outputs are NHWC, as in JAX: cls / reg / dir preds, their ``_single``
twins, each camera type's ``depth_items_mX``, and for Where2comm
``comm_rate``. Both models are built for the agent axis ``max_cav`` (the
config's ``train_params.max_cav``), which sizes CoBEVT's bias table.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .fuse.fusion_in_one import build_fusion
from .heads import DetectionHeads
from .heter_pyramid import (ModalityBranch, _flatten_agents,
                            center_crop_or_pad, is_camera, lidar_first,
                            modality_list)
from .point_pillar import _shrink_from_args
from .registry import register_model
from .resnet_bev import ResNetBEVBackbone


def _heads(a: dict, cin: int) -> DetectionHeads:
    return DetectionHeads(cin, anchor_number=a["anchor_number"],
                          use_dir="dir_args" in a,
                          num_bins=a.get("dir_args", {}).get("num_bins", 2))


class _Baseline(nn.Module):
    """The branches and the slot scatter both baselines share."""

    needs_max_cav = True

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
            inputs = batch[f"inputs_{m}"]
            lm = inputs[sorted(inputs)[0]].shape[1]
            feat, depth = getattr(self, f"branch_{m}")(
                _flatten_agents(inputs, b, lm))
            feat = feat.permute(0, 2, 3, 1)  # NHWC view
            if depth is not None:
                out_aux[f"depth_items_{m}"] = depth
            if is_camera(self.args[m]) and feat_all is not None:
                feat = center_crop_or_pad(feat, *feat_all.shape[1:3])
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
        if a.get("use_iou"):
            raise NotImplementedError("use_iou is not ported yet")
        norm = a.get("norm", "batch")
        width = self._branches(a, norm)
        method = a["fusion_method"]
        fusion_args = dict(a.get(method, {}) or {})
        fusion_args.setdefault("in_channels", a.get("in_head", 64))
        self.shrink = _shrink_from_args(a, width)
        if self.shrink is not None:
            width = a["shrink_header"]["dim"][-1]
        self.fusion = build_fusion(method, fusion_args, width, max_cav)
        self.heads = _heads(a, _out_width(self.fusion, width))

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


def _out_width(fusion: nn.Module, width: int) -> int:
    """The fused map's width: the decode conv's for Who2com, else the
    input's."""
    decode = getattr(fusion, "decode_layer", None)
    return decode.bias.shape[0] if decode is not None else width


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
