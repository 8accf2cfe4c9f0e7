"""Reference-checkpoint transplant: opencood state_dict -> the port.

The port's copy of heal_tpu/utils/transplant.py: the numpy layout maps
that take the weights of HEAL's published PyTorch checkpoints (the
reference's ``HeterPyramidCollab`` and its SECOND encoder) into flax's
layouts, module by module, then through utils/bridge.py into the port's
state_dict. They are the only route from those checkpoints into the
port.

  * PillarVFE + PointPillarScatter (pillar_vfe.py:10-155,
    point_pillar_scatter.py:9-77) -> the PointPillarEncoder's fused
    parameters (``pfn_kernel`` is the PFN linear transposed; BN affine +
    running stats map 1:1).
  * ResNetBEVBackbone (base_bev_backbone_resnet.py:112-140, resblock.py)
    -> models/resnet_bev.ResNetBEVBackbone. torch conv OIHW -> flax HWIO;
    torch ConvTranspose2d IOHW -> flax HWIO with both spatial axes
    flipped (the bridge flips them back: the port's ConvTranspose2d holds
    the reference's weight as it is).
  * PyramidFusion (pyramid_fuse.py) -> models/fuse/pyramid.PyramidFusion.
    The reference's ResNeXt grouped 3x3 (groups=32) embeds EXACTLY into
    the port's dense 3x3 as a block-diagonal kernel (a grouped conv is a
    dense conv with zeros off the channel-group blocks).
  * DownsampleConv shrink header and the cls/reg/dir 1x1 heads.
  * The SECOND encoder (spconv VoxelBackBone8x) ->
    models/second.SecondRefEncoder.

:func:`transplant_heter_pyramid_collab` and
:func:`transplant_second_encoder` return the port state_dict, shape
checked as JAX's ``_merge`` checks it, which the port model loads
strictly. :func:`synthetic_reference` writes a seeded opencood-named
state_dict with the keys and shapes these functions read, for checks
while no published checkpoint is in the repository.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .bridge import from_flax, to_flax


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def conv_kernel(w) -> np.ndarray:
    """torch Conv2d weight (O, I, kh, kw) -> flax HWIO (kh, kw, I, O)."""
    return _np(w).transpose(2, 3, 1, 0)


def deconv_kernel(w) -> np.ndarray:
    """torch ConvTranspose2d weight (I, O, kh, kw) -> flax ConvTranspose
    kernel (kh, kw, I, O). lax.conv_transpose applies the kernel as a
    regular conv over the dilated input, so both spatial axes flip."""
    k = _np(w).transpose(2, 3, 0, 1)
    return k[::-1, ::-1].copy()


def grouped_to_dense(w, groups: int) -> np.ndarray:
    """torch grouped Conv2d weight (O, I/g, kh, kw) -> DENSE flax HWIO
    (kh, kw, I, O) with zeros off the channel-group diagonal blocks."""
    w = _np(w)
    o, ig, kh, kw = w.shape
    og = o // groups
    i = ig * groups
    dense = np.zeros((kh, kw, i, o), np.float32)
    for g in range(groups):
        blk = w[g * og : (g + 1) * og]  # (og, ig, kh, kw)
        dense[:, :, g * ig : (g + 1) * ig, g * og : (g + 1) * og] = (
            blk.transpose(2, 3, 1, 0)
        )
    return dense


def _bn(sd: dict, prefix: str):
    """-> (affine params, running stats) for one torch BatchNorm."""
    params = {"scale": _np(sd[f"{prefix}.weight"]),
              "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]),
             "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


# --------------------------------------------------------------- modules
def transplant_pillar_encoder(sd: dict, prefix: str = "encoder_m1"):
    """PillarVFE (single PFN layer) -> PointPillarEncoder fused params.

    pfn_kernel rows follow the decoration order shared with the
    reference: [raw xyz+intensity (4), cluster offsets (3), center
    offsets (3)] (pillar_vfe.py:123-141 vs encoders._decorate).
    """
    lin = _np(sd[f"{prefix}.pillar_vfe.pfn_layers.0.linear.weight"])  # (F, 10)
    bn_p, bn_s = _bn(sd, f"{prefix}.pillar_vfe.pfn_layers.0.norm")
    params = {
        "pfn_kernel": lin.T.copy(),
        "bn_scale": bn_p["scale"],
        "bn_bias": bn_p["bias"],
    }
    stats = {"bn_mean": bn_s["mean"], "bn_var": bn_s["var"]}
    return params, stats


def _conv_norm_act(sd, bn_key, kernel):
    params = {"kernel": kernel}
    bn_p, bn_s = _bn(sd, bn_key)
    params["Norm_0"] = bn_p
    return params, {"Norm_0": bn_s}


def transplant_resnet_bev(
    sd: dict,
    prefix: str,
    layer_nums,
    bottleneck: bool = False,
    groups: int = 32,
):
    """Reference ResNetBEVBackbone/PyramidFusion backbone ->
    models/resnet_bev.ResNetBEVBackbone params/batch_stats subtrees.

    ``bottleneck`` selects the ResNeXt Bottleneck layout of PyramidFusion
    (pyramid_fuse.py:72-79), whose grouped conv2 expands block-diagonally
    into our dense 3x3.
    """
    params: dict = {}
    stats: dict = {}
    block_name = "BottleneckX" if bottleneck else "BasicBlock"
    for si, blocks in enumerate(layer_nums):
        sp: dict = {}
        ss: dict = {}
        for bi in range(blocks):
            base = f"{prefix}.resnet.layer{si}.{bi}"
            bp: dict = {}
            bs: dict = {}
            convs = ("conv1", "conv2", "conv3") if bottleneck else (
                "conv1", "conv2")
            for ci, cname in enumerate(convs):
                w = sd[f"{base}.{cname}.weight"]
                if bottleneck and cname == "conv2":
                    k = grouped_to_dense(w, groups)
                else:
                    k = conv_kernel(w)
                p, s = _conv_norm_act(sd, f"{base}.bn{ci + 1}", k)
                bp[f"ConvNormAct_{ci}"] = p
                bs[f"ConvNormAct_{ci}"] = s
            if f"{base}.downsample.0.weight" in sd:
                di = len(convs)
                p, s = _conv_norm_act(
                    sd,
                    f"{base}.downsample.1",
                    conv_kernel(sd[f"{base}.downsample.0.weight"]),
                )
                bp[f"ConvNormAct_{di}"] = p
                bs[f"ConvNormAct_{di}"] = s
            sp[f"{block_name}_{bi}"] = bp
            ss[f"{block_name}_{bi}"] = bs
        params[f"stages_{si}"] = sp
        stats[f"stages_{si}"] = ss
    # deblocks (upsample >= 1 -> ConvTranspose; < 1 -> strided Conv)
    i = 0
    while f"{prefix}.deblocks.{i}.0.weight" in sd:
        w = _np(sd[f"{prefix}.deblocks.{i}.0.weight"])
        bn_p, bn_s = _bn(sd, f"{prefix}.deblocks.{i}.1")
        out_ch = bn_p["scale"].shape[0]
        if w.shape[1] == out_ch:  # (I, O, kh, kw) ConvTranspose
            dp = {"ConvTranspose_0": {"kernel": deconv_kernel(w)},
                  "Norm_0": bn_p}
        else:  # stride < 1 downsample conv (O, I, kh, kw)
            dp = {"Conv_0": {"kernel": conv_kernel(w)}, "Norm_0": bn_p}
        params[f"deblocks_{i}"] = dp
        stats[f"deblocks_{i}"] = {"Norm_0": bn_s}
        i += 1
    return params, stats


def transplant_pyramid(sd: dict, args: dict, prefix: str = "pyramid_backbone"):
    """PyramidFusion = resnext backbone + per-level 1x1 single heads."""
    params, stats = transplant_resnet_bev(
        sd,
        prefix,
        args["layer_nums"],
        bottleneck=args.get("resnext", False),
        groups=32,
    )
    out_p = {"backbone": params}
    out_s = {"backbone": stats}
    for i in range(len(args["layer_nums"])):
        out_p[f"single_head_{i}"] = {
            "kernel": conv_kernel(sd[f"{prefix}.single_head_{i}.weight"]),
            "bias": _np(sd[f"{prefix}.single_head_{i}.bias"]),
        }
    return out_p, out_s


def transplant_shrink(sd: dict, prefix: str = "shrink_conv"):
    """Reference DownsampleConv (DoubleConv stages) -> layers.DownsampleConv."""
    params: dict = {}
    i = 0
    while f"{prefix}.layers.{i}.double_conv.0.weight" in sd:
        params[f"conv_{i}a"] = {
            "kernel": conv_kernel(sd[f"{prefix}.layers.{i}.double_conv.0.weight"]),
            "bias": _np(sd[f"{prefix}.layers.{i}.double_conv.0.bias"]),
        }
        params[f"conv_{i}b"] = {
            "kernel": conv_kernel(sd[f"{prefix}.layers.{i}.double_conv.2.weight"]),
            "bias": _np(sd[f"{prefix}.layers.{i}.double_conv.2.bias"]),
        }
        i += 1
    return params


def transplant_heads(sd: dict):
    out = {}
    for name in ("cls_head", "reg_head", "dir_head"):
        if f"{name}.weight" in sd:
            out[name] = {
                "kernel": conv_kernel(sd[f"{name}.weight"]),
                "bias": _np(sd[f"{name}.bias"]),
            }
    return out


# ------------------------------------------------------------ full model
def _merge(dst: dict, src: dict, path: str = "") -> dict:
    """Shape-checked recursive overwrite of dst leaves by src leaves
    (numpy; JAX's ``_merge``)."""
    out = dict(dst)
    for k, v in src.items():
        if isinstance(v, dict):
            if k not in dst:
                raise KeyError(f"transplant: no target subtree {path}/{k}")
            out[k] = _merge(dst[k], v, f"{path}/{k}")
        else:
            if k not in dst:
                raise KeyError(f"transplant: no target leaf {path}/{k}")
            tgt = dst[k]
            if tuple(tgt.shape) != tuple(v.shape):
                raise ValueError(
                    f"transplant: shape mismatch at {path}/{k}: "
                    f"{tuple(v.shape)} -> {tuple(tgt.shape)}"
                )
            out[k] = np.asarray(v, dtype=tgt.dtype)
    return out


def _into(state_dict: dict, p_new: dict, s_new: dict) -> dict:
    """The port ``state_dict`` with the flax-layout trees merged in
    (shape checked), bridged back key for key."""
    params, stats = to_flax(state_dict)
    params = _merge(params, p_new)
    stats = _merge(stats, s_new)
    return from_flax(params, stats, expected=state_dict)


def heter_pyramid_collab_tree(sd: dict, args: dict):
    """A reference HeterPyramidCollab state_dict (m1 PointPillars branch)
    -> (params, batch_stats) subtrees in flax layout: encoder_m1
    (PillarVFE), backbone_m1, pyramid_backbone, shrink_conv and the
    shared heads. The identity aligner has no parameters."""
    p_new: dict = {}
    s_new: dict = {}
    enc_p, enc_s = transplant_pillar_encoder(sd, "encoder_m1")
    bb_p, bb_s = transplant_resnet_bev(
        sd, "backbone_m1", args["m1"]["backbone_args"]["layer_nums"]
    )
    p_new["branch_m1"] = {"encoder": enc_p, "backbone": bb_p}
    s_new["branch_m1"] = {"encoder": enc_s, "backbone": bb_s}

    pyr_p, pyr_s = transplant_pyramid(sd, args["fusion_backbone"])
    p_new["pyramid_backbone"] = pyr_p
    s_new["pyramid_backbone"] = pyr_s

    if any(k.startswith("shrink_conv.") for k in sd):
        p_new["shrink"] = transplant_shrink(sd)
    p_new["heads"] = transplant_heads(sd)
    return p_new, s_new


def transplant_heter_pyramid_collab(sd: dict, state_dict: dict,
                                    args: dict) -> dict:
    """Port a reference HeterPyramidCollab state_dict into the port's
    HeterPyramidCollab: ``state_dict`` is the target model's, ``args``
    its model args; -> the new state_dict (every entry the transplant
    does not reach kept), which the model loads strictly."""
    return _into(state_dict, *heter_pyramid_collab_tree(sd, args))


def _spconv_kernel(w) -> np.ndarray:
    """spconv-1.x weight (kd, kh, kw, in, out) -> (kd*kh*kw, in, out)
    tap-major kernel for ops/sparse_conv.apply_table_conv (the tap order
    of sparse_conv._offsets/_taps is the same z-major flattening)."""
    w = _np(w)
    kd, kh, kw, cin, cout = w.shape
    return w.reshape(kd * kh * kw, cin, cout)


def second_encoder_tree(sd: dict, prefix: str = "encoder_m3"):
    """Reference SECOND encoder (heter_encoders.py:52-81: MeanVFE +
    VoxelBackBone8x + HeightCompression, sparse_backbone_3d.py:34-152)
    -> models/second.SecondRefStack params/batch_stats in flax layout.

    Layer map (ref SparseSequential index naming -> our module names):
      spconv_block.conv_input.{0,1}          -> conv_input.{kernel,bn}
      spconv_block.conv1.0.{0,1}             -> conv1_0
      spconv_block.conv{s}.{j}.{0,1} (s=2..4)-> conv{s}_{j}
      spconv_block.conv_out.{0,1}            -> conv_out
    MeanVFE has no parameters; HeightCompression is a reshape.
    """
    base = f"{prefix}.spconv_block" if prefix else "spconv_block"

    def conv_bn(conv_key, bn_key):
        bn_p, bn_s = _bn(sd, bn_key)
        params = {
            "kernel": _spconv_kernel(sd[f"{conv_key}.weight"]),
            "bn": bn_p,
        }
        return params, {"bn": bn_s}

    params: dict = {}
    stats: dict = {}
    params["conv_input"], stats["conv_input"] = conv_bn(
        f"{base}.conv_input.0", f"{base}.conv_input.1"
    )
    params["conv1_0"], stats["conv1_0"] = conv_bn(
        f"{base}.conv1.0.0", f"{base}.conv1.0.1"
    )
    for s in (2, 3, 4):
        for j in (0, 1, 2):
            params[f"conv{s}_{j}"], stats[f"conv{s}_{j}"] = conv_bn(
                f"{base}.conv{s}.{j}.0", f"{base}.conv{s}.{j}.1"
            )
    params["conv_out"], stats["conv_out"] = conv_bn(
        f"{base}.conv_out.0", f"{base}.conv_out.1"
    )
    return params, stats


def transplant_second_encoder(sd: dict, state_dict: dict,
                              prefix: str = "encoder_m3") -> dict:
    """Port a reference SECOND encoder's state_dict into the port's
    ``SecondRefEncoder``, whose state_dict is ``state_dict``; -> the new
    state_dict, which the encoder loads strictly."""
    p, s = second_encoder_tree(sd, prefix)
    return _into(state_dict, {"VmapSecondRefStack_0": p},
                 {"VmapSecondRefStack_0": s})


# ------------------------------------------------- synthetic checkpoints
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_PFN_BN = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
           "bn_var": "running_var"}
_BACKBONES = {"branch_m1.backbone": "backbone_m1",
              "pyramid_backbone.backbone": "pyramid_backbone"}


def _reference_entry(key: str, shape: tuple, prefix: str):
    """The opencood key and shape that the port entry ``key`` of ``shape``
    is transplanted from; None for an entry no transplant reaches."""
    m = re.fullmatch(r"branch_m1\.encoder\.(\w+)", key)
    if m:
        base = "encoder_m1.pillar_vfe.pfn_layers.0"
        if m.group(1) == "pfn_kernel":
            return f"{base}.linear.weight", shape[::-1]
        return f"{base}.norm.{_PFN_BN[m.group(1)]}", shape
    m = re.fullmatch(r"(branch_m1\.backbone|pyramid_backbone\.backbone)"
                     r"\.stages_(\d+)\.(BasicBlock|BottleneckX)_(\d+)"
                     r"\.ConvNormAct_(\d+)\.(kernel|Norm_0\.(\w+))", key)
    if m:
        ref, s, kind, b, c = (_BACKBONES[m.group(1)], m.group(2), m.group(3),
                              m.group(4), int(m.group(5)))
        base = f"{ref}.resnet.layer{s}.{b}"
        convs = 3 if kind == "BottleneckX" else 2
        if m.group(6) == "kernel":
            if c == convs:
                return f"{base}.downsample.0.weight", shape
            if kind == "BottleneckX" and c == 1:  # grouped conv2
                return f"{base}.conv2.weight", (shape[0], shape[1] // 32,
                                                *shape[2:])
            return f"{base}.conv{c + 1}.weight", shape
        bn = "downsample.1" if c == convs else f"bn{c + 1}"
        return f"{base}.{bn}.{_BN[m.group(7)]}", shape
    m = re.fullmatch(r"(branch_m1\.backbone|pyramid_backbone\.backbone)"
                     r"\.deblocks_(\d+)\.(ConvTranspose_0\.kernel|Conv_0\."
                     r"kernel|Norm_0\.(\w+))", key)
    if m:
        base = f"{_BACKBONES[m.group(1)]}.deblocks.{m.group(2)}"
        if m.group(4) is None:
            return f"{base}.0.weight", shape
        return f"{base}.1.{_BN[m.group(4)]}", shape
    m = re.fullmatch(r"pyramid_backbone\.single_head_(\d+)\.(kernel|bias)",
                     key)
    if m:
        leaf = "weight" if m.group(2) == "kernel" else "bias"
        return f"pyramid_backbone.single_head_{m.group(1)}.{leaf}", shape
    m = re.fullmatch(r"shrink\.conv_(\d+)([ab])\.(kernel|bias)", key)
    if m:
        idx = 0 if m.group(2) == "a" else 2
        leaf = "weight" if m.group(3) == "kernel" else "bias"
        return (f"shrink_conv.layers.{m.group(1)}.double_conv.{idx}.{leaf}",
                shape)
    m = re.fullmatch(r"heads\.(cls|reg|dir)_head\.(kernel|bias)", key)
    if m:
        leaf = "weight" if m.group(2) == "kernel" else "bias"
        return f"{m.group(1)}_head.{leaf}", shape
    m = re.fullmatch(r"VmapSecondRefStack_0\.(conv_input|conv1_0|conv\d_\d|"
                     r"conv_out)\.(kernel|bn\.(\w+))", key)
    if m:
        name = m.group(1)
        block = {"conv_input": "conv_input", "conv_out": "conv_out",
                 "conv1_0": "conv1.0"}.get(name, name.replace("_", "."))
        base = f"{prefix}.spconv_block" if prefix else "spconv_block"
        if m.group(2) == "kernel":
            taps, cin, cout = shape
            kd = (3, 1, 1) if taps == 3 else (3, 3, 3)
            return f"{base}.{block}.0.weight", (*kd, cin, cout)
        return f"{base}.{block}.1.{_BN[m.group(3)]}", shape
    return None


def synthetic_reference(state_dict: dict, seed: int = 0,
                        prefix: str = "encoder_m3") -> dict:
    """A seeded opencood-named state_dict (f32 CPU tensors) with the keys
    and shapes the transplant reads for the port model whose state_dict
    is ``state_dict`` (a HeterPyramidCollab's m1 modules, or a
    SecondRefEncoder's with the SECOND ``prefix``): conv and linear
    weights normal over sqrt(fan-in), biases and BN shifts small, BN
    scales near 1 and running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(state_dict):
        entry = _reference_entry(key, tuple(state_dict[key].shape), prefix)
        if entry is None:
            continue
        name, shape = entry
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "weight" and len(shape) == 1:
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == "weight":
            if name.endswith("linear.weight"):
                fan_in = shape[1]
            elif len(shape) == 5:  # spconv (kd, kh, kw, in, out)
                fan_in = int(np.prod(shape[:4]))
            else:  # conv (O, I, kh, kw); a deconv's (I, O, s, s) alike
                fan_in = int(np.prod(shape[1:]))
            v = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
        else:  # biases and running means
            v = rng.normal(0.0, 0.05, shape)
        out[name] = torch.from_numpy(np.asarray(v, np.float32))
    return out
