"""Seeded weights, made on the device in one draw, for the program and
the reference alike.

The leaves and their shapes are the reference model's state dict; the
program's model takes the same dict strictly, so a name or a shape that
differs stops the run. Kernels are lecun-normal (std sqrt(1 / fan in)),
which keeps the heads' logits of the benchmark's configurations near
one; norm scales, biases and running statistics are drawn around flax's
defaults so that every one of them matters to the output.

The attention fusions' own leaves (V2X-ViT, CoBEVT):

  * ``relation_att``, ``relation_msg`` (T, T, heads, dh, dh): each
    (receiver type, sender type, head) slice is a dh x dh map applied
    to a query or a value as a kernel is, so lecun-normal over fan in
    dh: the map keeps its input's scale;
  * ``rel_pos_bias`` (offsets, heads): added to attention logits whose
    spread is about one (LayerNormed tokens through lecun projections,
    scaled by 1 / sqrt(dh)). It is drawn with std ``REL_POS_STD`` = 1,
    the logits' own scale, so that a bias read at a wrong offset shows
    in the heads: on the small lidar-only V2X-ViT and CoBEVT of
    ``tests/test_bench_zoo.py``, a transposed offset index moves the
    heads by about 25% of their largest magnitude at std 1, and by
    about 0.5% at flax's own std 0.02.
"""
from __future__ import annotations

import math
import re

import torch

REL_POS_STD = 1.0
_MHA = r"(?:^|\.)(?:mha|MultiHeadDotProductAttention_\d+)\."
# fan in of the zoo's 3-D kernels, by the module path that declares them
_FAN_IN_3D = (
    (re.compile(_MHA + r"(?:query|key|value)\.kernel$"),
     lambda s: s[0]),                      # (cin, heads, dh)
    (re.compile(_MHA + r"out\.kernel$"),
     lambda s: s[0] * s[1]),               # (heads, dh, cout)
    (re.compile(r"(?:^|\.)hmsa_\d+\.(?:q|k|v|proj)\.kernel$"),
     lambda s: s[1]),                      # TypedDense (T, C, D)
)


def _fan_in(name: str, shape) -> int:
    if len(shape) == 2:                    # Dense (in, out), PFN (10, F)
        return shape[0]
    if name.endswith("ConvTranspose_0.kernel"):   # (in, out, s, s)
        return shape[0] * shape[2] * shape[3]
    if len(shape) == 3:
        for pattern, fan_in in _FAN_IN_3D:
            if pattern.search(name):
                return fan_in(shape)
        return shape[0] * shape[1]         # SECOND's (taps, in, out)
    return math.prod(shape[1:])            # (out, in, kh, kw)


def _leaf(name: str, shape, noise: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("kernel"):
        return noise * math.sqrt(1.0 / _fan_in(name, shape))
    if leaf in ("scale", "bn_scale"):
        return 1.0 + 0.1 * noise
    if leaf in ("bias", "bn_bias"):
        return 0.05 * noise
    if leaf in ("mean", "bn_mean"):
        return 0.1 * noise
    if leaf in ("var", "bn_var"):
        return 1.0 + 0.2 * noise.abs()
    if leaf == "gamma":
        return 0.1 * noise
    if leaf in ("relation_att", "relation_msg"):   # (T, T, heads, dh, dh)
        return noise * math.sqrt(1.0 / shape[-2])
    if leaf == "rel_pos_bias":
        return REL_POS_STD * noise
    raise KeyError(f"no rule for the leaf {name!r}: give it one here")


def make(shapes: dict, seed: int, device) -> dict:
    """{name: shape} -> {name: f32 tensor on ``device``}, drawn from
    ``seed`` by one ``torch.randn`` on the device."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    sizes = [math.prod(s) for s in shapes.values()]
    noise = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(shapes.items(), noise.split(sizes)):
        out[name] = _leaf(name, shape, part.reshape(shape))
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
