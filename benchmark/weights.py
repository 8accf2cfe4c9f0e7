"""Seeded weights, made on the device in one draw, for the program and
the reference alike.

The leaves and their shapes are the reference model's state dict; the
program's model takes the same dict strictly, so a name or a shape that
differs stops the run. Kernels are lecun-normal (std sqrt(1 / fan in)),
which keeps the heads' logits of the benchmark's configurations near
one; norm scales, biases and running statistics are drawn around flax's
defaults so that every one of them matters to the output.
"""
from __future__ import annotations

import math

import torch


def _fan_in(name: str, shape) -> int:
    if len(shape) == 2:                    # Dense (in, out), PFN (10, F)
        return shape[0]
    if name.endswith("ConvTranspose_0.kernel"):   # (in, out, s, s)
        return shape[0] * shape[2] * shape[3]
    if len(shape) == 3:                    # SECOND's (taps, in, out)
        return shape[0] * shape[1]
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
