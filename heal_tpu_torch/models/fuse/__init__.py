"""Collaborative fusion modules (torch).

Counterpart of heal_tpu/models/fuse: each method fuses per-agent BEV maps
(warped into the ego frame) into one map, on features (B, L, H, W, C)
with a (B, L) agent mask; padded slots are masked out of every reduction.
``build_fusion`` builds every method of the zoo: max, att, disconet,
v2vnet, where2comm, who2com, v2xvit, cobevt, when2com and transformer;
Pyramid Fusion is HEAL's own.
"""
from .fusion_in_one import (
    AttFusion,
    DiscoFusion,
    MaxFusion,
    ScaledDotProductAttention,
    V2VNetFusion,
    Where2commFusion,
    Who2comFusion,
    build_fusion,
)
from .legacy import When2comFusion
from .pyramid import PyramidFusion, weighted_fuse
from .v2xvit import HMSA
from ..layers import MultiHeadDotProductAttention

# module class -> its parameter that adds one value to every logit of a
# softmax: a key projection's bias shifts each query's logits by q . b,
# HMSA's typed one whenever the keys share one agent type, and DiscoNet's
# and When2com's biases every agent's score alike
_SHIFT_BIASES = {MultiHeadDotProductAttention: "key.bias", HMSA: "k.bias",
                 DiscoFusion: "Conv_0.bias", When2comFusion:
                 "key_net.Dense_2.bias"}


def softmax_shift_biases(model) -> set:
    """Names of ``model``'s parameters whose gradient is zero by
    construction: the softmax they all shift cancels them, so a step
    moves them only by rounding."""
    return {f"{n}.{b}" if n else b for n, m in model.named_modules()
            for cls, b in _SHIFT_BIASES.items() if isinstance(m, cls)}

__all__ = [
    "MaxFusion",
    "AttFusion",
    "DiscoFusion",
    "ScaledDotProductAttention",
    "V2VNetFusion",
    "Where2commFusion",
    "Who2comFusion",
    "PyramidFusion",
    "weighted_fuse",
    "build_fusion",
    "softmax_shift_biases",
]
