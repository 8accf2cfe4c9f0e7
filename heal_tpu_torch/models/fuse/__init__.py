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
from .pyramid import PyramidFusion, weighted_fuse

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
]
