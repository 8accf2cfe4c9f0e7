"""Model zoo (torch, eval mode): the modules of the m1 Pyramid-collab path.

Module and parameter names follow the flax paths of ``heal_tpu.models``,
so utils/bridge.py maps flax variables onto them mechanically.
"""
from .registry import build_model, register_model

__all__ = ["build_model", "register_model"]
