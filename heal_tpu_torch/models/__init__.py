"""Model zoo (torch): HEAL's pyramid models (collab and stage-2 single)
and the heterogeneous baselines with the fusion zoo.

Module and parameter names follow the flax paths of ``heal_tpu.models``,
so utils/bridge.py maps flax variables onto them mechanically.
"""
from .registry import build_loss, build_model, register_loss, register_model

__all__ = ["build_loss", "build_model", "register_loss", "register_model"]
