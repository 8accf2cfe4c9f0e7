"""Model zoo (torch): HEAL's pyramid models (collab and stage-2 single),
the heterogeneous baselines with the fusion zoo, late fusion's
heterogeneous detector and the homogeneous PointPillars detectors.

Module and parameter names follow the flax paths of ``heal_tpu.models``,
so utils/bridge.py maps flax variables onto them mechanically.
"""
from .registry import build_loss, build_model, register_loss, register_model

__all__ = ["build_loss", "build_model", "register_loss", "register_model"]
