"""Model registry (torch), keyed by the config's ``core_method``.

Counterpart of heal_tpu/models/registry.py. Only ``heter_pyramid_collab``
is ported so far.
"""
from __future__ import annotations

MODEL_REGISTRY: dict = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def build_model(model_cfg: dict):
    """Build the torch module of the config's ``model`` section, in eval
    mode, parameters uninitialised (bridge or ``init_weights`` them)."""
    name = model_cfg["core_method"]
    if name not in MODEL_REGISTRY:
        from . import heter_pyramid  # noqa: F401  (registers its models)
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"model core_method {name!r} is not ported; ported: "
            f"{sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[name](model_cfg["args"]).eval()
