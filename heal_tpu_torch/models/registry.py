"""Model and loss registries (torch), keyed by the config's ``core_method``.

Counterpart of heal_tpu/models/registry.py. Ported so far: the models
``heter_pyramid_collab`` and ``heter_pyramid_single`` and the losses
``point_pillar_loss`` and ``point_pillar_pyramid_loss``.
"""
from __future__ import annotations

MODEL_REGISTRY: dict = {}
LOSS_REGISTRY: dict = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def register_loss(name: str):
    def deco(cls):
        LOSS_REGISTRY[name] = cls
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
    args = model_cfg["args"]
    if "bn_momentum" in args:
        # as heal_tpu/models/registry.py: the momentum rides the norm kind
        # ("batch@0.99"), so each model instance carries its own
        base = str(args.get("norm", "batch")).split("@")[0]
        if base == "batch":
            args = dict(args, norm=f"batch@{float(args['bn_momentum'])}")
    return MODEL_REGISTRY[name](args).eval()


def build_loss(loss_cfg: dict):
    """The loss callable of the config's ``loss`` section."""
    name = loss_cfg["core_method"]
    if name not in LOSS_REGISTRY:
        from .. import losses  # noqa: F401  (registers the losses)
    if name not in LOSS_REGISTRY:
        raise KeyError(
            f"loss core_method {name!r} is not ported; ported: "
            f"{sorted(LOSS_REGISTRY)}"
        )
    return LOSS_REGISTRY[name](loss_cfg["args"])
