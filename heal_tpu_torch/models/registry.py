"""Model and loss registries (torch), keyed by the config's ``core_method``.

Counterpart of heal_tpu/models/registry.py. Ported so far (18 of its
29 model names, 4 of its 9 losses): the models ``heter_pyramid_collab``,
``heter_pyramid_single``, ``heter_model_baseline``,
``heter_model_baseline_ms``, ``heter_model_late``, ``point_pillar``,
``point_pillar_uncertainty``, ``point_pillar_baseline``,
``center_point``, ``center_point_baseline``,
``center_point_baseline_multiscale``, ``center_point_intermediate``,
``center_point_where2comm``, ``second``, ``second_intermediate``,
``lift_splat_shoot``, ``lift_splat_shoot_voxel`` and
``lift_splat_shoot_intermediate``, and
the losses ``point_pillar_loss``, ``point_pillar_pyramid_loss``,
``point_pillar_uncertainty_loss`` and ``center_point_loss``.
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


def model_class(name: str):
    """The registered model class of ``core_method`` ``name``."""
    if name not in MODEL_REGISTRY:
        # importing the model modules registers their models
        from . import (center_point, heter_baseline,  # noqa: F401
                       heter_pyramid, lift_splat_shoot, point_pillar,
                       second_model)
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"model core_method {name!r} is not ported; ported: "
            f"{sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[name]


def build_model(model_cfg: dict, max_cav: int | None = None):
    """Build the torch module of the config's ``model`` section, in eval
    mode, parameters uninitialised (bridge or ``init_weights`` them).
    ``max_cav``: the agent axis L of the batches (``train_params.max_cav``)
    for the models that size parameters by it (``needs_max_cav``: the
    baselines, whose CoBEVT bias table spans the agents)."""
    cls = model_class(model_cfg["core_method"])
    args = model_cfg["args"]
    if "bn_momentum" in args:
        # as heal_tpu/models/registry.py: the momentum rides the norm kind
        # ("batch@0.99"), so each model instance carries its own
        base = str(args.get("norm", "batch")).split("@")[0]
        if base == "batch":
            args = dict(args, norm=f"batch@{float(args['bn_momentum'])}")
    if getattr(cls, "needs_max_cav", False):
        return cls(args, max_cav=max_cav).eval()
    return cls(args).eval()


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
