"""Model and loss registries (torch), keyed by the config's ``core_method``.

Counterpart of heal_tpu/models/registry.py, with all of its 29 model
names and 9 losses: the HEAL models (``heter_pyramid_collab``,
``heter_pyramid_single``), the heterogeneous baselines
(``heter_model_baseline``, ``_ms``, ``heter_model_late``), the
PointPillars detectors (``point_pillar``, ``_uncertainty``,
``_baseline``, ``_baseline_multiscale``, the DiscoNet student and
teacher ``point_pillar_disconet``, ``_teacher``), CenterPoint
(``center_point``, ``_baseline``, ``_baseline_multiscale``,
``_intermediate``, ``_where2comm``), SECOND (``second``,
``_intermediate``, ``second_ssfa``, ``_ssfa_uncertainty``), the
Lift-Splat-Shoot detectors (``lift_splat_shoot``, ``_voxel``,
``_intermediate``), VoxelNet (``voxel_net``, ``_intermediate``), PIXOR
(``pixor``, ``_intermediate``), ``ciassd`` and ``fpvrcnn``.
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
        from . import (center_point, ciassd, fpvrcnn,  # noqa: F401
                       heter_baseline, heter_pyramid, lift_splat_shoot,
                       pixor, point_pillar, second_model, voxel_net)
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model core_method {name!r}; registered: "
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
            f"unknown loss core_method {name!r}; registered: "
            f"{sorted(LOSS_REGISTRY)}"
        )
    return LOSS_REGISTRY[name](loss_cfg["args"])
