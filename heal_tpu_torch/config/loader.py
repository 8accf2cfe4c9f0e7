"""YAML loading + the derived-parameter pass of the port's configs.

The port's copy of heal_tpu/config/loader.py, trimmed to the parser the
slice's configs name (``load_general_params``: anchor W/H/D from the
lidar range and voxel size): a scientific-notation-safe YAML loader,
dispatch on the ``yaml_parser`` key, and ``save_yaml``. The same file
gives the same dict as ``heal_tpu.config.load_yaml``.
"""
from __future__ import annotations

import math
import os
import re

import numpy as np
import yaml

PARSER_REGISTRY: dict = {}


class _Loader(yaml.SafeLoader):
    """SafeLoader that also reads 1e-10 (no dot) as a float."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        """^(?:
     [-+]?(?:[0-9][0-9_]*)\\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\\.[0-9_]*
    |[-+]?\\.(?:inf|Inf|INF)
    |\\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def load_yaml(file: str, model_dir: str | None = None) -> dict:
    """Load a config; if ``model_dir`` is given, its config.yaml wins."""
    if model_dir:
        candidate = os.path.join(model_dir, "config.yaml")
        if os.path.exists(candidate):
            file = candidate
    with open(file, "r") as stream:
        param = yaml.load(stream, Loader=_Loader)
    parser_name = param.get("yaml_parser")
    if parser_name:
        if parser_name not in PARSER_REGISTRY:
            raise KeyError(
                f"yaml_parser {parser_name!r} is not ported; "
                f"registered: {sorted(PARSER_REGISTRY)}"
            )
        param = PARSER_REGISTRY[parser_name](param)
    return param


def save_yaml(data: dict, path: str) -> None:
    """Dump a config dict (numpy scalars/arrays converted to python)."""

    def _clean(obj):
        if isinstance(obj, dict):
            return {k: _clean(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [_clean(v) for v in obj]
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, np.generic):
            return obj.item()
        return obj

    with open(path, "w") as f:
        yaml.safe_dump(_clean(data), f, sort_keys=False)


def load_general_params(param: dict) -> dict:
    """Anchor-map W/H/D (W spans lidar x, H lidar y) and voxel sizes in
    ``postprocess.anchor_args``, used by all heter (HEAL) configs."""
    cav_lidar_range = param["preprocess"]["cav_lidar_range"]
    vw, vh, vd = param["preprocess"]["args"]["voxel_size"]
    anchor_args = param["postprocess"].setdefault("anchor_args", {})
    anchor_args["vw"] = vw
    anchor_args["vh"] = vh
    anchor_args["vd"] = vd
    anchor_args["W"] = math.ceil((cav_lidar_range[3] - cav_lidar_range[0]) / vw)
    anchor_args["H"] = math.ceil((cav_lidar_range[4] - cav_lidar_range[1]) / vh)
    anchor_args["D"] = math.ceil((cav_lidar_range[5] - cav_lidar_range[2]) / vd)
    anchor_args.setdefault("cav_lidar_range", cav_lidar_range)
    return param


PARSER_REGISTRY["load_general_params"] = load_general_params
