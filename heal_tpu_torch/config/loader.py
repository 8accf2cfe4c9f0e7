"""YAML loading + the derived-parameter pass of the port's configs.

The port's copy of heal_tpu/config/loader.py with all seven of its
parsers (``load_general_params``: anchor W/H/D from the lidar range and
voxel size; ``load_point_pillar_params``: the same and the voxel grid
size in ``model.args.point_pillar_scatter``;
``load_point_pillar_params_stage1``: that for CoAlign's stage 1;
``load_second_params``: the grid size in ``model.args.backbone_3d``;
``load_voxel_params``: the anchors only; ``load_bev_params``: PIXOR's
input and label shapes; ``load_lift_splat_shoot_params``: the anchor map
from the camera grid of ``fusion.args.grid_conf``): a
scientific-notation-safe YAML loader,
dispatch on the ``yaml_parser`` key, and ``save_yaml``. The same file
gives the same dict as ``heal_tpu.config.load_yaml``. ``reparse`` runs
the parser again after an override (the inference tools);
``keep_modalities`` cuts an alliance config down to the agent types
that were trained.
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
    if param.get("yaml_parser"):
        param = reparse(param)
    return param


def reparse(param: dict) -> dict:
    """Run the config's ``yaml_parser`` (default ``load_general_params``)
    again, e.g. after ``common_np.update_dict`` changed a range."""
    parser_name = param.get("yaml_parser", "load_general_params")
    if parser_name not in PARSER_REGISTRY:
        raise KeyError(
            f"unknown yaml_parser {parser_name!r}; "
            f"registered: {sorted(PARSER_REGISTRY)}"
        )
    return PARSER_REGISTRY[parser_name](param)


def keep_modalities(param: dict, keep) -> dict:
    """Drop every agent type but ``keep`` from ``heter.modality_setting``,
    ``heter.mapping_dict`` and ``model.args`` (in place; -> ``param``):
    an alliance config served with the types that were trained."""
    keep = set(keep)
    heter = param.get("heter") or {}
    for section in ("modality_setting", "mapping_dict"):
        table = heter.get(section)
        if table:
            for m in [m for m in table if m not in keep]:
                del table[m]
    margs = param["model"]["args"]
    for m in [m for m in ("m1", "m2", "m3", "m4") if m in margs]:
        if m not in keep:
            del margs[m]
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


def _set_grid_size(param: dict, key: str) -> dict:
    """The voxel grid size (x, y, z cells, int64) in
    ``model.args.<key>.grid_size``."""
    cav_lidar_range = param["preprocess"]["cav_lidar_range"]
    voxel_size = param["preprocess"]["args"]["voxel_size"]
    grid_size = np.round(
        (np.array(cav_lidar_range[3:6]) - np.array(cav_lidar_range[0:3]))
        / np.array(voxel_size)
    ).astype(np.int64)
    param["model"]["args"].setdefault(key, {})["grid_size"] = grid_size
    return param


def load_point_pillar_params(param: dict) -> dict:
    """``load_general_params`` after the voxel grid size is set in
    ``model.args.point_pillar_scatter.grid_size``."""
    return load_general_params(_set_grid_size(param, "point_pillar_scatter"))


def load_second_params(param: dict) -> dict:
    """``load_general_params`` after the grid size of the sparse 3D
    backbone is set in ``model.args.backbone_3d.grid_size``."""
    return load_general_params(_set_grid_size(param, "backbone_3d"))


def load_voxel_params(param: dict) -> dict:
    """VoxelNet's pass: the anchor derivation of ``load_general_params``."""
    return load_general_params(param)


def load_bev_params(param: dict) -> dict:
    """PIXOR's BEV rasterisation: ``preprocess.args.input_shape`` (cells
    of ``res`` over x, y and z + 1) and ``label_shape`` (x, y over
    ``downsample_rate``, 7), and the anchor args' ``cav_lidar_range``."""
    res = param["preprocess"]["args"]["res"]
    x0, y0, z0, x1, y1, z1 = param["preprocess"]["cav_lidar_range"]
    rate = param["preprocess"]["args"]["downsample_rate"]
    input_shape = (int((x1 - x0) / res), int((y1 - y0) / res),
                   int((z1 - z0) / res) + 1)
    param["preprocess"]["args"]["input_shape"] = list(input_shape)
    param["preprocess"]["args"]["label_shape"] = [
        int(input_shape[0] / rate), int(input_shape[1] / rate), 7]
    param["postprocess"].setdefault("anchor_args", {})[
        "cav_lidar_range"] = param["preprocess"]["cav_lidar_range"]
    return param


def load_lift_splat_shoot_params(param: dict) -> dict:
    """The standalone camera detectors' pass: the anchor map's cell size
    and W / H from ``fusion.args.grid_conf``'s x and y bounds, and a
    default ``cav_lidar_range`` of the grid with z from -3 to 1."""
    grid_conf = param["fusion"]["args"]["grid_conf"]
    xbound, ybound = grid_conf["xbound"], grid_conf["ybound"]
    anchor_args = param["postprocess"].setdefault("anchor_args", {})
    anchor_args["vw"] = xbound[2]
    anchor_args["vh"] = ybound[2]
    anchor_args["W"] = math.ceil((xbound[1] - xbound[0]) / xbound[2])
    anchor_args["H"] = math.ceil((ybound[1] - ybound[0]) / ybound[2])
    anchor_args.setdefault(
        "cav_lidar_range", [xbound[0], ybound[0], -3, xbound[1], ybound[1], 1])
    return param


def load_point_pillar_params_stage1(param: dict) -> dict:
    """``load_point_pillar_params`` for CoAlign's stage-1 detector; a
    ``box_align_pre_calc`` block's stage-1 post-processor gets the
    derived anchor arguments."""
    param = load_point_pillar_params(param)
    if "box_align_pre_calc" in param:
        param["box_align_pre_calc"]["stage1_postprocessor_config"].update(
            {"anchor_args": param["postprocess"]["anchor_args"]})
    return param


PARSER_REGISTRY["load_general_params"] = load_general_params
PARSER_REGISTRY["load_point_pillar_params"] = load_point_pillar_params
PARSER_REGISTRY["load_point_pillar_params_stage1"] = (
    load_point_pillar_params_stage1)
PARSER_REGISTRY["load_second_params"] = load_second_params
PARSER_REGISTRY["load_voxel_params"] = load_voxel_params
PARSER_REGISTRY["load_bev_params"] = load_bev_params
PARSER_REGISTRY["load_lift_splat_shoot_params"] = load_lift_splat_shoot_params
