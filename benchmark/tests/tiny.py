"""Tiny cells for the CPU tests: a benchmark configuration cut to a
small lidar range and few points, with its traffic made small to
match. Only the tests use these; the benchmark runs the files as they
are."""
from __future__ import annotations

import argparse
import copy

from benchmark import harness

RANGE = [-12.8, -6.4, -3, 12.8, 6.4, 1]


def _set_range(node, rng):
    if isinstance(node, dict):
        for k, v in node.items():
            if k in ("cav_lidar_range", "lidar_range", "gt_range"):
                node[k] = list(rng)
            else:
                _set_range(v, rng)
    elif isinstance(node, list):
        for v in node:
            _set_range(v, rng)


def _shrink_cameras(node):
    """Small camera images and a camera grid over the tiny range, and
    SECOND's column capacities cut to a tiny sweep's."""
    if isinstance(node, dict):
        if "data_aug_conf" in node:
            node["data_aug_conf"]["final_dim"] = [64, 128]
        if "max_voxels" in node:
            # below a tiny sweep's columns: the caps cut
            node["max_voxels"] = [1000, 600, 400, 300]
        if "grid_conf" in node:
            for key in ("xbound", "ybound"):
                node["grid_conf"][key] = [-12.8, 12.8, 0.8]
        for v in node.values():
            _shrink_cameras(v)


def shrink(hypes: dict, max_points: int = 1500) -> dict:
    """``hypes`` cut in place to a tiny range and ``max_points`` points
    an agent, with small cameras."""
    _set_range(hypes, RANGE)
    hypes["preprocess"]["args"]["max_points"] = max_points
    _shrink_cameras(hypes)
    return hypes


def shrink_traffic(t: dict, **traffic) -> dict:
    """The traffic file ``t`` cut in place to tiny scenes, then
    ``traffic``'s sizes."""
    t.update(frames=2, warmup_passes=1, traced_frames=2, vehicles=6,
             area_m=12.0, ground_points=2500, max_range_m=20.0)
    t.update(traffic)
    return t


def cell(name: str, max_points: int = 1500, **traffic) -> dict:
    """harness.cell(name) with a tiny range, ``max_points`` points an
    agent and the traffic's sizes replaced by ``traffic``."""
    c = copy.deepcopy(harness.cell(name))
    shrink(c["config_file"]["hypes"], max_points)
    shrink_traffic(c["traffic_file"], **traffic)
    return c


def args(seed: int = 3, seconds: float = 0.1, trace: int = 0):
    return argparse.Namespace(workload="tiny", seed=seed, seconds=seconds,
                              trace=trace)
