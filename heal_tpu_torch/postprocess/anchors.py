"""Anchor grid generation (host side, numpy).

The port's copy of heal_tpu/postprocess/anchors.py: anchor centers on a
linspace over the lidar range inset by one voxel, one anchor per (cell,
yaw) with fixed l/w/h, z fixed at -1.0.
"""
from __future__ import annotations

import math

import numpy as np


def generate_anchor_box(anchor_args: dict, order: str = "hwl") -> np.ndarray:
    """Build the (H', W', num_anchor, 7) anchor grid.

    H' = H // feature_stride, W' = W // feature_stride where H/W are the
    voxel-grid dims from the config derivation pass (config/loader.py).
    """
    W = anchor_args["W"]
    H = anchor_args["H"]
    l = anchor_args["l"]
    w = anchor_args["w"]
    h = anchor_args["h"]
    r = [math.radians(a) for a in anchor_args["r"]]
    num = len(r)
    vh = anchor_args["vh"]
    vw = anchor_args["vw"]
    xrange = [anchor_args["cav_lidar_range"][0], anchor_args["cav_lidar_range"][3]]
    yrange = [anchor_args["cav_lidar_range"][1], anchor_args["cav_lidar_range"][4]]
    stride = anchor_args.get("feature_stride", 2)

    x = np.linspace(xrange[0] + vw, xrange[1] - vw, W // stride)
    y = np.linspace(yrange[0] + vh, yrange[1] - vh, H // stride)
    cx, cy = np.meshgrid(x, y)  # (H', W')
    cx = np.tile(cx[..., None], num)
    cy = np.tile(cy[..., None], num)
    cz = np.full_like(cx, -1.0)

    ww = np.full_like(cx, w)
    ll = np.full_like(cx, l)
    hh = np.full_like(cx, h)
    rr = np.stack([np.full_like(cx[..., 0], ri) for ri in r], axis=-1)

    if order == "hwl":
        anchors = np.stack([cx, cy, cz, hh, ww, ll, rr], axis=-1)
    elif order == "lhw":
        anchors = np.stack([cx, cy, cz, ll, hh, ww, rr], axis=-1)
    else:
        raise ValueError(f"unsupported anchor order {order!r}")
    return anchors
