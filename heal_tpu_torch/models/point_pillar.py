"""PointPillars helpers shared by the detectors (torch).

Counterpart of the shrink-header builder of heal_tpu/models/point_pillar.py
(``_shrink_from_args``, :35-44). The single-agent PointPillar detector
itself is not ported yet.
"""
from __future__ import annotations

from .layers import DownsampleConv


def _shrink_from_args(args: dict, cin: int):
    if "shrink_header" not in args:
        return None
    sh = args["shrink_header"]
    return DownsampleConv(
        cin,
        dims=tuple(sh["dim"]),
        kernels=tuple(sh["kernal_size"]),
        strides=tuple(sh["stride"]),
        paddings=tuple(sh.get("padding", ())),
    )
