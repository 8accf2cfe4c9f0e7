"""Reference of the ``alliance`` configuration: HEAL's four-type
alliance, m1 PointPillars, m2 Lift-Splat-Shoot cameras, m3 SECOND and
m4 16-line PointPillars, each with its aligner, into the same Pyramid
Fusion and heads as the flagship (``model.py``)."""
from __future__ import annotations

from .assemble import to_device  # noqa: F401  (the harness's entry)
from .camera import LiftSplat
from .model import HeterPyramid, PillarVFE
from .second import Second

ENCODERS = {"point_pillar": PillarVFE, "second": Second, "camera": LiftSplat}


def build(hypes: dict):
    return HeterPyramid(hypes["model"]["args"], ENCODERS)
