"""Reference of the ``flagship`` configuration: HEAL's Pyramid Fusion
over m1 PointPillars agents (``model.py`` with the PointPillars
encoder)."""
from __future__ import annotations

from .assemble import to_device  # noqa: F401  (the harness's entry)
from .model import HeterPyramid, PillarVFE

ENCODERS = {"point_pillar": PillarVFE}


def build(hypes: dict):
    return HeterPyramid(hypes["model"]["args"], ENCODERS)
