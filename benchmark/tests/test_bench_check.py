"""``check.detections`` pairs each served box with the reference's box at
its place, by exact distance, where another anchor's box lies a
centimetre away a hundred metres out (at that range the matmul form of
``torch.cdist`` cannot tell the two apart)."""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import check, harness

TEMPLATE = torch.tensor([[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
                         [1, -1, 1], [1, 1, 1], [-1, 1, 1],
                         [-1, -1, 1]]) / 2.0


def _box(centre, yaw):
    c, s = math.cos(yaw), math.sin(yaw)
    rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return (TEMPLATE * torch.tensor([3.9, 1.6, 1.56])) @ rot.T + torch.tensor(
        centre)


def _decoded():
    """100 decoded boxes: box 0 and box 1 (another anchor's yaw) 1 cm
    apart at (-100, -50), the rest scattered near the ego."""
    g = torch.Generator().manual_seed(0)
    rest = [_box([float(x), float(y), -1.0], 0.0)
            for x, y in torch.rand(98, 2, generator=g) * 60 - 30]
    corners = torch.stack([_box([-100.0, -50.0, -0.8], 0.0),
                           _box([-100.01, -50.0, -0.8], math.pi / 2)]
                          + rest)
    scores = torch.full((100,), 0.3)
    scores[0], scores[1] = 0.4594, 0.4903
    return {"corners": corners, "scores": scores, "above": scores > 0.2}


def test_a_served_box_pairs_with_the_box_at_its_place():
    hypes = harness.load_json(harness.HERE, "configs", "flagship.json")[
        "hypes"]
    dec = _decoded()
    served = {"corners": dec["corners"][1:2].numpy(),
              "scores": np.array([0.4903], np.float32)}
    out = check.detections(served, dec, np.array([1]), hypes)
    assert out == {"boxes_m": 0.0, "scores": 0.0}


def test_a_box_moved_a_metre_still_reads_its_move():
    hypes = harness.load_json(harness.HERE, "configs", "flagship.json")[
        "hypes"]
    dec = _decoded()
    moved = dec["corners"][1:2].clone()
    moved[..., 0] += 1.0
    served = {"corners": moved.numpy(),
              "scores": np.array([0.4903], np.float32)}
    out = check.detections(served, dec, np.array([1]), hypes)
    assert out["boxes_m"] >= 1.0 - 1e-4
