"""On the card: the control (the reference in the program's place, in
TF32) comes out not correct, and the sound program correct, on small
copies of every cell. The full-size readings the limits were set from
come from ``python -m benchmark.tests.controls`` (PERF.md)."""
from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests import controls, tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_and_the_program_is(cell, cuda_device):
    c = tiny.cell(cell, batches=3) if "train" in cell else tiny.cell(cell)
    for seed in (11, 12, 13):
        ok, _, numbers = controls.readings(c, seed, 0.5, cuda_device, True)
        assert not ok, (seed, numbers)
        ok, _, numbers = controls.readings(c, seed, 0.5, cuda_device, False)
        assert ok, (seed, numbers)
