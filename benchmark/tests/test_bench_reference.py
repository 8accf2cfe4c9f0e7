"""Each plain reference against the port at a tiny size on the CPU, on
the same raw scenes and weights: the serve cells' numbers far inside
their limits."""
from __future__ import annotations

import time

import pytest

from benchmark import harness
from benchmark.tests import tiny

# f32 on the CPU: the two compute the same function in another order
TIGHT = {"heads": 1e-4, "boxes_m": 1e-4, "scores": 1e-5}


@pytest.mark.parametrize("cell", ["flagship.serve", "alliance.serve"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_serve_reference_agrees_with_the_port(cell, seed):
    c = tiny.cell(cell)
    res = harness.mode("serve").run(c, tiny.args(seed=seed), "cpu",
                                    time.perf_counter(),
                                    harness.reference(c["config"]))
    for key, tol in TIGHT.items():
        assert res["numbers"][key] <= tol, res["numbers"]
    assert res["attempted"] >= 1


@pytest.mark.parametrize("cell", ["flagship.train"])
def test_train_reference_agrees_with_the_port_on_the_first_step(cell):
    """The first step's loss and gradient: later steps move every weight
    by Adam's sign-like first update, so rounding in a near-zero
    gradient element moves it the other way (PERF.md)."""
    c = tiny.cell(cell, batches=3)
    res = harness.mode("train").run(c, tiny.args(seed=4), "cpu",
                                    time.perf_counter(),
                                    harness.reference(c["config"]))
    assert res["numbers"]["loss_first"] <= 1e-5, res["numbers"]
    assert res["numbers"]["grad"] <= 1e-2, res["numbers"]
