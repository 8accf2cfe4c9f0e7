"""A run with its timed path broken underneath comes out not correct:
the harness's look for a chip skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault the serve cells can have (an
answer altered where it is produced: a box moved, a score changed, a
detection dropped, a head output changed) and the sound run beside
them."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.tests import controls, tiny

SERVE_CELLS = ["flagship.serve", "alliance.serve"]


def _run(cell):
    c = tiny.cell(cell)
    res = harness.mode("serve").run(c, tiny.args(seed=5), "cpu",
                                    time.perf_counter(),
                                    harness.reference(c["config"]))
    return harness.verdict(res["numbers"], harness.limits(c))[0], \
        res["numbers"]


def _patch_decode(monkeypatch, alter):
    import heal_tpu_torch.postprocess.decode as dec

    real = dec.post_process_single

    def broken(*a, **k):
        out = real(*a, **k)
        return alter(dict(out))

    monkeypatch.setattr(dec, "post_process_single", broken)


def _first_kept(out):
    return int(torch.nonzero(out["valid"])[0, 0])


def _move_box(out):
    i = _first_kept(out)
    out["corners"] = out["corners"].clone()
    out["corners"][i, :, 0] += 0.5
    return out


def _change_score(out):
    i = _first_kept(out)
    out["scores"] = out["scores"].clone()
    out["scores"][i] -= 0.05
    return out


def _drop_detection(out):
    i = _first_kept(out)
    out["valid"] = out["valid"].clone()
    out["valid"][i] = False
    return out


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_sound_run_is_correct(cell):
    ok, numbers = _run(cell)
    assert ok, numbers


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("alter", [_move_box, _change_score,
                                   _drop_detection])
def test_an_altered_detection_is_not_correct(cell, alter, monkeypatch):
    _patch_decode(monkeypatch, alter)
    ok, numbers = _run(cell)
    assert not ok, numbers


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_altered_heads_are_not_correct(cell, monkeypatch):
    from heal_tpu_torch.models.heads import DetectionHeads

    real = DetectionHeads.forward

    def broken(self, x):
        out = real(self, x)
        out["reg_preds"] = out["reg_preds"] * 1.01
        return out

    monkeypatch.setattr(DetectionHeads, "forward", broken)
    ok, numbers = _run(cell)
    assert not ok, numbers


TRAIN_CELLS = ["flagship.train"]
# at this size the later steps' readings are noisier than at the cell's
# (fewer elements a leaf, so Adam's sign-like first update flips more of
# a leaf's norm on rounding): the tiny runs are held to the first step's
# numbers, which both training faults fail
FIRST_STEP = ("heads_first", "loss_first", "grad")


def _train(cell):
    c = tiny.cell(cell, batches=3)
    res = harness.mode("train").run(c, tiny.args(seed=5), "cpu",
                                    time.perf_counter(),
                                    harness.reference(c["config"]))
    limits = harness.limits(c)
    return harness.verdict(res["numbers"],
                           {k: limits[k] for k in FIRST_STEP})[0], \
        res["numbers"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_sound_training_is_correct(cell):
    ok, numbers = _train(cell)
    assert ok, numbers


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
def test_a_training_fault_is_not_correct(cell, fault):
    """A step that leaves the state unchanged; half of the batch left
    out, the mean taken over the rest."""
    undo = controls.FAULTS[fault]()
    try:
        ok, numbers = _train(cell)
    finally:
        undo()
    assert not ok, numbers
