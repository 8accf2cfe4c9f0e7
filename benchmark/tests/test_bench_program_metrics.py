"""The readers of the program's own spans and counters
(``metrics/program.py`` and the nine readers beside it) on synthetic
records: a device-only stretch followed by a host-traced one, as the
traced run records them. Each reader averages the first stretch alone,
and reads nothing where there is nothing to read."""
from __future__ import annotations

import sys

import pytest

from benchmark import harness

SERVE = ("transfer_ms.serve", "encoder_span_ms.serve",
         "fusion_span_ms.serve", "decode_span_ms.serve", "host_syncs.serve")
TRAIN = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
         "host_syncs.train")


def rec(name, request, ms, counts=None):
    return {"name": name, "request": request, "parent": -1,
            "start_ns": None if ms is None else 0,
            "end_ns": None if ms is None else 1, "device_ms": ms,
            "counts": dict(counts or {})}


def frame(request, k, scale):
    """One served frame's records; ``k`` varies the NMS readbacks."""
    return [rec("serve.inputs", request, 1.0 * scale, {"host_sync.h2d": 6}),
            rec("encoder.m1", request, 2.0 * scale),
            rec("encoder.m3", request, 3.0 * scale, {"host_sync.const": 2}),
            rec("fusion", request, 10.0 * scale),
            rec("decode", request, 4.0 * scale,
                {"host_sync.nms": 1 + k % 2, "host_sync.const": 2}),
            rec("to_host", request, 1.0 * scale, {"host_sync.to_host": 4}),
            rec("request", request, None, {"host_sync.h2d": 3})]


def step(request, scale):
    """One trained step's records."""
    return [rec("train.step", request, 100.0 * scale),
            rec("train.forward", request, 40.0 * scale,
                {"host_sync.const": 1}),
            rec("encoder.m1", request, 5.0 * scale),
            rec("train.backward", request, 50.0 * scale),
            rec("train.optimizer", request, 1.0 * scale),
            rec("train.optimizer", request, 2.0 * scale)]


def ctx_of(cell):
    return {"cell": harness.cell(cell)}


@pytest.fixture
def records(monkeypatch):
    """Set what the program's tracer returns."""
    from heal_tpu_torch import trace

    def set_records(recs):
        monkeypatch.setattr(trace, "records", lambda: list(recs))

    return set_records


def read(name, ctx):
    return harness.module("metrics", name).read(ctx)


def serve_records(n):
    # a request left over from before the profiler, then the device-only
    # stretch (scale 1), then the host-traced one (scale 5, other counts)
    out = [rec("request", 3, None, {"host_sync.h2d": 99})]
    for i in range(n):
        out += frame(10 + i, i, 1.0)
    for i in range(4):
        extra = frame(10 + n + i, 0, 5.0)
        extra[0]["counts"]["host_sync.h2d"] = 50
        out += extra
    return out


def test_serve_readers_average_the_device_only_stretch(records):
    for cell in ("flagship.serve", "alliance.serve"):
        ctx = ctx_of(cell)
        n = ctx["cell"]["traffic_file"]["traced_frames"]
        records(serve_records(n))
        got = {name: read(name, ctx) for name in SERVE}
        assert got == pytest.approx({
            "transfer_ms.serve": 1.0, "encoder_span_ms.serve": 5.0,
            "fusion_span_ms.serve": 10.0, "decode_span_ms.serve": 5.0,
            "host_syncs.serve": 6 + 2 + 1.5 + 2 + 4 + 3})


def test_train_readers_average_the_device_only_stretch(records):
    ctx = ctx_of("flagship.train")
    n = ctx["cell"]["traffic_file"]["traced_steps"]
    recs = [r for i in range(n) for r in step(20 + i, 1.0)]
    recs += [r for i in range(2) for r in step(20 + n + i, 7.0)]
    records(recs)
    got = {name: read(name, ctx) for name in TRAIN}
    assert got == pytest.approx({
        "forward_ms.train": 40.0, "backward_ms.train": 50.0,
        "optimizer_ms.train": 3.0, "host_syncs.train": 1.0})


def test_fewer_requests_than_the_stretch_are_averaged_as_they_are(records):
    ctx = ctx_of("flagship.serve")
    records(frame(1, 0, 1.0) + frame(2, 1, 3.0))
    assert read("fusion_span_ms.serve", ctx) == pytest.approx(20.0)
    assert read("host_syncs.serve", ctx) == pytest.approx(18.5)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_to_read_reads_none(records, monkeypatch, name):
    cell = "flagship.train" if name.endswith(".train") else "flagship.serve"
    records([])
    assert read(name, ctx_of(cell)) is None
    # spans of another kind only: no request of this mode opened
    records(step(1, 1.0) if cell.endswith("serve") else frame(1, 0, 1.0))
    assert read(name, ctx_of(cell)) is None
    assert read(name, {}) is None
    # a checkout of the program from before it had a tracer, where the
    # same records would otherwise be read
    import heal_tpu_torch

    records(serve_records(16) if cell.endswith("serve")
            else step(1, 1.0))
    assert read(name, ctx_of(cell)) is not None
    monkeypatch.delattr(heal_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "heal_tpu_torch.trace", None)
    assert read(name, ctx_of(cell)) is None


def test_the_nine_metrics_are_in_the_manifest_with_their_cells():
    specs = {m["name"]: m for m in harness.manifest()["per_layer"]}
    for name in SERVE:
        assert specs[name]["workloads"] == ["flagship.serve",
                                            "alliance.serve"]
        assert specs[name]["better"] == "lower"
    for name in TRAIN:
        assert specs[name]["workloads"] == ["flagship.train"]
    layers = {m["layer"] for m in specs.values()
              if m["name"] not in SERVE + TRAIN}
    for name in ("encoder_span_ms.serve", "fusion_span_ms.serve",
                 "decode_span_ms.serve", "forward_ms.train"):
        assert specs[name]["layer"] in layers, name
