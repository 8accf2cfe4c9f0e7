"""The port's tracer (heal_tpu_torch/trace.py) on the CPU.

Off (no profiler recording): ``span`` is the one shared no-op, a served
frame and a train step create no CUDA event, enter no
``record_function`` and add no record, and the counters still add. On
(under a CPU-only ``torch.profiler``): nesting, parent links and request
ids, the span names among the profiler's events, a tiny pyramid frame
and train step bit-identical to the ones served and trained with spans
off, the host-sync counts against independent witnesses, and the bound
of the buffer.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from heal_tpu_torch import trace
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.ops import nms
from heal_tpu_torch.postprocess import decode
from heal_tpu_torch.postprocess.anchors import generate_anchor_box
from heal_tpu_torch.tools.inference import (batch_keys, build_weights,
                                            frame_inputs)
from heal_tpu_torch.tools.train import build_trainer, device_batches
from heal_tpu_torch.tools.train import load_config
from heal_tpu_torch.utils.rotated_iou import box2d_to_corners

torch.set_num_threads(1)
TINY = "tests/configs/entry_tiny.yaml"


def recording():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _clean():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(TINY)
    model = build_weights(cfg, seed=0).eval()
    frame = next(build_dataset(cfg, train=False).batches(1, shuffle=False))
    batch = next(device_batches(cfg, cfg["train_params"]["batch_size"],
                                "cpu"))[0]
    return cfg, model, frame, batch


def serve(cfg, model, frame):
    """One frame as tools/inference.py serves it -> (heads, detections
    on the device, dense detections on the host)."""
    post = cfg["postprocess"]
    anchors = torch.from_numpy(np.asarray(generate_anchor_box(
        post["anchor_args"], post["order"]), np.float32))
    with torch.inference_mode():
        out = model(frame_inputs(frame, batch_keys(cfg), "cpu", False))
        det = decode.post_process_single(
            out["cls_preds"][0], out["reg_preds"][0], out["dir_preds"][0],
            anchors, torch.from_numpy(np.asarray(
                frame["transformation_matrix"][0], np.float32)),
            torch.tensor(post["gt_range"], dtype=torch.float32),
            order=post["order"],
            score_threshold=post["target_args"]["score_threshold"],
            nms_threshold=post["nms_thresh"])
        dense = decode.strip_padding(det)
    heads = {k: out[k] for k in ("cls_preds", "reg_preds", "dir_preds")}
    return heads, det, dense


def step(cfg, batch):
    """One train step of a fresh trainer -> (aux, parameters after)."""
    trainer = build_trainer(cfg, "cpu", 8)
    aux = trainer.train_step(batch)
    return aux, {n: p.detach().clone()
                 for n, p in trainer.model.named_parameters()}


def _forbid(monkeypatch):
    """Make a CUDA event, or a span of the tracer (which alone enters
    its ``record_function``), raise. torch's own optimizer opens ranges
    of its own whatever the profiler does."""
    def no(*args, **kwargs):
        raise AssertionError("created while spans are off")

    monkeypatch.setattr(torch.cuda, "Event", no)
    monkeypatch.setattr(trace, "Span", no)


def test_off_span_is_the_shared_noop_and_counters_still_add(monkeypatch):
    _forbid(monkeypatch)
    assert trace.span("a") is trace.OFF and trace.span("b") is trace.OFF
    with trace.request("r"):
        with trace.span("a"):
            trace.count("c")
    trace.count("c", 4)
    assert trace.records() == []
    assert trace.counters() == {"c": 5}


def test_off_frame_and_step_create_no_event_and_no_record(tiny,
                                                          monkeypatch):
    cfg, model, frame, batch = tiny
    _forbid(monkeypatch)
    serve(cfg, model, frame)
    step(cfg, batch)
    assert trace.records() == []
    counts = trace.counters()
    assert counts["host_sync.h2d"] > 0 and counts["host_sync.nms"] > 0
    assert counts["host_sync.to_host"] == 4


def test_on_nesting_parents_requests_and_profiler_events():
    with recording() as prof:
        assert isinstance(trace.span("x"), trace.Span)
        with trace.request("outer"):
            trace.count("c")
            with trace.span("inner"):
                trace.count("c", 2)
                with trace.span("leaf"):
                    pass
            trace.count("d")
        trace.count("loose", 3)  # no span open: the request's own record
        with trace.request("next"):
            trace.count("c")
    assert trace.span("x") is trace.OFF
    recs = trace.records()
    first = recs[0]["request"]
    assert [(r["name"], r["request"] - first, r["parent"])
            for r in recs] == [
        ("outer", 0, -1), ("inner", 0, 0), ("leaf", 0, 1),
        ("request", 0, -1), ("next", 1, -1)]
    assert [r["counts"] for r in recs] == [
        {"c": 1, "d": 1}, {"c": 2}, {}, {"loose": 3}, {"c": 1}]
    for r in recs[:3] + recs[4:]:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None
    assert recs[0]["start_ns"] <= recs[1]["start_ns"] <= recs[2]["end_ns"] \
        <= recs[1]["end_ns"] <= recs[0]["end_ns"]
    assert recs[3]["start_ns"] is None
    assert trace.counters() == {"c": 4, "d": 1, "loose": 3}
    names = {e.name for e in prof.events()}
    assert {"outer", "inner", "leaf", "next"} <= names


def test_on_frame_and_step_are_bit_identical_to_off(tiny):
    cfg, model, frame, batch = tiny
    heads_off, _, dense_off = serve(cfg, model, frame)
    aux_off, params_off = step(cfg, batch)
    assert trace.records() == []
    with recording():
        heads_on, _, dense_on = serve(cfg, model, frame)
        aux_on, params_on = step(cfg, batch)
    for k in heads_off:
        assert torch.equal(heads_on[k], heads_off[k]), k
    assert dense_on.keys() == dense_off.keys()
    for k in dense_off:
        assert np.array_equal(dense_on[k], dense_off[k]), k
    assert aux_on.keys() == aux_off.keys()
    for k in aux_off:
        assert torch.equal(aux_on[k], aux_off[k]), k
    for n in params_off:
        assert torch.equal(params_on[n], params_off[n]), n

    recs = trace.records()
    frame_recs = [r for r in recs if r["request"] == recs[0]["request"]]
    assert [r["name"] for r in frame_recs] == [
        "serve.inputs", "encoder.m1", "fusion", "decode", "to_host"]
    assert all(r["parent"] == -1 for r in frame_recs)
    step_recs = [r for r in recs if r["request"] == recs[0]["request"] + 1]
    top = recs.index(step_recs[0])
    assert [(r["name"], r["parent"]) for r in step_recs
            if r["parent"] in (-1, top)] == [
        ("train.step", -1), ("train.forward", top),
        ("train.backward", top), ("train.optimizer", top),
        ("train.optimizer", top)]
    # the train forward's encoder and fusion nest in train.forward
    assert {r["name"] for r in recs if r["parent"] == top + 1} >= {
        "encoder.m1", "fusion"}


def _fixpoint_iterations(corners, valid, threshold) -> int:
    """The iterations of nms_rotated_fixed's loop, counted apart."""
    k = corners.shape[0]
    iou = nms.rotated_iou_matrix(corners, corners)
    order = torch.arange(k)
    sup = ((iou > threshold) & (order[:, None] < order[None, :])).float()
    keep, n = valid, 0
    for _ in range(k):
        n += 1
        new = valid & ((keep.float() @ sup) < 0.5)
        if torch.equal(new, keep):
            break
        keep = new
    return n


def test_host_syncs_of_one_served_frame_match_their_witnesses(tiny,
                                                              monkeypatch):
    cfg, model, frame, _ = tiny
    calls, real_nms = [], decode.nms_rotated_fixed

    def spy_nms(corners, scores, valid, threshold):
        calls.append(_fixpoint_iterations(corners, valid, threshold))
        return real_nms(corners, scores, valid, threshold)

    readbacks, real_cpu = [0], torch.Tensor.cpu

    def spy_cpu(self, *args, **kwargs):
        readbacks[0] += 1
        return real_cpu(self, *args, **kwargs)

    monkeypatch.setattr(decode, "nms_rotated_fixed", spy_nms)
    _, det, _ = serve(cfg, model, frame)
    trace.clear()
    calls.clear()
    with recording():
        inputs = frame_inputs(frame, batch_keys(cfg), "cpu", False)
        _, det, _ = serve(cfg, model, frame)
        monkeypatch.setattr(torch.Tensor, "cpu", spy_cpu)
        decode.strip_padding(det)
        monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
    counts = trace.counters()
    assert counts["host_sync.nms"] == sum(calls) and len(calls) == 1
    assert counts["host_sync.to_host"] == 2 * readbacks[0] == 2 * len(det)
    leaves = {id(t) for v in inputs.values()
              for t in (v.values() if isinstance(v, dict) else [v])}
    assert counts["host_sync.h2d"] == 2 * len(leaves)
    # a frame's counts sit in its spans' records, by request
    recs = trace.records()
    last = recs[-1]["request"]
    per_frame: dict = {}
    for r in recs:
        if r["request"] == last:
            for k, v in r["counts"].items():
                per_frame[k] = per_frame.get(k, 0) + v
    assert per_frame["host_sync.nms"] == calls[-1]
    assert per_frame["host_sync.h2d"] == len(leaves)


def test_nms_counts_each_fixpoint_readback():
    # a chain of boxes 0.8 apart along x, each overlapping the next:
    # greedy keeps every other one, and the fixpoint needs several passes
    k = 9
    x = torch.arange(k, dtype=torch.float32) * 0.8
    boxes = torch.stack([x, torch.zeros(k), torch.ones(k), torch.ones(k),
                         torch.zeros(k)], dim=-1)
    corners = box2d_to_corners(boxes)
    valid = torch.ones(k, dtype=torch.bool)
    want = _fixpoint_iterations(corners, valid, 0.1)
    assert want >= 3
    keep = nms.nms_rotated_fixed(corners, torch.ones(k), valid, 0.1)
    assert keep.tolist() == [i % 2 == 0 for i in range(k)]
    assert trace.counters() == {"host_sync.nms": want}


def test_the_buffer_stays_bounded(monkeypatch):
    monkeypatch.setattr(trace.TRACER, "limit", 5)
    with recording():
        for i in range(4):
            with trace.request(f"r{i}"):
                with trace.span("child"):
                    trace.count("c")
    recs = trace.records()
    assert len(recs) == 5
    assert [(r["name"], r["parent"]) for r in recs] == [
        ("r0", -1), ("child", 0), ("r1", -1), ("child", 2), ("r2", -1)]
    assert [r["counts"] for r in recs] == [{}, {"c": 1}, {}, {"c": 1}, {}]
    assert trace.counters() == {"c": 4, "trace.dropped": 3}
    trace.clear()
    with recording():
        with trace.span("again"):
            pass
    assert [r["name"] for r in trace.records()] == ["again"]


def test_a_published_v2xvit_frame_records_its_encoder_and_fusion_layers():
    """The benchmark's V2X-ViT configuration (benchmark/configs/
    v2xvit.json) on the tiny range at depth 2, one forward: with no
    profiler, no record; profiled, ``encoder.lidar`` then ``fusion``,
    with each depth layer's ``v2xvit.hmsa``, ``v2xvit.mswin`` and
    ``v2xvit.ffn`` nested in ``fusion``, in that order."""
    import copy
    import json
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import weights as wlib
    from benchmark.reference import assemble
    from benchmark.tests import tiny
    from benchmark.traffic import scenes as gen
    from heal_tpu_torch.config import reparse
    from heal_tpu_torch.models import build_model

    with open(os.path.join(root, "benchmark", "configs",
                           "v2xvit.json")) as f:
        hypes = tiny.shrink(json.load(f)["hypes"])
    hypes["model"]["args"]["v2xvit"]["transformer"]["encoder"]["depth"] = 2
    h = reparse(copy.deepcopy(hypes))
    model = build_model(h["model"], max_cav=h["train_params"]["max_cav"])
    model.load_state_dict(wlib.make(wlib.shapes_of(model), 1, "cpu"))
    model.eval()
    with open(os.path.join(root, "benchmark", "traffic",
                           "serve8.json")) as f:
        traffic = tiny.shrink_traffic(json.load(f))
    scene = gen.scenes(hypes, traffic, 3, 1)[0]
    batch = assemble.to_device(assemble.collate(
        [assemble.assemble(hypes, scene, train=False)]), "cpu")
    with torch.inference_mode():
        off = model(batch)
    assert trace.records() == []
    with recording(), torch.inference_mode():
        on = model(batch)
    assert torch.equal(on["cls_preds"], off["cls_preds"])
    recs = trace.records()
    top = [(i, r["name"]) for i, r in enumerate(recs) if r["parent"] == -1]
    assert [n for _, n in top] == ["encoder.lidar", "fusion"]
    fusion = top[1][0]
    assert [r["name"] for r in recs if r["parent"] == fusion] == [
        "v2xvit.hmsa", "v2xvit.mswin", "v2xvit.ffn"] * 2
