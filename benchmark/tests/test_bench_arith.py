"""The arithmetic of the metrics: tails over every frame, the idle share
over the union of device intervals, MFU and the rooflines."""
from __future__ import annotations

import argparse
import os

import numpy as np
import pytest

from benchmark import harness, trace
from benchmark.work import kernels, peaks


def test_union_of_intervals():
    assert trace.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_s([(5, 6), (0, 10)]) == 10
    assert trace.union_s([]) == 0


def test_idle_share_is_one_minus_the_union_over_the_window():
    read = harness.module("metrics", "device_idle.serve").read
    assert read({"trace": {"window_s": 2.0, "busy_s": 1.5}}) == \
        pytest.approx(25.0)
    assert read({"trace": {}}) is None


class _Event:
    def __init__(self, name, start, end, device, annotation=False):
        from types import SimpleNamespace

        from torch.autograd import DeviceType

        self.name = name
        self.time_range = SimpleNamespace(start=start, end=end)
        self.device_type = getattr(DeviceType, device)
        self.is_user_annotation = annotation


class _Profile:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_only_trace_spans_its_first_to_its_last_device_op():
    """Without the host traced the window runs from the first device
    operation to the last; a record_function range mirrored on the
    device is no work; gaps are named "host"."""
    red = trace.reduce_trace(_Profile([
        _Event("k1", 100, 300, "CUDA"), _Event("k2", 200, 400, "CUDA"),
        _Event("forward", 100, 900, "CUDA", annotation=True),
        _Event("k3", 600, 1100, "CUDA")]))
    assert red["window_s"] == pytest.approx(1000e-6)
    assert red["busy_s"] == pytest.approx(800e-6)
    assert red["idle_gaps"] == [["host", pytest.approx(200e-6)]]
    assert [n for n, _ in red["device_ops"]] == ["k3", "k1", "k2"]


def test_host_traced_window_names_the_gaps_by_the_host_span():
    red = trace.reduce_trace(_Profile([
        _Event("traced_window", 0, 1000, "CPU"),
        _Event("forward", 0, 500, "CPU"),
        _Event("decode_nms", 500, 1000, "CPU"),
        _Event("k1", 100, 300, "CUDA"), _Event("k2", 700, 800, "CUDA"),
        _Event("k0", -50, -10, "CUDA")]))
    assert red["window_s"] == pytest.approx(1000e-6)
    assert red["busy_s"] == pytest.approx(300e-6)
    assert red["idle_gaps"] == [["forward", pytest.approx(400e-6)],
                                ["decode_nms", pytest.approx(200e-6)],
                                ["forward", pytest.approx(100e-6)]]


def test_p95_is_over_every_frame():
    """Every frame of the window counts: the slow tenth moves the tail
    and the rate takes the whole window."""
    from benchmark import serve

    fast = serve.end_to_end([0.01] * 100, 1.0, 5.0)
    slow = serve.end_to_end([0.01] * 90 + [0.1] * 10, 1.0, 5.0)
    assert fast["serve_p95_ms"] == pytest.approx(10.0)
    assert slow["serve_p95_ms"] == pytest.approx(100.0)
    assert slow["serve_frames_per_s"] == 100.0 and slow["setup_s"] == 5.0


def test_mfu_is_flops_over_time_a_frame_over_the_peak():
    # 6.7e11 FLOPs in 0.1 s is 6.7e12 FLOP/s, a tenth of 67e12
    ctx = {"flops_per_item": 6.7e11, "frames": 100, "window_s": 10.0}
    for name in ("mfu.serve", "mfu.train"):
        assert harness.module("metrics", name).read(ctx) == \
            pytest.approx(10.0)


def test_kernel2_roofline_counts_each_call_read_once_written_once():
    w = kernels.shift_work((4, 292, 292, 65), 4, 0)
    assert w["bytes"] == 2 * 4 * 292 * 292 * 65 * 4 + 4 * 292 * 4
    read = harness.module("metrics", "kernel2_roofline.serve").read
    t = peaks.bound_s(w["bytes"], w["flops"])
    ctx = {"trace": {"kernels": [("shift_rows_kernel<float>", 0, 2 * t * 1e6)]},
           "shift_calls": {"rows": [[((4, 292, 292, 65), "torch.float32"),
                                     ((4, 292), "torch.float32")]],
                           "cols": []}}
    assert read(ctx) == pytest.approx(50.0)
    ctx["shift_calls"]["cols"] = [[((4, 8, 8, 1), "torch.float32")]]
    assert read(ctx) is None  # a call without its launch: nothing read


def test_kernel1_work_counts_landed_points_and_the_whole_canvas():
    rng = [-4.0, -2.0, -3.0, 4.0, 2.0, 1.0]
    pts = np.zeros((2, 4, 4), np.float32)
    pts[0, :3, :3] = [[0.1, 0.1, 0], [0.2, 0.1, 0], [3.9, 1.9, 0]]
    pts[0, 3, :3] = [9.0, 0, 0]            # out of range
    mask = np.array([[1, 1, 1, 1], [0, 0, 0, 0]], bool)
    w = kernels.pillar_work(pts, mask, rng, [0.4, 0.4, 4], 8)
    cells = 20 * 10
    assert w["bytes"] == 3 * (8 * 4 + 20) + 7 * 8 * 4 + 2 * cells * 8 * 4
    assert w["flops"] == 3 * 12 + 2 * 8 * 14


def test_verdict_needs_every_number_within_its_limit():
    ok, checks = harness.verdict({"a": 1.0, "b": float("nan")},
                                 {"a": 2.0, "b": 1.0})
    assert not ok and checks["a"] == {"value": 1.0, "limit": 2.0}
    assert harness.verdict({"a": 1.0}, {"a": 1.0})[0]
    assert not harness.verdict({}, {"a": 1.0})[0]


def test_run_refuses_without_a_card(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "flagship.serve", "--seed", "1",
                  "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_args_take_seeds_past_32_bits():
    from benchmark import run

    args = run.parse(["--workload", "x", "--seed", str(2 ** 31 + 12345),
                      "--seconds", "1"])
    assert isinstance(args, argparse.Namespace)
    assert args.seed == 2 ** 31 + 12345 and args.trace == 0


def test_run_refuses_without_the_program(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files:
    no result, a non-zero exit."""
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "flagship.serve", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "heal_tpu_torch" in r.stderr


def test_host_spans_are_means_a_frame_in_ms():
    spans = trace.Spans()
    spans.host["decode_nms"] = [0.004, 0.006]
    assert spans.mean_ms() == {"decode_nms": pytest.approx(5.0)}
