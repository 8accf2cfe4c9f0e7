"""The traced run's instruments, all registered from outside the
program: CUDA-event spans on module calls and methods, a recorder of a
function's argument shapes, and the reduction of a ``torch.profiler``
trace to device busy time, the top device operations and the longest
idle gaps.

The union-of-intervals arithmetic is a frozen copy of
heal_tpu_torch/kernels/measure.py ``device_busy`` at commit 067a829.
"""
from __future__ import annotations

import fnmatch
import functools

import torch


class Spans:
    """Named spans timed by CUDA events. ``on_modules(name, root, glob)``
    times every call of the submodules of ``root`` whose dotted name
    matches ``glob`` (forward pre- and post-hooks); ``on_method(name,
    obj, attr)`` wraps a bound method (a method called directly, which
    module hooks never see). ``frame()`` closes a frame; ``mean_ms()``
    gives each span's device time a frame, summed over its calls, and the
    mean of each host-clock span the caller put in ``host`` (seconds a
    frame, by name)."""

    def __init__(self):
        self.open: dict = {}
        self.frames: list[dict] = []
        self.current: dict = {}
        self.undo: list = []
        self.host: dict = {}

    def _start(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.open.setdefault(name, []).append(e)

    def _stop(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.current.setdefault(name, []).append((self.open[name].pop(), e))

    def on_modules(self, name: str, root: torch.nn.Module, glob: str) -> int:
        hit = 0
        for path, mod in root.named_modules():
            if path and fnmatch.fnmatchcase(path, glob):
                self.undo.append(mod.register_forward_pre_hook(
                    lambda *_: self._start(name)))
                self.undo.append(mod.register_forward_hook(
                    lambda *_: self._stop(name)))
                hit += 1
        return hit

    def on_method(self, name: str, obj, attr: str) -> bool:
        fn = getattr(obj, attr, None)
        if fn is None:
            return False

        def timed(*args, **kwargs):
            self._start(name)
            out = fn(*args, **kwargs)
            self._stop(name)
            return out

        setattr(obj, attr, timed)
        self.undo.append(_Restore(obj, attr))
        return True

    def frame(self):
        self.frames.append(self.current)
        self.current = {}

    def remove(self):
        for u in self.undo:
            u.remove()
        self.undo = []

    def mean_ms(self) -> dict:
        if self.frames and any(self.frames):
            torch.cuda.synchronize()
        total: dict = {}
        for f in self.frames:
            for name, pairs in f.items():
                total[name] = total.get(name, 0.0) + sum(
                    a.elapsed_time(b) for a, b in pairs)
        out = {k: v / max(len(self.frames), 1) for k, v in total.items()}
        out.update({k: 1e3 * sum(v) / len(v) for k, v in self.host.items()})
        return out


class _Restore:
    def __init__(self, obj, attr):
        self.obj, self.attr = obj, attr

    def remove(self):
        delattr(self.obj, self.attr)


class Calls:
    """Records the shapes and dtypes of the tensor arguments of every
    call of ``module.attr`` while installed."""

    def __init__(self, module, attr: str):
        self.module, self.attr = module, attr
        self.fn = getattr(module, attr)
        self.calls: list = []

        def recorded(*args, **kwargs):
            self.calls.append([(tuple(a.shape), a.dtype) for a in args
                               if isinstance(a, torch.Tensor)])
            return self.fn(*args, **kwargs)

        # the function's own attributes (a launch counter) stay reachable
        functools.update_wrapper(recorded, self.fn)
        setattr(module, attr, recorded)

    def remove(self):
        setattr(self.module, self.attr, self.fn)


def union_s(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, None
    for start, stop in sorted(spans):
        if end is None or start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def profile(step, count: int, host: bool = False):
    """``count`` calls of ``step(i)`` under ``torch.profiler``: device
    activity alone, or with ``host`` the host's too, the stretch inside
    the span "traced_window". -> the profiler.

    The device-only stretch is what the device's busy time, its idle
    share and the kernels' times are read from: tracing the host's ops
    slows the host several-fold, which would read as idle device time.
    The host stretch only names the idle gaps."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with prof(activities=activities) as p:
        with torch.profiler.record_function("traced_window"):
            for i in range(count):
                step(i)
            torch.cuda.synchronize()
    return p


def stretch(step, count: int, named: int, recorders=()) -> dict:
    """``reduce_trace`` of ``count`` calls of ``step`` profiled on the
    device alone, with the ``recorders`` (``Calls``) installed over that
    stretch only, and its idle gaps taken from ``named`` more calls
    profiled with the host's spans."""
    try:
        red = reduce_trace(profile(step, count))
    finally:
        for r in recorders:
            r.remove()
    if red:
        red["idle_gaps"] = reduce_trace(
            profile(step, named, host=True)).get("idle_gaps", [])
    return red


def reduce_trace(p, host_spans=("transfer", "forward", "decode_nms",
                                "train_step")) -> dict:
    """-> {"window_s", "busy_s", "kernels" [(name, start_us, dur_us)],
    "device_ops" top 10 [(name, s)], "idle_gaps" top 10 [(name, s)]}.
    Device operations are kernels, copies and fills; the window is the
    host span "traced_window" where the host was traced, else from the
    first device operation's start to the last one's end; a gap between
    device operations is named by the benchmark span the host was in at
    its start ("host" where the host was not traced)."""
    from torch.autograd import DeviceType

    events = p.events()
    # the profiler mirrors each record_function range on the device's
    # timeline; those are no device work
    spans = set(host_spans) | {"traced_window"}
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)
                 and e.name not in spans)
    win = [e for e in events if e.name == "traced_window"
           and e.device_type == DeviceType.CPU]
    if win:
        w0, w1 = win[0].time_range.start, win[0].time_range.end
        dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    elif dev:
        w0, w1 = dev[0][0], max(b for _, b, _ in dev)
    else:
        return {}
    if not dev:
        return {"window_s": (w1 - w0) / 1e6, "busy_s": 0.0, "kernels": [],
                "device_ops": [], "idle_gaps": []}
    clipped = [(max(a, w0), min(b, w1)) for a, b, _ in dev]
    by_name: dict = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CPU
                  and e.name in host_spans)
    gaps, end = [], w0
    for a, b, _ in dev:
        if a > end:
            gaps.append((a - end, end))
        end = max(end, b)
    if w1 > end:
        gaps.append((w1 - end, end))
    named = []
    for length, at in sorted(gaps, reverse=True)[:10]:
        inside = [n for a, b, n in host if a <= at < b]
        named.append([inside[-1] if inside else "host", length / 1e6])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": union_s(clipped) / 1e6,
        "kernels": [(n, a, b - a) for a, b, n in dev],
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": named,
    }
