"""Spans and counters of the port.

Spans are on exactly while a ``torch.profiler`` (or autograd profiler)
session records, and off otherwise: there is no other switch. Open any
profiler session (``torch.profiler.profile``, TensorBoard's handler,
tools/profile_second.py) and the program's spans appear on its
timeline beside the device's work, and in :func:`records`.

  * ``span(name)``: off, the one shared no-op context, after a single
    attribute read (no CUDA event, no record, no ``record_function``).
    On, it enters ``torch.profiler.record_function(name)`` (the span sits
    on the profiler's timeline, on its clock), records a CUDA event on
    the current stream at its start and end (where the process uses
    CUDA), and appends a record: the name, the host clock
    (``perf_counter_ns``) at start and end, the event pair, the index of
    the enclosing span's record, the request id, and the counts made
    while it was the innermost open span. The buffer holds ``LIMIT``
    records; later spans still enter ``record_function`` but add no
    record (``counters()["trace.dropped"]`` counts them).
  * ``request(name)``: opens a new request id (a served frame in
    ``tools/inference.frame_inputs``, a trained step in
    ``Trainer.train_step``), then ``span(name)``. Every span and count
    after it carries that id until the next one opens.
  * ``count(name, n=1)``: always adds ``n`` to the process's totals
    (:func:`counters`); while spans are on, also to the innermost open
    span's record, or where none is open to the request's own record
    (named ``request``, without times).
  * :func:`records` resolves the events' device times (one synchronize)
    and returns the records as dicts; :func:`clear` drops them and
    zeroes the counters.

There is no exporter: the records stay in memory, and the profiler's
own trace export (``export_chrome_trace``) is the file form. Spans and
counts belong to the thread that serves or trains.

Counters the port keeps (each named where it counts):

  * ``kernel1.launches``, ``kernel2.launches``,
    ``kernel2.backward_launches``, ``kernel3.launches``,
    ``kernel4.launches``: launches of the hand-written kernels
    (ops/pillar.py, ops/shift_rows.py, ops/column_conv.py,
    ops/window_attention.py);
  * ``host_sync.<site>``: each place where the host waits for the
    device on a CUDA device (counted on every device): ``h2d``, a
    pageable host->device copy (the frame's inputs, the camera's
    field-of-view masks); ``const``, a small constant built from a
    Python list on the device each call (a pageable copy too); ``nms``,
    each readback of the NMS fixpoint; ``to_host``, each copy of the
    kept detections to the host (``strip_padding``).
"""
from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _profiler

LIMIT = 1 << 16


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Tracer:
    """The records, the open spans and the counters of one process."""

    def __init__(self):
        self.limit = LIMIT
        self.totals: dict = {}
        self.request = 0
        self.recs: list = []
        self.open: list = []  # the open spans' records (None: not kept)
        self.loose = (None, None)  # (request id, that request's record)

    def record(self, name: str, start_ns, events):
        """A new record, or None where the buffer is full."""
        if len(self.recs) >= self.limit:
            self.totals["trace.dropped"] = self.totals.get(
                "trace.dropped", 0) + 1
            return None
        parent = next((r["index"] for r in reversed(self.open)
                       if r is not None), -1)
        rec = {"index": len(self.recs), "name": name,
               "request": self.request, "parent": parent,
               "start_ns": start_ns, "end_ns": None, "events": events,
               "device_ms": None, "counts": {}}
        self.recs.append(rec)
        return rec

    def add(self, name: str, n: int) -> None:
        """``n`` more of counter ``name`` in the innermost open span's
        record, or with none open in the request's own record."""
        if self.open:
            rec = self.open[-1]
        else:
            request, rec = self.loose
            if request != self.request:
                rec = self.record("request", None, None)
                self.loose = (self.request, rec)
        if rec is not None:
            rec["counts"][name] = rec["counts"].get(name, 0) + n


class Span:
    """A span while spans are on (see the module's docstring)."""

    __slots__ = ("name", "fn", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.fn = _profiler.record_function(self.name)
        self.fn.__enter__()
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        self.rec = TRACER.record(self.name, time.perf_counter_ns(), events)
        TRACER.open.append(self.rec)
        return None

    def __exit__(self, *exc):
        TRACER.open.pop()
        rec = self.rec
        if rec is not None:
            rec["end_ns"] = time.perf_counter_ns()
            if rec["events"] is not None:
                rec["events"][1].record()
        self.fn.__exit__(*exc)
        return False


TRACER = Tracer()


def span(name: str):
    """A span named ``name`` while spans are on, else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return Span(name)


def request(name: str):
    """A new request id, then ``span(name)``."""
    TRACER.request += 1
    return span(name)


def count(name: str, n: int = 1) -> None:
    """``n`` more of counter ``name``: in the process's totals always,
    and while spans are on in the innermost open span's record."""
    totals = TRACER.totals
    totals[name] = totals.get(name, 0) + n
    if _profiler._is_profiler_enabled:
        TRACER.add(name, n)


def counters() -> dict:
    """A copy of the process's counter totals."""
    return dict(TRACER.totals)


def records() -> list:
    """The records, oldest first, as dicts: ``name``, ``request``,
    ``parent`` (the enclosing span's index in this list, or -1),
    ``start_ns`` / ``end_ns`` (host ``perf_counter_ns``; None for a
    request's own record and for a span still open), ``device_ms`` (the
    stream time between the span's events; None without CUDA or while
    open) and ``counts``."""
    recs = TRACER.recs
    done = [r for r in recs if r["events"] is not None
            and r["end_ns"] is not None]
    if done:
        torch.cuda.synchronize()
        for r in done:
            r["device_ms"] = r["events"][0].elapsed_time(r["events"][1])
            r["events"] = None
    return [{k: (dict(v) if k == "counts" else v) for k, v in r.items()
             if k not in ("index", "events")} for r in recs]


def clear() -> None:
    """Drop the records and zero the counters (spans open now add no
    record)."""
    t = TRACER
    t.recs, t.totals, t.loose = [], {}, (None, None)
    t.open = [None] * len(t.open)
