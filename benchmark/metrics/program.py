"""What the per-layer metrics read from the program's own tracer
(heal_tpu_torch/trace.py): its spans and counters, which are on while a
profiler records, so over the traced run's two profiled stretches.

Each reader averages over the device-only stretch alone: the first
``traced_frames`` (serve) or ``traced_steps`` (train) requests recorded,
a request being a served frame (opened by the span ``serve.inputs``) or
a trained step (``train.step``). The host-traced stretch after them is
left out: tracing the host slows it several-fold. Nothing is read where
the program has no tracer or the tracer holds no records."""
from __future__ import annotations

OPENS = {"serve": "serve.inputs", "train": "train.step"}


def requests(ctx) -> list | None:
    """[{"ms": {span: stream ms summed}, "counts": {counter: n}}] of the
    stretch's requests, oldest first; None where nothing was recorded."""
    if "program_requests" not in ctx:
        ctx["program_requests"] = _requests(ctx)
    return ctx["program_requests"]


def _requests(ctx) -> list | None:
    try:
        from heal_tpu_torch import trace
    except ImportError:
        return None
    traffic = (ctx.get("cell") or {}).get("traffic_file") or {}
    mode = traffic.get("mode")
    count = traffic.get("traced_frames" if mode == "serve"
                        else "traced_steps")
    if mode not in OPENS or not count:
        return None
    recs = trace.records()
    ids = []
    for r in recs:
        if r["name"] == OPENS[mode] and r["request"] not in ids:
            ids.append(r["request"])
    ids = ids[:count]
    if not ids:
        return None
    out = {i: {"ms": {}, "counts": {}} for i in ids}
    for r in recs:
        req = out.get(r["request"])
        if req is None:
            continue
        if r["device_ms"] is not None:
            req["ms"][r["name"]] = req["ms"].get(r["name"], 0.0) + \
                r["device_ms"]
        for k, n in r["counts"].items():
            req["counts"][k] = req["counts"].get(k, 0) + n
    return [out[i] for i in ids]


def span_ms(ctx, match) -> float | None:
    """Mean over the stretch's requests of the stream time of the spans
    whose name ``match`` accepts, summed in each request."""
    reqs = requests(ctx)
    if not reqs:
        return None
    found = [sum(v for k, v in r["ms"].items() if match(k)) for r in reqs
             if any(match(k) for k in r["ms"])]
    if not found:
        return None
    return sum(found) / len(reqs)


def host_syncs(ctx) -> float | None:
    """Mean over the stretch's requests of the ``host_sync.*`` counts."""
    reqs = requests(ctx)
    if not reqs:
        return None
    return sum(n for r in reqs for k, n in r["counts"].items()
               if k.startswith("host_sync.")) / len(reqs)
