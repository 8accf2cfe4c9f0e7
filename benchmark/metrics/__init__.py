"""One reader a per-layer metric, ``<metric name>.py``: ``read(ctx)``
returns the value, or None where the traced run holds nothing to read.
A reader that needs spans declares them in ``SPANS``: (span name,
submodule glob or dotted path, ``__call__`` or a method name). The
arithmetic the serve and train readers share is here."""
from __future__ import annotations

from benchmark.work import kernels, peaks


def mfu(ctx):
    """The reference's FLOPs a frame or step over the window's time a
    frame or step, over the f32 peak, in %."""
    if not ctx.get("flops_per_item") or not ctx.get("frames"):
        return None
    per = ctx["window_s"] / ctx["frames"]
    return 100.0 * ctx["flops_per_item"] / per / peaks.F32_FLOP_PER_S


def idle(ctx):
    """One minus the union of the device operations' intervals over the
    profiled stretch, in %."""
    red = ctx.get("trace")
    if not red or not red.get("window_s") or not red.get("busy_s"):
        return None
    return 100.0 * (1.0 - red["busy_s"] / red["window_s"])


def shift_roofline(ctx, backward: bool):
    """Kernel 2: the bound of every recorded row and column shift (each
    twice with ``backward``: the backward launch shifts the output
    gradient, of the forward's shape) over the device time of the
    kernels below, in %; None unless launches and calls pair."""
    names = ("shift_rows_kernel", "shift_cols_kernel")
    red = ctx.get("trace") or {}
    runs = [d for n, _, d in red.get("kernels", ())
            if any(k in n for k in names)]
    calls = ctx.get("shift_calls") or {}
    if not runs or not calls:
        return None
    reps = 2 if backward else 1
    bound, count = 0.0, 0
    for axis, key in ((0, "rows"), (1, "cols")):
        for shapes in calls.get(key, ()):
            shape, dtype = shapes[0]
            w = kernels.shift_work(shape, 2 if "bfloat16" in str(dtype)
                                   else 4, axis)
            bound += reps * peaks.bound_s(w["bytes"], w["flops"])
            count += reps
    if len(runs) != count:
        return None
    return 100.0 * bound / (sum(runs) / 1e6)
