"""Device timing and the H100's bound, for chip_smoke.py and the kernel
A/B (tools/kernel_ab.py). Nothing here runs at import time."""
from __future__ import annotations

# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call: CUDA events around ``iters`` calls queued
    behind a spin kernel (~10 ms), so that the host's launch rate does not
    bound the reading (a call that synchronises still pays its host
    time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn) -> list[str]:
    """The names of the device kernels (and copies or fills) that one call
    of ``fn`` puts on the card, from ``torch.profiler``'s CUPTI trace. The
    call runs under ``torch.cuda.set_sync_debug_mode("error")``, so a call
    that makes PyTorch synchronise with the host raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_busy(fn) -> dict:
    """One call of ``fn`` traced with ``torch.profiler``: ``busy_ms``, the
    time the card spent in the call's device kernels, copies and fills
    (the union of their intervals), ``wall_ms``, the call's host time
    under the trace (synchronised), and ``device_ops``, their count.
    Raises if the trace holds no device operation."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("the trace holds no device operation")
    busy_us, end = 0.0, spans[0][0]
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return {"busy_ms": busy_us / 1e3, "wall_ms": wall * 1e3,
            "device_ops": len(spans)}


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    """The least time for the work on an H100 SXM (ms) and what sets it:
    the bytes (each input read once, each output written once) over the
    memory rate, or the f32 operations over their rate outside the tensor
    cores."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
