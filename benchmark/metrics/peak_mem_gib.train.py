"""The process's peak of allocated device memory, from
``torch.cuda.max_memory_allocated()`` after the window, in GiB."""


def read(ctx):
    peak = ctx.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
