"""The card's idle share of the profiled steps after the window: one
minus the union of its kernels', copies' and fills' intervals over the
stretch from the first to the last of them, profiled on the device alone
(``trace.stretch``: tracing the host would slow it and read as idle)."""
from benchmark.metrics import idle as read  # noqa: F401
