"""Device-side operators (torch). Four sit in front of the hand-written
CUDA kernels (:data:`KERNELS`): each alone chooses between its kernel and
its plain PyTorch version, and launches through kernels/build.py."""
from __future__ import annotations

import contextlib
from types import ModuleType
from typing import NamedTuple

from . import column_conv, pillar, shift_rows, window_attention


class Kernel(NamedTuple):
    """One kernel behind its op: ``module`` holds ``launch``, the function
    that launches it, and, with ``launch``'s arguments, ``plain``, its
    plain version, and ``ops``, the operations the profiler counts apart
    for one call."""

    name: str
    module: ModuleType
    launch: str
    plain: str
    ops: str


KERNELS = (
    Kernel("pillar_tables", pillar, "pillar_tables", "pillar_tables_plain",
           "pillar_ops"),
    # the one-direction launcher, which shift_rows' autograd function
    # calls forward with s and backward with -s
    Kernel("shift_rows", shift_rows, "_shift", "_shift_plain", "shift_ops"),
    Kernel("column_conv", column_conv, "column_conv_layer",
           "column_conv_layer_plain", "column_conv_ops"),
    Kernel("window_attention", window_attention, "window_attention",
           "window_attention_plain", "window_attention_ops"),
)


@contextlib.contextmanager
def launches_replaced(replace):
    """Within the block each kernel's ``launch`` attribute is
    ``replace(kernel)``, called with the attribute as it stood; restored
    afterwards."""
    saved = [getattr(k.module, k.launch) for k in KERNELS]
    try:
        for k in KERNELS:
            setattr(k.module, k.launch, replace(k))
        yield
    finally:
        for k, fn in zip(KERNELS, saved):
            setattr(k.module, k.launch, fn)
