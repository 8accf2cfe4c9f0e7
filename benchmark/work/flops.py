"""Model FLOPs: the products ``torch.utils.flop_counter.FlopCounterMode``
counts (convolutions, matrix products) over the benchmark's own plain
reference, so that the count does not move when the program changes
(the method of heal_tpu_torch/tools/profiler.py ``flop_count`` at commit
067a829)."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(fn) -> int:
    """FLOPs of one call of ``fn`` (a forward, or a forward and its
    backward)."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
