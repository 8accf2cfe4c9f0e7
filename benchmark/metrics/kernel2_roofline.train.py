"""Kernel 2's share of its roofline over the profiled steps, forward and
backward launches: each recorded call's bound counted twice, over the
device time of the kernels in the trace."""
from benchmark.metrics import shift_roofline


def read(ctx):
    return shift_roofline(ctx, backward=True)
