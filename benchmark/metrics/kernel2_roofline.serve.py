"""Kernel 2's share of its roofline over the profiled frames: the least
time every row and column shift needs (benchmark/work/kernels.py, each
call's image shape as recorded at ``ops/shift_rows.shift_rows`` /
``shift_cols``) over the device time of the kernels in the trace."""
from benchmark.metrics import shift_roofline


def read(ctx):
    return shift_roofline(ctx, backward=False)
