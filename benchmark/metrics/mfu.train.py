"""Whole step's share of the f32 peak: the FLOPs FlopCounterMode counts
in the reference's forward, loss and backward on the cell's first batch,
over the window's time a step, over 67 TFLOP/s."""
from benchmark.metrics import mfu as read  # noqa: F401
