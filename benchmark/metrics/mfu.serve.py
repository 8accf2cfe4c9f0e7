"""Whole frame's share of the f32 peak: the FLOPs FlopCounterMode counts
in the reference's forward on the cell's first frame, over the window's
time a frame, over 67 TFLOP/s (NVIDIA H100 SXM, f32 outside the tensor
cores)."""
from benchmark.metrics import mfu as read  # noqa: F401
