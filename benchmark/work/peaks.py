"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates), and the least time a piece of work can take.

Frozen copy of heal_tpu_torch/kernels/measure.py (``HBM_BYTES_PER_S``,
``F32_FLOP_PER_S``, ``bound``) at commit 067a829. The benchmark runs in
f32 with TF32 off, so the compute peak is the f32 rate outside the
tensor cores.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the f32
    operations over their rate, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
