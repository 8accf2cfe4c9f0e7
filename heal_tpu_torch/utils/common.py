"""Torch counterparts of the device-side helpers in heal_tpu.utils.common.

``heal_tpu.utils.common.limit_period`` sends any non-numpy input to
jax.numpy, so the port keeps its own version for tensors.
"""
from __future__ import annotations

import math

import torch


def limit_period(
    val: torch.Tensor, offset: float = 0.5, period: float = 2 * math.pi
) -> torch.Tensor:
    """Wrap ``val`` into ``[-offset*period, (1-offset)*period)``."""
    return val - torch.floor(val / period + offset) * period
