"""Feature aligner (torch): the ``identity`` backend of
heal_tpu/models/aligner.py ``AlignNet`` (aligner.py:248-252).

The learned aligners (res1x1, res3x3, convnext, scaligner, sdta, cbam,
fanet) are not ported yet and raise.
"""
from __future__ import annotations

import torch
import torch.nn as nn


class AlignNet(nn.Module):
    def __init__(self, args: dict | None):
        super().__init__()
        method = (args or {}).get("core_method", "identity")
        if method != "identity":
            raise NotImplementedError(
                f"aligner core_method {method!r} is not ported (identity)"
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x
