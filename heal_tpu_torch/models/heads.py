"""Detection heads: 1x1 conv cls / reg / dir (torch).

Counterpart of heal_tpu/models/heads.py. Runs NCHW inside and returns
the JAX layout, NHWC: cls (B, H, W, A), reg (B, H, W, A*7),
dir (B, H, W, A*num_bins), as postprocess/decode.py expects. The IoU
branch of the CoAlign configs is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv


class DetectionHeads(nn.Module):
    def __init__(self, cin: int, anchor_number: int, use_dir: bool = True,
                 num_bins: int = 2):
        super().__init__()
        self.cls_head = Conv(cin, anchor_number)
        self.reg_head = Conv(cin, 7 * anchor_number)
        self.dir_head = Conv(cin, num_bins * anchor_number) if use_dir else None

    def forward(self, x: torch.Tensor) -> dict:
        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()

        out = {
            "cls_preds": nhwc(self.cls_head(x)),
            "reg_preds": nhwc(self.reg_head(x)),
        }
        if self.dir_head is not None:
            out["dir_preds"] = nhwc(self.dir_head(x))
        return out
