"""Detection heads: 1x1 conv cls / reg / dir (torch).

Counterpart of heal_tpu/models/heads.py. Runs NCHW inside and returns
the JAX layout, NHWC: cls (B, H, W, A), reg (B, H, W, A*7),
dir (B, H, W, A*num_bins), as postprocess/decode.py expects; with
``use_iou`` also iou (B, H, W, A), the IoU-quality branch (``iou_head``)
that the loss's ``iou`` term trains.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .layers import Conv


class DetectionHeads(nn.Module):
    def __init__(self, cin: int, anchor_number: int, use_dir: bool = True,
                 num_bins: int = 2, use_iou: bool = False):
        super().__init__()
        self.cls_head = Conv(cin, anchor_number)
        self.reg_head = Conv(cin, 7 * anchor_number)
        self.dir_head = Conv(cin, num_bins * anchor_number) if use_dir else None
        self.iou_head = Conv(cin, anchor_number) if use_iou else None

    def forward(self, x: torch.Tensor) -> dict:
        def nhwc(t):
            return t.permute(0, 2, 3, 1).contiguous()

        out = {
            "cls_preds": nhwc(self.cls_head(x)),
            "reg_preds": nhwc(self.reg_head(x)),
        }
        if self.dir_head is not None:
            out["dir_preds"] = nhwc(self.dir_head(x))
        if self.iou_head is not None:
            out["iou_preds"] = nhwc(self.iou_head(x))
        return out
