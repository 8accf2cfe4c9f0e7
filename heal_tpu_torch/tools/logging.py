"""Training metric logging.

The port's copy of heal_tpu/tools/logging.py: scalars go to
``train_log.jsonl`` in the run dir, and to TensorBoard when tensorboardX
is importable.
"""
from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, model_dir: str):
        self.path = os.path.join(model_dir, "train_log.jsonl")
        self.tb = None
        try:
            from tensorboardX import SummaryWriter  # optional

            self.tb = SummaryWriter(os.path.join(model_dir, "tb"))
        except ImportError:
            pass

    def log(self, step: int, scalars: dict):
        record = {"step": step, "time": time.time(), **scalars}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.tb is not None:
            for key, value in scalars.items():
                self.tb.add_scalar(key, value, step)
