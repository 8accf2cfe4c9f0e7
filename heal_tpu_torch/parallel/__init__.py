"""Training runtime (torch): optimizer and LR schedule from the config,
and the train / eval steps. One device; no mesh yet."""
from .schedulers import build_lr_schedule, build_optimizer
from .trainer import Trainer, pin, to_device

__all__ = ["Trainer", "build_lr_schedule", "build_optimizer", "pin",
           "to_device"]
