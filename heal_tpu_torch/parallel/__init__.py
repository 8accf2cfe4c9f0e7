"""Training runtime (torch): optimizer and LR schedule from the config,
the train / eval steps, and the (data, agent, model) device mesh over
torch.distributed (sharding.py)."""
from .schedulers import build_lr_schedule, build_optimizer
from .trainer import Trainer, pin, to_device

__all__ = ["Trainer", "build_lr_schedule", "build_optimizer", "pin",
           "to_device"]
