"""Optimizer + LR schedule from the config (torch).

Counterpart of heal_tpu/parallel/schedulers.py. The schedule is a plain
function of the update count, stepped per ITERATION with its boundaries
at ``epoch * steps_per_epoch``, exactly as the optax schedules count:
update k (from 0) uses ``schedule(k)``, the count before the increment.
The trainer writes it into the optimizer before every step.

Optimizers: Adam with ``weight_decay`` is torch-Adam L2 (the decay folded
into the gradient), which is what ``optax.chain(add_decayed_weights,
adam)`` computes, with the same eps placement (outside the square root);
AdamW decays the weights directly, as ``optax.adamw``; SGD with momentum
and L2, as ``optax.chain(add_decayed_weights, sgd)``.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def build_lr_schedule(opt_cfg: dict, sched_cfg: dict | None,
                      steps_per_epoch: int) -> Callable[[int], float]:
    """-> schedule(count) = the learning rate of update ``count``."""
    base_lr = float(opt_cfg["lr"])
    sched_cfg = sched_cfg or {}
    method = sched_cfg.get("core_method", "multistep")
    if method == "step":
        every = sched_cfg["step_size"] * steps_per_epoch
        gamma = sched_cfg.get("gamma", 0.1)
        return lambda count: base_lr * gamma ** (count // every)
    if method == "multistep":
        gamma = sched_cfg.get("gamma", 0.1)
        # a set, as optax's boundary dict: equal boundaries decay once
        bounds = {int(e) * steps_per_epoch for e in sched_cfg["step_size"]}
        return lambda count: base_lr * gamma ** sum(count >= b for b in bounds)
    if method == "exponential":
        gamma = sched_cfg.get("gamma", 0.98)
        return lambda count: base_lr * gamma ** (count / steps_per_epoch)
    raise KeyError(f"unknown lr_scheduler {method!r}")


def build_optimizer(params: Iterable[torch.nn.Parameter], opt_cfg: dict,
                    sched_cfg: dict | None, steps_per_epoch: int):
    """-> (optimizer, schedule) for the model's parameters."""
    schedule = build_lr_schedule(opt_cfg, sched_cfg, steps_per_epoch)
    name = opt_cfg.get("core_method", "Adam").lower()
    args = opt_cfg.get("args", {}) or {}
    wd = float(args.get("weight_decay", 0.0))
    eps = float(args.get("eps", 1e-8))
    lr = schedule(0)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, eps=eps, weight_decay=wd)
    elif name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, eps=eps, weight_decay=wd)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=args.get("momentum", 0.9),
                              weight_decay=wd)
    else:
        raise KeyError(f"unknown optimizer {name!r}")
    return opt, schedule
