"""Stage freezing (HEAL stage 2): the base's modules stay at their
loaded values while a new agent type trains.

Counterpart of heal_tpu/parallel/freezing.py, which masks the optimizer
(``optax.multi_transform`` with ``set_to_zero`` for the frozen subtrees)
and restores their batch statistics (``freeze_stats``). Here:

  * :func:`freeze` sets ``requires_grad_(False)`` on every parameter of
    the frozen top-level modules, and the optimizer is built from
    :func:`trainable_parameters` only, so no update, and no weight-decay
    term of Adam's, can reach them (``Trainer`` refuses an optimizer that
    holds one). Gradients still flow THROUGH them into the modules
    before them;
  * :func:`frozen_eval` puts the frozen modules in eval mode after
    ``model.train()``: their batch norms use the running statistics and
    never write them (the ``freeze_stats`` equivalent).
"""
from __future__ import annotations

import torch


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def freeze(model: torch.nn.Module, fix_modules) -> list[str]:
    """``requires_grad_(False)`` on the parameters of ``fix_modules``
    (top-level module names); -> the names of the frozen parameters."""
    fix = set(fix_modules)
    frozen = []
    for name, p in model.named_parameters():
        if _top(name) in fix:
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


def trainable_parameters(model: torch.nn.Module) -> list:
    """The parameters the optimizer may hold."""
    return [p for p in model.parameters() if p.requires_grad]


def frozen_eval(model: torch.nn.Module, fix_modules) -> None:
    """Eval mode for the frozen modules (call after ``model.train()``)."""
    for name in fix_modules:
        module = getattr(model, name, None)
        if module is not None:
            module.eval()
