"""Port checkpoints: ``torch.save``d state_dicts with the bridged key names.

Counterpart of heal_tpu/tools/checkpoint.py for the port's own format
(flax-msgpack import is a later port item). File names as in JAX:
``net_epoch{E}.pth`` every save_freq epochs and one
``net_epoch_bestval_at{E}.pth`` tracking the best validation loss.
"""
from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"net_epoch(_bestval_at)?(\d+)\.pth")


def save_checkpoint(model_dir: str, model: torch.nn.Module, epoch: int,
                    bestval: bool = False) -> str:
    """Write the model's state_dict (f32, on the CPU); -> its path."""
    os.makedirs(model_dir, exist_ok=True)
    if bestval:
        for old in os.listdir(model_dir):
            if old.startswith("net_epoch_bestval_at"):
                os.remove(os.path.join(model_dir, old))
    name = (f"net_epoch_bestval_at{epoch}.pth" if bestval
            else f"net_epoch{epoch}.pth")
    path = os.path.join(model_dir, name)
    torch.save({k: v.detach().float().cpu()
                for k, v in model.state_dict().items()}, path)
    return path


def find_checkpoint(model_dir: str, best: bool = False):
    """-> (epoch, path): with ``best`` the bestval checkpoint if there is
    one (inference, as JAX picks it), else the newest (resume); (0, None)
    if the directory holds none."""
    found = []
    for name in os.listdir(model_dir):
        m = _NAME.fullmatch(name)
        if m:
            is_best, epoch = bool(m.group(1)), int(m.group(2))
            # resume: newest epoch, the regular file at a tie
            key = (is_best, epoch) if best else (epoch, not is_best)
            found.append((key, epoch, os.path.join(model_dir, name)))
    if not found:
        return 0, None
    _, epoch, path = max(found)
    return epoch, path


def loose_load(model: torch.nn.Module, path: str) -> list[str]:
    """Load the entries of a checkpoint whose key and shape match the
    model (HEAL's partial load); -> the checkpoint keys left out."""
    src = torch.load(path, map_location="cpu", weights_only=True)
    own = model.state_dict()
    take = {k: v for k, v in src.items()
            if k in own and own[k].shape == v.shape}
    model.load_state_dict(take, strict=False)
    return sorted(set(src) - set(take))
