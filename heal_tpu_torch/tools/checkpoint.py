"""Checkpoints: the port's ``torch.save``d state_dicts, and heal_tpu's.

Counterpart of heal_tpu/tools/checkpoint.py. The port writes state_dicts
with the bridged key names (utils/bridge.py): ``net_epoch{E}.pth`` every
save_freq epochs and one ``net_epoch_bestval_at{E}.pth`` tracking the best
validation loss. It reads those and heal_tpu's ``net_epoch*.ckpt`` (flax
msgpack of ``{"params", "batch_stats", "epoch"}``), which
:func:`load_state_dict` turns into the same state_dict through
utils/flax_msgpack.py and ``bridge.from_flax``, without jax.

HEAL's protocol rests on two operations on them: the LOOSE load
(:func:`loose_load`: entries whose key and shape match are taken, the
rest reported) and the stage-3 merge (:func:`merge_checkpoints`: a union
of state_dicts, later files winning).
"""
from __future__ import annotations

import os
import re

import torch

from ..parallel.sharding import full_state_dict

_NAME = re.compile(r"net_epoch(_bestval_at)?(\d+)\.(pth|ckpt)")


def save_checkpoint(model_dir: str, model, epoch: int,
                    bestval: bool = False, mesh=None) -> str:
    """Write ``model``'s state_dict (or a state_dict) in f32 on the CPU;
    -> its path. Under a device mesh (``mesh``, a ``model`` placed by
    parallel/sharding.shard_state) every rank calls it: the model-sharded
    weights are gathered into the one-device layout, and rank 0 writes."""
    if mesh is not None:
        model = full_state_dict(model)
    name = (f"net_epoch_bestval_at{epoch}.pth" if bestval
            else f"net_epoch{epoch}.pth")
    path = os.path.join(model_dir, name)
    if mesh is not None and mesh.rank != 0:
        return path
    os.makedirs(model_dir, exist_ok=True)
    if bestval:
        for old in os.listdir(model_dir):
            if old.startswith("net_epoch_bestval_at"):
                os.remove(os.path.join(model_dir, old))
    sd = model.state_dict() if isinstance(model, torch.nn.Module) else model
    torch.save({k: v.detach().float().cpu() for k, v in sd.items()}, path)
    return path


def find_checkpoint(model_dir: str):
    """-> (epoch, path): the bestval checkpoint if there is one, else the
    newest epoch's; (0, None) if the directory holds none. JAX's
    ``find_checkpoint`` picks so for resume, inference and merge alike. A
    port ``.pth`` wins over a heal_tpu ``.ckpt`` of the same name."""
    found = []
    for name in os.listdir(model_dir):
        m = _NAME.fullmatch(name)
        if m:
            is_best, epoch = bool(m.group(1)), int(m.group(2))
            key = (is_best, epoch, m.group(3) == "pth")
            found.append((key, epoch, os.path.join(model_dir, name)))
    if not found:
        return 0, None
    _, epoch, path = max(found)
    return epoch, path


def load_state_dict(path: str) -> dict:
    """The port state_dict (f32 CPU tensors) of a ``.pth`` or of a
    heal_tpu ``.ckpt``."""
    if path.endswith(".ckpt"):
        from ..utils.bridge import from_flax
        from ..utils.flax_msgpack import read

        tree = read(path)
        return from_flax(tree.get("params", {}), tree.get("batch_stats", {}))
    return torch.load(path, map_location="cpu", weights_only=True)


def loose_load(model: torch.nn.Module, path: str,
               verbose: bool = True) -> list[str]:
    """Load the entries of a checkpoint whose key and shape match the
    model (HEAL's partial load); -> the checkpoint keys left out, a shape
    mismatch marked " (shape mismatch)" (JAX ``loose_update``)."""
    src = load_state_dict(path)
    own = model.state_dict()
    take, left = {}, []
    for k, v in src.items():
        if k not in own:
            left.append(k)
        elif own[k].shape != v.shape:
            left.append(f"{k} (shape mismatch)")
        else:
            take[k] = v
    model.load_state_dict(take, strict=False)
    if verbose and left:
        print(f"[checkpoint] {len(left)} source keys not loaded:")
        for k in left[:10]:
            print("   ", k)
    return left


def merge_checkpoints(paths: list, drop_prefixes=(),
                      verbose: bool = True) -> dict:
    """HEAL stage-3 merge: union of state_dicts, later files win (the
    base comes last). ``drop_prefixes``: keys whose first dotted component
    starts with one of them are dropped from every file but the last
    (JAX drops those top-level subtrees from the non-base checkpoints)."""
    merged: dict = {}
    for i, path in enumerate(paths):
        src = load_state_dict(path)
        if i < len(paths) - 1:
            src = {k: v for k, v in src.items()
                   if not k.split(".", 1)[0].startswith(tuple(drop_prefixes))}
        if verbose:
            added = sum(k not in merged for k in src)
            print(f"[merge] {os.path.basename(path)}: +{added} "
                  f"~{len(src) - added}")
        merged.update(src)
    return merged
