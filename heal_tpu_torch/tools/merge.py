"""HEAL stage 3: merge the agent types' checkpoints into one alliance.

Counterpart of heal_tpu/tools/merge.py. ``merge_final`` takes each run
dir's best checkpoint (bestval, else the newest; ``.pth`` or heal_tpu
``.ckpt``), drops the shared modules (``DROP_FROM_NEW_TYPES``) from the
new agent types' state_dicts, and unions them with the collaboration
base's, which comes last and so wins on any overlap. The result is
``<out>/net_epoch_bestval_at0.pth``, and the base's config is copied
beside it as the starting point of the final inference config.

    python -m heal_tpu_torch.tools.merge merge_final m4_dir [...] m1_base_dir out_dir
    python -m heal_tpu_torch.tools.merge rename net.pth old=new [...]
"""
from __future__ import annotations

import argparse
import os
import shutil

import torch

from . import checkpoint as ckpt_lib

# the new types' stage-2 runs carry frozen copies of these; the base's win
DROP_FROM_NEW_TYPES = ("pyramid_backbone", "shrink", "heads")


def best_ckpt(model_dir: str) -> str:
    _, path = ckpt_lib.find_checkpoint(model_dir)
    if not path:
        raise FileNotFoundError(f"no checkpoint under {model_dir}")
    return path


def merge_final(new_type_dirs: list, base_dir: str, output_dir: str) -> str:
    """Union of the new agent types' state_dicts with the base's (last
    wins: the base); -> the merged checkpoint's path."""
    paths = [best_ckpt(d) for d in new_type_dirs] + [best_ckpt(base_dir)]
    merged = ckpt_lib.merge_checkpoints(paths,
                                        drop_prefixes=DROP_FROM_NEW_TYPES)
    os.makedirs(output_dir, exist_ok=True)
    out = ckpt_lib.save_checkpoint(output_dir, merged, epoch=0, bestval=True)
    base_cfg = os.path.join(base_dir, "config.yaml")
    if os.path.exists(base_cfg) and not os.path.exists(
            os.path.join(output_dir, "config.yaml")):
        shutil.copy(base_cfg, os.path.join(output_dir, "config.yaml"))
    print(f"[merge_final] wrote {out}")
    return out


def rename_modules(ckpt_path: str, mapping: dict) -> str:
    """Rename top-level modules (the first dotted component of each key)
    of a checkpoint; -> the renamed checkpoint's path. A port ``.pth`` is
    rewritten in place and the original kept as ``<path>.oldversion``
    (JAX ``rename_modules``); a heal_tpu ``.ckpt`` stays as it is and the
    renamed state_dict goes to a ``.pth`` beside it."""
    out = {}
    for key, value in ckpt_lib.load_state_dict(ckpt_path).items():
        top, _, rest = key.partition(".")
        out[".".join(filter(None, (mapping.get(top, top), rest)))] = value
    if ckpt_path.endswith(".pth"):
        shutil.copy(ckpt_path, ckpt_path + ".oldversion")
        target = ckpt_path
    else:
        target = os.path.splitext(ckpt_path)[0] + ".pth"
    torch.save(out, target)
    print(f"[rename] {ckpt_path} -> {target}: {mapping}")
    return target


def main(argv=None):
    p = argparse.ArgumentParser("heal_tpu_torch merge tools")
    p.add_argument("command", choices=["merge_final", "rename"])
    p.add_argument("dirs", nargs="+",
                   help="merge_final: new-type dirs..., base dir, output "
                        "dir; rename: checkpoint old=new [old=new ...]")
    args = p.parse_args(argv)
    if args.command == "merge_final":
        if len(args.dirs) < 3:
            p.error("merge_final needs new-type dirs, a base dir and an "
                    "output dir")
        *new_dirs, base, out = args.dirs
        merge_final(new_dirs, base, out)
    else:
        path, *pairs = args.dirs
        rename_modules(path, dict(pair.split("=", 1) for pair in pairs))


if __name__ == "__main__":
    main()
