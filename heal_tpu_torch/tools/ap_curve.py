"""AP-vs-epochs curve: evaluate every saved checkpoint of a run.

Counterpart of heal_tpu/tools/ap_curve.py (the reference's
evaluation-as-test loop, train.py running inference at the end): walks a
run dir's epoch checkpoints oldest-first, the port's ``net_epoch{E}.pth``
and heal_tpu's ``net_epoch{E}.ckpt`` alike (the bestval files are left
out), serves each through :func:`tools.inference.run_inference` and
writes ``ap_curve.json``, one row per epoch with its numbers (``ap_30``,
``ap_50``, ``ap_70``, the frames served, ...).

    python -m heal_tpu_torch.tools.ap_curve --model_dir runs/demo \\
        [--max_batches N] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import re

from .inference import run_inference

_EPOCH_RE = re.compile(r"net_epoch(\d+)\.(pth|ckpt)")


def list_epoch_checkpoints(model_dir: str) -> list:
    """[(epoch, path)] sorted by epoch, bestval files excluded; where an
    epoch has both a ``.pth`` and a ``.ckpt``, the port's ``.pth`` (as
    tools/checkpoint.find_checkpoint prefers it)."""
    found: dict = {}
    for name in sorted(os.listdir(model_dir)):
        m = _EPOCH_RE.fullmatch(name)
        if m and (int(m.group(1)) not in found or m.group(2) == "pth"):
            found[int(m.group(1))] = os.path.join(model_dir, name)
    return sorted(found.items())


def run_curve(model_dir: str, max_batches: int | None = None,
              device: str = "cuda") -> list:
    curve = []
    for epoch, path in list_epoch_checkpoints(model_dir):
        res = run_inference(model_dir, device=device, checkpoint=path,
                            note=f"epoch{epoch}", max_batches=max_batches)
        row = {"epoch": epoch}
        row.update({k: float(v) for k, v in res.items()
                    if isinstance(v, (int, float))})
        curve.append(row)
        print(f"[ap_curve] epoch {epoch}: "
              + " ".join(f"{k}={v:.3f}" for k, v in row.items()
                         if k != "epoch"))
    out_path = os.path.join(model_dir, "ap_curve.json")
    with open(out_path, "w") as f:
        json.dump(curve, f, indent=1)
    print(f"[ap_curve] wrote {out_path}")
    return curve


def main(argv=None) -> list:
    p = argparse.ArgumentParser("heal_tpu_torch ap_curve")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return run_curve(args.model_dir, args.max_batches, args.device)


if __name__ == "__main__":
    main()
