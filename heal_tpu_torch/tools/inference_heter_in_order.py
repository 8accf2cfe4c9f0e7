"""Open-heterogeneity evaluation: agent types join in order.

Counterpart of heal_tpu/tools/inference_heter_in_order.py: the merged
alliance of ``model_dir`` is evaluated with the first k agents
collaborating, k = 1 .. the number of agent types (m1 -> m1m2 ->
m1m2m3 -> m1m2m3m4 for the full alliance): ``mapping_dict`` forced to
the identity, ``comm_range`` 180 m, ``heter.use_cav`` = k (the ground
truth still comes from the whole scene), and optionally fewer lidar
lines for any lidar type (``--degrade m1:32,m3:16``).
The AP of each k goes to ``<model_dir>/ap_in_order.json``.

    python -m heal_tpu_torch.tools.inference_heter_in_order --model_dir runs/merged \\
        [--degrade m1:32,m3:16] [--max_batches N] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..config import load_yaml
from .inference import run_inference


def run_in_order(model_dir: str, lidar_degrade: dict | None = None,
                 comm_range: float = 180.0, max_batches: int | None = None,
                 *, cfg: dict | None = None, device="cuda",
                 dtype=torch.float32) -> dict:
    """-> {tag: {ap_30, ap_50, ap_70}} with tags "m1", "m1m2", ...
    ``cfg``: the alliance config (default: ``model_dir``'s config.yaml)."""
    if cfg is None:
        cfg = load_yaml("", model_dir=model_dir)
    heter = cfg.get("heter") or {}
    order = sorted((heter.get("modality_setting") or {"m1": {}}).keys())
    results = {}
    for k in range(1, len(order) + 1):
        override = {
            "comm_range": comm_range,
            "heter": {"mapping_dict": {m: m for m in order}, "use_cav": k},
        }
        if lidar_degrade:
            override["heter"]["lidar_channels_dict"] = lidar_degrade
        tag = "".join(order[:k])
        res = run_inference(model_dir, cfg, device=device, dtype=dtype,
                            max_batches=max_batches, note=f"in_order_{tag}",
                            cfg_override=override)
        results[tag] = {key: v for key, v in res.items()
                        if key.startswith("ap")}
        print(f"[in-order k={k}] {results[tag]}")
    with open(os.path.join(model_dir, "ap_in_order.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    p = argparse.ArgumentParser("heal_tpu_torch inference_heter_in_order")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--degrade", default=None,
                   help="e.g. 'm1:32,m3:16' lidar line degradation")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    degrade = None
    if args.degrade:
        degrade = {kv.split(":")[0]: int(kv.split(":")[1])
                   for kv in args.degrade.split(",")}
    return run_in_order(args.model_dir, degrade, max_batches=args.max_batches,
                        device=args.device)


if __name__ == "__main__":
    main()
