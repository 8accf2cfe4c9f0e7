"""Pose-noise robustness sweep.

Counterpart of heal_tpu/tools/inference_w_noise.py: the eval loop of
``model_dir`` with localization noise on every agent's (x, y, yaw) at
pos/rot std in {0, 0.2, 0.4, 0.6} (utils/pose_noise.py: Gaussian,
``--laplace`` or Gaussian position with von-Mises yaw ``--von_mises``),
the AP per level written to ``<model_dir>/ap_vs_noise_<dist>.json``.
With ``--box_align PRECALC_JSON`` (a tools/pose_graph_pre_calc.py dump)
the config's ``box_align.precalc_path`` is set to it, so every frame's
noisy poses are refined by CoAlign's box alignment before fusion
(data/builder.py, data/scene.py), and the AP per level goes to
``ap_vs_noise_<dist>_boxalign.json``.

    python -m heal_tpu_torch.tools.inference_w_noise --model_dir runs/merged \\
        [--laplace | --von_mises] [--box_align stage1_boxes.json] \\
        [--max_batches N] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from .inference import run_inference

NOISE_LEVELS = (0.0, 0.2, 0.4, 0.6)


def run_noise_sweep(model_dir: str, laplace: bool = False,
                    levels=NOISE_LEVELS, max_batches: int | None = None,
                    box_align_precalc: str | None = None,
                    von_mises: bool = False, *, cfg: dict | None = None,
                    device="cuda", dtype=torch.float32) -> dict:
    """-> {std: {ap_30, ap_50, ap_70}}. ``cfg``: the config to serve
    (default: ``model_dir``'s config.yaml); ``box_align_precalc``: a
    pose_graph_pre_calc dump, which turns CoAlign's pose refinement on."""
    dist = "laplace" if laplace else "vonmises" if von_mises else "gauss"
    align = "_boxalign" if box_align_precalc else ""
    override = ({"box_align": {"precalc_path": box_align_precalc}}
                if box_align_precalc else None)
    results = {}
    for std in levels:
        noise = {
            "add_noise": std > 0,
            "args": {"pos_std": std, "rot_std": std, "pos_mean": 0,
                     "rot_mean": 0, "laplace": laplace,
                     "von_mises": von_mises},
        }
        res = run_inference(model_dir, cfg, device=device, dtype=dtype,
                            max_batches=max_batches,
                            note=f"noise_{dist}_{std}{align}",
                            noise_setting=noise, cfg_override=override)
        results[std] = {k: v for k, v in res.items() if k.startswith("ap")}
        print(f"[noise {std}{' +align' if align else ''}] {results[std]}")
    with open(os.path.join(model_dir, f"ap_vs_noise_{dist}{align}.json"),
              "w") as f:
        json.dump(results, f, indent=2)
    return results


def main(argv=None):
    p = argparse.ArgumentParser("heal_tpu_torch inference_w_noise")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--laplace", action="store_true")
    p.add_argument("--von_mises", action="store_true",
                   help="Gaussian position + von-Mises yaw noise")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--box_align", default=None, metavar="PRECALC_JSON",
                   help="pose_graph_pre_calc dump; turns CoAlign pose "
                        "refinement on during the sweep")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return run_noise_sweep(args.model_dir, args.laplace,
                           max_batches=args.max_batches,
                           box_align_precalc=args.box_align,
                           von_mises=args.von_mises, device=args.device)


if __name__ == "__main__":
    main()
