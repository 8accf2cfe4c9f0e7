"""Evaluate CoAlign pose-graph refinement quality.

Counterpart of heal_tpu/tools/pose_graph_evaluate.py: load the stage-1
detection dump (tools/pose_graph_pre_calc.py), put pose noise on every
test scene at several stds, run the box alignment, and report the
translation and rotation errors of the non-ego agents before and after
refinement (mean and median), written to
``<model_dir>/pose_graph_eval.json``. Host numpy only.

    python -m heal_tpu_torch.tools.pose_graph_evaluate --model_dir runs/stage1 \\
        [--precalc stage1_boxes.json] [--stds 0.2,0.4,0.6] [--max_frames N]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..config import load_yaml
from ..data import build_dataset
from ..utils.box_align import box_alignment_relative, uncertainty_to_weights
from ..utils.pose_noise import add_pose_noise


def _pose_errors(poses, clean):
    """Per-agent translation (m) and rotation (deg) errors, the ego
    (agent 0) excluded."""
    poses = np.asarray(poses, dtype=np.float64)
    clean = np.asarray(clean, dtype=np.float64)
    trans = np.linalg.norm(poses[1:, :2] - clean[1:, :2], axis=1)
    dyaw = np.abs(poses[1:, 4] - clean[1:, 4]) % 360.0
    rot = np.minimum(dyaw, 360.0 - dyaw)
    return trans.tolist(), rot.tolist()


def evaluate(model_dir: str, precalc_path: str | None = None,
             stds=(0.2, 0.4, 0.6), max_frames: int | None = None,
             seed: int = 303) -> dict:
    """-> {str(std): {trans_noisy, rot_noisy, trans_refined, rot_refined:
    {mean, median}}}. Each std reseeds numpy's global generator with
    ``seed`` (``add_pose_noise`` draws from it)."""
    cfg = load_yaml("", model_dir=model_dir)
    dataset = build_dataset(cfg, train=False)
    precalc_path = precalc_path or os.path.join(model_dir,
                                                "stage1_boxes.json")
    with open(precalc_path) as f:
        precalc = json.load(f)

    report = {}
    for std in stds:
        np.random.seed(seed)
        errs = {k: [] for k in ("trans_noisy", "rot_noisy",
                                "trans_refined", "rot_refined")}
        n_frames = 0
        for idx in range(len(dataset)):
            if max_frames and n_frames >= max_frames:
                break
            entry = precalc.get(str(idx))
            if not entry:
                continue
            scene = dataset.backend.scene(idx)
            clean = [np.asarray(a["pose"], np.float64)
                     for a in scene["agents"]]
            if len(clean) < 2:
                continue
            noisy = add_pose_noise(clean, {"pos_std": std, "rot_std": std,
                                           "pos_mean": 0.0, "rot_mean": 0.0})
            entry = entry[:len(clean)]
            centers = [np.asarray(e["centers"]) for e in entry]
            if any(len(c) == 0 for c in centers):
                continue
            uncert = None
            if all("uncertainty" in e and len(e["uncertainty"])
                   for e in entry):
                uncert = [uncertainty_to_weights(e["uncertainty"])
                          for e in entry]
            refined = box_alignment_relative(centers, np.stack(noisy),
                                             uncertainties=uncert)
            for when, poses in (("noisy", noisy), ("refined", refined)):
                t, r = _pose_errors(poses, clean)
                errs[f"trans_{when}"] += t
                errs[f"rot_{when}"] += r
            n_frames += 1
        report[str(std)] = {
            k: {"mean": float(np.mean(v)) if v else None,
                "median": float(np.median(v)) if v else None}
            for k, v in errs.items()
        }
        if errs["trans_noisy"]:
            print(f"[pose_graph_evaluate] std={std}: trans "
                  f"{np.mean(errs['trans_noisy']):.3f} -> "
                  f"{np.mean(errs['trans_refined']):.3f} m, rot "
                  f"{np.mean(errs['rot_noisy']):.3f} -> "
                  f"{np.mean(errs['rot_refined']):.3f} deg "
                  f"({n_frames} frames)")
    out_path = os.path.join(model_dir, "pose_graph_eval.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[pose_graph_evaluate] wrote {out_path}")
    return report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("heal_tpu_torch pose_graph_evaluate")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--precalc", default=None)
    p.add_argument("--stds", default="0.2,0.4,0.6")
    p.add_argument("--max_frames", type=int, default=None)
    args = p.parse_args(argv)
    return evaluate(args.model_dir, args.precalc,
                    tuple(float(s) for s in args.stds.split(",")),
                    args.max_frames)


if __name__ == "__main__":
    main()
