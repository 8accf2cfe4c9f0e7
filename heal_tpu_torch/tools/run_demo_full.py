"""Run HEAL's open-heterogeneity protocol end to end with the port.

Counterpart of heal_tpu/tools/run_demo_full.py: a stage-1 m1 base, each
new agent type of ``--modalities`` trained against the FROZEN base
(stage 2), the merge (stage 3), then the merged alliance's evaluations:
plain AP, the in-order table (k = 1 .. n agent types) and the pose-noise
sweep, and CoAlign's box-aligned sweep: the stage-1 base's detections
dumped by tools/pose_graph_pre_calc.py (when the dump is missing), then
the pose-noise sweep with the box alignment on. The alliance config is
``--final_cfg`` (a name in ``--cfg_dir`` or a path) cut down to m1 and
the trained types (``config.keep_modalities``). A failure of the
box-align leg is recorded in the results, as JAX records it, and the
run goes on.

Each phase is skipped when its artifact exists, so the run resumes.

    python -m heal_tpu_torch.tools.run_demo_full --out runs/demo_full \\
        [--modalities m2,m3,m4] [--cfg_dir DIR] [--final_cfg NAME|PATH] \\
        [--stage1_epochs N] [--stage2_epochs N] [--max_batches N] \\
        [--skip_noise] [--device cuda]

Every agent type of HEAL's alliance is ported: the PointPillars types
(m1 and the 16-line m4), the camera type (m2, Lift-Splat-Shoot) and the
SECOND sparse-conv type (m3).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import time
import traceback

CFG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "heal_tpu", "configs", "demo_heal_full")


def _trained(d: str, epochs_override=None) -> bool:
    """True when the run dir holds a checkpoint at the configured final
    epoch (a mid-run checkpoint means "resume", not "done")."""
    from ..config import load_yaml

    if not os.path.isdir(d):
        return False
    eps = [int(m.group(1)) for m in (
        re.fullmatch(r"net_epoch(\d+)\.(?:pth|ckpt)", n) for n in os.listdir(d))
        if m]
    if not eps:
        return False
    cfg = load_yaml("", model_dir=d)
    return max(eps) >= (epochs_override or cfg["train_params"]["epoches"])


def _final_cfg_path(cfg_dir: str, final: str) -> str:
    return final if os.path.exists(final) else os.path.join(
        cfg_dir, f"{final}.yaml")


def main(argv=None):
    p = argparse.ArgumentParser("heal_tpu_torch run_demo_full")
    p.add_argument("--out", default="runs/demo_full")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--stage1_epochs", type=int, default=None)
    p.add_argument("--stage2_epochs", type=int, default=None)
    p.add_argument("--cfg_dir", default=CFG,
                   help="directory of stage1_m1.yaml, stage2_mX.yaml and "
                        "the final config")
    p.add_argument("--modalities", default="m2,m3,m4",
                   help="stage-2 agent types to train (csv)")
    p.add_argument("--final_cfg", default="final_m1m2m3m4",
                   help="merged-alliance config: a name in cfg_dir or a path")
    p.add_argument("--skip_noise", action="store_true",
                   help="skip the pose-noise and box-align legs")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg_dir = args.cfg_dir
    dev = ["--device", args.device]

    from ..config import keep_modalities, load_yaml, save_yaml
    from .checkpoint import find_checkpoint
    from .inference import run_inference
    from .inference_heter_in_order import run_in_order
    from .inference_w_noise import run_noise_sweep
    from .merge import merge_final
    from .pose_graph_pre_calc import pre_calc
    from .train import main as train_main

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()

    def log(msg):
        print(f"[demo_full +{time.time() - t0:7.0f}s] {msg}", flush=True)

    # stage 1: the m1 collaboration base
    stage1 = os.path.join(args.out, "stage1_m1")
    if not _trained(stage1, args.stage1_epochs):
        log("stage 1: training the m1 base")
        argv1 = ["-y", os.path.join(cfg_dir, "stage1_m1.yaml"),
                 "--model_dir", stage1, "--no_final_inference", *dev]
        if args.stage1_epochs:
            argv1 += ["--epochs", str(args.stage1_epochs)]
        train_main(argv1)
    s1_path = find_checkpoint(stage1)[1]
    log(f"stage 1 ready: {s1_path}")

    # stage 2: each new agent type against the frozen base
    modalities = [m.strip() for m in args.modalities.split(",") if m.strip()]
    stage2_dirs = []
    for m in modalities:
        d = os.path.join(args.out, f"stage2_{m}")
        if not _trained(d, args.stage2_epochs):
            log(f"stage 2: training {m} against the frozen base")
            argv2 = ["-y", os.path.join(cfg_dir, f"stage2_{m}.yaml"),
                     "--model_dir", d, "--no_final_inference",
                     "--init_from", s1_path, *dev]
            if args.stage2_epochs:
                argv2 += ["--epochs", str(args.stage2_epochs)]
            train_main(argv2)
        stage2_dirs.append(d)
        log(f"stage 2 {m} ready")

    # stage 3: merge into the alliance, served with its final config
    merged = os.path.join(args.out, "merged_alliance")
    if not os.path.exists(os.path.join(merged, "config.yaml")):
        log("stage 3: merging checkpoints")
        merge_final(stage2_dirs, stage1, merged)
        final = keep_modalities(
            load_yaml(_final_cfg_path(cfg_dir, args.final_cfg)),
            ["m1", *modalities])
        save_yaml(final, os.path.join(merged, "config.yaml"))
    log("merged alliance ready")

    results = {}
    tagf = os.path.join(merged, "eval_merged.json")
    if not os.path.exists(tagf):
        log("eval: merged alliance inference")
        res = run_inference(merged, note="merged",
                            max_batches=args.max_batches, device=args.device)
        with open(tagf, "w") as f:
            json.dump({k: v for k, v in res.items()
                       if isinstance(v, (int, float, str))}, f, indent=2)
    with open(tagf) as f:
        results["merged"] = json.load(f)
    log(f"merged AP: { {k: v for k, v in results['merged'].items() if k.startswith('ap')} }")

    tagf = os.path.join(merged, "ap_in_order.json")
    if not os.path.exists(tagf):
        log("eval: in-order")
        run_in_order(merged, max_batches=args.max_batches, device=args.device)
    with open(tagf) as f:
        results["in_order"] = json.load(f)

    if not args.skip_noise:
        tagf = os.path.join(merged, "ap_vs_noise_gauss.json")
        if not os.path.exists(tagf):
            log("eval: pose-noise sweep (gaussian)")
            run_noise_sweep(merged, max_batches=args.max_batches,
                            device=args.device)
        with open(tagf) as f:
            results["noise"] = json.load(f)
        # CoAlign: the box-aligned sweep on the stage-1 detections
        precalc = os.path.join(stage1, "stage1_boxes.json")
        try:
            if not os.path.exists(precalc):
                log("eval: pose_graph_pre_calc on the stage-1 model")
                pre_calc(stage1, precalc, device=args.device)
            tagf = os.path.join(merged, "ap_vs_noise_gauss_boxalign.json")
            if not os.path.exists(tagf):
                log("eval: pose-noise sweep + box align")
                run_noise_sweep(merged, max_batches=args.max_batches,
                                box_align_precalc=precalc,
                                device=args.device)
            with open(tagf) as f:
                results["noise_boxalign"] = json.load(f)
        except Exception as e:  # noqa: BLE001 (recorded, as JAX does)
            log(f"box-align leg failed: {e!r}\n{traceback.format_exc()}")
            results["noise_boxalign"] = {"error": repr(e)}

    with open(os.path.join(args.out, "demo_full_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    log("DONE" + (" (noise legs skipped)" if args.skip_noise else ""))
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
