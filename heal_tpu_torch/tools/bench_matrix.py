"""Secondary performance matrix: per-path inference and train throughput.

Counterpart of heal_tpu/tools/bench_matrix.py (the reference profiler
suite: tools/profiler/params_calc.py's per-model fps, traintp_calc.py's
samples/s) for the port: the encoder families beside the flagship, and
the train step at batch 2.

    python -m heal_tpu_torch.tools.bench_matrix [--paths pp_max,second,lss]
        [--frames 8] [--out matrix.json] [--device cuda]

Each path serves ``--frames`` synthetic test frames of its published
config (heal_tpu/configs/, with the same shapes and ranges as the real
recordings) with seeded weights in bf16. The frames are assembled and
copied to the device before timing and cast as JAX's ``cast16`` casts
them: floating inputs to bf16, but the points, and the geometry the
port's bf16 serving keeps in f32 (the pairwise affines, whose shifts feed
kernel 2; the camera's rotations, translations and intrinsics, which it
inverts). The forward, the decode and the rotated NMS of every frame run
inside the timed region: a warm pass, then the best of 3 timed passes
(CUDA events; the host clock on the CPU). One JSON row a path is printed,
and the list written to ``--out``. The ``train`` / ``train_bf16`` rows
time ``Trainer.train_step`` on lidar_only/max.yaml at batch 2, in f32
and under the bf16 policy (parallel/trainer.py ``bf16``).
"""
from __future__ import annotations

import argparse
import copy
import json
import os

import numpy as np
import torch

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "heal_tpu", "configs")

PATH_CONFIGS = {
    # PointPillars + max fusion, real OPV2V scale
    "pp_max": {
        "cfg": "opv2v/lidar_only/max.yaml",
        "desc": "PointPillars intermediate max-fusion",
    },
    # SECOND sparse-conv encoder (HEAL stage-2 m3 single-agent config)
    "second": {
        "cfg": "opv2v/heal/stage2/m3_alignto_m1.yaml",
        "desc": "SECOND sparse 3D conv (heter single m3)",
    },
    # camera-only LSS pyramid collab
    "lss": {
        "cfg": "opv2v/camera_only/m2_pyramid.yaml",
        "desc": "Lift-Splat-Shoot camera pyramid collab",
    },
    # the full heterogeneous alliance: all four encoder families in one
    # frame, 2 agents per modality (heter.modality_setting max_agents)
    "heter4": {
        "cfg": "opv2v/heal/final_infer/m1m2m3m4.yaml",
        "desc": "HEAL alliance m1+m2+m3+m4 (pillars/camera/SECOND/16-line)",
        "max_agents": 2,
    },
}
TRAIN_CFG = "opv2v/lidar_only/max.yaml"
TRAIN_BATCH = 2
# inputs the port's bf16 serving keeps in f32 besides the points
F32_INPUTS = ("pairwise_affine", "rots", "trans", "intrins", "post_rots",
              "post_trans")


def load_path_cfg(rel: str, frames: int, train: bool = False) -> dict:
    """A published config on the synthetic backend with ``frames``
    scenes in the split it serves."""
    from .train import load_config

    cfg = load_config(os.path.join(CONFIGS, rel))
    cfg["fusion"]["dataset"] = "synthetic"
    split = "num_scenes_train" if train else "num_scenes_test"
    cfg["fusion"]["args"] = dict(cfg["fusion"].get("args") or {},
                                 **{split: frames})
    return cfg


def cast16(inputs, key: str = ""):
    """JAX's ``cast16`` on the port's frame inputs (module docstring)."""
    if isinstance(inputs, dict):
        return {k: cast16(v, k) for k, v in inputs.items()}
    if isinstance(inputs, list):
        return [cast16(v, key) for v in inputs]
    if (inputs.dtype == torch.float32 and "points" not in key
            and key not in F32_INPUTS):
        return inputs.to(torch.bfloat16)
    return inputs


def best_ms(fn, device, passes: int = 3) -> float:
    """The best of ``passes`` timed calls of ``fn``, after a warm one."""
    from .profiler import _Clock

    clock = _Clock(device)
    fn()
    times = []
    for _ in range(passes):
        clock.start()
        fn()
        times.append(clock.stop())
    return min(times)


def bench_path(name: str, spec: dict, frames: int, device="cuda",
               cfg: dict | None = None) -> dict:
    """Serve ``frames`` frames of ``spec``'s config (or ``cfg``) in bf16:
    -> {"path", "desc", "fps", "ms_per_frame", "frames"}."""
    from ..models.layers import channels_last
    from ..postprocess.anchors import generate_anchor_box
    from ..postprocess.decode import post_process_single
    from .inference import build_weights, device_frames

    device = torch.device(device)
    if cfg is None:
        cfg = load_path_cfg(spec["cfg"], frames)
    cfg = copy.deepcopy(cfg)
    if "max_agents" in spec and "heter" in cfg:
        for setting in cfg["heter"]["modality_setting"].values():
            setting["max_agents"] = spec["max_agents"]
    fs = [(b, cast16(x)) for b, x in device_frames(cfg, device, frames)]
    model = build_weights(cfg, seed=0).to(device=device,
                                          dtype=torch.bfloat16).eval()
    if device.type == "cuda":
        model = channels_last(model)
    post = cfg["postprocess"]
    anchors = torch.from_numpy(np.asarray(generate_anchor_box(
        post["anchor_args"], post["order"]), np.float32)).to(device)
    gt_range = torch.tensor(post["gt_range"], dtype=torch.float32,
                            device=device)
    tms = [torch.from_numpy(np.asarray(b["transformation_matrix"][0],
                                       np.float32)).to(device)
           for b, _ in fs]

    def serve():
        with torch.inference_mode():
            for (_, x), tm in zip(fs, tms):
                out = model(x)
                post_process_single(
                    out["cls_preds"][0].float(), out["reg_preds"][0].float(),
                    out["dir_preds"][0].float() if out.get("dir_preds")
                    is not None else None,
                    anchors, tm, gt_range, order=post["order"],
                    score_threshold=post["target_args"]["score_threshold"],
                    nms_threshold=post["nms_thresh"],
                    anchor_free=bool(out.get("anchor_free", False)))

    ms = best_ms(serve, device)
    return {"path": name, "desc": spec["desc"], "frames": len(fs),
            "fps": len(fs) / ms * 1e3, "ms_per_frame": ms / len(fs)}


def bench_train_throughput(frames: int = 8, steps: int = 10,
                           bf16: bool = False, device="cuda",
                           cfg: dict | None = None) -> dict:
    """``steps`` train steps on one batch of TRAIN_BATCH (ref
    traintp_calc.py), after a warm one: -> samples/s. ``bf16``: the
    Trainer's mixed-precision policy (f32 master weights, bf16 compute,
    the torch-AMP ``--half`` equivalent)."""
    from .train import build_trainer, device_batches

    device = torch.device(device)
    if cfg is None:
        cfg = load_path_cfg(TRAIN_CFG, frames, train=True)
    cfg = copy.deepcopy(cfg)
    cfg["train_params"]["bf16"] = bf16
    trainer = build_trainer(cfg, device, 1)
    batch, _ = next(device_batches(cfg, TRAIN_BATCH, device))

    from .profiler import _Clock

    trainer.train_step(batch)  # warm: allocator, autotuning
    clock = _Clock(device)
    clock.start()
    for _ in range(steps):
        trainer.train_step(batch)
    ms = clock.stop()
    return {"path": "train_pp_max_bf16" if bf16 else "train_pp_max",
            "desc": (f"train step samples/s (b{TRAIN_BATCH}"
                     + (", bf16 policy)" if bf16 else ")")),
            "fps": steps * TRAIN_BATCH / ms * 1e3, "step_ms": ms / steps}


def main(argv=None) -> list:
    p = argparse.ArgumentParser("heal_tpu_torch bench_matrix")
    p.add_argument("--paths",
                   default="pp_max,second,lss,heter4,train,train_bf16")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    rows = []
    for name in args.paths.split(","):
        name = name.strip()
        if name in ("train", "train_bf16"):
            rows.append(bench_train_throughput(
                args.frames, bf16=name == "train_bf16", device=args.device))
        else:
            rows.append(bench_path(name, PATH_CONFIGS[name], args.frames,
                                   device=args.device))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
