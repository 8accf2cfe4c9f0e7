"""Drive the PyTorch port (heal_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels of heal_tpu_torch/csrc from this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the flagship config (heal_tpu/configs/opv2v_m1_pyramid.yaml:
     5 agents, 30000 points each, 512x256 BEV), f32 and bf16: max abs
     error and both times (CUDA events, after a warmup);
  4. serve 8 synthetic flagship frames through
     heal_tpu_torch.tools.inference.run_inference with seeded random
     weights, f32 (TF32 off) and bf16 (points, affines and decode f32);
     the f32 heads must match the same frames run with the plain kernel
     versions on the card; both kernels' launch counters must rise while
     serving; frames/s for both, and the exact-vs-shear warp time.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

SEED = 0
FRAMES = 8
ITERS = 20

# tolerances, as max |kernel - plain| <= tol * (1 + max |plain|):
#   f32: the kernels sum in another order than scatter_reduce / FMA
#   contraction differs -> a few f32 ulps;
#   bf16: both blend and reduce in f32, then round to bf16 -> at most
#   one bf16 ulp apart (2^-8 relative).
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# f32 heads, kernels vs plain versions on the card: the ulp-level kernel
# differences pass through ~40 convolutions (TF32 off both times)
HEADS_TOL = 1e-4


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, that over 1 + max |b|)."""
    d = (a.float() - b.float()).abs().max().item()
    return d, d / (1.0 + b.float().abs().max().item())


def cuda_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the kernels' plain PyTorch versions (for the
    reference run only): the wrappers are swapped at module level."""
    from heal_tpu_torch.ops import pillar, shift_rows

    saved = (pillar.pillar_tables, shift_rows.shift_rows,
             shift_rows.shift_cols)
    pillar.pillar_tables = pillar.pillar_tables_plain
    shift_rows.shift_rows = shift_rows.shift_rows_plain
    shift_rows.shift_cols = shift_rows.shift_cols_plain
    try:
        yield
    finally:
        (pillar.pillar_tables, shift_rows.shift_rows,
         shift_rows.shift_cols) = saved


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from heal_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.3f} s")
    for line in build.build_log().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")


def flagship_cfg():
    from heal_tpu.config import load_yaml

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_yaml(os.path.join(root, "heal_tpu", "configs",
                                 "opv2v_m1_pyramid.yaml"))
    cfg["fusion"]["args"]["num_scenes_test"] = FRAMES
    return cfg


def phase_kernels(cfg, model32) -> dict:
    """Kernel vs plain at flagship shapes; returns the JSON rows' numbers."""
    from heal_tpu.data import build_dataset
    from heal_tpu_torch.ops import pillar, shift_rows

    dev = torch.device("cuda")
    rows = {}

    # kernel 1: the encoder's inputs on the first flagship frame
    batch = next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))
    pts = torch.from_numpy(batch["inputs_m1"]["points"][0]).to(dev)
    msk = torch.from_numpy(batch["inputs_m1"]["point_mask"][0]).to(dev)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        enc = copy.deepcopy(model32.branch_m1.encoder).to(dt)
        with torch.inference_mode():
            args = enc.kernel_inputs(pts, msk)
            got = pillar.pillar_tables(*args)
            want = pillar.pillar_tables_plain(*args)
            torch.cuda.synchronize()
            d, r = rel_err(got, want)
            ms = cuda_ms(lambda: pillar.pillar_tables(*args))
            plain_ms = cuda_ms(lambda: pillar.pillar_tables_plain(*args))
        u = args[0]
        print(f"[kernel] pillar_tables {str(dt)[6:]} u {tuple(u.shape)} "
              f"canvas {tuple(got.shape)}: max_abs_err {d:.3e} (rel {r:.3e}, "
              f"tol {KERNEL_TOL[dt]}), {ms:.4f} ms vs plain {plain_ms:.4f} ms")
        if not r <= KERNEL_TOL[dt]:
            raise AssertionError(f"pillar_tables {dt} disagrees: {r}")
        worst = max(worst, d)
        if dt == torch.bfloat16:
            rows["pillar_tables"] = dict(max_abs_err=worst, ms=ms,
                                         plain_ms=plain_ms)

    # kernel 2: the pyramid warp's canvases (4 non-ego agents; level sides
    # 292 / 148 / 76 with C = 65 / 129 / 257), shear-sized shifts
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for side, c in ((292, 65), (148, 129), (76, 257)):
            ms_bound = int(math.ceil(0.7072 * side / 2)) + 2
            x = torch.randn((4, side, side, c), generator=gen, device=dev
                            ).to(dt)
            s = (torch.rand((4, side), generator=gen, device=dev) * 2 - 1
                 ) * ms_bound
            for name, fn, plain in (
                ("rows", shift_rows.shift_rows, shift_rows.shift_rows_plain),
                ("cols", shift_rows.shift_cols, shift_rows.shift_cols_plain),
            ):
                got = fn(x, s, ms_bound)
                want = plain(x, s, ms_bound)
                torch.cuda.synchronize()
                d, r = rel_err(got, want)
                ms = cuda_ms(lambda: fn(x, s, ms_bound))
                plain_ms = cuda_ms(lambda: plain(x, s, ms_bound))
                print(f"[kernel] shift_{name} {str(dt)[6:]} x {tuple(x.shape)}"
                      f": max_abs_err {d:.3e} (rel {r:.3e}, tol "
                      f"{KERNEL_TOL[dt]}), {ms:.4f} ms vs plain "
                      f"{plain_ms:.4f} ms")
                if not r <= KERNEL_TOL[dt]:
                    raise AssertionError(f"shift_{name} {dt} {side}: {r}")
                worst = max(worst, d)
                if dt == torch.bfloat16 and side == 292 and name == "rows":
                    rows["shift_rows"] = dict(ms=ms, plain_ms=plain_ms)
    rows["shift_rows"]["max_abs_err"] = worst
    return rows


def phase_serve(cfg, model32) -> dict:
    import numpy as np

    from heal_tpu.data import build_dataset
    from heal_tpu_torch.ops import pillar, shift_rows
    from heal_tpu_torch.ops.warp import warp_agents_to_ego
    from heal_tpu_torch.tools.inference import run_inference

    model16 = copy.deepcopy(model32).to(torch.bfloat16)

    pillar.pillar_tables.launches = 0
    shift_rows.shift_rows.launches = 0
    r32 = run_inference(cfg=cfg, device="cuda", dtype=torch.float32,
                        model=model32, collect_heads=True)
    r16 = run_inference(cfg=cfg, device="cuda", dtype=torch.bfloat16,
                        model=model16, collect_heads=True)
    launches = {"pillar_tables": pillar.pillar_tables.launches,
                "shift_rows": shift_rows.shift_rows.launches}
    print(f"[serve] kernel launches while serving: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched while serving")

    with plain_kernels():
        ref = run_inference(cfg=cfg, device="cuda", dtype=torch.float32,
                            model=model32, collect_heads=True)
    if (pillar.pillar_tables.launches, shift_rows.shift_rows.launches) != (
            launches["pillar_tables"], launches["shift_rows"]):
        raise AssertionError("the plain reference run launched a kernel")

    want = {"cls_preds": (1, 128, 256, 2), "reg_preds": (1, 128, 256, 14),
            "dir_preds": (1, 128, 256, 4)}
    worst = 0.0
    for i, (a, b, h16) in enumerate(zip(r32["heads"], ref["heads"],
                                        r16["heads"])):
        for k, shape in want.items():
            for t in (a[k], b[k], h16[k]):
                if tuple(t.shape) != shape or not torch.isfinite(t).all():
                    raise AssertionError(f"frame {i} {k}: bad output")
            d, r = rel_err(a[k], b[k])
            worst = max(worst, r)
    print(f"[serve] f32 heads, kernels vs plain on the card, {FRAMES} "
          f"frames: max rel err {worst:.3e} (tol {HEADS_TOL})")
    if not worst <= HEADS_TOL:
        raise AssertionError(f"f32 heads disagree with the plain run: {worst}")
    d16 = max(rel_err(h16[k], a[k])[1] for a, h16 in
              zip(r32["heads"], r16["heads"]) for k in want)
    print(f"[serve] bf16 vs f32 heads (information): max rel err {d16:.3e}")

    fps = {}
    for name, r in (("f32", r32), ("bf16", r16), ("f32 plain", ref)):
        steady = r["serve_s"][1:]
        fps[name] = len(steady) / sum(steady)
        print(f"[serve] {name}: {fps[name]:.3f} frames/s over {len(steady)} "
              f"frames after the first ({np.mean(steady) * 1e3:.3f} ms/frame;"
              f" first {r['serve_s'][0] * 1e3:.1f} ms; host data "
              f"{np.mean(r['data_s']) * 1e3:.1f} ms/frame not included); "
              f"ap_30 {r['ap_30']:.4f}")

    # exact vs shear warp at pyramid level 0 (5 agent slots, 128x256,
    # 64 features + score) on a real frame's affines
    batch = next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))
    aff = torch.from_numpy(batch["pairwise_affine"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dt in (torch.float32, torch.bfloat16):
        feats = torch.randn((1, 5, 128, 256, 65), generator=gen,
                            device="cuda").to(dt)
        t_ex = cuda_ms(lambda: warp_agents_to_ego(feats, aff, method="exact"))
        t_sh = cuda_ms(lambda: warp_agents_to_ego(feats, aff, method="shear"))
        print(f"[warp] level-0 warp_agents_to_ego {str(dt)[6:]}: exact "
              f"{t_ex:.4f} ms, shear {t_sh:.4f} ms")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the port and the shared host side come from this checkout: fail here,
    # before printing anything, when the script stands alone
    import heal_tpu.data  # noqa: F401
    import heal_tpu_torch  # noqa: F401

    smi = phase_card()
    phase_build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from heal_tpu_torch.tools.inference import build_weights

    cfg = flagship_cfg()
    model32 = build_weights(cfg, seed=SEED).cuda().to(
        memory_format=torch.channels_last)
    rows = phase_kernels(cfg, model32)
    launches = phase_serve(cfg, model32)

    meta = {
        "pillar_tables": ("heal_tpu_torch/csrc/pillar_tables.cu",
                          "heal_tpu/ops/pallas_pillar.py:214"),
        "shift_rows": ("heal_tpu_torch/csrc/shift_rows.cu",
                       "heal_tpu/ops/pallas_shear.py:54"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **rows[name]}
        for name, (src, rep) in meta.items()
    ]
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
