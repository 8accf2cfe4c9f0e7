"""Drive the PyTorch port (heal_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels of heal_tpu_torch/csrc from this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the flagship config (heal_tpu/configs/opv2v_m1_pyramid.yaml:
     5 agents, 30000 points each, 512x256 BEV), f32 and bf16: max abs
     error and both times (CUDA events, after a warmup); kernel 2 also in
     its backward (the kernel run with -s) against the plain backward,
     shift_*_plain(g, -s);
  4. serve 8 synthetic flagship frames through
     heal_tpu_torch.tools.inference.run_inference with seeded random
     weights, f32 (TF32 off) and bf16 (points, affines and decode f32);
     the f32 heads must match the same frames run with the plain kernel
     versions on the card; both kernels' launch counters must rise while
     serving; frames/s for both, and the exact-vs-shear warp time;
  5. train the flagship model (batch_size 2, full width and depth) with
     heal_tpu_torch.parallel.Trainer: one f32 step through the kernels and
     one through the plain versions from the same weights and batch (loss
     and every gradient must agree), then 6 steps on the repeated batch
     (the loss must be finite and fall), then 2 bf16-policy steps; kernel
     2's forward and backward counters must rise and kernel 1's must not
     move (it is eval-only); ms/step, samples/s and peak memory.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. The script imports torch and heal_tpu_torch
only; configs and batches come through heal_tpu_torch.tools.train.
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
import warnings

import torch

SEED = 0
FRAMES = 8
ITERS = 20

# tolerances, as max |kernel - plain| <= tol * (1 + max |plain|):
#   f32: kernel 1 sums in another order than scatter_reduce -> a few f32
#   ulps; kernel 2 (built without FMA contraction) rounds as its plain
#   version does;
#   bf16: both blend and reduce in f32, then round to bf16 -> at most
#   one bf16 ulp apart (2^-8 relative).
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# f32 heads, kernels vs plain versions on the card: the ulp-level kernel
# differences pass through ~40 convolutions (TF32 off both times)
HEADS_TOL = 1e-4
# f32 train step, kernels vs plain versions on the card, loss and every
# gradient leaf as max |d| / (1 + max |ref|): both steps run with
# deterministic algorithms, and kernel 2 (built without FMA contraction)
# rounds as its plain version does in both directions, so the two steps
# should agree to the bit; the bound leaves room for an op that has no
# deterministic CUDA implementation (listed when the run meets one). Not
# deterministic, two runs of the same step differ by ~7e-3 in a gradient
# leaf (7.4e-3 on an H100): batch norm in train mode amplifies the order
# of atomic sums.
TRAIN_TOL = {"loss": 1e-6, "grad": 1e-6}
TRAIN_STEPS = 6


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
    reference run only): kernel 1's wrapper is swapped at module level, and
    kernel 2's one-direction launcher, which its autograd function calls
    forward with s and backward with -s."""
    from heal_tpu_torch.ops import pillar, shift_rows

    saved = (pillar.pillar_tables, shift_rows._shift)
    pillar.pillar_tables = pillar.pillar_tables_plain
    shift_rows._shift = lambda x, s, m, axis, backward=False: (
        shift_rows.shift_rows_plain if axis == 0
        else shift_rows.shift_cols_plain)(x, s, m)
    try:
        yield
    finally:
        pillar.pillar_tables, shift_rows._shift = saved


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
    from heal_tpu_torch.tools.train import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "heal_tpu", "configs",
                                   "opv2v_m1_pyramid.yaml"))
    cfg["fusion"]["args"]["num_scenes_test"] = FRAMES
    return cfg


def phase_kernels(cfg, model32) -> dict:
    """Kernel vs plain at flagship shapes; returns the JSON rows' numbers."""
    from heal_tpu_torch.ops import pillar, shift_rows
    from heal_tpu_torch.tools.train import device_batches

    dev = torch.device("cuda")
    rows = {}

    # kernel 1: the encoder's inputs on the first flagship frame
    batch, _ = next(device_batches(cfg, 1, dev, train=False))
    pts = batch["inputs_m1"]["points"][0]
    msk = batch["inputs_m1"]["point_mask"][0]
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
    worst = worst_bwd = 0.0
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
                b = shift_backward(x, s, ms_bound, fn, plain, gen,
                                   0 if name == "rows" else 1)
                print(f"[kernel] shift_{name} backward {str(dt)[6:]} x "
                      f"{tuple(x.shape)}: max_abs_err {b['err']:.3e} (rel "
                      f"{b['rel']:.3e}, tol {KERNEL_TOL[dt]}), {b['ms']:.4f} "
                      f"ms vs plain {b['plain_ms']:.4f} ms (autograd through "
                      f"the plain forward: {b['autograd_ms']:.4f} ms)")
                if not b["rel"] <= KERNEL_TOL[dt]:
                    raise AssertionError(f"shift_{name} backward {dt} {side}:"
                                         f" {b['rel']}")
                worst_bwd = max(worst_bwd, b["err"])
                if dt == torch.bfloat16 and side == 292 and name == "rows":
                    rows["shift_rows"].update(backward_ms=b["ms"],
                                              backward_plain_ms=b["plain_ms"])
    rows["shift_rows"].update(max_abs_err=worst,
                              backward_max_abs_err=worst_bwd)
    return rows


def shift_backward(x, s, ms_bound, fn, plain, gen, axis) -> dict:
    """Kernel 2's backward against the plain backward plain(g, -s) on one
    shape: the error through autograd, the time of the backward as autograd
    runs it (negate the shifts, launch the kernel), and for information
    autograd through the plain forward."""
    from heal_tpu_torch.ops import shift_rows

    g = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    xr = x.detach().clone().requires_grad_()
    (got,) = torch.autograd.grad(fn(xr, s, ms_bound), xr, g)
    want = plain(g, -s, ms_bound)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    yp = plain(xr, s, ms_bound)
    return dict(
        err=err, rel=rel,
        ms=cuda_ms(lambda: shift_rows._shift(g, -s, ms_bound, axis,
                                             backward=True)),
        plain_ms=cuda_ms(lambda: plain(g, -s, ms_bound)),
        autograd_ms=cuda_ms(
            lambda: torch.autograd.grad(yp, xr, g, retain_graph=True)),
    )


def phase_serve(cfg, model32) -> dict:
    import numpy as np

    from heal_tpu_torch.ops import pillar, shift_rows
    from heal_tpu_torch.ops.warp import warp_agents_to_ego
    from heal_tpu_torch.tools.inference import run_inference
    from heal_tpu_torch.tools.train import device_batches

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
    batch, _ = next(device_batches(cfg, 1, "cuda", train=False))
    aff = batch["pairwise_affine"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dt in (torch.float32, torch.bfloat16):
        feats = torch.randn((1, 5, 128, 256, 65), generator=gen,
                            device="cuda").to(dt)
        t_ex = cuda_ms(lambda: warp_agents_to_ego(feats, aff, method="exact"))
        t_sh = cuda_ms(lambda: warp_agents_to_ego(feats, aff, method="shear"))
        print(f"[warp] level-0 warp_agents_to_ego {str(dt)[6:]}: exact "
              f"{t_ex:.4f} ms, shear {t_sh:.4f} ms")
    return launches


def _grad_leaves(model) -> dict:
    return {k: p.grad.detach().float().clone()
            for k, p in model.named_parameters()}


def phase_train(cfg, model32) -> dict:
    """Train steps on the flagship config; returns kernel 2's train-phase
    launch counts."""
    from heal_tpu_torch.models import build_loss
    from heal_tpu_torch.ops import pillar, shift_rows
    from heal_tpu_torch.parallel import Trainer, build_optimizer
    from heal_tpu_torch.tools.train import device_batches

    dev = torch.device("cuda")
    bs = cfg["train_params"]["batch_size"]
    batches = device_batches(cfg, bs, dev, train=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch, data_s = next(batches)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0 - data_s
    print(f"[train] flagship batch of {bs}: host data {data_s * 1e3:.1f} ms, "
          f"h2d {h2d_s * 1e3:.2f} ms (neither is in ms/step)")

    def trainer(bf16=False):
        model = copy.deepcopy(model32).train()
        opt, schedule = build_optimizer(
            model.parameters(), cfg["optimizer"], cfg.get("lr_scheduler"),
            max(cfg["fusion"]["args"]["num_scenes_train"] // bs, 1))
        return Trainer(
            model, build_loss(cfg["loss"]), opt, schedule,
            supervise_single=cfg["model"]["args"]["supervise_single"],
            single_weight=cfg["loss"]["args"].get("single_weight", 1.0),
            bf16=bf16)

    def timed_step(tr):
        torch.cuda.synchronize()
        t = time.perf_counter()
        aux = tr.train_step(batch)
        torch.cuda.synchronize()
        return aux, time.perf_counter() - t

    # f32 (TF32 off): one step through the plain versions, then two
    # through the kernels (the second gives the run-to-run noise)
    before = (pillar.pillar_tables.launches, shift_rows.shift_rows.launches,
              shift_rows.shift_rows.backward_launches)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with plain_kernels():
            tr_plain = trainer()
            aux_plain, _ = timed_step(tr_plain)
        if before != (pillar.pillar_tables.launches,
                      shift_rows.shift_rows.launches,
                      shift_rows.shift_rows.backward_launches):
            raise AssertionError("the plain reference step launched a kernel")
        ref = _grad_leaves(tr_plain.model)
        del tr_plain
        pillar.pillar_tables.launches = 0
        shift_rows.shift_rows.launches = 0
        shift_rows.shift_rows.backward_launches = 0
        runs = []
        for _ in range(2):
            tr = trainer()
            aux, _ = timed_step(tr)
            runs.append((aux, _grad_leaves(tr.model)))
    torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    print(f"[train] ops without a deterministic CUDA implementation in the "
          f"compared steps: {nondet or 'none'}")
    worst = {"loss": 0.0, "grad": 0.0}
    for aux, grads in runs:
        for k, v in aux_plain.items():
            worst["loss"] = max(worst["loss"], rel_err(aux[k], v)[1])
        for k, v in ref.items():
            worst["grad"] = max(worst["grad"], rel_err(grads[k], v)[1])
    noise = max(rel_err(runs[0][1][k], runs[1][1][k])[1] for k in ref)
    print(f"[train] f32 step, kernels vs plain on the card: loss max rel "
          f"{worst['loss']:.3e} (tol {TRAIN_TOL['loss']}), gradients max "
          f"|d|/(1+max|ref|) {worst['grad']:.3e} over {len(ref)} leaves (tol "
          f"{TRAIN_TOL['grad']}); kernel run vs kernel run {noise:.3e}")
    for name in ("loss", "grad"):
        if not worst[name] <= TRAIN_TOL[name]:
            raise AssertionError(f"f32 train step {name} disagrees with the "
                                 f"plain run: {worst[name]}")

    # more steps on the repeated batch (tr has taken one already)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [float(runs[-1][0]["total_loss"])], []
    for _ in range(TRAIN_STEPS - 1):
        aux, dt = timed_step(tr)
        losses.append(float(aux["total_loss"]))
        times.append(dt)
    peak32 = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] f32 losses over {TRAIN_STEPS} steps: "
          + ", ".join(f"{x:.4f}" for x in losses))
    print("[train] f32 last step terms: " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in sorted(aux.items())))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"f32 training loss is not finite and falling: "
                             f"{losses}")
    ms32 = 1e3 * sum(times[1:]) / len(times[1:])
    print(f"[train] f32: {ms32:.3f} ms/step, {bs / ms32 * 1e3:.3f} samples/s "
          f"(mean of {len(times) - 1} steps after the first timed one), peak "
          f"memory {peak32:.3f} GiB")
    del tr, runs

    # the bf16 policy: f32 master weights, bf16 compute, f32 BN buffers
    tr = trainer(bf16=True)
    torch.cuda.reset_peak_memory_stats()
    out16 = [timed_step(tr) for _ in range(2)]
    peak16 = torch.cuda.max_memory_allocated() / 2**30
    l16 = [float(a["total_loss"]) for a, _ in out16]
    bufs = {b.dtype for b in tr.model.buffers()}
    params = {p.dtype for p in tr.model.parameters()}
    print(f"[train] bf16 losses {l16[0]:.4f}, {l16[1]:.4f}; second step "
          f"{out16[1][1] * 1e3:.3f} ms ({bs / out16[1][1]:.3f} samples/s); "
          f"peak memory {peak16:.3f} GiB; buffers {bufs}, params {params}")
    print("[train] bf16 last step terms: " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in sorted(out16[1][0].items())))
    if not all(math.isfinite(x) for x in l16):
        raise AssertionError(f"bf16 training loss is not finite: {l16}")
    if bufs != {torch.float32} or params != {torch.float32}:
        raise AssertionError("bf16 policy: buffers and master weights must "
                             "stay f32")

    # the launch counters of the training run
    launches = {"pillar_tables": pillar.pillar_tables.launches,
                "shift_rows": shift_rows.shift_rows.launches,
                "shift_rows_backward": shift_rows.shift_rows.backward_launches}
    print(f"[train] kernel launches while training: {launches}")
    if launches["pillar_tables"] != 0:
        raise AssertionError("kernel 1 was launched in training")
    if launches["shift_rows"] <= 0 or launches["shift_rows_backward"] <= 0:
        raise AssertionError("kernel 2 was not launched in both directions "
                             "while training")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # the port comes from this checkout: fail here, before printing
    # anything, when the script stands alone
    import heal_tpu_torch.tools.train  # noqa: F401

    # cuBLAS reads this when it makes its handle: needed for the
    # deterministic train-step comparison
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    trained = phase_train(cfg, model32)
    rows["shift_rows"]["backward_launches"] = trained["shift_rows_backward"]

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
