"""Drive the PyTorch port (heal_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels of heal_tpu_torch/csrc from this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the flagship config (heal_tpu/configs/opv2v_m1_pyramid.yaml:
     5 agents, 30000 points each, 512x256 BEV), f32 and bf16: max abs
     error, both device times (CUDA events, after a warmup), the bytes
     and the bound they set, and the time of one PyTorch call that
     computes the same function where there is one (F.grid_sample for
     kernel 2); kernel 1 on the first flagship frame and on a frame as
     dense as OPV2V lidar, each call held to one device kernel and no
     host sync (torch.profiler, sync debug mode "error"); kernel 2 at its
     3 levels, rows and columns, forward and backward (the kernel run
     with -s, against shift_*_plain(g, -s));
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

# the port comes from this checkout: the script fails here, before it
# prints anything, when it stands alone
from heal_tpu_torch.kernels.cases import (dense_inputs, frame_inputs,
                                          pillar_work)
from heal_tpu_torch.kernels.measure import bound, device_kernels, device_ms

SEED = 0
FRAMES = 8

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
    """Kernel vs plain at flagship shapes; returns the JSON rows' numbers
    (all but the launches)."""
    from heal_tpu_torch.ops import pillar, shift_rows
    from heal_tpu_torch.tools.train import device_batches

    dev = torch.device("cuda")
    rows = {}

    # kernel 1: (a) the encoder's inputs on the first flagship frame; (b) a
    # frame as dense as OPV2V lidar on the same grid (every point real,
    # 20000 pillars a slot of 1-32 points). Each call must launch exactly
    # one device kernel and never sync the host.
    batch, _ = next(device_batches(cfg, 1, dev, train=False))
    pts = batch["inputs_m1"]["points"][0]
    msk = batch["inputs_m1"]["point_mask"][0]
    enc = model32.branch_m1.encoder
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for name, args in (
            ("frame", frame_inputs(enc, pts, msk, dt)),
            ("dense", dense_inputs(enc.grid(), pts.shape[0],
                                   enc.out_channels, dt, dev, SEED,
                                   points=pts.shape[1])),
        ):
            got = pillar.pillar_tables(*args)
            want = pillar.pillar_tables_plain(*args)
            torch.cuda.synchronize()
            d, r = rel_err(got, want)
            if not r <= KERNEL_TOL[dt]:
                raise AssertionError(f"pillar_tables {name} {dt} disagrees: "
                                     f"{r}")
            launched = device_kernels(lambda: pillar.pillar_tables(*args))
            if len(launched) != 1 or "pillar_tables" not in launched[0]:
                raise AssertionError(f"pillar_tables {name} {dt}: one call "
                                     f"put {launched} on the card")
            ms = device_ms(lambda: pillar.pillar_tables(*args))
            plain_ms = device_ms(lambda: pillar.pillar_tables_plain(*args))
            # the floor of any version: filling the same canvas with zeros
            fill_ms = device_ms(got.zero_)
            work = pillar_work(args)
            b_ms, b_by = bound(work["bytes"], work["flops"])
            u = args[0]
            print(f"[kernel] pillar_tables {name} {str(dt)[6:]} u "
                  f"{tuple(u.shape)} ({work['landed']} points in "
                  f"{work['runs']} pillars land) canvas {tuple(got.shape)}: "
                  f"max_abs_err {d:.3e} (rel {r:.3e}, tol {KERNEL_TOL[dt]}), "
                  f"{ms:.4f} ms vs plain {plain_ms:.4f} ms; one kernel, no "
                  f"sync; {work['bytes']} bytes, bound {b_ms:.4f} ms "
                  f"({b_by}), {100 * b_ms / ms:.1f}% of bound; library call:"
                  f" none; the canvas's fill by zero_ {fill_ms:.4f} ms")
            cases.append(dict(
                case=name, dtype=str(dt)[6:], u=list(u.shape),
                landed=work["landed"], runs=work["runs"], max_abs_err=d,
                ms=ms, plain_ms=plain_ms, fill_ms=fill_ms, bytes=work["bytes"],
                bytes_all=work["bytes_all"], bound_ms=b_ms, bound_by=b_by,
                pct_of_bound=100 * b_ms / ms))
    print("[kernel] pillar_tables bytes as counted before (all of u, g4 and "
          "fi, padding and drop bucket included): " + ", ".join(
              f"{c['case']} {c['dtype']} {c['bytes_all']} (bound "
              f"{bound(c['bytes_all'], 0)[0]:.4f} ms)" for c in cases))
    # the row's numbers: the bf16 frame, as the bf16 serve path calls it;
    # every case is in "cases"
    head = next(c for c in cases if c["case"] == "frame"
                and c["dtype"] == "bfloat16")
    rows["pillar_tables"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, bytes=head["bytes"],
        pct_of_bound=head["pct_of_bound"], cases=cases)

    # kernel 2: the pyramid warp's canvases (4 non-ego agents; level sides
    # 292 / 148 / 76 with C = 65 / 129 / 257), shear-sized shifts; each
    # case forward (s) and backward (the kernel with -s on a gradient)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = worst_bwd = 0.0
    cases = []
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
                axis = 0 if name == "rows" else 1
                got = fn(x, s, ms_bound)
                want = plain(x, s, ms_bound)
                torch.cuda.synchronize()
                d, r = rel_err(got, want)
                if not r <= KERNEL_TOL[dt]:
                    raise AssertionError(f"shift_{name} {dt} {side}: {r}")
                worst = max(worst, d)
                fwd = dict(
                    err=d, rel=r, ms=device_ms(lambda: fn(x, s, ms_bound)),
                    plain_ms=device_ms(lambda: plain(x, s, ms_bound)),
                    **library_shift(x, s, axis, want))
                bwd = shift_backward(x, s, ms_bound, fn, plain, gen, axis)
                if not bwd["rel"] <= KERNEL_TOL[dt]:
                    raise AssertionError(f"shift_{name} backward {dt} {side}:"
                                         f" {bwd['rel']}")
                worst_bwd = max(worst_bwd, bwd["err"])
                nbytes = 2 * x.numel() * x.element_size() + s.numel() * 4
                b_ms, b_by = bound(nbytes, 3 * x.numel())
                for direction, m in (("forward", fwd), ("backward", bwd)):
                    print(f"[kernel] shift_{name} {direction} {str(dt)[6:]} x "
                          f"{tuple(x.shape)}: max_abs_err {m['err']:.3e} (rel "
                          f"{m['rel']:.3e}, tol {KERNEL_TOL[dt]}), "
                          f"{m['ms']:.4f} ms vs plain {m['plain_ms']:.4f} ms; "
                          f"{nbytes} bytes, bound {b_ms:.4f} ms ({b_by}), "
                          f"{100 * b_ms / m['ms']:.1f}% of bound; grid_sample "
                          f"{m['library_ms']:.4f} ms (max abs diff from plain "
                          f"{m['library_err']:.3e})"
                          + (f"; autograd through the plain forward "
                             f"{m['autograd_ms']:.4f} ms"
                             if "autograd_ms" in m else ""))
                    cases.append(dict(
                        dtype=str(dt)[6:], x=list(x.shape), axis=name,
                        direction=direction, max_abs_err=m["err"],
                        ms=m["ms"], plain_ms=m["plain_ms"],
                        library_ms=m["library_ms"],
                        library_err=m["library_err"], bytes=nbytes,
                        bound_ms=b_ms, pct_of_bound=100 * b_ms / m["ms"]))
    # the row's numbers: f32 level 0 rows forward, as the f32 serve path
    # calls it; every case is in "cases". Not a bf16 case: grid_sample
    # takes its grid in x's dtype, and a bf16 grid cannot hold the
    # coordinates, so there it does not compute the same function
    head = next(c for c in cases if c["dtype"] == "float32"
                and c["x"][1] == 292 and c["axis"] == "rows"
                and c["direction"] == "forward")
    rows["shift_rows"] = dict(
        max_abs_err=worst, backward_max_abs_err=worst_bwd, ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=head["library_ms"],
        bytes=head["bytes"], pct_of_bound=head["pct_of_bound"], cases=cases)
    return rows


def library_shift(x, s, axis, want) -> dict:
    """The yardstick for kernel 2: one ``F.grid_sample`` call (bilinear,
    zero padding, align_corners=True) on x viewed as NCHW, with a grid
    built beforehand whose x is j + s (rows) or whose y is i + s
    (columns). Only the call is timed; its largest difference from the
    plain version is reported (a bf16 grid cannot hold the coordinates
    exactly). The port never calls it."""
    import torch.nn.functional as F

    n, h, w, _ = x.shape
    i = torch.arange(h, device=x.device, dtype=torch.float32)[:, None]
    j = torch.arange(w, device=x.device, dtype=torch.float32)[None, :]
    if axis == 0:
        gx, gy = j + s[:, :, None], i.expand(h, w).expand(n, h, w)
    else:
        gx, gy = j.expand(h, w).expand(n, h, w), i + s[:, None, :]
    grid = torch.stack([2 * gx / (w - 1) - 1, 2 * gy / (h - 1) - 1],
                       dim=-1).to(x.dtype)
    src = x.permute(0, 3, 1, 2)

    def call():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    err = (call().permute(0, 2, 3, 1).float() - want.float()).abs().max()
    return dict(library_ms=device_ms(call), library_err=err.item())


def shift_backward(x, s, ms_bound, fn, plain, gen, axis) -> dict:
    """Kernel 2's backward against the plain backward plain(g, -s) on one
    shape: the error through autograd, the time of the backward launch
    (the kernel with -s; autograd also negates the shifts, a separate
    elementwise op), the grid_sample yardstick with -s, and for
    information autograd through the plain forward."""
    from heal_tpu_torch.ops import shift_rows

    g = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    xr = x.detach().clone().requires_grad_()
    (got,) = torch.autograd.grad(fn(xr, s, ms_bound), xr, g)
    want = plain(g, -s, ms_bound)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    yp = plain(xr, s, ms_bound)
    neg = -s
    return dict(
        err=err, rel=rel,
        ms=device_ms(lambda: shift_rows._shift(g, neg, ms_bound, axis,
                                             backward=True)),
        plain_ms=device_ms(lambda: plain(g, neg, ms_bound)),
        autograd_ms=device_ms(
            lambda: torch.autograd.grad(yp, xr, g, retain_graph=True)),
        **library_shift(g, neg, axis, want),
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
        t_ex = device_ms(
            lambda: warp_agents_to_ego(feats, aff, method="exact"))
        t_sh = device_ms(
            lambda: warp_agents_to_ego(feats, aff, method="shear"))
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
    rows["pillar_tables"]["train_launches"] = trained["pillar_tables"]
    rows["shift_rows"]["train_launches"] = trained["shift_rows"]
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
    for k in kernels:
        print(f"[kernels] {k['name']}: launches {k['launches']} serving, "
              f"{k['train_launches']} training forward"
              + (f", {k['backward_launches']} backward"
                 if "backward_launches" in k else "")
              + f"; {k['bytes']} bytes, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), {k['ms']:.4f} ms = {k['pct_of_bound']:.1f}%"
              f" of bound, plain {k['plain_ms']:.4f} ms, library call "
              + (f"{k['library_ms']:.4f} ms" if k["library_ms"] is not None
                 else "none"))
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
