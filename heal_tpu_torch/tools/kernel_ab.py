"""A/B timing of two builds of one CUDA kernel of heal_tpu_torch on one card.

    python -m heal_tpu_torch.tools.kernel_ab --old DIR --build DIR
    python -m heal_tpu_torch.tools.kernel_ab --kernel pillar_tables \
        --old DIR --build DIR

``--old`` holds another version of the kernel's source and its
``common.cuh``; this checkout's ``heal_tpu_torch/csrc`` is the new one. The
old one is compiled by kernels/build.py into its own shared library under
``--build`` (one directory per hash of the sources), the new one is the
port's own build (``build.library()``). Both are timed in turns (old, new,
new, old). Each time is CUDA events around ``ITERS`` calls queued behind a
spin kernel (kernels/measure.py), so it is device time, not the host's
launch rate; a call that synchronises pays its round trip to the host.
Every case also checks new and old against the plain PyTorch version.
Prints one line per case and, last, one JSON object with all of them.

Kernel 2 (``shift_rows.cu``, the same C entry points on both sides): the
three pyramid levels of the flagship config (x (4, 292, 292, 65),
(4, 148, 148, 129), (4, 76, 76, 257)), rows and columns, f32 and bf16,
forward (shift s) and backward (the same kernel with -s on an output
gradient): 24 cases; the bound is the bytes read once and written once
over 3.35 TB/s.

Kernel 1 (``pillar_tables.cu``): the old source is the one-block-per-run
kernel, bound here with its own C signature (run starts and their count)
and called as its wrapper called it: a zeroed canvas, the run starts from
change flags through ``torch.nonzero`` (a host sync), then the kernel. The
new side is ``ops.pillar.pillar_tables``. Cases, f32 and bf16: (a) the
encoder's inputs on the first synthetic flagship frame, (b) a frame as
dense as OPV2V lidar (kernels/cases.py); the bound is the work of
``cases.pillar_work``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..kernels import build
from ..kernels.cases import dense_inputs, frame_inputs, pillar_work
from ..kernels.measure import bound, device_ms
from ..ops import pillar
from ..ops import shift_rows as sr

LEVELS = ((292, 65), (148, 129), (76, 257))
ITERS = 50
SOURCES = {"shift_rows": ("common.cuh", "shift_rows.cu"),
           "pillar_tables": ("common.cuh", "pillar_tables.cu")}
ENTRIES = {"shift_rows": ("heal_shift_rows_f32", "heal_shift_rows_bf16"),
           "pillar_tables": ("heal_pillar_tables_f32",
                             "heal_pillar_tables_bf16")}
# kernel 1's C signature before its redesign: u, g4, fi, starts, weights,
# out, n_runs, feat, nx, stride, cells, batch, vx, vy, cx0, cy0, cz, stream
OLD_PILLAR_SIGNATURES = {
    name: [build.P] * 6 + [build.I] * 6 + [build.F] * 5 + [build.P]
    for name in ENTRIES["pillar_tables"]
}
# max |kernel - plain| <= tol * (1 + max |plain|), as in chip_smoke.py
PILLAR_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# kernel 1's cases come from this config's first test frame (run from the
# repository's root)
FLAGSHIP = os.path.join("heal_tpu", "configs", "opv2v_m1_pyramid.yaml")


def launcher(lib, x, s, pad, axis):
    """A no-argument launch of lib's kernel 2 on (x, s) into a fixed
    output."""
    out = torch.empty_like(x)
    entry = (lib.heal_shift_rows_f32 if x.dtype == torch.float32
             else lib.heal_shift_rows_bf16)
    n, h, w, c = x.shape
    args = (x.data_ptr(), s.data_ptr(), out.data_ptr(), n, h, w, c, axis,
            pad)

    def run():
        code = entry(*args, torch.cuda.current_stream().cuda_stream)
        build.check(code, "shift_rows")
        return out

    return run


def old_pillar_call(lib, args):
    """A no-argument call of the one-block-per-run kernel 1 as its wrapper
    made it: a zeroed canvas, run starts through ``torch.nonzero``, which
    reads their count back to the host, then one block per run."""
    u, g4, fi, weights, grid, batch = args
    n, f = u.shape
    entry = (lib.heal_pillar_tables_f32 if u.dtype == torch.float32
             else lib.heal_pillar_tables_bf16)

    def run():
        canvas = torch.zeros((batch * grid.stride, f), dtype=u.dtype,
                             device=u.device)
        flags = torch.ones(n, dtype=torch.bool, device=u.device)
        flags[1:] = fi[1:] != fi[:-1]
        starts = torch.cat([
            torch.nonzero(flags).flatten().to(torch.int32),
            torch.tensor([n], dtype=torch.int32, device=u.device),
        ])
        code = entry(
            u.data_ptr(), g4.data_ptr(), fi.data_ptr(), starts.data_ptr(),
            weights.data_ptr(), canvas.data_ptr(), starts.numel() - 1, f,
            grid.nx, grid.stride, grid.cells, batch, grid.vx, grid.vy,
            grid.cx0, grid.cy0, grid.cz,
            torch.cuda.current_stream().cuda_stream)
        build.check(code, "old pillar_tables")
        return canvas

    return run


def shift_cases(old, new, dev) -> tuple[list, bool]:
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for side, c in LEVELS:
            ms_bound = int(math.ceil(0.7072 * side / 2)) + 2
            pad = ms_bound + 2
            x = torch.randn((4, side, side, c), generator=gen,
                            device=dev).to(dt)
            g = torch.randn(x.shape, generator=gen, device=dev).to(dt)
            for axis, name in ((0, "rows"), (1, "cols")):
                s = ((torch.rand((4, side), generator=gen, device=dev) * 2
                      - 1) * ms_bound).contiguous()
                plain = (sr.shift_rows_plain if axis == 0
                         else sr.shift_cols_plain)
                for direction, inp, sh in (("forward", x, s),
                                           ("backward", g, -s)):
                    f_old = launcher(old, inp, sh, pad, axis)
                    f_new = launcher(new, inp, sh, pad, axis)
                    want = plain(inp, sh, ms_bound)
                    d_new = (f_new().float() - want.float()).abs().max().item()
                    d_old = (f_old().float() - want.float()).abs().max().item()
                    t = [device_ms(f, ITERS)
                         for f in (f_old, f_new, f_new, f_old)]
                    nbytes = (2 * inp.numel() * inp.element_size()
                              + sh.numel() * 4)
                    b_ms = bound(nbytes, 3 * inp.numel())[0]
                    row = dict(
                        dtype=str(dt)[6:], x=list(inp.shape), axis=name,
                        direction=direction, old_ms=[t[0], t[3]],
                        new_ms=[t[1], t[2]], bytes=nbytes, bound_ms=b_ms,
                        new_pct_of_bound=100 * b_ms / (0.5 * (t[1] + t[2])),
                        old_pct_of_bound=100 * b_ms / (0.5 * (t[0] + t[3])),
                        new_err=d_new, old_err=d_old)
                    cases.append(row)
                    print(f"[ab] {row['dtype']} {tuple(inp.shape)} {name} "
                          f"{direction}: old {t[0]:.4f}/{t[3]:.4f} ms, new "
                          f"{t[1]:.4f}/{t[2]:.4f} ms, bound {b_ms:.4f} ms "
                          f"(new {row['new_pct_of_bound']:.1f}%); max abs err "
                          f"vs plain new {d_new:.3e} old {d_old:.3e}")
                    del f_old, f_new, want
    return cases, all(c["new_err"] == 0.0 for c in cases)


def pillar_cases(old, dev) -> tuple[list, bool]:
    from .inference import build_weights
    from .train import device_batches, load_config

    cfg = load_config(FLAGSHIP)
    enc = build_weights(cfg, seed=0).branch_m1.encoder.to(dev)
    batch, _ = next(device_batches(cfg, 1, dev, train=False))
    pts = batch["inputs_m1"]["points"][0]
    msk = batch["inputs_m1"]["point_mask"][0]
    cases, ok = [], True
    for dt in (torch.float32, torch.bfloat16):
        for name, args in (
            ("frame", frame_inputs(enc, pts, msk, dt)),
            ("dense", dense_inputs(enc.grid(), pts.shape[0],
                                   enc.out_channels, dt, dev, 0,
                                   points=pts.shape[1])),
        ):
            f_old = old_pillar_call(old, args)

            def f_new():
                return pillar.pillar_tables(*args)

            want = pillar.pillar_tables_plain(*args).float()
            scale = 1.0 + want.abs().max().item()
            d_new = (f_new().float() - want).abs().max().item()
            d_old = (f_old().float() - want).abs().max().item()
            t = [device_ms(f, ITERS) for f in (f_old, f_new, f_new, f_old)]
            work = pillar_work(args)
            b_ms = bound(work["bytes"], work["flops"])[0]
            row = dict(
                case=name, dtype=str(dt)[6:], u=list(args[0].shape),
                landed=work["landed"], runs=work["runs"],
                old_ms=[t[0], t[3]], new_ms=[t[1], t[2]],
                bytes=work["bytes"], bound_ms=b_ms,
                new_pct_of_bound=100 * b_ms / (0.5 * (t[1] + t[2])),
                old_pct_of_bound=100 * b_ms / (0.5 * (t[0] + t[3])),
                new_err=d_new, old_err=d_old)
            ok &= max(d_new, d_old) <= PILLAR_TOL[dt] * scale
            cases.append(row)
            print(f"[ab] pillar_tables {name} {row['dtype']} u "
                  f"{tuple(row['u'])} ({work['landed']} points in "
                  f"{work['runs']} pillars land): old {t[0]:.4f}/{t[3]:.4f} "
                  f"ms, new {t[1]:.4f}/{t[2]:.4f} ms, bound {b_ms:.4f} ms "
                  f"(new {row['new_pct_of_bound']:.1f}%, old "
                  f"{row['old_pct_of_bound']:.1f}%); max abs err vs plain "
                  f"new {d_new:.3e} old {d_old:.3e} (tol {PILLAR_TOL[dt]} x "
                  f"{scale:.3f})")
            del f_old, want
    return cases, ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser("kernel A/B")
    p.add_argument("--kernel", choices=sorted(SOURCES), default="shift_rows")
    p.add_argument("--old", required=True)
    p.add_argument("--build", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(2) as pool:
        srcs = [os.path.join(args.old, f) for f in SOURCES[args.kernel]]
        old_path = pool.submit(build._build, srcs,
                               os.path.join(args.build, build._digest(srcs)))
        new = pool.submit(build.library).result()
        if args.kernel == "pillar_tables":
            old = build.bind(old_path.result(), ENTRIES[args.kernel],
                             OLD_PILLAR_SIGNATURES)
        else:
            old = build.bind(old_path.result(), ENTRIES[args.kernel])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    dev = torch.device("cuda")
    if args.kernel == "pillar_tables":
        cases, ok = pillar_cases(old, dev)
    else:
        cases, ok = shift_cases(old, new, dev)
    print(f"[card] {smi}")
    print(json.dumps({"card": smi, "kernel": args.kernel, "iters": ITERS,
                      "cases": cases}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
