"""A/B timing of two builds of kernel 2 (csrc/shift_rows.cu) on one card.

    python -m heal_tpu_torch.tools.kernel_ab --old DIR --build DIR

``--old`` holds another version of ``shift_rows.cu`` and its
``common.cuh`` (with the same C entry points); this checkout's
``heal_tpu_torch/csrc`` is the new one. The old one is compiled by
kernels/build.py into its own shared library under ``--build`` (one
directory per hash of the sources), the new one is the port's own build
(``build.library()``). Both are timed in turns (old, new, new, old) at
the three pyramid levels of the flagship config (x (4, 292, 292, 65), (4, 148, 148, 129),
(4, 76, 76, 257)), rows and columns, f32 and bf16, forward (shift s) and
backward (the same kernel with -s on an output gradient): 24 cases. Each
time is CUDA events around ``ITERS`` launches queued behind a spin
kernel (kernels/measure.py), so it is device time, not the host's launch
rate. Every case also checks new and old against the plain PyTorch
version. Prints one line per case and, last, one JSON object with all of
them; the bound is the bytes read once and written once over 3.35 TB/s.
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
from ..kernels.measure import bound, device_ms
from ..ops import shift_rows as sr

LEVELS = ((292, 65), (148, 129), (76, 257))
ITERS = 50
ENTRIES = ("heal_shift_rows_f32", "heal_shift_rows_bf16")


def launcher(lib, x, s, pad, axis):
    """A no-argument launch of lib's kernel on (x, s) into a fixed output."""
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser("kernel 2 A/B")
    p.add_argument("--old", required=True)
    p.add_argument("--build", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(2) as pool:
        srcs = [os.path.join(args.old, f)
                for f in ("common.cuh", "shift_rows.cu")]
        old_path = pool.submit(build._build, srcs,
                               os.path.join(args.build, build._digest(srcs)))
        new = pool.submit(build.library).result()
        old = build.bind(old_path.result(), ENTRIES)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {smi}")
    dev = torch.device("cuda")
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
    print(f"[card] {smi}")
    print(json.dumps({"card": smi, "iters": ITERS, "cases": cases}))
    bad = [c for c in cases if c["new_err"] != 0.0]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
