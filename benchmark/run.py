"""Run one cell of BENCHMARK.json once and print one JSON line.

    python benchmark/run.py --workload flagship.serve --seed 7 \
        --seconds 40 --trace 0

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` its
per-layer metrics, from spans registered on the program from outside,
a profiled stretch after the window and the readers under ``metrics/``.
Every run checks what the timed path produced against the plain
reference (``check.py``) and prints each number compared beside its
limit, last on standard error and last in the result line.

Set-up (``setup_s``) runs from the start of this process to the start
of the window: imports, CUDA, the kernels' build (cached under
heal_tpu_torch/_build/ in the checkout), the scenes and their host
assembly, the weights and the warm-up of the cell's shapes. Exits
non-zero without a result when there is no CUDA device, when a JAX
module is loaded, or when a file the cell names is missing.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one host thread: the load is one client, and idle pool threads spinning
# beside it on a shared host only add jitter
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# caches of the program's builds, at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser("benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    args = parse(argv)
    try:
        from benchmark import harness
        c = harness.cell(args.workload)
        runner = harness.mode(c["traffic_file"]["mode"])
        ref = harness.reference(c["config"])
    except (OSError, ImportError, KeyError) as e:
        fail(f"the cell's files are incomplete: {e!r}", 2)
    if importlib.util.find_spec("heal_tpu_torch") is None:
        fail("the program (heal_tpu_torch) is not in this checkout", 2)
    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < c["chips"]):
        fail(f"needs {c['chips']} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
             2)
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    res = runner.run(c, args, device, T_START, ref)

    bad = harness.forbidden_modules()
    if bad:
        fail(f"the process holds {bad} after the window", 3)
    correct, checks = harness.verdict(res["numbers"], harness.limits(c))
    facts = harness.device_facts(torch, c["chips"])
    facts["memory_peak_bytes"] = res["memory_peak_bytes"]
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": 0 if correct else res["attempted"]}
    if args.trace:
        ctx = dict(res["ctx"], cell=c)
        out["metrics"] = harness.read_metrics(c["per_layer"], ctx)
        red = ctx.get("trace") or {}
        facts["busy_s"] = red.get("busy_s", 0.0)
        facts["window_s"] = red.get("window_s", 0.0)
        if red:
            out["breakdown"] = {"device_ops": red["device_ops"],
                                "idle_gaps": red["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in c["end_to_end"]}
        out["metrics"] = {k: {"value": v, "unit": units[k]}
                          for k, v in res["end_to_end"].items()
                          if k in units}
    out["device"] = facts
    out["checks"] = checks
    print("numbers: " + json.dumps(res["numbers"]), file=sys.stderr)
    harness.print_checks(checks)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
