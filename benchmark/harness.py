"""What every run shares: the manifest and the files it names, the
device facts, the per-layer readers, the correctness verdict and the
result line.

Everything that belongs to one configuration, traffic mix or metric is
a file of its own, found by its name in BENCHMARK.json:

  * ``configs/<config>.json``: the frozen published YAML (``hypes``),
    its precision, and the limits of the numbers that decide
    ``correct``, by mode;
  * ``traffic/<traffic>.json``: the mix: the mode (a module
    ``<mode>.py`` beside this file), the distinct frames or batches, the
    scene sizes the generator (``traffic/scenes.py``) draws;
  * ``reference/<config>.py``: the plain reference of the configuration;
  * ``metrics/<metric>.py``: the reader of one per-layer metric.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# modules the process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "heal_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The workload entry ``name``, with its configuration and traffic
    files read, and the per-layer metrics that list it."""
    bench = bench or manifest()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         + ", ".join(w["name"] for w in bench["workloads"]))
    w = dict(found[0])
    w["config_file"] = load_json(HERE, "configs", f"{w['config']}.json")
    w["traffic_file"] = load_json(HERE, "traffic", f"{w['traffic']}.json")
    w["end_to_end"] = [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])]
    w["per_layer"] = [m for m in bench["per_layer"]
                      if name in m["workloads"]]
    return w


def limits(c: dict) -> dict:
    """The limits of the numbers that decide ``correct`` in cell ``c``:
    its configuration file's, for the traffic's mode."""
    return c["config_file"]["limits"][c["traffic_file"]["mode"]]


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` (names may hold dots) as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    key = f"benchmark.{kind}.{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def mode(name: str):
    return importlib.import_module(f"benchmark.{name}")


def reference(config: str):
    return importlib.import_module(f"benchmark.reference.{config}")


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k, v in sys.modules.items()
                   if v is not None} & set(FORBIDDEN))


def device_facts(torch, count: int) -> dict:
    """The ``count`` cards a cell runs on."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is
    within it (a missing or non-finite number is not)."""
    checks, ok = {}, True
    for key, limit in limits.items():
        value = numbers.get(key)
        good = value is not None and value == value and value <= limit
        ok &= good
        checks[key] = {"value": value, "limit": limit}
    return ok, checks


def print_checks(checks: dict) -> None:
    for key, c in checks.items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)


def read_metrics(specs: list, ctx: dict) -> dict:
    """Each per-layer metric's reader on the traced run; a reader that
    finds nothing returns None and the metric is left out."""
    out = {}
    for spec in specs:
        value = module("metrics", spec["name"]).read(ctx)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out
