"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program. Module names are compared by
their top-level name, whole: ``heal_tpu_torch`` is not ``heal_tpu``."""
from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import harness

JAX = ("jax", "jaxlib", "flax", "optax", "heal_tpu")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(harness.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & set(JAX), path


def test_the_references_import_nothing_of_the_program():
    for path in _sources("reference"):
        assert not set(_imports(path)) & set(JAX + ("heal_tpu_torch",)), path


def _run(code: str, blocked) -> subprocess.CompletedProcess:
    pre = ("import sys\n" + "".join(f"sys.modules[{m!r}] = None\n"
                                    for m in blocked)
           + f"sys.path.insert(0, {harness.ROOT!r})\n")
    return subprocess.run([sys.executable, "-c", pre + code],
                          capture_output=True, text=True, timeout=600,
                          cwd=harness.ROOT)


def test_a_run_loads_no_jax_module():
    """A whole tiny serve run, with the JAX modules made unimportable;
    the harness's own look finds none loaded afterwards."""
    r = _run(
        "import time, torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import harness\n"
        "from benchmark.tests import tiny\n"
        "c = tiny.cell('flagship.serve')\n"
        "harness.mode('serve').run(c, tiny.args(), 'cpu', time.perf_counter(),"
        " harness.reference('flagship'))\n"
        "assert not harness.forbidden_modules()\n"
        "print('ok')\n", JAX)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_the_references_run_without_the_program():
    code = (
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from benchmark import harness, weights\n"
        "from benchmark.reference import assemble\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.traffic import scenes\n"
        "for cell in {cells!r}:\n"
        "    c = tiny.cell(cell)\n"
        "    h = c['config_file']['hypes']\n"
        "    m = harness.reference(c['config']).build(h).eval()\n"
        "    m.load_state_dict(weights.make(weights.shapes_of(m), 1, 'cpu'))\n"
        "    s = scenes.scenes(h, c['traffic_file'], 1, 1)[0]\n"
        "    b = assemble.to_device(assemble.collate(\n"
        "        [assemble.assemble(h, s, False)]), 'cpu')\n"
        "    with torch.no_grad():\n"
        "        m(b)\n"
        "import sys\n"
        "assert not {{k.split('.')[0] for k, v in sys.modules.items() if v}} & "
        "{{'heal_tpu_torch', 'heal_tpu', 'jax'}}\n"
        "print('ok')\n").format(cells=SERVE)
    r = _run(code, JAX + ("heal_tpu_torch",))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


SERVE = ["flagship.serve", "alliance.serve"]
