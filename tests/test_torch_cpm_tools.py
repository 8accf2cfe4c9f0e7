"""The port's CPM size measurement and the run dir's source snapshot, on
the CPU.

``heal_tpu_torch.utils.cpm_size`` against ``heal_tpu.utils.cpm_size`` on
the same seeded numpy messages: the byte counts equal exactly (an empty
message included) and the PLY files byte-equal; ``tools/train.py``'s
``backup_source`` snapshots the package without its built kernels and
loaders.
"""
import os

import numpy as np
import pytest
import torch

from heal_tpu.utils import cpm_size as jax_cpm
from heal_tpu_torch.tools.train import backup_source
from heal_tpu_torch.utils import cpm_size

torch.set_num_threads(1)


def _message(n: int, f: int, seed: int):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    feats = rng.normal(0, 1, (n, f)).astype(np.float32)
    return coords, feats


@pytest.mark.parametrize("n,f,bits", [
    (0, 16, (14, 8)), (1, 4, (14, 8)), (128, 32, (14, 8)),
    (512, 64, (12, 8)), (300, 8, (20, 12))])
def test_cpm_size_bytes_equal_heal_tpu(n, f, bits):
    coords, feats = _message(n, f, seed=n)
    kw = {"coord_bits": bits[0], "feat_bits": bits[1]}
    got = cpm_size.cpm_size_bytes(coords, feats, **kw)
    assert got == jax_cpm.cpm_size_bytes(coords, feats, **kw)
    assert got["raw"] == (n * 3 + n * f) * 4
    sizes = [got, cpm_size.cpm_size_bytes(*_message(n + 7, f, 1), **kw)]
    for key in ("raw", "quantized", "compressed"):
        assert cpm_size.avg_cpm_kb(sizes, key) == jax_cpm.avg_cpm_kb(
            sizes, key)
    assert cpm_size.avg_cpm_kb([]) == jax_cpm.avg_cpm_kb([]) == 0.0


@pytest.mark.parametrize("n", [0, 64])
def test_save_ply_byte_equal_heal_tpu(tmp_path, n):
    coords, feats = _message(n, 12, seed=3)
    got = cpm_size.save_ply(str(tmp_path / "port" / "kp.ply"), coords, feats)
    want = jax_cpm.save_ply(str(tmp_path / "jax" / "kp.ply"), coords, feats)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_backup_source_leaves_built_files_out(tmp_path):
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(
        cpm_size.__file__)))
    build = os.path.join(pkg, "_build", "snapshot_probe")
    os.makedirs(build, exist_ok=True)
    probe = os.path.join(build, "libprobe.so")
    open(probe, "wb").close()
    try:
        backup_source(str(tmp_path))
    finally:
        os.remove(probe)
        os.rmdir(build)
    snap = tmp_path / "scripts" / "heal_tpu_torch"
    assert (snap / "__init__.py").is_file()
    assert (snap / "tools" / "train.py").read_text() == open(
        os.path.join(pkg, "tools", "train.py")).read()
    assert (snap / "csrc" / "shift_rows.cu").is_file()
    names = [os.path.join(d, f) for d, ds, fs in os.walk(snap)
             for f in fs + ds]
    assert not [p for p in names if p.endswith((".so", ".o", "_build",
                                                "__pycache__"))]
    # a run dir that has its snapshot keeps it
    (snap / "tools" / "train.py").write_text("kept")
    backup_source(str(tmp_path))
    assert (snap / "tools" / "train.py").read_text() == "kept"
