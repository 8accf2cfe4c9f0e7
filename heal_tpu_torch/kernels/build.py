"""Build and bind the hand-written CUDA kernels of ``heal_tpu_torch/csrc``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for sm_90a, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes. The build
runs at first use, from the sources in this checkout only, into
``heal_tpu_torch/_build/<hash of the sources and flags>/`` (listed in
.gitignore), so a changed source rebuilds and an unchanged one loads the
cached library. Nothing here runs at import time.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
# --fmad=false: no multiply-add contraction, so each product rounds as in
# the plain PyTorch versions and kernel 2 agrees with its plain version bit
# for bit (kernels 1 and 2 are bound by bytes; kernel 3, bound by
# operations, writes its multiply-adds as explicit FMAs)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC",
]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signature of every entry point: (name, argtypes)
_SIGNATURES = {
    # u, g4, fi, weights, out, n, feat, nx, stride, cells, batch,
    # vx, vy, cx0, cy0, cz, stream
    "heal_pillar_tables_f32": [P, P, P, P, P, I, I, I, I, I, I,
                               F, F, F, F, F, P],
    "heal_pillar_tables_bf16": [P, P, P, P, P, I, I, I, I, I, I,
                                F, F, F, F, F, P],
    # x, shifts, out, n, h, w, c, axis, pad, stream
    "heal_shift_rows_f32": [P, P, P, I, I, I, I, I, I, P],
    "heal_shift_rows_bf16": [P, P, P, I, I, I, I, I, I, P],
    # feats, occ, table, weights, scale, shift, valid, out, out_occ,
    # batch, vc, ocap, z, zo, cin, cout, strided, eps, stream
    "heal_column_conv_f32": [P, P, P, P, P, P, P, P, P,
                             I, I, I, I, I, I, I, I, F, P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
            "kernels of heal_tpu_torch need the CUDA toolkit to build"
        )
    return found


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f)
        for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc_run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    log = " ".join(cmd) + "\n" + proc.stdout
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    return log


def _build(sources: list[str], out_dir: str) -> str:
    lib_path = os.path.join(out_dir, "libheal_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cus = [s for s in sources if s.endswith(".cu")]
    objs = [os.path.join(out_dir, f"{os.path.basename(s)}.{tag}.o")
            for s in cus]
    tmp = f"{lib_path}.{tag}"
    try:
        # one nvcc per source, all started together, then one link
        with ThreadPoolExecutor(len(cus)) as pool:
            logs = list(pool.map(_nvcc_run, [
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s]
                for o, s in zip(objs, cus)]))
        logs.append(_nvcc_run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs]))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(os.path.join(out_dir, "nvcc.log"), "w") as f:
        f.write("\n".join(logs))
    os.replace(tmp, lib_path)  # atomic: a concurrent builder sees all or none
    return lib_path


def bind(path: str, names=tuple(_SIGNATURES),
         signatures: dict = _SIGNATURES) -> ctypes.CDLL:
    """Load a built library and set the C signature of its entry points
    ``names`` (a library built from some of the sources has only theirs;
    one built from another version of a source may need ``signatures`` of
    its own)."""
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = signatures[name]
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library; builds it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            _lib = bind(_build(sources,
                               os.path.join(BUILD_ROOT, _digest(sources))))
    return _lib


def build_log() -> str:
    """nvcc's output of the cached build (registers, spills per kernel)."""
    sources = _sources()
    path = os.path.join(BUILD_ROOT, _digest(sources), "nvcc.log")
    with open(path) as f:
        return f.read()


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
