"""Build and bind the hand-written CUDA kernels of ``heal_tpu_torch/csrc``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` for sm_90a, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded with ctypes. The build
runs at first use, from the sources in this checkout only, into
``heal_tpu_torch/_build/<hash of the sources and flags>/`` (listed in
.gitignore), so a changed source rebuilds and an unchanged one loads the
cached library. Nothing here runs at import time.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``. Every op of ``heal_tpu_torch/ops`` that launches a
kernel keeps one contract: :func:`expect` checks the tensors' shapes,
dtypes, contiguity, device and alignment, and :func:`launch` calls the
entry point on the current stream, raises on its error code and counts
the launch for the tracer.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import trace

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
# --fmad=false: no multiply-add contraction, so each product rounds as in
# the plain PyTorch versions and kernel 2 agrees with its plain version bit
# for bit (kernels 1 and 2 are bound by bytes; kernels 3 and 4, bound by
# operations, write their multiply-adds as explicit FMAs)
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
    # qkv, table, out, n, h, w, heads, window, dh, scale, stream
    "heal_window_attention_f32": [P, P, P, I, I, I, I, I, I, F, P],
}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

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


def _build() -> str:
    """The built library of this checkout's sources, built if absent."""
    sources = _sources()
    out_dir = os.path.join(BUILD_ROOT, _digest(sources))
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


def library() -> ctypes.CDLL:
    """The loaded kernel library, every entry point's C signature set;
    builds it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def build_log() -> str:
    """nvcc's output of the cached build (registers, spills per kernel)."""
    path = os.path.join(BUILD_ROOT, _digest(_sources()), "nvcc.log")
    with open(path) as f:
        return f.read()


def takes_kernel(*tensors: torch.Tensor) -> bool:
    """Whether an f32, eval-only kernel (3 or 4) takes a call with these
    float arguments: all on the card, all f32, and no gradient wanted
    through any. Its op takes the plain version otherwise."""
    return (all(t.is_cuda and t.dtype == torch.float32 for t in tensors)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in tensors)))


def expect(what: str, specs, aligned=()) -> None:
    """The launch contract's checks: each (tensor, shape, dtype) of
    ``specs`` has that shape and dtype, is contiguous and sits on the
    first one's device, and each tensor of ``aligned`` starts on a 16-byte
    boundary (the kernel reads it in 16-byte vectors). Raises ValueError,
    the message led by ``what``."""
    device = specs[0][0].device
    for t, shape, dtype in specs:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{what}: expected {tuple(shape)} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"{what}: inputs must be contiguous, one "
                             "device")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{what}: inputs must be 16-byte aligned")


def launch(what: str, kernel: str, counter: str, out: torch.Tensor,
           *args) -> None:
    """Launch entry point ``heal_<kernel>_<f32|bf16>`` for ``out``'s dtype
    (TypeError where none is built) with ``args`` (a tensor passes its
    data pointer, None a null one) on the current stream of ``out``'s
    device, raise on the error code it returns, and count the launch
    under ``counter`` when ``out`` is not empty (the kernel launches
    nothing then). ``what`` leads the messages."""
    entry = f"heal_{kernel}_{_SUFFIX.get(out.dtype)}"
    if entry not in _SIGNATURES:
        raise TypeError(f"{what}: no kernel for {out.dtype}")
    code = getattr(library(), entry)(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        torch.cuda.current_stream(out.device).cuda_stream)
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
    if out.numel():
        trace.count(counter)
