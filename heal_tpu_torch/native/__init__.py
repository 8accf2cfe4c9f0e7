"""The native (C++) host data-loader core, with ctypes bindings.

The port's copy of heal_tpu/native: ``bbox_overlaps`` (the f32 anchor
IoU of target assignment), ``read_pcd``, ``range_filter_pad`` and
``voxelize`` from ``loader.cpp``. The library is built with ``g++`` at
first use, never at import, into ``heal_tpu_torch/_build/native-<digest>/``
(listed in .gitignore), with the JAX package's flags
(heal_tpu/native/build.py), so that both libraries compute the same bits
on one host. The digest covers the source, the flags and the host (its
name, machine and CPU model and flags): a library built for one CPU
with ``-march=native`` is never loaded on another. A failed build or
load raises; unlike the JAX package, nothing falls back to numpy. The
numpy versions (``utils/box_np.standup_iou_matrix``,
``data/opv2v._load_pcd_numpy``, :func:`range_filter_pad_numpy`) are the
plain references the tests hold the library to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "loader.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")
# heal_tpu/native/build.py's flags
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def _host_key() -> bytes:
    """What ``-march=native`` depends on: the host and its CPU."""
    cpu = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"model name", b"flags")):
                    cpu += line
                if line.strip() == b"":
                    break  # the first processor's block
    except OSError:
        pass
    return " ".join((platform.node(), platform.machine())).encode() + cpu


def library_path() -> str:
    """Where this source, these flags and this host's library lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(_host_key())
    return os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}",
                        "libheal_loader.so")


def build(path: str) -> str:
    """Compile ``loader.cpp`` into ``path`` (atomically: a concurrent
    builder sees the whole library or none); raises on failure."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: heal_tpu_torch's native host "
                           "loader needs a C++ compiler") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded library; built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            _lib = _bind(ctypes.CDLL(path))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    lib.bbox_overlaps.restype = None
    lib.bbox_overlaps.argtypes = [f32p, i64, f32p, i64, f32p, ctypes.c_int]
    lib.range_filter_pad.restype = i64
    lib.range_filter_pad.argtypes = [f32p, i64, f32p, f32p, u8p, i64]
    lib.read_pcd.restype = i64
    lib.read_pcd.argtypes = [ctypes.c_char_p, f32p, i64]
    lib.voxelize.restype = i64
    lib.voxelize.argtypes = [f32p, i64, f32p, f32p, i64, i64, f32p, i32p,
                             i32p]
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _rows4(a, what: str) -> np.ndarray:
    """``a`` as a C-contiguous (N, 4) f32 array, the layout the library
    reads; anything else raises."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"{what}: want (N, 4), got {a.shape}")
    return a


def _six(limit_range) -> np.ndarray:
    r = np.asarray(limit_range, dtype=np.float32)
    if r.shape != (6,):
        raise ValueError(f"limit_range: want 6 values, got {r.shape}")
    return r


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray,
                  plus_one: bool = True) -> np.ndarray:
    """(N, 4) x (K, 4) [x1 y1 x2 y2] -> (N, K) f32 IoU matrix."""
    lib = load()
    boxes, query = _rows4(boxes, "boxes"), _rows4(query, "query")
    out = np.empty((len(boxes), len(query)), dtype=np.float32)
    lib.bbox_overlaps(_fp(boxes), len(boxes), _fp(query), len(query),
                      _fp(out), 1 if plus_one else 0)
    return out


def read_pcd(path: str, cap: int = 200_000) -> np.ndarray:
    """PCD file -> (N, 4) f32 [x y z intensity]. The reader returns the
    file's point count; past ``cap`` the read is retried with a buffer
    that holds them all, so nothing is cut."""
    lib = load()
    while True:
        out = np.empty((cap, 4), dtype=np.float32)
        n = lib.read_pcd(os.fsencode(path), _fp(out), cap)
        if n < 0:
            raise IOError(f"failed to read pcd {path}")
        if n <= cap:
            return out[:n].copy()
        cap = int(n)


def range_filter_pad(points: np.ndarray, limit_range, max_out: int):
    """The points inside ``limit_range`` (x0 y0 z0 x1 y1 z1, bounds
    included), in order, padded with zeros to ``max_out`` -> (points,
    mask)."""
    lib = load()
    pts, rng = _rows4(points, "points"), _six(limit_range)
    out = np.empty((max_out, 4), dtype=np.float32)
    mask = np.empty(max_out, dtype=np.uint8)
    lib.range_filter_pad(
        _fp(pts), len(pts), _fp(rng), _fp(out),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_out)
    return out, mask.astype(bool)


def range_filter_pad_numpy(points: np.ndarray, limit_range, max_out: int):
    """The plain numpy version of :func:`range_filter_pad` (the JAX
    package's fallback)."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    r = limit_range
    m = ((pts[:, 0] >= r[0]) & (pts[:, 0] <= r[3])
         & (pts[:, 1] >= r[1]) & (pts[:, 1] <= r[4])
         & (pts[:, 2] >= r[2]) & (pts[:, 2] <= r[5]))
    sel = pts[m][:max_out]
    out = np.zeros((max_out, 4), np.float32)
    mask = np.zeros(max_out, bool)
    out[: len(sel)] = sel
    mask[: len(sel)] = True
    return out, mask


def voxelize(points, limit_range, voxel_size, max_voxels: int,
             max_points: int):
    """spconv-style host voxelization -> (voxels (V, P, 4), coords (V, 3)
    z y x, counts (V,)), the voxels in order of their first point."""
    lib = load()
    pts, rng = _rows4(points, "points"), _six(limit_range)
    vs = np.asarray(voxel_size, dtype=np.float32)
    if vs.shape != (3,):
        raise ValueError(f"voxel_size: want 3 values, got {vs.shape}")
    voxels = np.zeros((max_voxels, max_points, 4), dtype=np.float32)
    coords = np.zeros((max_voxels, 3), dtype=np.int32)
    counts = np.zeros(max_voxels, dtype=np.int32)
    used = lib.voxelize(
        _fp(pts), len(pts), _fp(rng), _fp(vs), max_voxels, max_points,
        _fp(voxels), coords.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return voxels[:used], coords[:used], counts[:used]
