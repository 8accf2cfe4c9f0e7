"""A reader for heal_tpu's ``.ckpt`` files (flax msgpack), in pure Python.

heal_tpu/tools/checkpoint.py writes ``flax.serialization.msgpack_serialize``
of ``{"params": ..., "batch_stats": ..., "epoch": E}``. This module reads
those bytes back to nested dicts of numpy arrays, as
``flax.serialization.msgpack_restore`` does, without ``msgpack``, ``flax``
or ``jax``:

  * msgpack's maps, arrays (as lists), str, bin, ints, floats, nil and
    bool, all big-endian;
  * flax's ext type 1, an ndarray packed as the msgpack triple
    (shape, dtype name, C-order bytes); ext type 3, a numpy scalar packed
    the same way (returned as the scalar); ext type 2, a complex number;
  * flax's chunked leaves (``{"__msgpack_chunked_array__": True, "shape",
    "chunks"}``, written for arrays above 1 GiB), reassembled.

A dtype numpy does not have (``bfloat16``) raises ``ValueError``: numpy
cannot hold it, and a silent cast would change the checkpoint. Arrays are
read-only views of the file's bytes, as flax returns them.
"""
from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        # raw: str comes back as bytes (flax reads the ndarray triple so)
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated input")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        return _ext(code, bytes(self.take(n)))

    def obj(self):
        t = self.unpack("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack("B"))),
            0xC5: lambda: bytes(self.take(self.unpack("H"))),
            0xC6: lambda: bytes(self.take(self.unpack("I"))),
            0xC7: lambda: self.ext(self.unpack("B")),
            0xC8: lambda: self.ext(self.unpack("H")),
            0xC9: lambda: self.ext(self.unpack("I")),
            0xCA: lambda: self.unpack("f"), 0xCB: lambda: self.unpack("d"),
            0xCC: lambda: self.unpack("B"), 0xCD: lambda: self.unpack("H"),
            0xCE: lambda: self.unpack("I"), 0xCF: lambda: self.unpack("Q"),
            0xD0: lambda: self.unpack("b"), 0xD1: lambda: self.unpack("h"),
            0xD2: lambda: self.unpack("i"), 0xD3: lambda: self.unpack("q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str_(self.unpack("B")),
            0xDA: lambda: self.str_(self.unpack("H")),
            0xDB: lambda: self.str_(self.unpack("I")),
            0xDC: lambda: [self.obj() for _ in range(self.unpack("H"))],
            0xDD: lambda: [self.obj() for _ in range(self.unpack("I"))],
            0xDE: lambda: self.map_(self.unpack("H")),
            0xDF: lambda: self.map_(self.unpack("I")),
        }
        if t not in fixed:
            raise ValueError(f"msgpack: byte 0x{t:02x} starts no object")
        return fixed[t]()

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def unpackb(data: bytes, raw: bool = False):
    """One msgpack object from ``data`` (all of it), flax's ext types
    decoded."""
    reader = _Reader(data, raw)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing bytes after the object")
    return out


def _dtype(name) -> np.dtype:
    name = name.decode() if isinstance(name, bytes) else name
    try:
        dt = np.dtype(name)
    except TypeError:
        dt = None
    # isbuiltin 2: a type registered from outside numpy (ml_dtypes'
    # bfloat16 once jax is imported), which a jax-free reader lacks
    if dt is None or dt.name != name or dt.isbuiltin != 1:
        raise ValueError(
            f"checkpoint leaf of dtype {name!r}: numpy has no such dtype, so "
            "it cannot be read without jax (save the checkpoint in float32)"
        )
    return dt


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=_dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"msgpack: ext type {code} is not one flax writes")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes):
    """``flax.serialization.msgpack_restore`` of ``data``."""
    return _unchunk(unpackb(data))


def read(path: str):
    """The tree of a heal_tpu ``.ckpt`` file."""
    with open(path, "rb") as f:
        return restore(f.read())
