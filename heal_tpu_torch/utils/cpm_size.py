"""CPM (collaborative perception message) size measurement.

The port's copy of heal_tpu/utils/cpm_size.py (numpy, zlib and os only,
so the sizes are the same bytes): the bandwidth an agent would transmit,
keypoint coordinates + features for two-stage models (FPV-RCNN), or the
sparse BEV cells Where2comm sends. The reference shells out to Google's
draco binary; this measures sizes with in-process codecs:

- ``save_ply`` writes the same ascii PLY the reference emits (so an
  external draco binary can still be pointed at the dump), and
- ``cpm_size_bytes`` reports raw / quantized / zlib-compressed sizes,
  the quantize+entropy-code pipeline being what draco's sequential codec
  does for point attributes.

A message on the card is taken to the host once a frame
(``x.float().cpu().numpy()``) and measured here.
"""
from __future__ import annotations

import os
import zlib

import numpy as np


def save_ply(path: str, coords: np.ndarray, features: np.ndarray) -> str:
    """Write keypoints (N, 3) + features (N, F) as ascii PLY
    (ref draco_compression.save_ply layout: x y z feat0..featF-1)."""
    coords = np.asarray(coords, np.float32)
    features = np.asarray(features, np.float32)
    n, f = features.shape
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        + "".join(f"property float feat{i}\n" for i in range(f))
        + "end_header"
    )
    data = np.concatenate([coords, features], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savetxt(path, data, delimiter=" ", header=header, comments="")
    return path


def cpm_size_bytes(
    coords: np.ndarray,
    features: np.ndarray,
    coord_bits: int = 14,
    feat_bits: int = 8,
    coord_range: float = 204.8,
) -> dict:
    """Transmitted-message size under three encodings.

    Returns {"raw", "quantized", "compressed"} byte counts: f32 payload,
    fixed-point quantization (draco's -qp/-qg analogue: coord_bits for
    positions over +-coord_range/2, feat_bits for per-channel min/max
    scaled features), and zlib over the quantized buffer.
    """
    coords = np.asarray(coords, np.float32)
    features = np.asarray(features, np.float32)
    n, f = features.shape
    raw = (coords.size + features.size) * 4

    # fixed-point coords
    cq = np.clip(
        (coords / coord_range + 0.5) * (2**coord_bits - 1),
        0,
        2**coord_bits - 1,
    ).astype(np.uint16 if coord_bits <= 16 else np.uint32)
    # per-channel affine quantization of features
    lo = features.min(axis=0, keepdims=True) if n else np.zeros((1, f))
    hi = features.max(axis=0, keepdims=True) if n else np.ones((1, f))
    span = np.maximum(hi - lo, 1e-12)
    fq = np.clip(
        (features - lo) / span * (2**feat_bits - 1), 0, 2**feat_bits - 1
    ).astype(np.uint8 if feat_bits <= 8 else np.uint16)
    quantized = (
        coords.shape[0] * coords.shape[1] * ((coord_bits + 7) // 8)
        + n * f * ((feat_bits + 7) // 8)
        + f * 8  # per-channel (lo, scale) side info
    )
    compressed = len(zlib.compress(cq.tobytes() + fq.tobytes(), level=6))
    return {"raw": raw, "quantized": quantized, "compressed": compressed}


def avg_cpm_kb(sizes: list, key: str = "compressed") -> float:
    """Average size in KB over per-frame measurements."""
    if not sizes:
        return 0.0
    return float(np.mean([s[key] for s in sizes])) / 1024.0
