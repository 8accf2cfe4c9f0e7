"""Flax variables -> torch state_dict, and back.

The port names its modules, parameters and buffers after the flax paths
(``branch_m1.encoder.pfn_kernel``,
``pyramid_backbone.backbone.stages_0.BottleneckX_0.ConvNormAct_0.kernel``
...), so the key of a leaf is its flax path joined with dots. Only the
layouts differ:

  * conv kernels: flax HWIO (kh, kw, I, O) -> torch OIHW;
  * VoxelNet's 3D conv kernels: flax DHWIO (kd, kh, kw, I, O) -> torch
    OIDHW;
  * ``ConvTranspose_0/kernel``: flax (s, s, I, O) -> torch ConvTranspose2d
    (I, O, s, s), flipped on both spatial axes (flax's tap at output
    (i*s+di, j*s+dj) is kern[s-1-di, s-1-dj], heal_tpu layers.py:278-290);
  * ``pfn_kernel`` (10, F), norm scales/biases, conv biases and the
    batch statistics: as they are;
  * the fusion zoo's leaves (models/fuse/), which the port keeps in
    flax's layouts, so they pass as they are: ``Dense`` (in, out),
    ``LayerNorm`` scale / bias, the ``MultiHeadDotProductAttention``
    projections (query / key / value kernels (C, heads, dh) with (heads,
    dh) biases, ``out`` (heads, dh, C)), V2X-ViT's typed denses (T, C,
    D), its ``relation_att`` / ``relation_msg`` (T, T, heads, dh, dh),
    and the ``rel_pos_bias`` tables; only their convolutions (V2VNet's
    ``msg_cnn`` and GRU convs, DiscoNet's, Who2com's ``decode_layer``)
    are HWIO -> OIHW like every conv.

Inputs are nested dicts of numpy arrays (``jax.device_get(variables)``,
or a checkpoint); nothing here imports jax.
"""
from __future__ import annotations

import numpy as np
import torch

BATCH_STAT_LEAVES = ("mean", "var", "bn_mean", "bn_var")


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flatten(dict(value.items()), path))
        else:
            out[path] = np.asarray(value)
    return out


def _to_torch_layout(key: str, value: np.ndarray) -> np.ndarray:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "kernel" and value.ndim == 4:
        if key.endswith("ConvTranspose_0.kernel"):
            return value[::-1, ::-1].transpose(2, 3, 0, 1)
        return value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 5:
        return value.transpose(4, 3, 0, 1, 2)
    return value


def _to_flax_layout(key: str, value: np.ndarray) -> np.ndarray:
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "kernel" and value.ndim == 4:
        if key.endswith("ConvTranspose_0.kernel"):
            return value.transpose(2, 3, 0, 1)[::-1, ::-1]
        return value.transpose(2, 3, 1, 0)
    if leaf == "kernel" and value.ndim == 5:
        return value.transpose(2, 3, 4, 1, 0)
    return value


def from_flax(params: dict, batch_stats: dict | None = None,
              expected: dict | None = None) -> dict:
    """-> torch state_dict (f32 tensors).

    ``expected``: a module's state_dict. If given, raise on any flax leaf
    that maps to no port entry, on any port entry left unset, and on any
    shape that disagrees.
    """
    leaves = _flatten(params)
    stats = _flatten(batch_stats or {})
    clash = set(leaves) & set(stats)
    if clash:
        raise ValueError(f"params and batch_stats share keys: {sorted(clash)}")
    leaves.update(stats)
    sd = {
        # np.array copies: a flipped size-1 axis keeps a negative stride
        # that ascontiguousarray would pass through
        k: torch.from_numpy(np.array(_to_torch_layout(k, v), np.float32))
        for k, v in leaves.items()
    }
    if expected is not None:
        unmapped = sorted(set(sd) - set(expected))
        unset = sorted(set(expected) - set(sd))
        if unmapped or unset:
            raise KeyError(
                f"flax leaves with no port entry: {unmapped}; "
                f"port entries with no flax leaf: {unset}"
            )
        bad = [
            (k, tuple(sd[k].shape), tuple(expected[k].shape))
            for k in sd if sd[k].shape != expected[k].shape
        ]
        if bad:
            raise ValueError(f"shape mismatch (flax, port): {bad}")
    return sd


def load_flax(model: torch.nn.Module, params: dict,
              batch_stats: dict | None = None) -> torch.nn.Module:
    """Load flax variables into ``model`` in place (strict); returns it."""
    sd = from_flax(params, batch_stats, expected=model.state_dict())
    model.load_state_dict(sd, strict=True)
    return model


def to_flax(state_dict: dict) -> tuple[dict, dict]:
    """Inverse of :func:`from_flax`: -> (params, batch_stats) nested dicts
    of numpy arrays (f32).

    Takes any mapping of port keys to tensors: a state_dict (the running
    statistics after a train step land in batch_stats), or
    ``{name: p.grad for name, p in model.named_parameters()}``, whose
    params tree is then the gradient in flax layout."""
    params: dict = {}
    stats: dict = {}
    for key, value in state_dict.items():
        arr = np.array(
            _to_flax_layout(key, value.detach().float().cpu().numpy())
        )
        *path, leaf = key.split(".")
        tree = stats if leaf in BATCH_STAT_LEAVES else params
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = arr
    return params, stats
