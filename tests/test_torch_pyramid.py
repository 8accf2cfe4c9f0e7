"""Pyramid Fusion: weighted_fuse and PyramidFusion.forward_collab, port vs
JAX, on the CPU (exact warp on both sides), eval mode, f32.

Stated tolerance: 1e-5 relative and absolute for weighted_fuse (one warp
and a softmax); 1e-4 for forward_collab / forward_single, whose ~15
convolutions sum in a different order in XLA and oneDNN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.models.fuse import pyramid as jp
from heal_tpu_torch.models.fuse import pyramid as tp
from heal_tpu_torch.utils.bridge import load_flax

torch.set_num_threads(1)


def _affines(b, l, h, w, rng):
    aff = np.tile(np.array([[1.0, 0, 0], [0, 1, 0]], np.float32),
                  (b, l, l, 1, 1))
    for bi in range(b):
        for j in range(1, l):
            t = rng.uniform(-np.pi, np.pi)
            c, s = np.cos(t), np.sin(t)
            aff[bi, 0, j] = [[c, -s * h / w, rng.uniform(-0.6, 0.6)],
                             [s * w / h, c, rng.uniform(-0.6, 0.6)]]
    return aff


def test_weighted_fuse_masks_padding_and_out_of_fov():
    rng = np.random.RandomState(0)
    b, l, h, w, c = 2, 4, 12, 20, 5
    feats = rng.randn(b, l, h, w, c).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, (b, l, h, w, 1)).astype(np.float32)
    aff = _affines(b, l, h, w, rng)
    # sample 0, agent 1: translated half a map away -> exact-zero warped
    # scores (out of the sender's FOV) on a large part of the ego map
    aff[0, 0, 1] = [[1.0, 0.0, 1.0], [0.0, 1.0, 0.0]]
    mask = np.array([[True, True, True, False],   # padded agent slot
                     [True, True, False, False]])
    got = tp.weighted_fuse(torch.from_numpy(feats), torch.from_numpy(scores),
                           torch.from_numpy(aff), torch.from_numpy(mask))
    want = jp.weighted_fuse(jnp.asarray(feats), jnp.asarray(scores),
                            jnp.asarray(aff), jnp.asarray(mask))
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the padded slot carries no weight: zeroing its features changes nothing
    feats2 = feats.copy()
    feats2[0, 3] = 0.0
    got2 = tp.weighted_fuse(torch.from_numpy(feats2),
                            torch.from_numpy(scores), torch.from_numpy(aff),
                            torch.from_numpy(mask))
    np.testing.assert_array_equal(got2[0].numpy(), got[0].numpy())


@pytest.fixture(scope="module")
def fusion():
    """A flax PyramidFusion with seeded BN statistics, bridged to the port."""
    rng = np.random.RandomState(1)
    args = {
        "resnext": True, "width_per_group": 4, "layer_nums": [1, 2],
        "layer_strides": [1, 2], "num_filters": [16, 32],
        "upsample_strides": [1, 2], "num_upsample_filter": [8, 8],
    }
    b, l, h, w, c = 1, 3, 16, 24, 8
    x = rng.randn(b, l, h, w, c).astype(np.float32)
    jm = jp.PyramidFusion(args=args)
    v = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(x.reshape(b * l, h, w, c))))
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape) if p[-1].key == "var"
                      else rng.uniform(-0.3, 0.3, s.shape)
                      ).astype(np.float32),
        v["batch_stats"])
    tm = tp.PyramidFusion(args, c).eval()
    load_flax(tm, params, stats)
    return jm, {"params": params, "batch_stats": stats}, tm, x, rng


def test_forward_collab_matches_jax(fusion):
    jm, variables, tm, x, rng = fusion
    b, l, h, w, _ = x.shape
    aff = _affines(b, l, h, w, rng)
    mask = np.array([[True, True, False]])
    fused, occ = jax.jit(
        lambda vv, xx, aa, mm: jm.apply(vv, xx, aa, mm,
                                        method=jp.PyramidFusion.forward_collab)
    )(variables, jnp.asarray(x), jnp.asarray(aff), jnp.asarray(mask))
    with torch.no_grad():
        got, got_occ = tm.forward_collab(torch.from_numpy(x),
                                         torch.from_numpy(aff),
                                         torch.from_numpy(mask))
    assert got.shape == fused.shape == (b, h, w, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(fused), rtol=1e-4,
                               atol=1e-4)
    for g, want in zip(got_occ, occ):
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_forward_single_matches_jax(fusion):
    jm, variables, tm, x, _ = fusion
    flat = x.reshape((-1,) + x.shape[2:])
    dec, occ = jax.jit(lambda vv, xx: jm.apply(
        vv, xx, method=jp.PyramidFusion.forward_single))(
            variables, jnp.asarray(flat))
    with torch.no_grad():
        got, got_occ = tm.forward_single(torch.from_numpy(flat))
    assert got.shape == dec.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(dec), rtol=1e-4,
                               atol=1e-4)
    for g, want in zip(got_occ, occ):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
