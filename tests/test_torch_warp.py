"""Kernel 2 (row shift) and the BEV warps: port vs JAX.

The port runs on CPU torch, where ``shift_rows`` takes its plain version.
References: heal_tpu.ops.warp._shift_rows / _shift_cols (the semantics of
the Pallas kernel, as JAX runs it off the TPU), affine_warp,
affine_warp_shear and warp_agents_to_ego. Stated tolerances: 1e-6 for the
row shift (the same f32 arithmetic on both sides); 2e-5 for the warps,
whose angles and shear offsets are f32 trigonometry computed by two
libraries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.ops import warp as jw
from heal_tpu_torch.ops import warp as tw
from heal_tpu_torch.ops.shift_rows import shift_cols, shift_rows

torch.set_num_threads(1)
WARP_TOL = dict(rtol=2e-5, atol=2e-5)


def _jax_rows(fn, x, s, max_shift):
    return np.stack([np.asarray(fn(jnp.asarray(xi), jnp.asarray(si),
                                   max_shift)) for xi, si in zip(x, s)])


@pytest.mark.parametrize("kind", ["fractional", "integer", "negative",
                                  "clamped"])
@pytest.mark.parametrize("c", [1, 65])
def test_shift_rows_and_cols_match_jax(kind, c):
    rng = np.random.RandomState(c)
    n, h, w, max_shift = 2, 9, 13, 5
    x = rng.randn(n, h, w, c).astype(np.float32)
    s = rng.uniform(-max_shift, max_shift, (n, h)).astype(np.float32)
    if kind == "integer":
        s = np.round(s)
    elif kind == "negative":
        s = -np.abs(s)
    elif kind == "clamped":
        # at and past the bound the callers clip to: past max_shift + 2
        # the read position clamps to the padded row and the fraction
        # grows past 1, as in JAX's padded-row dynamic slice
        s[:, :4] = [max_shift, -max_shift, max_shift - 0.25, -max_shift]
        s[:, 4:] *= 3.0
    got = shift_rows(torch.from_numpy(x), torch.from_numpy(s), max_shift)
    want = _jax_rows(jw._shift_rows, x, s, max_shift)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    sc = rng.uniform(-max_shift, max_shift, (n, w)).astype(np.float32)
    if kind == "integer":
        sc = np.round(sc)
    got = shift_cols(torch.from_numpy(x), torch.from_numpy(sc), max_shift)
    want = _jax_rows(jw._shift_cols, x, sc, max_shift)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_shift_without_bound_and_integer_roll():
    x = np.arange(24, dtype=np.float32).reshape(1, 2, 12, 1)
    s = np.asarray([[2.0, -3.0]], np.float32)
    out = shift_rows(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(out[0, 0, :10, 0], np.arange(2, 12))
    np.testing.assert_array_equal(out[0, 0, 10:, 0], 0.0)
    np.testing.assert_array_equal(out[0, 1, 3:, 0], np.arange(12, 21))
    np.testing.assert_array_equal(out[0, 1, :3, 0], 0.0)


def _M(theta, h, w, tx=0.12, ty=-0.07):
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c, -s * h / w, tx], [s * w / h, c, ty]], np.float32)


@pytest.mark.parametrize("align_corners", [False, True])
def test_affine_warp_matches_jax(align_corners):
    rng = np.random.RandomState(0)
    h, w = 24, 40
    src = rng.randn(2, h, w, 3).astype(np.float32)
    ms = np.stack([_M(0.3, h, w), _M(-2.0, h, w, 0.3, 0.1)])
    got = tw.affine_warp(torch.from_numpy(src), torch.from_numpy(ms),
                         align_corners).numpy()
    for i in range(2):
        want = np.asarray(jw.affine_warp(jnp.asarray(src[i]),
                                         jnp.asarray(ms[i]), align_corners))
        np.testing.assert_allclose(got[i], want, **WARP_TOL)


def test_affine_warp_shear_matches_jax_in_every_sector():
    rng = np.random.RandomState(1)
    h, w = 20, 32
    src = rng.randn(1, h, w, 3).astype(np.float32)
    # one angle per 90-degree sector (all flip / rot90 selects), plus a
    # translation past the canvas margin (the final constant shifts)
    cases = [(0.3, 0.12, -0.07), (np.pi / 2 + 0.2, 0.12, -0.07),
             (np.pi + 0.35, -0.2, 0.1), (-np.pi / 2 - 0.1, 0.05, 0.3),
             (0.1, 1.7, -1.4)]
    ms = np.stack([_M(t, h, w, tx, ty) for t, tx, ty in cases])
    got = tw.affine_warp_shear(
        torch.from_numpy(np.repeat(src, len(cases), 0)),
        torch.from_numpy(ms)).numpy()
    for i in range(len(cases)):
        want = np.asarray(jw.affine_warp_shear(jnp.asarray(src[0]),
                                               jnp.asarray(ms[i])))
        assert np.abs(want).max() > 0 or i == len(cases) - 1
        np.testing.assert_allclose(got[i], want, **WARP_TOL)


@pytest.mark.parametrize("method", ["exact", "shear"])
@pytest.mark.parametrize("skip_ego", [True, False])
def test_warp_agents_to_ego_matches_jax(method, skip_ego):
    rng = np.random.RandomState(2)
    b, l, h, w, c = 2, 3, 16, 24, 4
    feats = rng.randn(b, l, h, w, c).astype(np.float32)
    aff = np.tile(np.array([[1.0, 0, 0], [0, 1, 0]], np.float32),
                  (b, l, l, 1, 1))
    for bi in range(b):
        for j in range(1, l):
            aff[bi, 0, j] = _M(0.4 * j - 0.9 * bi, h, w, 0.1 * j, -0.05)
    got = tw.warp_agents_to_ego(torch.from_numpy(feats),
                                torch.from_numpy(aff), method=method,
                                skip_ego=skip_ego).numpy()
    want = np.asarray(jw.warp_agents_to_ego(
        jnp.asarray(feats), jnp.asarray(aff), method=method,
        skip_ego=skip_ego))
    np.testing.assert_allclose(got, want, **WARP_TOL)


def test_auto_method_is_exact_on_cpu():
    rng = np.random.RandomState(3)
    feats = torch.from_numpy(rng.randn(1, 2, 8, 12, 2).astype(np.float32))
    aff = np.tile(np.array([[1.0, 0, 0], [0, 1, 0]], np.float32),
                  (1, 2, 2, 1, 1))
    aff[0, 0, 1] = _M(0.7, 8, 12)
    aff = torch.from_numpy(aff)
    np.testing.assert_array_equal(
        tw.warp_agents_to_ego(feats, aff).numpy(),
        tw.warp_agents_to_ego(feats, aff, method="exact").numpy())
