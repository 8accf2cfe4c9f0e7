"""Kernel 2 (row shift) and the BEV warps: port vs JAX, forward and backward.

The port runs on CPU torch, where ``shift_rows`` takes its plain version
in both directions. References: heal_tpu.ops.warp._shift_rows /
_shift_cols (the semantics of the Pallas kernel, as JAX runs it off the
TPU) and their ``jax.vjp``, affine_warp, affine_warp_shear and
warp_agents_to_ego. Stated tolerances: 1e-6 for the row shift and its
gradient (the same f32 arithmetic on both sides: a gradient element sums
at most two taps); 2e-5 for the warps, whose angles and shear offsets are
f32 trigonometry computed by two libraries.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.ops import warp as jw
from heal_tpu_torch.ops import warp as tw
from heal_tpu_torch.ops.shift_rows import (
    shift_cols,
    shift_cols_plain,
    shift_rows,
    shift_rows_plain,
)

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


@pytest.mark.parametrize("kind", ["fractional", "integer", "negative"])
@pytest.mark.parametrize("c", [1, 65])
@pytest.mark.parametrize("axis", [0, 1])
def test_shift_backward_matches_jax_vjp_and_transpose(kind, c, axis):
    """x.grad through the autograd.Function: the VJP of JAX's CPU form,
    and the explicit transpose (the shift by -s), for |s| <= max_shift."""
    rng = np.random.RandomState(10 * c + axis)
    n, h, w, max_shift = 2, 9, 13, 5
    x = rng.randn(n, h, w, c).astype(np.float32)
    g = rng.randn(n, h, w, c).astype(np.float32)
    s = rng.uniform(-max_shift, max_shift, (n, (h, w)[axis]))
    s[:, :2] = [max_shift, -max_shift]  # at the bound
    if kind == "integer":
        s = np.round(s)
    elif kind == "negative":
        s = -np.abs(s)
    s = s.astype(np.float32)
    fn, plain, jfn = ((shift_rows, shift_rows_plain, jw._shift_rows)
                      if axis == 0 else
                      (shift_cols, shift_cols_plain, jw._shift_cols))
    xt = torch.from_numpy(x).requires_grad_()
    fn(xt, torch.from_numpy(s), max_shift).backward(torch.from_numpy(g))
    want = np.stack([
        np.asarray(jax.vjp(lambda xi: jfn(xi, jnp.asarray(si), max_shift),
                           jnp.asarray(xi))[1](jnp.asarray(gi))[0])
        for xi, si, gi in zip(x, s, g)])
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    transpose = plain(torch.from_numpy(g), torch.from_numpy(-s), max_shift)
    np.testing.assert_allclose(xt.grad.numpy(), transpose.numpy(), rtol=1e-6,
                               atol=1e-6)


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


def test_affine_warp_shear_input_gradient_matches_jax_vjp():
    rng = np.random.RandomState(4)
    h, w = 20, 32
    src = rng.randn(4, h, w, 3).astype(np.float32)
    g = rng.randn(4, h, w, 3).astype(np.float32)
    # one angle per 90-degree sector
    cases = [(0.3, 0.12, -0.07), (np.pi / 2 + 0.2, -0.1, 0.05),
             (np.pi + 0.35, -0.2, 0.1), (-np.pi / 2 - 0.1, 0.05, 0.3)]
    ms = np.stack([_M(t, h, w, tx, ty) for t, tx, ty in cases])
    xt = torch.from_numpy(src).requires_grad_()
    tw.affine_warp_shear(xt, torch.from_numpy(ms)).backward(
        torch.from_numpy(g))
    for i in range(len(cases)):
        _, vjp = jax.vjp(
            lambda x: jw.affine_warp_shear(x, jnp.asarray(ms[i])),
            jnp.asarray(src[i]))
        want = np.asarray(vjp(jnp.asarray(g[i]))[0])
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(xt.grad[i].numpy(), want, **WARP_TOL)


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
