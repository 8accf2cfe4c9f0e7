"""The aligners, port vs JAX ``AlignNet``, on the CPU.

All eight backends (identity, res1x1, res3x3 and convnext, which the
shipped configs use, and scaligner, sdta, cbam and fanet) at width 8
with two blocks: a flax init (batch-norm parameters, running statistics,
LayerNorm parameters, the layer scales ``gamma`` / ``gamma_xca`` and
XCA's ``temperature`` randomised so that every term matters) bridged
strictly into the port. Inputs are 6x7 maps, fanet's 8x12 (its U needs
multiples of 4; the borders of its bilinear 2x upsampling are held
there). Compared in eval mode (the output) and in train mode (the
output, the updated running statistics, and the input and parameter
gradients of a seeded cotangent). Stated tolerance: 1e-5 relative and
absolute, as the other module tests (f32 sums in another order). sdta's
train case runs both packages in f64 (JAX under x64): its f32 gradients
are ill-conditioned at these scales, JAX's and the port's each up to
6e-5 off their own f64 values, so neither f32 run is a witness for the
other; in f64 they agree far inside the tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.models.aligner import AlignNet as JaxAlignNet
from heal_tpu_torch.models.aligner import AlignNet
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.utils.bridge import load_flax, to_flax
from test_torch_train_layers import _check_tree, _random_stats

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
DIM = 8
METHODS = ["identity", "res1x1", "res3x3", "convnext", "scaligner", "sdta",
           "cbam", "fanet"]
SIZE = {"fanet": (8, 12)}
F64 = ("sdta",)


def _flax_train(module, variables, x, cot):
    """-> (out, new batch_stats, grads of params, grad of x), jitted."""
    def f(params, xx):
        out, mut = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xx,
            train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut["batch_stats"])

    (_, (out, stats)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"],
                                          jnp.asarray(x))
    return jax.device_get((out, stats, gp, gx))


def _args(method):
    return {"core_method": method, "args": {"num_of_blocks": 2}}


def _randomise(params, rng):
    """Non-default values for every scale, bias and ``gamma`` leaf."""
    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "gamma", "gamma_xca", "temperature"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(params))


def _case(method):
    rng = np.random.RandomState(METHODS.index(method))
    hw = SIZE.get(method, (6, 7))
    x = rng.randn(2, *hw, DIM).astype(np.float32)
    cot = rng.randn(2, *hw, DIM).astype(np.float32)
    fm = JaxAlignNet(args=_args(method), dim=DIM)
    v = jax.device_get(jax.jit(fm.init)(jax.random.PRNGKey(0),
                                        jnp.asarray(x)))
    v = {"params": _randomise(v.get("params", {}), rng),
         "batch_stats": _random_stats(v.get("batch_stats", {}), rng)}
    tm = AlignNet(_args(method), dim=DIM)
    load_flax(tm, v["params"], v["batch_stats"])
    return fm, tm, v, x, cot


@pytest.mark.parametrize("method", METHODS)
def test_aligner_eval_matches_jax(method):
    fm, tm, v, x, _ = _case(method)
    want = jax.device_get(jax.jit(lambda vv, xx: fm.apply(
        vv, xx, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    if method != "identity":
        assert np.abs(want - x).max() > 0.1  # the blocks did something


@pytest.mark.parametrize("method", METHODS)
def test_aligner_train_matches_jax(method):
    fm, tm, v, x, cot = _case(method)
    dt = np.float64 if method in F64 else np.float32
    x, cot = x.astype(dt), cot.astype(dt)
    tm = tm.to(torch.float64) if method in F64 else tm
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tm.train()(xt)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    if method == "identity":
        assert not list(tm.parameters())
        np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(),
                                      cot)
        return
    with jax.enable_x64(method in F64):
        v = jax.tree.map(lambda a: np.asarray(a, dt), v)
        out, stats, gp, gx = _flax_train(fm, v, x, cot)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               out, **TOL)
    _check_tree(to_flax(tm.state_dict())[1], stats)
    _check_tree(to_flax({k: p.grad for k, p in tm.named_parameters()})[0],
                gp)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx,
                               **TOL)


def test_init_weights_convnext_gamma_is_flax_init():
    """``gamma`` starts at 1e-6 as flax inits it (aligner.py:52-54), not
    at the 0 ``init_weights`` gives other non-kernel leaves, which would
    make each block the identity with no gradient into its convs; the
    rest of the block follows flax's defaults too."""
    tm = init_weights(AlignNet(_args("convnext"), dim=DIM),
                      torch.Generator().manual_seed(0))
    fm = JaxAlignNet(args=_args("convnext"), dim=DIM)
    want = jax.device_get(fm.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 4, 4, DIM))))["params"]
    got = to_flax(tm.state_dict())[0]
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for i in range(2):
        block = got[f"ConvNeXtBlock_{i}"]
        np.testing.assert_array_equal(block["gamma"],
                                      np.full(DIM, 1e-6, np.float32))
        np.testing.assert_array_equal(block["gamma"],
                                      want[f"ConvNeXtBlock_{i}"]["gamma"])
        np.testing.assert_array_equal(block["LayerNorm_0"]["scale"],
                                      np.ones(DIM, np.float32))
        assert block["Conv_0"]["kernel"].shape == (7, 7, 1, DIM)
        assert np.abs(block["Dense_0"]["kernel"]).max() > 0
    x = torch.randn(1, DIM, 4, 4, requires_grad=True)
    tm.train()(x).sum().backward()
    assert tm.ConvNeXtBlock_0.Dense_0.kernel.grad.abs().max() > 0


@pytest.mark.parametrize("method", ["scaligner", "sdta", "cbam", "fanet"])
def test_init_weights_follows_flax_for_the_other_aligners(method):
    """``init_weights`` gives each backend flax's tree and its constant
    leaves: ``temperature`` 1 and ``gamma_xca`` 1e-6 (sdta), unit
    LayerNorm and batch-norm scales; and every parameter then has a
    gradient in train mode."""
    tm = init_weights(AlignNet(_args(method), dim=DIM),
                      torch.Generator().manual_seed(0))
    fm = JaxAlignNet(args=_args(method), dim=DIM)
    want = jax.device_get(jax.jit(fm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, DIM))))["params"]
    got = to_flax(tm.state_dict())[0]
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape, path
        if path[-1].key in ("temperature", "gamma_xca", "gamma", "scale"):
            np.testing.assert_array_equal(g, w)
    x = torch.randn(1, DIM, 8, 8, requires_grad=True)
    tm.train()(x).sum().backward()
    assert all(p.grad is not None for p in tm.parameters())
