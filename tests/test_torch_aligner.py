"""The ported aligners, port vs JAX ``AlignNet``, on the CPU.

identity, res1x1, res3x3 and convnext (the backends the shipped configs
use) at width 8 with two blocks: a flax init (batch-norm parameters,
running statistics, LayerNorm parameters and ConvNeXt's ``gamma``
randomised so that every term matters) bridged into the port. Compared in
eval mode (the output) and in train mode (the output, the updated running
statistics, and the input and parameter gradients of a seeded
cotangent). Stated tolerance: 1e-5 relative and absolute, as the other
module tests (f32 sums in another order).
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
from test_torch_train_layers import _check_tree, _flax_train, _random_stats

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
DIM = 8
METHODS = ["identity", "res1x1", "res3x3", "convnext"]


def _args(method):
    return {"core_method": method, "args": {"num_of_blocks": 2}}


def _randomise(params, rng):
    """Non-default values for every scale, bias and ``gamma`` leaf."""
    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "gamma"):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(params))


def _case(method):
    rng = np.random.RandomState(METHODS.index(method))
    x = rng.randn(2, 6, 7, DIM).astype(np.float32)
    cot = rng.randn(2, 6, 7, DIM).astype(np.float32)
    fm = JaxAlignNet(args=_args(method), dim=DIM)
    v = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = {"params": _randomise(v.get("params", {}), rng),
         "batch_stats": _random_stats(v.get("batch_stats", {}), rng)}
    tm = AlignNet(_args(method), dim=DIM)
    load_flax(tm, v["params"], v["batch_stats"])
    return fm, tm, v, x, cot


@pytest.mark.parametrize("method", METHODS)
def test_aligner_eval_matches_jax(method):
    fm, tm, v, x, _ = _case(method)
    want = jax.device_get(fm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)
    if method != "identity":
        assert np.abs(want - x).max() > 0.1  # the blocks did something


@pytest.mark.parametrize("method", METHODS)
def test_aligner_train_matches_jax(method):
    fm, tm, v, x, cot = _case(method)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tm.train()(xt)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    if method == "identity":
        assert not list(tm.parameters())
        np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(),
                                      cot)
        return
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
def test_unported_aligners_raise(method):
    with pytest.raises(NotImplementedError, match="item 12"):
        AlignNet({"core_method": method}, dim=DIM)
