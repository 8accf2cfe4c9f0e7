"""Train-mode layers, port vs JAX: batch-statistics ``Norm``, the blocks
built on it, and the PointPillars encoder's fused train path.

Inputs are seeded numpy, weights flax inits (BN parameters and running
statistics randomised), on the CPU in f32. Compared: outputs, the updated
running statistics (flax ``mutable=["batch_stats"]``) and the gradients
of a seeded cotangent. Stated tolerance: 1e-5 relative and absolute
(XLA and torch sum in different orders; the batch moments are f32 means
over every element of a channel). The encoder's max/sum over pillars uses
``index_add`` / ``scatter_reduce`` here and XLA segment ops in JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.models import layers as jl
from heal_tpu.models.encoders import PointPillarEncoder as JaxEncoder
from heal_tpu_torch.models import layers as tl
from heal_tpu_torch.models.encoders import PointPillarEncoder
from heal_tpu_torch.ops import pillar
from heal_tpu_torch.utils.bridge import load_flax, to_flax
from test_torch_pillar import _points

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _flax_train(module, variables, x, cot):
    """-> (out, new batch_stats, grads of params, grad of x)."""
    def f(params, xx):
        out, mut = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, xx,
            train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut["batch_stats"])

    (_, (out, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))
    return jax.device_get((out, stats, gp, gx))


def _random_stats(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape)
                      if p[-1].key in ("var", "bn_var")
                      else rng.uniform(-0.3, 0.3, s.shape)).astype(np.float32),
        jax.device_get(tree))


def _check_tree(got: dict, want: dict, tol=TOL):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=str(path), **tol)


@pytest.mark.parametrize("kind", ["batch", "batch@0.99"])
@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_norm_train_matches_flax(kind, eps):
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 6, 7, 8) * 2 + 0.5).astype(np.float32)
    cot = rng.randn(3, 6, 7, 8).astype(np.float32)
    fm = jl.Norm(kind, epsilon=eps)
    v = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                    "bias": rng.uniform(-0.3, 0.3, 8).astype(np.float32)},
         "batch_stats": _random_stats(v["batch_stats"], rng)}
    out, stats, gp, gx = _flax_train(fm, v, x, cot)

    tm = tl.Norm(8, kind, epsilon=eps).train()
    load_flax(tm, v["params"], v["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tm(xt)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               out, **TOL)
    _check_tree(to_flax(tm.state_dict())[1], stats)
    _check_tree(to_flax({k: p.grad for k, p in tm.named_parameters()})[0],
                gp)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx,
                               **TOL)
    assert tm.mean.dtype == tm.var.dtype == torch.float32


@pytest.mark.parametrize("block", ["basic", "bottleneck_x"])
def test_blocks_train_match_flax(block):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 12, 16).astype(np.float32)
    if block == "basic":
        fm, tm = jl.BasicBlock(32, stride=2), tl.BasicBlock(16, 32, stride=2)
    else:
        fm = jl.BottleneckX(32, stride=2, width_per_group=4)
        tm = tl.BottleneckX(16, 32, stride=2, width_per_group=4)
    v = jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = {"params": v["params"],
         "batch_stats": _random_stats(v["batch_stats"], rng)}
    cot = rng.randn(2, 4, 6, 32).astype(np.float32)
    out, stats, gp, gx = _flax_train(fm, v, x, cot)

    load_flax(tm, v["params"], v["batch_stats"])
    tm.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = tm(xt)
    (got.permute(0, 2, 3, 1) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               out, **TOL)
    _check_tree(to_flax(tm.state_dict())[1], stats)
    _check_tree(to_flax({k: p.grad for k, p in tm.named_parameters()})[0],
                gp)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx,
                               **TOL)


@pytest.mark.parametrize("case", ["unsorted", "presorted", "duplicates"])
def test_encoder_train_matches_jax(case):
    """Canvas, updated bn_mean / bn_var and the gradients of pfn_kernel,
    bn_scale and bn_bias. "duplicates": repeated points tie in their
    pillar's segment max; torch's amax gradient splits evenly among ties
    and JAX's segment_max gradient averages them too, and since the tied
    points carry identical features the parameter gradients agree
    however a tie is split."""
    lidar_range = (-9.6, -6.4, -3.0, 9.6, 6.4, 1.0)
    voxel = (0.8, 0.8, 4.0)
    presorted = case == "presorted"
    pts, mask = _points(11, 2, 700, lidar_range, voxel, presorted)
    if case == "duplicates":
        pts[:, 300:340] = pts[:, 200:240]
        mask[:, 300:340] = mask[:, 200:240] = True
    cot = np.random.RandomState(2).randn(2, 16, 24, 16).astype(np.float32)
    jenc = JaxEncoder(voxel_size=voxel, lidar_range=lidar_range,
                      num_filters=(16,), presorted=presorted)
    v = jax.device_get(jenc.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                                 jnp.asarray(mask)))
    rng = np.random.RandomState(3)
    params = dict(v["params"],
                  bn_scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
                  bn_bias=rng.uniform(-0.3, 0.3, 16).astype(np.float32))
    stats = {"bn_mean": rng.uniform(-0.3, 0.3, 16).astype(np.float32),
             "bn_var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}

    def f(p):
        out, mut = jenc.apply({"params": p, "batch_stats": stats},
                              jnp.asarray(pts), jnp.asarray(mask),
                              train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut["batch_stats"])

    (_, (want, want_stats)), gp = jax.device_get(
        jax.value_and_grad(f, has_aux=True)(params))

    enc = PointPillarEncoder(voxel, lidar_range, (16,), presorted=presorted)
    load_flax(enc, params, stats)
    enc.train()
    before = pillar.pillar_tables.launches
    got = enc(torch.from_numpy(pts), torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    assert pillar.pillar_tables.launches == before  # kernel 1 is eval-only
    assert got.shape == want.shape == (2, 16, 24, 16)
    assert (want != 0).any(axis=-1).sum() > 50
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    _check_tree(to_flax(enc.state_dict())[1], want_stats)
    _check_tree(to_flax({k: p.grad for k, p in enc.named_parameters()})[0],
                gp)


def test_pillar_tables_raises_under_grad():
    """Kernel 1 has no backward: a call autograd would differentiate
    raises instead of returning a canvas with no graph."""
    grid = pillar.PillarGrid(2, 4, 5, 1.0, 1.0, 0.5, 0.5, 0.0)
    u = torch.zeros((3, 8), requires_grad=True)
    args = (torch.zeros((3, 4)), torch.zeros(3, dtype=torch.int32),
            torch.zeros((7, 8)), grid, 1)
    with pytest.raises(RuntimeError, match="no backward"):
        pillar.pillar_tables(u, *args)
    with torch.no_grad():
        assert pillar.pillar_tables(u, *args).shape == (4, 8)
    # the eval-mode encoder with grad enabled reaches it with a graph too
    enc = PointPillarEncoder((0.8, 0.8, 4.0), (-1.6, -1.6, -3, 1.6, 1.6, 1),
                             (8,))
    tl.init_weights(enc, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no backward"):
        enc.eval()(torch.zeros((1, 5, 4)), torch.ones((1, 5), dtype=bool))
