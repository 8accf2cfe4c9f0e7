"""Flax -> torch weight bridge and layer parity (heal_tpu vs heal_tpu_torch).

Inputs and weights come from numpy with a fixed seed and go through both
the flax module and its port, on the CPU, in eval mode and f32. Stated
tolerance: 1e-5 relative and absolute — both sides are f32, but XLA's CPU
convolutions and oneDNN's sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml
from heal_tpu.data import build_dataset
from heal_tpu.models import build_model as build_flax
from heal_tpu.models import heads as jheads
from heal_tpu.models import layers as jl
from heal_tpu_torch.models import build_model as build_torch
from heal_tpu_torch.models import heads as theads
from heal_tpu_torch.models import layers as tl
from heal_tpu_torch.utils.bridge import from_flax, load_flax, to_flax

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = "tests/configs/entry_tiny.yaml"


def _randomize(tree, rng):
    """Seeded values for the leaves flax initialises to constants: BN
    scales and biases, conv biases, running means and variances (> 0).
    Kernels keep their seeded lecun-normal init."""
    def walk(t):
        out = {}
        for k, v in t.items():
            if hasattr(v, "items"):
                out[k] = walk(v)
                continue
            shape = np.shape(v)
            if k in ("kernel", "pfn_kernel"):
                out[k] = np.asarray(v, np.float32)
            elif k in ("scale", "bn_scale", "var", "bn_var"):
                out[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            else:
                out[k] = rng.uniform(-0.3, 0.3, shape).astype(np.float32)
        return out

    return walk(jax.device_get(tree))


def _flax_vars(module, x, seed=0):
    v = jax.device_get(
        jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.asarray(x)))
    rng = np.random.RandomState(seed)
    return _randomize(v["params"], rng), _randomize(
        v.get("batch_stats", {}), rng)


def _parity(flax_module, torch_module, x_nhwc, seed=0):
    params, stats = _flax_vars(flax_module, x_nhwc, seed)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    want = jax.jit(flax_module.apply)(variables, jnp.asarray(x_nhwc))
    load_flax(torch_module, params, stats)
    torch_module.eval()
    with torch.no_grad():
        got = torch_module(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return want, got


def _nchw_to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def tiny_flax():
    cfg = load_yaml(TINY)
    ds = build_dataset(cfg, train=False)
    batch = next(ds.batches(1, shuffle=False, process_split=False))
    model = build_flax(cfg["model"])
    # shapes only (no op-by-op init); the values are seeded numpy
    shapes = jax.eval_shape(
        lambda b: model.init(jax.random.PRNGKey(0), b, train=False),
        jax.tree.map(jnp.asarray, batch))
    rng = np.random.RandomState(0)
    v = jax.tree.map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    return cfg, v


def test_every_flax_leaf_maps_to_one_port_entry_and_back(tiny_flax):
    cfg, v = tiny_flax
    port = build_torch(cfg["model"])
    expected = port.state_dict()
    sd = from_flax(v["params"], v["batch_stats"], expected=expected)
    n_flax = len(jax.tree.leaves(v["params"])) + len(
        jax.tree.leaves(v["batch_stats"]))
    assert len(sd) == n_flax == len(expected)
    for k, t in sd.items():
        assert t.shape == expected[k].shape, k
    params, stats = to_flax(sd)
    for a, b in ((params, v["params"]), (stats, v["batch_stats"])):
        fa = jax.tree_util.tree_flatten_with_path(a)[0]
        fb = jax.tree_util.tree_flatten_with_path(b)[0]
        assert [p for p, _ in fa] == [p for p, _ in fb]
        for (_, x), (_, y) in zip(fa, fb):
            np.testing.assert_array_equal(x, np.asarray(y))


def test_bridge_raises_on_unmapped_and_unset(tiny_flax):
    cfg, v = tiny_flax
    expected = build_torch(cfg["model"]).state_dict()
    extra = dict(v["params"], stray={"kernel": np.zeros((1, 1, 1, 1))})
    with pytest.raises(KeyError, match="stray"):
        from_flax(extra, v["batch_stats"], expected=expected)
    missing = dict(v["params"])
    missing.pop("heads")
    with pytest.raises(KeyError, match="heads"):
        from_flax(missing, v["batch_stats"], expected=expected)


@pytest.mark.parametrize("kernel,stride,eps", [
    (3, 1, 1e-3), (3, 2, 1e-5), (1, 1, 1e-5), (1, 2, 1e-3),
])
def test_conv_norm_act(kernel, stride, eps):
    x = np.random.RandomState(1).randn(2, 12, 10, 8).astype(np.float32)
    fm = jl.ConvNormAct(16, kernel, stride, norm_eps=eps)
    tm = tl.ConvNormAct(8, 16, kernel, stride, norm_eps=eps)
    want, got = _parity(fm, tm, x)
    np.testing.assert_allclose(_nchw_to_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("cin,planes,stride,wpg", [
    (16, 16, 1, 4), (16, 32, 2, 2), (32, 32, 1, 2),
])
def test_bottleneck_x(cin, planes, stride, wpg):
    x = np.random.RandomState(2).randn(2, 8, 12, cin).astype(np.float32)
    fm = jl.BottleneckX(planes, stride=stride, width_per_group=wpg)
    tm = tl.BottleneckX(cin, planes, stride=stride, width_per_group=wpg)
    want, got = _parity(fm, tm, x)
    np.testing.assert_allclose(_nchw_to_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_deconv_norm_act(stride):
    x = np.random.RandomState(3).randn(2, 5, 7, 12).astype(np.float32)
    fm = jl.DeconvNormAct(8, stride)
    tm = tl.DeconvNormAct(12, 8, stride)
    want, got = _parity(fm, tm, x)
    assert got.shape == (2, 8, 5 * stride, 7 * stride)
    np.testing.assert_allclose(_nchw_to_nhwc(got), np.asarray(want), **TOL)


def test_basic_block_and_stage():
    x = np.random.RandomState(4).randn(1, 8, 8, 8).astype(np.float32)
    fm = jl.ResNetStage(planes=16, blocks=2, stride=2)
    tm = tl.ResNetStage(8, 16, 2, stride=2)
    want, got = _parity(fm, tm, x)
    np.testing.assert_allclose(_nchw_to_nhwc(got), np.asarray(want), **TOL)


def test_downsample_conv():
    x = np.random.RandomState(5).randn(2, 9, 11, 12).astype(np.float32)
    fm = jl.DownsampleConv(dims=(16, 8), kernels=(3, 3), strides=(1, 2),
                           paddings=(1, 1))
    tm = tl.DownsampleConv(12, (16, 8), (3, 3), (1, 2), (1, 1))
    want, got = _parity(fm, tm, x)
    np.testing.assert_allclose(_nchw_to_nhwc(got), np.asarray(want), **TOL)


def test_detection_heads():
    x = np.random.RandomState(6).randn(2, 6, 10, 16).astype(np.float32)
    fm = jheads.DetectionHeads(anchor_number=2, use_dir=True, num_bins=2)
    tm = theads.DetectionHeads(16, anchor_number=2, use_dir=True, num_bins=2)
    want, got = _parity(fm, tm, x)
    for k in ("cls_preds", "reg_preds", "dir_preds"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)
