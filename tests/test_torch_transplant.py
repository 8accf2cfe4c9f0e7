"""opencood checkpoints into the port: heal_tpu_torch.utils.transplant
against heal_tpu.utils.transplant, on the CPU.

A seeded synthetic opencood-named state_dict (``synthetic_reference``:
the keys and shapes heal_tpu's transplant reads) goes through
heal_tpu's transplant and the JAX forward of tests/configs/entry_tiny.yaml's
HeterPyramidCollab, and through the port's transplant and forward: the
port's state_dict equals the bridged JAX tree exactly and the heads agree
within 1e-5 (f32). The same for the SECOND encoder (SecondRefEncoder on a
small grid). The layout maps equal heal_tpu's exactly, and grouped ->
dense and the deconv's flip are held against F.conv2d(groups=...) and
F.conv_transpose2d directly.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from heal_tpu.config import load_yaml
from heal_tpu.data import build_dataset
from heal_tpu.models import build_model as build_flax
from heal_tpu.models import second as jax_second
from heal_tpu.utils import transplant as jt
from heal_tpu_torch.models import build_model as build_torch
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.models.second import SecondRefEncoder
from heal_tpu_torch.utils import transplant as tt
from heal_tpu_torch.utils.bridge import from_flax

torch.set_num_threads(1)
TINY = "tests/configs/entry_tiny.yaml"
HEADS = ("cls_preds", "reg_preds", "dir_preds")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (1.0 + np.abs(want).max()))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def test_layout_maps_equal_heal_tpu():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 6, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tt.conv_kernel(w), jt.conv_kernel(w))
    np.testing.assert_array_equal(tt.conv_kernel(torch.from_numpy(w)),
                                  jt.conv_kernel(w))
    d = rng.normal(size=(6, 4, 2, 2)).astype(np.float32)
    np.testing.assert_array_equal(tt.deconv_kernel(d), jt.deconv_kernel(d))
    g = rng.normal(size=(64, 2, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(tt.grouped_to_dense(g, 32),
                                  jt.grouped_to_dense(g, 32))
    s = rng.normal(size=(3, 1, 1, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(tt._spconv_kernel(s), jt._spconv_kernel(s))
    sd = {f"bn.{k}": rng.normal(size=4).astype(np.float32)
          for k in ("weight", "bias", "running_mean", "running_var")}
    for a, b in zip(tt._bn(sd, "bn"), jt._bn(sd, "bn")):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("groups,cin,cout", [(32, 64, 64), (4, 8, 12)])
def test_grouped_to_dense_is_the_grouped_conv(groups, cin, cout):
    gen = torch.Generator().manual_seed(groups)
    w = torch.randn((cout, cin // groups, 3, 3), generator=gen)
    x = torch.randn((2, cin, 9, 11), generator=gen)
    dense = torch.from_numpy(tt.grouped_to_dense(w, groups)).permute(
        3, 2, 0, 1)
    got = F.conv2d(x, dense, padding=1)
    want = F.conv2d(x, w, padding=1, groups=groups)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_deconv_kernel_is_the_transposed_conv(stride):
    gen = torch.Generator().manual_seed(stride)
    w = torch.randn((6, 5, stride, stride), generator=gen)
    x = torch.randn((2, 6, 7, 9), generator=gen)
    k = tt.deconv_kernel(w)  # flax (s, s, I, O), both spatial axes flipped
    flax_out = jax.lax.conv_transpose(
        jnp.asarray(x.permute(0, 2, 3, 1).numpy()), jnp.asarray(k),
        (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = F.conv_transpose2d(x, w, stride=stride)
    assert _rel(np.asarray(flax_out).transpose(0, 3, 1, 2),
                want.numpy()) <= 1e-5
    back = from_flax({"ConvTranspose_0": {"kernel": k}})
    assert torch.equal(back["ConvTranspose_0.kernel"], w)


@pytest.fixture(scope="module")
def tiny():
    cfg = load_yaml(TINY)
    batch = next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))
    jb = jax.tree.map(jnp.asarray, batch)
    jm = build_flax(cfg["model"])
    v = jax.device_get(jax.jit(lambda b: jm.init(
        jax.random.PRNGKey(0), b, train=False))(jb))
    return cfg, batch, jb, jm, v


def test_synthetic_reference_reaches_every_entry(tiny):
    cfg = tiny[0]
    sd = init_weights(build_torch(cfg["model"]),
                      torch.Generator().manual_seed(0)).state_dict()
    ref = tt.synthetic_reference(sd, seed=1)
    assert len(ref) == len(sd)
    # every entry comes from the reference: none keeps its init
    new = tt.transplant_heter_pyramid_collab(ref, sd, cfg["model"]["args"])
    assert new.keys() == sd.keys()
    assert not [k for k in sd if torch.equal(new[k], sd[k])]


def test_heter_pyramid_collab_transplant_matches_jax(tiny):
    cfg, batch, jb, jm, v = tiny
    tm = build_torch(cfg["model"])
    ref = tt.synthetic_reference(tm.state_dict(), seed=3)
    jv = jt.transplant_heter_pyramid_collab(ref, v, cfg["model"]["args"])
    want = jax.device_get(jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items()
        if k in HEADS})(jv, jb))
    new = tt.transplant_heter_pyramid_collab(ref, tm.state_dict(),
                                             cfg["model"]["args"])
    bridged = from_flax(jax.device_get(jv["params"]),
                        jax.device_get(jv["batch_stats"]))
    assert new.keys() == bridged.keys()
    for k in new:
        assert torch.equal(new[k], bridged[k]), k
    tm.load_state_dict(new, strict=True)
    with torch.no_grad():
        got = tm.eval()(_tensors({k: batch[k] for k in (
            "inputs_m1", "slots_m1", "agent_mask", "pairwise_affine")}))
    for k in HEADS:
        assert got[k].shape == want[k].shape
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
    assert np.abs(want["cls_preds"]).max() > 0


def test_transplant_checks_shapes_and_names(tiny):
    cfg = tiny[0]
    sd = build_torch(cfg["model"]).state_dict()
    ref = tt.synthetic_reference(sd, seed=2)
    bad = dict(ref)
    key = "cls_head.weight"
    bad[key] = torch.zeros((bad[key].shape[0] + 1,) + bad[key].shape[1:])
    with pytest.raises(ValueError, match="shape mismatch"):
        tt.transplant_heter_pyramid_collab(bad, sd, cfg["model"]["args"])
    args = copy.deepcopy(cfg["model"]["args"])
    args["m1"]["backbone_args"]["layer_nums"] = [2]
    with pytest.raises(KeyError):
        tt.transplant_heter_pyramid_collab(ref, sd, args)


SECOND_RANGE = (-8.0, -3.2, -3.0, 8.0, 3.2, 1.0)
SECOND_VOXEL = (0.4, 0.4, 4.0 / 24)
SECOND_CAPS = (512, 2304, 512, 64, 16)


def test_second_encoder_transplant_matches_jax():
    rng = np.random.default_rng(5)
    lo, hi = np.array(SECOND_RANGE[:3]), np.array(SECOND_RANGE[3:])
    pts = np.concatenate([rng.uniform(lo, hi, (1, 300, 3)),
                          rng.uniform(0, 1, (1, 300, 1))], -1).astype(
                              np.float32)
    mask = np.ones((1, 300), bool)
    tm = SecondRefEncoder(SECOND_VOXEL, SECOND_RANGE, SECOND_CAPS)
    ref = tt.synthetic_reference(tm.state_dict(), seed=4, prefix="")
    assert len(ref) == len(tm.state_dict()) == 60
    new = tt.transplant_second_encoder(ref, tm.state_dict(), prefix="")
    tm.load_state_dict(new, strict=True)

    p, s = jt.transplant_second_encoder(ref, "")
    jm = jax_second.SecondRefEncoder(voxel_size=SECOND_VOXEL,
                                     lidar_range=SECOND_RANGE,
                                     max_voxels=SECOND_CAPS)
    want = np.asarray(jax.jit(lambda pp, ss, x, m: jm.apply(
        {"params": {"VmapSecondRefStack_0": pp},
         "batch_stats": {"VmapSecondRefStack_0": ss}}, x, m,
        train=False))(p, s, pts, mask))
    bridged = from_flax({"VmapSecondRefStack_0": p},
                        {"VmapSecondRefStack_0": s})
    for k in new:
        assert torch.equal(new[k], bridged[k]), k
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(pts), torch.from_numpy(mask))
    assert got.shape == want.shape and np.abs(want).max() > 0
    assert _rel(got.numpy(), want) <= 1e-5
