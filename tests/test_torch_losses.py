"""Detection and pyramid losses, port vs JAX.

Seeded random predictions against the real targets of one
tests/configs/entry_tiny.yaml training batch (two samples, three agent
slots of which one is padding, so the "_single" targets hold empty
slots). Compared: the total, every aux term and the gradients with
respect to every prediction. Stated tolerance: 1e-5 relative and
absolute (f32 sums over a few thousand anchors, taken in a different
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml
from heal_tpu.data import build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.parallel.trainer import _single_targets as jax_single
from heal_tpu_torch.models import build_loss
from heal_tpu_torch.parallel.trainer import _label_targets, _single_targets

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TINY = "tests/configs/entry_tiny.yaml"


@pytest.fixture(scope="module")
def tiny():
    cfg = load_yaml(TINY)
    batch = next(build_dataset(cfg, train=True).batches(
        2, shuffle=False, process_split=False))
    assert (batch["pos_equal_one"] > 0).any()
    assert not batch["agent_mask"].all()  # a padded slot
    return cfg, batch


def _preds(cfg, batch, mode, rng):
    """Random NHWC predictions shaped as the model's outputs."""
    b, l = batch["agent_mask"].shape
    h, w, a = batch["pos_equal_one"].shape[1:]
    n_occ = b * l if mode == "collab" else b
    out = {"cls_preds": rng.randn(b, h, w, a) * 2,
           "reg_preds": rng.randn(b, h, w, 7 * a),
           "dir_preds": rng.randn(b, h, w, 2 * a)}
    ks = cfg["loss"]["args"]["pyramid"]["relative_downsample"]
    out["occ_single_list"] = [rng.randn(n_occ, h // k, w // k, 1) * 2
                              for k in ks]
    return jax.tree.map(lambda x: x.astype(np.float32), out)


def _run_both(loss_cfg, preds, targets, suffix, mode):
    jloss = build_jax_loss(loss_cfg)

    def jf(p):
        return jloss(dict(p, pyramid=mode), jax.tree.map(jnp.asarray,
                                                         targets), suffix)

    (jtotal, jaux), jgrad = jax.value_and_grad(jf, has_aux=True)(
        jax.tree.map(jnp.asarray, preds))
    tloss = build_loss(loss_cfg)
    tp = jax.tree.map(lambda x: torch.from_numpy(x).requires_grad_(), preds)
    ttotal, taux = tloss(dict(tp, pyramid=mode),
                         jax.tree.map(torch.from_numpy, targets), suffix)
    ttotal.backward()
    return (jax.device_get((jtotal, jaux, jgrad)),
            (ttotal, taux, jax.tree.map(lambda t: t.grad, tp)))


def _compare(want, got):
    (jtotal, jaux, jgrad), (ttotal, taux, tgrad) = want, got
    np.testing.assert_allclose(ttotal.detach().item(), jtotal, **TOL)
    assert sorted(taux) == sorted(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].detach().item(), jaux[k],
                                   err_msg=k, **TOL)
    for k in jgrad:
        for g, j in zip(jax.tree.leaves(tgrad[k]), jax.tree.leaves(jgrad[k])):
            if g is None:  # not read by this mode: JAX's gradient is zero
                assert not np.asarray(j).any(), k
                continue
            np.testing.assert_allclose(g.numpy(), j, err_msg=k, **TOL)


@pytest.mark.parametrize("mode,suffix", [
    ("collab", ""), ("collab", "_single"), ("single", ""),
])
def test_pyramid_loss_matches_jax(tiny, mode, suffix):
    cfg, batch = tiny
    preds = _preds(cfg, batch, mode, np.random.RandomState(len(suffix)))
    if suffix:
        targets = jax.tree.map(np.asarray, jax_single(batch))
        port = _single_targets(batch)
        assert port.keys() == targets.keys()
        for k in targets:
            np.testing.assert_array_equal(port[k], targets[k])
    else:
        targets = _label_targets(batch)
    want, got = _run_both(cfg["loss"], preds, targets, suffix, mode)
    _compare(want, got)
    if mode == "collab" and suffix:
        assert set(got[1]) == {"pyramid_loss", "total_loss"}
    else:
        assert {"cls_loss", "reg_loss", "dir_loss"} <= set(got[1])


def test_point_pillar_loss_matches_jax(tiny):
    cfg, batch = tiny
    preds = _preds(cfg, batch, "collab", np.random.RandomState(7))
    del preds["occ_single_list"]
    loss_cfg = dict(cfg["loss"], core_method="point_pillar_loss")
    want, got = _run_both(loss_cfg, preds, _label_targets(batch), "",
                          "collab")
    _compare(want, got)


def test_iou_and_depth_branches_match_jax(tiny):
    cfg, batch = tiny
    preds = jax.tree.map(
        torch.from_numpy,
        _preds(cfg, batch, "collab", np.random.RandomState(0)))
    targets = jax.tree.map(torch.from_numpy, _label_targets(batch))
    # the IoU term waits for the anchors, as JAX's
    args = dict(cfg["loss"]["args"], iou={"sigma": 1.0, "weight": 1.0})
    loss = build_loss(dict(cfg["loss"], args=args))
    total, aux = loss(dict(preds, iou_preds=preds["cls_preds"]), targets)
    assert "iou_loss" not in aux and torch.isfinite(total)
    # depth logits with their targets: the LSS depth term joins, as JAX's
    rng = np.random.RandomState(1)
    depth = {"depth_items_m2": rng.normal(size=(4, 3, 5, 8)).astype(
        np.float32) * 2}
    bins = {"depth_bins_m2": rng.randint(0, 9, (2, 2, 3, 5)).astype(
        np.int32)}
    want, got = _run_both(cfg["loss"], dict(_preds(
        cfg, batch, "collab", np.random.RandomState(0)), **depth),
        dict(_label_targets(batch), **bins), "", "collab")
    _compare(want, got)
    assert "depth_loss" in got[1] and got[1]["depth_loss"].item() > 0
    # the flagship case: "depth" configured, no depth logits -> no term
    loss = build_loss(cfg["loss"])
    total, aux = loss(preds, targets)
    assert "depth_loss" not in aux and torch.isfinite(total)
