"""CoAlign's stage-1 detector in the port against heal_tpu's, on the CPU.

``point_pillar_uncertainty`` (``PointPillar`` + the ``unc_head`` 1x1
conv) on tests/configs/tiny_late.yaml switched to it, its loss
``point_pillar_uncertainty_loss`` and the ``uncertainty`` export of
``postprocess/decode.post_process_single``. One numpy batch of heal_tpu's
host side goes to both packages and one set of flax variables is bridged
(running statistics randomised). Stated tolerances, as max |d| / (1 +
max |ref|) unless said otherwise:

  * ``log_i0`` (each kappa) and ``von_mises_nll``, values and
    gradients, f32: 1e-6; log I0(500) within 0.01 of its asymptote, as JAX's
    tests/test_uncertainty.py holds it;
  * eval heads and ``unc_preds`` (JAX's encoder on its Pallas kernel in
    interpret mode, ``HEAL_TPU_FORCE_PALLAS=1``): 1e-4;
  * the loss on the same outputs and targets: every term 1e-5 relative,
    its gradient with respect to each output 1e-5;
  * one train step: loss terms 1e-5 relative, every f32 gradient leaf
    within 1e-4 of JAX's own step in f64 (tests/test_torch_train.py);
  * the decode: the same candidates, and each one's uncertainty equal to
    JAX's, box for box (a gather: exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.losses import point_pillar_uncertainty_loss as jloss
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.postprocess import decode as jdecode
from heal_tpu.tools.checkpoint import save_checkpoint as jax_save
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.losses import point_pillar_uncertainty_loss as tloss
from heal_tpu_torch.models import build_loss
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.postprocess import decode as tdecode
from heal_tpu_torch.tools.inference import build_weights
from heal_tpu_torch.utils.bridge import to_flax
from test_torch_point_pillar import (_batch, _jax_heads, _model_batch, _port,
                                     _variables)
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
TINY = "tests/configs/tiny_late.yaml"
OUTS = ("cls_preds", "reg_preds", "dir_preds", "unc_preds")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def unc_cfg() -> dict:
    """tiny_late.yaml with CoAlign's stage-1 detector and its loss."""
    cfg = jax_load_yaml(TINY)
    cfg["model"]["core_method"] = "point_pillar_uncertainty"
    cfg["loss"]["core_method"] = "point_pillar_uncertainty_loss"
    cfg["loss"]["args"]["uncertainty"] = {"weight": 0.5}
    return cfg


def _test_batch(cfg):
    return {k: v for k, v in _batch(cfg).items() if k != "agent_samples"}


def test_log_i0_matches_jax_and_stays_finite():
    kappa = np.array([1e-3, 0.5, 3.0, 50.0, 500.0, 1e4], np.float32)
    t = torch.tensor(kappa, requires_grad=True)
    got = tloss.log_i0(t)
    got.sum().backward()
    want = np.asarray(jloss.log_i0(jnp.asarray(kappa)))
    dwant = np.asarray(jax.grad(lambda k: jloss.log_i0(k).sum())(
        jnp.asarray(kappa)))
    # per kappa: log(i0e(k)) + k cancels to ~k^2/4 at small k in f32
    for g, w in zip(got.detach().numpy(), want):
        assert abs(g - w) <= 1e-6 * (1 + abs(w)), (g, w)
    for g, w in zip(t.grad.numpy(), dwant):
        assert abs(g - w) <= 1e-6 * (1 + abs(w)), (g, w)
    assert torch.isfinite(got).all() and torch.isfinite(t.grad).all()
    # asymptotic: log I0(k) ~ k - 0.5 log(2 pi k)
    v = float(tloss.log_i0(torch.tensor(500.0)))
    assert abs(v - (500.0 - 0.5 * np.log(2 * np.pi * 500.0))) < 0.01


def test_von_mises_nll_matches_jax():
    rng = np.random.RandomState(0)
    pred, target = (rng.uniform(-3, 3, 64).astype(np.float32)
                    for _ in range(2))
    log_kappa = rng.uniform(-3, 6, 64).astype(np.float32)
    args = [torch.tensor(a, requires_grad=True)
            for a in (pred, target, log_kappa)]
    got = tloss.von_mises_nll(*args)
    got.sum().backward()
    jargs = tuple(map(jnp.asarray, (pred, target, log_kappa)))
    want = np.asarray(jloss.von_mises_nll(*jargs))
    grads = jax.grad(lambda *a: jloss.von_mises_nll(*a).sum(),
                     argnums=(0, 1, 2))(*jargs)
    assert _rel(got.detach().numpy(), want) <= 1e-6
    for a, g in zip(args, grads):
        assert _rel(a.grad.numpy(), np.asarray(g)) <= 1e-6
    # the likelihood peaks where the angles agree
    same = tloss.von_mises_nll(torch.tensor(0.7), torch.tensor(0.7),
                               torch.tensor(1.5))
    off = tloss.von_mises_nll(torch.tensor(1.7), torch.tensor(0.7),
                              torch.tensor(1.5))
    assert float(same) < float(off)


def test_heads_and_unc_preds_match_jax(monkeypatch, tmp_path):
    cfg = unc_cfg()
    batch = _test_batch(cfg)
    monkeypatch.setenv("HEAL_TPU_FORCE_PALLAS", "1")
    jm, v = _variables(cfg, batch, seed=0, jax_init=True)
    assert sorted(v["params"]) == ["DetectionHeads_0", "DownsampleConv_0",
                                   "PointPillarEncoder_0",
                                   "ResNetBEVBackbone_0", "unc_head"]
    want = _jax_heads(jm, v, batch, OUTS + ("spatial_features_2d",))
    model = _port(cfg, v)
    with torch.no_grad():
        got = model(_model_batch(batch))
    assert want["unc_preds"].shape == (1, 64, 64, 6)  # (B, H, W, 3A) NHWC
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert _rel(got[k].numpy(), w) <= TOL, (k, _rel(got[k].numpy(), w))
    # a heal_tpu checkpoint of it loads strictly
    path = jax_save(str(tmp_path), v, 1)
    loaded = build_weights(cfg, checkpoint=path)
    for k, t in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k


def _loss_inputs(cfg, seed):
    """Random NHWC outputs of the model's shapes and the targets of a
    train batch of 2."""
    batch = _batch(cfg, train=True, size=2)
    h, w = batch["pos_equal_one"].shape[1:3]
    a = cfg["model"]["args"]["anchor_number"]
    rng = np.random.RandomState(seed)
    outs = {k: rng.normal(0, 1, (2, h, w, a * c)).astype(np.float32)
            for k, c in (("cls_preds", 1), ("reg_preds", 7),
                         ("dir_preds", 2), ("unc_preds", 3))}
    targets = {k: batch[k] for k in ("pos_equal_one", "neg_equal_one",
                                     "targets")}
    assert batch["pos_equal_one"].sum() > 0
    return outs, targets


def test_uncertainty_loss_and_gradients_match_jax():
    cfg = unc_cfg()
    outs, targets = _loss_inputs(cfg, seed=1)
    jl = build_jax_loss(cfg["loss"])

    def jfn(o):
        return jl(o, {k: jnp.asarray(v) for k, v in targets.items()})

    (jtotal, jaux), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outs.items()})
    tout = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    total, aux = build_loss(cfg["loss"])(
        tout, {k: torch.from_numpy(v) for k, v in targets.items()})
    total.backward()
    assert sorted(aux) == sorted(jaux) and "unc_loss" in aux
    for k, v in jaux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)
    for k, g in jgrads.items():
        assert _rel(tout[k].grad.numpy(), np.asarray(g)) <= 1e-5, k
    assert float(np.abs(np.asarray(jgrads["unc_preds"])).max()) > 0


def test_train_step_matches_jax_f64():
    cfg = unc_cfg()
    batch = _batch(cfg, train=True, size=2)
    jm, v = _variables(cfg, batch, seed=3, jax_init=False)
    jt = JaxTrainer(model=jm, criterion=build_jax_loss(cfg["loss"]), tx=None)
    want_aux, _, grads = _jax_f64_step(jt, v["params"], v["batch_stats"],
                                       batch)
    model = _port(cfg, v)
    opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                    cfg["lr_scheduler"], 4)
    port = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                   rng_seed=None)
    aux = port.train_step(to_device(batch, "cpu"))
    assert sorted(aux) == sorted(want_aux) and "unc_loss" in aux
    for k, w in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), w, rtol=1e-5, err_msg=k)
    got = _leaves(to_flax({k: p.grad for k, p in model.named_parameters()})[0])
    want = _leaves(grads)
    assert got.keys() == want.keys()
    assert any("unc_head" in k for k in got)
    errs = {k: _rel(g, want[k]) for k, g in got.items()}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda x: x[1])


def test_decoded_uncertainty_matches_jax():
    """The same head outputs through both decoders: the candidates and
    each one's uncertainty (log-var x / y, log-kappa yaw) box for box."""
    cfg = unc_cfg()
    post = cfg["postprocess"]
    outs, _ = _loss_inputs(cfg, seed=2)
    outs["cls_preds"] -= 2.5  # fewer than 300 candidates pass
    ds = build_dataset(cfg, train=False)
    args = [outs["cls_preds"][0], outs["reg_preds"][0], outs["dir_preds"][0],
            np.asarray(ds.anchors, np.float32), np.eye(4, dtype=np.float32),
            np.asarray(post["gt_range"], np.float32)]
    kw = dict(order=post["order"],
              score_threshold=post["target_args"]["score_threshold"],
              nms_threshold=post["nms_thresh"])
    want = jax.device_get(jdecode.post_process_single(
        *map(jnp.asarray, args), **kw,
        unc_preds=jnp.asarray(outs["unc_preds"][0])))
    got = tdecode.post_process_single(
        *(torch.from_numpy(np.array(a)) for a in args), **kw,
        unc_preds=torch.from_numpy(outs["unc_preds"][0]))
    assert got["uncertainty"].shape == (300, 3)
    valid = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert 0 < valid.sum() < 300
    np.testing.assert_array_equal(got["uncertainty"].numpy()[valid],
                                  np.asarray(want["uncertainty"])[valid])
    dense, jdense = tdecode.strip_padding(got), jdecode.strip_padding(want)
    np.testing.assert_array_equal(dense["uncertainty"],
                                  jdense["uncertainty"])
    # each box's row is its anchor's (h, w, a) triple of the NHWC map
    flat = outs["unc_preds"][0].reshape(-1, 3)
    rows = [np.flatnonzero((flat == u).all(1)) for u in dense["uncertainty"]]
    assert all(len(r) == 1 for r in rows)
