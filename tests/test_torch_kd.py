"""DiscoNet's knowledge distillation, port vs JAX, on the CPU: the teacher
view of the host batches, ``point_pillar_disconet_loss``, ``KDTrainer``
and the ``train_w_kd`` CLI.

tests/configs/tiny_intermediate.yaml with the student's model
(``point_pillar_disconet``), loss (``point_pillar_disconet_loss``, kd
weight 10000 so the imitation term weighs on the gradients) and
``kd_flag`` set in code (``kd_cfg``); the teacher is
``point_pillar_disconet_teacher`` on the same args, so its map has the
student's shape. Stated tolerances:

  * host batches, teacher view included: exact (``np.array_equal``,
    dtypes and shapes), numpy's global seed set before each package, at
    2000 points so that the merged view is subsampled;
  * the loss: 1e-6 relative;
  * one KD step against JAX's ``KDTrainer`` in f64 (its teacher's
    variables in f64 too), loss terms 1e-5 relative, every gradient leaf
    as max |d| / (1 + max |JAX|): the port's f64 step within 1e-5
    (measured 1.6e-6: the same program), its f32 step within 1e-3. Not
    1e-4: the DiscoNet student's f32 gradients at this size are
    sensitive to rounding, 1.5e-4 off here (3.7e-4 and 8.0e-4 from the
    port's inits 3 and 0), while JAX's own f32 step is 1.2e-2 off its
    f64 one (3.8e-2 and 3.6e-3); the teacher's weights and statistics
    bit-equal after the step, every student parameter with a gradient,
    ``kd_loss`` > 0.

The CLI trains the student one epoch on the CPU from a teacher run dir
(its config.yaml and a checkpoint, a port ``.pth`` or a heal_tpu
``.ckpt``); the teacher's encoder takes the kernel-1 path once a step.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.tools import checkpoint as jax_ckpt
from heal_tpu.tools.train_w_kd import KDTrainer as JaxKDTrainer
from heal_tpu_torch.config import save_yaml
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.models import build_loss
from heal_tpu_torch.ops import pillar
from heal_tpu_torch.parallel import build_optimizer, to_device
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools import train_w_kd
from heal_tpu_torch.tools.inference import build_weights
from test_torch_host import _assert_same
from test_torch_legacy_models import (legacy_cfg, port_model,
                                      port_variables)
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    # heal_tpu on its numpy host path, built library or not
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def kd_cfg(max_points: int = 6000) -> dict:
    cfg = legacy_cfg("disconet")
    cfg["kd_flag"] = True
    cfg["preprocess"]["args"]["max_points"] = max_points
    return cfg


def teacher_cfg(cfg: dict) -> dict:
    """The teacher of the student's config: its args, the teacher model,
    early fusion (the merged view it is trained on)."""
    t = copy.deepcopy(cfg)
    t.pop("kd_flag")
    t["model"]["core_method"] = "point_pillar_disconet_teacher"
    t["fusion"]["core_method"] = "early"
    t["loss"] = {"core_method": "point_pillar_loss",
                 "args": {k: v for k, v in cfg["loss"]["args"].items()
                          if k != "kd"}}
    return t


def _batch(build, cfg, train, **kw):
    np.random.seed(0)
    extra = {} if build is jax_build_dataset else {"native_iou": False}
    return next(build(copy.deepcopy(cfg), train=train, **extra).batches(
        2, shuffle=train, seed=3, **kw))


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_teacher_view_batches_equal_heal_tpu(train):
    cfg = kd_cfg(max_points=2000)
    got = _batch(build_dataset, cfg, train)
    want = _batch(jax_build_dataset, cfg, train, process_split=False)
    assert want["teacher_points"].shape == (2, 2000, 4)
    # a collaboration's points merged: more than max_points, subsampled
    assert want["teacher_point_mask"].all(axis=1).any()
    _assert_same(got, want)


def test_teacher_view_is_the_agents_points_in_the_ego_frame():
    """Without subsampling, the teacher view holds every kept agent's
    in-range points moved into the ego frame: the ego's own points
    among them unchanged."""
    cfg = kd_cfg()
    batch = _batch(build_dataset, cfg, False)
    n_ego = int(batch["point_mask"][0, 0].sum())
    tmask = batch["teacher_point_mask"][0]
    assert n_ego < tmask.sum() <= 6000
    ego = batch["points"][0, 0][:n_ego]
    tpts = batch["teacher_points"][0][tmask]
    assert {tuple(p) for p in ego} <= {tuple(p) for p in tpts}


def test_disconet_loss_matches_jax():
    """On seeded random heads and features, the port's f32 loss against
    JAX's in f64 (the kd term's mean over 2 x 64 x 64 x 64 values: JAX's
    f32 sum is 4e-6 off it, the port's within 1e-6)."""
    cfg = kd_cfg()
    batch = _batch(jax_build_dataset, cfg, True, process_split=False)
    rng = np.random.RandomState(0)
    b, h, w, a = batch["pos_equal_one"].shape
    out = {"cls_preds": rng.randn(b, h, w, a),
           "reg_preds": rng.randn(b, h, w, 7 * a),
           "dir_preds": rng.randn(b, h, w, 2 * a),
           "spatial_features_2d": rng.randn(b, h, w, 64),
           "teacher_feature": rng.randn(b, h, w, 64)}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    tgt = {k: batch[k] for k in ("pos_equal_one", "neg_equal_one",
                                 "targets")}
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64  # JAX's loss traced in f64 throughout
        try:
            want_total, want_aux = jax.device_get(build_jax_loss(
                cfg["loss"])(_f64(out), _f64(tgt)))
        finally:
            jnp.float32 = f32
    total, aux = build_loss(cfg["loss"])(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in tgt.items()})
    assert sorted(aux) == sorted(want_aux) and "kd_loss" in aux
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-6)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def test_kd_step_matches_jax_f64():
    cfg = kd_cfg()
    tcfg = teacher_cfg(cfg)
    batch = _batch(jax_build_dataset, cfg, True, process_split=False)
    params, stats = port_variables(cfg, seed=1)
    tparams, tstats = port_variables(tcfg, seed=2)

    jt = JaxKDTrainer(model=build_flax(cfg["model"]),
                      criterion=build_jax_loss(cfg["loss"]), tx=None)
    jteacher = build_flax(tcfg["model"])
    tvars = {"params": _f64(tparams), "batch_stats": _f64(tstats)}
    jt.teacher_apply = lambda b: jteacher.apply(
        tvars, {"points": b["teacher_points"],
                "point_mask": b["teacher_point_mask"]},
        train=False)["spatial_features_2d"]
    want_aux, _, grads = _jax_f64_step(jt, params, stats, batch)
    want = _leaves(grads)
    assert float(want_aux["kd_loss"]) > 0

    for dtype, tol in ((torch.float64, 1e-5), (torch.float32, 1e-3)):
        teacher = port_model(tcfg, tparams, tstats).to(dtype)
        before = {k: v.clone() for k, v in teacher.state_dict().items()}
        model = port_model(cfg, params, stats).to(dtype)
        opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                        cfg["lr_scheduler"], 4)
        port = train_w_kd.KDTrainer(model, build_loss(cfg["loss"]), opt,
                                    schedule, rng_seed=None, teacher=teacher)
        b = to_device(batch, "cpu")
        if dtype == torch.float64:
            b = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
                 else v for k, v in b.items()}
        aux = port.train_step(b)
        assert sorted(aux) == sorted(want_aux)
        for k, v in want_aux.items():
            np.testing.assert_allclose(aux[k].item(), v, rtol=1e-5,
                                       err_msg=(dtype, k))
        assert not teacher.training
        for k, v in teacher.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert all(p.grad is not None for p in model.parameters())
        got = _leaves(train_w_kd_grads(model))
        assert got.keys() == want.keys()
        errs = {k: _rel(g, want[k]) for k, g in got.items()}
        assert max(errs.values()) <= tol, (dtype, max(errs.items(),
                                                      key=lambda x: x[1]))


def train_w_kd_grads(model):
    from heal_tpu_torch.utils.bridge import to_flax
    return to_flax({k: p.grad for k, p in model.named_parameters()})[0]


@pytest.mark.parametrize("ckpt_kind", ["pth", "heal_tpu"])
def test_train_w_kd_cli(tmp_path, monkeypatch, ckpt_kind):
    """One epoch (4 steps at batch 2) from a teacher run dir, on the CPU:
    the teacher's encoder takes the kernel-1 path once a step (a spy on
    ``ops/pillar.pillar_tables``), its checkpoint is loaded strictly and
    never rewritten; the student's checkpoint of epoch 1 is written."""
    cfg = kd_cfg()
    tcfg = teacher_cfg(cfg)
    tdir, sdir = tmp_path / "teacher", tmp_path / "student"
    tdir.mkdir()
    save_yaml(tcfg, str(tdir / "config.yaml"))
    teacher = build_weights(tcfg, seed=4)
    if ckpt_kind == "pth":
        tpath = ckpt_lib.save_checkpoint(str(tdir), teacher, 1)
    else:
        from heal_tpu_torch.utils.bridge import to_flax
        params, stats = to_flax(teacher.state_dict())
        tpath = jax_ckpt.save_checkpoint(
            str(tdir), {"params": params, "batch_stats": stats}, 1)
    stamp = os.path.getmtime(tpath)
    student_yaml = str(tmp_path / "student.yaml")
    save_yaml(cfg, student_yaml)
    calls = []
    real = pillar.pillar_tables

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(pillar, "pillar_tables", spy)
    out = train_w_kd.main(["-y", student_yaml, "--teacher_dir", str(tdir),
                           "--model_dir", str(sdir), "--epochs", "1",
                           "--device", "cpu"])
    assert out == str(sdir)
    assert len(calls) == 4  # the teacher, once a step
    epoch, path = ckpt_lib.find_checkpoint(str(sdir))
    assert epoch == 1 and path
    assert os.path.getmtime(tpath) == stamp
    assert set(ckpt_lib.load_state_dict(path)) == set(
        build_weights(cfg, seed=0).state_dict())
