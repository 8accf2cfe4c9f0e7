"""The homogeneous PointPillars detectors, port vs JAX, on the CPU.

``point_pillar`` (late and early fusion's detector) on
tests/configs/tiny_late.yaml, and ``point_pillar_baseline`` on the same
config switched to intermediate fusion and cut narrow in code (backbone
16 / 32 channels, shrink 32: a 64 x 64 fusion grid, three agent slots
with a padded one) for each of the ten fusion methods of
``opv2v/lidar_only/*.yaml``. One numpy batch of heal_tpu's host side
goes to both packages, and one set of flax variables is bridged (JAX's
init for ``point_pillar``, the port's seeded init for the baselines, half
the compile time; running statistics randomised). JAX's eval encoder
runs its Pallas kernel in interpret mode (``HEAL_TPU_FORCE_PALLAS=1``)
for ``point_pillar``, its XLA path for the baselines. Stated tolerances,
as max |d| / (1 + max |ref|):

  * eval heads (and Where2comm's ``comm_rate``): 1e-4;
  * one train step (the port with no random streams, JAX's without rngs):
    loss terms 1e-5 relative, every f32 gradient leaf within 1e-4 of
    JAX's own step in f64 (the witness of tests/test_torch_train.py).

Also: a heal_tpu ``.ckpt`` of each model loads strictly, and
``use_iou`` with the loss's IoU term (heads and one step, as above).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.config.loader import PARSER_REGISTRY
from heal_tpu.data import build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.tools.checkpoint import save_checkpoint as jax_save
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.tools.inference import build_weights
from heal_tpu_torch.utils.bridge import load_flax, to_flax
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
TINY = "tests/configs/tiny_late.yaml"
HEADS = ("cls_preds", "reg_preds", "dir_preds")
TOL = 1e-4

# fusion method -> its block at the cut width (32 channels), as the
# published opv2v/lidar_only/<method>.yaml sets it at 256
METHODS = {
    "max": {"in_channels": 32, "feat_dim": 32},
    "att": {"in_channels": 32, "feat_dim": 32},
    "disconet": {"in_channels": 32, "feat_dim": 32},
    "v2vnet": {"in_channels": 32, "num_iteration": 2, "agg_operator": "avg",
               "gru_flag": True,
               "conv_gru": {"kernel_size": [[3, 3]], "num_layers": 1}},
    "where2comm": {"in_channels": 32, "feat_dim": 32},
    "who2com": {"in_channels": 32, "feat_dim": 32},
    "cobevt": {"input_dim": 32, "window_size": 8, "depth": 1},
    "v2xvit": {"depth": 1},
    "when2com": {"in_channels": 32, "query_size": 16, "key_size": 32,
                 "mode": "activated", "threshold": 0.2},
    "transformer": {"in_channels": 32, "n_head": 4},
}


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    # heal_tpu on its numpy host path, built library or not
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def pp_cfg() -> dict:
    return jax_load_yaml(TINY)


def baseline_cfg(method: str) -> dict:
    """tiny_late.yaml as intermediate fusion with ``point_pillar_baseline``
    of ``method``, cut narrow."""
    cfg = jax_load_yaml(TINY)
    cfg["fusion"]["core_method"] = "intermediate"
    a = cfg["model"]["args"]
    cfg["model"]["core_method"] = "point_pillar_baseline"
    a["pillar_vfe"]["num_filters"] = [16]
    a["base_bev_backbone"].update(num_filters=[16, 32],
                                  num_upsample_filter=[16, 16])
    a["shrink_header"].update(dim=[32], input_dim=32)
    a["fusion_method"] = method
    a[method] = copy.deepcopy(METHODS[method])
    return PARSER_REGISTRY[cfg["yaml_parser"]](cfg)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def _random_stats(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape)
                      if p[-1].key in ("var", "bn_var")
                      else rng.uniform(-0.3, 0.3, s.shape)).astype(np.float32),
        jax.device_get(tree))


def _batch(cfg, train=False, size=1):
    np.random.seed(0)
    return next(build_dataset(cfg, train=train).batches(
        size, shuffle=False, process_split=False))


def _model_batch(batch):
    return _tensors({k: v for k, v in batch.items()
                     if k != "agent_samples"})


def _variables(cfg, batch, seed, jax_init):
    """(JAX model, variables): JAX's init, or the port's seeded init in
    flax layout; running statistics randomised."""
    jm = build_flax(cfg["model"])
    if jax_init:
        v = jax.device_get(jax.jit(lambda b: jm.init(
            jax.random.PRNGKey(seed), b, train=False))(
                jax.tree.map(jnp.asarray, batch)))
    else:
        model = init_weights(build_model(
            cfg["model"], max_cav=cfg["train_params"]["max_cav"]),
            torch.Generator().manual_seed(seed))
        v = dict(zip(("params", "batch_stats"), to_flax(model.state_dict())))
    return jm, {"params": v["params"],
                "batch_stats": _random_stats(v["batch_stats"], seed)}


def _port(cfg, variables):
    return load_flax(build_model(cfg["model"],
                                 max_cav=cfg["train_params"]["max_cav"]),
                     variables["params"], variables["batch_stats"])


def _jax_heads(jm, variables, batch, keys):
    return jax.device_get(jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items() if k in keys})(
            variables, jax.tree.map(jnp.asarray, batch)))


def test_point_pillar_heads_match_jax(monkeypatch):
    """The ego's test sample through JAX's init, JAX's encoder on its
    Pallas kernel (interpret mode)."""
    cfg = pp_cfg()
    batch = {k: v for k, v in _batch(cfg).items() if k != "agent_samples"}
    assert batch["points"].shape == (1, 6000, 4)
    monkeypatch.setenv("HEAL_TPU_FORCE_PALLAS", "1")
    jm, v = _variables(cfg, batch, seed=0, jax_init=True)
    assert sorted(v["params"]) == ["DetectionHeads_0", "DownsampleConv_0",
                                   "PointPillarEncoder_0",
                                   "ResNetBEVBackbone_0"]
    want = _jax_heads(jm, v, batch, HEADS + ("spatial_features_2d",))
    with torch.no_grad():
        got = _port(cfg, v)(_model_batch(batch))
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert _rel(got[k].numpy(), w) <= TOL, (k, _rel(got[k].numpy(), w))


@pytest.mark.parametrize("method", list(METHODS))
def test_point_pillar_baseline_heads_match_jax(method):
    cfg = baseline_cfg(method)
    batch = _batch(cfg)
    assert batch["points"].shape == (1, 3, 6000, 4)
    assert batch["agent_mask"].tolist() == [[True, True, False]]
    jm, v = _variables(cfg, batch, seed=list(METHODS).index(method),
                       jax_init=False)
    keys = HEADS + ("comm_rate",)
    want = _jax_heads(jm, v, batch, keys)
    model = _port(cfg, v)
    # the fusion module carries flax's auto-name
    assert model.fusion_name == f"{type(model.fusion).__name__}_0"
    with torch.no_grad():
        got = model(_model_batch(batch))
    assert sorted(k for k in got if k in keys) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == np.shape(w), k
        assert _rel(g, w) <= TOL, (k, _rel(g, w))
    if method == "where2comm":
        assert 0 < float(got["comm_rate"]) <= 1


@pytest.mark.parametrize("which", ["point_pillar", "max"])
def test_train_step_matches_jax_f64(which):
    """One step at batch 2 (the late train split for point_pillar, the
    intermediate one for the max baseline): loss terms at 1e-5 and every
    gradient leaf within 1e-4 of JAX's f64 step."""
    cfg = pp_cfg() if which == "point_pillar" else baseline_cfg(which)
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
    assert sorted(aux) == sorted(want_aux)
    for k, w in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), w, rtol=1e-5, err_msg=k)
    got = _leaves(to_flax({k: p.grad for k, p in model.named_parameters()})[0])
    want = _leaves(grads)
    assert got.keys() == want.keys()
    errs = {k: _rel(g, want[k]) for k, g in got.items()}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda x: x[1])


@pytest.mark.parametrize("which", ["point_pillar", "cobevt"])
def test_heal_tpu_checkpoint_loads_strictly(which, tmp_path):
    """A heal_tpu checkpoint of JAX's init (running statistics
    randomised) serves in the port, loaded strictly, with JAX's heads."""
    cfg = pp_cfg() if which == "point_pillar" else baseline_cfg(which)
    batch = _batch(cfg)
    if which == "point_pillar":
        batch = {k: v for k, v in batch.items() if k != "agent_samples"}
    jm, v = _variables(cfg, batch, seed=7, jax_init=True)
    path = jax_save(str(tmp_path), v, 3)
    model = build_weights(cfg, checkpoint=path)
    want = _jax_heads(jm, v, batch, HEADS)
    with torch.no_grad():
        got = model(_model_batch(batch))
    for k, w in want.items():
        assert _rel(got[k].numpy(), w) <= TOL, k


def test_use_iou_heads_and_step_match_jax():
    """``use_iou`` on the max baseline with the loss's ``iou`` term (no
    published config sets them): the heads' ``iou_preds`` at 1e-4, and
    one step with the anchors handed to both losses, ``iou_loss`` among
    the terms at 1e-5, every gradient leaf within 1e-4 of JAX's f64
    step."""
    cfg = baseline_cfg("max")
    cfg["model"]["args"]["use_iou"] = True
    cfg["loss"]["args"]["iou"] = {"weight": 1.0, "sigma": 1.0}
    batch = _batch(cfg)
    jm, v = _variables(cfg, batch, seed=5, jax_init=False)
    want = _jax_heads(jm, v, batch, HEADS + ("iou_preds",))
    model = _port(cfg, v)
    with torch.no_grad():
        got = model(_model_batch(batch))
    for k, w in want.items():
        assert _rel(got[k].numpy(), w) <= TOL, (k, _rel(got[k].numpy(), w))
    assert got["iou_preds"].shape == got["cls_preds"].shape

    train = _batch(cfg, train=True, size=2)
    anchors = build_dataset(cfg, train=True).anchors
    jloss = build_jax_loss(cfg["loss"])
    jloss.set_anchors(anchors)
    jt = JaxTrainer(model=jm, criterion=jloss, tx=None)
    want_aux, _, grads = _jax_f64_step(jt, v["params"], v["batch_stats"],
                                       train)
    model = _port(cfg, v)
    opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                    cfg["lr_scheduler"], 4)
    loss = build_loss(cfg["loss"])
    loss.set_anchors(anchors)
    aux = Trainer(model, loss, opt, schedule, rng_seed=None).train_step(
        to_device(train, "cpu"))
    assert "iou_loss" in aux and aux["iou_loss"].item() > 0
    assert sorted(aux) == sorted(want_aux)
    for k, w in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), w, rtol=1e-5, err_msg=k)
    got = _leaves(to_flax({k: p.grad for k, p in model.named_parameters()})[0])
    want = _leaves(grads)
    assert got.keys() == want.keys()
    errs = {k: _rel(g, want[k]) for k, g in got.items()}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda x: x[1])
