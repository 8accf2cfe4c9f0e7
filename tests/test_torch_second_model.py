"""The SECOND detectors ``second`` and ``second_intermediate``, port vs
JAX, on the CPU.

tests/configs/tiny_intermediate.yaml (three agent slots with a padded
one, at most 2048 points an agent) with its model switched to SECOND at
small widths, as tests/configs/entry_m3_single.yaml sizes its m3 agent:
0.15 x 0.15 x 0.5 m voxels over the 76.8 m square (a (8, 512, 512)
grid, 8x down to the 64 x 64 anchor grid), channels 8/16/16/16,
capacities 4096/3072/2048/1536, backbone 16/32, shrink 32. One numpy
batch of heal_tpu's host side goes to both packages (heal_tpu's C++
anchor IoU off, as in tests/test_torch_host.py), and one set of flax
variables (the port's seeded init, running statistics randomised) is
bridged strictly. Stated tolerances, as max |d| / (1 + max |ref|):

  * eval heads of ``second`` and of ``second_intermediate`` with ``att``
    (the published DAIR-V2X fusion) and with ``max``: 1e-4;
  * one ``point_pillar_loss`` train step of ``second_intermediate``
    (att): loss terms 1e-5 relative, every f32 gradient leaf within 1e-4
    of JAX's own step in f64 (the witness of tests/test_torch_train.py).

Also: JAX's variables map key for key onto the port's, and the
published ``dairv2x/second_coalign.yaml`` builds with JAX's fusion
width rule.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu_torch.config import load_yaml
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.utils.bridge import from_flax, load_flax, to_flax
from test_torch_point_pillar import _model_batch, _random_stats
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
TINY = "tests/configs/tiny_intermediate.yaml"
HEADS = ("cls_preds", "reg_preds", "dir_preds")
TOL = 1e-4
CASES = {"second": ("second", "max"),
         "intermediate_att": ("second_intermediate", "att"),
         "intermediate_max": ("second_intermediate", "max")}


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    # heal_tpu on its numpy host path, built library or not
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def second_cfg(case: str) -> dict:
    core, method = CASES[case]
    cfg = jax_load_yaml(TINY)
    cfg["preprocess"]["args"]["max_points"] = 2048
    a = cfg["model"]["args"]
    cfg["model"]["core_method"] = core
    for k in ("pillar_vfe", "point_pillar_scatter"):
        a.pop(k)
    a["voxel_size"] = [0.15, 0.15, 0.5]
    a["second"] = {"channels": [8, 16, 16, 16],
                   "max_voxels": [4096, 3072, 2048, 1536]}
    a["base_bev_backbone"] = {
        "layer_nums": [1, 1], "layer_strides": [1, 2],
        "num_filters": [16, 32], "upsample_strides": [1, 2],
        "num_upsample_filter": [16, 16]}
    a["shrink_header"].update(dim=[32], input_dim=32)
    a["fusion_method"] = method
    a[method] = {"feat_dim": 32}
    return cfg


def _batch(cfg, train=False, size=1):
    np.random.seed(0)
    batch = next(jax_build_dataset(cfg, train=train).batches(
        size, shuffle=False, process_split=False))
    if cfg["model"]["core_method"] == "second":  # one agent: the ego
        batch = dict(batch, points=batch["points"][:, 0],
                     point_mask=batch["point_mask"][:, 0])
    return batch


def _variables(cfg, seed):
    model = init_weights(build_model(cfg["model"],
                                     max_cav=cfg["train_params"]["max_cav"]),
                         torch.Generator().manual_seed(seed))
    params, stats = to_flax(model.state_dict())
    return params, _random_stats(stats, seed)


def _port(cfg, params, stats):
    return load_flax(build_model(cfg["model"],
                                 max_cav=cfg["train_params"]["max_cav"]),
                     params, stats)


@pytest.mark.parametrize("case", list(CASES))
def test_jax_init_bridges_strictly(case):
    cfg = second_cfg(case)
    batch = _batch(cfg)
    jm = build_flax(cfg["model"])
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False),
                            jax.tree.map(jnp.asarray, batch))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = build_model(cfg["model"], max_cav=cfg["train_params"]["max_cav"])
    assert model.encoder_name == "SecondEncoder_0"
    from_flax(zeros["params"], zeros.get("batch_stats"),
              expected=model.state_dict())


@pytest.mark.parametrize("case", list(CASES))
def test_heads_match_jax(case):
    cfg = second_cfg(case)
    batch = _batch(cfg)
    params, stats = _variables(cfg, seed=list(CASES).index(case))
    jm = build_flax(cfg["model"])
    keys = HEADS + ("spatial_features_2d",)
    want = jax.device_get(jax.jit(lambda v, b: {
        k: x for k, x in jm.apply(v, b, train=False).items() if k in keys})(
            {"params": params, "batch_stats": stats},
            jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got = _port(cfg, params, stats)(_model_batch(batch))
    assert sorted(k for k in got if k in keys) == sorted(want)
    assert want["cls_preds"].shape[1:] == (64, 64, 2)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == np.shape(w), k
        assert _rel(g, w) <= TOL, (k, _rel(g, w))


def test_train_step_matches_jax_f64():
    """One step of ``second_intermediate`` (att) at batch 2: loss terms at
    1e-5 and every gradient leaf within 1e-4 of JAX's f64 step."""
    cfg = second_cfg("intermediate_att")
    batch = _batch(cfg, train=True, size=2)
    params, stats = _variables(cfg, seed=0)
    jt = JaxTrainer(model=build_flax(cfg["model"]),
                    criterion=build_jax_loss(cfg["loss"]), tx=None)
    want_aux, _, grads = _jax_f64_step(jt, params, stats, batch)
    model = _port(cfg, params, stats)
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


@pytest.mark.parametrize("method", ["att", "disconet"])
def test_published_dairv2x_config_builds(method):
    """``dairv2x/second_coalign.yaml`` as published (att, no parameters)
    and switched to a fusion with parameters, DiscoNet, whose width is
    JAX's ``in_channels`` rule (``in_head``, else 64; not the 256-wide
    map): JAX's variables (shapes by ``jax.eval_shape``) map key for key
    onto the port's."""
    cfg = load_yaml("heal_tpu/configs/dairv2x/second_coalign.yaml")
    a = cfg["model"]["args"]
    a["fusion_method"] = method
    a[method] = copy.deepcopy(a["att"])
    model = build_model(cfg["model"], max_cav=2)
    assert model.encoder.out_channels == 5 * 64  # 40 z layers -> 5
    n = sum(p.numel() for p in model.fusion.parameters())
    assert (n == 0) == (method == "att")
    x = {"points": jnp.zeros((1, 2, 16, 4)),
         "point_mask": jnp.zeros((1, 2, 16), bool),
         "agent_mask": jnp.ones((1, 2), bool),
         "pairwise_affine": jnp.tile(jnp.eye(2, 3), (1, 2, 2, 1, 1))}
    jm = build_flax(cfg["model"])
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False), x)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    assert (model.fusion_name in zeros["params"]) == (n > 0)
    from_flax(zeros["params"], zeros.get("batch_stats"),
              expected=model.state_dict())
