"""The CenterPoint family, port vs JAX, on the CPU.

tests/configs/tiny_intermediate.yaml (a 128 x 128 pillar grid, backbone
32 / 64, shrink 64, a 64 x 64 head map, three agent slots with a padded
one) with its model switched to each CenterPoint name and its loss to
``center_point_loss``, as JAX's tests/test_center_point.py and
tests/test_heter_baseline.py use it. One numpy batch of heal_tpu's host
side goes to both packages (heal_tpu's C++ anchor IoU off, as in
tests/test_torch_host.py) and one set of flax variables (the port's
seeded init, running statistics randomised) is bridged strictly.
Stated tolerances:

  * ``gaussian_radius``, ``generate_center_targets`` and the host batch's
    ``heatmap`` / ``box_targets`` / ``reg_mask``: exactly equal;
  * ``CenterPointLoss``: 1e-6 relative;
  * the anchor-free decode: the same kept boxes in the same order,
    scores 1e-6, boxes and corners 1e-5 absolute;
  * f32 heads (and Where2comm's ``comm_rate``) of all five names: 1e-4 as
    max |d| / (1 + max |ref|);
  * one train step: loss terms 1e-5 relative, every f32 gradient leaf
    within 1e-4 of JAX's own step in f64 (the witness of
    tests/test_torch_train.py), as max |d| / (1 + max |ref|).

Also: the flax variables of JAX's init bridge key for key; ``CenterHeads``
starts its heatmap bias at -2.19 in both; ``tools/train.py`` then
``tools/inference.py`` serve a tiny CenterPoint run on the CPU.
"""
import copy
import os

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
from heal_tpu.models.center_point import CenterHeads as JaxCenterHeads
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.postprocess import targets as jax_targets
from heal_tpu.postprocess.decode import (
    post_process_single as jax_post_process)
from heal_tpu_torch.config import save_yaml
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.center_point import resize_nearest
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.postprocess import targets
from heal_tpu_torch.postprocess.decode import post_process_single
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.tools.inference import run_inference
from heal_tpu_torch.utils.bridge import from_flax, load_flax, to_flax
from test_torch_point_pillar import _model_batch, _random_stats
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
TINY = "tests/configs/tiny_intermediate.yaml"
HEADS = ("cls_preds", "reg_preds")
TOL = 1e-4
LABELS = ("heatmap", "box_targets", "reg_mask")

# name -> (core_method, the model args it sets): the five CenterPoint
# names, Where2comm over the agg modes of JAX's TestWhere2commFidelity
MODELS = {
    "center_point": ("center_point", {}),
    "baseline_max": ("center_point_baseline", {"fusion_method": "max"}),
    "multiscale_att": ("center_point_baseline_multiscale",
                       {"fusion_method": "att"}),
    "intermediate": ("center_point_intermediate", {}),
    **{f"where2comm_{mode}_{'ms' if ms else 'ss'}": (
        "center_point_where2comm",
        {"where2comm": {"threshold": 0.06, "multi_scale": ms,
                        "agg_operator": {"mode": mode, "n_head": 4,
                                         "with_spe": spe}}})
       for mode, ms, spe in (("max", True, False), ("atten", True, False),
                             ("transformer", True, True),
                             ("atten", False, False),
                             ("transformer", False, True))},
}


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    # heal_tpu's C++ anchor IoU rounds in f32; the port has the numpy path
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def cp_cfg(name: str) -> dict:
    core, args = MODELS[name]
    cfg = jax_load_yaml(TINY)
    cfg["model"]["core_method"] = core
    cfg["model"]["args"].update(copy.deepcopy(args))
    cfg["loss"] = {"core_method": "center_point_loss",
                   "args": {"cls_weight": 1.0, "reg_weight": 2.0}}
    return cfg


def _batch(cfg, train=False, size=1, build=jax_build_dataset):
    np.random.seed(0)
    kw = {} if build is build_dataset else {"process_split": False}
    batch = next(build(cfg, train=train).batches(size, shuffle=False, **kw))
    if cfg["model"]["core_method"] == "center_point":  # one agent: the ego
        batch = dict(batch, points=batch["points"][:, 0],
                     point_mask=batch["point_mask"][:, 0])
    return batch


def _port(cfg, params, stats):
    return load_flax(build_model(cfg["model"],
                                 max_cav=cfg["train_params"]["max_cav"]),
                     params, stats)


def _seeded(cfg, seed):
    model = init_weights(build_model(cfg["model"],
                                     max_cav=cfg["train_params"]["max_cav"]),
                         torch.Generator().manual_seed(seed))
    params, stats = to_flax(model.state_dict())
    return params, _random_stats(stats, seed)


# ------------------------------------------------------------- host side
def test_center_targets_equal_jax():
    """Seeded boxes over the grid, on its border and outside the range:
    every array exactly equal, and ``gaussian_radius`` on seeded sizes."""
    rng = np.random.RandomState(0)
    lr = [-38.4, -38.4, -3, 38.4, 38.4, 1]
    n = 24
    boxes = np.zeros((n + 6, 7))
    boxes[:n, 0:2] = rng.uniform(-38.4, 38.4, (n, 2))
    boxes[:, 2] = -1.0
    boxes[:, 3:6] = rng.uniform(1.0, 5.0, (n + 6, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n + 6)
    # the range's corners and edges: in at -38.4, out at +38.4 and past it
    boxes[n:, 0:2] = [[-38.4, -38.4], [38.39, 38.39], [38.4, 0.0],
                      [0.0, -38.41], [-40.0, 5.0], [0.0, 0.0]]
    mask = np.ones(n + 6)
    mask[3] = 0
    want = jax_targets.generate_center_targets(boxes, mask, (64, 64), lr,
                                               1.2)
    got = targets.generate_center_targets(boxes, mask, (64, 64), lr, 1.2)
    assert want["reg_mask"].sum() >= n - 1  # the border boxes went in
    for k in LABELS:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for h, w, ov in rng.uniform(0.1, 12.0, (32, 3)):
        ov = ov / 13.0
        assert targets.gaussian_radius(h, w, ov) == \
            jax_targets.gaussian_radius(h, w, ov)


@pytest.mark.parametrize("train", [False, True])
def test_host_batch_labels_equal_jax(train):
    cfg = cp_cfg("where2comm_max_ms")
    want = _batch(cfg, train=train, size=2)
    got = _batch(cfg, train=train, size=2, build=build_dataset)
    assert got.keys() == want.keys()
    assert want["heatmap"].shape == (2, 64, 64, 1)
    assert want["reg_mask"].sum() > 0
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k


# ------------------------------------------------------------ loss, decode
def _heads_and_labels(seed, b=2, h=16, w=16):
    rng = np.random.RandomState(seed)
    hm = np.clip(rng.uniform(-0.5, 1.0, (b, h, w, 1)), 0, 1)
    hm[rng.uniform(size=hm.shape) > 0.97] = 1.0
    reg_mask = (hm[..., 0] == 1.0).astype(np.float32)
    return (
        {"cls_preds": rng.normal(0, 2, (b, h, w, 1)).astype(np.float32),
         "reg_preds": rng.normal(0, 1, (b, h, w, 7)).astype(np.float32)},
        {"heatmap": hm.astype(np.float32),
         "box_targets": rng.normal(0, 1, (b, h, w, 7)).astype(np.float32),
         "reg_mask": reg_mask})


@pytest.mark.parametrize("args", [{"cls_weight": 1.0, "reg_weight": 2.0},
                                  {"cls": {"weight": 0.5},
                                   "reg": {"weight": 3.0, "sigma": 2.0}}])
def test_center_point_loss_equals_jax(args):
    """JAX reads ``cls.weight`` / ``reg.weight`` and ignores the published
    flat keys; the port mirrors it."""
    cfg = {"core_method": "center_point_loss", "args": args}
    out, tgt = _heads_and_labels(1)
    want_total, want = build_jax_loss(cfg)(
        jax.tree.map(jnp.asarray, out), jax.tree.map(jnp.asarray, tgt))
    got_total, got = build_loss(cfg)(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in tgt.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got_total.item(), float(want_total),
                               rtol=1e-6)


def test_anchor_free_decode_equals_jax():
    """Seeded heads with boxes planted in the range: the regression is the
    box, the anchors are never read (NaN here), no direction head."""
    rng = np.random.RandomState(2)
    h = w = 32
    cls = rng.normal(-4, 2, (h, w, 1)).astype(np.float32)
    reg = np.zeros((h, w, 7), np.float32)
    reg[..., 0:2] = rng.uniform(-30, 30, (h, w, 2))
    reg[..., 2] = -1.0
    reg[..., 3:6] = [1.56, 1.6, 3.9]
    reg[..., 6] = rng.uniform(-np.pi, np.pi, (h, w))
    t = np.eye(4, dtype=np.float32)
    t[:3, 3] = [0.7, -0.4, 0.0]
    gt_range = np.array([-38.4, -38.4, -3, 38.4, 38.4, 1], np.float32)
    anchors = np.full((h, w, 1, 7), np.nan, np.float32)
    want = jax.device_get(jax_post_process(
        jnp.asarray(cls), jnp.asarray(reg), None, jnp.asarray(anchors),
        jnp.asarray(t), jnp.asarray(gt_range), max_det=64, anchor_free=True))
    got = post_process_single(
        torch.from_numpy(cls), torch.from_numpy(reg), None,
        torch.from_numpy(anchors), torch.from_numpy(t),
        torch.from_numpy(gt_range), max_det=64, anchor_free=True)
    valid = np.asarray(want["valid"])
    assert 0 < valid.sum() < 64
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-6)
    for k in ("boxes", "corners"):
        np.testing.assert_allclose(got[k].numpy()[valid],
                                   np.asarray(want[k])[valid], rtol=0,
                                   atol=1e-5, err_msg=k)


# ------------------------------------------------------------------ models
def test_center_heads_init_and_resize_nearest():
    """The heatmap bias starts at -2.19 in both packages; the nearest
    resize reads JAX's source indices at non-integer ratios."""
    x = jnp.zeros((1, 4, 4, 8))
    v = jax.device_get(JaxCenterHeads().init(jax.random.PRNGKey(0), x))
    cfg = cp_cfg("center_point")
    model = init_weights(build_model(cfg["model"]),
                         torch.Generator().manual_seed(0))
    bias = model.CenterHeads_0.heatmap_head.bias
    np.testing.assert_array_equal(
        bias.detach().numpy(), v["params"]["heatmap_head"]["bias"])
    assert float(bias.detach()) == pytest.approx(-2.19)
    rng = np.random.RandomState(0)
    for shape, size in (((1, 2, 7, 5, 1), (3, 9)), ((2, 1, 8, 8, 1), (5, 3)),
                        ((1, 1, 6, 6, 2), (6, 4))):
        x = rng.normal(size=shape).astype(np.float32)
        want = jax.image.resize(jnp.asarray(x), shape[:2] + size
                                + shape[4:], "nearest")
        got = resize_nearest(torch.from_numpy(x), *size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(MODELS))
def test_jax_init_bridges_strictly(name):
    """JAX's variables (their shapes, by ``jax.eval_shape``) map key for
    key onto the port's state_dict: no key missing or extra."""
    cfg = cp_cfg(name)
    batch = _batch(cfg)
    jm = build_flax(cfg["model"])
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.PRNGKey(0), b,
                                              train=False),
                            jax.tree.map(jnp.asarray, batch))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = build_model(cfg["model"], max_cav=cfg["train_params"]["max_cav"])
    from_flax(zeros["params"], zeros.get("batch_stats"),
              expected=model.state_dict())


@pytest.mark.parametrize("name", list(MODELS))
def test_heads_match_jax(name):
    cfg = cp_cfg(name)
    batch = _batch(cfg)
    params, stats = _seeded(cfg, seed=list(MODELS).index(name))
    jm = build_flax(cfg["model"])
    keys = HEADS + ("comm_rate", "spatial_features_2d")
    want = jax.device_get(jax.jit(lambda v, b: {
        k: x for k, x in jm.apply(v, b, train=False).items() if k in keys})(
            {"params": params, "batch_stats": stats},
            jax.tree.map(jnp.asarray, batch)))
    with torch.no_grad():
        got = _port(cfg, params, stats)(_model_batch(batch))
    assert got["anchor_free"] is True
    assert sorted(k for k in got if k in keys) == sorted(want)
    assert want["cls_preds"].shape[-1] == 1
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == np.shape(w), k
        assert _rel(g, w) <= TOL, (k, _rel(g, w))
    if "comm_rate" in want:
        # the seeded heads' confidence straddles the threshold
        assert 0 < float(got["comm_rate"]) < 1


@pytest.mark.parametrize("name", ["where2comm_transformer_ss",
                                  "where2comm_max_ms"])
def test_train_step_matches_jax_f64(name):
    """One step at batch 2 of the intermediate train split (the port with
    no random streams, JAX's without rngs: the comm threshold stays
    fixed): loss terms at 1e-5 and every gradient leaf within 1e-4 of
    JAX's f64 step; the updated running statistics within 1e-4 too. The
    multiscale model runs the backbone twice in train mode, so its
    running statistics move twice in both.

    These steps' gradients are ill conditioned for some inits: the
    port's exact warp samples at f32 positions by design, and at seed 11
    that alone puts the single-scale step's gradients 5.9e-3 off the
    witness (the port in f64 too); JAX's own f32 step is 2.5e-2 off it at
    seed 0 and 1.8e-2 at seed 11. At seed 0 the port's f32 step is
    1.7e-5 (single scale) and 1.7e-5 (multiscale) off the witness."""
    cfg = cp_cfg(name)
    batch = _batch(cfg, train=True, size=2)
    params, stats = _seeded(cfg, seed=0)
    jt = JaxTrainer(model=build_flax(cfg["model"]),
                    criterion=build_jax_loss(cfg["loss"]), tx=None)
    want_aux, new_stats, grads = _jax_f64_step(jt, params, stats, batch)
    model = _port(cfg, params, stats)
    opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                    cfg["lr_scheduler"], 4)
    port = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                   rng_seed=None)
    aux = port.train_step(to_device(batch, "cpu"))
    assert "comm_rate" in aux
    assert sorted(aux) == sorted(want_aux)
    for k, w in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), w, rtol=1e-5, err_msg=k)
    got = _leaves(to_flax({k: p.grad for k, p in model.named_parameters()})[0])
    want = _leaves(grads)
    assert got.keys() == want.keys()
    errs = {k: _rel(g, want[k]) for k, g in got.items()}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda x: x[1])
    got_stats = _leaves(to_flax(model.state_dict())[1])
    want_stats = _leaves(new_stats)
    assert got_stats.keys() == want_stats.keys()
    errs = {k: _rel(g, want_stats[k]) for k, g in got_stats.items()}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda x: x[1])


def test_train_cli_then_inference(tmp_path):
    """``tools/train.py`` one epoch of the Where2comm CenterPoint, then
    ``tools/inference.py`` on its run: anchor-free decode, AP in range,
    ``comm_rate`` reported."""
    cfg = cp_cfg("where2comm_transformer_ss")
    cfg["fusion"]["args"].update(num_scenes_train=4, num_scenes_test=2)
    yaml = str(tmp_path / "cp.yaml")
    save_yaml(cfg, yaml)
    run = str(tmp_path / "run")
    train_tool.main(["-y", yaml, "--model_dir", run, "--epochs", "1",
                     "--device", "cpu"])
    assert os.path.exists(os.path.join(run, "net_epoch_bestval_at1.pth"))
    result = run_inference(run, device="cpu", collect_heads=True)
    assert result["frames"] == 2
    assert result["heads"][0]["cls_preds"].shape == (1, 64, 64, 1)
    assert 0 < result["comm_rate"] <= 1
    for t in ("ap_30", "ap_50", "ap_70"):
        assert 0.0 <= result[t] <= 1.0
