"""HEAL's bandwidth compressors in the port against heal_tpu's, on the CPU.

  * ``models/layers.NaiveCompressor`` and ``AutoEncoder`` (1 and 2
    stages) on a seeded (2, 16, 12, 16) map, eval and train mode: the
    output, and in train mode the running statistics, within 1e-5;
  * ``heter_pyramid_collab`` with a ``compressor`` (naive and
    autoencoder) on tests/configs/tiny_heter_collab.yaml: eval heads
    within 1e-5 of JAX's (JAX's init, running statistics randomised);
  * the compressor finetune (``opv2v/heal/stage1/m1_pyramid_compress
    .yaml``'s mechanism at the tiny width): a collab base saved as
    ``.pth``, loosely loaded (every base key taken; only the
    compressor's keys left to their init), one step against JAX's
    ``Trainer`` with ``freeze_wrap`` and ``fix_modules``: loss terms 1e-5
    relative; every frozen parameter and running statistic bit-equal to
    the base in both packages (JAX's ``freeze_stats``); the compressor's
    running statistics within 1e-4 of JAX's, and its gradients within
    1e-4 (the port's f64 step) and 2e-4 (its f32 step) of JAX's own step
    in f64 (tests/test_torch_train.py's witness; the test says why);
    ``tools/train.py --init_from`` one epoch, after which only
    ``compressor.*`` moved;
  * the published configs: ``m1_pyramid_compress.yaml``'s model is
    ``m1_pyramid.yaml``'s plus ``compressor.*`` (same keys and shapes);
  * ``point_pillar_baseline`` with ``compression`` (its
    ``NaiveCompressor_0`` after the shrink): heads within 1e-4, a
    heal_tpu ``.ckpt`` loaded strictly.
Tolerances as max |d| / (1 + max |ref|) unless said otherwise.
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
from heal_tpu.data import build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.models.layers import AutoEncoder as JaxAutoEncoder
from heal_tpu.models.layers import NaiveCompressor as JaxNaiveCompressor
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.parallel.freezing import freeze_wrap
from heal_tpu.parallel.schedulers import build_optimizer as jax_optimizer
from heal_tpu.parallel.trainer import TrainState
from heal_tpu.tools.checkpoint import save_checkpoint as jax_save
from heal_tpu_torch.config import load_yaml, save_yaml
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.layers import (AutoEncoder, NaiveCompressor,
                                         init_weights)
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.parallel.freezing import freeze, trainable_parameters
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.tools.inference import build_weights
from heal_tpu_torch.utils.bridge import from_flax, load_flax, to_flax
from test_torch_point_pillar import (_jax_heads, _model_batch, _port,
                                     _random_stats, _tensors, _variables,
                                     baseline_cfg)
from test_torch_point_pillar import _batch as _pp_batch
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
COLLAB = "tests/configs/tiny_heter_collab.yaml"
PUBLISHED = "heal_tpu/configs/opv2v/heal/stage1/"
COMPRESSORS = {"naive": {"core_method": "naive", "input_dim": 32,
                         "compress_ratio": 4},
               "autoencoder": {"core_method": "autoencoder",
                               "input_dim": 32, "layer_num": 1}}
STEPS_PER_EPOCH = 4


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def _module_case(jmod, tmod, train: bool):
    x = np.random.RandomState(0).normal(0, 1, (2, 16, 12, 16)).astype(
        np.float32)
    v = jax.device_get(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    stats = _random_stats(v["batch_stats"], 2)
    load_flax(tmod, v["params"], stats)
    want, new = jmod.apply({"params": v["params"], "batch_stats": stats},
                           jnp.asarray(x), train, mutable=["batch_stats"])
    tmod.train(train)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == x.shape
    assert _rel(got, np.asarray(want)) <= 1e-5, _rel(got, np.asarray(want))
    sd = tmod.state_dict()
    ref = from_flax(v["params"], jax.device_get(new["batch_stats"]))
    assert sd.keys() == ref.keys()
    for k, t in sd.items():
        assert _rel(t.numpy(), ref[k].numpy()) <= 1e-5, k
    moved = [k for k, t in from_flax(v["params"], stats).items()
             if not torch.equal(t, sd[k])]
    assert bool(moved) == train  # running statistics move in train mode


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_naive_compressor_matches_jax(train):
    tmod = NaiveCompressor(16, 4)
    assert [n for n, _ in tmod.named_children()] == [
        "ConvNormAct_0", "ConvNormAct_1", "ConvNormAct_2"]
    _module_case(JaxNaiveCompressor(input_dim=16, compress_ratio=4), tmod,
                 train)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("layers", [1, 2])
def test_autoencoder_matches_jax(layers, train):
    tmod = AutoEncoder(16, layers)
    assert sorted(n for n, _ in tmod.named_children()) == sorted(
        f"{s}_{i}{h}" for s in ("enc", "dec") for i in range(layers)
        for h in "ab")
    _module_case(JaxAutoEncoder(feature_num=16, layer_num=layers), tmod,
                 train)


def compress_cfg(kind: str) -> dict:
    cfg = jax_load_yaml(COLLAB)
    cfg["model"]["args"]["compressor"] = copy.deepcopy(COMPRESSORS[kind])
    return cfg


def _test_batch(cfg):
    return next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))


@pytest.mark.parametrize("kind", list(COMPRESSORS))
def test_collab_with_compressor_heads_match_jax(kind):
    cfg = compress_cfg(kind)
    batch = _test_batch(cfg)
    assert batch["agent_mask"].sum() == 2
    jm = build_flax(cfg["model"])
    v = jax.device_get(jax.jit(lambda b: jm.init(
        jax.random.PRNGKey(4), b, train=False))(
            jax.tree.map(jnp.asarray, batch)))
    assert "compressor" in v["params"]
    variables = {"params": v["params"],
                 "batch_stats": _random_stats(v["batch_stats"], 4)}
    want = _jax_heads(jm, variables, batch,
                      ("cls_preds", "reg_preds", "dir_preds"))
    model = load_flax(build_model(cfg["model"]), variables["params"],
                      variables["batch_stats"])
    assert model.fix_modules == tuple(jm.fix_modules) == (
        "branch_m1", "pyramid_backbone", "shrink", "heads")
    with torch.no_grad():
        got = model(_tensors({k: batch[k] for k in (
            "inputs_m1", "slots_m1", "agent_mask", "pairwise_affine")}))
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert _rel(got[k].numpy(), w) <= 1e-5, (k, _rel(got[k].numpy(), w))


@pytest.fixture(scope="module")
def finetune(tmp_path_factory):
    """A collab base (the port's seeded init of tiny_heter_collab.yaml,
    running statistics randomised) saved as ``.pth``, loosely loaded into
    the compressed model (the port's seeded init): the variables both
    packages finetune from, the train batch, the base."""
    heal_tpu.native.load, load = (lambda: None), heal_tpu.native.load
    try:
        base_cfg, cfg = jax_load_yaml(COLLAB), compress_cfg("naive")
        base = init_weights(build_model(base_cfg["model"]),
                            torch.Generator().manual_seed(0))
        p, st = to_flax(base.state_dict())
        base.load_state_dict(from_flax(p, _random_stats(st, 3)))
        run = str(tmp_path_factory.mktemp("base"))
        base_path = ckpt_lib.save_checkpoint(run, base, 1)
        model = init_weights(build_model(cfg["model"]),
                             torch.Generator().manual_seed(1))
        assert ckpt_lib.loose_load(model, base_path) == []
        missing = set(model.state_dict()) - set(base.state_dict())
        assert missing and all(k.startswith("compressor.") for k in missing)
        params, stats = to_flax(model.state_dict())
        batch = next(build_dataset(cfg, train=True).batches(
            2, shuffle=False, process_split=False))
    finally:
        heal_tpu.native.load = load
    return cfg, params, stats, batch, base, base_path


def _frozen(sd: dict, fix) -> dict:
    return {k: v for k, v in sd.items() if k.split(".")[0] in fix}


def test_finetune_step_matches_jax_and_keeps_the_base(finetune):
    cfg, params, stats, batch, base, _ = finetune
    jm = build_flax(cfg["model"])
    fix = tuple(jm.fix_modules)
    tx = freeze_wrap(jax_optimizer(cfg["optimizer"], cfg["lr_scheduler"],
                                   STEPS_PER_EPOCH), params, fix)
    jt = JaxTrainer(model=jm, criterion=build_jax_loss(cfg["loss"]), tx=tx,
                    fix_modules=fix).compile()
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree.map(jnp.asarray, params),
                       batch_stats=jax.tree.map(jnp.asarray, stats),
                       opt_state=tx.init(params))
    new, aux = jax.device_get(jt.train_step(state,
                                            jax.tree.map(jnp.asarray, batch)))

    model = load_flax(build_model(cfg["model"]), params, stats)
    assert model.fix_modules == fix
    frozen_names = freeze(model, fix)
    opt, schedule = build_optimizer(trainable_parameters(model),
                                    cfg["optimizer"], cfg["lr_scheduler"],
                                    STEPS_PER_EPOCH)
    port = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                   fix_modules=fix)
    got = port.train_step(to_device(batch, "cpu"))
    assert sorted(got) == sorted(aux)
    for k, v in aux.items():
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-5, err_msg=k)

    # everything but the compressor is the base's, bit for bit, in both
    want_base = _frozen(base.state_dict(), fix)
    after = port.model.state_dict()
    jafter = from_flax(new.params, new.batch_stats)
    assert len(want_base) > len(frozen_names) > 50  # buffers too
    assert set(after) - set(want_base) == {
        k for k in after if k.startswith("compressor.")}
    for k, v in want_base.items():
        assert torch.equal(after[k], v), k
        assert torch.equal(jafter[k], v), k
    # ... while the compressor moved, in both, and its running
    # statistics agree
    start = from_flax(params, stats)
    comp = [k for k in after if k.startswith("compressor.")]
    assert all(not torch.equal(after[k], start[k]) for k in comp), comp
    assert all(not torch.equal(jafter[k], start[k]) for k in comp)
    for k in comp:
        if k.endswith((".mean", ".var")):
            assert _rel(after[k].numpy(), jafter[k].numpy()) <= 1e-4, k
    assert all(p.grad is None for n, p in port.model.named_parameters()
               if n in frozen_names)


def test_finetune_gradients_hold_to_jax_f64_step(finetune):
    """The compressor's gradients through the frozen base against JAX's
    own step in f64: the port's f64 step within 1e-4, its f32 step within
    2e-4 (measured 5.6e-5 and 1.55e-4; the bound of f32 was set after
    that first reading). Not closer, as in tests/test_torch_train.py: the
    port keeps the frozen PFN's moments and the warp's blend in f32 by
    design and the bridge rounds the leaves to f32, and here three
    train-mode batch norms over the 32 -> 8 -> 32 bottleneck amplify
    that; the compressor alone agrees with JAX's to 6e-8 in f64."""
    cfg, params, stats, batch, _, _ = finetune
    jm = build_flax(cfg["model"])
    jt = JaxTrainer(model=jm, criterion=build_jax_loss(cfg["loss"]),
                    tx=None, fix_modules=tuple(jm.fix_modules))
    want_aux, _, grads = _jax_f64_step(jt, params, stats, batch)
    want = {k: v for k, v in _leaves(grads).items()
            if k.startswith("['compressor']")}
    for dtype, bound in ((torch.float64, 1e-4), (torch.float32, 2e-4)):
        model = load_flax(build_model(cfg["model"]), params, stats).to(dtype)
        opt, schedule = build_optimizer(
            [p for n, p in model.named_parameters()
             if n.startswith("compressor.")],
            cfg["optimizer"], cfg["lr_scheduler"], STEPS_PER_EPOCH)
        port = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                       fix_modules=model.fix_modules)
        b = to_device(batch, "cpu")
        if dtype == torch.float64:
            b = jax.tree.map(lambda t: t.double() if t.is_floating_point()
                             else t, b)
        aux = port.train_step(b)
        np.testing.assert_allclose(aux["total_loss"].item(),
                                   want_aux["total_loss"], rtol=1e-5)
        got = _leaves(to_flax({k: p.grad for k, p in
                               model.named_parameters()
                               if k.startswith("compressor.")})[0])
        assert got.keys() == want.keys() and len(got) == 9
        errs = {k: _rel(v, want[k]) for k, v in got.items()}
        assert max(errs.values()) <= bound, (
            dtype, max(errs.items(), key=lambda kv: kv[1]))
        assert max(float(np.abs(v).max()) for v in got.values()) > 0


def test_finetune_through_the_train_cli(finetune, tmp_path, capsys):
    cfg, _, _, _, base, base_path = finetune
    yaml = str(tmp_path / "compress.yaml")
    save_yaml(cfg, yaml)
    run = str(tmp_path / "run")
    train_tool.main(["-y", yaml, "--model_dir", run, "--epochs", "1",
                     "--init_from", base_path, "--device", "cpu",
                     "--no_final_inference"])
    printed = capsys.readouterr().out
    assert "0 keys left out" in printed and "frozen modules" in printed
    sd = ckpt_lib.load_state_dict(ckpt_lib.find_checkpoint(run)[1])
    init = build_weights(load_yaml(yaml), seed=0).state_dict()
    for k, v in sd.items():
        if k.startswith("compressor."):
            assert not torch.equal(v, init[k]), k
        else:
            assert torch.equal(v, base.state_dict()[k]), k


def test_published_compress_config_is_the_base_plus_a_compressor():
    base = build_model(load_yaml(PUBLISHED + "m1_pyramid.yaml")["model"])
    model = build_model(load_yaml(PUBLISHED + "m1_pyramid_compress.yaml")
                        ["model"])
    assert isinstance(model.compressor, NaiveCompressor)
    assert base.fix_modules == () and model.fix_modules == (
        "branch_m1", "pyramid_backbone", "shrink", "heads")
    own, sd = model.state_dict(), base.state_dict()
    assert {k for k in own if k not in sd} == {
        k for k in own if k.startswith("compressor.")} != set()
    for k, v in sd.items():
        assert own[k].shape == v.shape, k
    # 64 -> 16 -> 64 -> 64 channels
    assert own["compressor.ConvNormAct_0.kernel"].shape == (16, 64, 3, 3)


def test_point_pillar_baseline_compression_matches_jax(tmp_path):
    cfg = baseline_cfg("max")
    cfg["model"]["args"]["compression"] = 4
    batch = _pp_batch(cfg)
    jm, v = _variables(cfg, batch, seed=5, jax_init=False)
    assert "NaiveCompressor_0" in v["params"]
    want = _jax_heads(jm, v, batch, ("cls_preds", "reg_preds", "dir_preds"))
    model = _port(cfg, v)
    assert model.NaiveCompressor_0.ConvNormAct_0.kernel.shape == (8, 32, 3,
                                                                  3)
    with torch.no_grad():
        got = model(_model_batch(batch))
    for k, w in want.items():
        assert _rel(got[k].numpy(), w) <= 1e-4, (k, _rel(got[k].numpy(), w))
    path = jax_save(str(tmp_path), v, 1)
    loaded = build_weights(cfg, checkpoint=path)
    for k, t in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], t), k
    assert os.path.exists(path)
