"""HEAL's stages 2 and 3 for lidar agents, port vs JAX, on the CPU.

Stage 1 is tests/configs/entry_tiny.yaml (m1 collab base), stage 2
entry_m4_single.yaml (a 16-line PointPillars agent with a res3x3 aligner,
``heter_pyramid_single``), stage 3 the alliance entry_m1m2m3m4_final.yaml
cut in code (``config.keep_modalities``; the YAML is not edited) to the
types a test trains: m1 + m4, and m1 + m3 + m4 with the SECOND agent
(the uncut four-type alliance is in tests/test_torch_second_slice.py).
Stated tolerances:

  * heads 1e-5 of 1 + max |JAX| (max |d| / (1 + max |ref|)): f32
    convolutions summed in another order;
  * the stage-2 step: loss terms 1e-5 relative; ``branch_m4``'s gradients
    within 1e-4 of JAX's own step in f64, as the stage-1 witness
    (tests/test_torch_train.py: JAX's f32 train-mode BN gradients are
    themselves ~5e-3 off it); the frozen modules' parameters and running
    statistics bit-equal to the loaded values in both packages;
  * the merge: exact.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.data import build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.parallel.freezing import freeze_wrap
from heal_tpu.parallel.schedulers import build_optimizer as jax_optimizer
from heal_tpu.parallel.trainer import TrainState
from heal_tpu.tools import checkpoint as jax_ckpt
from heal_tpu_torch.config import keep_modalities
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.parallel.freezing import freeze, trainable_parameters
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools.merge import DROP_FROM_NEW_TYPES
from heal_tpu_torch.utils.bridge import from_flax, load_flax, to_flax
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
TINY = "tests/configs/entry_tiny.yaml"
M4 = "tests/configs/entry_m4_single.yaml"
FINAL = "tests/configs/entry_m1m2m3m4_final.yaml"
FROZEN = ("pyramid_backbone", "shrink", "heads")
STEPS_PER_EPOCH = 4


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


def _heads_match(cfg, batch, keys, seed):
    """A JAX init of ``cfg``'s model (running statistics randomised)
    bridged into the port: eval heads within 1e-5."""
    jb = jax.tree.map(jnp.asarray, batch)
    jm = build_flax(cfg["model"])
    v = jax.device_get(jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(seed), b, train=False))(jb))
    variables = {"params": v["params"],
                 "batch_stats": _random_stats(v["batch_stats"], seed)}
    want = jax.device_get(jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items()
        if k in ("cls_preds", "reg_preds", "dir_preds")})(variables, jb))
    tm = load_flax(build_model(cfg["model"]), variables["params"],
                   variables["batch_stats"])
    with torch.no_grad():
        got = tm(_tensors({k: batch[k] for k in keys}))
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert _rel(got[k].numpy(), w) <= 1e-5, (k, _rel(got[k].numpy(), w))
    return got


def test_heter_pyramid_single_heads_match_jax():
    cfg = jax_load_yaml(M4)
    batch = next(build_dataset(cfg, train=False).batches(
        2, shuffle=False, process_split=False))
    got = _heads_match(cfg, batch, ("inputs_m4", "slots_m4", "agent_mask",
                                    "pairwise_affine"), seed=1)
    assert got["cls_preds"].shape[0] == 2  # (B * max_cav 1) agents


def test_m1m4_alliance_heads_match_jax():
    cfg = keep_modalities(jax_load_yaml(FINAL), ("m1", "m4"))
    assert sorted(cfg["heter"]["modality_setting"]) == ["m1", "m4"]
    assert not {"m2", "m3"} & set(cfg["model"]["args"])
    batch = next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))
    # both branches carry agents: m1 in slots 0 and 2, m4 in 1 and 3
    assert batch["slots_m1"][0, :2].tolist() == [0, 2]
    assert batch["slots_m4"][0, :2].tolist() == [1, 3]
    _heads_match(cfg, batch, ("inputs_m1", "slots_m1", "inputs_m4",
                              "slots_m4", "agent_mask", "pairwise_affine"),
                 seed=2)


def test_m1m3m4_alliance_heads_match_jax():
    cfg = keep_modalities(jax_load_yaml(FINAL), ("m1", "m3", "m4"))
    assert {"m1", "m3", "m4"} <= set(cfg["model"]["args"])
    assert "m2" not in cfg["model"]["args"]
    batch = next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))
    # every branch carries an agent, the ego an m1
    assert batch["slots_m1"][0, 0] == 0
    assert all(batch[f"slots_{m}"][0, 0] < 4 for m in ("m3", "m4"))
    _heads_match(cfg, batch, ("inputs_m1", "slots_m1", "inputs_m3",
                              "slots_m3", "inputs_m4", "slots_m4",
                              "agent_mask", "pairwise_affine"), seed=4)


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    """Stage-1 variables (the port's seeded init of entry_tiny, running
    statistics randomised) loosely loaded into the stage-2 model (the
    port's seeded init of entry_m4_single): the variables both packages
    start stage 2 from, and the stage-2 batch."""
    s1cfg, s2cfg = jax_load_yaml(TINY), jax_load_yaml(M4)
    base = init_weights(build_model(s1cfg["model"]),
                        torch.Generator().manual_seed(0))
    p1, st1 = to_flax(base.state_dict())
    base.load_state_dict(from_flax(p1, _random_stats(st1, 3)))
    run = str(tmp_path_factory.mktemp("stage1"))
    s1_path = ckpt_lib.save_checkpoint(run, base, 1)
    single = init_weights(build_model(s2cfg["model"]),
                          torch.Generator().manual_seed(1))
    left = ckpt_lib.loose_load(single, s1_path)
    assert left and all(k.startswith("branch_m1.") for k in left), left
    params, stats = to_flax(single.state_dict())
    batch = next(build_dataset(s2cfg, train=True).batches(
        2, shuffle=False, process_split=False))
    return s2cfg, params, stats, batch, base


def _frozen(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.split(".")[0] in FROZEN}


def test_stage2_step_matches_jax_and_keeps_the_base(stage2):
    cfg, params, stats, batch, base = stage2
    jm = build_flax(cfg["model"])
    fix = tuple(jm.fix_modules)
    assert fix == FROZEN
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
    # the base stayed where it was loaded, bit for bit, in both packages
    loaded = _frozen(from_flax(params, stats))
    assert loaded and len(frozen_names) < len(loaded)  # buffers too
    for k, v in _frozen(port.model.state_dict()).items():
        assert torch.equal(v, loaded[k]), k
    after = _frozen(from_flax(new.params, new.batch_stats))
    assert after.keys() == loaded.keys()
    for k, v in after.items():
        assert torch.equal(v, loaded[k]), k
    # the stage-1 base's own values are what was frozen
    for k, v in _frozen(base.state_dict()).items():
        assert torch.equal(v, loaded[k]), k
    # ... while branch_m4 moved, in both
    start = from_flax(params, stats)
    moved = [k for k, v in port.model.state_dict().items()
             if k.startswith("branch_m4.") and not torch.equal(v, start[k])]
    assert len(moved) > 20
    jmoved = from_flax(new.params, new.batch_stats)
    assert all(not torch.equal(jmoved[k], start[k]) for k in moved)
    assert all(p.grad is None for n, p in port.model.named_parameters()
               if n in frozen_names)


def test_stage2_gradients_hold_to_jax_f64_step(stage2):
    """``branch_m4``'s f32 gradients through the frozen base within 1e-4
    of JAX's own f64 step (tests/test_torch_train.py's witness)."""
    cfg, params, stats, batch, _ = stage2
    jm = build_flax(cfg["model"])
    jt = JaxTrainer(model=jm, criterion=build_jax_loss(cfg["loss"]),
                    tx=None, fix_modules=tuple(jm.fix_modules))
    want_aux, _, grads = _jax_f64_step(jt, params, stats, batch)
    model = load_flax(build_model(cfg["model"]), params, stats)
    opt, schedule = build_optimizer(
        [p for n, p in model.named_parameters() if n.startswith("branch_")],
        cfg["optimizer"], cfg["lr_scheduler"], STEPS_PER_EPOCH)
    port = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                   fix_modules=tuple(jm.fix_modules))
    aux = port.train_step(to_device(batch, "cpu"))
    np.testing.assert_allclose(aux["total_loss"].item(),
                               want_aux["total_loss"], rtol=1e-5)
    got = _leaves(to_flax({k: p.grad for k, p in model.named_parameters()
                           if p.grad is not None})[0])
    want = {k: v for k, v in _leaves(grads).items()
            if k.startswith("['branch_m4']")}
    assert got.keys() == want.keys() and len(got) == 18
    errs = {k: _rel(v, want[k]) for k, v in got.items()}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])
    assert max(float(np.abs(v).max()) for v in got.values()) > 0


def test_trainer_refuses_frozen_parameters_in_the_optimizer(stage2):
    cfg, params, stats, _, _ = stage2
    model = load_flax(build_model(cfg["model"]), params, stats)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, weight_decay=1e-4)
    with pytest.raises(ValueError, match="frozen parameters"):
        Trainer(model, build_loss(cfg["loss"]), opt, lambda step: 1e-3,
                fix_modules=FROZEN)


def test_merge_matches_jax(stage2, tmp_path):
    """The port's merge of heal_tpu ``.ckpt`` files equals the bridge of
    JAX's merge of the same files, and its merge of the same checkpoints
    as port ``.pth`` files too; the base wins the shared modules."""
    cfg, params, stats, _, base = stage2
    p1, st1 = to_flax(base.state_dict())
    # a stage-2 state whose shared modules differ from the base's
    p2 = jax.tree.map(lambda x: x + 1.0, params)
    paths = [jax_ckpt.save_checkpoint(str(tmp_path / "s2"),
                                      {"params": p2, "batch_stats": stats}, 1),
             jax_ckpt.save_checkpoint(str(tmp_path / "s1"),
                                      {"params": p1, "batch_stats": st1}, 1)]
    want_tree = jax_ckpt.merge_checkpoints(paths, DROP_FROM_NEW_TYPES)
    want = from_flax(want_tree["params"], want_tree["batch_stats"])
    got = ckpt_lib.merge_checkpoints(paths, DROP_FROM_NEW_TYPES)
    pths = [ckpt_lib.save_checkpoint(str(tmp_path / f"p{i}"),
                                     ckpt_lib.load_state_dict(p), 1)
            for i, p in enumerate(paths)]
    got_pth = ckpt_lib.merge_checkpoints(pths, DROP_FROM_NEW_TYPES)
    for merged in (got, got_pth):
        assert merged.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(merged[k], v), k
    base_sd = base.state_dict()
    assert {k.split(".")[0] for k in want} == {"branch_m1", "branch_m4",
                                                *FROZEN}
    for k in _frozen(want):
        assert torch.equal(want[k], base_sd[k]), k
    # the alliance model takes the merge strictly
    final = keep_modalities(jax_load_yaml(FINAL), ("m1", "m4"))
    final_model = build_model(final["model"])
    final_model.load_state_dict(got, strict=True)
    assert os.path.basename(pths[0]) == "net_epoch1.pth"
