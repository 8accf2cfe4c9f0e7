"""The SECOND agent type (m3) through the HEAL models, port vs JAX, on
the CPU.

Each test feeds one batch of heal_tpu's host side to both packages and
bridges one set of weights (a port init, running statistics randomised).

  * ``HeterPyramidSingle`` m3 (tests/configs/entry_m3_single.yaml: a
    (8, 256, 256) voxel grid, channels 8/16/16/16, capacities
    2048/1536/1024/768, a res3x3 aligner): eval heads within 1e-5 of
    1 + max |JAX| (max |d| / (1 + max |ref|)); one stage-2 step with the
    base frozen, loss terms 1e-5 relative, the frozen modules bit-equal
    in both packages and ``branch_m3`` moved in both; ``branch_m3``'s f32
    gradients within 1e-5 of JAX's own step in f64 (the witness of
    tests/test_torch_train.py), every leaf as max |d| / (1 + max |ref|).
    The SECOND stack normalises with LayerNorm, and only the branch's
    small backbone and aligner hold train-mode batch norms, so the f32
    steps stay close: measured,
    the port's 2.0e-6 off the witness and JAX's own f32 step 1.0e-5,
    tighter than the ~2e-2 of the whole collab model (ROADMAP's parity
    conventions);
  * the uncut four-type alliance (tests/configs/entry_m1m2m3m4_final.yaml,
    an agent of each type): heads within 1e-5 of 1 + max |JAX|;
  * the known reference fault of ADVICE r5, repaired in the port: with
    the host presort off (``preprocess.args.presort: false``) and a heter
    encoder's ``encoder_args.presorted: true``, JAX's builder accepts the
    config and its running max merges voxels without an error; the
    port's builder raises (for the m3 key and the flagship's m1 key).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.models.second import SecondEncoder as JaxSecondEncoder
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.parallel.freezing import freeze_wrap
from heal_tpu.parallel.schedulers import build_optimizer as jax_optimizer
from heal_tpu.parallel.trainer import TrainState
from heal_tpu_torch.config import load_yaml
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.parallel.freezing import freeze, trainable_parameters
from heal_tpu_torch.utils.bridge import from_flax, load_flax, to_flax
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
M3 = "tests/configs/entry_m3_single.yaml"
FINAL = "tests/configs/entry_m1m2m3m4_final.yaml"
HEADS = ("cls_preds", "reg_preds", "dir_preds")
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


def _jax_heads(cfg, variables, batch):
    jm = build_flax(cfg["model"])
    return jax.device_get(jax.jit(lambda v, b: {
        k: x for k, x in jm.apply(v, b, train=False).items() if k in HEADS})(
        variables, jax.tree.map(jnp.asarray, batch)))


# ------------------------------------------------------------ stage 2, m3
@pytest.fixture(scope="module")
def single():
    cfg = jax_load_yaml(M3)
    model = init_weights(build_model(cfg["model"]),
                         torch.Generator().manual_seed(0))
    params, stats = to_flax(model.state_dict())
    stats = _random_stats(stats, 1)
    np.random.seed(0)  # the train split's point subsampling
    batch = next(jax_build_dataset(cfg, train=True).batches(
        2, shuffle=False, process_split=False))
    assert batch["inputs_m3"]["point_mask"].sum() > 300
    return cfg, params, stats, batch


def test_single_m3_heads_match_jax(single):
    cfg, params, stats, batch = single
    want = _jax_heads(cfg, {"params": params, "batch_stats": stats}, batch)
    tm = load_flax(build_model(cfg["model"]), params, stats).eval()
    assert tm.branch_m3.encoder.out_channels == 16  # nz 8 -> 1, times 16
    with torch.no_grad():
        got = tm(_tensors({k: batch[k] for k in ("inputs_m3",
                                                 "agent_mask")}))
    assert got["cls_preds"].shape[:3] == (2, 32, 32)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert _rel(got[k].numpy(), w) <= 1e-5, (k, _rel(got[k].numpy(), w))


def test_single_m3_step_matches_jax(single):
    """One stage-2 step with the base frozen: loss terms against JAX's
    ``Trainer``, the frozen modules bit-equal in both, ``branch_m3``
    (the SECOND kernels and LayerNorms among it) moved in both."""
    cfg, params, stats, batch = single
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
    new, aux = jax.device_get(jt.train_step(
        state, jax.tree.map(jnp.asarray, batch)))

    model = load_flax(build_model(cfg["model"]), params, stats)
    freeze(model, fix)
    opt, schedule = build_optimizer(trainable_parameters(model),
                                    cfg["optimizer"], cfg["lr_scheduler"],
                                    STEPS_PER_EPOCH)
    port = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                   fix_modules=fix)
    got = port.train_step(to_device(batch, "cpu"))
    assert sorted(got) == sorted(aux)
    for k, v in aux.items():
        np.testing.assert_allclose(got[k].item(), v, rtol=1e-5, err_msg=k)
    start = from_flax(params, stats)
    after = port.model.state_dict()
    jafter = from_flax(new.params, new.batch_stats)
    frozen = [k for k in start if k.split(".")[0] in fix]
    assert len(frozen) > 30
    for k in frozen:
        assert torch.equal(after[k], start[k]) and torch.equal(
            jafter[k], start[k]), k
    second = [k for k in start if ".VmapSecondStack_0." in k]
    assert len(second) == 30  # 10 layers: kernel, LN scale and bias
    moved = [k for k in start if k.startswith("branch_m3.")
             and not torch.equal(after[k], start[k])]
    assert set(second) <= set(moved)
    assert all(not torch.equal(jafter[k], start[k]) for k in moved)


def test_single_m3_gradients_hold_to_jax_f64_step(single):
    """``branch_m3``'s f32 gradients through the frozen base within 1e-5
    of JAX's own f64 step; JAX's own f32 step for comparison."""
    cfg, params, stats, batch = single
    jm = build_flax(cfg["model"])
    jt = JaxTrainer(model=jm, criterion=build_jax_loss(cfg["loss"]),
                    tx=None, fix_modules=tuple(jm.fix_modules))
    want_aux, _, grads = _jax_f64_step(jt, params, stats, batch)
    want = {k: v for k, v in _leaves(grads).items()
            if k.startswith("['branch_m3']")}
    (_, _), g32 = jax.device_get(jax.jit(jax.value_and_grad(
        jt._loss_fn, has_aux=True))(params, stats,
                                    jax.tree.map(jnp.asarray, batch)))
    jax32 = max(_rel(v, want[k]) for k, v in _leaves(g32).items()
                if k in want)
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
    assert got.keys() == want.keys()
    assert sum("VmapSecondStack_0" in k for k in got) == 30
    errs = {k: _rel(v, want[k]) for k, v in got.items()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    assert worst[1] <= 1e-5, (worst, jax32)
    assert max(float(np.abs(v).max()) for k, v in got.items()
               if "VmapSecondStack_0" in k) > 0


# ------------------------------------------------------------ the alliance
def test_m1m2m3m4_alliance_heads_match_jax():
    """The uncut alliance config: one agent of each type, the m3 agent
    through the SECOND branch, heads within 1e-5 of JAX's."""
    cfg = jax_load_yaml(FINAL)
    assert sorted(cfg["heter"]["modality_setting"]) == ["m1", "m2", "m3",
                                                         "m4"]
    batch = next(jax_build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))
    assert all((batch[f"slots_{m}"] < 4).any() for m in ("m1", "m2", "m3",
                                                          "m4"))
    assert batch["inputs_m3"]["point_mask"].sum() > 20
    model = init_weights(build_model(cfg["model"]),
                         torch.Generator().manual_seed(2))
    params, stats = to_flax(model.state_dict())
    stats = _random_stats(stats, 2)
    want = _jax_heads(cfg, {"params": params, "batch_stats": stats}, batch)
    tm = load_flax(build_model(cfg["model"]), params, stats).eval()
    keys = ["agent_mask", "pairwise_affine"] + [
        f"{p}_{m}" for m in ("m1", "m2", "m3", "m4")
        for p in ("inputs", "slots")]
    with torch.no_grad():
        got = tm(_tensors({k: batch[k] for k in keys}))
        # without the m3 agent the heads move: its branch reaches them
        cut = copy.deepcopy(batch)
        cut["inputs_m3"]["point_mask"][:] = False
        bare = tm(_tensors({k: cut[k] for k in keys}))
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert _rel(got[k].numpy(), w) <= 1e-5, (k, _rel(got[k].numpy(), w))
    assert float((bare["cls_preds"] - got["cls_preds"]).abs().max()) > 1e-4


# ------------------------------------------------- known reference fault
def _m3_cfg(presort: bool, presorted: bool) -> dict:
    cfg = load_yaml(M3)
    cfg["preprocess"]["args"]["presort"] = presort
    cfg["model"]["args"]["m3"]["encoder_args"]["presorted"] = presorted
    return cfg


def _m3_batch(build, presort: bool, presorted: bool, **kw):
    cfg = _m3_cfg(presort, presorted)
    np.random.seed(0)
    return cfg, next(build(cfg, train=False).batches(2, shuffle=False, **kw))


def test_presort_off_with_presorted_encoder_merges_voxels():
    """ADVICE r5 (ROADMAP §3, repaired in the port): the data knob
    ``preprocess.args.presort`` against the heter encoder's
    ``encoder_args.presorted``. The port's builder refuses the mismatch.
    JAX's builder still accepts it, and on its unsorted batch the
    encoder's running max merges points into wrong voxels with no error:
    the port's encoder on that batch equals JAX's (same weights) and
    differs from the sorted run's."""
    with pytest.raises(ValueError, match="presort"):
        build_dataset(_m3_cfg(presort=False, presorted=True), train=False)
    _, sorted_batch = _m3_batch(build_dataset, presort=True, presorted=True)
    cfg, batch = _m3_batch(jax_build_dataset, presort=False, presorted=True,
                           process_split=False)
    model = init_weights(build_model(cfg["model"]),
                         torch.Generator().manual_seed(3)).eval()
    enc = model.branch_m3.encoder
    params, _ = to_flax(enc.state_dict())
    a = cfg["model"]["args"]["m3"]["encoder_args"]
    jenc = JaxSecondEncoder(
        voxel_size=tuple(a["voxel_size"]), lidar_range=tuple(a["lidar_range"]),
        channels=tuple(a["second"]["channels"]),
        max_voxels=tuple(a["second"]["max_voxels"]), presorted=True)

    def bev(b):
        pts = b["inputs_m3"]["points"][:, 0]
        mask = b["inputs_m3"]["point_mask"][:, 0]
        with torch.no_grad():
            return enc(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()

    got, good = bev(batch), bev(sorted_batch)
    want = np.asarray(jax.device_get(jax.jit(lambda p, m: jenc.apply(
        {"params": params}, p, m))(
        jnp.asarray(batch["inputs_m3"]["points"][:, 0]),
        jnp.asarray(batch["inputs_m3"]["point_mask"][:, 0]))))
    assert _rel(got, want) <= 1e-5
    assert _rel(got, good) > 1e-2


def test_presort_guard_reads_the_flagship_m1_encoder_args():
    """The flagship sets its m1 encoder's ``presorted`` under
    ``model.args.m1.encoder_args`` (opv2v_m1_pyramid.yaml): with the host
    presort off, the port's builder raises and JAX's accepts."""
    cfg = load_yaml("heal_tpu/configs/opv2v_m1_pyramid.yaml")
    assert cfg["model"]["args"]["m1"]["encoder_args"]["presorted"] is True
    cfg["preprocess"]["args"]["presort"] = False
    cfg["fusion"]["args"] = dict(cfg["fusion"]["args"] or {},
                                 num_scenes_test=1)
    with pytest.raises(ValueError, match="presort"):
        build_dataset(cfg, train=False)
    assert len(jax_build_dataset(cfg, train=False)) == 1
