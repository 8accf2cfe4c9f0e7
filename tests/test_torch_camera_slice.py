"""The camera agent type (m2, Lift-Splat-Shoot) through the HEAL models,
port vs JAX, on the CPU.

Each test feeds one batch of heal_tpu's host side to both packages and
bridges one set of weights. The synthetic rig's images are seeded from
``id(scene)`` in both packages (ROADMAP §3), so they differ between
processes: ``_seeded_images`` replaces them with images drawn from a
fixed seed, and every test here sees the same numbers in every run.

  * ``HeterPyramidCollab`` m1 + m2 (tests/configs/tiny_heter_m1m2.yaml),
    eval with the camera's crop masks, the m1 branch through JAX's Pallas
    path in interpret mode (``HEAL_TPU_FORCE_PALLAS=1``): heads and depth
    logits 1e-4 relative and absolute, as tests/test_torch_slice.py;
  * ``HeterPyramidSingle`` m2 (heal_tpu/configs/demo_heal_full/
    stage2_m2.yaml cut narrow: ``_narrow``): eval heads 1e-5 of
    1 + max |JAX|; one stage-2 step against JAX's ``Trainer`` with the
    base frozen, loss terms (the depth loss among them) 1e-5 relative;
    ``branch_m2``'s gradients against JAX's own step in f64, as
    tests/test_torch_train.py's witness: the port's f64 step at 1e-5, its
    f32 step at 1e-4 (with oneDNN off; see the test);
  * a heal_tpu m2 ``.ckpt`` loads strictly into the port;
  * where the camera grid does not cover the lidar range (the published
    stage-2 config's shape), the port pads the camera BEV as the
    reference and the collab model do, and JAX's single model fails.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml
from heal_tpu.config.loader import PARSER_REGISTRY
from heal_tpu.data import build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.parallel.freezing import freeze_wrap
from heal_tpu.parallel.schedulers import build_optimizer as jax_optimizer
from heal_tpu.parallel.trainer import TrainState
from heal_tpu.tools import checkpoint as jax_ckpt
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.parallel.freezing import freeze, trainable_parameters
from heal_tpu_torch.tools.inference import build_weights
from heal_tpu_torch.utils.bridge import from_flax, load_flax, to_flax
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
M1M2 = "tests/configs/tiny_heter_m1m2.yaml"
STAGE2_M2 = "heal_tpu/configs/demo_heal_full/stage2_m2.yaml"
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


def _seeded_images(batch, seed=0):
    """``batch`` with its camera agents' images drawn from ``seed`` (the
    rig's own draw, N(0.45, 0.2)); padded slots stay zero."""
    imgs = batch["inputs_m2"]["imgs"]
    real = imgs.reshape(imgs.shape[:2] + (-1,)).any(-1)
    new = np.zeros_like(imgs)
    new[real] = np.random.default_rng(seed).normal(
        0.45, 0.2, new[real].shape).astype(imgs.dtype)
    return dict(batch, inputs_m2=dict(batch["inputs_m2"], imgs=new))


def _narrow(x_half=25.6, y_half=25.6):
    """demo_heal_full/stage2_m2.yaml at CPU size: a 16x16 camera grid
    (3.2 m over +-25.6 m) of 4 cameras at 64x96 (4x6 at /16) with 8 depth
    bins and 16 features; the lidar range +-``x_half`` x +-``y_half`` m
    in 1.6 m pillars (so the pyramid's input grid is the camera's at
    +-25.6 m); a one-block 16/24/32 pyramid, batch 2. The coarse grid
    keeps the camera BEV dense, as the published 128x128 one is."""
    cfg = load_yaml(STAGE2_M2)
    rng = [-x_half, -y_half, -3, x_half, y_half, 1]
    cfg["cav_lidar_range"] = rng
    cfg["preprocess"]["cav_lidar_range"] = rng
    cfg["preprocess"]["args"]["max_points"] = 4000
    cfg["postprocess"]["gt_range"] = rng
    cfg["postprocess"]["anchor_args"]["cav_lidar_range"] = rng
    cfg["fusion"]["args"].update(num_scenes_train=4, num_scenes_test=2)
    cfg["preprocess"]["args"]["voxel_size"] = [1.6, 1.6, 4]
    grid = {"xbound": [-25.6, 25.6, 3.2], "ybound": [-25.6, 25.6, 3.2],
            "zbound": [-10, 10, 20.0], "ddiscr": [2, 50, 8], "mode": "LID"}
    setting = cfg["heter"]["modality_setting"]["m2"]
    setting["grid_conf"] = grid
    setting["data_aug_conf"]["final_dim"] = [64, 96]
    a = cfg["model"]["args"]
    a["lidar_range"] = rng
    enc = a["m2"]["encoder_args"]
    enc.update(grid_conf=grid, img_features=16)
    enc["data_aug_conf"]["final_dim"] = [64, 96]
    a["m2"]["camera_mask_args"]["grid_conf"] = grid
    a["m2"]["backbone_args"].update(layer_nums=[1], num_filters=[16])
    a["fusion_backbone"].update(layer_nums=[1, 1, 1],
                                num_filters=[16, 24, 32],
                                num_upsample_filter=[16, 16, 16])
    a["shrink_header"].update(dim=[32], input_dim=48)
    a["in_head"] = 32
    return PARSER_REGISTRY[cfg["yaml_parser"]](cfg)


# ------------------------------------------------------------ collab m1+m2
@pytest.fixture(scope="module")
def collab():
    cfg = load_yaml(M1M2)
    batch = _seeded_images(next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False)))
    jb = jax.tree.map(jnp.asarray, batch)
    jm = build_flax(cfg["model"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HEAL_TPU_FORCE_PALLAS", "1")
        v = jax.device_get(jax.jit(
            lambda b: jm.init(jax.random.PRNGKey(0), b, train=False))(jb))
        stats = _random_stats(v["batch_stats"], 0)
        want = jax.device_get(jax.jit(lambda vv, b: {
            k: x for k, x in jm.apply(vv, b, train=False).items()
            if k in HEADS or k.startswith("depth_items")})(
            {"params": v["params"], "batch_stats": stats}, jb))
    tm = load_flax(build_model(cfg["model"]), v["params"], stats)
    with torch.no_grad():
        got = tm(_tensors({k: batch[k] for k in (
            "inputs_m1", "slots_m1", "inputs_m2", "slots_m2", "agent_mask",
            "pairwise_affine")}))
    return cfg, batch, tm, want, got


def test_collab_m1m2_heads_match_jax(collab):
    cfg, batch, _, want, got = collab
    # both branches carry an agent: m1 the ego, m2 the other
    assert batch["slots_m1"][0, 0] == 0 and batch["slots_m2"][0, 0] == 1
    assert batch["agent_mask"].sum() == 2
    assert sorted(k for k in got if k.startswith("depth")) == \
        ["depth_items_m2"]
    for k in (*HEADS, "depth_items_m2"):
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)


def test_collab_crop_masks_reach_the_scores(collab):
    """The eval-time field-of-view masks: the camera agent's slot gets the
    mask (a 4-pixel guard band at ratio 1), the others ones; without them
    the heads move."""
    cfg, batch, tm, _, got = collab
    inputs = _tensors({k: batch[k] for k in (
        "inputs_m1", "slots_m1", "inputs_m2", "slots_m2", "agent_mask",
        "pairwise_affine")})
    seen = []
    fuse = tm.pyramid_backbone.forward_collab

    def spy(*a, crop_mask_list=None):
        seen.append(crop_mask_list)
        return fuse(*a)

    tm.pyramid_backbone.forward_collab = spy
    try:
        with torch.no_grad():
            bare = tm(inputs)
    finally:
        del tm.pyramid_backbone.forward_collab
    (masks,) = seen
    assert [tuple(m.shape) for m in masks] == [
        (1, 3, 64, 64, 1), (1, 3, 32, 32, 1), (1, 3, 16, 16, 1)]
    level0 = masks[0][0, :, :, :, 0]
    assert torch.equal(level0[0], torch.ones(64, 64))  # the m1 ego
    assert level0[1].sum() == 60 * 60  # the camera agent, guard band off
    assert float((bare["cls_preds"] - got["cls_preds"]).abs().max()) > 0


# ------------------------------------------------------------ stage 2, m2
@pytest.fixture(scope="module")
def single():
    cfg = _narrow()
    model = init_weights(build_model(cfg["model"]),
                         torch.Generator().manual_seed(0))
    params, stats = to_flax(model.state_dict())
    stats = _random_stats(stats, 1)
    np.random.seed(0)  # the train split's point subsampling
    batch = _seeded_images(next(build_dataset(cfg, train=True).batches(
        2, shuffle=False, process_split=False)))
    return cfg, params, stats, batch


def test_single_m2_heads_match_jax(single):
    cfg, params, stats, batch = single
    jm = build_flax(cfg["model"])
    jb = jax.tree.map(jnp.asarray, batch)
    want = jax.device_get(jax.jit(lambda b: {
        k: x for k, x in jm.apply({"params": params, "batch_stats": stats},
                                  b, train=False).items()
        if k in HEADS or k.startswith("depth")})(jb))
    tm = load_flax(build_model(cfg["model"]), params, stats)
    with torch.no_grad():
        got = tm(_tensors({k: batch[k] for k in ("inputs_m2", "agent_mask")}))
    assert sorted(want) == sorted(k for k in got if k in want)
    assert got["cls_preds"].shape[:3] == (2, 16, 16)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert _rel(got[k].numpy(), w) <= 1e-5, (k, _rel(got[k].numpy(), w))


def test_single_m2_step_matches_jax(single):
    """One stage-2 step with the base frozen: loss terms (the depth loss
    among them) against JAX's ``Trainer``, the frozen modules bit-equal
    in both, ``branch_m2`` moved in both."""
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
    assert "depth_loss" in aux and sorted(got) == sorted(aux)
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
    moved = [k for k in start if k.startswith("branch_m2.")
             and not torch.equal(after[k], start[k])]
    assert len(moved) > 40
    assert all(not torch.equal(jafter[k], start[k]) for k in moved)


def test_single_m2_gradients_hold_to_jax_f64_step(single):
    """``branch_m2``'s gradients through the frozen base against JAX's own
    step in f64 (tests/test_torch_train.py's witness): the port's f64 step
    at 1e-5 (loss terms and every leaf; measured ~5e-8), its f32 step at
    1e-4 (measured ~5e-6; JAX's own f32 step 5e-5). The f32 step runs
    with oneDNN off: on these shapes oneDNN's f32 convolution backward on
    the CPU lands up to 4e-2 off the witness in the camera CNN's kernels
    (PyTorch's own CPU convolutions ~5e-6; the card runs cuDNN). The f32
    bound holds for this batch (``_seeded_images`` seed 0): on other image
    draws the step is ill conditioned (eleven train-mode batch norms, the
    last over 2x3 maps at /32), and both frameworks' f32 gradients land
    2e-2 to 7e-2 off the witness."""
    cfg, params, stats, batch = single
    jm = build_flax(cfg["model"])
    jt = JaxTrainer(model=jm, criterion=build_jax_loss(cfg["loss"]),
                    tx=None, fix_modules=tuple(jm.fix_modules))
    want_aux, _, grads = _jax_f64_step(jt, params, stats, batch)
    want = {k: v for k, v in _leaves(grads).items()
            if k.startswith("['branch_m2']")}
    (_, _), g32 = jax.device_get(jax.jit(jax.value_and_grad(
        jt._loss_fn, has_aux=True))(params, stats,
                                    jax.tree.map(jnp.asarray, batch)))
    jax32 = max(_rel(v, want[k]) for k, v in _leaves(g32).items()
                if k in want)
    errs = {}
    for dt in (torch.float64, torch.float32):
        model = load_flax(build_model(cfg["model"]), params, stats).to(dt)
        opt, schedule = build_optimizer(
            [p for n, p in model.named_parameters()
             if n.startswith("branch_")],
            cfg["optimizer"], cfg["lr_scheduler"], STEPS_PER_EPOCH)
        port = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                       fix_modules=tuple(jm.fix_modules))
        tb = jax.tree.map(lambda t: t.to(dt) if t.is_floating_point() else t,
                          to_device(batch, "cpu"))
        mkldnn = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
        try:
            aux = port.train_step(tb)
        finally:
            torch.backends.mkldnn.enabled = mkldnn
        got = _leaves(to_flax({k: p.grad for k, p in model.named_parameters()
                               if p.grad is not None})[0])
        assert got.keys() == want.keys() and len(got) > 40
        errs[dt] = max(_rel(v, want[k]) for k, v in got.items())
        if dt == torch.float64:
            for k in ("total_loss", "depth_loss"):
                np.testing.assert_allclose(aux[k].item(), want_aux[k],
                                           rtol=1e-5, err_msg=k)
        assert max(float(np.abs(v).max()) for v in got.values()) > 0
    assert errs[torch.float64] <= 1e-5, errs
    assert errs[torch.float32] <= 1e-4, (errs, jax32)


def test_heal_tpu_m2_checkpoint_loads_strictly(single, tmp_path):
    """Every flax path of the m2 branch (``cam_encoder.ConvNormAct_*``,
    ``Up_0``, ``depth_head``, ``image_head``, the backbone and the
    convnext aligner) has its port entry."""
    cfg, _, _, batch = single
    jm = build_flax(cfg["model"])
    v = jax.device_get(jax.jit(lambda b: jm.init(
        jax.random.PRNGKey(3), b, train=False))(jax.tree.map(jnp.asarray,
                                                             batch)))
    path = jax_ckpt.save_checkpoint(str(tmp_path), dict(v), 1)
    model = build_weights(cfg, checkpoint=path)  # strict
    sd = model.state_dict()
    for key in ("branch_m2.encoder.cam_encoder.Up_0.ConvNormAct_1.kernel",
                "branch_m2.encoder.cam_encoder.depth_head.bias",
                "branch_m2.encoder.cam_encoder.image_head.kernel",
                "branch_m2.encoder.cam_encoder.ConvNormAct_8.Norm_0.var"):
        assert key in sd, key
    want = from_flax(v["params"], v["batch_stats"])
    for k, t in sd.items():
        assert torch.equal(t, want[k]), k


def test_single_camera_pads_where_heal_tpu_fails():
    """A lidar range wider than the camera grid (the published
    stage2/m2_alignto_m1.yaml: 128x128 camera cells against a 128x256
    label grid), here 16x16 against 16x32: the port pads the camera BEV
    to the lidar canvas and its loss runs; JAX's single model does not
    pad, and its loss fails on the shapes."""
    cfg = _narrow(x_half=51.2)
    batch = _seeded_images(next(build_dataset(cfg, train=True).batches(
        2, shuffle=False, process_split=False)))
    assert batch["pos_equal_one"].shape[1:3] == (16, 32)
    model = init_weights(build_model(cfg["model"]),
                         torch.Generator().manual_seed(0))
    port = Trainer(model, build_loss(cfg["loss"]),
                   torch.optim.SGD(model.parameters(), lr=0.0),
                   lambda step: 0.0)
    aux = port.train_step(to_device(batch, "cpu"))
    assert np.isfinite(aux["total_loss"].item())
    with torch.no_grad():
        out = model.eval()(_tensors({"inputs_m2": batch["inputs_m2"],
                                     "agent_mask": batch["agent_mask"]}))
    assert tuple(out["cls_preds"].shape[:3]) == (2, 16, 32)
    params, stats = to_flax(model.state_dict())
    jt = JaxTrainer(model=build_flax(cfg["model"]),
                    criterion=build_jax_loss(cfg["loss"]), tx=None)
    with pytest.raises((TypeError, ValueError)):
        jt._loss_fn(params, stats, jax.tree.map(jnp.asarray,
                                                copy.deepcopy(batch)))
