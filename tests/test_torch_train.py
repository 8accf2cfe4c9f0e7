"""Training of the m1 Pyramid-collab slice, port vs JAX, on the CPU.

tests/configs/entry_tiny.yaml: a JAX ``Trainer`` state is bridged into the
port ``Trainer`` and both take steps on the same training batch (two
samples, three agent slots with one padded, ``supervise_single``).

Stated tolerances, with what sets them:
  * losses and aux terms 3e-5 relative, running statistics 1e-5: f32
    sums in another order, through train-mode batch norms;
  * gradients, max|d| / (1 + max|ref|) <= 3e-2 (measured 1.7e-2 on
    pfn_kernel, 5e-3 elsewhere). The bound is JAX's f32: XLA's CPU
    reduction over the N*H*W axes of a BN input sums sequentially in f32
    (on this batch one channel mean is 4.8e-6 off an f64 reference where
    torch's cascade sum is 1.3e-8 off), and the train-mode BN backward
    amplifies that ~1000x. The witness is JAX's own step in f64
    (test_port_gradients_hold_to_the_f64_step): from the port's seeded
    init, JAX's f32 gradients are 4.7e-3 off it, the port's f32 ones
    7.4e-6, held there to 1e-4; the port's f64 step agrees with JAX's to
    7.1e-7. The train-mode modules one by one hold 1e-5 against JAX
    (test_torch_train_layers.py);
  * the 5-step loss trajectory 2e-3 relative (measured 6.8e-4): the
    gradient differences above through five Adam updates, whose first
    step is lr*sign(g);
  * the bf16 policy's step: loss terms 2e-2 relative (measured 9e-3),
    running statistics 2e-3 (measured 5.6e-4): both frameworks round
    ~40 layers' activations to bf16 (2^-8), in different places.
    Gradients are not compared there: bf16 bias sums differ by O(1).
"""
import copy
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml
from heal_tpu.data import build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_jax_model
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.parallel.schedulers import build_optimizer as jax_optimizer
from heal_tpu.utils import box_np, eval_np
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.layers import init_weights
from heal_tpu_torch import trace
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.postprocess.decode import post_process_single, strip_padding
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.tools.inference import run_inference
from heal_tpu_torch.utils.bridge import load_flax, to_flax

torch.set_num_threads(1)
TINY = "tests/configs/entry_tiny.yaml"
STEPS_PER_EPOCH = 8


def _launches(name: str) -> int:
    """The launches the tracer has counted under ``name``."""
    return trace.counters().get(name, 0)


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / (1.0 + np.abs(b).max()))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def tiny():
    cfg = load_yaml(TINY)
    batch = next(build_dataset(cfg, train=True).batches(
        2, shuffle=False, process_split=False))
    jb = jax.tree.map(jnp.asarray, batch)
    jt = JaxTrainer(
        model=build_jax_model(cfg["model"]),
        criterion=build_jax_loss(cfg["loss"]),
        tx=jax_optimizer(cfg["optimizer"], cfg["lr_scheduler"],
                         STEPS_PER_EPOCH),
        supervise_single=True).compile()
    state = jt.init_state(jax.random.PRNGKey(0), jb)
    return cfg, batch, jb, jt, jax.device_get(state)


def _port(cfg, state, dtype=torch.float32):
    model = build_model(cfg["model"])
    load_flax(model, state.params, state.batch_stats)
    model = model.to(dtype)
    opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                    cfg["lr_scheduler"], STEPS_PER_EPOCH)
    return Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                   supervise_single=True)


def _grads(trainer):
    return to_flax({k: p.grad for k, p in trainer.model.named_parameters()})[0]


def test_train_step_matches_jax(tiny):
    cfg, batch, jb, jt, state = tiny
    (loss, (aux, stats)), grads = jax.device_get(
        jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
            state.params, state.batch_stats, jb))
    aux = dict(aux, total_loss=loss)

    port = _port(cfg, state)
    before = _launches("kernel1.launches")
    got = port.train_step(to_device(batch, "cpu"))
    assert _launches("kernel1.launches") == before
    assert sorted(got) == sorted(aux)
    for k in aux:
        np.testing.assert_allclose(got[k].item(), aux[k], rtol=3e-5,
                                   err_msg=k)
    want_stats = _leaves(stats)
    got_stats = _leaves(to_flax(port.model.state_dict())[1])
    assert got_stats.keys() == want_stats.keys()
    for k, v in want_stats.items():
        np.testing.assert_allclose(got_stats[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    want_g, got_g = _leaves(grads), _leaves(_grads(port))
    assert got_g.keys() == want_g.keys() and len(got_g) > 50
    errs = {k: _rel(got_g[k], want_g[k]) for k in want_g}
    assert max(errs.values()) <= 3e-2, sorted(errs.items(),
                                              key=lambda kv: kv[1])[-3:]


def test_bn_momentum_running_stats_match_jax(tiny):
    """``model.args.bn_momentum`` rides the norm kind in both packages'
    build_model ("batch@0.99"): the running statistics after one
    train-mode forward agree with JAX's at the f32 step's 1e-5."""
    cfg, batch, jb, jt, state = tiny
    mcfg = dict(cfg["model"], args=dict(cfg["model"]["args"],
                                        bn_momentum=0.99))
    jt99 = dataclasses.replace(jt, model=build_jax_model(mcfg))
    _, (_, stats) = jax.device_get(jax.jit(jt99._loss_fn)(
        state.params, state.batch_stats, jb))
    model = load_flax(build_model(mcfg), state.params, state.batch_stats)
    momenta = {m.momentum for m in model.modules() if hasattr(m, "momentum")}
    assert momenta == {0.99}
    port = Trainer(model, build_loss(cfg["loss"]),
                   torch.optim.SGD(model.parameters(), lr=0.0),
                   lambda step: 0.0, supervise_single=True)
    with torch.no_grad():
        port.loss(to_device(batch, "cpu"))
    want = _leaves(stats)
    got = _leaves(to_flax(port.model.state_dict())[1])
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _jax_f64_step(jt, params, stats, batch):
    """JAX's loss and gradients with every float in f64. The model casts
    its batch-norm inputs and loss terms to ``jnp.float32`` by name, so it
    is traced with that name bound to float64 (and x64 on): the same
    program with no f32 rounding anywhere."""
    f64 = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            (loss, (aux, new_stats)), grads = jax.device_get(
                jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
                    f64(params), f64(stats), f64(batch)))
        finally:
            jnp.float32 = f32
    assert np.asarray(loss).dtype == np.float64
    return dict(aux, total_loss=loss), new_stats, grads


def test_port_gradients_hold_to_the_f64_step(tiny):
    """The whole-model gradient against JAX at 1e-4, with JAX's own f64
    step as the witness. From the port's seeded init (key 0's JAX init is
    ill conditioned, see the module docstring), bridged into both:
      * the port's f64 step against JAX's: loss terms 1e-5 relative
        (measured 2.1e-7), every gradient leaf 1e-5 (measured 7.1e-7).
        Not closer: the port keeps the PFN's moments and the shift's blend
        in f32 by design, and the bridge rounds the leaves to f32;
      * the port's f32 gradients within 1e-4 of JAX's f64 ones (measured
        7.4e-6) and of the port's own f64 ones."""
    cfg, batch, _, jt, _ = tiny
    model = init_weights(build_model(cfg["model"]),
                         torch.Generator().manual_seed(0))
    params, stats = to_flax(model.state_dict())
    state = SimpleNamespace(params=params, batch_stats=stats)
    b32 = to_device(batch, "cpu")
    b64 = jax.tree.map(
        lambda t: t.double() if t.is_floating_point() else t, b32)
    port32, port64 = _port(cfg, state), _port(cfg, state, torch.float64)
    port32.train_step(b32)
    aux64 = port64.train_step(b64)
    want_aux, _, want = _jax_f64_step(jt, params, stats, batch)
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux64[k].item(), v, rtol=1e-5, err_msg=k)
    jax64 = _leaves(want)
    for name, port in (("port f64", port64), ("port f32", port32)):
        got = _leaves(_grads(port))
        assert got.keys() == jax64.keys()
        errs = {k: _rel(v, jax64[k]) for k, v in got.items()}
        bound = 1e-5 if name == "port f64" else 1e-4
        assert max(errs.values()) <= bound, (
            name, max(errs.items(), key=lambda kv: kv[1]))
    g64 = _leaves(_grads(port64))
    errs = {k: _rel(v, g64[k]) for k, v in _leaves(_grads(port32)).items()}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda kv: kv[1])


def test_bf16_policy_step_matches_jax(tiny):
    """f32 master weights, bf16 forward and backward, f32 gradients and
    running statistics, against JAX's ``Trainer(bf16=True)``."""
    cfg, batch, jb, jt, state = tiny
    jt16 = dataclasses.replace(jt, bf16=True)
    (loss, (aux, stats)), _ = jax.device_get(
        jax.jit(jax.value_and_grad(jt16._loss_fn, has_aux=True))(
            state.params, state.batch_stats, jb))
    aux = dict(aux, total_loss=loss)
    port = _port(cfg, state)
    port.bf16 = True
    got = port.train_step(to_device(batch, "cpu"))
    for k in aux:
        np.testing.assert_allclose(got[k].item(), aux[k], rtol=2e-2,
                                   err_msg=k)
    want_stats = _leaves(stats)
    got_stats = _leaves(to_flax(port.model.state_dict())[1])
    for k, v in want_stats.items():
        assert _rel(got_stats[k], v) <= 2e-3, k
    assert {p.dtype for p in port.model.parameters()} == {torch.float32}
    assert {p.grad.dtype for p in port.model.parameters()} == {torch.float32}
    assert {b.dtype for b in port.model.buffers()} == {torch.float32}


def test_five_step_trajectory_matches_jax(tiny):
    cfg, batch, jb, jt, state = tiny
    port = _port(cfg, state)
    tb = to_device(batch, "cpu")
    jstate = jax.tree.map(jnp.asarray, state)
    want, got = [], []
    for _ in range(5):
        jstate, aux = jt.train_step(jstate, jb)
        want.append(float(aux["total_loss"]))
        got.append(port.train_step(tb)["total_loss"].item())
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert all(b < a for a, b in zip(got, got[1:]))
    assert all(b < a for a, b in zip(want, want[1:]))


def _eval_ap(model, cfg, anchors, batch) -> float:
    """Eval-mode AP@0.3 of one batch, as tests/test_overfit_ap.py takes it."""
    model.eval()
    with torch.no_grad():
        out = model(to_device(batch, "cpu"))
    stat = eval_np.new_result_stat((0.3,))
    for b in range(batch["gt_mask"].shape[0]):
        det = strip_padding(post_process_single(
            out["cls_preds"][b], out["reg_preds"][b], out["dir_preds"][b],
            anchors, torch.eye(4),
            torch.tensor(cfg["postprocess"]["gt_range"], dtype=torch.float32),
            order="hwl", score_threshold=0.2, nms_threshold=0.15))
        gtc = box_np.boxes_to_corners_3d(
            batch["gt_boxes"][b][batch["gt_mask"][b] > 0], "hwl")
        eval_np.calculate_tp_fp(det["corners"], det["scores"], gtc, stat, 0.3)
    return eval_np.calculate_ap(stat, 0.3)[0]


def test_overfit_then_eval_mode_ap(tiny):
    """Torch twin of tests/test_overfit_ap.py on entry_tiny (the JAX test's
    tiny_intermediate.yaml model is not ported): 150 Adam(2e-3) steps on
    one batch, then the EVAL-mode AP@0.3, which guards the running
    statistics. Bound 0.4: JAX's own trainer reaches AP@0.3 = 0.5 on
    this batch (measured at 50, 100 and 150 steps), minus 0.1."""
    cfg, batch, _, _, state = tiny
    model = build_model(cfg["model"])
    load_flax(model, state.params, state.batch_stats)
    trainer = Trainer(model, build_loss(cfg["loss"]),
                      torch.optim.Adam(model.parameters(), lr=2e-3),
                      lambda step: 2e-3)
    tb = to_device(batch, "cpu")
    for _ in range(150):
        aux = trainer.train_step(tb)
    assert aux["total_loss"].item() < 2.0
    anchors = torch.from_numpy(
        np.asarray(build_dataset(cfg, train=True).anchors, np.float32))
    ap = _eval_ap(model, cfg, anchors, batch)
    assert ap > 0.4, f"eval-mode AP collapsed: {ap}"


def test_train_tool_one_epoch_checkpoint_inference_resume(tmp_path):
    run = str(tmp_path / "run")
    train_tool.main(["-y", TINY, "--model_dir", run, "--epochs", "1",
                     "--device", "cpu"])
    assert os.path.exists(os.path.join(run, "config.yaml"))
    assert os.path.exists(os.path.join(run, "eval_intermediate.yaml"))
    # the bestval checkpoint is what resume, inference and merge take
    epoch, path = ckpt_lib.find_checkpoint(run)
    assert (epoch, os.path.basename(path)) == (1, "net_epoch_bestval_at1.pth")
    assert os.path.exists(os.path.join(run, "net_epoch1.pth"))
    sd = torch.load(path, weights_only=True)
    assert sd.keys() == build_model(load_yaml(TINY)["model"]).state_dict(
        ).keys()
    result = run_inference(run, device="cpu", max_batches=1)
    assert result["frames"] == 1 and 0.0 <= result["ap_30"] <= 1.0

    train_tool.main(["--model_dir", run, "--epochs", "2", "--device", "cpu",
                     "--no_final_inference"])
    epoch, path2 = ckpt_lib.find_checkpoint(run)
    assert (epoch, os.path.basename(path2)) == (2,
                                                "net_epoch_bestval_at2.pth")
    assert os.path.exists(os.path.join(run, "net_epoch2.pth"))
    sd2 = torch.load(path2, weights_only=True)
    assert any(not torch.equal(sd[k], sd2[k]) for k in sd)

    # --init_from: a loose load into a fresh run
    fresh = str(tmp_path / "fresh")
    train_tool.main(["-y", TINY, "--model_dir", fresh, "--epochs", "1",
                     "--device", "cpu", "--init_from", path2,
                     "--no_final_inference"])
    assert ckpt_lib.find_checkpoint(fresh)[0] == 1
    model = copy.deepcopy(build_model(load_yaml(TINY)["model"]))
    assert ckpt_lib.loose_load(model, path2) == []
