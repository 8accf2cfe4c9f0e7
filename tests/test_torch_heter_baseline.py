"""The heterogeneous baselines, port vs JAX, on the CPU.

``heter_model_baseline`` and ``heter_model_baseline_ms`` (heal_tpu_torch/
models/heter_baseline.py) on tests/configs/entry_m1m2m3m4_final.yaml (an
agent of each type m1..m4 at 16 channels on a 32 x 32 BEV) switched to
each fusion method, as tests/test_heter_baseline.py does for m1m2: every
method on the alliance cut in code to m1 + m2 + m4 (the SECOND branch
takes JAX ~10 s to compile), V2X-ViT (which types the agents) and the MS
model on CoAlign's wiring (``att`` at two levels) on the uncut one too.
Each test feeds one batch of heal_tpu's host side to both packages and
bridges one set of flax variables (JAX's init for the uncut alliance,
the port's for the cut one; running statistics randomised).
Stated tolerances, as max |d| / (1 + max |ref|):

  * eval heads and the ``_single`` heads: 1e-4;
  * a train step with no random streams on either side (JAX's step
    without rngs: Where2comm's threshold fixed): loss terms 1e-5
    relative, and every f32 gradient leaf within 1e-4 of JAX's own step
    in f64 (the witness of tests/test_torch_train.py; whole-model f32
    gradients through train-mode batch norm agree with JAX's f32 ones
    only to ~2e-2).

Also held: the train-mode threshold sampling and the dropout masks come
from the trainer's per-step generators, the same for the same (seed,
step); ``tools/train.py`` for one epoch, then ``tools/inference.py``
reporting ``comm_rate``, on a tiny where2comm config.
"""
import copy

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
from heal_tpu_torch.config import keep_modalities, save_yaml
from heal_tpu_torch.models import build_loss, build_model
from heal_tpu_torch.models.fuse.where2comm_comm import CommMask
from heal_tpu_torch.models.layers import Dropout, init_weights, rng_streams
from heal_tpu_torch.parallel import Trainer, build_optimizer, to_device
from heal_tpu_torch.parallel.trainer import step_streams
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.tools.inference import build_weights, run_inference
from heal_tpu_torch.utils.bridge import load_flax, to_flax
from test_torch_train import _jax_f64_step, _leaves, _rel

torch.set_num_threads(1)
FINAL = "tests/configs/entry_m1m2m3m4_final.yaml"
HEADS = ("cls_preds", "reg_preds", "dir_preds")
TOL = 1e-4
STEPS_PER_EPOCH = 4

# fusion method -> its config block at the alliance's 16 channels
METHODS = {
    "max": {"in_channels": 16},
    "att": {},
    "disconet": {"in_channels": 16},
    "v2vnet": {"in_channels": 16, "num_iteration": 2, "agg_operator": "avg",
               "gru_flag": True},
    "where2comm": {"in_channels": 16, "threshold": 0.01},
    "who2com": {"in_channels": 16},
    "cobevt": {"input_dim": 16, "window_size": 8, "depth": 1},
    "v2xvit": {"depth": 1, "num_types": 5},
    "when2com": {"policy_width": 16},
    "transformer": {"n_head": 4},
}


def baseline_cfg(method: str, ms: bool = False, uncut: bool = False) -> dict:
    """The alliance config (cut to m1 + m2 + m4 unless ``uncut``) with
    the baseline model of ``method``: the shrink header per agent (or
    after the MS decode), supervise_single, the single-scale
    point_pillar_loss."""
    cfg = jax_load_yaml(FINAL)
    if not uncut:
        keep_modalities(cfg, ("m1", "m2", "m4"))
    a = cfg["model"]["args"]
    a.pop("fusion_backbone")
    a["fusion_method"] = method
    a[method] = copy.deepcopy(METHODS[method])
    a["supervise_single"] = True
    width = 16
    if ms:
        a["fusion_backbone"] = {
            "layer_nums": [1, 1], "layer_strides": [1, 2],
            "num_filters": [16, 32], "upsample_strides": [1, 2],
            "num_upsample_filter": [16, 16]}
        width = 32
    a["in_head"] = width
    a["shrink_header"] = {"kernal_size": [3], "stride": [1], "padding": [1],
                          "dim": [width], "input_dim": width}
    cfg["model"]["core_method"] = ("heter_model_baseline_ms" if ms
                                   else "heter_model_baseline")
    loss = cfg["loss"]
    loss["core_method"] = "point_pillar_loss"
    loss["args"].pop("pyramid")
    return cfg


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
    return next(build_dataset(cfg, train=train).batches(
        size, shuffle=False, process_split=False))


def _variables(cfg, batch, seed, jax_init=True):
    """(JAX model, variables): JAX's init, or (``jax_init`` False, half
    the compile time) the port's seeded init in flax layout, whose tree
    JAX's apply must take; running statistics randomised."""
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
    max_cav = cfg["train_params"]["max_cav"]
    return load_flax(build_model(cfg["model"], max_cav=max_cav),
                     variables["params"], variables["batch_stats"])


@pytest.mark.parametrize("method,ms,uncut", [
    *[(m, False, False) for m in METHODS], ("att", True, False),
    ("v2xvit", False, True), ("att", True, True)])
def test_baseline_heads_match_jax(method, ms, uncut):
    cfg = baseline_cfg(method, ms, uncut)
    batch = _batch(cfg)
    types = {"m1", "m2", "m4"} | ({"m3"} if uncut else set())
    assert types == {m for m in cfg["model"]["args"] if m[0] == "m"
                     and m[1:].isdigit()}
    assert all(batch[f"slots_{m}"][0, 0] < 4 for m in types)
    # the uncut models from JAX's init (its tree loads strictly); the
    # others from the port's
    jm, v = _variables(cfg, batch, seed=list(METHODS).index(method),
                       jax_init=uncut)
    keys = [k + s for k in HEADS for s in ("", "_single")]
    want = jax.device_get(jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items()
        if k in keys + ["comm_rate"]})(v, jax.tree.map(jnp.asarray, batch)))
    model = _port(cfg, v)
    if ms:  # level 0 fuses the raw features: no stage 0, in either
        assert "stages_0" not in v["params"]["fusion_backbone"]
        assert not any(k.startswith("fusion_backbone.stages_0")
                       for k in model.state_dict())
    with torch.no_grad():
        got = model(_tensors({k: batch[k] for k in batch if k in (
            "agent_mask", "pairwise_affine", "agent_modality")
            or k.startswith(("inputs_", "slots_"))}))
    assert sorted(k for k in got if k in want) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape, k
        assert _rel(g, w) <= TOL, (k, _rel(g, w))
    if method == "where2comm":
        assert 0 < float(got["comm_rate"]) <= 1


@pytest.fixture(scope="module")
def w2c_step():
    """The where2comm baseline, its variables and a train batch of 2."""
    cfg = baseline_cfg("where2comm")
    batch = _batch(cfg, train=True, size=2)
    jm, v = _variables(cfg, batch, seed=5, jax_init=False)
    return cfg, jm, v, batch


def test_train_step_matches_jax_without_streams(w2c_step):
    """One step, no rngs in JAX and no streams in the port: the loss terms
    at 1e-5 and every gradient leaf within 1e-4 of JAX's f64 step."""
    cfg, jm, v, batch = w2c_step
    jt = JaxTrainer(model=jm, criterion=build_jax_loss(cfg["loss"]), tx=None,
                    supervise_single=True)
    want_aux, _, grads = _jax_f64_step(jt, v["params"], v["batch_stats"],
                                       batch)
    model = _port(cfg, v)
    opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                    cfg["lr_scheduler"], STEPS_PER_EPOCH)
    port = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                   supervise_single=True, rng_seed=None)
    aux = port.train_step(to_device(batch, "cpu"))
    assert sorted(aux) == sorted(want_aux)
    for k, w in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), w, rtol=1e-5, err_msg=k)
    got = _leaves(to_flax({k: p.grad for k, p in model.named_parameters()})[0])
    want = _leaves(grads)
    assert got.keys() == want.keys()
    errs = {k: _rel(g, want[k]) for k, g in got.items()}
    assert max(errs.values()) <= 1e-4, max(errs.items(), key=lambda x: x[1])
    fusion = [k for k in got if k.startswith("['fusion']")]
    assert fusion and all(np.abs(got[k]).max() > 0 for k in fusion)


def test_comm_threshold_and_dropout_draw_from_the_step_streams():
    conf = torch.rand((2, 3, 8, 8, 1), generator=torch.Generator()
                      .manual_seed(0)) * 0.05
    mask = CommMask(threshold=0.01).train()
    drop = Dropout(0.5).train()
    x = torch.ones(64)

    def draw(step):
        with rng_streams(mask, **step_streams(0, step, "cpu")), \
                rng_streams(drop, **step_streams(0, step, "cpu")):
            return mask(conf)[0], drop(x)

    m5, d5 = draw(5)
    again = draw(5)
    assert torch.equal(m5, again[0]) and torch.equal(d5, again[1])
    others = [draw(s) for s in (6, 7, 8)]
    assert any(not torch.equal(m5, m) for m, _ in others)
    assert all(not torch.equal(d5, d) for _, d in others)
    # the sampled threshold spans thr * 10^[-1, 1]: some step sends more
    # and some less than the fixed threshold
    rates = [m.mean() for m, _ in (draw(s) for s in range(12))]
    fixed = mask.eval()(conf)[0].mean()
    assert min(rates) < fixed < max(rates)
    # without a stream: the fixed threshold in train mode, and dropout
    # refuses to run, as flax does
    assert torch.equal(mask.train()(conf)[0], mask.eval()(conf)[0])
    with pytest.raises(RuntimeError, match="dropout"):
        drop(x)


def test_trainer_streams_are_reproducible_by_step():
    """A CoBEVT baseline with dropout: two trainers from the same weights
    take the same first step, and a trainer resumed at update 1 from the
    weights after update 0 draws what the unbroken run drew at update 1.
    Without streams the dropout refuses to run."""
    cfg = baseline_cfg("cobevt")
    cfg["model"]["args"]["cobevt"]["drop_out"] = 0.3
    batch = to_device(_batch(cfg, train=True, size=1), "cpu")
    base = build_weights(cfg, seed=0)

    def trainer(model, step=0, **kw):
        opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                        cfg["lr_scheduler"], STEPS_PER_EPOCH)
        return Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                       supervise_single=True, step=step, **kw)

    a, b = trainer(copy.deepcopy(base)), trainer(copy.deepcopy(base))
    assert torch.equal(a.train_step(batch)["total_loss"],
                       b.train_step(batch)["total_loss"])
    after = copy.deepcopy(a.model)
    resumed, later = trainer(after, step=1), trainer(copy.deepcopy(after),
                                                     step=2)
    with resumed.streams():
        got = resumed.loss(batch)[0]
    with later.streams():
        other = later.loss(batch)[0]
    want = a.train_step(batch)["total_loss"]
    assert torch.equal(got, want)
    assert not torch.equal(other, want)
    with pytest.raises(RuntimeError, match="dropout"):
        trainer(copy.deepcopy(base), rng_seed=None).train_step(batch)


def test_train_cli_then_inference_reports_comm_rate(tmp_path):
    cfg = baseline_cfg("where2comm")
    cfg["fusion"]["args"]["num_scenes_train"] = 2
    cfg["fusion"]["args"]["num_scenes_test"] = 2
    cfg["train_params"]["batch_size"] = 1
    yaml = str(tmp_path / "w2c.yaml")
    save_yaml(cfg, yaml)
    run = str(tmp_path / "run")
    train_tool.main(["-y", yaml, "--model_dir", run, "--epochs", "1",
                     "--no_final_inference", "--device", "cpu"])
    with open(f"{run}/train_log.jsonl") as f:
        assert "comm_rate" in f.read()
    result = run_inference(run, device="cpu")
    assert result["frames"] == 2
    assert 0 < result["comm_rate"] <= 1
