"""The port's (data, agent, model) device mesh on CPU gloo ranks.

heal_tpu_torch/parallel/sharding.py against heal_tpu/parallel/sharding.py:
the mesh factoring, JAX's batch and parameter rules; then one train step
of the tiny flagship (tests/configs/entry_tiny.yaml with ``max_cav`` =
``num_agents`` = 4, as tests/test_sharding.py sets them) across 2, 4 and
8 ranks, each rank a spawned process with one thread
(heal_tpu_torch/tools/dryrun_multichip.sharded_results), against:

  * the port's one process on the same global batch and weights: in f64
    the loss and every gradient within 1e-9 of max |g| (the sums are
    only reassociated; measured 1e-15), 1e-8 under a model axis: the
    PFN computes in f32 whatever the weights' dtype (models/encoders.py),
    and a column-parallel layer hands it each rank's partial input
    gradient, whose f32 rounding differs from the whole gradient's
    (measured 4.0e-9 on ``pfn_kernel``, 1e-15 elsewhere); in f32 JAX's
    own sharded-vs-single bounds
    (test_sharding.py TestShardedEquivalence): loss and gradients within
    4e-3 with ``norm: none``, gradients within 0.4 under batch norm,
    whose init-state conditioning amplifies the reassociation;
  * JAX's f64 step (the 4-rank f64 step, 1e-5 relative to 1 + max|g|
    per leaf, as test_torch_train.py holds the one-process step) and
    JAX's sharded f32 step on the 8 virtual CPU devices of
    tests/conftest.py (the port's 2x2x2 step, JAX's f32 bounds).

Then the CLI (``tools/train.main --devices 2x1x2 --device cpu``, its
checkpoint loaded strictly by one process), the batch-wide loss
normalisers and the dropout draw under a data axis of 2
(tests/torch_sharding_workers.py). Each world rendezvouses through a file
in its own temporary directory and bounds every collective at 60 s.
"""
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_jax_model
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.parallel import sharding as jshard
from heal_tpu.parallel.schedulers import build_optimizer as jax_optimizer
from heal_tpu_torch.config import load_yaml, reparse, save_yaml
from heal_tpu_torch.models import build_model
from heal_tpu_torch.parallel import launch, to_device
from heal_tpu_torch.parallel import sharding as shlib
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools import dryrun_multichip as dry
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.tools.train import build_trainer
from heal_tpu_torch.utils.bridge import to_flax

import torch_sharding_workers as workers

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60.0
VARIANTS = {  # name -> (norm, dtype)
    "bn_f32": (None, "float32"),
    "none_f32": ("none", "float32"),
    "bn_f64": (None, "float64"),
}
MESHES_2 = [(2, 1, 1), (1, 2, 1), (1, 1, 2)]
MESH_4 = (2, 2, 1)
MESH_8 = (2, 2, 2)
NO_MESH = shlib.Mesh(dict(data=2, agent=2, model=2),
                     dict(data=0, agent=0, model=0))


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / (1.0 + np.abs(b).max()))


def _leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------- rules


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_factor_mesh_is_jaxs(n):
    assert shlib.factor_mesh(n) == jshard.factor_mesh(n)
    assert int(np.prod(shlib.factor_mesh(n))) == n


@pytest.mark.parametrize("spec,dims", [
    ("8", (8, 1, 1)), ("2x2", (2, 2, 1)), ("2x1x2", (2, 1, 2)),
    ("1X2X2", (1, 2, 2)), (4, (4, 1, 1))])
def test_devices_flag_parses_as_jax_does(spec, dims):
    """heal_tpu/tools/train.py:104-110: N or DxAxM, missing axes 1."""
    assert shlib.parse_devices(spec) == dims
    args = train_tool.parse_args(["-y", "x.yaml", "--devices", str(spec)])
    assert shlib.parse_devices(args.devices) == dims


def _rule_batch():
    """The leaves of tests/test_sharding.py:36-66, and a 3-agent leaf."""
    return {
        "inputs_m1": {
            "points": np.zeros((2, 4, 8, 4), np.float32),
            "point_mask": np.zeros((2, 4, 8), bool),
        },
        "slots_m1": np.zeros((2, 4), np.int32),
        "slots_m2": np.zeros((2, 3), np.int32),
        "agent_mask": np.zeros((2, 4), bool),
        "agent_modality": np.zeros((2, 4), np.int32),
        "pairwise_affine": np.zeros((2, 4, 4, 2, 3), np.float32),
        "targets": np.zeros((2, 16, 16, 14), np.float32),
        "targets_single": np.zeros((2, 4, 16, 16, 14), np.float32),
        "dropped_agent_count": np.zeros((2,), np.int32),
    }


RULE_LEAVES = [jax.tree_util.keystr(p) for p, _ in
               jax.tree_util.tree_flatten_with_path(_rule_batch())[0]]


class _JaxMeshShape:
    """What JAX's ``_fit`` reads of a mesh: its axis sizes."""

    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("shape", [dict(data=2, agent=2, model=2),
                                   dict(data=2, agent=1, model=1),
                                   dict(data=1, agent=3, model=1)])
@pytest.mark.parametrize("leaf", RULE_LEAVES)
def test_batch_rule_is_jaxs(leaf, shape):
    """``batch_pspec`` then ``_fit``, leaf by leaf, equal to JAX's."""
    paths = dict((jax.tree_util.keystr(p), (p, x)) for p, x in
                 jax.tree_util.tree_flatten_with_path(_rule_batch())[0])
    path, x = paths[leaf]
    want = tuple(jshard._fit(jshard.batch_pspec(path, x), x.shape,
                             _JaxMeshShape(shape)))
    keys = tuple(p.key for p in path)
    got = shlib._fit(shlib.batch_pspec(keys, x), x.shape, shape)
    assert got == want, (leaf, got, want)


@pytest.mark.parametrize("axes", [("data", "agent"), ("data",)])
def test_shard_batch_slices_tile_the_global_batch(axes):
    """Every rank's slices of a (2, 2, 1) mesh put back together give
    the global batch; ``axes=("data",)`` keeps every agent."""
    rng = np.random.default_rng(0)
    batch = {k: (rng.normal(size=v.shape).astype(v.dtype)
                 if not isinstance(v, dict) else
                 {kk: rng.normal(size=vv.shape).astype(np.float32)
                  for kk, vv in v.items()})
             for k, v in _rule_batch().items()}
    shape = dict(data=2, agent=2, model=1)
    parts = {}
    for d in range(2):
        for a in range(2):
            mesh = shlib.Mesh(shape, dict(data=d, agent=a, model=0))
            parts[d, a] = shlib.shard_batch(batch, mesh, axes)
    for key in ("slots_m1", "targets", "targets_single", "slots_m2"):
        split_agent = ("agent" in axes and key in ("slots_m1",
                                                   "targets_single"))
        rows = []
        for d in range(2):
            cols = [parts[d, a][key] for a in range(2)]
            if split_agent:
                assert cols[0].shape[1] * 2 == batch[key].shape[1]
                rows.append(np.concatenate(cols, 1))
            else:
                np.testing.assert_array_equal(cols[0], cols[1])
                rows.append(cols[0])
        np.testing.assert_array_equal(np.concatenate(rows), batch[key])
    pts = parts[1, 1]["inputs_m1"]["points"]
    want = batch["inputs_m1"]["points"][1:, 2:] if "agent" in axes else \
        batch["inputs_m1"]["points"][1:]
    np.testing.assert_array_equal(pts, want)


def test_shard_batch_refuses_leaves_of_two_batch_sizes():
    batch = {"targets": np.zeros((2, 4)), "gt_mask": np.zeros((4, 4))}
    with pytest.raises(ValueError, match="batch size"):
        shlib.shard_batch(batch, NO_MESH, ("data",))


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("leaf", ["conv_kernel", "dense_kernel", "bn_scale",
                                  "odd_kernel", "narrow_kernel", "step"])
def test_param_rule_is_jaxs(leaf, model_size):
    """tests/test_sharding.py:68-86's leaves (and one kernel narrower
    than 2M) under JAX's ``param_pspec``."""
    leaves = {
        "conv_kernel": (3, 3, 8, 16), "dense_kernel": (8, 16),
        "bn_scale": (16,), "odd_kernel": (3, 3, 8, 7),
        "narrow_kernel": (3, 3, 8, 6), "step": (),
    }
    shape = leaves[leaf]
    want = tuple(jshard.param_pspec(np.zeros(shape), model_size))
    assert shlib.param_pspec(shape, model_size) == want


def test_shard_state_splits_what_jaxs_rule_splits():
    """Under a model axis of 2, the tiny flagship's column layers keep
    half their out channels exactly where JAX's ``param_pspec`` shards the
    flax kernel. JAX also shards >= 2-D leaves outside the column layers
    (the PFN's ``pfn_kernel``); the port replicates those."""
    cfg = dry.tiny_cfg(4)
    model = build_trainer(cfg, "cpu", 4).model
    full = {k: v.clone() for k, v in model.state_dict().items()}
    params, _ = to_flax(full)
    jax_leaves = {k for k, v in _flat(params).items()
                  if "model" in tuple(jshard.param_pspec(v, 2))}
    jax_sharded = {k[:-len(".kernel")] for k in jax_leaves
                   if k.endswith(".kernel")}
    mesh = shlib.Mesh(dict(data=1, agent=1, model=2),
                      dict(data=0, agent=0, model=1))
    shlib.shard_state(model, mesh)
    port = {name for name, m in model.named_modules()
            if getattr(m, "tp", None) is mesh}
    capable = {name for name, m in model.named_modules()
               if hasattr(type(m), "column_dims")}
    assert port and port == jax_sharded & capable
    assert jax_leaves - {f"{n}.kernel" for n in port} == {
        "branch_m1.encoder.pfn_kernel"}
    for name, m in model.named_modules():
        if name in port:
            kdim = type(m).column_dims[0]
            want = full[f"{name}.kernel"]
            half = want.shape[kdim] // 2
            torch.testing.assert_close(
                m.kernel.data, want.narrow(kdim, half, half), rtol=0, atol=0)
    assert all(m.mesh is mesh for m in model.modules()
               if hasattr(type(m), "mesh"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_process_shard_is_jaxs_split():
    """data/prefetch.process_shard: equal contiguous slices, the
    remainder dropped; one host takes everything."""
    from heal_tpu_torch.data.prefetch import process_shard

    assert [process_shard(10, i, 3) for i in range(3)] == [
        (0, 3), (3, 6), (6, 9)]
    assert process_shard(10) == (0, 10)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("data", [1, 2, 4])
def test_batch_parts_are_the_sharded_batch(train, data):
    """``FusionDataset.batches(part=(d, D))``, which a data rank of
    tools/train.py assembles, equals ``shard_batch``'s data slice of the
    whole collated batch, leaf by leaf, for every d."""
    from heal_tpu_torch.data import build_dataset

    ds = build_dataset(dry.tiny_cfg(4), train=train, native_iou=False)
    whole = next(ds.batches(4, shuffle=True, seed=3, process_split=False))
    shape = dict(data=data, agent=1, model=1)
    for d in range(data):
        part = next(ds.batches(4, shuffle=True, seed=3, process_split=False,
                               part=(d, data)))
        want = shlib.shard_batch(
            whole, shlib.Mesh(shape, dict(data=d, agent=0, model=0)),
            ("data",))
        got, want = _flat(part), _flat(want)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_batch_parts_must_divide_the_batch():
    from heal_tpu_torch.data import build_dataset

    ds = build_dataset(dry.tiny_cfg(4), train=False, native_iou=False)
    with pytest.raises(ValueError, match="does not split into 3"):
        next(ds.batches(4, shuffle=False, part=(0, 3)))


@pytest.mark.parametrize("variant", ["bn_f32", "none_f32"])
def test_one_rank_mesh_step_is_bit_equal_to_the_plain_step(tmp_path,
                                                           variant):
    """A world of one rank runs every collective of the mesh step (the
    batch norms' world sums, the gradient all-reduce, the aux mean) on
    the same arithmetic as the plain step: the loss and every gradient
    are bit-equal, as chip_smoke.py holds the NCCL flagship step."""
    cfg = dry.tiny_cfg(4, VARIANTS[variant][0])
    batch = to_device(dry.global_batch(cfg, 2), "cpu")
    init = str(tmp_path / "init.pth")
    torch.save(build_trainer(cfg, "cpu", 4).model.state_dict(), init)
    plain = build_trainer(cfg, "cpu", 1, resume=init)
    want = plain.gradients(batch)
    launch.init_rank(0, 1, "cpu", "file://" + str(tmp_path / "rdv"),
                     TIMEOUT_S)
    try:
        mesh = shlib.make_mesh(1, 1, 1, 1)
        meshed = build_trainer(cfg, "cpu", 1, resume=init, mesh=mesh)
        got = meshed.gradients(batch)
    finally:
        torch.distributed.destroy_process_group()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ref = dict(plain.model.named_parameters())
    for k, p in meshed.model.named_parameters():
        assert torch.equal(p.grad, ref[k].grad), k


def test_spawn_joins_a_rank_that_exits_between_its_checks(monkeypatch):
    """``launch.spawn`` without a time limit (tools/train.py's) returns
    when its one rank exits between the loop's liveness check and the
    wait: the wait is on a snapshot of the live ranks, never on an empty
    list, which would block for good."""

    class Rank:
        def __init__(self, target, args):
            self.calls, self.exitcode = 0, None
            read, write = os.pipe()
            os.write(write, b"x")  # an exited process's sentinel is ready
            self.sentinel = read

        def start(self):
            pass

        def is_alive(self):
            self.calls += 1
            if self.calls > 1:
                self.exitcode = 0
            return self.calls == 1

        def join(self, timeout=None):
            pass

    class Context:
        Process = Rank

    monkeypatch.setattr(torch.multiprocessing, "get_context",
                        lambda method: Context)
    joiner = threading.Thread(target=launch.spawn, args=(print, 1),
                              daemon=True)
    joiner.start()
    joiner.join(30)
    assert not joiner.is_alive()


def test_more_cuda_ranks_than_devices_raise():
    """``--devices`` on cuda with more ranks than visible devices names
    both counts and starts nothing (this CPU host sees none)."""
    with pytest.raises(ValueError, match="2 ranks on cuda, but 0"):
        train_tool.main(["-y", dry.TINY, "--devices", "2",
                         "--device", "cuda"])


# ---------------------------------------------------- the sharded steps


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The seeded init of each variant's config, the global batch, and
    the port's one-process step on them."""
    tmp = tmp_path_factory.mktemp("sharding")
    batch = dry.global_batch(dry.tiny_cfg(4), 2)
    out = {}
    for name, (norm, dtype) in VARIANTS.items():
        cfg = dry.tiny_cfg(4, norm)
        path = str(tmp / f"{name}.pth")
        torch.save(build_trainer(cfg, "cpu", 4).model.state_dict(), path)
        out[name] = dict(cfg=cfg, state=path, dtype=dtype,
                         single=dry.one_process(cfg, path, batch,
                                                dtype=dtype))
    return batch, out


def _world(setup, n, meshes):
    batch, variants = setup
    keys = [(m, v) for m in meshes for v in VARIANTS]
    jobs = [dict(cfg=variants[v]["cfg"], state=variants[v]["state"],
                 batch=batch, dims=m, dtype=variants[v]["dtype"])
            for m, v in keys]
    return dict(zip(keys, dry.sharded_results(jobs, n, "cpu", TIMEOUT_S)))


@pytest.fixture(scope="module")
def world2(setup):
    return _world(setup, 2, MESHES_2)


@pytest.fixture(scope="module")
def world4(setup):
    return _world(setup, 4, [MESH_4])


@pytest.fixture(scope="module")
def world8(setup):
    return _world(setup, 8, [MESH_8])


def _hold(sharded, single, variant, mesh):
    d_loss, d_grads = dry.equivalence_deltas(sharded, single)
    loss = single["aux"]["total_loss"]
    if VARIANTS[variant][1] == "float64":
        scale = dry.grad_scale(single)
        bound = 1e-8 if mesh[2] > 1 else 1e-9
        assert d_loss <= 1e-9 * loss, (d_loss, loss)
        assert d_grads <= bound * scale, (d_grads, scale)
        for k, v in single["buffers"].items():
            if v.is_floating_point():
                torch.testing.assert_close(sharded["buffers"][k], v,
                                           rtol=1e-9, atol=1e-12)
    else:
        assert d_loss <= 4e-3, d_loss
        assert d_grads <= (4e-3 if variant == "none_f32" else 0.4), d_grads
    assert sharded["aux"].keys() == single["aux"].keys()


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", MESHES_2, ids=lambda m: "x".join(map(str, m)))
def test_two_rank_step_is_one_process(world2, setup, mesh, variant):
    """data, agent and model parallel over two ranks: one process's loss,
    gradients and running statistics on the global batch."""
    _hold(world2[mesh, variant], setup[1][variant]["single"], variant, mesh)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_four_rank_mixed_step_is_one_process(world4, setup, variant):
    """A (2, 2, 1) mesh: a sample and two agents a rank."""
    _hold(world4[MESH_4, variant], setup[1][variant]["single"], variant,
          MESH_4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eight_rank_step_is_one_process(world8, setup, variant):
    """JAX's own test mesh, (2, 2, 2)."""
    _hold(world8[MESH_8, variant], setup[1][variant]["single"], variant,
          MESH_8)


def _jax_trainer(cfg):
    return JaxTrainer(
        model=build_jax_model(cfg["model"]),
        criterion=build_jax_loss(cfg["loss"]),
        tx=jax_optimizer(cfg["optimizer"], cfg["lr_scheduler"], 4),
        supervise_single=True)


def _jax_f64_step(jt, params, stats, batch):
    """JAX's loss and gradients with every float in f64
    (tests/test_torch_train.py ``_jax_f64_step``: ``jnp.float32`` bound
    to float64 while tracing, x64 on)."""
    f64 = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            (loss, (aux, _)), grads = jax.device_get(
                jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
                    f64(params), f64(stats), f64(batch)))
        finally:
            jnp.float32 = f32
    return dict(aux, total_loss=loss), grads


def test_four_rank_f64_step_is_jaxs(world4, setup):
    """The port's 4-rank f64 step against JAX's f64 step from the same
    weights and global batch: loss terms 1e-5 relative, every gradient
    leaf 1e-5 relative to 1 + max|JAX|."""
    batch, variants = setup
    v = variants["bn_f64"]
    params, stats = to_flax(torch.load(v["state"]))
    want_aux, want = _jax_f64_step(_jax_trainer(v["cfg"]), params, stats,
                                   batch)
    got = world4[MESH_4, "bn_f64"]
    for k, val in want_aux.items():
        np.testing.assert_allclose(got["aux"][k], val, rtol=1e-5, err_msg=k)
    want_g = _leaves(want)
    got_g = _leaves(to_flax(got["grads"])[0])
    assert got_g.keys() == want_g.keys() and len(got_g) > 50
    errs = {k: _rel(got_g[k], want_g[k]) for k in want_g}
    assert max(errs.values()) <= 1e-5, max(errs.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("variant", ["bn_f32", "none_f32"])
def test_eight_rank_step_is_jaxs_sharded_step(world8, setup, variant):
    """JAX's sharded f32 step on the 8 virtual CPU devices (mesh 2x2x2)
    against the port's 2x2x2 step, from the same weights and batch, at
    JAX's own sharded-vs-single f32 bounds."""
    if len(jax.devices()) < 8:
        pytest.fail("tests/conftest.py gives JAX 8 CPU devices")
    batch, variants = setup
    v = variants[variant]
    params, stats = to_flax(torch.load(v["state"]))
    jt = _jax_trainer(v["cfg"])
    mesh = jshard.make_mesh(8, agent=2, model=2)
    sb = jshard.shard_batch(jax.tree.map(jnp.asarray, batch), mesh)
    sp = jshard.shard_state(jax.tree.map(jnp.asarray, params), mesh)
    ss = jshard.shard_state(jax.tree.map(jnp.asarray, stats), mesh)
    (loss, _), grads = jax.device_get(jax.jit(jax.value_and_grad(
        jt._loss_fn, has_aux=True))(sp, ss, sb))
    got = world8[MESH_8, variant]
    assert abs(got["aux"]["total_loss"] - float(loss)) <= 4e-3
    want_g = _leaves(grads)
    got_g = _leaves(to_flax(got["grads"])[0])
    assert got_g.keys() == want_g.keys()
    d = max(float(np.abs(got_g[k] - want_g[k]).max()) for k in want_g)
    assert d <= (4e-3 if variant == "none_f32" else 0.4), d


def _v2xvit_cfg() -> dict:
    """tests/configs/tiny_late.yaml as intermediate fusion through
    V2X-ViT's flat form at C = 32: each MSwin branch 8 heads of 4, a head
    width that a model axis of 2 splits."""
    cfg = load_yaml(os.path.join(REPO, "tests", "configs", "tiny_late.yaml"))
    cfg["fusion"]["core_method"] = "intermediate"
    cfg["model"]["core_method"] = "point_pillar_baseline"
    a = cfg["model"]["args"]
    a["pillar_vfe"]["num_filters"] = [16]
    a["base_bev_backbone"].update(num_filters=[16, 32],
                                  num_upsample_filter=[16, 16])
    a["shrink_header"].update(dim=[32], input_dim=32)
    a.update(fusion_method="v2xvit", v2xvit={"depth": 1})
    return reparse(cfg)


def test_v2xvit_model_axis_step_is_one_process(tmp_path):
    """Under a model axis of 2 the q, k, v and out projections of every
    MSwin window attention keep their half of the head width (q, k, v) or
    of the output channels (out) and gather their outputs, and the f64
    step over two ranks is the one process's: loss within 1e-9 of it,
    every gradient within 1e-7 of max |g|. LayerNorm takes its statistics
    in f32 whatever the dtype (models/layers.layer_norm), so the sharded
    step's reassociated sums show at f32's rounding there (measured
    3.2e-8)."""
    from heal_tpu_torch.models.fuse.v2xvit import WindowAttention

    cfg = _v2xvit_cfg()
    model = build_trainer(cfg, "cpu", 4).model
    path = str(tmp_path / "v2xvit.pth")
    torch.save(model.state_dict(), path)
    mesh = shlib.Mesh(dict(data=1, agent=1, model=2),
                      dict(data=0, agent=0, model=1))
    shlib.shard_state(model, mesh)
    windows = [m for m in model.modules() if isinstance(m, WindowAttention)]
    assert len(windows) == 3
    for w in windows:
        mha = w.MultiHeadDotProductAttention_0
        assert all(p.tp is mesh for p in (mha.query, mha.key, mha.value,
                                          mha.out))
        assert mha.query.kernel.shape[-1] == w.dim_head // 2 == 2
    batch = dry.global_batch(cfg, 2)
    single = dry.one_process(cfg, path, batch, dtype="float64")
    (sharded,) = dry.sharded_results(
        [dict(cfg=cfg, state=path, batch=batch, dims=(1, 1, 2),
              dtype="float64")], 2, "cpu", TIMEOUT_S)
    d_loss, d_grads = dry.equivalence_deltas(sharded, single)
    loss = single["aux"]["total_loss"]
    assert d_loss <= 1e-9 * loss, (d_loss, loss)
    assert d_grads <= 1e-7 * dry.grad_scale(single), d_grads


# ----------------------------------------------------- the other items


def test_cli_2x1x2_checkpoint_loads_into_one_process(tmp_path):
    """``tools/train.main --devices 2x1x2 --device cpu``: four gloo
    ranks train an epoch; rank 0 alone logs and writes the checkpoint,
    in the one-device layout, which one process loads strictly, and runs
    the final inference."""
    run = str(tmp_path / "run")
    cfg_path = str(tmp_path / "tiny.yaml")
    cfg = dry.tiny_cfg(4)
    cfg["fusion"]["args"]["num_scenes_test"] = 2
    save_yaml(cfg, cfg_path)
    # a process of its own, leading a new process group: the tool's
    # ranks wait on their collectives with torch's default limit, so a
    # stuck world is killed whole here, within the test's own bound
    proc = subprocess.Popen(
        [sys.executable, "-m", "heal_tpu_torch.tools.train", "-y", cfg_path,
         "--model_dir", run, "--epochs", "1", "--devices", "2x1x2",
         "--device", "cpu"], cwd=REPO, start_new_session=True)
    try:
        assert proc.wait(timeout=4 * TIMEOUT_S) == 0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    with open(os.path.join(run, "train_log.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 1 and np.isfinite(lines[0]["total_loss"])
    epoch, path = ckpt_lib.find_checkpoint(run)
    assert path.endswith(".pth") and epoch == 1
    model = build_model(train_tool.load_config(cfg_path)["model"])
    model.load_state_dict(torch.load(path), strict=True)
    ref = build_trainer(train_tool.load_config(cfg_path), "cpu", 4).model
    assert {k: v.shape for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in ref.state_dict().items()}
    assert os.path.exists(os.path.join(run, "eval_intermediate.yaml"))


@pytest.fixture(scope="module")
def loss_world():
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.pt")
        launch.spawn(workers.rank_losses, 2, (out,), timeout_s=4 * TIMEOUT_S)
        return torch.load(out, weights_only=False)


@pytest.mark.parametrize("name", ["center", "depth", "voxel", "pixor"])
def test_batch_normalised_losses_are_global_under_data_2(loss_world, name):
    """Each rank divides by the count of the whole batch (all-reduced);
    the data ranks' losses average to the one-process loss and their
    prediction gradients stack into its gradient. The inputs give one
    sample no positive (no valid depth pixel), where a local count
    would differ."""
    loss, preds = workers.loss_terms(workers.loss_inputs())[name]
    loss.backward()
    got_value, got_grad = loss_world[name]
    np.testing.assert_allclose(got_value, loss.item(), rtol=1e-12)
    torch.testing.assert_close(got_grad, preds.grad, rtol=1e-12, atol=1e-15)


def test_dropout_draws_the_global_mask_under_data_2(loss_world):
    """The two data ranks' dropout outputs stack into one process's on
    the global input, from the same stream."""
    want = workers.dropout_draw()
    assert 0 < int((want == 0).sum()) < want.numel()
    torch.testing.assert_close(loss_world["dropout"], want, rtol=0, atol=0)
