"""heal_tpu ``.ckpt`` files read by the port without jax.

tests/configs/entry_tiny.yaml: a JAX init (running statistics
randomised) is written by ``heal_tpu.tools.checkpoint.save_checkpoint``.
The port's msgpack reader (utils/flax_msgpack.py) must give exactly what
``flax.serialization.msgpack_restore`` gives (same tree, dtypes, shapes
and bytes); the port's ``load_state_dict`` of it, loaded strictly into
the port model, must give JAX's heads within 1e-5 of 1 + max |JAX|
(max |d| / (1 + max |ref|): f32 convolutions summed in another order).
Chunked leaves are reassembled and bf16 leaves refused.
"""
import os

import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml
from heal_tpu.data import build_dataset
from heal_tpu.models import build_model as build_flax
from heal_tpu.tools import checkpoint as jax_ckpt
from heal_tpu_torch.models import build_model
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.utils import flax_msgpack
from heal_tpu_torch.utils.bridge import from_flax

torch.set_num_threads(1)
TINY = "tests/configs/entry_tiny.yaml"


def _rel(a, b) -> float:
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / (1.0 + np.abs(b).max()))


def _same(a, b, path="") -> None:
    """Equal trees: keys, types, and for arrays dtype, shape and bytes."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    cfg = load_yaml(TINY)
    batch = next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))
    jb = jax.tree.map(jnp.asarray, batch)
    jm = build_flax(cfg["model"])
    v = jax.device_get(jax.jit(
        lambda b: jm.init(jax.random.PRNGKey(0), b, train=False))(jb))
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape)
                      if p[-1].key in ("var", "bn_var")
                      else rng.uniform(-0.3, 0.3, s.shape)).astype(np.float32),
        v["batch_stats"])
    run = str(tmp_path_factory.mktemp("jax_run"))
    path = jax_ckpt.save_checkpoint(
        run, {"params": v["params"], "batch_stats": stats}, 3)
    return cfg, batch, jb, jm, {"params": v["params"], "batch_stats": stats}, \
        run, path


def test_reader_matches_flax_msgpack_restore(tiny_ckpt):
    path = tiny_ckpt[-1]
    with open(path, "rb") as f:
        data = f.read()
    want = flax.serialization.msgpack_restore(data)
    got = flax_msgpack.read(path)
    _same(got, want)
    assert got["epoch"] == 3 and len(jax.tree.leaves(got["params"])) > 50


def test_bridged_checkpoint_heads_match_jax(tiny_ckpt):
    cfg, batch, jb, jm, variables, run, path = tiny_ckpt
    want = jax.device_get(jm.apply(variables, jb, train=False))
    model = build_model(cfg["model"])
    model.load_state_dict(ckpt_lib.load_state_dict(path), strict=True)
    with torch.no_grad():
        got = model({k: (torch.from_numpy(np.asarray(v))
                         if not isinstance(v, dict) else
                         {kk: torch.from_numpy(np.asarray(vv))
                          for kk, vv in v.items()})
                     for k, v in batch.items()
                     if k in ("inputs_m1", "slots_m1", "agent_mask",
                              "pairwise_affine")})
    for k in ("cls_preds", "reg_preds", "dir_preds"):
        assert got[k].shape == want[k].shape, k
        assert _rel(got[k].numpy(), want[k]) <= 1e-5, k
    # the run dir's .ckpt is found (inference and merge take it)
    assert ckpt_lib.find_checkpoint(run) == (3, path)
    # a loose load of the same file leaves nothing out
    assert ckpt_lib.loose_load(build_model(cfg["model"]), path) == []


def test_find_checkpoint_names(tmp_path):
    """``net_epoch*.ckpt`` names count as the port's own, and the port
    picks the file and epoch JAX's ``find_checkpoint`` picks on the same
    listing: bestval while there is one (resume, inference and merge
    alike), else the newest; a ``.pth`` wins a tie."""
    d = str(tmp_path)
    for name in ("net_epoch2.ckpt", "net_epoch_bestval_at1.ckpt",
                 "net_epoch4.ckpt", "other.ckpt"):
        (tmp_path / name).touch()
    assert ckpt_lib.find_checkpoint(d) == jax_ckpt.find_checkpoint(d) == (
        1, os.path.join(d, "net_epoch_bestval_at1.ckpt"))
    (tmp_path / "net_epoch_bestval_at1.ckpt").unlink()
    assert ckpt_lib.find_checkpoint(d) == jax_ckpt.find_checkpoint(d) == (
        4, os.path.join(d, "net_epoch4.ckpt"))
    (tmp_path / "net_epoch4.pth").touch()
    assert ckpt_lib.find_checkpoint(d)[1].endswith("net_epoch4.pth")


def test_chunked_leaves_are_reassembled(monkeypatch):
    """flax splits leaves above MAX_CHUNK_SIZE bytes into
    ``__msgpack_chunked_array__`` dicts; with the limit lowered flax itself
    writes them, and the reader joins them back as flax does."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    tree = {"params": {"big": rng.randn(5, 7, 3).astype(np.float32),
                       "small": np.arange(4, dtype=np.int32)},
            "batch_stats": {"x": {"mean": rng.randn(40).astype(np.float32)}},
            "epoch": 7}
    data = flax.serialization.msgpack_serialize(tree)
    raw = msgpack.unpackb(data, raw=False)
    assert "__msgpack_chunked_array__" in raw["params"]["big"]
    assert len(raw["params"]["big"]["chunks"]) == 7  # 420 bytes / 64
    got = flax_msgpack.restore(data)
    _same(got, flax.serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got["params"]["big"], tree["params"]["big"])


def test_bf16_leaves_are_refused(tmp_path):
    tree = {"params": {"w": jnp.ones((2, 3), jnp.bfloat16)}, "epoch": 1}
    path = tmp_path / "net_epoch1.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize(tree))
    with pytest.raises(ValueError, match="bfloat16"):
        flax_msgpack.read(str(path))
    with pytest.raises(ValueError, match="bfloat16"):
        ckpt_lib.load_state_dict(str(path))


def test_msgpack_scalars_and_containers():
    """Every msgpack type the checkpoints can hold, against msgpack's own
    reader (flax's ext hook for the numpy leaves)."""
    tree = {"i": [0, 127, 128, 255, 65535, 2**32, -1, -32, -33, -200,
                  -40000, -2**40], "f": [0.5, -1e300], "s": "x" * 40,
            "t": "y" * 300, "b": b"\x00\x01" * 200, "n": None,
            "flags": [True, False], "nested": {str(k): k for k in range(20)},
            "sc": np.float64(2.5), "c": 1 + 2j,
            "a": np.arange(70000, dtype=np.int16)}
    data = flax.serialization.msgpack_serialize(tree)
    _same(flax_msgpack.restore(data), flax.serialization.msgpack_restore(data))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(data[:-3])
    assert from_flax({"k": flax_msgpack.restore(data)["a"]})["k"].dtype == \
        torch.float32


def test_heal_tpu_m3_checkpoint_loads_strictly_and_merges(tiny_ckpt,
                                                          tmp_path):
    """A heal_tpu ``.ckpt`` of the SECOND single model
    (tests/configs/entry_m3_single.yaml) loads strictly into the port:
    the (27, Cin, Cout) kernels as they are, the LayerNorm leaves by
    their flax names. ``merge_checkpoints`` of it with the m1 base keeps
    ``branch_m3`` as JAX's merge does."""
    from heal_tpu_torch.tools.inference import build_weights
    from heal_tpu_torch.tools.merge import DROP_FROM_NEW_TYPES

    cfg = load_yaml("tests/configs/entry_m3_single.yaml")
    batch = next(build_dataset(cfg, train=False).batches(
        1, shuffle=False, process_split=False))
    jm = build_flax(cfg["model"])
    v = jax.device_get(jax.jit(lambda b: jm.init(
        jax.random.PRNGKey(5), b, train=False))(jax.tree.map(jnp.asarray,
                                                             batch)))
    path = jax_ckpt.save_checkpoint(str(tmp_path / "m3"), dict(v), 1)
    sd = build_weights(cfg, checkpoint=path).state_dict()  # strict
    stack = "branch_m3.encoder.VmapSecondStack_0"
    assert sd[f"{stack}.conv_input.kernel"].shape == (27, 4, 8)
    assert sd[f"{stack}.down_3.kernel"].shape == (27, 16, 16)
    assert f"{stack}.stage3_subm1.LayerNorm_0.scale" in sd
    want = from_flax(v["params"], v["batch_stats"])
    for k, t in sd.items():
        assert torch.equal(t, want[k]), k
    paths = [path, tiny_ckpt[-1]]
    got = ckpt_lib.merge_checkpoints(paths, DROP_FROM_NEW_TYPES)
    jwant = jax_ckpt.merge_checkpoints(paths, DROP_FROM_NEW_TYPES)
    jwant = from_flax(jwant["params"], jwant["batch_stats"])
    assert got.keys() == jwant.keys()
    assert {k.split(".")[0] for k in got} == {
        "branch_m1", "branch_m3", "pyramid_backbone", "shrink", "heads"}
    for k, t in jwant.items():
        assert torch.equal(got[k], t), k
