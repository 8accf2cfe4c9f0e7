"""The whole m1 Pyramid-collab slice, port vs JAX, on the CPU.

A JAX init of tests/configs/entry_tiny.yaml is bridged into the port and
one batch of heal_tpu.data.build_dataset is fed to both. Stated
tolerances: heads 1e-4 relative and absolute (XLA and oneDNN sum the ~20
convolutions in different orders); decoded boxes 1e-4 as well. Only the
VALID detections are compared: lax.top_k and torch.topk break ties among
the zero scores of invalid candidates differently.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heal_tpu.config import load_yaml
from heal_tpu.data import build_dataset
from heal_tpu.models import build_model as build_flax
from heal_tpu.postprocess import decode as jdecode
from heal_tpu_torch.models import build_model as build_torch
from heal_tpu_torch.postprocess import decode as tdecode
from heal_tpu_torch.tools.inference import run_inference
from heal_tpu_torch.utils.bridge import load_flax

torch.set_num_threads(1)
TINY = "tests/configs/entry_tiny.yaml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.fixture(scope="module")
def slice_outputs():
    cfg = load_yaml(TINY)
    ds = build_dataset(cfg, train=False)
    batch = next(ds.batches(1, shuffle=False, process_split=False))
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
    variables = {"params": v["params"], "batch_stats": stats}
    want = jax.jit(lambda vv, b: {
        k: x for k, x in jm.apply(vv, b, train=False).items()
        if k in ("cls_preds", "reg_preds", "dir_preds")
    })(variables, jb)

    tm = build_torch(cfg["model"])
    load_flax(tm, v["params"], stats)
    with torch.no_grad():
        got = tm(_tensors({k: batch[k] for k in (
            "inputs_m1", "slots_m1", "agent_mask", "pairwise_affine")}))
    return cfg, ds, batch, jax.device_get(want), got


def test_heads_match_jax(slice_outputs):
    _, _, batch, want, got = slice_outputs
    assert batch["agent_mask"].sum() >= 2  # a real collaboration
    for k in ("cls_preds", "reg_preds", "dir_preds"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=1e-4)


def test_post_process_valid_detections_match_jax(slice_outputs):
    cfg, ds, batch, want, _ = slice_outputs
    post = cfg["postprocess"]
    kw = dict(order=post["order"],
              score_threshold=post["target_args"]["score_threshold"],
              nms_threshold=post["nms_thresh"])
    # the same head outputs (JAX's) through both decoders
    args = [want["cls_preds"][0], want["reg_preds"][0], want["dir_preds"][0],
            np.asarray(ds.anchors, np.float32),
            np.asarray(batch["transformation_matrix"][0], np.float32),
            np.asarray(post["gt_range"], np.float32)]
    ref = jdecode.strip_padding(jax.device_get(
        jdecode.post_process_single(*map(jnp.asarray, args), **kw)))
    got = tdecode.strip_padding(tdecode.post_process_single(
        *(torch.from_numpy(np.array(a)) for a in args), **kw))
    assert 0 < len(ref["scores"]) < 300  # NMS kept some, dropped some
    for k in ("scores", "boxes", "corners"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4)


def test_run_inference_two_frames(slice_outputs):
    cfg = slice_outputs[0]
    result = run_inference(cfg=cfg, device="cpu", max_batches=2)
    assert result["frames"] == 2
    for t in ("ap_30", "ap_50", "ap_70"):
        assert 0.0 <= result[t] <= 1.0


# the port, and chip_smoke.py, run with jax, flax, optax and the JAX
# package blocked: an import of any of them raises
_BLOCK = """
import json, sys
for name in ("jax", "flax", "optax", "heal_tpu"):
    sys.modules[name] = None
"""
_LOADED = """
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "heal_tpu")
                and sys.modules[m] is not None)
"""

_NO_JAX = _BLOCK + """
import heal_tpu_torch
from heal_tpu_torch.models import build_loss
from heal_tpu_torch.parallel import Trainer, build_optimizer
from heal_tpu_torch.tools.inference import build_weights, run_inference
from heal_tpu_torch.tools.train import device_batches, load_config
import torch
torch.set_num_threads(1)
cfg = load_config(sys.argv[1])
r = run_inference(cfg=cfg, device="cpu", max_batches=1)
model = build_weights(cfg, seed=0)
opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                cfg["lr_scheduler"], 8)
trainer = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                  supervise_single=True)
batch, _ = next(device_batches(cfg, 2, "cpu"))
losses = [trainer.train_step(batch)["total_loss"].item() for _ in range(2)]
""" + _LOADED + """
print(json.dumps({"frames": r["frames"], "steps": len(losses),
                  "falling": losses[1] < losses[0], "loaded": loaded}))
"""

# chip_smoke.py's host side: the flagship config and one test batch
_CHIP_SMOKE = _BLOCK + """
import torch
torch.set_num_threads(1)
import chip_smoke
from heal_tpu_torch.tools.train import device_batches
cfg = chip_smoke.flagship_cfg()
batch, _ = next(device_batches(cfg, 1, "cpu", train=False))
""" + _LOADED + """
print(json.dumps({"points": list(batch["inputs_m1"]["points"].shape),
                  "agents": int(batch["agent_mask"].sum()),
                  "loaded": loaded}))
"""


def _run_blocked(script, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script, *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_never_imports_jax():
    out = _run_blocked(_NO_JAX, os.path.join(REPO, TINY))
    assert out == {"frames": 1, "steps": 2, "falling": True, "loaded": []}


def test_chip_smoke_never_imports_jax():
    out = _run_blocked(_CHIP_SMOKE)
    assert out == {"points": [1, 5, 30000, 4], "agents": 4, "loaded": []}
