"""Late fusion's models, merge and serving, port vs JAX, on the CPU.

  * ``postprocess/decode.fuse_and_nms`` against JAX's on random padded
    detection sets of three agents (more than ``max_det`` candidates,
    overlapping boxes): keep masks, scores and corners equal (ties keep
    the lower index, as ``lax.top_k``);
  * ``heter_model_late`` on tests/configs/tiny_heter_m1m2.yaml as
    lateheter: an m1 and an m2 sample (JAX's init, its m1 branch on the
    Pallas kernel in interpret mode), heads and depth logits at 1e-4 as
    max |d| / (1 + max |ref|); the ``modality_flags`` gating; the camera
    BEV padded where JAX's late model leaves it short and its loss
    fails; ``supervise_single`` on a late config, where JAX's step
    raises and the port's trains (ROADMAP §3); the stage-3 merge of two
    single-type checkpoints loaded strictly;
  * ``tools/inference.run_inference`` late on tests/configs/tiny_late.yaml
    against heal_tpu's ``run_inference`` from one heal_tpu checkpoint:
    per frame the same number of kept detections, scores within 1e-5 and
    corners within 1e-4 (the heads differ by ~1e-6; the class bias is
    set so that fewer than 300 candidates a forward pass the threshold);
  * ``tools/train.py`` one epoch of late and of early fusion, then the
    final inference through the late / early path.
"""
import copy
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heal_tpu.native
import heal_tpu.utils.eval_np as jax_eval_np
from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.config import save_yaml as jax_save_yaml
from heal_tpu.data import build_dataset
from heal_tpu.losses import build_loss as build_jax_loss
from heal_tpu.models import build_model as build_flax
from heal_tpu.parallel import Trainer as JaxTrainer
from heal_tpu.postprocess import decode as jdecode
from heal_tpu.tools import inference as jax_inference
from heal_tpu.tools.checkpoint import save_checkpoint as jax_save
import heal_tpu_torch.utils.eval_np as eval_np
from heal_tpu_torch.config import keep_modalities, save_yaml
from heal_tpu_torch.data.scene import collate
from heal_tpu_torch.models import build_model
from heal_tpu_torch.parallel import to_device
from heal_tpu_torch.postprocess import decode as tdecode
from heal_tpu_torch.tools import checkpoint as ckpt_lib
from heal_tpu_torch.tools import train as train_tool
from heal_tpu_torch.tools.inference import build_weights, run_inference
from heal_tpu_torch.tools.merge import merge_final
from heal_tpu_torch.utils.box_np import boxes_to_corners_3d
from heal_tpu_torch.utils.bridge import load_flax, to_flax
from test_torch_camera_slice import _seeded_images
from test_torch_point_pillar import _random_stats, _rel, _tensors

torch.set_num_threads(1)
TINY = "tests/configs/tiny_late.yaml"
M1M2 = "tests/configs/tiny_heter_m1m2.yaml"
HEADS = ("cls_preds", "reg_preds", "dir_preds")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def late_heter_cfg(keep=("m1", "m2"), supervise_single=False) -> dict:
    """tiny_heter_m1m2.yaml as late fusion with ``heter_model_late``
    (batch norm, as every published config sets it) and the single-scale
    detection loss with depth supervision."""
    cfg = jax_load_yaml(M1M2)
    keep_modalities(cfg, keep)
    cfg["fusion"]["core_method"] = "lateheter"
    cfg["model"]["core_method"] = "heter_model_late"
    a = cfg["model"]["args"]
    a.pop("fusion_backbone")
    a["supervise_single"] = supervise_single
    a["shrink_header"].update(dim=[32], input_dim=32)
    cfg["loss"]["core_method"] = "point_pillar_loss"
    cfg["loss"]["args"].pop("pyramid")
    return cfg


def _late_samples(cfg, train=False):
    """The first test frame's samples (the ego's, then the others'), each
    collated at batch 1, camera images redrawn from a fixed seed."""
    np.random.seed(0)
    frame = next(build_dataset(cfg, train=train).batches(
        1, shuffle=False, process_split=False))
    out = [{k: v for k, v in frame.items() if k != "agent_samples"}]
    out += [collate([s]) for s in frame.get("agent_samples", [[]])[0]]
    return [_seeded_images(b) if "inputs_m2" in b else b for b in out]


def _inputs(batch):
    return _tensors({k: v for k, v in batch.items()
                     if k.startswith("inputs_") or k == "modality_flags"})


def _padded_set(rng, n, cap, center):
    boxes = np.concatenate([center + rng.normal(0, 2.0, (n, 3)),
                            np.tile([1.56, 1.6, 3.9], (n, 1)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    corners = np.zeros((cap, 8, 3), np.float32)
    scores = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    corners[:n] = boxes_to_corners_3d(boxes, "hwl")
    scores[:n] = rng.uniform(0.2, 1.0, n)
    valid[:n] = rng.uniform(size=n) < 0.9
    return corners, scores, valid


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuse_and_nms_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sets = [_padded_set(rng, n, 140, np.array([x, 0.0, 0.0]))
            for n, x in ((135, 0.0), (120, 3.0), (130, -3.0))]
    args = [[s[i] for s in sets] for i in range(3)]
    want = jax.device_get(jdecode.fuse_and_nms(
        *([jnp.asarray(x) for x in a] for a in args), nms_threshold=0.15))
    got = tdecode.fuse_and_nms(
        *([torch.from_numpy(x) for x in a] for a in args),
        nms_threshold=0.15)
    keep = want["valid"]
    # more valid candidates than max_det, and NMS drops some of the rest
    assert sum(int(s[2].sum()) for s in sets) > 300
    assert 0 < keep.sum() < 300
    np.testing.assert_array_equal(got["valid"].numpy(), keep)
    np.testing.assert_array_equal(got["scores"].numpy(), want["scores"])
    np.testing.assert_array_equal(got["corners"].numpy(), want["corners"])


# ---------------------------------------------------------- heter_model_late
@pytest.fixture(scope="module")
def late_heter():
    """An m1 sample (the ego) and an m2 sample of one test frame, JAX's
    init bridged into the port, JAX's heads."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(heal_tpu.native, "load", lambda: None)
        mp.setenv("HEAL_TPU_FORCE_PALLAS", "1")
        cfg = late_heter_cfg()
        samples = _late_samples(cfg)
        batch = collate([jax.tree.map(lambda x: x[0], s) for s in samples])
        jm = build_flax(cfg["model"])
        jb = jax.tree.map(jnp.asarray, batch)
        v = jax.device_get(jax.jit(
            lambda b: jm.init(jax.random.PRNGKey(0), b, train=False))(jb))
        v = {"params": v["params"],
             "batch_stats": _random_stats(v["batch_stats"], 0)}
        want = jax.device_get(jax.jit(lambda vv, b: {
            k: x for k, x in jm.apply(vv, b, train=False).items()
            if k in HEADS or k.startswith("depth_items")})(v, jb))
    model = load_flax(build_model(cfg["model"]), v["params"],
                      v["batch_stats"])
    return cfg, batch, model, v, want


def test_heter_model_late_heads_match_jax(late_heter):
    cfg, batch, model, v, want = late_heter
    assert sorted(v["params"]) == ["branch_m1", "branch_m2", "heads",
                                   "shrink"]
    assert batch["modality_flags"].tolist() == [[1.0, 0.0], [0.0, 1.0]]
    assert batch["inputs_m1"]["points"].shape == (2, 6000, 4)
    assert batch["inputs_m2"]["imgs"].shape == (2, 4, 128, 192, 3)
    with torch.no_grad():
        got = model(_inputs(batch))
    assert sorted(want) == sorted(HEADS + ("depth_items_m2",))
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert _rel(got[k].numpy(), w) <= TOL, (k, _rel(got[k].numpy(), w))


def test_modality_gating_blocks_the_inactive_branch(late_heter):
    """A sample's heads do not move when the inputs of the type it is not
    are replaced with noise (heal_tpu's tests/test_late_inference.py
    ::TestLateHeter::test_modality_gating_blocks_inactive_branch), in
    both directions."""
    _, batch, model, _, _ = late_heter
    rng = np.random.default_rng(1)
    noisy = copy.deepcopy(batch)
    noisy["inputs_m2"]["imgs"][0] = rng.normal(
        0, 1, noisy["inputs_m2"]["imgs"][0].shape)
    pts = noisy["inputs_m1"]["points"]
    pts[1, :3000] = rng.uniform(-30, 30, (3000, 4))
    noisy["inputs_m1"]["point_mask"][1, :3000] = True
    with torch.no_grad():
        a, b = model(_inputs(batch)), model(_inputs(noisy))
    for k in HEADS:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-5,
                                   err_msg=k)
    # the active inputs do move them
    noisy["inputs_m2"]["imgs"][1] += 1.0
    with torch.no_grad():
        c = model(_inputs(noisy))
    assert not torch.allclose(c["cls_preds"][1], a["cls_preds"][1])


def test_camera_only_late_pads_where_heal_tpu_fails():
    """An m2-only late config whose camera grid (+-19.2 m, 32 cells) is
    smaller than the lidar range (+-38.4 m, a 64 x 64 label grid), as
    the published single/m2_pretrain.yaml: the port pads the camera BEV to
    the lidar canvas and trains; JAX's late model does not, and its loss
    fails on the shapes."""
    cfg = late_heter_cfg(keep=("m2",))
    grid = {"xbound": [-19.2, 19.2, 1.2], "ybound": [-19.2, 19.2, 1.2],
            "zbound": [-10, 10, 20.0], "ddiscr": [2, 30, 16], "mode": "LID"}
    cfg["heter"]["modality_setting"]["m2"]["grid_conf"] = grid
    a = cfg["model"]["args"]["m2"]
    a["encoder_args"]["grid_conf"] = grid
    a["camera_mask_args"]["grid_conf"] = grid
    np.random.seed(0)
    batch = _seeded_images(next(build_dataset(cfg, train=True).batches(
        2, shuffle=False, process_split=False)))
    assert batch["pos_equal_one"].shape[1:3] == (64, 64)
    tr = train_tool.build_trainer(cfg, "cpu", 1)
    aux = tr.train_step(to_device(batch, "cpu"))
    assert np.isfinite(aux["total_loss"].item()) and "depth_loss" in aux
    with torch.no_grad():
        out = tr.model.eval()(_inputs(batch))
    assert tuple(out["cls_preds"].shape[:3]) == (2, 64, 64)
    params, stats = to_flax(tr.model.state_dict())
    jt = JaxTrainer(model=build_flax(cfg["model"]),
                    criterion=build_jax_loss(cfg["loss"]), tx=None)
    with pytest.raises((TypeError, ValueError)):
        jt._loss_fn(params, stats, jax.tree.map(jnp.asarray, batch))


def test_supervise_single_on_late_trains_where_heal_tpu_raises():
    """Every published single/m*_pretrain.yaml sets supervise_single on a
    late config. heal_tpu's train.py hands the flag to its Trainer
    whatever the fusion, and the step fails on the per-agent labels the
    late assembler never makes; the port takes it for intermediate
    fusion only (HEAL's rule) and trains."""
    cfg = late_heter_cfg(supervise_single=True)
    np.random.seed(0)
    batch = _seeded_images(next(build_dataset(cfg, train=True).batches(
        2, shuffle=False, process_split=False)))
    assert not any(k.endswith("_single") for k in batch)
    assert train_tool.supervise_single(cfg) is False
    assert train_tool.supervise_single(jax_load_yaml(M1M2)) is True
    tr = train_tool.build_trainer(cfg, "cpu", 1)
    assert tr.supervise_single is False
    aux = tr.train_step(to_device(batch, "cpu"))
    assert np.isfinite(aux["total_loss"].item())
    params, stats = to_flax(tr.model.state_dict())
    jt = JaxTrainer(model=build_flax(cfg["model"]),
                    criterion=build_jax_loss(cfg["loss"]), tx=None,
                    supervise_single=cfg["model"]["args"]["supervise_single"])
    with pytest.raises(KeyError, match="pos_equal_one_single"):
        jt._loss_fn(params, stats, jax.tree.map(jnp.asarray, batch))


def test_merge_of_single_type_checkpoints_loads_strictly(tmp_path):
    """HEAL's late table: each type's own detector (m1, m2) merged into
    the m1+m2 late model, the base's (m1's) shrink and heads winning; the
    merge loads strictly and keeps every branch entry."""
    dirs = {}
    for i, m in enumerate(("m1", "m2")):
        cfg = late_heter_cfg(keep=(m,))
        model = build_weights(cfg, seed=i)
        dirs[m] = str(tmp_path / m)
        ckpt_lib.save_checkpoint(dirs[m], model, 1, bestval=True)
        save_yaml(cfg, os.path.join(dirs[m], "config.yaml"))
    out = merge_final([dirs["m2"]], dirs["m1"], str(tmp_path / "m1m2"))
    merged = build_weights(late_heter_cfg(), checkpoint=out)
    sd = merged.state_dict()
    for m in ("m1", "m2"):
        src = ckpt_lib.load_state_dict(ckpt_lib.find_checkpoint(dirs[m])[1])
        for k, val in src.items():
            if m == "m1" or k.startswith("branch_"):
                assert torch.equal(sd[k], val), k
            else:  # m2's shrink and heads give way to the base's
                assert k.split(".")[0] in ("shrink", "heads")


# ------------------------------------------------------------------ serving
def _record(module, seen):
    real = module.calculate_tp_fp

    def spy(corners, scores, gt, stat, thr):
        if thr == 0.3:
            seen.append((np.asarray(corners), np.asarray(scores)))
        return real(corners, scores, gt, stat, thr)

    return spy


def test_run_inference_late_matches_heal_tpu(tmp_path, monkeypatch):
    cfg = jax_load_yaml(TINY)
    model = build_weights(cfg, seed=0)
    sd = model.state_dict()
    sd["DetectionHeads_0.cls_head.bias"][:] = -2.0
    model.load_state_dict(sd)
    params, stats = to_flax(model.state_dict())
    run = str(tmp_path)
    jax_save_yaml(cfg, os.path.join(run, "config.yaml"))
    jax_save(run, {"params": params, "batch_stats": stats}, 1)
    seen = {"jax": [], "port": []}
    monkeypatch.setattr(jax_eval_np, "calculate_tp_fp",
                        _record(jax_eval_np, seen["jax"]))
    monkeypatch.setattr(eval_np, "calculate_tp_fp",
                        _record(eval_np, seen["port"]))
    want = jax_inference.run_inference(run, max_batches=2, note="jax")
    got = run_inference(run, device="cpu", max_batches=2, note="port",
                        collect_heads=True)
    assert got["frames"] == 2 and len(got["heads"]) == 4  # 2 forwards each
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for (jc, js), (tc, ts) in zip(seen["jax"], seen["port"]):
        assert 0 < len(js) == len(ts) < 300
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
    for t in ("ap_30", "ap_50", "ap_70"):
        assert got[t] == pytest.approx(want[t], abs=1e-9)


@pytest.mark.parametrize("method", ["late", "early"])
def test_train_cli_then_inference(method, tmp_path):
    """One epoch (4 steps of 2, a validation pass whose late batches
    carry their agent samples), then the CLI's final inference through
    the late or early path, then a served run."""
    cfg = jax_load_yaml(TINY)
    cfg["fusion"]["core_method"] = method
    cfg["fusion"]["args"]["num_scenes_test"] = 2
    yaml = str(tmp_path / f"{method}.yaml")
    save_yaml(cfg, yaml)
    run = str(tmp_path / "run")
    train_tool.main(["-y", yaml, "--model_dir", run, "--epochs", "1",
                     "--device", "cpu"])
    assert glob.glob(os.path.join(run, "net_epoch_bestval_at1.pth"))
    assert glob.glob(os.path.join(run, "eval*.yaml"))
    result = run_inference(run, device="cpu", collect_heads=True)
    assert result["frames"] == 2
    assert len(result["heads"]) == (4 if method == "late" else 2)
    for t in ("ap_30", "ap_50", "ap_70"):
        assert 0.0 <= result[t] <= 1.0
