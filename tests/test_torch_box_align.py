"""CoAlign's box alignment in the port against heal_tpu's, on the CPU.

  * ``utils/box_align.py`` (``uncertainty_to_weights``, ``_se2_apply``,
    ``cluster_boxes``, ``box_alignment_relative``) on seeded worlds of
    agents that share some objects and see clutter of their own: the
    clusters equal, the float64 poses within 1e-12;
  * the ``box_align.precalc_path`` hook (data/builder.py) and the
    scene's refinement branch (data/scene.py): a dump derived from the
    ground truth (each agent's view of every object, as
    tests/test_box_align.py builds it), with and without uncertainties,
    through both packages' ``build_dataset`` at seeded pose noise: the
    collated batches equal (``np.array_equal``, heal_tpu's C++ anchor
    IoU off as in tests/test_torch_host.py), and the aligned pairwise
    affines less than half as far from the clean ones as the noisy ones;
    a missing dump warns and leaves the poses noisy in both;
  * ``tools/pose_graph_evaluate.py``: the report equal to JAX's;
  * ``tools/pose_graph_pre_calc.py`` in both paths from one heal_tpu
    ``.ckpt`` (``heter_pyramid_collab`` on tests/configs/
    tiny_heter_collab.yaml, one-agent scenes; ``point_pillar_uncertainty``
    on tests/configs/tiny_late.yaml, padded presorted points): per frame
    one entry per scene agent, the same number of boxes, centers within
    1e-4 m, scores within 1e-5 and uncertainties within 1e-4 (the heads
    differ by ~1e-6; the class bias is set so that fewer than 300
    candidates an agent pass the threshold).
"""
import json
import os

import numpy as np
import pytest
import torch

import heal_tpu.native
from heal_tpu.config import load_yaml as jax_load_yaml
from heal_tpu.config import save_yaml as jax_save_yaml
from heal_tpu.data import build_dataset as jax_build_dataset
from heal_tpu.tools import pose_graph_evaluate as jax_evaluate
from heal_tpu.tools import pose_graph_pre_calc as jax_pre_calc
from heal_tpu.tools.checkpoint import save_checkpoint as jax_save
from heal_tpu.utils import box_align as jax_ba
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.tools import pose_graph_evaluate, pose_graph_pre_calc
from heal_tpu_torch.tools.inference import build_weights
from heal_tpu_torch.utils import box_align
from heal_tpu_torch.utils.bridge import to_flax

torch.set_num_threads(1)
COLLAB = "tests/configs/tiny_heter_collab.yaml"
LATE = "tests/configs/tiny_late.yaml"
NOISE = {"add_noise": True, "args": {"pos_std": 0.6, "rot_std": 0.6,
                                     "pos_mean": 0, "rot_mean": 0}}


@pytest.fixture(autouse=True)
def _numpy_host(monkeypatch):
    # heal_tpu's C++ anchor IoU rounds in f32; the port has the numpy path
    monkeypatch.setattr(heal_tpu.native, "load", lambda: None)


def _to_agent(pose, pts):
    yaw = np.radians(pose[4])
    c, s = np.cos(yaw), np.sin(yaw)
    return (pts - pose[:2]) @ np.array([[c, -s], [s, c]])


def _world(seed: int, n_agents: int = 4, n_obj: int = 10):
    """Box centers of shared objects (plus two clutter boxes an agent)
    in each agent's frame, the clean poses, noisy poses, and per-agent
    weights."""
    rng = np.random.default_rng(seed)
    objects = np.stack([rng.uniform(-40, 40, n_obj),
                        rng.uniform(-20, 20, n_obj)], axis=1)
    poses = np.zeros((n_agents, 6))
    poses[1:, 0] = rng.uniform(-15, 15, n_agents - 1)
    poses[1:, 1] = rng.uniform(-8, 8, n_agents - 1)
    poses[1:, 4] = rng.uniform(-60, 60, n_agents - 1)
    centers = []
    for p in poses:
        seen = objects[rng.random(n_obj) < 0.8]
        clutter = rng.uniform(-60, 60, (2, 2))
        centers.append(np.concatenate([_to_agent(p, seen), clutter])
                       + rng.normal(0, 0.05, (len(seen) + 2, 2)))
    noisy = poses.copy()
    noisy[1:, [0, 1]] += rng.normal(0, 0.8, (n_agents - 1, 2))
    noisy[1:, 4] += rng.normal(0, 3.0, n_agents - 1)
    unc = [rng.normal(0, 0.5, (len(c), 3)) for c in centers]
    return centers, poses, noisy, unc


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_align_functions_match_jax(seed, weighted):
    centers, clean, noisy, unc = _world(seed)
    for u in unc:
        np.testing.assert_array_equal(box_align.uncertainty_to_weights(u),
                                      jax_ba.uncertainty_to_weights(u))
    assert box_align.uncertainty_to_weights([]).shape == (0,)
    np.testing.assert_array_equal(
        box_align._se2_apply(np.array([1.0, -2.0, 0.3]), centers[1]),
        jax_ba._se2_apply(np.array([1.0, -2.0, 0.3]), centers[1]))
    world = [box_align._se2_apply(p[[0, 1]].tolist() + [np.radians(p[4])],
                                  c) for p, c in zip(clean, centers)]
    assert box_align.cluster_boxes(world) == jax_ba.cluster_boxes(world)
    weights = ([box_align.uncertainty_to_weights(u) for u in unc]
               if weighted else None)
    got = box_align.box_alignment_relative(centers, noisy, weights)
    want = jax_ba.box_alignment_relative(centers, noisy, weights)
    assert got.dtype == np.float64
    assert np.abs(got - want).max() <= 1e-12
    np.testing.assert_array_equal(got[0], noisy[0])  # the ego stays
    before = np.abs(noisy - clean)[1:, [0, 1, 4]].max()
    after = np.abs(got - clean)[1:, [0, 1, 4]].max()
    assert after < 0.5 * before, (before, after)


def _gt_dump(cfg, path, uncertainty: bool) -> str:
    """A stage-1 dump from the ground truth: each agent's view of every
    object's center (tests/test_box_align.py:69-106), with seeded
    uncertainties when asked."""
    ds = build_dataset(cfg, train=False)
    rng = np.random.default_rng(5)
    dump = {}
    for idx in range(len(ds)):
        scene = ds.backend.scene(idx)
        objs = scene["objects"][:, :2]
        per_agent = []
        for a in scene["agents"]:
            c = _to_agent(np.asarray(a["pose"], np.float64), objs)
            e = {"centers": c.tolist(), "scores": [0.9] * len(c)}
            if uncertainty:
                e["uncertainty"] = rng.normal(0, 0.3, (len(c), 3)).tolist()
            per_agent.append(e)
        dump[str(idx)] = per_agent
    with open(path, "w") as f:
        json.dump(dump, f)
    return path


def _assert_same(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert np.array_equal(got, want), path


def _collab_cfg() -> dict:
    cfg = jax_load_yaml(COLLAB)
    cfg["fusion"]["args"].update(num_agents=3, num_vehicles=10)
    return cfg


def _samples(build, cfg) -> list:
    np.random.seed(0)
    ds = build(cfg, train=False)
    return [ds[i] for i in range(len(ds))]


def _affine_err(samples, clean) -> float:
    return max(float(np.abs(s["pairwise_affine"]
                            - c["pairwise_affine"]).max())
               for s, c in zip(samples, clean))


@pytest.mark.parametrize("uncertainty", [False, True],
                         ids=["centers", "uncertainty"])
def test_precalc_hook_refines_as_jax(uncertainty, tmp_path):
    cfg = _collab_cfg()
    clean = _samples(build_dataset, cfg)
    path = _gt_dump(cfg, str(tmp_path / "stage1_boxes.json"), uncertainty)
    noisy_cfg = dict(cfg, noise_setting=NOISE)
    aligned_cfg = dict(noisy_cfg, box_align={"precalc_path": path,
                                             "args": {}})
    got = _samples(build_dataset, aligned_cfg)
    want = _samples(jax_build_dataset, aligned_cfg)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_same(g, w)
    # the hook set the detections (and weights) on the scene's agents
    ds = build_dataset(aligned_cfg, train=False)
    seen, assemble = [], ds.assembler.assemble
    ds.assembler.assemble = lambda scene: seen.append(scene) or assemble(
        scene)
    ds[0]
    agents = seen[0]["agents"]
    assert all("pred_centers" in a for a in agents)
    assert all(("pred_uncertainty" in a) == uncertainty for a in agents)
    noisy = _samples(build_dataset, noisy_cfg)
    e_noisy, e_aligned = _affine_err(noisy, clean), _affine_err(got, clean)
    assert e_aligned < 0.5 * e_noisy, (e_noisy, e_aligned)


def test_missing_precalc_warns_and_keeps_the_noisy_poses(tmp_path):
    cfg = dict(_collab_cfg(), noise_setting=NOISE)
    noisy = _samples(build_dataset, cfg)
    missing = dict(cfg, box_align={"precalc_path": str(tmp_path / "no.json")})
    for build in (build_dataset, jax_build_dataset):
        with pytest.warns(UserWarning, match="DISABLED"):
            samples = _samples(build, missing)
        for s, n in zip(samples, noisy):
            np.testing.assert_array_equal(s["pairwise_affine"],
                                          n["pairwise_affine"])


@pytest.mark.parametrize("uncertainty", [False, True],
                         ids=["centers", "uncertainty"])
def test_pose_graph_evaluate_matches_jax(uncertainty, tmp_path):
    cfg = _collab_cfg()
    run = str(tmp_path / "run")
    os.makedirs(run)
    jax_save_yaml(cfg, os.path.join(run, "config.yaml"))
    path = _gt_dump(cfg, str(tmp_path / "boxes.json"), uncertainty)
    want = jax_evaluate.evaluate(run, precalc_path=path, stds=(0.2, 0.4),
                                 max_frames=4)
    got = pose_graph_evaluate.main(["--model_dir", run, "--precalc", path,
                                    "--stds", "0.2,0.4", "--max_frames", "4"])
    assert got == want
    with open(os.path.join(run, "pose_graph_eval.json")) as f:
        assert json.load(f) == got
    # the errors are against the clean poses, the ego's noise included,
    # which the relative refinement keeps (as JAX's test reads them)
    r = got["0.4"]
    assert r["trans_refined"]["mean"] < r["trans_noisy"]["mean"]
    assert r["rot_refined"]["mean"] < r["rot_noisy"]["mean"]


def _stage1_run(path: str, which: str, tmp_path) -> str:
    """A run dir holding ``which``'s config and one heal_tpu ``.ckpt`` of
    the port's seeded init, the class bias at -2."""
    cfg = jax_load_yaml(path)
    if which == "plain":
        cfg["model"]["core_method"] = "point_pillar_uncertainty"
    model = build_weights(cfg, seed=3)
    bias = [k for k in model.state_dict() if k.endswith("cls_head.bias")]
    assert len(bias) == 1
    sd = model.state_dict()
    sd[bias[0]][:] = -2.0
    params, stats = to_flax(sd)
    run = str(tmp_path / which)
    os.makedirs(run)
    jax_save_yaml(cfg, os.path.join(run, "config.yaml"))
    jax_save(run, {"params": params, "batch_stats": stats}, 1)
    return run


@pytest.mark.parametrize("which,path", [("heter", COLLAB), ("plain", LATE)])
def test_pose_graph_pre_calc_matches_jax(which, path, tmp_path):
    run = _stage1_run(path, which, tmp_path)
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jax_pre_calc.main(["--model_dir", run, "--out", jpath,
                       "--max_frames", "2"])
    got = pose_graph_pre_calc.main(["--model_dir", run, "--out", tpath,
                                    "--max_frames", "2", "--device", "cpu"])
    with open(jpath) as f:
        want = json.load(f)
    with open(tpath) as f:
        assert json.load(f) == got
    assert sorted(got) == sorted(want) == ["0", "1"]
    ds = build_dataset(jax_load_yaml(path), train=False)
    n_boxes = 0
    for idx, agents in want.items():
        assert len(got[idx]) == len(agents) == len(
            ds.backend.scene(int(idx))["agents"])
        for g, w in zip(got[idx], agents):
            assert sorted(g) == sorted(w) == sorted(
                ["centers", "scores"]
                + (["uncertainty"] if which == "plain" else []))
            assert len(g["centers"]) == len(w["centers"]) < 300
            n_boxes += len(w["centers"])
            np.testing.assert_allclose(g["centers"], w["centers"], rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                       atol=1e-5)
            if which == "plain":
                assert np.shape(g["uncertainty"]) == (len(g["centers"]), 3)
                np.testing.assert_allclose(g["uncertainty"],
                                           w["uncertainty"], rtol=0,
                                           atol=1e-4)
    assert n_boxes > 0
