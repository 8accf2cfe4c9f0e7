"""The harness takes every anchor-based intermediate-fusion configuration
of OPV2V that the port serves: ``weights.make`` has a rule for each leaf
of the port's model, ``reference/assemble.py`` gives a configuration
with no ``heter`` block its points, and a cell on such a configuration
needs only new files. The cells already in BENCHMARK.json draw the same
weights and assemble the same reference batches as they did before the
fusion zoo's rules came in (checksums pinned from that harness, on the
CPU)."""
from __future__ import annotations

import copy
import glob
import hashlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from benchmark import check, harness, serve
from benchmark import train as train_mode
from benchmark import weights as wlib
from benchmark.reference import assemble
from benchmark.tests import tiny
from benchmark.traffic import scenes as gen

OPV2V = os.path.join(harness.ROOT, "heal_tpu", "configs", "opv2v")
V2XVIT = os.path.join(OPV2V, "lidar_only", "v2xvit.yaml")
COBEVT = os.path.join(OPV2V, "lidar_only", "cobevt.yaml")
SEEDS = (1, 2 ** 31 + 11)


def _raw(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def _anchor_intermediate(raw: dict) -> bool:
    """Anchor-based intermediate fusion: a heterogeneous model fused in
    the middle, or the lidar-only PointPillars baseline."""
    heter = bool(raw.get("heter")) and (
        raw["fusion"]["core_method"] == "intermediateheter")
    return heter or raw["model"]["core_method"] == "point_pillar_baseline"


ZOO = [p for p in sorted(glob.glob(os.path.join(OPV2V, "**", "*.yaml"),
                                   recursive=True))
       if _anchor_intermediate(_raw(p))]


def _digest(tree) -> str:
    """sha256 of every array of ``tree`` (nested dicts, keys sorted) with
    its name, dtype and shape; the first 16 hex digits."""
    h = hashlib.sha256()

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
            return
        a = (node.detach().cpu().numpy() if isinstance(node, torch.Tensor)
             else np.asarray(node))
        a = np.ascontiguousarray(a)
        h.update(f"{prefix}:{a.dtype}:{a.shape}".encode())
        h.update(a.tobytes())

    walk("", tree)
    return h.hexdigest()[:16]


def _port_shapes(hypes: dict) -> dict:
    from heal_tpu_torch.config import reparse
    from heal_tpu_torch.models import build_model

    h = reparse(copy.deepcopy(hypes))
    return wlib.shapes_of(build_model(h["model"],
                                      max_cav=h["train_params"]["max_cav"]))


def _traffic(mode: str) -> dict:
    return harness.load_json(harness.HERE, "traffic",
                             {"serve": "serve8.json",
                              "train": "train4.json"}[mode])


def _heads_limit() -> float:
    return harness.load_json(harness.HERE, "configs", "flagship.json")[
        "limits"]["serve"]["heads"]


def test_the_zoo_holds_every_v2xvit_and_cobevt_config():
    names = [os.path.relpath(p, OPV2V) for p in ZOO]
    attention = [n for n in names if "v2xvit" in n or "cobevt" in n]
    assert len(attention) == 10, attention
    assert "lidar_only/v2xvit.yaml" in names
    assert "heal/stage1/m1_pyramid.yaml" in names


@pytest.mark.parametrize("path", ZOO,
                         ids=lambda p: os.path.relpath(p, OPV2V))
def test_every_leaf_of_the_ports_model_has_a_rule(path):
    shapes = _port_shapes(_raw(path))
    drawn = wlib.make(shapes, 3, "cpu")
    assert list(drawn) == list(shapes)
    for name, value in drawn.items():
        assert tuple(value.shape) == shapes[name], name
        assert torch.isfinite(value).all(), name


@pytest.mark.parametrize("name, shape, fan_in", [
    ("fusion.block_0.SwapAttention_1.MultiHeadDotProductAttention_0"
     ".query.kernel", (64, 8, 8), 64),
    ("V2XViTFusion_0.block_2.mswin_0.win4.MultiHeadDotProductAttention_0"
     ".value.kernel", (256, 8, 32), 256),
    ("TransformerFusion_0.mha.key.kernel", (256, 8, 32), 256),
    ("fusion.block_0.SwapAttention_0.MultiHeadDotProductAttention_0"
     ".out.kernel", (8, 8, 64), 64),
    ("Where2commFusion_0.mha.out.kernel", (8, 32, 256), 256),
    ("fusion.block_1.hmsa_0.q.kernel", (5, 64, 64), 64),
    ("V2XViTFusion_0.block_0.hmsa_0.proj.kernel", (4, 256, 256), 256),
    ("branch_m3.encoder.VmapSecondStack_0.down_1.kernel", (27, 16, 32),
     27 * 16),
    ("branch_m3.encoder.VmapSecondStack_0.conv_input.kernel", (27, 4, 16),
     27 * 4),
])
def test_three_dimensional_kernels_take_their_fan_in(name, shape, fan_in):
    assert wlib._fan_in(name, shape) == fan_in


def test_relation_maps_are_lecun_over_their_input_width():
    noise = torch.randn(4, 4, 8, 32, 32, generator=torch.Generator()
                        .manual_seed(0))
    for leaf in ("relation_att", "relation_msg"):
        out = wlib._leaf(f"fusion.block_0.hmsa_0.{leaf}", noise.shape, noise)
        assert torch.equal(out, noise * (1.0 / 32) ** 0.5)


@pytest.mark.parametrize("config", ["flagship", "alliance"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_cells_draws_are_unchanged(config, seed):
    pinned = {("flagship", 1): "d6ca19500ebf7ed7",
              ("flagship", SEEDS[1]): "0252eafd11124e6a",
              ("alliance", 1): "c6766483247ef9f2",
              ("alliance", SEEDS[1]): "3a0d074d7bea882a"}
    hypes = harness.load_json(harness.HERE, "configs", f"{config}.json")[
        "hypes"]
    shapes = wlib.shapes_of(harness.reference(config).build(hypes))
    assert _digest(wlib.make(shapes, seed, "cpu")) == pinned[config, seed]


@pytest.mark.parametrize("config", ["flagship", "alliance"])
@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_cells_reference_batches_are_unchanged(config, mode, seed):
    """The first scene served, or the first batch trained (numpy's
    global state seeded as ``check.train`` seeds it)."""
    pinned = {("flagship", "serve", 1): "5a89e39d7ba735df",
              ("flagship", "serve", SEEDS[1]): "aba2b8b6f34d017c",
              ("alliance", "serve", 1): "43a42403e1f8fa39",
              ("alliance", "serve", SEEDS[1]): "5bc0dc904be179b8",
              ("flagship", "train", 1): "a028789543e276dd",
              ("flagship", "train", SEEDS[1]): "3300380f8fc01ee1",
              ("alliance", "train", 1): "af2528ad9f7d3ce7",
              ("alliance", "train", SEEDS[1]): "fa43d8eb2e14537e"}
    hypes = harness.load_json(harness.HERE, "configs", f"{config}.json")[
        "hypes"]
    train = mode == "train"
    count = hypes["train_params"]["batch_size"] if train else 1
    scenes = gen.scenes(hypes, _traffic(mode), seed, count)
    np.random.seed(train_mode.numpy_seed(seed))
    batch = assemble.collate([assemble.assemble(hypes, s, train)
                              for s in scenes])
    assert _digest(batch) == pinned[config, mode, seed]


def _ports_sample(hypes: dict, scene: dict, train: bool, presort: bool):
    from heal_tpu_torch.config import reparse
    from heal_tpu_torch.data import assembler_class

    h = reparse(copy.deepcopy(hypes))
    h["preprocess"]["args"]["presort"] = presort
    return assembler_class(h)(h, train=train,
                              native_iou=False).assemble(scene)


@pytest.mark.parametrize("train", [False, True])
def test_lidar_only_points_are_the_ports_assemblers(train):
    """lidar_only/v2xvit.yaml at its published range and 30000 points:
    the reference's ``points`` and ``point_mask`` are the port's,
    exactly; with the port's presort on, each slot holds the same rows
    in the presort's order."""
    hypes = _raw(V2XVIT)
    assert "heter" not in hypes
    scene = gen.scenes(hypes, _traffic("serve"), SEEDS[1], 1)[0]
    seed = train_mode.numpy_seed(SEEDS[1])
    np.random.seed(seed)
    ref = assemble.assemble(hypes, scene, train)
    np.random.seed(seed)
    port = _ports_sample(hypes, scene, train, presort=False)
    for key in ("points", "point_mask"):
        assert ref[key].dtype == port[key].dtype
        assert np.array_equal(ref[key], port[key]), key
    assert ref["point_mask"].sum() > 0
    np.random.seed(seed)
    sorted_port = _ports_sample(hypes, scene, train, presort=True)
    assert np.array_equal(ref["point_mask"], sorted_port["point_mask"])
    for a, b in zip(ref["points"], sorted_port["points"]):
        assert np.array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])


def _tiny_program(path: str, seed: int):
    hypes = tiny.shrink(_raw(path))
    program = serve.Program(hypes, _port_shapes(hypes), seed, "cpu")
    scene = gen.scenes(hypes, tiny.shrink_traffic(_traffic("serve")), seed,
                       1)[0]
    return program, program.assemble(scene)


def _heads_gap(a: dict, b: dict) -> float:
    return max(check._gap(a[k], b[k]) for k in check.HEADS)


@pytest.mark.parametrize("path, leaf", [
    (V2XVIT, "relation_att"), (V2XVIT, "relation_msg"),
    (V2XVIT, "rel_pos_bias"), (COBEVT, "rel_pos_bias")],
    ids=lambda v: os.path.basename(v) if os.sep in str(v) else v)
def test_each_new_rules_leaf_moves_the_heads(path, leaf):
    """A small port model with the seeded weights: zeroing every leaf
    of the rule moves the heads past the serve cells' ``heads`` limit."""
    program, batch = _tiny_program(path, 11)
    base, _ = program.serve(batch)
    state = program.model.state_dict()
    names = [k for k in state if k.endswith("." + leaf)]
    assert names
    with torch.no_grad():
        for k in names:
            state[k].zero_()
    assert _heads_gap(program.serve(batch)[0], base) > 10 * _heads_limit()


@pytest.mark.parametrize("path", [V2XVIT, COBEVT], ids=os.path.basename)
def test_a_wrong_offset_shows_in_the_heads(path):
    """The relative-position bias read through its offset index
    transposed (every offset negated): the heads move past the serve
    cells' ``heads`` limit."""
    program, batch = _tiny_program(path, 12)
    base, _ = program.serve(batch)
    for m in program.model.modules():
        if hasattr(m, "rel_idx"):
            n = int(round(m.rel_idx.numel() ** 0.5))
            m.rel_idx = m.rel_idx.reshape(n, n).t().reshape(-1).contiguous()
    assert _heads_gap(program.serve(batch)[0], base) > 10 * _heads_limit()


def test_a_new_config_needs_only_new_files(monkeypatch):
    """A throwaway configuration made of new files alone: a config file
    frozen from lidar_only/v2xvit.yaml, a stub reference module (its
    ``build`` gives the port's leaf names and shapes, as a plain
    reference's state dict must) and a manifest entry. The harness finds
    it by name; its weights are seeded and load into the port's model
    strictly; its scenes are assembled for the reference with their
    points, and the port serves one."""
    bench = json.loads(json.dumps(harness.manifest()))
    bench["configs"].append({
        "name": "v2xvit_throwaway", "source": "test",
        "file": "benchmark/configs/v2xvit_throwaway.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": "v2xvit_throwaway.serve",
                               "config": "v2xvit_throwaway",
                               "traffic": "serve8", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "flagship.serve" in m["workloads"]:
            m["workloads"].append("v2xvit_throwaway.serve")
    config_file = {"hypes": tiny.shrink(_raw(V2XVIT)),
                   "precision": "float32",
                   "limits": harness.load_json(
                       harness.HERE, "configs", "flagship.json")["limits"]}
    real = harness.load_json

    def load(*parts):
        if parts[-1] == "v2xvit_throwaway.json":
            return copy.deepcopy(config_file)
        return real(*parts)

    shapes = _port_shapes(config_file["hypes"])

    class Stub(torch.nn.Module):
        def state_dict(self, *a, **k):
            return {n: torch.empty(s) for n, s in shapes.items()}

    stub = types.ModuleType("benchmark.reference.v2xvit_throwaway")
    stub.build = lambda hypes: Stub()
    stub.to_device = assemble.to_device
    monkeypatch.setattr(harness, "load_json", load)
    monkeypatch.setitem(sys.modules, stub.__name__, stub)

    c = harness.cell("v2xvit_throwaway.serve", bench)
    assert harness.limits(c)["heads"] == _heads_limit()
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s",
                                                   "serve_frames_per_s"}
    hypes = c["config_file"]["hypes"]
    ref = harness.reference(c["config"])
    ref_shapes = wlib.shapes_of(ref.build(hypes))
    assert ref_shapes == shapes
    program = serve.Program(hypes, ref_shapes, SEEDS[1], "cpu")
    scene = gen.scenes(hypes, tiny.shrink_traffic(c["traffic_file"]),
                       SEEDS[1], 1)[0]
    batch = ref.to_device(assemble.collate(
        [assemble.assemble(hypes, scene, train=False)]), "cpu")
    assert set(batch) == {"agent_mask", "pairwise_affine", "points",
                          "point_mask"}
    assert batch["point_mask"].any()
    heads, dets = program.serve(program.assemble(scene))
    assert all(torch.isfinite(v).all() for v in heads.values())
    assert dets["scores"].shape[0] == dets["corners"].shape[0]
