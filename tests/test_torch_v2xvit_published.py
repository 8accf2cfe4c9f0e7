"""V2X-ViT at its published widths (heal_tpu_torch/models/fuse/v2xvit.py)
against the benchmark's plain reference (benchmark/reference/v2xvit.py),
on the CPU.

The published form of ``V2XViTFusion``'s args, ``transformer.encoder``
as V2X-ViT's yaml writes it, at a small size: the fusion alone against
the reference's V2X-ViT (untyped, typed, and with heads x dim_head
narrower than the width), the whole lidar-only model of
``benchmark/configs/v2xvit.json`` at its published widths on a small
range against the reference's heads, the flat form's module tree as it
was, the keys that raise, the collaborators' order, and the seeded
weights of the configuration loading strictly into the port.
"""
import copy
import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import check, serve  # noqa: E402
from benchmark import weights as wlib  # noqa: E402
from benchmark.reference import assemble  # noqa: E402
from benchmark.reference import v2xvit as ref  # noqa: E402
from benchmark.tests import tiny  # noqa: E402
from benchmark.traffic import scenes as gen  # noqa: E402
from heal_tpu_torch.config import reparse  # noqa: E402
from heal_tpu_torch.models import build_model  # noqa: E402
from heal_tpu_torch.models.fuse import build_fusion  # noqa: E402
from heal_tpu_torch.models.fuse import v2xvit  # noqa: E402

torch.set_num_threads(1)
C, B, L, H, W = 32, 2, 3, 16, 24
TOL = 1e-5
CONFIG = os.path.join(ROOT, "benchmark", "configs", "v2xvit.json")


def small_args(heads=(4, 2, 1), dim_head=(8, 16, 32), cav=(4, 8),
               depth=2) -> dict:
    """The published block at a small size: C 32, windows 2/4/8."""
    return {"num_types": 2, "in_channels": C, "transformer": {"encoder": {
        "num_blocks": 1, "depth": depth, "use_roi_mask": True,
        "use_RTE": False, "RTE_ratio": 2,
        "cav_att_config": {"dim": C, "use_hetero": True, "use_RTE": False,
                           "RTE_ratio": 2, "heads": cav[0],
                           "dim_head": cav[1], "dropout": 0.3},
        "pwindow_att_config": {"dim": C, "heads": list(heads),
                               "dim_head": list(dim_head), "dropout": 0.3,
                               "window_size": [2, 4, 8],
                               "relative_pos_embedding": True,
                               "fusion_method": "split_attn"},
        "feed_forward": {"mlp_dim": 32, "dropout": 0.3},
        "sttf": {"voxel_size": [0.4, 0.4, 4], "downsample_rate": 2}}}}


def _affine(theta, tx, ty):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s * H / W, tx], [s * W / H, c, ty]], np.float32)


def inputs(seed: int = 0):
    """B 2, L 3: sample 0 has three agents, sample 1 a padded slot."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, L, H, W, C)).astype(
        np.float32))
    mask = torch.tensor([[True, True, True], [True, True, False]])
    aff = np.tile(np.eye(2, 3, dtype=np.float32), (B, L, L, 1, 1))
    for b in range(B):
        for j in range(1, L):
            aff[b, 0, j] = _affine(0.3 * j - 0.2 * b, 0.1 * j, -0.05 * b)
    return x, torch.from_numpy(aff), mask


def pair(args: dict, seed: int = 4):
    """The port's fusion and the reference's V2X-ViT on one seeded state
    dict (the reference's leaves)."""
    r = ref.V2XViT(args, C).eval()
    state = wlib.make(wlib.shapes_of(r), seed, "cpu")
    r.load_state_dict(state)
    port = build_fusion("v2xvit", copy.deepcopy(args), C, L).eval()
    port.load_state_dict(state, strict=True)
    return port, r


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("case", ["untyped", "typed", "narrow"])
def test_published_fusion_matches_the_reference(case):
    """Eval mode, seeded weights: the ego's fused map within 1e-5 of the
    reference's largest magnitude. ``typed``: agent types 0 / 1 by slot;
    ``narrow``: heads x dim_head below C in every branch and in HMSA."""
    args = (small_args(heads=(2, 2, 1), dim_head=(4, 8, 16), cav=(2, 8))
            if case == "narrow" else small_args())
    port, r = pair(args)
    x, aff, mask = inputs()
    types = (torch.tensor([[0, 1, 1], [1, 0, 0]]) if case == "typed"
             else None)
    with torch.no_grad():
        got = port(x, aff, mask, agent_types=types)
        want = r(x, aff, mask, types)
    assert got.shape == (B, H, W, C)
    assert rel(got, want) <= TOL


def test_the_published_widths_are_built():
    """The configuration's block builds HMSA 8 x 32 over 2 types, MSwin
    branches 4 / 8 / 16 with 16 x 16, 8 x 32 and 4 x 64 heads, and a
    256-wide feed-forward, three layers."""
    hypes = json.load(open(CONFIG))["hypes"]
    args = hypes["model"]["args"]["v2xvit"]
    fusion = build_fusion("v2xvit", copy.deepcopy(args), 256, 5)
    shapes = wlib.shapes_of(fusion)
    assert fusion.depth == 3
    assert shapes["block_2.hmsa_0.q.kernel"] == (2, 256, 256)
    assert shapes["block_0.hmsa_0.relation_att"] == (2, 2, 8, 32, 32)
    for ws, m, dh in ((4, 16, 16), (8, 8, 32), (16, 4, 64)):
        pre = f"block_1.mswin_0.win{ws}."
        assert shapes[pre + "rel_pos_bias"] == ((2 * ws - 1) ** 2, m)
        assert shapes[pre + "MultiHeadDotProductAttention_0.query.kernel"] \
            == (256, m, dh)
        assert shapes[pre + "MultiHeadDotProductAttention_0.out.kernel"] \
            == (m, dh, 256)
    assert shapes["Dense_0.kernel"] == (256, 256)
    assert shapes["Dense_5.kernel"] == (256, 256)


def _tiny_cell(seed: int):
    hypes = tiny.shrink(json.load(open(CONFIG))["hypes"])
    r = ref.build(hypes).eval()
    shapes = wlib.shapes_of(r)
    r.load_state_dict(wlib.make(shapes, seed, "cpu"))
    program = serve.Program(hypes, shapes, seed, "cpu")
    traffic = tiny.shrink_traffic(json.load(open(os.path.join(
        ROOT, "benchmark", "traffic", "serve8.json"))))
    scene = gen.scenes(hypes, traffic, seed, 1)[0]
    return hypes, r, program, scene


def test_whole_model_heads_match_the_reference():
    """configs/v2xvit.json at its published widths on the tiny range
    (25.6 x 12.8 m, a 32 x 16 BEV every window divides): the port's
    heads, served, within the cell's ``heads`` limit of the reference's."""
    hypes, r, program, scene = _tiny_cell(2 ** 31 + 5)
    heads, dets = program.serve(program.assemble(scene))
    batch = assemble.to_device(assemble.collate(
        [assemble.assemble(hypes, scene, train=False)]), "cpu")
    with torch.no_grad():
        want = r(batch)
    assert want["cls_preds"].shape[1:3] == (16, 32)
    limit = json.load(open(CONFIG))["limits"]["serve"]["heads"]
    for k in check.HEADS:
        assert check._gap(heads[k], want[k]) <= limit, k
    assert dets["scores"].shape[0] == dets["corners"].shape[0]


def _tree_digest(module) -> str:
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(f"{k}:{tuple(v.shape)};".encode())
    return h.hexdigest()[:16]


def _yaml_model(rel_path: str):
    import yaml

    with open(os.path.join(ROOT, "heal_tpu", "configs", "opv2v",
                           rel_path)) as f:
        h = reparse(yaml.safe_load(f))
    return build_model(h["model"], max_cav=h["train_params"]["max_cav"])


@pytest.mark.parametrize("case, digest, leaves", [
    ("zoo_typed", "f7f925e853d76fe0", 53),
    ("zoo_hybrid", "bd76e652cae26775", 80),
    ("lidar_only/v2xvit.yaml", "5eb8b7b294be00a6", 320),
    ("more_modality/m1m2m3m4_v2xvit.yaml", "af35d29c200574ae", 435)])
def test_the_flat_form_builds_the_tree_it_built(case, digest, leaves):
    """Parameter names, order and shapes of the flat form, pinned from
    the port before the published form came in: the generated configs
    and the zoo tests' arguments build what they built."""
    if case == "zoo_typed":
        module = build_fusion("v2xvit", {"depth": 1, "num_types": 5}, 32, 3)
    elif case == "zoo_hybrid":
        module = build_fusion("v2xvit", {"transformer": {"encoder": {
            "depth": 1, "num_blocks": 2}}, "windows": [2, 4]}, 32, 3)
    else:
        module = _yaml_model(case)
    assert len(module.state_dict()) == leaves
    assert _tree_digest(module) == digest


def _set(args, path, value):
    node = args["transformer"]
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return args


@pytest.mark.parametrize("path, value, words", [
    (("encoder", "mlp_ratio"), 4, "unknown key"),
    (("encoder", "cav_att_config", "qkv_bias"), True, "unknown key"),
    (("encoder", "pwindow_att_config", "shift"), 1, "unknown key"),
    (("encoder", "feed_forward", "hidden"), 64, "unknown key"),
    (("decoder",), {}, "unknown key"),
    (("encoder", "use_RTE"), True, "not built"),
    (("encoder", "cav_att_config", "use_hetero"), False, "not built"),
    (("encoder", "pwindow_att_config", "fusion_method"), "naive",
     "not built"),
    (("encoder", "pwindow_att_config", "relative_pos_embedding"), False,
     "not built"),
    (("encoder", "cav_att_config", "dim"), 64, "width"),
    (("encoder", "pwindow_att_config", "heads"), [4, 2], "one a window")])
def test_a_key_the_port_does_not_build_raises(path, value, words):
    args = _set(small_args(), path, value)
    with pytest.raises(ValueError, match=words):
        build_fusion("v2xvit", args, C, L)


def test_the_keys_not_acted_on_are_named_with_a_reason():
    assert set(v2xvit.NOT_ACTED_ON) == {"sttf", "use_roi_mask", "use_RTE",
                                        "RTE_ratio"}
    assert all(len(why) > 20 for why in v2xvit.NOT_ACTED_ON.values())
    args = small_args()
    enc = args["transformer"]["encoder"]
    bare = copy.deepcopy(args)
    for k in v2xvit.NOT_ACTED_ON:
        bare["transformer"]["encoder"].pop(k)
    for k in ("use_RTE", "RTE_ratio"):
        bare["transformer"]["encoder"]["cav_att_config"].pop(k)
    assert enc["sttf"] and "sttf" not in bare["transformer"]["encoder"]
    assert _tree_digest(build_fusion("v2xvit", args, C, L)) == \
        _tree_digest(build_fusion("v2xvit", bare, C, L))


def test_collaborators_order_does_not_change_the_ego():
    """Per-branch heads: swapping the two collaborators of sample 0 (their
    maps, their transforms and their types) leaves the ego's map."""
    port, _ = pair(small_args(), seed=9)
    x, aff, mask = inputs(3)
    types = torch.tensor([[0, 1, 0], [0, 1, 1]])
    perm = [0, 2, 1]
    x2 = x.clone()
    x2[0] = x[0, perm]
    aff2 = aff.clone()
    aff2[0] = aff[0][perm][:, perm]
    types2 = types.clone()
    types2[0] = types[0, perm]
    with torch.no_grad():
        a = port(x, aff, mask, agent_types=types)
        b = port(x2, aff2, mask, agent_types=types2)
    assert rel(b, a) <= TOL


def test_the_configurations_seeded_weights_load_strictly():
    """weights.make has a rule for every leaf of the reference at the
    published widths, and the port's model takes the dict strictly."""
    hypes = json.load(open(CONFIG))["hypes"]
    shapes = wlib.shapes_of(ref.build(hypes))
    drawn = wlib.make(shapes, 2 ** 31 + 77, "cpu")
    assert list(drawn) == list(shapes)
    assert all(torch.isfinite(v).all() for v in drawn.values())
    h = reparse(copy.deepcopy(hypes))
    model = build_model(h["model"], max_cav=h["train_params"]["max_cav"])
    model.load_state_dict(drawn, strict=True)
    assert any(k.endswith("win16.rel_pos_bias") for k in drawn)
