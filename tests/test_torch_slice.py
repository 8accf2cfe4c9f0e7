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


# the port, and chip_smoke.py, run with jax, flax, optax, msgpack and the
# JAX package blocked: an import of any of them raises
_BLOCK = """
import json, sys
for name in ("jax", "flax", "optax", "msgpack", "heal_tpu"):
    sys.modules[name] = None
"""
_LOADED = """
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "msgpack", "heal_tpu")
                and sys.modules[m] is not None)
"""

_NO_JAX = _BLOCK + """
import heal_tpu_torch
from heal_tpu_torch.models import build_loss
from heal_tpu_torch.parallel import Trainer, build_optimizer
# the fusion zoo and the heterogeneous baselines
from heal_tpu_torch.models import heter_baseline
from heal_tpu_torch.models.fuse import (build_fusion, cobevt, legacy, v2xvit,
                                        where2comm_comm)
from heal_tpu_torch.ops.warp import warp_pairwise
from heal_tpu_torch.tools.inference import build_weights, run_inference
from heal_tpu_torch.tools.train import device_batches, load_config
# HEAL's stages 2 and 3 (a heal_tpu .ckpt is read by utils.flax_msgpack)
from heal_tpu_torch.parallel import freezing
from heal_tpu_torch.tools import (inference_heter_in_order, inference_w_noise,
                                  merge, run_demo_full)
from heal_tpu_torch.utils import flax_msgpack
# the camera agent type and the input pipeline: one camera batch
from heal_tpu_torch.data import build_dataset
from heal_tpu_torch.data.prefetch import prefetch
from heal_tpu_torch.models import lift_splat_shoot
from heal_tpu_torch.utils import camera
# the SECOND agent type: one m3 stage-2 model's forward
from heal_tpu_torch.models import second
from heal_tpu_torch.ops import column_conv, sparse_conv
import torch
torch.set_num_threads(1)
cam_cfg = load_config(sys.argv[3])
cam = next(prefetch(build_dataset(cam_cfg, train=False).batches(1, False)))
m3_cfg = load_config(sys.argv[4])
m3_batch, _ = next(device_batches(m3_cfg, 1, "cpu", train=False))
with torch.no_grad():
    m3_heads = build_weights(m3_cfg, seed=0).eval()(m3_batch)["cls_preds"]
cfg = load_config(sys.argv[1])
r = run_inference(cfg=cfg, device="cpu", max_batches=1)
model = build_weights(cfg, seed=0)
opt, schedule = build_optimizer(model.parameters(), cfg["optimizer"],
                                cfg["lr_scheduler"], 8)
trainer = Trainer(model, build_loss(cfg["loss"]), opt, schedule,
                  supervise_single=True)
batch, _ = next(device_batches(cfg, 2, "cpu"))
losses = [trainer.train_step(batch)["total_loss"].item() for _ in range(2)]
from heal_tpu_torch.tools import checkpoint
build_weights(cfg, checkpoint=sys.argv[2])  # a heal_tpu .ckpt, strictly
# a where2comm baseline served (its comm rate) and trained one step
b_cfg = load_config(sys.argv[5])
rb = run_inference(cfg=b_cfg, device="cpu", max_batches=1)
bmodel = build_weights(b_cfg, seed=0)
bopt, bsched = build_optimizer(bmodel.parameters(), b_cfg["optimizer"],
                               b_cfg["lr_scheduler"], 8)
btr = Trainer(bmodel, build_loss(b_cfg["loss"]), bopt, bsched,
              supervise_single=True)
baux = btr.train_step(next(device_batches(b_cfg, 1, "cpu"))[0])
zoo = [type(build_fusion(m, {"in_channels": 16, "policy_width": 16}, 16,
                         4)).__name__
       for m in ("max", "att", "disconet", "v2vnet", "where2comm", "who2com",
                 "v2xvit", "cobevt", "when2com", "transformer")]
# late fusion: one served frame through the late path (two forwards)
from heal_tpu_torch.data import augmentor, late_early
from heal_tpu_torch.models import point_pillar
rl = run_inference(cfg=load_config(sys.argv[6]), device="cpu", max_batches=1,
                   collect_heads=True)
# CoAlign: the uncertainty detector's stage-1 dump; the compressors
from heal_tpu_torch.config import save_yaml
from heal_tpu_torch.losses import point_pillar_uncertainty_loss
from heal_tpu_torch.models.layers import AutoEncoder, NaiveCompressor
from heal_tpu_torch.tools import pose_graph_evaluate, pose_graph_pre_calc
from heal_tpu_torch.utils import box_align
u_cfg = load_config(sys.argv[6])
u_cfg["model"]["core_method"] = "point_pillar_uncertainty"
u_cfg["fusion"]["args"]["num_scenes_test"] = 1
checkpoint.save_checkpoint(sys.argv[7], build_weights(u_cfg, seed=0), 1)
save_yaml(u_cfg, sys.argv[7] + "/config.yaml")
dump = pose_graph_pre_calc.main(["--model_dir", sys.argv[7],
                                 "--device", "cpu"])
with torch.no_grad():
    comp = AutoEncoder(8, 2)(NaiveCompressor(8, 4)(torch.zeros(1, 8, 8, 8)))
# CenterPoint served through the anchor-free decode; the SECOND detectors
from heal_tpu_torch.losses import center_point_loss
from heal_tpu_torch.models import center_point, second_model
rc = run_inference(cfg=load_config(sys.argv[8]), device="cpu", max_batches=1,
                   collect_heads=True)
# the last detectors, their losses, FPV-RCNN's point operators and the
# distillation trainer
from heal_tpu_torch.losses import (fpvrcnn_loss, pixor_loss,
                                   point_pillar_disconet_loss,
                                   voxel_net_loss)
from heal_tpu_torch.models import ciassd, fpvrcnn, pixor, voxel_net
from heal_tpu_torch.ops import pointnet
from heal_tpu_torch.tools import train_w_kd
kp = pointnet.farthest_point_sample(torch.rand(2, 64, 3),
                                    torch.ones(2, 64, dtype=torch.bool), 8)
""" + _LOADED + """
print(json.dumps({"frames": r["frames"], "steps": len(losses),
                  "falling": losses[1] < losses[0],
                  "camera": list(cam["inputs_m2"]["imgs"].shape),
                  "second": list(m3_heads.shape),
                  "comm": 0 < rb["comm_rate"] <= 1,
                  "baseline_step": sorted(k for k in baux if "comm" in k),
                  "zoo": zoo, "late_heads": len(rl["heads"]),
                  "precalc": [len(dump), len(dump["0"]), sorted(dump["0"][0])],
                  "compressor": list(comp.shape),
                  "center_point": [list(rc["heads"][0]["cls_preds"].shape),
                                   0 < rc["comm_rate"] <= 1],
                  "keypoints": list(kp.shape), "loaded": loaded}))
"""

# chip_smoke.py's host side: the flagship config and one test batch, and
# the protocol phase's configs and one alliance batch
_CHIP_SMOKE = _BLOCK + """
import torch
torch.set_num_threads(1)
import chip_smoke
from heal_tpu_torch.models import build_model
from heal_tpu_torch.tools.train import device_batches
cfg = chip_smoke.flagship_cfg()
batch, _ = next(device_batches(cfg, 1, "cpu", train=False))
cfgs = chip_smoke.protocol_cfgs()
final, _ = next(device_batches(cfgs["final"], 1, "cpu", train=False))
singles = [build_model(cfgs[k]["model"])
           for k in ("stage2", "stage2_m2", "stage2_m3")]
baselines = {
    name: [type(m).__name__,
           [type(f).__name__ for f in chip_smoke._fusions(m)]]
    for name, m in ((n, build_model(c["model"],
                                    max_cav=c["train_params"]["max_cav"]))
                    for n, c in chip_smoke.baseline_cfgs().items())}
# the fusion timings phase: its models and one late test frame
fcfgs = chip_smoke.fusion_cfgs()
fusion = {}
for n, c in fcfgs.items():
    m = build_model(c["model"], max_cav=c["train_params"]["max_cav"])
    fusion[n] = [type(m).__name__, type(getattr(m, "fusion", None)).__name__]
late, _ = next(device_batches(fcfgs["late"], 1, "cpu", train=False))
# the pose error and bandwidth phase: its models and loss
from heal_tpu_torch.models import build_loss
pose = {}
for n, c in chip_smoke.pose_cfgs().items():
    m = build_model(c["model"], max_cav=c["train_params"]["max_cav"])
    pose[n] = [type(m).__name__, list(getattr(m, "fix_modules", ())),
               type(build_loss(c["loss"])).__name__]
# the anchor-free and SECOND phase: its models, losses and scenes
from heal_tpu_torch.data import build_dataset
anchor_free = {}
for n, c in chip_smoke.anchor_free_cfgs().items():
    m = build_model(c["model"], max_cav=c["train_params"]["max_cav"])
    anchor_free[n] = [type(m).__name__, type(build_loss(c["loss"])).__name__,
                      c["train_params"]["max_cav"],
                      c["fusion"]["args"]["num_agents"],
                      "heatmap" in build_dataset(c, train=True)[0]]
# the disk phase's host side, its trees written small: the readers, one
# frame of each published config from its files, the train split
import tempfile
chip_smoke.DISK_IMG_HW = (150, 200)
chip_smoke.DISK_GROUND_POINTS, chip_smoke.DISK_BOX_POINTS = 1500, 300
disk = {}
with tempfile.TemporaryDirectory() as tmp:
    trees = chip_smoke.disk_trees(tmp)
    readers = chip_smoke.pcd_readers(trees["opv2v"], tmp)
    dcfgs = chip_smoke.disk_cfgs(trees)
    for n in chip_smoke.DISK_CFGS:
        frames, host = chip_smoke.disk_frames(dcfgs[n], 1, "cpu")
        disk[n] = [type(build_model(dcfgs[n]["model"], max_cav=dcfgs[n][
            "train_params"]["max_cav"])).__name__, len(host["in_range"][0]),
            sorted(k for k in frames[0][1] if k.startswith("inputs_"))]
    disk["train"] = len(build_dataset(dcfgs["train"], train=True))
    disk["sweeps"] = readers["sweeps"]
# the camera and options phase: its models, losses and label grids
camera = {}
for n, c in chip_smoke.camera_cfgs().items():
    m = build_model(c["model"], max_cav=c["train_params"]["max_cav"])
    camera[n] = [type(m).__name__, type(build_loss(c["loss"])).__name__,
                 list(build_dataset(c, train=False).anchors.shape[:2])]
# the legacy phase: its models, losses, fusion and a test sample's keys
legacy = {}
for n, c in chip_smoke.legacy_cfgs().items():
    m = build_model(c["model"], max_cav=c["train_params"]["max_cav"])
    sample = build_dataset(c, train=False)[0]
    legacy[n] = [type(m).__name__, type(build_loss(c["loss"])).__name__,
                 c["fusion"]["core_method"],
                 sorted(k for k in ("teacher_points", "pos_equal_one_single")
                        if k in sample)]
legacy["center_labels"] = sorted(
    k for k in chip_smoke.center_batch(chip_smoke.legacy_cfgs()["pixor"], 1,
                                       "cpu")
    if k in ("heatmap", "box_targets", "reg_mask"))
""" + _LOADED + """
print(json.dumps({"points": list(batch["inputs_m1"]["points"].shape),
                  "agents": int(batch["agent_mask"].sum()),
                  "alliance": [list(final[f"inputs_{m}"][k].shape)
                               for m, k in (("m1", "points"), ("m2", "imgs"),
                                            ("m3", "points"),
                                            ("m4", "points"))],
                  "stage2": [[type(m).__name__, m.modality, m.fix_modules]
                             for m in singles],
                  "cached": cfgs["stage2_m2"]["train_params"][
                      "cache_device_batches"],
                  "baselines": baselines, "fusion": fusion,
                  "late": [list(late["points"].shape),
                           len(late["agent_samples"][0]),
                           "data_augment" in fcfgs["late"]],
                  "pose": pose, "anchor_free": anchor_free, "disk": disk,
                  "camera": camera, "legacy": legacy, "loaded": loaded}))
"""


def _run_blocked(script, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script, *args],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_never_imports_jax(tmp_path):
    from heal_tpu.tools.checkpoint import save_checkpoint
    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.models.layers import init_weights
    from heal_tpu_torch.utils.bridge import to_flax
    from test_torch_center_point import cp_cfg
    from test_torch_heter_baseline import baseline_cfg

    model = init_weights(build_torch(load_yaml(TINY)["model"]),
                         torch.Generator().manual_seed(0))
    params, stats = to_flax(model.state_dict())
    ckpt = save_checkpoint(str(tmp_path), {"params": params,
                                           "batch_stats": stats}, 1)
    w2c = baseline_cfg("where2comm")
    w2c["fusion"]["args"].update(num_scenes_train=1, num_scenes_test=1)
    save_yaml(w2c, str(tmp_path / "w2c.yaml"))
    cp = cp_cfg("where2comm_transformer_ss")
    cp["fusion"]["args"].update(num_scenes_train=1, num_scenes_test=1)
    save_yaml(cp, str(tmp_path / "cp.yaml"))
    out = _run_blocked(_NO_JAX, os.path.join(REPO, TINY), ckpt,
                       os.path.join(REPO, "tests/configs/tiny_heter_m1m2.yaml"),
                       os.path.join(REPO, "tests/configs/entry_m3_single.yaml"),
                       str(tmp_path / "w2c.yaml"),
                       os.path.join(REPO, "tests/configs/tiny_late.yaml"),
                       str(tmp_path / "stage1"), str(tmp_path / "cp.yaml"))
    assert out == {"frames": 1, "steps": 2, "falling": True,
                   "camera": [1, 3, 4, 128, 192, 3], "second": [1, 32, 32, 2],
                   "comm": True, "baseline_step": ["comm_rate"],
                   "zoo": ["MaxFusion", "AttFusion", "DiscoFusion",
                           "V2VNetFusion", "Where2commFusion",
                           "Who2comFusion", "V2XViTFusion", "CoBEVTFusion",
                           "When2comFusion", "TransformerFusion"],
                   "late_heads": 2,
                   "precalc": [1, 2, ["centers", "scores", "uncertainty"]],
                   "compressor": [1, 8, 8, 8],
                   "center_point": [[1, 64, 64, 1], True],
                   "keypoints": [2, 8], "loaded": []}


def test_chip_smoke_never_imports_jax():
    out = _run_blocked(_CHIP_SMOKE)
    frozen = ["pyramid_backbone", "shrink", "heads"]
    grid = [128, 256]
    assert out == {"points": [1, 5, 30000, 4], "agents": 4,
                   "alliance": [[1, 5, 30000, 4], [1, 5, 4, 384, 512, 3],
                                [1, 5, 30000, 4], [1, 5, 30000, 4]],
                   "stage2": [["HeterPyramidSingle", "m4", frozen],
                              ["HeterPyramidSingle", "m2", frozen],
                              ["HeterPyramidSingle", "m3", frozen]],
                   "cached": True,
                   "baselines": {
                       **{n: ["HeterModelBaseline", [f]] for n, f in (
                           ("fcooper", "MaxFusion"), ("att", "AttFusion"),
                           ("disconet", "DiscoFusion"),
                           ("v2vnet", "V2VNetFusion"),
                           ("where2comm", "Where2commFusion"),
                           ("cobevt", "CoBEVTFusion"),
                           ("v2xvit", "V2XViTFusion"))},
                       "coalign": ["HeterModelBaselineMS",
                                   ["AttFusion", "AttFusion"]]},
                   "fusion": {
                       **{n: ["PointPillar", "NoneType"]
                          for n in ("late", "early")},
                       **{m: ["HeterModelLate", "NoneType"]
                          for m in ("m1", "m2", "m3", "m4", "m1m2")},
                       **{n: ["PointPillarBaseline", f] for n, f in (
                           ("max", "MaxFusion"), ("att", "AttFusion"),
                           ("disconet", "DiscoFusion"),
                           ("v2vnet", "V2VNetFusion"),
                           ("where2comm", "Where2commFusion"),
                           ("cobevt", "CoBEVTFusion"),
                           ("v2xvit", "V2XViTFusion"),
                           ("who2com", "Who2comFusion"),
                           ("when2com", "When2comFusion"),
                           ("transformer", "TransformerFusion"))}},
                   "late": [[1, 30000, 4], 3, True],
                   "pose": {
                       "coalign": ["HeterModelBaselineMS", [],
                                   "PointPillarLoss"],
                       "uncertainty": ["PointPillarUncertainty", [],
                                       "PointPillarUncertaintyLoss"],
                       "base": ["HeterPyramidCollab", [],
                                "PointPillarPyramidLoss"],
                       "compress": ["HeterPyramidCollab",
                                    ["branch_m1", *frozen],
                                    "PointPillarPyramidLoss"]},
                   "anchor_free": {
                       "center_point": ["CenterPointWhere2comm",
                                        "CenterPointLoss", 5, 4, True],
                       "second": ["SecondIntermediate", "PointPillarLoss", 2,
                                  2, False]},
                   "disk": {
                       "opv2v": ["HeterPyramidCollab", 3,
                                 ["inputs_m1", "inputs_m2", "inputs_m3",
                                  "inputs_m4"]],
                       "dairv2x": ["HeterPyramidCollab", 2, ["inputs_m1"]],
                       "v2xsim": ["PointPillarBaseline", 5, ["inputs_m1"]],
                       "train": 6, "sweeps": 5},
                   "camera": {
                       **{n: ["HeterModelBaseline", "PointPillarLoss", grid]
                          for n in ("fcooper", "attfuse", "disconet",
                                    "v2vnet", "cobevt", "v2xvit")},
                       "coalign": ["HeterModelBaselineMS", "PointPillarLoss",
                                   grid],
                       "m2_pyramid": ["HeterPyramidCollab",
                                      "PointPillarPyramidLoss", grid],
                       **{f"aligner_{a}": ["HeterPyramidSingle",
                                           "PointPillarPyramidLoss", grid]
                          for a in ("scaligner", "sdta", "cbam", "fanet")},
                       "iou": ["PointPillarBaseline", "PointPillarLoss",
                               grid],
                       "group": ["HeterModelLate", "PointPillarLoss", grid],
                       "lss_intermediate": ["LiftSplatShootIntermediate",
                                            "PointPillarLoss", [128, 128]],
                       "lss": ["LiftSplatShoot", "PointPillarLoss",
                               [128, 128]]},
                   "legacy": {
                       "multiscale": ["PointPillarBaselineMultiscale",
                                      "PointPillarLoss", "intermediate", []],
                       "disconet_teacher": ["PointPillarDiscoNetTeacher",
                                            "PointPillarLoss", "early", []],
                       "disconet": ["PointPillarDiscoNet",
                                    "PointPillarDiscoNetLoss", "intermediate",
                                    ["teacher_points"]],
                       "voxel_net": ["VoxelNet", "VoxelNetLoss", "early", []],
                       "voxel_net_intermediate": [
                           "VoxelNetIntermediate", "VoxelNetLoss",
                           "intermediate", []],
                       "pixor": ["Pixor", "CenterPointLoss", "early", []],
                       "pixor_intermediate": ["PixorIntermediate",
                                              "CenterPointLoss",
                                              "intermediate", []],
                       "ciassd": ["CIASSD", "CiassdLoss", "early", []],
                       "second_ssfa": ["SecondSSFA", "CiassdLoss", "early",
                                       []],
                       "second_ssfa_uncertainty": [
                           "SecondSSFAUncertainty",
                           "PointPillarUncertaintyLoss", "early", []],
                       "fpvrcnn": ["FPVRCNN", "FpvrcnnLoss",
                                   "intermediate2stage",
                                   ["pos_equal_one_single"]],
                       "center_labels": ["box_targets", "heatmap",
                                         "reg_mask"]},
                   "loaded": []}
