"""Drive the PyTorch port (heal_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels of heal_tpu_torch/csrc from this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the flagship config (heal_tpu/configs/opv2v_m1_pyramid.yaml:
     5 agents, 30000 points each, 512x256 BEV), f32 and bf16: max abs
     error, both device times (CUDA events, after a warmup), the bytes
     and the bound they set, and the time of one PyTorch call that
     computes the same function where there is one (F.grid_sample for
     kernel 2); kernel 1 on the first flagship frame and on a frame as
     dense as OPV2V lidar, each call held to one device kernel and no
     host sync (torch.profiler, sync debug mode "error"); kernel 2 at its
     3 levels, rows and columns, forward and backward (the kernel run
     with -s, against shift_*_plain(g, -s));
  4. serve 8 synthetic flagship frames through
     heal_tpu_torch.tools.inference.run_inference with seeded random
     weights, f32 (TF32 off) and bf16 (points, affines and decode f32);
     the f32 heads must match the same frames run with the plain kernel
     versions on the card; both kernels' launch counters must rise while
     serving; frames/s for both, and the exact-vs-shear warp time;
  5. train the flagship model (batch_size 2, full width and depth) with
     heal_tpu_torch.parallel.Trainer: one f32 step through the kernels and
     one through the plain versions from the same weights and batch (loss
     and every gradient must agree), then 6 steps on the repeated batch
     (the loss must be finite and fall), then 2 bf16-policy steps; kernel
     2's forward and backward counters must rise and kernel 1's must not
     move (it is eval-only); ms/step, samples/s and peak memory;
  6. HEAL's protocol (stages 2 and 3) on the published configs at full
     width (heal_tpu/configs/opv2v/heal/: stage1/m1_pyramid,
     stage2/m4_alignto_m1, stage2/m2_alignto_m1, stage2/m3_alignto_m1,
     final_infer/m1m2m3m4 uncut), on synthetic scenes with the flagship's
     scene arguments: a stage-1 m1 base (seeded init, two f32 steps,
     saved);
     stage 2 of each new agent type through
     heal_tpu_torch.tools.train.main with --init_from the base (no
     frozen key left out at load; the pyramid, shrink and heads bit-equal
     to the base after it; the new branch moved; finite loss): m4, the
     16-line PointPillars agent, and m2, the Lift-Splat-Shoot camera
     agent (4 cameras at 384x512, 48 depth bins, its 128x128 grid padded
     to the 128x256 canvas; the batches cached on the card, as
     train_params.cache_device_batches asks; the depth loss finite), each
     stage-2 step timed in f32 and bf16 with its peak memory; and m3, the
     SECOND sparse-conv agent (a (40, 1024, 2048) voxel grid, column
     capacities 24000 / 16000 / 12000 / 8000), whose encoder is also held
     on one frame against the same module on the CPU (integer tables
     equal, f32 features within 1e-5) and whose active columns at each
     level are counted against the capacities (with the count dropped by
     overflow); the merge (heal_tpu_torch.tools.merge.merge_final: strict
     load into the alliance, shared modules bit-equal to the base); the
     m1+m2+m3+m4 alliance served in f32 and bf16 (2 launches of kernel 1
     and 15 of kernel 2 a frame; f32 heads against the plain kernel
     versions; the camera's depth RMSE; the camera branch's stages and
     the SECOND branch's (voxelize, rank maps and tables, the convs of
     each level, to_dense_bev, backbone + aligner) timed with CUDA events,
     with each branch's share of the frame), the in-order evaluation (m1,
     m1m2, m1m2m3, m1m2m3m4) and one pose-noise level. Phase 3 also holds
     kernel 1 on the alliance's first m4 frame (16-line, sorted on the
     card) against its plain version;
  7. HEAL's heterogeneous baselines: the eight published
     heal_tpu/configs/opv2v/more_modality/m1m2m3m4_{fcooper, att,
     disconet, v2vnet, where2comm, cobevt, v2xvit, coalign}.yaml at full
     width with seeded random weights (heter_model_baseline with max,
     att, disconet, v2vnet, where2comm, cobevt and v2xvit fusion; coalign
     is heter_model_baseline_ms with att at two levels), on synthetic
     scenes with the flagship's scene arguments; cut to BASELINE_FRAMES
     test frames and one train batch of BASELINE_BATCH scenes (published
     4). The frames are assembled and copied to the card once and every
     model serves the same device frames through
     tools.inference.run_inference, f32 and bf16: the heads finite, the
     f32 heads within HEADS_TOL of the plain kernel versions on those
     frames (deterministic algorithms), kernel 1 launched 2 times a frame
     and kernel 2 BASELINE_LAUNCHES times, Where2comm's comm_rate in
     (0, 1]; the fusion module's own time (CUDA events) and its share of
     the forward; then one warm and two timed f32 train steps through
     parallel.Trainer and a warm and a timed bf16 step (finite loss, a
     nonzero gradient in every fusion parameter but the softmax shifts,
     whose gradient is zero by construction, see no_gradient; kernel 2's
     backward
     counter rising, kernel 1's not moving), ms/step and peak memory;
  8. the fusion timings: HEAL's late and early fusion and the
     homogeneous PointPillars table on the published
     heal_tpu/configs/opv2v/ configs at full width, seeded random
     weights, synthetic scenes with the flagship's scene arguments,
     TIMING_FRAMES test frames each (assembled and copied once) served f32
     and bf16 through tools.inference.run_inference (mean, median and
     range of the frames after the first; one more f32 frame traced with
     torch.profiler for the card's busy and idle share of it), the f32
     heads of every forward within HEADS_TOL of the plain kernel versions:
     lidar_only/late_fusion.yaml (point_pillar, one forward per agent
     sample, kernel 1 launched once per forward, kernel 2 never) and
     lidar_only/early_fusion.yaml (kernel 1 once a frame), each then a
     warm and TIMING_STEPS timed train steps at the published batch with
     the published augmentation (kernel 1 never launched in training);
     the late-heter protocol: one train step after a warm one of each
     single/m{1,2,3,4}_pretrain.yaml at the published batch (no
     supervise_single on late fusion), m1 and m2 merged by
     tools.merge.merge_final into more_modality/m1m2_lateheter.yaml
     (strict load, no entry left out) and served (kernel 1 once per
     forward: the m1 branch runs on every sample); the ten
     lidar_only/{max, att, disconet, v2vnet, where2comm, cobevt, v2xvit,
     who2com, when2com, transformer}.yaml on point_pillar_baseline, one
     set of frames for all (kernel 1 once a frame, kernel 2
     LIDAR_SHIFT_LAUNCHES a frame), then a warm and a timed f32 train
     step at LIDAR_BATCH (published 4; every fusion parameter with a
     nonzero gradient but the softmax shifts, kernel 2 forward and
     backward launched); per
     config serve ms a frame, step ms, peak memory and the launches;
  9. pose error and bandwidth, on the published heal_tpu/configs/opv2v/
     configs at full width, seeded random weights, synthetic scenes with
     the flagship's scene arguments, POSE_FRAMES test frames: CoAlign on
     lidar_only/coalign.yaml (heter_model_baseline_ms, att at two
     levels): tools/pose_graph_pre_calc.py's CLI on the card in both
     paths, its one-agent scenes for coalign.yaml and padded presorted
     points for the uncertainty detector (point_pillar_uncertainty on
     lidar_only/late_fusion.yaml derived: model and loss switched; the
     repo publishes no config for it), each dump one entry per scene
     agent with 3 uncertainty values a box for the detector, kernel 1 once
     a forward (kernel 2 10 times for coalign.yaml); the detector's heads
     and unc_preds within HEADS_TOL of the plain kernel versions; a dump
     from the ground truth, and coalign.yaml's frames at pose noise
     POSE_NOISE assembled without and with box alignment from the same
     seed: the aligned pairwise affines at least 2x closer to the clean
     ones than the noisy ones, both served (serve ms a frame each, the
     host's box-align ms a frame apart, heads vs plain), then one level
     of tools/inference_w_noise.run_noise_sweep with box_align_precalc;
     the compressor finetune of heal/stage1/m1_pyramid_compress.yaml:
     a seeded heal/stage1/m1_pyramid.yaml base saved as .pth, loaded by
     tools/train.build_trainer's init_from (every base key taken, only
     compressor.* left), a warm and a timed f32 step at the published
     batch (ms, peak memory; every frozen parameter and batch-norm
     buffer bit-equal, every compressor parameter moved; a step
     launches kernel 1 once, in the frozen branch's eval-mode encoder,
     and kernel 2 15 times forward and 15 backward), then served f32 and
     bf16 (kernel 1 once and kernel 2 15 times a frame, heads vs plain);
 10. the anchor-free and SECOND intermediate detectors, on the published
     heal_tpu/configs/opv2v/lidar_only/center_point_where2comm.yaml
     (CenterPoint with Where2comm, max_cav 5) and
     heal_tpu/configs/dairv2x/second_coalign.yaml (second_intermediate
     with att over 0.1 m voxels, max_cav 2, its scenes 2 agents: a
     vehicle and a roadside unit) at full width, seeded random weights,
     synthetic scenes with the flagship's scene arguments: both kernels
     on each path's own inputs against their plain versions (kernel 1 on
     CenterPoint's first frame, kernel 2 at the fusion warp's canvases
     and crops, forward and backward), AF_FRAMES test frames served f32
     and bf16 through tools.inference.run_inference (anchor-free decode
     for CenterPoint, its comm_rate), the exact launches a frame
     (AF_LAUNCHES), the f32 heads within HEADS_TOL of the plain kernel
     versions, then a warm and a timed f32 train step at the published
     batch AF_BATCH (finite loss, every trainable parameter moved but
     the softmax shifts, which need only a gradient; kernel 2 as often
     backward as forward, kernel 1 never), ms and peak memory;
 11. the input pipeline: epochs of heal_tpu/configs/demo_heal_full/
     stage2_m2.yaml (PIPELINE_SCENES train scenes) timed on the host
     clock, batches assembled serially, through the prefetch pipeline
     (tools/train.py, data/prefetch.py), and from the device cache of
     cache_device_batches.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. The script imports torch and heal_tpu_torch
only; configs and batches come through heal_tpu_torch.tools.train.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import torch

# the port comes from this checkout: the script fails here, before it
# prints anything, when it stands alone
from heal_tpu_torch.kernels.cases import (branch_frame_inputs, dense_inputs,
                                          frame_inputs, pillar_work)
from heal_tpu_torch.kernels.measure import (bound, device_busy, device_kernels,
                                           device_ms)

SEED = 0
FRAMES = 8

# tolerances, as max |kernel - plain| <= tol * (1 + max |plain|):
#   f32: kernel 1 sums in another order than scatter_reduce -> a few f32
#   ulps; kernel 2 (built without FMA contraction) rounds as its plain
#   version does;
#   bf16: both blend and reduce in f32, then round to bf16 -> at most
#   one bf16 ulp apart (2^-8 relative).
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# f32 heads, kernels vs plain versions on the card: the ulp-level kernel
# differences pass through ~40 convolutions (TF32 off both times)
HEADS_TOL = 1e-4
# f32 train step, kernels vs plain versions on the card, loss and every
# gradient leaf as max |d| / (1 + max |ref|): both steps run with
# deterministic algorithms, and kernel 2 (built without FMA contraction)
# rounds as its plain version does in both directions, so the two steps
# should agree to the bit; the bound leaves room for an op that has no
# deterministic CUDA implementation (listed when the run meets one). Not
# deterministic, two runs of the same step differ by ~7e-3 in a gradient
# leaf (7.4e-3 on an H100): batch norm in train mode amplifies the order
# of atomic sums.
TRAIN_TOL = {"loss": 1e-6, "grad": 1e-6}
TRAIN_STEPS = 6
TRACE_TRIES = 3  # torch.profiler sessions to find kernel 1's one launch

# the protocol phase: published configs (heal_tpu/configs/opv2v/heal/)
PROTOCOL_CFGS = {"stage1": "stage1/m1_pyramid.yaml",
                 "stage2": "stage2/m4_alignto_m1.yaml",
                 "stage2_m2": "stage2/m2_alignto_m1.yaml",
                 "stage2_m3": "stage2/m3_alignto_m1.yaml",
                 "final": "final_infer/m1m2m3m4.yaml"}
# the new agent types of stage 2: config key -> branch
STAGE2_TYPES = {"stage2": "m4", "stage2_m2": "m2", "stage2_m3": "m3"}
# the served alliance: every agent type of the final config (the cut,
# config.keep_modalities, serves fewer)
ALLIANCE = ("m1", "m2", "m3", "m4")
PROTOCOL_FRAMES = 6
# synthetic scenes (train, test): stage 1 takes STAGE1_STEPS steps of
# STAGE1_BATCH; stage 2 one epoch at its published batch of 4 (2 steps)
# and one validation batch; the alliance serves PROTOCOL_FRAMES frames
PROTOCOL_SCENES = {"stage1": (4, 4), "stage2": (8, 4), "stage2_m2": (8, 4),
                   "stage2_m3": (8, 4), "final": (4, PROTOCOL_FRAMES)}
STAGE1_BATCH = 2  # published 4: two f32 steps are enough for a base
STAGE1_STEPS = 2
STAGE2_STEPS = 4  # timed stage-2 steps after a warm one
# launches of each kernel a served alliance frame: kernel 1 once per
# PointPillars branch (m1, m4); kernel 2 in weighted_fuse (3 levels x 5);
# the SECOND (m3) and camera (m2) branches launch neither
ALLIANCE_LAUNCHES = {"pillar_tables": 2, "shift_rows": 15}
# the SECOND encoder on the card vs on the CPU, one frame: f32 features
# as max |d| / (1 + max |cpu|) (GEMMs and segment sums in another order)
SECOND_CPU_TOL = 1e-5
# the baselines phase: the published heterogeneous baselines
# (heal_tpu/configs/opv2v/more_modality/m1m2m3m4_<name>.yaml)
BASELINES = ("fcooper", "att", "disconet", "v2vnet", "where2comm", "cobevt",
             "v2xvit", "coalign")
BASELINE_FRAMES = 4
BASELINE_BATCH = 2  # published 4
BASELINE_STEPS = 2  # timed f32 steps after a warm one
# kernel-2 launches a served baseline frame: each warp call is one
# 3-shear warp of all its maps, 5 launches (3 shears and 2 remainder
# shifts); one ego warp per fusion call, V2VNet's field-of-view warp and
# num_iteration 2 pairwise warps, CoAlign's two fused levels. Kernel 1
# runs once per PointPillars branch (m1, m4)
BASELINE_LAUNCHES = {"fcooper": 5, "att": 5, "disconet": 5, "v2vnet": 15,
                     "where2comm": 5, "cobevt": 5, "v2xvit": 5, "coalign": 10}
BASELINE_PILLAR_LAUNCHES = 2
# phase 8: the published demo config's first PIPELINE_SCENES train scenes
# (of 384) at its batch of 2
PIPELINE_CFG = "demo_heal_full/stage2_m2.yaml"
PIPELINE_SCENES = 24
# the fusion timings phase (heal_tpu/configs/opv2v/): late and early
# fusion of point_pillar, the late-heter protocol (each type's single
# detector, the m1+m2 merge) and the lidar-only point_pillar_baseline
# table; TIMING_FRAMES test frames each, the published batch of 4 for
# late, early and the singles, LIDAR_BATCH for the baselines
TIMING_CFGS = {"late": "lidar_only/late_fusion.yaml",
               "early": "lidar_only/early_fusion.yaml"}
SINGLE_CFGS = {m: f"single/{m}_pretrain.yaml" for m in ("m1", "m2", "m3",
                                                         "m4")}
LATE_HETER_CFG = "more_modality/m1m2_lateheter.yaml"
LIDAR_BASELINES = ("max", "att", "disconet", "v2vnet", "where2comm",
                   "cobevt", "v2xvit", "who2com", "when2com", "transformer")
TIMING_FRAMES = 12
TIMING_BATCH = 4  # published
TIMING_STEPS = 2  # timed steps after a warm one (late, early)
LIDAR_BATCH = 2  # published 4
# kernel-2 launches a served lidar-only baseline frame: 5 a warp call
# (one ego warp; V2VNet's field-of-view and two pairwise warps; the
# transformer's feature and region-of-interest warps). Kernel 1 runs once
# a frame (the encoder sees every agent slot in one call); late fusion
# launches it once per agent forward, early fusion once a frame
LIDAR_SHIFT_LAUNCHES = {**{n: 5 for n in LIDAR_BASELINES}, "v2vnet": 15,
                        "transformer": 10}
# the pose error and bandwidth phase (heal_tpu/configs/opv2v/): CoAlign on
# lidar_only/coalign.yaml with its stage-1 detector, point_pillar_
# uncertainty on a config derived from lidar_only/late_fusion.yaml (the
# repo publishes none: core_method and loss switched, pose_cfgs), and
# the compressor finetune of heal/stage1/m1_pyramid_compress.yaml from a
# seeded heal/stage1/m1_pyramid.yaml base; POSE_FRAMES test frames each
POSE_CFGS = {"coalign": "lidar_only/coalign.yaml",
             "uncertainty": "lidar_only/late_fusion.yaml",
             "base": "heal/stage1/m1_pyramid.yaml",
             "compress": "heal/stage1/m1_pyramid_compress.yaml"}
POSE_FRAMES = 4
POSE_NOISE = 0.6  # pos (m) and rot (deg) std, the sweep's top level
POSE_SEED = 303
COMPRESS_BATCH = 4  # published
# (kernel 1, kernel 2) launches a forward: coalign.yaml's one PointPillars
# branch and its two fused levels (5 a warp call), on every pre-calc
# one-agent forward too; the detector's encoder; the compressed Pyramid's
# encoder and weighted_fuse (3 levels x 5), in a finetune step too (its
# frozen encoder runs in eval mode; kernel 2 backward as often)
POSE_LAUNCHES = {"coalign": (1, 10), "uncertainty": (1, 0),
                 "compress": (1, 15)}
# phase 10: the anchor-free CenterPoint and DAIR-V2X's SECOND detector,
# published configs at full width (heal_tpu/configs/...)
AF_CFGS = {"center_point": "opv2v/lidar_only/center_point_where2comm.yaml",
           "second": "dairv2x/second_coalign.yaml"}
AF_FRAMES = 6
AF_BATCH = 4  # published
AF_AGENTS = {"second": 2}  # DAIR-V2X-C: one vehicle, one roadside unit
# (kernel 1, kernel 2) launches a forward, counted from the code: kernel 1
# once in CenterPoint's eval encoder (all B*L agents in one call) and
# never in SECOND; kernel 2 five times a warp_agents_to_ego (three shears
# and two integer shifts), the where2comm or att fusion's one warp. A
# train step launches kernel 2 as often again backward, kernel 1 never
AF_LAUNCHES = {"center_point": (1, 5), "second": (0, 5)}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, that over 1 + max |b|)."""
    d = (a.float() - b.float()).abs().max().item()
    return d, d / (1.0 + b.float().abs().max().item())


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the kernels' plain PyTorch versions (for the
    reference run only): kernel 1's wrapper is swapped at module level, and
    kernel 2's one-direction launcher, which its autograd function calls
    forward with s and backward with -s."""
    from heal_tpu_torch.ops import pillar, shift_rows

    saved = (pillar.pillar_tables, shift_rows._shift)
    pillar.pillar_tables = pillar.pillar_tables_plain
    shift_rows._shift = lambda x, s, m, axis, backward=False: (
        shift_rows.shift_rows_plain if axis == 0
        else shift_rows.shift_cols_plain)(x, s, m)
    try:
        yield
    finally:
        pillar.pillar_tables, shift_rows._shift = saved


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from heal_tpu_torch.kernels import build

    t0 = time.perf_counter()
    build.library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.3f} s")
    for line in build.build_log().splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")


def flagship_cfg():
    from heal_tpu_torch.tools.train import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(root, "heal_tpu", "configs",
                                   "opv2v_m1_pyramid.yaml"))
    cfg["fusion"]["args"]["num_scenes_test"] = FRAMES
    return cfg


def protocol_cfgs() -> dict:
    """The protocol phase's published configs at full width, read
    through the port's loader: the synthetic backend with the flagship's
    scene arguments (4 agents, 14 vehicles) and PROTOCOL_SCENES scenes;
    stage 1 at STAGE1_BATCH; the camera's stage 2 with its batches cached
    on the card; the final config with the ALLIANCE types."""
    from heal_tpu_torch.config import keep_modalities
    from heal_tpu_torch.tools.train import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    scene_args = flagship_cfg()["fusion"]["args"]
    out = {}
    for name, rel in PROTOCOL_CFGS.items():
        cfg = load_config(os.path.join(root, "heal_tpu", "configs", "opv2v",
                                       "heal", rel))
        n_train, n_test = PROTOCOL_SCENES[name]
        cfg["fusion"]["dataset"] = "synthetic"
        cfg["fusion"]["args"] = dict(scene_args, num_scenes_train=n_train,
                                     num_scenes_test=n_test)
        out[name] = cfg
    out["stage1"]["train_params"]["batch_size"] = STAGE1_BATCH
    out["stage2_m2"]["train_params"]["cache_device_batches"] = True
    keep_modalities(out["final"], ALLIANCE)
    return out


def phase_kernels(cfg, model32, final_cfg) -> dict:
    """Kernel vs plain at flagship shapes (and kernel 1 on the first frame
    of ``final_cfg``'s m1+m4 alliance through its m4 encoder); returns the
    JSON rows' numbers (all but the launches)."""
    from heal_tpu_torch.tools.inference import build_weights
    from heal_tpu_torch.tools.train import device_batches

    dev = torch.device("cuda")
    rows = {}

    # kernel 1: (a) the encoder's inputs on the first flagship frame; (b) a
    # frame as dense as OPV2V lidar on the same grid (every point real,
    # 20000 pillars a slot of 1-32 points); (c) the first frame of the
    # m1+m4 alliance through its 16-line m4 encoder (seeded weights; its
    # config leaves presorted false, so the ids are sorted on the card).
    # Each call must launch exactly one device kernel and never sync the
    # host.
    batch, _ = next(device_batches(cfg, 1, dev, train=False))
    pts = batch["inputs_m1"]["points"][0]
    msk = batch["inputs_m1"]["point_mask"][0]
    enc = model32.branch_m1.encoder
    alliance = build_weights(final_cfg, seed=SEED).to(dev)
    fbatch, _ = next(device_batches(final_cfg, 1, dev, train=False))
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for name, args in (
            ("frame", frame_inputs(enc, pts, msk, dt)),
            ("dense", dense_inputs(enc.grid(), pts.shape[0],
                                   enc.out_channels, dt, dev, SEED,
                                   points=pts.shape[1])),
            ("m4 frame", branch_frame_inputs(alliance, fbatch, "m4", dt)),
        ):
            cases.append(pillar_case(name, args, dt))
    del alliance
    print("[kernel] pillar_tables bytes as counted before (all of u, g4 and "
          "fi, padding and drop bucket included): " + ", ".join(
              f"{c['case']} {c['dtype']} {c['bytes_all']} (bound "
              f"{bound(c['bytes_all'], 0)[0]:.4f} ms)" for c in cases))
    # the row's numbers: the bf16 frame, as the bf16 serve path calls it;
    # every case is in "cases"
    head = next(c for c in cases if c["case"] == "frame"
                and c["dtype"] == "bfloat16")
    rows["pillar_tables"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, bytes=head["bytes"],
        pct_of_bound=head["pct_of_bound"], cases=cases)

    # kernel 2: the pyramid warp's canvases (4 non-ego agents; level sides
    # 292 / 148 / 76 with C = 65 / 129 / 257), shear-sized shifts; each
    # case forward (s) and backward (the kernel with -s on a gradient)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = worst_bwd = 0.0
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for side, c in ((292, 65), (148, 129), (76, 257)):
            ms_bound = int(math.ceil(0.7072 * side / 2)) + 2
            x = torch.randn((4, side, side, c), generator=gen, device=dev
                            ).to(dt)
            s = (torch.rand((4, side), generator=gen, device=dev) * 2 - 1
                 ) * ms_bound
            for name in ("rows", "cols"):
                got = shift_case(x, s, ms_bound, name, gen)
                worst = max(worst, got[0]["max_abs_err"])
                worst_bwd = max(worst_bwd, got[1]["max_abs_err"])
                cases += got
    # the row's numbers: f32 level 0 rows forward, as the f32 serve path
    # calls it; every case is in "cases". Not a bf16 case: grid_sample
    # takes its grid in x's dtype, and a bf16 grid cannot hold the
    # coordinates, so there it does not compute the same function
    head = next(c for c in cases if c["dtype"] == "float32"
                and c["x"][1] == 292 and c["axis"] == "rows"
                and c["direction"] == "forward")
    rows["shift_rows"] = dict(
        max_abs_err=worst, backward_max_abs_err=worst_bwd, ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by="bytes", library_ms=head["library_ms"],
        bytes=head["bytes"], pct_of_bound=head["pct_of_bound"], cases=cases)
    return rows


def pillar_case(name, args, dt) -> dict:
    """Kernel 1 on one input against its plain version (tolerance
    KERNEL_TOL), held to one device kernel and no host sync a call, with
    both device times, the canvas's fill, the bytes and the bound."""
    from heal_tpu_torch.ops import pillar

    got = pillar.pillar_tables(*args)
    want = pillar.pillar_tables_plain(*args)
    torch.cuda.synchronize()
    d, r = rel_err(got, want)
    if not r <= KERNEL_TOL[dt]:
        raise AssertionError(f"pillar_tables {name} {dt} disagrees: {r}")
    # CUPTI now and then hands back empty traces for the rest of a
    # session (PERF.md §7): trace again then, and after TRACE_TRIES empty
    # ones in a fresh process; a trace that holds anything must hold
    # exactly the one kernel
    for traces in range(1, TRACE_TRIES + 1):
        launched = device_kernels(lambda: pillar.pillar_tables(*args))
        if launched:
            break
    else:
        launched = trace_in_fresh_process(args)
        traces = f"{TRACE_TRIES} empty, then one in a fresh process"
    if len(launched) != 1 or "pillar_tables" not in launched[0]:
        raise AssertionError(f"pillar_tables {name} {dt}: one call put "
                             f"{launched} on the card ({traces} traces)")
    ms = device_ms(lambda: pillar.pillar_tables(*args))
    plain_ms = device_ms(lambda: pillar.pillar_tables_plain(*args))
    # the floor of any version: filling the same canvas with zeros
    fill_ms = device_ms(got.zero_)
    work = pillar_work(args)
    b_ms, b_by = bound(work["bytes"], work["flops"])
    u = args[0]
    print(f"[kernel] pillar_tables {name} {str(dt)[6:]} u {tuple(u.shape)} "
          f"({work['landed']} points in {work['runs']} pillars land) canvas "
          f"{tuple(got.shape)}: max_abs_err {d:.3e} (rel {r:.3e}, tol "
          f"{KERNEL_TOL[dt]}), {ms:.4f} ms vs plain {plain_ms:.4f} ms; one "
          f"kernel, no sync ({traces} trace{'' if traces == 1 else 's'}); "
          f"{work['bytes']} bytes, bound {b_ms:.4f} ms "
          f"({b_by}), {100 * b_ms / ms:.1f}% of bound; library call: none; "
          f"the canvas's fill by zero_ {fill_ms:.4f} ms")
    return dict(
        case=name, dtype=str(dt)[6:], u=list(u.shape), landed=work["landed"],
        runs=work["runs"], max_abs_err=d, ms=ms, plain_ms=plain_ms,
        fill_ms=fill_ms, bytes=work["bytes"], bytes_all=work["bytes_all"],
        bound_ms=b_ms, bound_by=b_by, pct_of_bound=100 * b_ms / ms)


_TRACE = """
import json, sys, torch
from heal_tpu_torch.kernels.measure import device_kernels
from heal_tpu_torch.ops import pillar
args = torch.load(sys.argv[1], weights_only=False)
print(json.dumps(device_kernels(lambda: pillar.pillar_tables(*args))))
"""


def trace_in_fresh_process(args) -> list[str]:
    """``device_kernels`` of one kernel-1 call on ``args`` (saved to a
    temporary file) in a new Python process with its own CUPTI session."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "args.pt")
        torch.save(list(args), path)
        proc = subprocess.run([sys.executable, "-c", _TRACE, path], cwd=root,
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=root))
    if proc.returncode != 0:
        raise AssertionError(f"the fresh trace failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def library_shift(x, s, axis, want) -> dict:
    """The yardstick for kernel 2: one ``F.grid_sample`` call (bilinear,
    zero padding, align_corners=True) on x viewed as NCHW, with a grid
    built beforehand whose x is j + s (rows) or whose y is i + s
    (columns). Only the call is timed; its largest difference from the
    plain version is reported (a bf16 grid cannot hold the coordinates
    exactly). The port never calls it."""
    import torch.nn.functional as F

    n, h, w, _ = x.shape
    i = torch.arange(h, device=x.device, dtype=torch.float32)[:, None]
    j = torch.arange(w, device=x.device, dtype=torch.float32)[None, :]
    if axis == 0:
        gx, gy = j + s[:, :, None], i.expand(h, w).expand(n, h, w)
    else:
        gx, gy = j.expand(h, w).expand(n, h, w), i + s[:, None, :]
    grid = torch.stack([2 * gx / (w - 1) - 1, 2 * gy / (h - 1) - 1],
                       dim=-1).to(x.dtype)
    src = x.permute(0, 3, 1, 2)

    def call():
        return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    err = (call().permute(0, 2, 3, 1).float() - want.float()).abs().max()
    return dict(library_ms=device_ms(call), library_err=err.item())


def shift_backward(x, s, ms_bound, fn, plain, gen, axis) -> dict:
    """Kernel 2's backward against the plain backward plain(g, -s) on one
    shape: the error through autograd, the time of the backward launch
    (the kernel with -s; autograd also negates the shifts, a separate
    elementwise op), the grid_sample yardstick with -s, and for
    information autograd through the plain forward."""
    from heal_tpu_torch.ops import shift_rows

    g = torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)
    xr = x.detach().clone().requires_grad_()
    (got,) = torch.autograd.grad(fn(xr, s, ms_bound), xr, g)
    want = plain(g, -s, ms_bound)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    yp = plain(xr, s, ms_bound)
    neg = -s
    return dict(
        err=err, rel=rel,
        ms=device_ms(lambda: shift_rows._shift(g, neg, ms_bound, axis,
                                             backward=True)),
        plain_ms=device_ms(lambda: plain(g, neg, ms_bound)),
        autograd_ms=device_ms(
            lambda: torch.autograd.grad(yp, xr, g, retain_graph=True)),
        **library_shift(g, neg, axis, want),
    )


def shift_case(x, s, ms_bound, name: str, gen, what: str = "") -> list:
    """Kernel 2 along ``name`` ("rows" or "cols") on x with shifts s,
    forward and backward, against the plain versions (tolerance
    KERNEL_TOL), with both device times, the bytes and the bound and the
    grid_sample yardstick; printed, -> the two cases."""
    from heal_tpu_torch.ops import shift_rows

    dt = x.dtype
    axis = 0 if name == "rows" else 1
    fn, plain = ((shift_rows.shift_rows, shift_rows.shift_rows_plain)
                 if axis == 0 else
                 (shift_rows.shift_cols, shift_rows.shift_cols_plain))
    got = fn(x, s, ms_bound)
    want = plain(x, s, ms_bound)
    torch.cuda.synchronize()
    d, r = rel_err(got, want)
    if not r <= KERNEL_TOL[dt]:
        raise AssertionError(f"shift_{name} {what}{dt} {tuple(x.shape)}: {r}")
    fwd = dict(
        err=d, rel=r, ms=device_ms(lambda: fn(x, s, ms_bound)),
        plain_ms=device_ms(lambda: plain(x, s, ms_bound)),
        **library_shift(x, s, axis, want))
    bwd = shift_backward(x, s, ms_bound, fn, plain, gen, axis)
    if not bwd["rel"] <= KERNEL_TOL[dt]:
        raise AssertionError(f"shift_{name} backward {what}{dt} "
                             f"{tuple(x.shape)}: {bwd['rel']}")
    nbytes = 2 * x.numel() * x.element_size() + s.numel() * 4
    b_ms, b_by = bound(nbytes, 3 * x.numel())
    cases = []
    for direction, m in (("forward", fwd), ("backward", bwd)):
        print(f"[kernel] {what}shift_{name} {direction} {str(dt)[6:]} x "
              f"{tuple(x.shape)}: max_abs_err {m['err']:.3e} (rel "
              f"{m['rel']:.3e}, tol {KERNEL_TOL[dt]}), "
              f"{m['ms']:.4f} ms vs plain {m['plain_ms']:.4f} ms; "
              f"{nbytes} bytes, bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / m['ms']:.1f}% of bound; grid_sample "
              f"{m['library_ms']:.4f} ms (max abs diff from plain "
              f"{m['library_err']:.3e})"
              + (f"; autograd through the plain forward "
                 f"{m['autograd_ms']:.4f} ms" if "autograd_ms" in m else ""))
        cases.append(dict(
            dtype=str(dt)[6:], x=list(x.shape), axis=name,
            direction=direction, max_abs_err=m["err"], ms=m["ms"],
            plain_ms=m["plain_ms"], library_ms=m["library_ms"],
            library_err=m["library_err"], bytes=nbytes, bound_ms=b_ms,
            pct_of_bound=100 * b_ms / m["ms"]))
    return cases


def phase_serve(cfg, model32) -> dict:
    import numpy as np

    from heal_tpu_torch.ops import pillar, shift_rows
    from heal_tpu_torch.ops.warp import warp_agents_to_ego
    from heal_tpu_torch.tools.inference import run_inference
    from heal_tpu_torch.tools.train import device_batches

    model16 = copy.deepcopy(model32).to(torch.bfloat16)

    pillar.pillar_tables.launches = 0
    shift_rows.shift_rows.launches = 0
    r32 = run_inference(cfg=cfg, device="cuda", dtype=torch.float32,
                        model=model32, collect_heads=True)
    r16 = run_inference(cfg=cfg, device="cuda", dtype=torch.bfloat16,
                        model=model16, collect_heads=True)
    launches = {"pillar_tables": pillar.pillar_tables.launches,
                "shift_rows": shift_rows.shift_rows.launches}
    print(f"[serve] kernel launches while serving: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched while serving")

    with plain_kernels():
        ref = run_inference(cfg=cfg, device="cuda", dtype=torch.float32,
                            model=model32, collect_heads=True)
    if (pillar.pillar_tables.launches, shift_rows.shift_rows.launches) != (
            launches["pillar_tables"], launches["shift_rows"]):
        raise AssertionError("the plain reference run launched a kernel")

    want = {"cls_preds": (1, 128, 256, 2), "reg_preds": (1, 128, 256, 14),
            "dir_preds": (1, 128, 256, 4)}
    worst = 0.0
    for i, (a, b, h16) in enumerate(zip(r32["heads"], ref["heads"],
                                        r16["heads"])):
        for k, shape in want.items():
            for t in (a[k], b[k], h16[k]):
                if tuple(t.shape) != shape or not torch.isfinite(t).all():
                    raise AssertionError(f"frame {i} {k}: bad output")
            d, r = rel_err(a[k], b[k])
            worst = max(worst, r)
    print(f"[serve] f32 heads, kernels vs plain on the card, {FRAMES} "
          f"frames: max rel err {worst:.3e} (tol {HEADS_TOL})")
    if not worst <= HEADS_TOL:
        raise AssertionError(f"f32 heads disagree with the plain run: {worst}")
    d16 = max(rel_err(h16[k], a[k])[1] for a, h16 in
              zip(r32["heads"], r16["heads"]) for k in want)
    print(f"[serve] bf16 vs f32 heads (information): max rel err {d16:.3e}")

    fps = {}
    for name, r in (("f32", r32), ("bf16", r16), ("f32 plain", ref)):
        steady = r["serve_s"][1:]
        fps[name] = len(steady) / sum(steady)
        print(f"[serve] {name}: {fps[name]:.3f} frames/s over {len(steady)} "
              f"frames after the first ({np.mean(steady) * 1e3:.3f} ms/frame;"
              f" first {r['serve_s'][0] * 1e3:.1f} ms; host data "
              f"{np.mean(r['data_s']) * 1e3:.1f} ms/frame not included); "
              f"ap_30 {r['ap_30']:.4f}")

    # exact vs shear warp at pyramid level 0 (5 agent slots, 128x256,
    # 64 features + score) on a real frame's affines
    batch, _ = next(device_batches(cfg, 1, "cuda", train=False))
    aff = batch["pairwise_affine"]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dt in (torch.float32, torch.bfloat16):
        feats = torch.randn((1, 5, 128, 256, 65), generator=gen,
                            device="cuda").to(dt)
        t_ex = device_ms(
            lambda: warp_agents_to_ego(feats, aff, method="exact"))
        t_sh = device_ms(
            lambda: warp_agents_to_ego(feats, aff, method="shear"))
        print(f"[warp] level-0 warp_agents_to_ego {str(dt)[6:]}: exact "
              f"{t_ex:.4f} ms, shear {t_sh:.4f} ms")
    return launches


def _grad_leaves(model) -> dict:
    return {k: p.grad.detach().float().clone()
            for k, p in model.named_parameters()}


def phase_train(cfg, model32) -> dict:
    """Train steps on the flagship config; returns kernel 2's train-phase
    launch counts."""
    from heal_tpu_torch.models import build_loss
    from heal_tpu_torch.ops import pillar, shift_rows
    from heal_tpu_torch.parallel import Trainer, build_optimizer
    from heal_tpu_torch.tools.train import device_batches

    dev = torch.device("cuda")
    bs = cfg["train_params"]["batch_size"]
    batches = device_batches(cfg, bs, dev, train=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch, data_s = next(batches)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0 - data_s
    print(f"[train] flagship batch of {bs}: host data {data_s * 1e3:.1f} ms, "
          f"h2d {h2d_s * 1e3:.2f} ms (neither is in ms/step)")

    def trainer(bf16=False):
        model = copy.deepcopy(model32).train()
        opt, schedule = build_optimizer(
            model.parameters(), cfg["optimizer"], cfg.get("lr_scheduler"),
            max(cfg["fusion"]["args"]["num_scenes_train"] // bs, 1))
        return Trainer(
            model, build_loss(cfg["loss"]), opt, schedule,
            supervise_single=cfg["model"]["args"]["supervise_single"],
            single_weight=cfg["loss"]["args"].get("single_weight", 1.0),
            bf16=bf16)

    def timed_step(tr):
        torch.cuda.synchronize()
        t = time.perf_counter()
        aux = tr.train_step(batch)
        torch.cuda.synchronize()
        return aux, time.perf_counter() - t

    # f32 (TF32 off): one step through the plain versions, then two
    # through the kernels (the second gives the run-to-run noise)
    before = (pillar.pillar_tables.launches, shift_rows.shift_rows.launches,
              shift_rows.shift_rows.backward_launches)
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with plain_kernels():
            tr_plain = trainer()
            aux_plain, _ = timed_step(tr_plain)
        if before != (pillar.pillar_tables.launches,
                      shift_rows.shift_rows.launches,
                      shift_rows.shift_rows.backward_launches):
            raise AssertionError("the plain reference step launched a kernel")
        ref = _grad_leaves(tr_plain.model)
        del tr_plain
        pillar.pillar_tables.launches = 0
        shift_rows.shift_rows.launches = 0
        shift_rows.shift_rows.backward_launches = 0
        runs = []
        for _ in range(2):
            tr = trainer()
            aux, _ = timed_step(tr)
            runs.append((aux, _grad_leaves(tr.model)))
    torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    print(f"[train] ops without a deterministic CUDA implementation in the "
          f"compared steps: {nondet or 'none'}")
    worst = {"loss": 0.0, "grad": 0.0}
    for aux, grads in runs:
        for k, v in aux_plain.items():
            worst["loss"] = max(worst["loss"], rel_err(aux[k], v)[1])
        for k, v in ref.items():
            worst["grad"] = max(worst["grad"], rel_err(grads[k], v)[1])
    noise = max(rel_err(runs[0][1][k], runs[1][1][k])[1] for k in ref)
    print(f"[train] f32 step, kernels vs plain on the card: loss max rel "
          f"{worst['loss']:.3e} (tol {TRAIN_TOL['loss']}), gradients max "
          f"|d|/(1+max|ref|) {worst['grad']:.3e} over {len(ref)} leaves (tol "
          f"{TRAIN_TOL['grad']}); kernel run vs kernel run {noise:.3e}")
    for name in ("loss", "grad"):
        if not worst[name] <= TRAIN_TOL[name]:
            raise AssertionError(f"f32 train step {name} disagrees with the "
                                 f"plain run: {worst[name]}")

    # more steps on the repeated batch (tr has taken one already)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [float(runs[-1][0]["total_loss"])], []
    for _ in range(TRAIN_STEPS - 1):
        aux, dt = timed_step(tr)
        losses.append(float(aux["total_loss"]))
        times.append(dt)
    peak32 = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] f32 losses over {TRAIN_STEPS} steps: "
          + ", ".join(f"{x:.4f}" for x in losses))
    print("[train] f32 last step terms: " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in sorted(aux.items())))
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"f32 training loss is not finite and falling: "
                             f"{losses}")
    ms32 = 1e3 * sum(times[1:]) / len(times[1:])
    print(f"[train] f32: {ms32:.3f} ms/step, {bs / ms32 * 1e3:.3f} samples/s "
          f"(mean of {len(times) - 1} steps after the first timed one), peak "
          f"memory {peak32:.3f} GiB")
    del tr, runs

    # the bf16 policy: f32 master weights, bf16 compute, f32 BN buffers
    tr = trainer(bf16=True)
    torch.cuda.reset_peak_memory_stats()
    out16 = [timed_step(tr) for _ in range(2)]
    peak16 = torch.cuda.max_memory_allocated() / 2**30
    l16 = [float(a["total_loss"]) for a, _ in out16]
    bufs = {b.dtype for b in tr.model.buffers()}
    params = {p.dtype for p in tr.model.parameters()}
    print(f"[train] bf16 losses {l16[0]:.4f}, {l16[1]:.4f}; second step "
          f"{out16[1][1] * 1e3:.3f} ms ({bs / out16[1][1]:.3f} samples/s); "
          f"peak memory {peak16:.3f} GiB; buffers {bufs}, params {params}")
    print("[train] bf16 last step terms: " + ", ".join(
        f"{k} {float(v):.4f}" for k, v in sorted(out16[1][0].items())))
    if not all(math.isfinite(x) for x in l16):
        raise AssertionError(f"bf16 training loss is not finite: {l16}")
    if bufs != {torch.float32} or params != {torch.float32}:
        raise AssertionError("bf16 policy: buffers and master weights must "
                             "stay f32")

    # the launch counters of the training run
    launches = {"pillar_tables": pillar.pillar_tables.launches,
                "shift_rows": shift_rows.shift_rows.launches,
                "shift_rows_backward": shift_rows.shift_rows.backward_launches}
    print(f"[train] kernel launches while training: {launches}")
    if launches["pillar_tables"] != 0:
        raise AssertionError("kernel 1 was launched in training")
    if launches["shift_rows"] <= 0 or launches["shift_rows_backward"] <= 0:
        raise AssertionError("kernel 2 was not launched in both directions "
                             "while training")
    return launches


def _counts() -> dict:
    from heal_tpu_torch.ops import pillar, shift_rows

    return {"pillar_tables": pillar.pillar_tables.launches,
            "shift_rows": shift_rows.shift_rows.launches,
            "shift_rows_backward": shift_rows.shift_rows.backward_launches}


def _zero_counts() -> None:
    from heal_tpu_torch.ops import pillar, shift_rows

    pillar.pillar_tables.launches = 0
    shift_rows.shift_rows.launches = 0
    shift_rows.shift_rows.backward_launches = 0


def _shared(sd: dict) -> dict:
    """The modules stage 2 freezes and the merge takes from the base."""
    from heal_tpu_torch.tools.merge import DROP_FROM_NEW_TYPES

    return {k: v for k, v in sd.items()
            if k.split(".")[0] in DROP_FROM_NEW_TYPES}


def _same_shared(sd: dict, base: dict, what: str) -> int:
    got, want = _shared(sd), _shared(base)
    if got.keys() != want.keys() or not got:
        raise AssertionError(f"{what}: the shared modules' keys differ")
    bad = [k for k, v in got.items()
           if not torch.equal(v.detach().float().cpu(), want[k])]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} shared entries moved, "
                             f"e.g. {bad[:3]}")
    return len(got)


def phase_protocol(cfgs: dict) -> dict:
    """HEAL's stages 1-3 on the published configs at full width
    (:func:`protocol_cfgs`), then the alliance served; returns the
    launches and timings."""
    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.models import build_model
    from heal_tpu_torch.tools import checkpoint as ckpt_lib
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import run_inference
    from heal_tpu_torch.tools.inference_heter_in_order import run_in_order
    from heal_tpu_torch.tools.inference_w_noise import run_noise_sweep
    from heal_tpu_torch.tools.merge import merge_final

    import numpy as np

    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # stage 1: the m1 base, seeded, two f32 steps, a port checkpoint
        s1cfg, s1dir = cfgs["stage1"], os.path.join(tmp, "stage1_m1")
        os.makedirs(s1dir)
        save_yaml(s1cfg, os.path.join(s1dir, "config.yaml"))
        tr = train_tool.build_trainer(s1cfg, dev, STAGE1_STEPS)
        losses = [float(tr.train_step(b)["total_loss"]) for b, _ in
                  itertools.islice(train_tool.device_batches(
                      s1cfg, STAGE1_BATCH, dev), STAGE1_STEPS)]
        if len(losses) != STAGE1_STEPS or not all(map(math.isfinite,
                                                      losses)):
            raise AssertionError(f"stage 1 losses: {losses}")
        s1_path = ckpt_lib.save_checkpoint(s1dir, tr.model, 1, bestval=True)
        base = ckpt_lib.load_state_dict(s1_path)
        print(f"[protocol] stage 1 ({PROTOCOL_CFGS['stage1']}, batch "
              f"{STAGE1_BATCH}): losses {', '.join(f'{x:.4f}' for x in losses)}"
              f"; {len(base)} entries saved")
        del tr
        torch.cuda.empty_cache()

        # stage 2 through the CLI: each new type against the frozen base
        s2dirs = {}
        launches = {}
        for key, m in STAGE2_TYPES.items():
            s2dirs[m] = os.path.join(tmp, f"stage2_{m}")
            out.update(_stage2(cfgs[key], key, s2dirs[m], s1_path, base))
            launches = {k: launches.get(k, 0) + out[f"stage2_{m}_launches"][k]
                        for k in out[f"stage2_{m}_launches"]}
        torch.cuda.empty_cache()
        _zero_counts()
        out.update(phase_second(cfgs["stage2_m3"], s2dirs["m3"]))
        if any(_counts().values()):
            raise AssertionError("the SECOND checks launched a kernel")

        # stage 3: the merge, served as the m1+m2+m3+m4 alliance
        merged = os.path.join(tmp, "merged")
        merge_final(list(s2dirs.values()), s1dir, merged)
        final = cfgs["final"]
        save_yaml(final, os.path.join(merged, "config.yaml"))
        msd = ckpt_lib.load_state_dict(ckpt_lib.find_checkpoint(merged)[1])
        alliance = build_model(final["model"])
        if set(msd) != set(alliance.state_dict()):
            raise AssertionError("the merge's keys are not the alliance's")
        alliance.load_state_dict(msd, strict=True)
        _same_shared(msd, base, "the merge")
        print(f"[protocol] merge: {len(msd)} entries, exactly the "
              f"{'+'.join(ALLIANCE)} alliance's (strict load); shared "
              "modules bit-equal to stage 1")

        models = {dt: copy.deepcopy(alliance).to(device=dev, dtype=dt).to(
            memory_format=torch.channels_last)
            for dt in (torch.float32, torch.bfloat16)}
        _zero_counts()
        stages, sstages = {}, {}
        runs = {}
        for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            with camera_stages(models[dt], "m2") as stages[name], \
                    second_stages(models[dt], "m3") as sstages[name]:
                runs[name] = run_inference(merged, final, device="cuda",
                                           dtype=dt, model=models[dt],
                                           collect_heads=True)
        r32, r16 = runs["f32"], runs["bf16"]
        serve = _counts()
        frames = r32["frames"] + r16["frames"]
        want = {k: n * frames for k, n in ALLIANCE_LAUNCHES.items()}
        print(f"[protocol] alliance launches over {frames} frames: {serve}")
        if {k: serve[k] for k in want} != want:
            raise AssertionError(f"alliance launches {serve}, want {want}")
        # kernels vs plain versions on the same frames: the synthetic
        # rig draws its images from id(scene) (ROADMAP §3), so every
        # run_inference call serves other camera images. Both runs with
        # deterministic algorithms: the camera splat's index_add_
        # otherwise sums in atomic order (the information line below)
        frames = [b for b, _ in itertools.islice(train_tool.device_batches(
            final, 1, dev, train=False), PROTOCOL_FRAMES)]
        model = models[torch.float32]

        def heads():
            with torch.inference_mode():
                return [{k: v.float() for k, v in model(b).items()
                         if k in ("cls_preds", "reg_preds", "dir_preds")}
                        for b in frames]

        atomic = heads()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det = heads()
            compared = _counts()
            with plain_kernels():
                ref = heads()
        finally:
            torch.use_deterministic_algorithms(False)
        if _counts() != compared:
            raise AssertionError("the plain alliance run launched a kernel")
        del models, model, frames
        worst = noise = 0.0
        for i, (a, b, c) in enumerate(zip(det, ref, atomic)):
            for k in a:
                for t in (a[k], b[k], c[k]):
                    if t.shape[:3] != (1, 128, 256) or not torch.isfinite(
                            t).all():
                        raise AssertionError(f"alliance frame {i} {k}: bad")
                worst = max(worst, rel_err(a[k], b[k])[1])
                noise = max(noise, rel_err(c[k], a[k])[1])
        for i, (h32, h16) in enumerate(zip(r32["heads"], r16["heads"])):
            for k, t in (*h32.items(), *h16.items()):
                if t.shape[:3] != (1, 128, 256) or not torch.isfinite(
                        t).all():
                    raise AssertionError(f"served alliance frame {i} {k}: "
                                         "bad")
        print(f"[protocol] alliance f32 heads, kernels vs plain on the same "
              f"{len(det)} frames, both with deterministic algorithms: max "
              f"rel err {worst:.3e} (tol {HEADS_TOL}); atomic vs "
              f"deterministic splat sums (information): {noise:.3e}")
        if not worst <= HEADS_TOL:
            raise AssertionError(f"alliance heads disagree: {worst}")
        for name, r in (("f32", r32), ("bf16", r16)):
            steady = r["serve_s"][1:]
            fps = len(steady) / sum(steady)
            out[f"alliance_fps_{name}"] = fps
            rmse = r.get("depth_rmse_m2", float("nan"))
            if not math.isfinite(rmse):
                raise AssertionError(f"alliance {name}: no depth RMSE")
            print(f"[protocol] alliance serve {name}: {fps:.3f} frames/s "
                  f"over {len(steady)} frames after the first "
                  f"({np.mean(steady) * 1e3:.3f} ms/frame; host data "
                  f"{np.mean(r['data_s']) * 1e3:.1f} ms/frame not included);"
                  f" ap_30 {r['ap_30']:.4f}; m2 depth RMSE {rmse:.4f} m")
        for name, st in stages.items():
            serve_ms = 1e3 * float(np.mean(runs[name]["serve_s"][1:]))
            print(f"[protocol] camera branch {name}, mean of "
                  f"{runs[name]['frames'] - 1} frames after the first (CUDA "
                  "events): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in st.items()
                              if k != "frame")
                  + f"; the model's forward {st['frame']:.3f} ms; the splat "
                  f"{100 * st['splat'] / st['frame']:.1f}% of the forward, "
                  f"{100 * st['splat'] / serve_ms:.1f}% of the served frame "
                  f"({serve_ms:.3f} ms)")
            out[f"splat_share_{name}"] = st["splat"] / st["frame"]
        for name, st in sstages.items():
            serve_ms = 1e3 * float(np.mean(runs[name]["serve_s"][1:]))
            share = st["branch"] / st["frame"]
            print(f"[protocol] SECOND branch {name}, mean of "
                  f"{runs[name]['frames'] - 1} frames after the first (CUDA "
                  "events): "
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in st.items()
                              if k not in ("frame", "branch"))
                  + f"; the m3 branch {st['branch']:.3f} ms = "
                  f"{100 * share:.1f}% of the forward ({st['frame']:.3f} ms),"
                  f" {100 * st['branch'] / serve_ms:.1f}% of the served frame"
                  f" ({serve_ms:.3f} ms)")
            out[f"second_share_{name}"] = share

        _zero_counts()
        order = run_in_order(merged, max_batches=2, device="cuda")
        noise = run_noise_sweep(merged, levels=(0.2,), max_batches=2,
                                device="cuda")
        evals = _counts()
        aps = [v for r in (*order.values(), *noise.values())
               for v in r.values()]
        print(f"[protocol] in-order {order}; noise 0.2 {noise[0.2]}; "
              f"launches {evals}")
        tags = ["".join(ALLIANCE[:k]) for k in range(1, len(ALLIANCE) + 1)]
        if list(order) != tags or not all(0 <= v <= 1 for v in aps):
            raise AssertionError("the in-order / noise evaluations failed")
        out["launches"] = {k: launches[k] + serve[k] + evals[k]
                           for k in serve}
    return out


def _stage2(cfg, key, s2dir, s1_path, base) -> dict:
    """Stage 2 of the agent type of PROTOCOL_CFGS[key] through the CLI
    against the frozen base at ``s1_path``, its checks, then its step
    timed in f32 and bf16."""
    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.models import build_model
    from heal_tpu_torch.tools import checkpoint as ckpt_lib
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import build_weights

    dev = torch.device("cuda")
    m = STAGE2_TYPES[key]
    out = {}
    yaml = s2dir + ".yaml"
    save_yaml(cfg, yaml)
    left = ckpt_lib.loose_load(build_model(cfg["model"]), s1_path,
                               verbose=False)
    if _shared({k.split(" ")[0]: None for k in left}):
        raise AssertionError(f"stage 2 {m} left frozen keys out: {left}")
    _zero_counts()
    t0 = time.perf_counter()
    train_tool.main(["-y", yaml, "--model_dir", s2dir, "--init_from",
                     s1_path, "--epochs", "1", "--no_final_inference",
                     "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    out[f"stage2_{m}_launches"] = _counts()
    s2 = ckpt_lib.load_state_dict(ckpt_lib.find_checkpoint(s2dir)[1])
    n_shared = _same_shared(s2, base, f"stage 2 {m}")
    init = build_weights(cfg, seed=0)
    names = [n for n, _ in init.named_parameters()
             if n.startswith(f"branch_{m}.")]
    init = init.state_dict()
    moved = [n for n in names if not torch.equal(s2[n], init[n])]
    with open(os.path.join(s2dir, "train_log.jsonl")) as f:
        log = json.loads(f.read().splitlines()[-1])
    depth = log.get("depth_loss")
    print(f"[protocol] stage 2 {m} ({PROTOCOL_CFGS[key]}): "
          f"{len(left)} base keys left out, none of the frozen modules;"
          f" {n_shared} pyramid/shrink/heads entries bit-equal to stage "
          f"1; {len(moved)} of {len(names)} branch_{m} parameters moved;"
          f" loss {log['total_loss']:.4f}"
          + (f", depth loss {depth:.4f}" if depth is not None else "")
          + f"; the CLI run {cli_s:.1f} s (epoch {log['epoch_s']:.3f} s);"
          f" launches {out[f'stage2_{m}_launches']}")
    if len(moved) < 0.9 * len(names) or not math.isfinite(log["total_loss"]):
        raise AssertionError(f"stage 2 did not train branch_{m}")
    if m == "m2" and not (depth is not None and math.isfinite(depth)):
        raise AssertionError(f"stage 2 m2: no finite depth loss ({depth})")

    # the stage-2 step, f32 and bf16, on one device batch
    bs = cfg["train_params"]["batch_size"]
    batch, _ = next(train_tool.device_batches(cfg, bs, dev))
    _zero_counts()
    for name in ("f32", "bf16"):
        tr = train_tool.build_trainer(cfg, dev, 1, init_from=s1_path)
        tr.bf16 = name == "bf16"
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(STAGE2_STEPS):
            t0 = time.perf_counter()
            aux = tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _same_shared(tr.model.state_dict(), base,
                     f"stage-2 {m} {name} steps")
        ms = 1e3 * sum(times) / len(times)
        out[f"stage2_{m}_ms_{name}"] = ms
        out[f"stage2_{m}_peak_{name}"] = peak
        print(f"[protocol] stage-2 {m} step {name}: {ms:.3f} ms/step "
              f"({bs / ms * 1e3:.3f} samples/s; mean of {STAGE2_STEPS} "
              f"after a warm one), peak memory {peak:.3f} GiB, loss "
              f"{float(aux['total_loss']):.4f}; base unchanged")
        if not math.isfinite(float(aux["total_loss"])):
            raise AssertionError(f"stage-2 {m} {name} loss is not finite")
        del tr
    steps = _counts()
    print(f"[protocol] launches over {2 * (STAGE2_STEPS + 1)} stage-2 {m} "
          f"steps: {steps}")
    if any(steps.values()):
        raise AssertionError("a stage-2 train step launched a kernel")
    return out


@contextlib.contextmanager
def camera_stages(model, m: str):
    """CUDA events around camera type ``m``'s stages in every forward of
    ``model`` while the block runs (forward hooks); yields a dict filled
    at the end with the mean ms, over the forwards after the first, of
    the image CNN, the splat (the depth softmax, the layout and the
    segment sum), the branch's backbone + aligner, and the whole forward
    (``frame``)."""
    branch = getattr(model, f"branch_{m}")
    marks: dict = {}

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.setdefault(name, []).append(ev)
        return hook

    hooks = [model.register_forward_pre_hook(mark("frame0")),
             model.register_forward_hook(mark("frame1")),
             branch.encoder.cam_encoder.register_forward_pre_hook(
                 mark("cnn0")),
             branch.encoder.cam_encoder.register_forward_hook(mark("cnn1")),
             branch.encoder.register_forward_hook(mark("splat1")),
             branch.backbone.register_forward_pre_hook(mark("bb0")),
             branch.aligner.register_forward_hook(mark("bb1"))]
    result: dict = {}
    try:
        yield result
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    for name, (a, b) in (("image CNN", ("cnn0", "cnn1")),
                         ("splat", ("cnn1", "splat1")),
                         ("backbone + aligner", ("bb0", "bb1")),
                         ("frame", ("frame0", "frame1"))):
        times = [s.elapsed_time(e) for s, e in zip(marks[a], marks[b])][1:]
        result[name] = sum(times) / len(times)


# the column-engine functions the SECOND stack calls, and the stage each
# one counts to
ENGINE_STAGES = {"voxelize_columns": "voxelize", "rank_map": "tables",
                 "column_table": "tables", "downsample_columns": "tables",
                 "strided_table": "tables", "to_dense_bev": "to_dense_bev"}


@contextlib.contextmanager
def column_engine(on_call):
    """Route the column-engine functions of ENGINE_STAGES through
    ``on_call(name, fn, *args, **kwargs)`` while the block runs (the
    SECOND stack looks them up in ops/column_conv.py at each call)."""
    from heal_tpu_torch.ops import column_conv as cc

    saved = {name: getattr(cc, name) for name in ENGINE_STAGES}
    for name, fn in saved.items():
        setattr(cc, name, functools.partial(on_call, name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(cc, name, fn)


def _second_layers(stack):
    """(level, layer) of each conv layer of a SecondStack."""
    for name, layer in stack.named_children():
        level = 0 if name == "conv_input" else int(
            name.split("_")[1] if name.startswith("down") else name[5])
        yield level, layer


def second_columns(stack, points, mask) -> list:
    """Active columns at each level of ``stack`` on these agents against
    the level's capacity: [(level, max active over the agents, capacity,
    columns dropped by overflow over the agents)]. The active count comes
    from the same functions at a capacity that drops nothing."""
    from heal_tpu_torch.ops import column_conv as cc

    def level(i, full, kept, cap):
        act = full["cvalid"].sum(1)
        return (i, int(act.max()), cap,
                int((act - kept["cvalid"].sum(1)).sum()))

    cols = cc.voxelize_columns(points, mask, stack.lidar_range,
                               stack.voxel_size, stack.max_voxels[0])
    rows = [level(0, cc.voxelize_columns(
        points, mask, stack.lidar_range, stack.voxel_size,
        points.shape[1]), cols, stack.max_voxels[0])]
    for si in range(1, len(stack.channels)):
        _, h, w = cols["grid"]
        cells = ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1)
        full = cc.downsample_columns(cols, cells)
        cols = cc.downsample_columns(cols, stack.max_voxels[si])
        rows.append(level(si, full, cols, stack.max_voxels[si]))
    return rows


def phase_second(cfg, s2dir) -> dict:
    """The stage-2 m3 encoder (its trained weights) on the first test
    batch of ``cfg``: the active columns of each level against the
    capacities, then the first agent's frame on the card against the same
    module on the CPU, every column-engine output and every conv layer's
    features compared (integer outputs equal, f32 within SECOND_CPU_TOL).
    """
    from heal_tpu_torch.tools import checkpoint as ckpt_lib
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import build_weights

    dev = torch.device("cuda")
    model = build_weights(cfg, checkpoint=ckpt_lib.find_checkpoint(s2dir)[1])
    enc = model.branch_m3.encoder.to(dev).eval()
    stack = enc.VmapSecondStack_0
    batch, _ = next(train_tool.device_batches(
        cfg, cfg["train_params"]["batch_size"], dev, train=False))
    pts = batch["inputs_m3"]["points"].flatten(0, 1)
    mask = batch["inputs_m3"]["point_mask"].flatten(0, 1)
    with torch.no_grad():
        rows = second_columns(stack, pts, mask)
    print(f"[second] active columns of {pts.shape[0]} m3 agents "
          f"({int(mask.sum())} points) per level, the most of any agent "
          "against the capacity, and the columns dropped by overflow: "
          + "; ".join(f"level {i} {a} of {c}, dropped {d}"
                      for i, a, c, d in rows))

    seen: dict = {"cuda": [], "cpu": []}

    def record(where):
        def on_call(name, fn, *args, **kwargs):
            got = fn(*args, **kwargs)
            seen[where].append((name, got))
            return got
        return on_call

    def run(module, where, *inputs):
        hooks = [layer.register_forward_hook(
            lambda mod, i, o, where=where: seen[where].append(
                ("layer", o if torch.is_tensor(o) else o["feats"])))
            for _, layer in _second_layers(module.VmapSecondStack_0)]
        try:
            with torch.no_grad(), column_engine(record(where)):
                return module(*inputs)
        finally:
            for h in hooks:
                h.remove()

    run(enc, "cuda", pts[:1], mask[:1])
    run(copy.deepcopy(enc).cpu(), "cpu", pts[:1].cpu(), mask[:1].cpu())
    worst, n_int = 0.0, 0
    for (name, got), (name_c, want) in zip(seen["cuda"], seen["cpu"],
                                           strict=True):
        if name != name_c:
            raise AssertionError(f"SECOND call order: {name} vs {name_c}")
        if name == "rank_map":  # the dump slot is written, never read
            got, want = got[:, :-1], want[:, :-1]
        pairs = ([(k, got[k], want[k]) for k in got if k != "grid"]
                 if isinstance(got, dict) else [(name, got, want)])
        for key, a, b in pairs:
            a = a.cpu()
            if a.is_floating_point():
                worst = max(worst, rel_err(a, b)[1])
            elif not torch.equal(a, b):
                raise AssertionError(f"SECOND {name} {key}: card and CPU "
                                     "disagree")
            else:
                n_int += 1
    print(f"[second] one m3 frame, the card vs the CPU: {len(seen['cpu'])} "
          f"outputs of the column engine and the conv layers, {n_int} "
          f"integer arrays equal; f32 features max rel err {worst:.3e} "
          f"(tol {SECOND_CPU_TOL})")
    if not worst <= SECOND_CPU_TOL:
        raise AssertionError(f"SECOND features, card vs CPU: {worst}")
    return {"second_columns": rows, "second_cpu_rel": worst}


@contextlib.contextmanager
def second_stages(model, m: str):
    """CUDA events around SECOND type ``m``'s stages in every forward of
    ``model`` while the block runs; yields a dict filled at the end with
    the mean ms, over the forwards after the first, of: voxelize, the rank
    maps and tables (column_table, downsample_columns, strided_table),
    each level's conv layers (conv + LayerNorm + ReLU), to_dense_bev, the
    branch's backbone + aligner, the whole branch and the whole forward
    (``frame``)."""
    branch = getattr(model, f"branch_{m}")
    stack = branch.encoder.VmapSecondStack_0
    forwards: list = []

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def span(name, start):
        forwards[-1].setdefault(name, []).append((start, event()))

    def timed(name, fn, *args, **kwargs):
        start = event()
        got = fn(*args, **kwargs)
        span(ENGINE_STAGES[name], start)
        return got

    def around(module, name):
        starts = []
        return [module.register_forward_pre_hook(
                    lambda *_: starts.append(event())),
                module.register_forward_hook(
                    lambda *_: span(name, starts.pop()))]

    hooks = [model.register_forward_pre_hook(
        lambda *_: forwards.append({}))]
    hooks += around(model, "frame") + around(branch, "branch")
    for level, layer in _second_layers(stack):
        hooks += around(layer, f"level {level} convs")
    bb0 = []
    hooks += [branch.backbone.register_forward_pre_hook(
                  lambda *_: bb0.append(event())),
              branch.aligner.register_forward_hook(
                  lambda *_: span("backbone + aligner", bb0.pop()))]
    result: dict = {}
    try:
        with column_engine(timed):
            yield result
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    for f in forwards[1:]:
        for name, pairs in f.items():
            result[name] = result.get(name, 0.0) + sum(
                a.elapsed_time(b) for a, b in pairs) / (len(forwards) - 1)


def baseline_cfgs() -> dict:
    """The baselines phase's published configs at full width, read through
    the port's loader: the synthetic backend with the flagship's scene
    arguments, BASELINE_BATCH train scenes at that batch and
    BASELINE_FRAMES test scenes."""
    from heal_tpu_torch.tools.train import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    scene_args = flagship_cfg()["fusion"]["args"]
    out = {}
    for name in BASELINES:
        cfg = load_config(os.path.join(root, "heal_tpu", "configs", "opv2v",
                                       "more_modality",
                                       f"m1m2m3m4_{name}.yaml"))
        cfg["fusion"]["dataset"] = "synthetic"
        cfg["fusion"]["args"] = dict(scene_args,
                                     num_scenes_train=BASELINE_BATCH,
                                     num_scenes_test=BASELINE_FRAMES)
        cfg["train_params"]["batch_size"] = BASELINE_BATCH
        out[name] = cfg
    return out


def _fusions(model) -> list:
    """The fusion modules of a baseline model (one, or one a level)."""
    return [m for n, m in model.named_children()
            if n == "fusion" or n.startswith("fusions_")]


@contextlib.contextmanager
def fusion_time(model):
    """CUDA events around the model's forward and its fusion modules in
    every forward while the block runs; yields a dict filled at the end
    with the mean ms over the forwards after the first of the fusion
    calls (summed over the levels) and of the whole forward."""
    marks: dict = {"frame": [], "fusion": []}
    starts: list = []

    def start(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        starts.append(ev)

    def stop(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks[name].append((starts.pop(), ev))
        return hook

    hooks = [model.register_forward_pre_hook(start),
             model.register_forward_hook(stop("frame"))]
    for f in _fusions(model):
        hooks += [f.register_forward_pre_hook(start),
                  f.register_forward_hook(stop("fusion"))]
    result: dict = {}
    try:
        yield result
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    per = len(marks["fusion"]) // max(len(marks["frame"]), 1)
    frames = [a.elapsed_time(b) for a, b in marks["frame"]][1:]
    fusion = [a.elapsed_time(b) for a, b in marks["fusion"]][per:]
    result["frame"] = sum(frames) / len(frames)
    result["fusion"] = sum(fusion) / len(frames)


def phase_baselines(cfgs: dict) -> dict:
    """The eight published baselines served and trained on one set of
    device frames and one train batch (module docstring, phase 7);
    returns each kernel's launches over the phase and the measurements."""
    import numpy as np

    from heal_tpu_torch.models.layers import channels_last
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import (build_weights, device_frames,
                                                run_inference)

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    first = cfgs[BASELINES[0]]
    t0 = time.perf_counter()
    frames = device_frames(first, dev, BASELINE_FRAMES)
    batch, _ = next(train_tool.device_batches(first, BASELINE_BATCH, dev))
    torch.cuda.synchronize()
    print(f"[baselines] {len(frames)} test frames and one train batch of "
          f"{BASELINE_BATCH} assembled and copied to the card once in "
          f"{time.perf_counter() - t0:.2f} s")
    if len(frames) != BASELINE_FRAMES:
        raise AssertionError(f"{len(frames)} baseline frames")
    total = {k: 0 for k in _counts()}
    out = {}
    for name, cfg in cfgs.items():
        torch.cuda.empty_cache()
        model32 = channels_last(build_weights(cfg, seed=SEED).to(dev))
        model16 = copy.deepcopy(model32).to(torch.bfloat16)
        runs, timing = {}, {}
        _zero_counts()
        for dname, model, dt in (("f32", model32, torch.float32),
                                 ("bf16", model16, torch.bfloat16)):
            with fusion_time(model) as timing[dname]:
                runs[dname] = run_inference(cfg=cfg, device="cuda", dtype=dt,
                                            model=model, collect_heads=True,
                                            frames=frames)
        served = _counts()
        n = runs["f32"]["frames"] + runs["bf16"]["frames"]
        want = {"pillar_tables": BASELINE_PILLAR_LAUNCHES * n,
                "shift_rows": BASELINE_LAUNCHES[name] * n,
                "shift_rows_backward": 0}
        if served != want:
            raise AssertionError(f"{name}: launches {served}, want {want}")
        for dname, r in runs.items():
            for i, h in enumerate(r["heads"]):
                for k, t in h.items():
                    if t.shape[:3] != (1, 128, 256) or not torch.isfinite(
                            t).all():
                        raise AssertionError(f"{name} {dname} frame {i} {k}:"
                                             " bad output")
        comm = runs["f32"].get("comm_rate")
        if name == "where2comm" and not (comm is not None and 0 < comm <= 1):
            raise AssertionError(f"where2comm comm_rate {comm}")

        # kernels vs plain versions on the same device frames
        worst = heads_vs_plain(model32, frames, name)
        del model16
        for k in total:  # the comparison's launches do not count
            total[k] += served[k]

        # training: one warm and BASELINE_STEPS timed f32 steps, one bf16
        model32.cpu()
        del model32
        torch.cuda.empty_cache()
        _zero_counts()
        tr = train_tool.build_trainer(cfg, dev, 1)
        fusion_params = {n: p for n, p in tr.model.named_parameters()
                         if n.split(".")[0] == "fusion"
                         or n.startswith("fusions_")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for step in range(1 + BASELINE_STEPS):
            t0 = time.perf_counter()
            aux = tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(aux["total_loss"]))
        peak32 = torch.cuda.max_memory_allocated() / 2**30
        dead = no_gradient(fusion_params, tr.model)
        # the bf16 policy: a warm step (its first call picks the bf16
        # convolution algorithms), then one timed
        tr.bf16 = True
        tr.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        aux16 = tr.train_step(batch)
        torch.cuda.synchronize()
        ms16 = 1e3 * (time.perf_counter() - t0)
        peak16 = torch.cuda.max_memory_allocated() / 2**30
        losses.append(float(aux16["total_loss"]))
        trained = _counts()
        del tr
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name} train losses {losses}")
        if dead:
            raise AssertionError(f"{name}: fusion parameters without a "
                                 f"gradient: {dead[:5]}")
        if trained["pillar_tables"] != 0 or trained["shift_rows"] <= 0 \
                or trained["shift_rows_backward"] <= 0:
            raise AssertionError(f"{name} training launches {trained}")
        for k in total:
            total[k] += trained[k]

        ms32 = 1e3 * sum(times[1:]) / BASELINE_STEPS
        row = {"launches_per_frame": {k: served[k] // n for k in served},
               "heads_rel": worst, "train_launches": trained,
               "ms_step_f32": ms32, "ms_step_bf16": ms16,
               "peak_gib_f32": peak32, "peak_gib_bf16": peak16,
               "losses": losses, "comm_rate": comm,
               "fusion_params": len(fusion_params)}
        for dname, r in runs.items():
            steady = r["serve_s"][1:]
            row[f"ms_frame_{dname}"] = 1e3 * float(np.mean(steady))
            row[f"fps_{dname}"] = len(steady) / sum(steady)
            row[f"fusion_ms_{dname}"] = timing[dname]["fusion"]
            row[f"forward_ms_{dname}"] = timing[dname]["frame"]
        out[name] = row
        print(f"[baselines] {name} ({cfg['model']['core_method']}, fusion "
              f"{cfg['model']['args']['fusion_method']}): launches a frame "
              f"{row['launches_per_frame']}; f32 heads vs plain max rel err "
              f"{worst:.3e} (tol {HEADS_TOL})"
              + (f"; comm_rate {comm:.4f}" if comm is not None else ""))
        for dname in ("f32", "bf16"):
            fus, fwd = row[f"fusion_ms_{dname}"], row[f"forward_ms_{dname}"]
            print(f"[baselines] {name} serve {dname}: "
                  f"{row[f'ms_frame_{dname}']:.3f} ms/frame, "
                  f"{row[f'fps_{dname}']:.3f} frames/s over "
                  f"{BASELINE_FRAMES - 1} frames after the first; the fusion "
                  f"{fus:.3f} ms = {100 * fus / fwd:.1f}% of the forward "
                  f"({fwd:.3f} ms, CUDA events)")
        print(f"[baselines] {name} train, batch {BASELINE_BATCH}: f32 "
              f"{ms32:.3f} ms/step (mean of {BASELINE_STEPS} after a warm "
              f"one), peak {peak32:.3f} GiB; bf16 {ms16:.3f} ms/step (after "
              f"a warm one), peak {peak16:.3f} GiB; losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f"; {len(fusion_params)} fusion parameters, each with a "
              f"nonzero gradient but the softmax shifts; launches "
              f"{trained}")
    print(f"[baselines] phase {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return {"launches": total, "rows": out}


def fusion_cfgs() -> dict:
    """The fusion timings phase's published configs at full width, read
    through the port's loader, on the synthetic backend with the
    flagship's scene arguments: ``late`` and ``early``
    (TIMING_BATCH train scenes), the single detectors ``m1``..``m4``
    (TIMING_BATCH train scenes), ``m1m2`` (the late-heter alliance), and
    each lidar-only baseline by its method (LIDAR_BATCH train scenes);
    TIMING_FRAMES test scenes each."""
    from heal_tpu_torch.tools.train import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    scene_args = flagship_cfg()["fusion"]["args"]
    rels = {**TIMING_CFGS, **SINGLE_CFGS, "m1m2": LATE_HETER_CFG,
            **{n: f"lidar_only/{n}.yaml" for n in LIDAR_BASELINES}}
    out = {}
    for name, rel in rels.items():
        cfg = load_config(os.path.join(root, "heal_tpu", "configs", "opv2v",
                                       rel))
        batch = LIDAR_BATCH if name in LIDAR_BASELINES else TIMING_BATCH
        cfg["fusion"]["dataset"] = "synthetic"
        cfg["fusion"]["args"] = dict(scene_args, num_scenes_train=batch,
                                     num_scenes_test=TIMING_FRAMES)
        cfg["train_params"]["batch_size"] = batch
        out[name] = cfg
    return out


def _forwards(frames) -> list:
    """Every forward's inputs of ``frames`` (late fusion: one per agent
    sample)."""
    return [x for _, f in frames for x in (f if isinstance(f, list) else [f])]


def heads_vs_plain(model, frames, what: str) -> float:
    """The f32 heads (and the uncertainty detector's ``unc_preds``) of
    every forward of ``frames``, kernels against the plain versions,
    both with deterministic algorithms; -> the worst
    max |d| / (1 + max |plain|). Fails past HEADS_TOL, on a bad output,
    or if the plain run launched a kernel."""
    inputs = _forwards(frames)

    def heads():
        with torch.inference_mode():
            return [{k: v.float() for k, v in model(x).items()
                     if k in ("cls_preds", "reg_preds", "dir_preds",
                              "unc_preds")}
                    for x in inputs]

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = heads()
        compared = _counts()
        with plain_kernels():
            ref = heads()
    finally:
        torch.use_deterministic_algorithms(False)
    if _counts() != compared:
        raise AssertionError(f"{what}: the plain run launched a kernel")
    for h in det:
        for k, t in h.items():
            if t.shape[:3] != (1, 128, 256) or not torch.isfinite(t).all():
                raise AssertionError(f"{what} {k}: bad output")
    worst = max(rel_err(a[k], b[k])[1] for a, b in zip(det, ref) for k in a)
    if not worst <= HEADS_TOL:
        raise AssertionError(f"{what} heads, kernels vs plain: {worst}")
    return worst


def _serve(cfg, model32, frames, what: str) -> tuple[dict, dict]:
    """``frames`` served f32 and bf16 through run_inference; -> (the
    runs, the kernels' launches over both); heads checked finite."""
    from heal_tpu_torch.tools.inference import run_inference

    model16 = copy.deepcopy(model32).to(torch.bfloat16)
    _zero_counts()
    runs = {dname: run_inference(cfg=cfg, device="cuda", dtype=dt,
                                 model=model, collect_heads=True,
                                 frames=frames)
            for dname, model, dt in (("f32", model32, torch.float32),
                                     ("bf16", model16, torch.bfloat16))}
    served = _counts()
    for dname, r in runs.items():
        for i, h in enumerate(r["heads"]):
            for k, t in h.items():
                if t.shape[:3] != (1, 128, 256) or not torch.isfinite(
                        t).all():
                    raise AssertionError(f"{what} {dname} forward {i} {k}: "
                                         "bad output")
    return runs, served


def traced_frame(cfg, model32, frame) -> dict:
    """One f32 frame served through run_inference under torch.profiler:
    the card's busy time in it against the frame's serve time in the
    same run; ``idle`` is the share of the frame the card sat idle."""
    from heal_tpu_torch.tools.inference import run_inference

    out = {}

    def serve():
        out.update(run_inference(cfg=cfg, device="cuda", dtype=torch.float32,
                                 model=model32, frames=[frame]))

    busy = device_busy(serve)
    frame_ms = 1e3 * out["serve_s"][0]
    return {"busy_ms": busy["busy_ms"], "frame_ms": frame_ms,
            "device_ops": busy["device_ops"],
            "idle": 1 - busy["busy_ms"] / frame_ms}


def no_gradient(params: dict, model) -> list:
    """The names of ``params`` (name -> parameter of ``model``, after a
    step) with no gradient, or an all-zero one. A softmax shift of
    ``model`` (heal_tpu_torch.models.fuse.softmax_shift_biases: a key
    projection's bias, DiscoNet's and When2com's score biases) has a
    gradient of zero by construction, so it needs only to have one: its
    rounding error may or may not be 0."""
    from heal_tpu_torch.models.fuse import softmax_shift_biases

    shifts = softmax_shift_biases(model)
    return [n for n, p in params.items() if p.grad is None
            or (n not in shifts and not bool(p.grad.abs().max() > 0))]


def _steps(tr, batch, n: int) -> dict:
    """``n`` train steps on ``batch`` (the first warm, the rest timed);
    -> losses, the mean ms of the timed steps, peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        aux = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["total_loss"]))
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    timed = times[1:] or times
    return {"losses": losses, "ms": 1e3 * sum(timed) / len(timed),
            "batch": int(batch["pos_equal_one"].shape[0]),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def phase_fusion_timings(cfgs: dict) -> dict:
    """Late and early fusion, the late-heter protocol and the lidar-only
    baselines on the published configs at full width (module docstring,
    phase 8); returns each kernel's launches over the phase and the
    measurements."""
    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.models.layers import channels_last
    from heal_tpu_torch.tools import checkpoint as ckpt_lib
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import build_weights, device_frames
    from heal_tpu_torch.tools.merge import merge_final

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    total = {k: 0 for k in _counts()}
    rows = {}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    def served_model(name, cfg, model32, frames, shift_per_frame):
        """Serve, check the launches (kernel 1 once per forward), compare
        the heads with the plain versions; -> the row."""
        runs, served = _serve(cfg, model32, frames, name)
        n = len(_forwards(frames))
        want = {"pillar_tables": 2 * n,
                "shift_rows": 2 * len(frames) * shift_per_frame,
                "shift_rows_backward": 0}
        if served != want:
            raise AssertionError(f"{name}: launches {served}, want {want}")
        add(served)
        worst = heads_vs_plain(model32, frames, name)
        row = {"forwards": n, "frames": len(frames), "heads_rel": worst,
               "launches_per_frame": {k: served[k] / (2 * len(frames))
                                      for k in served},
               "ap_30_f32": runs["f32"]["ap_30"]}
        for d, r in runs.items():
            ms = sorted(1e3 * t for t in r["serve_s"][1:])
            row[f"ms_frame_{d}"] = sum(ms) / len(ms)
            row[f"median_ms_frame_{d}"] = statistics.median(ms)
            row[f"range_ms_frame_{d}"] = (ms[0], ms[-1])
        row["trace_f32"] = traced_frame(cfg, model32, frames[1])
        if "comm_rate" in runs["f32"]:
            row["comm_rate"] = runs["f32"]["comm_rate"]
            if not 0 < row["comm_rate"] <= 1:
                raise AssertionError(f"{name} comm_rate {row['comm_rate']}")
        return row

    # 1-2. late and early fusion of point_pillar: serve, then train at
    # the published batch with the published augmentation
    for name in TIMING_CFGS:
        cfg = cfgs[name]
        torch.cuda.empty_cache()
        frames = device_frames(cfg, dev, TIMING_FRAMES)
        batch, _ = next(train_tool.device_batches(cfg, TIMING_BATCH, dev))
        model32 = channels_last(build_weights(cfg, seed=SEED).to(dev))
        row = served_model(name, cfg, model32, frames, 0)
        del model32
        _zero_counts()
        tr = train_tool.build_trainer(cfg, dev, 1)
        row["train"] = _steps(tr, batch, 1 + TIMING_STEPS)
        trained = _counts()
        del tr
        if any(trained.values()):
            raise AssertionError(f"{name} training launched {trained}")
        rows[name] = row

    # 3. the late-heter protocol: each type's single detector one step
    # at the published batch; m1 and m2 merged into the m1+m2 late model
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {}
        for m in SINGLE_CFGS:
            cfg = cfgs[m]
            torch.cuda.empty_cache()
            batch, _ = next(train_tool.device_batches(cfg, TIMING_BATCH,
                                                      dev))
            _zero_counts()
            tr = train_tool.build_trainer(cfg, dev, 1)
            if tr.supervise_single:
                raise AssertionError(f"{m}: supervise_single on late fusion")
            rows[f"single_{m}"] = {"train": _steps(tr, batch, 2)}
            if any(_counts().values()):
                raise AssertionError(f"single {m} training launched a "
                                     "kernel")
            dirs[m] = os.path.join(tmp, m)
            ckpt_lib.save_checkpoint(dirs[m], tr.model, 1, bestval=True)
            save_yaml(cfg, os.path.join(dirs[m], "config.yaml"))
            del tr, batch
        cfg = cfgs["m1m2"]
        merged = merge_final([dirs["m2"]], dirs["m1"],
                             os.path.join(tmp, "m1m2"))
        msd = ckpt_lib.load_state_dict(merged)
        srcs = {m: ckpt_lib.load_state_dict(
            ckpt_lib.find_checkpoint(dirs[m])[1]) for m in ("m1", "m2")}
        left = [k for m, sd in srcs.items() for k, v in sd.items()
                if (m == "m1" or k.startswith("branch_"))
                and not torch.equal(msd.get(k, torch.empty(0)), v)]
        if left:
            raise AssertionError(f"the late merge left out {left[:5]}")
        model32 = channels_last(build_weights(cfg, checkpoint=merged).to(
            dev))
        frames = device_frames(cfg, dev, TIMING_FRAMES)
        rows["m1m2"] = served_model("m1m2", cfg, model32, frames, 0)
        del model32, frames
    print(f"[fusion] late merge: {len(msd)} entries (m1's {len(srcs['m1'])}"
          f" and m2's branch), loaded strictly into {LATE_HETER_CFG}")

    # 4. the lidar-only point_pillar_baseline table on one set of frames
    frames = device_frames(cfgs[LIDAR_BASELINES[0]], dev, TIMING_FRAMES)
    batch, _ = next(train_tool.device_batches(cfgs[LIDAR_BASELINES[0]],
                                              LIDAR_BATCH, dev))
    for name in LIDAR_BASELINES:
        cfg = cfgs[name]
        torch.cuda.empty_cache()
        model32 = channels_last(build_weights(cfg, seed=SEED).to(dev))
        row = served_model(name, cfg, model32, frames,
                           LIDAR_SHIFT_LAUNCHES[name])
        del model32
        torch.cuda.empty_cache()
        _zero_counts()
        tr = train_tool.build_trainer(cfg, dev, 1)
        fusion = tr.model.fusion_name
        fusion_params = {n: p for n, p in tr.model.named_parameters()
                         if n.split(".")[0] == fusion}
        row["train"] = _steps(tr, batch, 2)
        trained = _counts()
        row["train_launches_per_step"] = {k: v / 2
                                          for k, v in trained.items()}
        dead = no_gradient(fusion_params, tr.model)
        del tr
        if dead:
            raise AssertionError(f"{name}: fusion parameters without a "
                                 f"gradient: {dead[:5]}")
        if trained["pillar_tables"] != 0 or trained["shift_rows"] <= 0 \
                or trained["shift_rows_backward"] <= 0:
            raise AssertionError(f"{name} training launches {trained}")
        add(trained)
        row["fusion_params"] = len(fusion_params)
        rows[name] = row
    del frames, batch

    for name, row in rows.items():
        parts = []
        if "ms_frame_f32" in row:
            tf = row["trace_f32"]
            parts.append(
                "serve ms/frame, mean / median [min, max] over "
                f"{row['frames'] - 1} frames after the first: "
                + ", ".join(
                    f"{d} {row[f'ms_frame_{d}']:.3f} / "
                    f"{row[f'median_ms_frame_{d}']:.3f} "
                    f"[{row[f'range_ms_frame_{d}'][0]:.3f}, "
                    f"{row[f'range_ms_frame_{d}'][1]:.3f}]"
                    for d in ("f32", "bf16"))
                + f" ({row['forwards']} forwards in {row['frames']} frames); "
                f"one traced f32 frame {tf['frame_ms']:.3f} ms, card busy "
                f"{tf['busy_ms']:.3f} ms in {tf['device_ops']} device ops, "
                f"idle {tf['idle']:.3f}; "
                f"launches a frame {row['launches_per_frame']}; f32 heads vs "
                f"plain max rel err {row['heads_rel']:.3e} (tol {HEADS_TOL})")
        if "train" in row:
            tr = row["train"]
            parts.append(
                f"train step {tr['ms']:.3f} ms f32 (batch {tr['batch']}, mean "
                f"of {len(tr['losses']) - 1} after a warm one), peak "
                f"{tr['peak_gib']:.3f} GiB, losses "
                + ", ".join(f"{x:.4f}" for x in tr["losses"]))
        if "comm_rate" in row:
            parts.append(f"comm_rate {row['comm_rate']:.4f}")
        if "fusion_params" in row:
            parts.append(f"{row['fusion_params']} fusion parameters, each "
                         "with a nonzero gradient but the softmax shifts")
        print(f"[fusion] {name}: " + "; ".join(parts))
    print(f"[fusion] phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}")
    return {"launches": total, "rows": rows}


def pose_cfgs() -> dict:
    """The pose error and bandwidth phase's configs (POSE_CFGS) at full
    width, read through the port's loader, on the synthetic backend with
    the flagship's scene arguments: POSE_FRAMES test scenes,
    COMPRESS_BATCH train scenes. ``uncertainty`` is derived from
    late_fusion.yaml: model point_pillar_uncertainty, loss
    point_pillar_uncertainty_loss, everything else as published."""
    from heal_tpu_torch.tools.train import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    scene_args = flagship_cfg()["fusion"]["args"]
    out = {}
    for name, rel in POSE_CFGS.items():
        cfg = load_config(os.path.join(root, "heal_tpu", "configs", "opv2v",
                                       rel))
        cfg["fusion"]["dataset"] = "synthetic"
        cfg["fusion"]["args"] = dict(scene_args,
                                     num_scenes_train=COMPRESS_BATCH,
                                     num_scenes_test=POSE_FRAMES)
        out[name] = cfg
    out["uncertainty"]["model"]["core_method"] = "point_pillar_uncertainty"
    out["uncertainty"]["loss"]["core_method"] = (
        "point_pillar_uncertainty_loss")
    return out


@contextlib.contextmanager
def timed_box_align(seconds: list):
    """Append the host seconds of every box alignment the assembler runs
    (data/scene.py) to ``seconds``."""
    from heal_tpu_torch.data import scene

    real = scene.box_alignment_relative

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return out

    scene.box_alignment_relative = timed
    try:
        yield
    finally:
        scene.box_alignment_relative = real


def gt_dump(cfg, path: str) -> str:
    """A stage-1 dump from the ground truth of ``cfg``'s first
    POSE_FRAMES test scenes: each agent's view of every object's center
    (tests/test_box_align.py builds it so)."""
    import numpy as np

    from heal_tpu_torch.data import build_dataset

    ds = build_dataset(cfg, train=False)
    dump = {}
    for idx in range(POSE_FRAMES):
        scene = ds.backend.scene(idx)
        objs = np.asarray(scene["objects"])[:, :2]
        per_agent = []
        for a in scene["agents"]:
            pose = np.asarray(a["pose"], np.float64)
            c, s = np.cos(np.radians(pose[4])), np.sin(np.radians(pose[4]))
            centers = (objs - pose[:2]) @ np.array([[c, -s], [s, c]])
            per_agent.append({"centers": centers.tolist(),
                              "scores": [1.0] * len(centers)})
        dump[str(idx)] = per_agent
    with open(path, "w") as f:
        json.dump(dump, f)
    return path


def _steady_ms(serve_s) -> float:
    timed = serve_s[1:] or serve_s
    return 1e3 * sum(timed) / len(timed)


def phase_pose(cfgs: dict) -> dict:
    """HEAL's pose-error and bandwidth paths at full width (module
    docstring, phase 9); returns each kernel's launches over the phase
    and the measurements."""
    import numpy as np

    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.data import build_dataset
    from heal_tpu_torch.models.layers import channels_last
    from heal_tpu_torch.tools import checkpoint as ckpt_lib
    from heal_tpu_torch.tools import pose_graph_pre_calc
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import (apply_overrides,
                                                build_weights, device_frames,
                                                run_inference)
    from heal_tpu_torch.tools.inference_w_noise import run_noise_sweep

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    total = {k: 0 for k in _counts()}
    out = {}

    def launched(what, want_per_forward, forwards):
        got = _counts()
        k1, k2 = want_per_forward
        want = {"pillar_tables": k1 * forwards,
                "shift_rows": k2 * forwards, "shift_rows_backward": 0}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")
        for k in total:
            total[k] += got[k]

    with tempfile.TemporaryDirectory() as tmp:
        # (a) CoAlign. 1. the stage-1 dumps through the CLI, both paths
        runs = {}
        for name in ("coalign", "uncertainty"):
            cfg = cfgs[name]
            runs[name] = os.path.join(tmp, name)
            ckpt_lib.save_checkpoint(runs[name],
                                     build_weights(cfg, seed=SEED), 1)
            save_yaml(cfg, os.path.join(runs[name], "config.yaml"))
            _zero_counts()
            t0 = time.perf_counter()
            dump = pose_graph_pre_calc.main(["--model_dir", runs[name],
                                             "--max_frames",
                                             str(POSE_FRAMES)])
            secs = time.perf_counter() - t0
            ds = build_dataset(cfg, train=False)
            agents = [len(ds.backend.scene(i)["agents"])
                      for i in range(POSE_FRAMES)]
            launched(f"pre-calc {name}", POSE_LAUNCHES[name], sum(agents))
            keys = {"centers", "scores"} | (
                {"uncertainty"} if name == "uncertainty" else set())
            if sorted(dump) != [str(i) for i in range(POSE_FRAMES)]:
                raise AssertionError(f"pre-calc {name}: frames {sorted(dump)}")
            boxes = []
            for i, n in enumerate(agents):
                entry = dump[str(i)]
                if len(entry) != n:
                    raise AssertionError(f"pre-calc {name} frame {i}: "
                                         f"{len(entry)} entries, {n} agents")
                for e in entry:
                    k = len(e["centers"])
                    if (set(e) != keys or len(e["scores"]) != k
                            or any(len(c) != 2 for c in e["centers"])
                            or ("uncertainty" in e and (
                                len(e["uncertainty"]) != k or any(
                                    len(u) != 3 for u in e["uncertainty"])))):
                        raise AssertionError(f"pre-calc {name} frame {i}: "
                                             "bad entry schema")
                    boxes.append(k)
            out[f"precalc_{name}"] = {
                "forwards": sum(agents), "s": secs,
                "boxes": (min(boxes), max(boxes))}

        # 2. the detector's heads (and unc_preds), kernels vs plain
        model_u = channels_last(build_weights(cfgs["uncertainty"],
                                              seed=SEED).to(dev))
        frames_u = device_frames(cfgs["uncertainty"], dev, POSE_FRAMES)
        out["uncertainty_heads_rel"] = heads_vs_plain(model_u, frames_u,
                                                      "uncertainty")
        del model_u, frames_u

        # 3. coalign.yaml at pose noise POSE_NOISE on the same frames,
        # without and with box alignment on a ground-truth dump
        cfg = cfgs["coalign"]
        gt_path = gt_dump(cfg, os.path.join(tmp, "gt_boxes.json"))
        noise = {"add_noise": True, "args": {
            "pos_std": POSE_NOISE, "rot_std": POSE_NOISE, "pos_mean": 0,
            "rot_mean": 0, "laplace": False, "von_mises": False}}
        variants = {
            "clean": apply_overrides(cfg),
            "noisy": apply_overrides(cfg, noise_setting=noise),
            "aligned": apply_overrides(
                cfg, noise_setting=noise,
                cfg_override={"box_align": {"precalc_path": gt_path}})}
        frames, align_s, calls = {}, [], {}
        with timed_box_align(align_s):
            for name, c in variants.items():
                np.random.seed(POSE_SEED)  # add_pose_noise's draws
                n0 = len(align_s)
                frames[name] = device_frames(c, dev, POSE_FRAMES)
                calls[name] = len(align_s) - n0
        if calls != {"clean": 0, "noisy": 0, "aligned": POSE_FRAMES}:
            raise AssertionError(f"box alignments run: {calls}")
        err = {name: max(float(np.abs(b["pairwise_affine"]
                                      - cb["pairwise_affine"]).max())
                         for (b, _), (cb, _) in zip(frames[name],
                                                    frames["clean"]))
               for name in ("noisy", "aligned")}
        if not 2 * err["aligned"] <= err["noisy"] or err["noisy"] <= 0:
            raise AssertionError(f"pairwise affine error vs clean: {err}")
        out["affine_err"] = err
        out["box_align_ms"] = 1e3 * sum(align_s) / len(align_s)
        model_c = channels_last(build_weights(cfg, seed=SEED).to(dev))
        _zero_counts()
        coalign_runs = {
            name: run_inference(cfg=variants[name], device="cuda",
                                model=model_c, frames=frames[name],
                                collect_heads=True)
            for name in ("noisy", "aligned")}
        launched("coalign served", POSE_LAUNCHES["coalign"], 2 * POSE_FRAMES)
        for name, r in coalign_runs.items():
            for h in r["heads"]:
                if not all(torch.isfinite(t).all() for t in h.values()):
                    raise AssertionError(f"coalign {name}: bad heads")
            out[f"serve_ms_{name}"] = _steady_ms(r["serve_s"])
        out["coalign_heads_rel"] = heads_vs_plain(model_c, frames["aligned"],
                                                  "coalign aligned")
        del frames, model_c

        # 4. one level of the box-aligned sweep, called directly
        _zero_counts()
        sweep_s = []
        with timed_box_align(sweep_s):
            sweep = run_noise_sweep(runs["coalign"], levels=(POSE_NOISE,),
                                    max_batches=POSE_FRAMES,
                                    box_align_precalc=gt_path, cfg=cfg)
        launched("box-aligned sweep", POSE_LAUNCHES["coalign"], POSE_FRAMES)
        with open(os.path.join(runs["coalign"],
                               "ap_vs_noise_gauss_boxalign.json")) as f:
            written = json.load(f)
        if (len(sweep_s) != POSE_FRAMES or set(written) != {str(POSE_NOISE)}
                or set(sweep[POSE_NOISE]) != {"ap_30", "ap_50", "ap_70"}):
            raise AssertionError(f"box-aligned sweep: {sweep}, "
                                 f"{len(sweep_s)} alignments")
        out["sweep"] = sweep[POSE_NOISE]

        # (b) the compressor finetune from a seeded m1 base (.pth)
        base_path = ckpt_lib.save_checkpoint(
            os.path.join(tmp, "base"), build_weights(cfgs["base"], seed=SEED),
            1)
        base_sd = ckpt_lib.load_state_dict(base_path)
        cfg = cfgs["compress"]
        batch, _ = next(train_tool.device_batches(cfg, COMPRESS_BATCH, dev))
        torch.cuda.empty_cache()
        _zero_counts()
        tr = train_tool.build_trainer(cfg, dev, 1, init_from=base_path)
        start = {k: v.detach().clone() for k, v in
                 tr.model.state_dict().items()}
        missing = set(start) - set(base_sd)
        if (set(base_sd) - set(start) or not missing
                or any(not k.startswith("compressor.") for k in missing)
                or any(not torch.equal(start[k].cpu(), v)
                       for k, v in base_sd.items())):
            raise AssertionError("compress: the base did not load whole, or "
                                 f"keys other than the compressor's are "
                                 f"missing: {sorted(missing)[:5]}")
        out["train"] = _steps(tr, batch, 2)
        # the frozen branch's encoder runs in eval mode: kernel 1 once a
        # step; weighted_fuse's warps forward and backward
        trained = _counts()
        k1, k2 = POSE_LAUNCHES["compress"]
        want = {"pillar_tables": 2 * k1, "shift_rows": 2 * k2,
                "shift_rows_backward": 2 * k2}
        if trained != want:
            raise AssertionError(f"compress training launches {trained}, "
                                 f"want {want}")
        for k in total:
            total[k] += trained[k]
        out["train_launches_per_step"] = {k: v / 2
                                          for k, v in trained.items()}
        after = tr.model.state_dict()
        moved = [k for k in after if not torch.equal(after[k], start[k])]
        frozen_moved = [k for k in moved if not k.startswith("compressor.")]
        still = [k for k, _ in tr.model.named_parameters()
                 if k.startswith("compressor.") and k not in moved]
        if frozen_moved or still:
            raise AssertionError(f"compress: frozen entries moved "
                                 f"{frozen_moved[:5]}, compressor "
                                 f"parameters still {still[:5]}")
        out["frozen_entries"] = len(after) - len(missing)
        out["compressor_moved"] = len(moved)
        model32 = tr.model.eval()
        del tr, batch
        torch.cuda.empty_cache()
        frames = device_frames(cfg, dev, POSE_FRAMES)
        runs_c, served = _serve(cfg, model32, frames, "compress")
        per = POSE_LAUNCHES["compress"]
        want = {"pillar_tables": 2 * POSE_FRAMES * per[0],
                "shift_rows": 2 * POSE_FRAMES * per[1],
                "shift_rows_backward": 0}
        if served != want:
            raise AssertionError(f"compress served: {served}, want {want}")
        for k in total:
            total[k] += served[k]
        out["compress_heads_rel"] = heads_vs_plain(model32, frames,
                                                   "compress")
        for d, r in runs_c.items():
            out[f"compress_serve_ms_{d}"] = _steady_ms(r["serve_s"])
        del model32, frames

    out["launches_per_frame"] = {
        name: dict(zip(("pillar_tables", "shift_rows"), POSE_LAUNCHES[name]))
        for name in POSE_LAUNCHES}
    out["s"] = time.perf_counter() - t_phase
    step = out["train"]
    print(f"[pose] pre-calc (pose_graph_pre_calc.main, {POSE_FRAMES} "
          "frames): " + "; ".join(
              f"{n} {out[f'precalc_{n}']['forwards']} forwards in "
              f"{out[f'precalc_{n}']['s']:.3f} s, {out[f'precalc_{n}']['boxes'][0]}"
              f"-{out[f'precalc_{n}']['boxes'][1]} boxes an agent"
              for n in ("coalign", "uncertainty"))
          + f"; detector heads + unc_preds vs plain max rel err "
          f"{out['uncertainty_heads_rel']:.3e} (tol {HEADS_TOL})")
    print(f"[pose] coalign.yaml at noise {POSE_NOISE}: pairwise affine max "
          f"|d| vs clean noisy {err['noisy']:.6f}, aligned "
          f"{err['aligned']:.6f}; serve ms/frame (f32, after the first) "
          f"noisy {out['serve_ms_noisy']:.3f}, aligned "
          f"{out['serve_ms_aligned']:.3f}; host box align "
          f"{out['box_align_ms']:.3f} ms a frame; heads vs plain "
          f"{out['coalign_heads_rel']:.3e}; one sweep level {out['sweep']}")
    print(f"[pose] compress finetune ({POSE_CFGS['compress']}, batch "
          f"{step['batch']}): step {step['ms']:.3f} ms f32 (after a warm "
          f"one), peak {step['peak_gib']:.3f} GiB, losses "
          + ", ".join(f"{x:.4f}" for x in step["losses"])
          + f"; {out['frozen_entries']} frozen entries bit-equal, "
          f"{out['compressor_moved']} compressor entries moved; launches a "
          f"step {out['train_launches_per_step']}; serve ms/frame f32 "
          f"{out['compress_serve_ms_f32']:.3f}, bf16 "
          f"{out['compress_serve_ms_bf16']:.3f}; heads vs plain "
          f"{out['compress_heads_rel']:.3e}")
    print(f"[pose] phase {out['s']:.1f} s; launches {total}")
    return {"launches": total, "rows": out}


def anchor_free_cfgs() -> dict:
    """Phase 10's published configs (AF_CFGS) at full width, read through
    the port's loader, on the synthetic backend with the flagship's scene
    arguments (DAIR-V2X's with AF_AGENTS agents): AF_BATCH train scenes,
    AF_FRAMES test scenes; max_cav as published (5 and 2)."""
    from heal_tpu_torch.tools.train import load_config

    root = os.path.dirname(os.path.abspath(__file__))
    scene_args = flagship_cfg()["fusion"]["args"]
    out = {}
    for name, rel in AF_CFGS.items():
        cfg = load_config(os.path.join(root, "heal_tpu", "configs", rel))
        cfg["fusion"]["dataset"] = "synthetic"
        cfg["fusion"]["args"] = dict(
            scene_args, num_scenes_train=AF_BATCH, num_scenes_test=AF_FRAMES,
            num_agents=AF_AGENTS.get(name, scene_args["num_agents"]))
        out[name] = cfg
    return out


def path_kernels(name: str, cfg, model, inputs, gen) -> list:
    """Both kernels on this path's own inputs against their plain
    versions: kernel 1 on the first frame's encoder arguments (CenterPoint
    only), kernel 2 at the fusion warp's shapes (the non-ego agents'
    (292, 292, C) canvases with shear-sized shifts, f32 and bf16, then
    small integer shifts on the (128, 256, C) crops, f32)."""
    cases = []
    if AF_LAUNCHES[name][0]:
        enc = model.CenterPointBaseline_0.encoder
        for dt in (torch.float32, torch.bfloat16):
            cases.append(pillar_case(
                f"{name} frame", frame_inputs(enc, inputs["points"][0],
                                              inputs["point_mask"][0], dt),
                dt))
    b, l = inputs["points"].shape[:2]
    # the fused map: the shrink header's width, 128 x 256
    width = cfg["model"]["args"]["shrink_header"]["dim"][-1]
    n, side = b * (l - 1), 292
    ms_bound = int(math.ceil(0.7072 * side / 2)) + 2
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((n, side, side, width), generator=gen,
                        device="cuda").to(dt)
        s = (torch.rand((n, side), generator=gen, device="cuda") * 2 - 1
             ) * ms_bound
        for axis in ("rows", "cols"):
            cases += shift_case(x, s, ms_bound, axis, gen, f"{name} ")
    # the crops' constant integer shifts (bound w and h): the remainders
    # of translations past the canvas margin, small where they are not 0
    x = torch.randn((n, 128, 256, width), generator=gen, device="cuda")
    for axis, length, reach in (("rows", 128, 256), ("cols", 256, 128)):
        s = torch.randint(-4, 5, (n, 1), generator=gen,
                          device="cuda").float().expand(n, length)
        cases += shift_case(x, s, reach, axis, gen, f"{name} crop ")
    return cases


def phase_anchor_free(cfgs: dict) -> dict:
    """CenterPoint with Where2comm and DAIR-V2X's SECOND intermediate
    detector on their published configs (module docstring, phase 10);
    returns each kernel's launches over the phase and the measurements."""
    from heal_tpu_torch.models.layers import channels_last
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import build_weights, device_frames

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t_phase = time.perf_counter()
    total = {k: 0 for k in _counts()}
    rows = {}
    for name, cfg in cfgs.items():
        torch.cuda.empty_cache()
        k1, k2 = AF_LAUNCHES[name]
        frames = device_frames(cfg, dev, AF_FRAMES)
        model32 = channels_last(build_weights(cfg, seed=SEED).to(dev))
        row = {"kernels": path_kernels(name, cfg, model32, frames[0][1],
                                       gen)}
        runs, served = _serve(cfg, model32, frames, name)
        want = {"pillar_tables": 2 * AF_FRAMES * k1,
                "shift_rows": 2 * AF_FRAMES * k2, "shift_rows_backward": 0}
        if served != want:
            raise AssertionError(f"{name} served: launches {served}, want "
                                 f"{want}")
        for k in total:
            total[k] += served[k]
        row["heads_rel"] = heads_vs_plain(model32, frames, name)
        for d, r in runs.items():
            row[f"serve_ms_{d}"] = _steady_ms(r["serve_s"])
        row["ap_30_f32"] = runs["f32"]["ap_30"]
        if name == "center_point":
            row["comm_rate"] = runs["f32"]["comm_rate"]
            if not 0 < row["comm_rate"] <= 1:
                raise AssertionError(f"{name} comm_rate {row['comm_rate']}")
        del model32, frames, runs
        torch.cuda.empty_cache()

        batch, _ = next(train_tool.device_batches(cfg, AF_BATCH, dev))
        _zero_counts()
        tr = train_tool.build_trainer(cfg, dev, 1)
        start = {n: p.detach().clone()
                 for n, p in tr.model.named_parameters() if p.requires_grad}
        row["train"] = _steps(tr, batch, 2)
        trained = _counts()
        want = {"pillar_tables": 0, "shift_rows": 2 * k2,
                "shift_rows_backward": 2 * k2}
        if trained != want:
            raise AssertionError(f"{name} training launches {trained}, "
                                 f"want {want}")
        for k in total:
            total[k] += trained[k]
        # a softmax shift's gradient is zero by construction: it needs
        # one, and need not move
        from heal_tpu_torch.models.fuse import softmax_shift_biases
        shifts = softmax_shift_biases(tr.model)
        still = [n for n, p in tr.model.named_parameters()
                 if n in start and n not in shifts
                 and torch.equal(p.detach(), start[n])]
        still += no_gradient({n: p for n, p in tr.model.named_parameters()
                              if n in start and n in shifts}, tr.model)
        if still:
            raise AssertionError(f"{name}: trainable parameters that did "
                                 f"not move: {still[:5]}")
        row["trainable"] = len(start)
        del tr, batch, start
        rows[name] = row

        step = row["train"]
        print(f"[anchor_free] {AF_CFGS[name]} ({name}): serve ms/frame "
              f"(after the first of {AF_FRAMES}) f32 "
              f"{row['serve_ms_f32']:.3f}, bf16 {row['serve_ms_bf16']:.3f}; "
              f"launches a frame kernel 1 {k1}, kernel 2 {k2}; f32 heads vs "
              f"plain max rel err {row['heads_rel']:.3e} (tol {HEADS_TOL})"
              + (f"; comm_rate {row['comm_rate']:.4f}" if "comm_rate" in row
                 else "")
              + f"; train step {step['ms']:.3f} ms f32 (batch "
              f"{step['batch']}, after a warm one), peak "
              f"{step['peak_gib']:.3f} GiB, losses "
              + ", ".join(f"{x:.4f}" for x in step["losses"])
              + f"; all {row['trainable']} trainable parameters moved "
              "(the softmax shifts: with a gradient); "
              f"launches a step {({k: v / 2 for k, v in trained.items()})}")
    print(f"[anchor_free] phase {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return {"launches": total, "rows": rows}


def phase_pipeline() -> None:
    """Epochs of the demo stage-2 m2 config on the host clock: batches
    assembled serially, through the prefetch pipeline, and from the
    device cache; turns serial, pipeline, pipeline, serial, then the
    cache (its build timed apart)."""
    from heal_tpu_torch.data import build_dataset
    from heal_tpu_torch.tools import train as train_tool

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = train_tool.load_config(os.path.join(root, "heal_tpu", "configs",
                                              PIPELINE_CFG))
    cfg["fusion"]["args"]["num_scenes_train"] = PIPELINE_SCENES
    bs = cfg["train_params"]["batch_size"]
    ds = build_dataset(cfg, train=True)
    steps = len(ds) // bs
    tr = train_tool.build_trainer(cfg, dev, steps)
    tr.train_step(next(train_tool.device_batches(cfg, bs, dev,
                                                 dataset=ds))[0])

    def epoch(batches) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 0
        for b in batches:
            tr.train_step(b)
            n += 1
        torch.cuda.synchronize()
        if n != steps:
            raise AssertionError(f"an epoch of {n} steps, want {steps}")
        return time.perf_counter() - t0

    out = {"serial": [], "prefetch": []}
    for turn, name in enumerate(("serial", "prefetch", "prefetch",
                                 "serial")):
        out[name].append(epoch(
            (b for b, _ in train_tool.device_batches(
                cfg, bs, dev, shuffle=True, seed=turn, dataset=ds))
            if name == "serial" else
            train_tool.epoch_batches(ds, bs, turn, dev)))
    t0 = time.perf_counter()
    cached = train_tool.cache_batches(ds, bs, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out["cached"] = [epoch(train_tool.epoch_batches(ds, bs, 4, dev, cached))]
    print(f"[pipeline] {PIPELINE_CFG}, an epoch of {steps} steps of {bs} "
          f"({PIPELINE_SCENES} scenes of 384), host clock: serial "
          + ", ".join(f"{t:.3f}" for t in out["serial"])
          + " s; prefetch pipeline (depth "
          f"{train_tool.PREFETCH_DEPTH}) "
          + ", ".join(f"{t:.3f}" for t in out["prefetch"])
          + f" s; from the device cache {out['cached'][0]:.3f} s (built in "
          f"{build_s:.3f} s)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    # cuBLAS reads this when it makes its handle: needed for the
    # deterministic train-step comparison
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    smi = phase_card()
    phase_build()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from heal_tpu_torch.tools.inference import build_weights

    cfg = flagship_cfg()
    pcfgs = protocol_cfgs()
    model32 = build_weights(cfg, seed=SEED).cuda().to(
        memory_format=torch.channels_last)
    rows = phase_kernels(cfg, model32, pcfgs["final"])
    launches = phase_serve(cfg, model32)
    trained = phase_train(cfg, model32)
    del model32
    torch.cuda.empty_cache()
    protocol = phase_protocol(pcfgs)
    torch.cuda.empty_cache()
    baselines = phase_baselines(baseline_cfgs())
    torch.cuda.empty_cache()
    fusion = phase_fusion_timings(fusion_cfgs())
    torch.cuda.empty_cache()
    pose = phase_pose(pose_cfgs())
    torch.cuda.empty_cache()
    anchor_free = phase_anchor_free(anchor_free_cfgs())
    phase_pipeline()
    for name in rows:
        rows[name]["protocol_launches"] = protocol["launches"][name]
        rows[name]["alliance_launches_per_frame"] = ALLIANCE_LAUNCHES[name]
        rows[name]["baselines_launches"] = baselines["launches"][name]
        rows[name]["baseline_launches_per_frame"] = {
            b: r["launches_per_frame"][name]
            for b, r in baselines["rows"].items()}
        rows[name]["fusion_timings_launches"] = fusion["launches"][name]
        rows[name]["fusion_timings_launches_per_frame"] = {
            c: r["launches_per_frame"][name]
            for c, r in fusion["rows"].items() if "launches_per_frame" in r}
        rows[name]["fusion_timings_launches_per_step"] = {
            c: r["train_launches_per_step"][name]
            for c, r in fusion["rows"].items()
            if "train_launches_per_step" in r}
        rows[name]["pose_launches"] = pose["launches"][name]
        rows[name]["pose_launches_per_forward"] = {
            c: n[name] for c, n in pose["rows"]["launches_per_frame"].items()}
        rows[name]["pose_compress_launches_per_step"] = pose["rows"][
            "train_launches_per_step"][name]
        rows[name]["anchor_free_launches"] = anchor_free["launches"][name]
        rows[name]["anchor_free_launches_per_frame"] = {
            c: AF_LAUNCHES[c][name == "shift_rows"] for c in AF_CFGS}
    # phase 10's own kernel cases (the CenterPoint frame's kernel 1, the
    # fusion warps' kernel 2) join the rows' cases and worst errors
    for r in anchor_free["rows"].values():
        for case in r["kernels"]:
            row = rows["pillar_tables" if "u" in case else "shift_rows"]
            row["cases"].append(case)
            err = ("backward_max_abs_err"
                   if case.get("direction") == "backward" else "max_abs_err")
            row[err] = max(row[err], case["max_abs_err"])
    rows["pillar_tables"]["train_launches"] = trained["pillar_tables"]
    rows["shift_rows"]["train_launches"] = trained["shift_rows"]
    rows["shift_rows"]["backward_launches"] = trained["shift_rows_backward"]
    rows["shift_rows"]["fusion_timings_backward_launches_per_step"] = {
        c: r["train_launches_per_step"]["shift_rows_backward"]
        for c, r in fusion["rows"].items() if "train_launches_per_step" in r}

    meta = {
        "pillar_tables": ("heal_tpu_torch/csrc/pillar_tables.cu",
                          "heal_tpu/ops/pallas_pillar.py:214"),
        "shift_rows": ("heal_tpu_torch/csrc/shift_rows.cu",
                       "heal_tpu/ops/pallas_shear.py:54"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **rows[name]}
        for name, (src, rep) in meta.items()
    ]
    for k in kernels:
        print(f"[kernels] {k['name']}: launches {k['launches']} serving, "
              f"{k['train_launches']} training forward"
              + (f", {k['backward_launches']} backward"
                 if "backward_launches" in k else "")
              + f", {k['protocol_launches']} in the protocol phase "
              f"({k['alliance_launches_per_frame']} a served alliance frame)"
              f", {k['baselines_launches']} in the baselines phase (a "
              f"frame: {k['baseline_launches_per_frame']})"
              f", {k['fusion_timings_launches']} in the fusion timings phase "
              f"(a frame: {k['fusion_timings_launches_per_frame']})"
              f", {k['pose_launches']} in the pose and bandwidth phase (a "
              f"forward: {k['pose_launches_per_forward']})"
              f", {k['anchor_free_launches']} in the anchor-free and SECOND "
              f"phase (a frame: {k['anchor_free_launches_per_frame']})"
              + f"; {k['bytes']} bytes, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), {k['ms']:.4f} ms = {k['pct_of_bound']:.1f}%"
              f" of bound, plain {k['plain_ms']:.4f} ms, library call "
              + (f"{k['library_ms']:.4f} ms" if k["library_ms"] is not None
                 else "none"))
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
