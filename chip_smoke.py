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
     with -s, against shift_*_plain(g, -s)); kernel 3 (one SECOND conv
     layer) at the alliance's m3 shapes, the first layer of each of its
     six (Cin, Cout, stride), each call one device kernel and no host
     sync, with its bound (the bytes, or the occupied output voxels'
     products at 67 TFLOP/s), then the m3 encoder with kernel 3 and with
     the plain layers (10 launches a forward). Every later phase counts
     kernel 3 too: M3_LAUNCHES an f32 eval forward of a SECOND encoder
     (the alliance's m3, the m1m2m3m4 baselines, the SECOND detectors),
     never in bf16, in training or in a flagship frame; kernel 4 (the
     window attention of V2X-ViT's MSwin branches) at the v2xvit.serve
     cell's three branches, each call one device kernel and no host
     sync, with its bound and F.scaled_dot_product_attention's time as a
     yardstick, then the published V2X-ViT fusion on the cell's maps
     with kernel 4 and with the plain versions (9 launches a forward).
     Every serving phase checks kernel 4 too: one launch an MSwin branch
     of an f32 eval forward (the V2X-ViT baselines), never in bf16, in
     training or outside V2X-ViT;
  4. serve 8 synthetic flagship frames through
     heal_tpu_torch.tools.inference.run_inference with seeded random
     weights, f32 (TF32 off) and bf16 (points, affines and decode f32);
     the f32 heads must match the same frames run with the plain kernel
     versions on the card; kernels 1 and 2's launch counters must rise
     while serving, kernel 3's stay 0; frames/s for both, and the
     exact-vs-shear warp time;
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
 11. the disk datasets: trees written under a temporary directory by the
     port's own writers at DISK_SEED (heal_tpu_torch/data/{opv2v,
     dairv2x,v2xsim}.py): an OPV2V tree of DISK_CAVS agents and
     DISK_TIMESTAMPS timestamps with 4 camera PNGs an agent at OPV2V's
     600x800, a DAIR-V2X-C tree and a V2X-Sim pickle, every lidar agent
     at least max_points (30000) points in range (DISK_GROUND_POINTS /
     DISK_BOX_POINTS); the native and numpy PCD readers held equal on an
     ascii and a binary PCD and timed, a frame's five sweeps; then, from
     the files, at full width with seeded random weights: the published
     heal_tpu/configs/opv2v/heal/final_infer/m1m2m3m4.yaml (its modalities
     drawn by the backend; the m2 agents read their PNGs, the config's
     data_aug_conf given the images' size and the crop policy of
     demo_heal_full/final_m1m2m3m4.yaml: DISK_AUG),
     dairv2x/m1_pyramid.yaml (a vehicle and a roadside unit) and
     v2xsim/point_pillar_fcooper.yaml served f32 and bf16 through
     tools.inference.run_inference (the host's read and assemble time a
     frame on the host clock, apart), kernel 1 on the first OPV2V frame's
     m1 encoder against its plain version, exact launches a frame
     (DISK_LAUNCHES), the f32 heads within HEADS_TOL of the plain kernel
     versions; opv2v/heal/stage1/m1_pyramid.yaml trained through
     tools/train.py's host-fed loop (epoch_batches: the backend
     reinitialised, the prefetch worker) at the published batch of 4, a
     warm and two timed steps (every trainable parameter moved; kernel 2
     15 times a step forward and backward, kernel 1 never), ms and peak
     memory;
 12. the camera-only table and the models' other options
     (camera_and_options), at full width with seeded random weights on
     synthetic scenes with the flagship's scene arguments: the eight
     heal_tpu/configs/opv2v/camera_only/*.yaml as published (4 cameras at
     384x512, 48 depth bins, the 128x128 camera grid padded to the
     128x256 label grid), one set of CAMERA_FRAMES frames served f32 and
     bf16 by each (kernel 1 never, kernel 2 CAMERA_LAUNCHES a frame, heads
     vs plain) and two f32 train steps at CAMERA_BATCH (published 4;
     kernel 2 CAMERA_BACKWARD times backward, every fusion parameter with
     a gradient, nonzero but the softmax shifts);
     heal/stage2/m4_alignto_m1.yaml with each of the scaligner, sdta, cbam
     and fanet aligners (derived): a warm and a timed stage-2 step at the
     published batch (the frozen base bit-equal, every aligner parameter
     moved), ALIGNER_FRAMES frames served (kernel 1 once a frame);
     use_iou on lidar_only/att.yaml (derived; JAX's multiscale baseline of
     coalign.yaml builds no IoU head): IOU_FRAMES frames served, two steps
     at batch 4 with a nonzero iou_loss (kernel 1 once, kernel 2 5 times a
     frame); JAX's default group norm on more_modality/m1m2_lateheter.yaml
     (norm removed): GROUP_FRAMES late frames served and a warm and a
     timed step at its batch of 4, no kernel launched (the m1 encoder's
     general path); lift_splat_shoot_intermediate (max fusion, kernel 2 5
     times a frame) and lift_splat_shoot (late frames) from
     camera_only/fcooper.yaml's m2 block (derived), LSS_FRAMES frames on
     the 128x128 camera grid; serve ms a frame (median and range after
     the first) with the serving peak, step ms and peak GiB; exact
     launches throughout;
 13. the last detectors (legacy), at full width with seeded random
     weights on synthetic scenes with the flagship's scene arguments, on
     configs derived from published ones (legacy_cfgs: no published
     config names these models): the multiscale PointPillars baseline
     (opv2v/lidar_only/max.yaml), DiscoNet's teacher (early fusion) and
     student (opv2v/lidar_only/disconet.yaml with kd_flag), VoxelNet and
     PIXOR alone (early fusion) and intermediate (max), CIA-SSD and
     SECOND-SSFA with and without its uncertainty head (early fusion) and
     FPV-RCNN (intermediate2stage) on dairv2x/second_coalign.yaml's SECOND;
     both kernels on the paths' own inputs against their plain versions
     (kernel 1 on the multiscale frame and the teacher's merged view, f32
     and bf16; kernel 2 on every distinct warp call of the multiscale
     frame and of DiscoNet's, f32, the square shear canvases in bf16 too);
     LEGACY_FRAMES frames served f32 and bf16 through
     tools.inference.run_inference (FPV-RCNN's through decode_stage2),
     exact launches a frame (LEGACY_LAUNCHES), the f32 heads within
     HEADS_TOL of the plain kernel versions, then a warm and a timed f32
     train step at LEGACY_BATCH (PIXOR's batch with CenterPoint's labels,
     center_batch) through tools/train.build_trainer, every trainable
     parameter moved but the softmax shifts and the ones the loss does not
     reach (LEGACY_UNREACHED); DiscoNet's step is the KD step
     (tools/train_w_kd.KDTrainer with the teacher saved to a temporary run
     dir and loaded by load_teacher): kernel 1 once a step (the frozen
     teacher), kernel 2 forward and backward, the teacher bit-equal after
     it, kd_loss > 0; then tools.train_w_kd.main runs an epoch of one step
     from that run dir; serve ms a frame (median and range after the
     first) with the serving peak, step ms and peak GiB;
 14. the tools, viewers and weight transplant (phase_tools, ``[tools]``
     lines): first which optional packages the card's host has
     (matplotlib, scikit-learn, open3d); a seeded synthetic
     opencood-named state_dict of the flagship's HeterPyramidCollab
     (utils/transplant.synthetic_reference) transplanted into the port's
     flagship at full width and loaded strictly, its layout maps held
     element by element (the PFN transpose, OIHW, grouped -> dense
     block-diagonal and the deconv's double flip, the last two also as
     F.conv2d(groups=32) and F.conv_transpose2d on the card), then
     TOOLS_FRAMES frames served f32 and bf16 (1 + 15 launches a frame,
     f32 heads within HEADS_TOL of the plain kernel versions); a
     synthetic spconv VoxelBackBone8x state_dict transplanted into
     models/second.SecondRefEncoder with the m3 agent's encoder args
     (opv2v/heal/stage2/m3_alignto_m1.yaml) and run on one frame of its
     cloud beside the column engine's encoder (ms a frame each), and the
     oracle engine's voxelization, submanifold and strided convs held to
     the column engine's on the same sites and weights (ORACLE_TOL);
     tools/profiler.main on the flagship (f32 and bf16, --train at its
     batch of 2: params, the FlopCounterMode count with kernels 1 and
     2's operations apart, ms and fps, peak memory); tools/bench_matrix
     .main's six rows at --frames BENCH_FRAMES; tools/train.main on
     opv2v/heal/stage1/m1_pyramid.yaml (AP_SCENES, batch AP_BATCH,
     AP_EPOCHS epochs, a checkpoint every epoch; its scripts/ snapshot
     without a built library) and tools/ap_curve.main over it; the CPM
     sizes of FPV-RCNN's keypoint messages (phase 13's derived config)
     and of Where2comm's sent cells
     (opv2v/lidar_only/center_point_where2comm.yaml), raw / quantized /
     zlib KB a frame (utils/cpm_size.py); inference --save_vis on the
     transplanted flagship (the PNG, where matplotlib is installed), the
     frame drawn on visualization.canvas.CanvasBEV with pixels drawn in
     every GT box's footprint, and CKA / MMD between two agents' BEV
     features from the card (t-SNE where scikit-learn is installed);
     exact launches throughout (TOOLS_LAUNCHES, BENCH_LAUNCHES);
 15. the input pipeline: epochs of heal_tpu/configs/demo_heal_full/
     stage2_m2.yaml (PIPELINE_SCENES train scenes) timed on the host
     clock, batches assembled serially, through the prefetch pipeline
     (tools/train.py, data/prefetch.py), and from the device cache of
     cache_device_batches;
 16. the device mesh (phase_multi_device, ``[multi]`` lines;
     heal_tpu_torch/parallel/sharding.py): the flagship's step on a
     one-rank NCCL world (every collective of the mesh step runs: the
     batch norms' moments, the gradient all-reduce, the aux mean) against
     the plain Trainer step from the same weights and batch under
     deterministic algorithms: the loss and every gradient bit-equal
     (both run one arithmetic; a world of one sums nothing), kernel 2
     launched 15 + 15 times a step and kernel 1 never; ms/step of both
     in turns (plain, mesh, mesh, plain), the peak, the host's clocks a
     step (process and main-thread CPU, Python's GC), and one step of
     each traced by torch.profiler with the kernels whose device time
     differs most; MULTI_STEPS steps through
     tools/train.main --devices 1 (loss finite and falling, the
     checkpoint loaded strictly by one process); then the flagship's
     step on two gloo ranks sharing the card for each axis
     (GLOO_MESHES; the agent run at MULTI_AGENTS agent slots) through
     tools/dryrun_multichip.sharded_results against one process on the
     card, loss and gradients within MULTI_TOL.
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
                                          frame_inputs)
from heal_tpu_torch.kernels.measure import (bound, device_busy, device_kernels,
                                           device_ms)
from heal_tpu_torch.ops import KERNELS as OP_KERNELS
from heal_tpu_torch.ops.pillar import pillar_work

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
# the kernels as the launch counts name them; the launch tables below
# index the first three: kernel 4 launches only in V2X-ViT's f32 eval
# forwards, k4_per_forward a forward
KERNELS = tuple(k.name for k in OP_KERNELS)
# kernel-3 launches an f32 eval forward of a SECOND encoder at the
# published widths on the card: one a conv layer (conv_input, three
# strided, six submanifold). bf16 and training take its plain version
M3_LAUNCHES = 10
# a served alliance frame: kernel 1 once per PointPillars branch (m1,
# m4), kernel 2 in weighted_fuse (3 levels x 5), kernel 3 (m3) in its f32
# frames only
ALLIANCE_LAUNCHES = {"pillar_tables": 2, "shift_rows": 15,
                     "column_conv": M3_LAUNCHES, "window_attention": 0}
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
# (kernel 1, kernel 2, kernel 3) launches a forward, counted from the
# code: kernel 1 once in CenterPoint's eval encoder (all B*L agents in one
# call) and never in SECOND; kernel 2 five times a warp_agents_to_ego
# (three shears and two integer shifts), the where2comm or att fusion's
# one warp; kernel 3 M3_LAUNCHES times an f32 SECOND forward. A train
# step launches kernel 2 as often again backward, kernels 1 and 3 never
AF_LAUNCHES = {"center_point": (1, 5, 0), "second": (0, 5, M3_LAUNCHES)}
# phase 11: the disk datasets, published configs read from files the
# phase writes (heal_tpu/configs/...)
DISK_CFGS = {"opv2v": "opv2v/heal/final_infer/m1m2m3m4.yaml",
             "dairv2x": "dairv2x/m1_pyramid.yaml",
             "v2xsim": "v2xsim/point_pillar_fcooper.yaml"}
DISK_TRAIN_CFG = "opv2v/heal/stage1/m1_pyramid.yaml"
# the published camera configs give only final_dim, cams and Ncams: the
# image size is the written one, the crop policy the demo alliance's m2
DISK_AUG = "demo_heal_full/final_m1m2m3m4.yaml"
DISK_SEED = 0
DISK_CAVS = 5
DISK_TIMESTAMPS = 6
DISK_IMG_HW = (600, 800)  # OPV2V's camera images
# a 64-line sweep's density: ~60000 of ~80000 points in range an agent
DISK_GROUND_POINTS = 60000
DISK_BOX_POINTS = 2000
DISK_FRAMES = {"opv2v": 6, "dairv2x": 4, "v2xsim": 4}
DISK_BATCH = 4  # published
# (kernel 1, kernel 2, kernel 3) launches a served frame: every branch
# runs on its fixed-capacity packing whatever modalities the backend drew,
# so kernel 1 runs once per PointPillars branch (the alliance's m1 and m4;
# the m1 of DAIR-V2X's pyramid; V2X-Sim's one encoder), kernel 2 five
# times a warp call (the pyramid's 3 levels; fcooper's one ego warp) and
# kernel 3 M3_LAUNCHES times in an f32 frame of the alliance (its m3)
DISK_LAUNCHES = {"opv2v": (2, 15, M3_LAUNCHES), "dairv2x": (1, 15, 0),
                 "v2xsim": (1, 5, 0)}
# phase 12, the camera-only table and the models' other options
# (heal_tpu/configs/opv2v/...): the eight camera_only configs as published
# (CAMERA_FRAMES test frames, one train batch of CAMERA_BATCH), the four
# other aligners on a stage-2 config, use_iou, group norm and the
# standalone Lift-Splat-Shoot detectors on derived configs (camera_cfgs)
CAMERA_ONLY = ("fcooper", "attfuse", "disconet", "v2vnet", "cobevt",
               "v2xvit", "coalign", "m2_pyramid")
CAMERA_FRAMES = 4
CAMERA_BATCH = 2  # published 4
# kernel-2 launches a served camera-only frame, 5 a warp call (one ego
# warp; V2VNet's field-of-view and two pairwise warps; CoAlign's two
# fused levels; the pyramid's three levels); kernel 1 never (no lidar
# branch). A train step launches kernel 2 as often backward, but for
# V2VNet's field-of-view warp of a mask, which has no gradient
CAMERA_LAUNCHES = {"fcooper": 5, "attfuse": 5, "disconet": 5, "v2vnet": 15,
                   "cobevt": 5, "v2xvit": 5, "coalign": 10, "m2_pyramid": 15}
CAMERA_BACKWARD = {**CAMERA_LAUNCHES, "v2vnet": 10}
ALIGNERS = ("scaligner", "sdta", "cbam", "fanet")
ALIGNER_CFG = "heal/stage2/m4_alignto_m1.yaml"  # published batch 4
ALIGNER_FRAMES = 2
# use_iou on a derived lidar_only/att.yaml (point_pillar_baseline, which
# JAX gives the IoU head; its heter_model_baseline_ms, coalign.yaml's
# model, builds none), the published batch of 4
IOU_CFG = "lidar_only/att.yaml"
IOU_FRAMES = 4
IOU_BATCH = 4
# JAX's default group norm on heter_model_late: norm removed
GROUP_CFG = "more_modality/m1m2_lateheter.yaml"
GROUP_BATCH = 4  # published
GROUP_FRAMES = 2  # a late frame timed after a warm one
# the standalone LSS detectors from camera_only/fcooper.yaml's m2 block
LSS_FROM = "camera_only/fcooper.yaml"
LSS_FRAMES = 4
# (kernel 1, kernel 2) launches a forward: use_iou's att baseline (its one
# encoder call, one ego warp); the late m1 + m2 model on group norm (the
# PointPillars branch on the encoder's general path, no warp); the
# stage-2 m4 model (its branch, forward_single: no warp); LSS
# intermediate's max fusion (one ego warp) and LSS alone (neither)
OPTION_LAUNCHES = {"iou": (1, 5), "group": (0, 0), "aligner": (1, 0),
                   "lss_intermediate": (0, 5), "lss": (0, 0)}
# phase 13 (legacy): the last detectors on configs derived from published
# ones (legacy_cfgs), LEGACY_FRAMES test frames each and one train batch
# of LEGACY_BATCH (published 4)
LEGACY_FRAMES = 4
LEGACY_BATCH = 2
LEGACY_LIDAR = "opv2v/lidar_only/max.yaml"
LEGACY_DISCONET = "opv2v/lidar_only/disconet.yaml"
LEGACY_PIXOR = "opv2v/lidar_only/center_point_where2comm.yaml"
LEGACY_SECOND = "dairv2x/second_coalign.yaml"
# (kernel 1, kernel 2, kernel 3) launches a served frame, rehearsed on
# the CPU with spies (the warp forced to the shear path): the multiscale
# baseline warps its three levels (5 each), DiscoNet and the intermediate
# VoxelNet and PIXOR their fused map once; the teacher is a PointPillars
# detector on early frames; VoxelNet, PIXOR and the SECOND detectors
# launch neither kernel 1 nor 2, FPV-RCNN neither (it moves boxes and
# keypoints, not maps); the SECOND detectors and FPV-RCNN run one SECOND
# encoder a forward, kernel 3 M3_LAUNCHES times in f32. A train step:
# kernel 1 never (the KD step's frozen teacher: once), kernel 2 as often
# backward as forward, kernel 3 never
LEGACY_LAUNCHES = {
    "multiscale": (1, 15, 0), "disconet": (1, 5, 0),
    "disconet_teacher": (1, 0, 0), "voxel_net": (0, 0, 0),
    "voxel_net_intermediate": (0, 5, 0), "pixor": (0, 0, 0),
    "pixor_intermediate": (0, 5, 0), "ciassd": (0, 0, M3_LAUNCHES),
    "second_ssfa": (0, 0, M3_LAUNCHES),
    "second_ssfa_uncertainty": (0, 0, M3_LAUNCHES),
    "fpvrcnn": (0, 0, M3_LAUNCHES)}
# phase 14 (tools): TOOLS_FRAMES flagship frames served after the
# transplant and one drawn by --save_vis; the profiler's timed forwards
# (train steps: half as many, after a warm one; plus one counted and 5
# warm forwards); bench_matrix at --frames BENCH_FRAMES (a warm and 3
# timed passes); the ap_curve run: (train, test) scenes, batch, epochs and
# ap_curve's --max_batches; the CPM frames; CKA's sampled BEV cells
TOOLS_FRAMES = 4
TOOLS_ITERS = 20
BENCH_FRAMES = 4
BENCH_STEPS = 10  # bench_matrix's train rows (after a warm step)
AP_SCENES = (4, 2)
AP_BATCH = 2
AP_EPOCHS = 2
AP_FRAMES = 2
CPM_FRAMES = 2
CKA_CELLS = 2048
# the oracle engine vs the column engine, f32: max |d| / (1 + max |col|)
# (the two sum a conv's taps in different orders)
ORACLE_TOL = 1e-5
# (kernel 1, kernel 2, kernel 3) launches a forward: the flagship
# (transplanted, profiled, ap_curve's stage-1 model); bench_matrix's
# paths (the m3 single model and SECOND bypass kernels 1 and 2; the
# camera has no kernel 1; bench_matrix serves in bf16, so kernel 3
# never); a pp_max train step launches kernel 2 5 times each way
TOOLS_LAUNCHES = (1, 15, 0)
BENCH_LAUNCHES = {"pp_max": (1, 5, 0), "second": (0, 0, 0),
                  "lss": (0, 15, 0), "heter4": (2, 15, 0)}
BENCH_TRAIN_SHIFTS = 5
# the paths whose own inputs the kernels are held on (kernel 1, kernel 2):
# the multiscale baseline's frame and its three levels' warps, the KD
# teacher's early-fused view, DiscoNet's fused-map warp (the intermediate
# VoxelNet and PIXOR warp maps of its shape)
LEGACY_CASES = {"multiscale": (True, True), "disconet_teacher": (True, False),
                "disconet": (False, True)}
# parameters a step's loss does not reach: VoxelNet's direction head
# (voxel_net_loss has no direction term); FPV-RCNN's residual layer while
# no RoI passes fg_thresh (rcnn_reg_loss 0, as at a seeded init). Their
# gradient is 0, as in JAX, and a zero bias stays
# phase 16: the device mesh. The one-rank NCCL step is held bit-equal to
# the plain step (deterministic algorithms, TF32 off). Two gloo ranks
# against one process: JAX's own bounds (__graft_entry__.dryrun_multichip
# at init), the loss within 1e-5 and every gradient within 1e-3 of
# max(1, loss); their sums are split over two ranks, so they differ by
# f32 rounding, which train-mode batch norm amplifies at a seeded init
MULTI_TOL = {"loss": 1e-5, "grad": 1e-3}
MULTI_PROFILE_TOP = 6  # kernels named in the profile of the two steps
MULTI_STEPS = 4  # steps of tools/train.main --devices 1
MULTI_TIMED = 3  # timed steps a turn
# gloo carries CUDA tensors for every collective the mesh runs
# (all-reduce, all-gather, the autograd gather, bf16: probed on the H100
# in the first card run of this phase), and unlike NCCL it lets two ranks
# share the one card: a data, an agent and a model split of two ranks
GLOO_MESHES = {"data": (2, 1, 1), "agent": (1, 2, 1), "model": (1, 1, 2)}
# the agent run's agent slots: the flagship's 5 do not split over 2 ranks
# (every rank would run all of them), 4 give each rank 2
MULTI_AGENTS = 4
LEGACY_UNREACHED = {"voxel_net": "DetectionHeads_0.dir_head.",
                    "voxel_net_intermediate": "DetectionHeads_0.dir_head.",
                    "fpvrcnn": "roi_head.reg."}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, that over 1 + max |b|)."""
    d = (a.float() - b.float()).abs().max().item()
    return d, d / (1.0 + b.float().abs().max().item())


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the kernels' plain PyTorch versions (for the
    reference run only): each kernel's launching function (ops.KERNELS)
    is swapped for its plain version at module level."""
    from heal_tpu_torch.ops import launches_replaced

    with launches_replaced(lambda k: getattr(k.module, k.plain)):
        yield


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
        launched = trace_in_fresh_process([(list(args), {})])
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
from heal_tpu_torch.ops import KERNELS
calls = torch.load(sys.argv[1], weights_only=False)
k = next(k for k in KERNELS if k.name == sys.argv[2])
fn = getattr(k.module, k.launch)
def run():
    with torch.inference_mode():
        for args, kwargs in calls:
            fn(*args, **kwargs)
print(json.dumps(device_kernels(run)))
"""


def trace_in_fresh_process(calls, kernel: str = "pillar_tables") -> list:
    """``device_kernels`` of ``calls`` [(args, kwargs)] of the launching
    function of ``kernel`` (a name of ops.KERNELS), saved to a temporary
    file, in a new Python process with its own CUPTI session."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "calls.pt")
        torch.save(list(calls), path)
        proc = subprocess.run([sys.executable, "-c", _TRACE, path, kernel],
                              cwd=root, capture_output=True, text=True,
                              timeout=300, env=dict(os.environ,
                                                    PYTHONPATH=root))
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


def column_conv_work(cols, table, weights, out_cols) -> dict:
    """The work of kernel 3 on these arguments: ``flops`` the products of
    the agents' valid output columns, every z layer of them (2*27*Cin*Cout
    a voxel; the epilogue's few operations a channel left out), ``bytes``
    the valid input columns' features and occupancy, the table, the
    weights and LayerNorm's parameters read once and the whole output
    written once; ``voxels`` those output voxels. The function needs the
    products of the occupied output voxels alone (every other output is
    0): :func:`column_conv_case` bounds by those."""
    b, vc, z, cin = cols["feats"].shape
    cout = weights.shape[-1]
    dst = out_cols if out_cols is not None else cols
    zo = dst["grid"][0]
    o = dst["cvalid"].shape[1]
    voxels = int(dst["cvalid"].sum()) * zo
    n_in = int(cols["cvalid"].sum())
    out_bytes = b * o * zo * (cout * 4 + (out_cols is not None))
    return dict(
        flops=2 * 27 * cin * cout * voxels, voxels=voxels,
        bytes=(n_in * z * (cin * 4 + 1) + table.numel() * 4
               + weights.numel() * 4 + 2 * cout * 4 + b * o + out_bytes),
        zo=zo, o=o)


def column_conv_layers(enc, points, mask) -> list:
    """Kernel 3's arguments at each conv layer of the SECOND encoder
    ``enc`` (eval) on these agents, in order: (name, args, kwargs) of
    ``cc.column_conv_layer`` as the layer called it."""
    from heal_tpu_torch.models.second import ColumnConvLayer
    from heal_tpu_torch.ops import column_conv as cc

    seen = []
    fused = cc.column_conv_layer

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return fused(*args, **kwargs)

    names = [n for n, m in enc.named_modules()
             if isinstance(m, ColumnConvLayer)]
    cc.column_conv_layer = spy
    try:
        with torch.inference_mode():
            enc(points, mask)
    finally:
        cc.column_conv_layer = fused
    if len(seen) != len(names):
        raise AssertionError(f"{len(seen)} kernel-3 calls for the "
                             f"{len(names)} conv layers {names}")
    return [(n.rsplit(".", 1)[-1], a, k) for n, (a, k) in zip(names, seen)]


def dense_m3_frame(points, mask, stack, seed: int):
    """An m3 frame as dense as OPV2V lidar on the SECOND ``stack``'s grid:
    the first slot holds as many real points as ``points`` has rows,
    spread over the whole BEV range and the lowest 2 m (one or two
    occupied voxels a column, enough distinct columns to fill every
    level's capacity), ordered by the full voxel key as the host presort
    orders them (data/scene.py ``_presort_voxel``; binned as the engine
    bins); the other slots stay empty."""
    from heal_tpu_torch.ops import column_conv as cc

    dev = points.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0, y0, z0, x1, y1, _ = stack.lidar_range
    n = points.shape[1]
    lo = torch.tensor([x0, y0, z0, 0.0], device=dev)
    span = torch.tensor([x1 - x0, y1 - y0, 2.0, 1.0], device=dev)
    pts = lo + span * torch.rand((n, 4), generator=gen, device=dev)
    nz, _, nx = cc.grid_shape(stack.lidar_range, stack.voxel_size)
    cell = torch.floor((pts[:, :3] - lo[:3]) / torch.tensor(
        stack.voxel_size, device=dev)).long()
    key = (cell[:, 1] * nx + cell[:, 0]) * nz + cell[:, 2]
    out = torch.zeros_like(points)
    out[0] = pts[torch.argsort(key, stable=True)]
    msk = torch.zeros_like(mask)
    msk[0] = True
    return out, msk


def column_conv_case(frame: str, name, args, kwargs) -> dict:
    """Kernel 3 on one layer's arguments against its plain version
    (KERNEL_TOL; the output occupancy exactly), with both device times
    and the bound."""
    from heal_tpu_torch.ops import column_conv as cc

    cols, table, weights = args[:3]
    out_cols = kwargs.get("out_cols")
    cin, cout = weights.shape[1:]
    strided = out_cols is not None
    work = column_conv_work(cols, table, weights, out_cols)

    def call():
        return cc.column_conv_layer(*args, **kwargs)

    def plain():
        return cc.column_conv_layer_plain(*args, **kwargs)

    with torch.inference_mode():
        got, want = call(), plain()
        torch.cuda.synchronize()
        d, r = rel_err(got["feats"], want["feats"])
        if not r <= KERNEL_TOL[torch.float32]:
            raise AssertionError(f"column_conv {frame} {name}: {r}")
        if not torch.equal(got["occ"], want["occ"]):
            raise AssertionError(f"column_conv {frame} {name}: occupancy")
        occupied = int(got["occ"].sum())
        ms = device_ms(call)
        plain_ms = device_ms(plain)
    # the function's bound: the occupied output voxels' products or the
    # bytes; the valid columns' every voxel (Z dense) is a note
    flops = 2 * 27 * cin * cout * occupied
    b_ms, b_by = bound(work["bytes"], flops)
    dense_ms = bound(0, work["flops"])[0]
    print(f"[kernel] column_conv {frame} {name} ({cin} -> {cout}"
          f"{', stride 2' if strided else ''}) feats "
          f"{tuple(cols['feats'].shape)} -> {tuple(got['feats'].shape)} "
          f"({work['voxels']} voxels in valid columns, {occupied} "
          f"occupied): max_abs_err {d:.3e} (rel {r:.3e}, tol "
          f"{KERNEL_TOL[torch.float32]}), {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms; the occupied voxels' {flops} flops, "
          f"{work['bytes']} bytes, bound {b_ms:.4f} ms ({b_by}), "
          f"{100 * b_ms / ms:.1f}% of bound; every voxel of the valid "
          f"columns ({work['flops']} flops) {dense_ms:.4f} ms "
          f"({100 * dense_ms / ms:.1f}%)")
    return dict(
        frame=frame, layer=name, cin=cin, cout=cout, strided=strided,
        feats=list(cols["feats"].shape), out=list(got["feats"].shape),
        voxels=work["voxels"], occupied=occupied, max_abs_err=d, ms=ms,
        plain_ms=plain_ms, flops=flops, bytes=work["bytes"],
        bound_ms=b_ms, bound_by=b_by, pct_of_bound=100 * b_ms / ms,
        dense_flops=work["flops"], dense_bound_ms=dense_ms)


def phase_column_conv(final_cfg) -> dict:
    """Kernel 3 against its plain version on the card at the alliance's
    m3 shapes (seeded weights, 5 slots, one real agent), on the first
    served frame of ``final_cfg`` and on a dense frame that fills every
    level's capacity (:func:`dense_m3_frame`): the first layer of each
    (Cin, Cout, strided) (:func:`column_conv_case`), the work's FLOP bound
    being the real agent's output voxels at the f32 rate; then the
    encoder's forward with the kernel and with the plain layers, its
    launches (one a conv layer) and host syncs a forward. Returns the
    JSON row's numbers."""
    from heal_tpu_torch import trace
    from heal_tpu_torch.ops import column_conv as cc
    from heal_tpu_torch.tools.inference import build_weights
    from heal_tpu_torch.tools.train import device_batches

    dev = torch.device("cuda")
    enc = build_weights(final_cfg, seed=SEED).branch_m3.encoder.to(dev).eval()
    batch, _ = next(device_batches(final_cfg, 1, dev, train=False))
    frame = (batch["inputs_m3"]["points"][0],
             batch["inputs_m3"]["point_mask"][0])
    frames = {"frame": frame, "dense": dense_m3_frame(
        *frame, enc.VmapSecondStack_0, SEED)}
    cases, encoder = [], {}
    for fname, (pts, msk) in frames.items():
        layers = column_conv_layers(enc, pts, msk)
        done = {}
        for name, args, kwargs in layers:
            key = (*args[2].shape[1:], kwargs.get("out_cols") is not None)
            if key not in done:
                done[key] = (args, kwargs)
                cases.append(column_conv_case(fname, name, args, kwargs))

        # each call one device kernel and no host sync: the six calls in
        # one trace (CUPTI now and then hands back empty traces for the
        # rest of a session: trace again then, and after TRACE_TRIES empty
        # ones in a fresh process)
        def six():
            with torch.inference_mode():
                for args, kwargs in done.values():
                    cc.column_conv_layer(*args, **kwargs)

        for traces in range(1, TRACE_TRIES + 1):
            launched = device_kernels(six)
            if launched:
                break
        else:
            launched = trace_in_fresh_process(done.values(), "column_conv")
            traces = f"{TRACE_TRIES} empty, then one in a fresh process"
        if (len(launched) != len(done)
                or not all("column_conv" in k for k in launched)):
            raise AssertionError(f"column_conv {fname}: {len(done)} calls "
                                 f"put {launched} on the card ({traces} "
                                 "traces)")
        print(f"[kernel] column_conv {fname}: {len(done)} calls, one device "
              f"kernel each and no sync ({traces} trace"
              f"{'' if traces == 1 else 's'})")

        # the whole encoder: launches and host syncs a forward, then its
        # time with the kernel and with the plain layers
        def forward(pts=pts, msk=msk):
            with torch.inference_mode():
                return enc(pts, msk)

        forward()
        torch.cuda.synchronize()
        trace.clear()
        forward()
        counts = dict(trace.counters())
        if counts.get("kernel3.launches") != len(layers):
            raise AssertionError(f"{counts} in one m3 forward, want "
                                 f"{len(layers)} kernel-3 launches")
        enc_ms = device_ms(forward, iters=5)
        with plain_kernels():
            enc_plain_ms = device_ms(forward, iters=5)
        # the occupied output voxels' products, layer by layer
        with torch.inference_mode():
            flops = sum(2 * 27 * a[2].shape[1] * a[2].shape[2] * int(
                cc.column_conv_layer(*a, **k)["occ"].sum())
                for _, a, k in layers)
        b_ms = bound(0, flops)[0]
        syncs = {k: v for k, v in counts.items() if k.startswith("host_sync")}
        print(f"[kernel] column_conv {fname}: one m3 forward launches "
              f"{counts['kernel3.launches']} (one a conv layer), host syncs "
              f"{syncs}; the m3 encoder {enc_ms:.3f} ms with kernel 3, "
              f"{enc_plain_ms:.3f} ms with the plain layers; its "
              f"{len(layers)} layers' occupied voxels' products {flops} "
              f"flops, bound {b_ms:.4f} ms")
        encoder[fname] = dict(launches=counts["kernel3.launches"],
                              host_syncs=syncs, ms=enc_ms,
                              plain_ms=enc_plain_ms, flops=flops,
                              bound_ms=b_ms)
    # the row's numbers: the dense frame's 64 -> 64 submanifold layer, the
    # most frequent; every case is in "cases"
    head = next(c for c in cases if c["frame"] == "dense" and (
        c["cin"], c["cout"], c["strided"]) == (64, 64, False))
    return dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, bytes=head["bytes"],
        pct_of_bound=head["pct_of_bound"], cases=cases,
        launches_per_m3_forward=encoder["frame"]["launches"],
        encoder=encoder)


# kernel 4 at the v2xvit.serve cell's MSwin branches, (window, heads, head
# width), on its map: 5 slots of 128 x 256 tokens
K4_BRANCHES = ((4, 16, 16), (8, 8, 32), (16, 4, 64))
K4_MAP = (5, 128, 256)
# kernel-4 launches an f32 eval forward of V2X-ViT's published block on
# the card: one an MSwin branch of each layer (3 layers x 3 windows; any
# model: k4_per_forward). bf16 and training take its plain version
K4_PUBLISHED = 9


def k4_per_forward(model) -> int:
    """Kernel-4 launches an f32 eval forward of ``model`` on the card: one
    for each MSwin branch (none outside V2X-ViT)."""
    from heal_tpu_torch.models.fuse.v2xvit import WindowAttention

    return sum(isinstance(m, WindowAttention) for m in model.modules())


def v2xvit_args() -> dict:
    """V2X-ViT's published fusion block as benchmark/configs/v2xvit.json
    states it (the v2xvit.serve cell's)."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "benchmark", "configs", "v2xvit.json")) as f:
        return json.load(f)["hypes"]["model"]["args"]["v2xvit"]


def window_attention_inputs(window, heads, dh, n, h, w, seed):
    """Random (N, H, W, 3, heads, dh) projections and a table on the
    card: q . k / sqrt(dh) and the bias each about unit spread."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((n, h, w, 3, heads, dh), generator=gen, device="cuda")
    table = torch.randn(((2 * window - 1) ** 2, heads), generator=gen,
                        device="cuda")
    return qkv, table


def window_attention_case(window, heads, dh) -> dict:
    """Kernel 4 on one branch of the cell's map against its plain version
    (KERNEL_TOL), both device times, the bound (q, k and v read once and
    the output written once, or the products at 67 TFLOP/s) and, as a
    yardstick the port never calls, F.scaled_dot_product_attention on the
    windows already partitioned with the bias as its float attn_mask."""
    import torch.nn.functional as F

    from heal_tpu_torch.ops import window_attention as wa

    n, h, w = K4_MAP
    qkv, table = window_attention_inputs(window, heads, dh, n, h, w,
                                         SEED + window)
    args = (qkv, table, window, heads, dh)
    t = window * window
    with torch.inference_mode():
        got, want = wa.window_attention(*args), wa.window_attention_plain(
            *args)
        torch.cuda.synchronize()
        d, r = rel_err(got, want)
        if not r <= KERNEL_TOL[torch.float32]:
            raise AssertionError(f"window_attention {window}: {r}")
        ms = device_ms(lambda: wa.window_attention(*args))
        plain_ms = device_ms(lambda: wa.window_attention_plain(*args),
                             iters=5)
        win = qkv.reshape(n, h // window, window, w // window, window, 3,
                          heads, dh).permute(5, 0, 1, 3, 6, 2, 4, 7)
        q, k, v = (x.reshape(-1, heads, t, dh).contiguous() for x in win)
        mask = table[wa.window_rel_index(window, table.device).reshape(-1)]
        mask = mask.reshape(t, t, heads).permute(2, 0, 1).contiguous()
        lib = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        lib_err = rel_err(lib.reshape(n, h // window, w // window, heads,
                                      window, window, dh).permute(
            0, 1, 4, 2, 5, 3, 6).reshape(got.shape), want)[1]
        library_ms = device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            iters=5)
    flops = wa.window_attention_ops(*args)
    nbytes = 4 * (4 * n * h * w * heads * dh + table.numel())
    b_ms, b_by = bound(nbytes, flops)
    print(f"[kernel] window_attention window {window}, {heads} x {dh} heads,"
          f" qkv {tuple(qkv.shape)}: max_abs_err {d:.3e} (rel {r:.3e}, tol "
          f"{KERNEL_TOL[torch.float32]}), {ms:.4f} ms vs plain "
          f"{plain_ms:.4f} ms; {flops} flops, {nbytes} bytes, bound "
          f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound; "
          f"F.scaled_dot_product_attention on partitioned windows "
          f"{library_ms:.4f} ms (rel err {lib_err:.2e})")
    return dict(window=window, heads=heads, dim_head=dh,
                qkv=list(qkv.shape), max_abs_err=d, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library_rel_err=lib_err, flops=flops,
                bytes=nbytes, bound_ms=b_ms, bound_by=b_by,
                pct_of_bound=100 * b_ms / ms)


def phase_window_attention() -> dict:
    """Kernel 4 against its plain version at the v2xvit.serve cell's three
    MSwin branches (:func:`window_attention_case`); each call one device
    kernel and no host sync; then the published V2X-ViT fusion (3 layers
    at 256, benchmark/configs/v2xvit.json's block, seeded weights) on the
    cell's 5 x 128 x 256 maps: its launches a forward (K4_PUBLISHED),
    its output with kernel 4 against the plain versions
    (HEADS_TOL) and both device times. Returns the JSON row's numbers."""
    from heal_tpu_torch.models.fuse import build_fusion
    from heal_tpu_torch.models.layers import init_weights
    from heal_tpu_torch.ops import window_attention as wa

    cases = [window_attention_case(*b) for b in K4_BRANCHES]

    # each call one device kernel and no host sync, at a small map
    calls = [((*window_attention_inputs(ws, m, dh, 1, 16, 16, SEED), ws, m,
               dh), {}) for ws, m, dh in K4_BRANCHES]

    def three():
        with torch.inference_mode():
            for args, _ in calls:
                wa.window_attention(*args)

    for traces in range(1, TRACE_TRIES + 1):
        launched = device_kernels(three)
        if launched:
            break
    else:
        launched = trace_in_fresh_process(calls, "window_attention")
        traces = f"{TRACE_TRIES} empty, then one in a fresh process"
    if (len(launched) != len(calls)
            or not all("window_attention" in k for k in launched)):
        raise AssertionError(f"window_attention: {len(calls)} calls put "
                             f"{launched} on the card ({traces} traces)")
    print(f"[kernel] window_attention: {len(calls)} calls, one device "
          f"kernel each and no sync ({traces} trace"
          f"{'' if traces == 1 else 's'})")

    # the published fusion on the cell's maps
    n, h, w = K4_MAP
    c = 256
    fusion = init_weights(build_fusion("v2xvit", v2xvit_args(), c, n),
                          torch.Generator().manual_seed(SEED)).cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((1, n, h, w, c), generator=gen, device="cuda")
    affine = torch.eye(2, 3, device="cuda").expand(1, n, n, 2,
                                                   3).contiguous()
    agent_mask = torch.tensor([[True] * 4 + [False]], device="cuda")
    types = torch.tensor([[0, 1, 0, 1, 0]], device="cuda")

    def forward():
        with torch.inference_mode():
            return fusion(x, affine, agent_mask, types)

    forward()
    torch.cuda.synchronize()
    _zero_counts()
    got = forward()
    launches = _counts()["window_attention"]
    want_launches = k4_per_forward(fusion)
    if launches != want_launches or want_launches != K4_PUBLISHED:
        raise AssertionError(f"V2X-ViT forward: {launches} kernel-4 "
                             f"launches, want {want_launches}")
    fusion_ms = device_ms(forward, iters=5)
    before = _counts()
    with plain_kernels():
        want = forward()
        fusion_plain_ms = device_ms(forward, iters=5)
    if _counts() != before:
        raise AssertionError("V2X-ViT: the plain run launched kernel 4")
    err = rel_err(got, want)[1]
    if not err <= HEADS_TOL:
        raise AssertionError(f"V2X-ViT fusion, kernel 4 vs plain: {err}")
    print(f"[kernel] window_attention: the published V2X-ViT fusion on "
          f"{n} x {h} x {w} x {c} maps launches {launches} a forward; "
          f"{fusion_ms:.3f} ms with kernel 4, {fusion_plain_ms:.3f} ms "
          f"with the plain versions; output rel err {err:.2e} (tol "
          f"{HEADS_TOL})")
    head = cases[-1]  # the row's numbers: window 16, the largest branch
    return dict(
        max_abs_err=max(k["max_abs_err"] for k in cases), ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=head["library_ms"],
        bytes=head["bytes"], pct_of_bound=head["pct_of_bound"], cases=cases,
        launches_per_v2xvit_forward=launches, fusion_ms=fusion_ms,
        fusion_plain_ms=fusion_plain_ms, fusion_rel_err=err)


def phase_serve(cfg, model32) -> dict:
    import numpy as np

    from heal_tpu_torch.ops.warp import warp_agents_to_ego
    from heal_tpu_torch.tools.inference import run_inference
    from heal_tpu_torch.tools.train import device_batches

    model16 = copy.deepcopy(model32).to(torch.bfloat16)

    _zero_counts()
    r32 = run_inference(cfg=cfg, device="cuda", dtype=torch.float32,
                        model=model32, collect_heads=True)
    r16 = run_inference(cfg=cfg, device="cuda", dtype=torch.bfloat16,
                        model=model16, collect_heads=True)
    launches = _counts()
    del launches["shift_rows_backward"]
    print(f"[serve] kernel launches while serving: {launches}")
    if launches["column_conv"] or launches["window_attention"]:
        raise AssertionError("kernel 3 or 4 was launched in a flagship "
                             "frame")
    for name in KERNELS[:2]:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched while serving")

    with plain_kernels():
        ref = run_inference(cfg=cfg, device="cuda", dtype=torch.float32,
                            model=model32, collect_heads=True)
    if _counts() != dict(launches, shift_rows_backward=0):
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
    before = _counts()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with plain_kernels():
            tr_plain = trainer()
            aux_plain, _ = timed_step(tr_plain)
        if before != _counts():
            raise AssertionError("the plain reference step launched a kernel")
        ref = _grad_leaves(tr_plain.model)
        del tr_plain
        _zero_counts()
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
    launches = _counts()
    print(f"[train] kernel launches while training: {launches}")
    if (launches["pillar_tables"] or launches["column_conv"]
            or launches["window_attention"]):
        raise AssertionError("kernel 1, 3 or 4 was launched in training")
    if launches["shift_rows"] <= 0 or launches["shift_rows_backward"] <= 0:
        raise AssertionError("kernel 2 was not launched in both directions "
                             "while training")
    return launches


def _counts() -> dict:
    """The kernels' launches since the last :func:`_zero_counts`, from the
    tracer's counters."""
    from heal_tpu_torch import trace

    c = trace.counters()
    return {"pillar_tables": c.get("kernel1.launches", 0),
            "shift_rows": c.get("kernel2.launches", 0),
            "shift_rows_backward": c.get("kernel2.backward_launches", 0),
            "column_conv": c.get("kernel3.launches", 0),
            "window_attention": c.get("kernel4.launches", 0)}


def _zero_counts() -> None:
    from heal_tpu_torch import trace

    trace.clear()


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
        second = _counts()
        if second != dict.fromkeys(second, 0) | {"column_conv": M3_LAUNCHES}:
            raise AssertionError(f"the SECOND checks launched {second}: "
                                 "want kernel 3 once a conv layer")

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
        want = {k: n * (r32["frames"] if k == "column_conv" else frames)
                for k, n in ALLIANCE_LAUNCHES.items()}
        print(f"[protocol] alliance launches over {frames} frames "
              f"({r32['frames']} f32): {serve}")
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
                "shift_rows_backward": 0,
                "column_conv": M3_LAUNCHES * runs["f32"]["frames"],
                # each MSwin branch of an f32 frame (v2xvit's 2 layers)
                "window_attention": k4_per_forward(model32)
                * runs["f32"]["frames"]}
        if served != want or (name == "v2xvit") != (
                want["window_attention"] > 0):
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
                or trained["shift_rows_backward"] <= 0 \
                or trained["column_conv"] != 0 \
                or trained["window_attention"] != 0:
            raise AssertionError(f"{name} training launches {trained}")
        for k in total:
            total[k] += trained[k]

        ms32 = 1e3 * sum(times[1:]) / BASELINE_STEPS
        row = {"launches_per_frame": dict(
                   {k: served[k] // n for k in served},
                   column_conv=served["column_conv"] // runs["f32"][
                       "frames"],
                   window_attention=served["window_attention"] // runs[
                       "f32"]["frames"]),
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


def heads_vs_plain(model, frames, what: str, hw=(128, 256),
                   lead: int = 1) -> float:
    """The f32 heads (and the uncertainty detector's ``unc_preds``, the
    IoU head's ``iou_preds``) of every forward of ``frames``, on the
    (lead, *hw) grid (FPV-RCNN's stage-1 heads: one an agent slot),
    kernels against the plain versions,
    both with deterministic algorithms; -> the worst
    max |d| / (1 + max |plain|). Fails past HEADS_TOL, on a bad output,
    or if the plain run launched a kernel."""
    inputs = _forwards(frames)

    def heads():
        with torch.inference_mode():
            return [{k: v.float() for k, v in model(x).items()
                     if k in ("cls_preds", "reg_preds", "dir_preds",
                              "unc_preds", "iou_preds")}
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
            if t.shape[:3] != (lead, *hw) or not torch.isfinite(t).all():
                raise AssertionError(f"{what} {k}: bad output")
    worst = max(rel_err(a[k], b[k])[1] for a, b in zip(det, ref) for k in a)
    if not worst <= HEADS_TOL:
        raise AssertionError(f"{what} heads, kernels vs plain: {worst}")
    return worst


def _serve(cfg, model32, frames, what: str,
           hw=(128, 256), lead: int = 1) -> tuple[dict, dict]:
    """``frames`` served f32 and bf16 through run_inference; -> (the
    runs, the kernels' launches over both); heads checked finite and of
    the (lead, *hw) grid."""
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
                if t.shape[:3] != (lead, *hw) or not torch.isfinite(t).all():
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
    -> losses, each step's loss terms, the mean ms of the timed steps,
    peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, terms, times = [], [], []
    for _ in range(n):
        t0 = time.perf_counter()
        aux = tr.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(aux["total_loss"]))
        terms.append({k: float(v) for k, v in aux.items()
                      if k.endswith("_loss")})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train losses {losses}")
    timed = times[1:] or times
    return {"losses": losses, "terms": terms,
            "ms": 1e3 * sum(timed) / len(timed),
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
                "shift_rows_backward": 0, "column_conv": 0,
                # V2X-ViT's MSwin branches, f32 forwards only
                "window_attention": k4_per_forward(model32) * n}
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
                or trained["shift_rows_backward"] <= 0 \
                or trained["column_conv"] != 0 \
                or trained["window_attention"] != 0:
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
                "shift_rows": k2 * forwards, "shift_rows_backward": 0,
                "column_conv": 0, "window_attention": 0}
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
                "shift_rows_backward": 2 * k2, "column_conv": 0,
                "window_attention": 0}
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
                "shift_rows_backward": 0, "column_conv": 0,
                "window_attention": 0}
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
        name: dict(zip(KERNELS, (*POSE_LAUNCHES[name], 0, 0)))
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
        k1, k2, k3 = AF_LAUNCHES[name]
        frames = device_frames(cfg, dev, AF_FRAMES)
        model32 = channels_last(build_weights(cfg, seed=SEED).to(dev))
        row = {"kernels": path_kernels(name, cfg, model32, frames[0][1],
                                       gen)}
        runs, served = _serve(cfg, model32, frames, name)
        want = {"pillar_tables": 2 * AF_FRAMES * k1,
                "shift_rows": 2 * AF_FRAMES * k2, "shift_rows_backward": 0,
                "column_conv": AF_FRAMES * k3, "window_attention": 0}
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
                "shift_rows_backward": 2 * k2, "column_conv": 0,
                "window_attention": 0}
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
              f"launches a frame kernel 1 {k1}, kernel 2 {k2}, kernel 3 "
              f"{k3} (f32); f32 heads vs "
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


def disk_trees(root: str) -> dict:
    """The phase's trees under ``root``, by the port's writers at
    DISK_SEED: OPV2V (DISK_CAVS agents, DISK_TIMESTAMPS timestamps, 4
    camera PNGs an agent), DAIR-V2X-C and V2X-Sim, each lidar sweep as
    dense as DISK_GROUND_POINTS / DISK_BOX_POINTS make it."""
    from heal_tpu_torch.data import dairv2x, opv2v, v2xsim

    dense = dict(ground_points=DISK_GROUND_POINTS,
                 points_per_box=DISK_BOX_POINTS)
    t0 = time.perf_counter()
    out = {"opv2v": os.path.join(root, "opv2v"),
           "dair": os.path.join(root, "dair")}
    opv2v.write_synthetic_opv2v_tree(
        out["opv2v"], num_cavs=DISK_CAVS, num_timestamps=DISK_TIMESTAMPS,
        num_vehicles=14, seed=DISK_SEED, cameras=True, img_hw=DISK_IMG_HW,
        **dense)
    out["dair_split"] = dairv2x.write_synthetic_dair_tree(
        out["dair"], num_frames=DISK_FRAMES["dairv2x"], seed=DISK_SEED,
        **dense)
    out["v2xsim_pkl"] = v2xsim.write_synthetic_v2xsim_pickle(
        os.path.join(root, "v2xsim"), num_frames=DISK_FRAMES["v2xsim"],
        num_agents=DISK_CAVS, seed=DISK_SEED, **dense)
    out["write_s"] = time.perf_counter() - t0
    return out


def disk_cfgs(trees: dict) -> dict:
    """The phase's published configs read through the port's loader,
    only their directories pointed at ``trees``; the OPV2V alliance's m2
    ``data_aug_conf`` given the written images' size and DISK_AUG's crop
    policy; the train config as published (batch 4)."""
    from heal_tpu_torch.tools.train import load_config

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "heal_tpu", "configs")
    demo = load_config(os.path.join(root, DISK_AUG))
    policy = {k: demo["heter"]["modality_setting"]["m2"]["data_aug_conf"][k]
              for k in ("resize_lim", "bot_pct_lim", "rot_lim", "rand_flip")}
    out = {}
    for name, rel in dict(DISK_CFGS, train=DISK_TRAIN_CFG).items():
        cfg = load_config(os.path.join(root, rel))
        if cfg["fusion"]["dataset"] == "opv2v":
            cfg.update(root_dir=trees["opv2v"], validate_dir=trees["opv2v"],
                       test_dir=trees["opv2v"])
        elif cfg["fusion"]["dataset"] == "dairv2x":
            cfg.update(root_dir=trees["dair_split"],
                       validate_dir=trees["dair_split"],
                       test_dir=trees["dair_split"], data_dir=trees["dair"])
        else:
            cfg.update(root_dir=trees["v2xsim_pkl"],
                       validate_dir=trees["v2xsim_pkl"],
                       test_dir=trees["v2xsim_pkl"])
        for setting in (cfg.get("heter") or {}).get("modality_setting",
                                                     {}).values():
            if "data_aug_conf" in setting:
                setting["data_aug_conf"].update(
                    H=DISK_IMG_HW[0], W=DISK_IMG_HW[1], **policy)
        out[name] = cfg
    return out


def _binary_pcd(path: str, pts) -> str:
    """``pts`` (N, 4) f32 as a binary PCD."""
    header = ("VERSION .7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
              "TYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {len(pts)}\nDATA binary\n")
    with open(path, "wb") as f:
        f.write(header.encode() + pts.tobytes())
    return path


def pcd_readers(tree: str, tmp: str) -> dict:
    """The first OPV2V frame's sweeps (one an agent, ascii as written, and
    binary copies) read by the native reader and by its numpy version:
    the arrays equal, and each reader's host ms for the frame."""
    import numpy as np

    from heal_tpu_torch import native
    from heal_tpu_torch.data import opv2v

    ascii_files = sorted(
        os.path.join(tree, scen, cav, "000000.pcd")
        for scen in os.listdir(tree)
        for cav in os.listdir(os.path.join(tree, scen)))
    binary_files = [_binary_pcd(os.path.join(tmp, f"{i}.pcd"),
                                native.read_pcd(p))
                    for i, p in enumerate(ascii_files)]
    out, arrays = {}, {}
    for kind, files in (("ascii", ascii_files), ("binary", binary_files)):
        for reader, fn in (("native", native.read_pcd),
                           ("numpy", opv2v._load_pcd_numpy)):
            t0 = time.perf_counter()
            arrays[kind, reader] = [fn(p) for p in files]
            out[f"{reader}_{kind}_ms"] = 1e3 * (time.perf_counter() - t0)
    for key, got in arrays.items():
        want = arrays["ascii", "native"]
        if not all(g.dtype == np.float32 and np.array_equal(g, w)
                   for g, w in zip(got, want)):
            raise AssertionError(f"PCD reader {key} disagrees with the "
                                 "native reader on the ascii files")
    out["sweeps"] = len(ascii_files)
    out["points"] = [len(a) for a in arrays["ascii", "native"]]
    return out


def disk_frames(cfg, n: int, dev) -> tuple[list, dict]:
    """The first ``n`` test frames of ``cfg``'s disk backend, assembled
    once as tools/inference.device_frames does: -> (frames, the host's
    read (backend.scene: yaml, sweeps, images) and assemble ms a frame,
    the points each lidar agent has in range, each frame's modalities)."""
    from heal_tpu_torch.data import build_dataset
    from heal_tpu_torch.data.scene import collate
    from heal_tpu_torch.tools.inference import batch_keys, frame_inputs

    ds = build_dataset(cfg, train=False)
    keys = batch_keys(cfg)
    asm = ds.assembler
    frames, read, assemble, in_range, mods = [], [], [], [], []
    for i in range(n):
        t0 = time.perf_counter()
        scene = ds.backend.scene(i)
        t1 = time.perf_counter()
        sample = asm.assemble(scene)
        t2 = time.perf_counter()
        read.append(1e3 * (t1 - t0))
        assemble.append(1e3 * (t2 - t1))
        mods.append([a["modality"] for a in scene["agents"]])
        in_range.append({j: len(asm._range_filter(a["points"]))
                         for j, a in enumerate(scene["agents"])
                         if asm.sensor_type(a["modality"]) == "lidar"})
        batch = collate([sample])
        frames.append((batch, frame_inputs(batch, keys, dev, False)))
    host = {"read_ms": statistics.mean(read),
            "assemble_ms": statistics.mean(assemble),
            "in_range": in_range, "modalities": mods}
    return frames, host


def phase_disk(cfgs: dict, trees: dict, readers: dict, smi: str) -> dict:
    """The disk datasets (module docstring, phase 11): each published
    config served from its files, the OPV2V stage-1 config trained;
    returns each kernel's launches over the phase, kernel 1's cases on
    the disk frame and the measurements."""
    from heal_tpu_torch.data import build_dataset
    from heal_tpu_torch.kernels.cases import branch_frame_inputs
    from heal_tpu_torch.models.fuse import softmax_shift_biases
    from heal_tpu_torch.models.layers import channels_last
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import build_weights

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    total = {k: 0 for k in _counts()}
    rows, cases = {}, []
    for name in DISK_CFGS:
        cfg = cfgs[name]
        torch.cuda.empty_cache()
        k1, k2, k3 = DISK_LAUNCHES[name]
        frames, host = disk_frames(cfg, DISK_FRAMES[name], dev)
        # every lidar sweep holds max_points in range, but DAIR-V2X's
        # roadside unit (agent 1): the writer (JAX's) puts it 4 m up, its
        # ground below the configs' z range, so it sees the boxes only
        max_points = cfg["preprocess"]["args"]["max_points"]
        short = [(i, j, n) for i, f in enumerate(host["in_range"])
                 for j, n in f.items() if n < max_points
                 and not (name == "dairv2x" and j == 1)]
        if short:
            raise AssertionError(f"{name}: sweeps with fewer points in "
                                 f"range than max_points: {short}")
        model32 = channels_last(build_weights(cfg, seed=SEED).to(dev))
        if name == "opv2v":
            # kernel 1 on the first frame's sweeps through the first
            # PointPillars type the backend drew (m1, else the 16-line m4)
            m = next(m for m in ("m1", "m4") if m in host["modalities"][0])
            for dt in (torch.float32, torch.bfloat16):
                cases.append(pillar_case(
                    f"disk frame {m}", branch_frame_inputs(
                        model32, frames[0][1], m, dt), dt))
        runs, served = _serve(cfg, model32, frames, f"disk {name}")
        n = len(frames)
        want = {"pillar_tables": 2 * n * k1, "shift_rows": 2 * n * k2,
                "shift_rows_backward": 0, "column_conv": n * k3,
                "window_attention": 0}
        if served != want:
            raise AssertionError(f"disk {name} served: launches {served}, "
                                 f"want {want}")
        for k in total:
            total[k] += served[k]
        row = dict(host, frames=n,
                   heads_rel=heads_vs_plain(model32, frames, f"disk {name}"),
                   **{f"serve_ms_{d}": _steady_ms(r["serve_s"])
                      for d, r in runs.items()})
        if "depth_rmse_m2" in runs["f32"]:
            row["depth_rmse_m2"] = runs["f32"]["depth_rmse_m2"]
        rows[name] = row
        del model32, frames, runs
        pts = [c for f in row["in_range"] for c in f.values()]
        print(f"[disk] {DISK_CFGS[name]} on the {name} tree ({n} frames; "
              f"modalities drawn {row['modalities'][0]}..; points in range "
              f"a lidar agent {min(pts)}-{max(pts)}): host a frame, read "
              f"{row['read_ms']:.1f} ms + assemble "
              f"{row['assemble_ms']:.1f} ms (host clock); serve ms/frame "
              f"(after the first) f32 {row['serve_ms_f32']:.3f}, bf16 "
              f"{row['serve_ms_bf16']:.3f}; launches a frame kernel 1 {k1}, "
              f"kernel 2 {k2}, kernel 3 {k3} (f32); f32 heads vs plain max "
              f"rel err "
              f"{row['heads_rel']:.3e} (tol {HEADS_TOL})"
              + (f"; depth RMSE m2 {row['depth_rmse_m2']:.3f} m"
                 if "depth_rmse_m2" in row else "") + f"; {smi}")

    # training through tools/train.py's host-fed loop: one batch an
    # epoch (DISK_TIMESTAMPS frames), a warm step then two timed ones
    cfg = cfgs["train"]
    torch.cuda.empty_cache()
    ds = build_dataset(cfg, train=True)
    tr = train_tool.build_trainer(cfg, dev, len(ds) // DISK_BATCH)
    start = {n: p.detach().clone()
             for n, p in tr.model.named_parameters() if p.requires_grad}
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    steps, waits, losses = [], [], []
    for epoch in range(3):
        t0 = time.perf_counter()
        for batch in train_tool.epoch_batches(ds, DISK_BATCH, epoch, dev):
            t1 = time.perf_counter()
            aux = tr.train_step(batch)
            torch.cuda.synchronize()
            steps.append(1e3 * (time.perf_counter() - t1))
            waits.append(1e3 * (t1 - t0))
            losses.append(float(aux["total_loss"]))
            t0 = time.perf_counter()
    trained = _counts()
    want = {"pillar_tables": 0, "shift_rows": 15 * len(steps),
            "shift_rows_backward": 15 * len(steps), "column_conv": 0,
            "window_attention": 0}
    if len(steps) != 3 or trained != want:
        raise AssertionError(f"disk training: {len(steps)} steps, launches "
                             f"{trained}, want {want}")
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"disk training losses {losses}")
    for k in total:
        total[k] += trained[k]
    shifts = softmax_shift_biases(tr.model)
    still = [n for n, p in tr.model.named_parameters()
             if n in start and n not in shifts
             and torch.equal(p.detach(), start[n])]
    still += no_gradient({n: p for n, p in tr.model.named_parameters()
                          if n in start and n in shifts}, tr.model)
    if still:
        raise AssertionError(f"disk training: trainable parameters that "
                             f"did not move: {still[:5]}")
    rows["train"] = {"step_ms": steps[1:], "input_wait_ms": waits,
                     "losses": losses, "trainable": len(start),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del tr, ds, start
    t = rows["train"]
    print(f"[disk] {DISK_TRAIN_CFG} trained on the opv2v tree through "
          f"tools/train.py's epoch_batches (batch {DISK_BATCH}, one an "
          f"epoch): step ms f32 (after a warm one) "
          + ", ".join(f"{x:.3f}" for x in t["step_ms"])
          + f"; waiting for input (the prefetch worker reading and "
          f"assembling) " + ", ".join(f"{x:.1f}" for x in t["input_wait_ms"])
          + f" ms; peak {t['peak_gib']:.3f} GiB; losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; all {t['trainable']} trainable parameters moved; launches "
          f"a step {({k: v // 3 for k, v in trained.items()})}; {smi}")
    print(f"[disk] PCD readers, the first OPV2V frame's {readers['sweeps']} "
          f"sweeps ({min(readers['points'])}-{max(readers['points'])} points"
          f" each; host clock, ms a frame): native ascii "
          f"{readers['native_ascii_ms']:.1f}, numpy ascii "
          f"{readers['numpy_ascii_ms']:.1f}, native binary "
          f"{readers['native_binary_ms']:.1f}, numpy binary "
          f"{readers['numpy_binary_ms']:.1f}; the arrays equal; trees "
          f"written in {trees['write_s']:.1f} s; {smi}")
    print(f"[disk] phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}")
    return {"launches": total, "rows": rows, "kernels": cases,
            "readers": readers}


def camera_cfgs() -> dict:
    """Phase 12's configs at full width, read through the port's loader,
    on the synthetic backend with the flagship's scene arguments:
      * the eight opv2v/camera_only/*.yaml by name (CAMERA_ONLY) as
        published but the batch (CAMERA_BATCH);
      * ``aligner_<method>``: heal/stage2/m4_alignto_m1.yaml with the m4
        aligner's core_method switched to each of ALIGNERS (derived);
      * ``iou``: IOU_CFG with ``use_iou`` and the loss's ``iou`` term
        (weight 1, sigma 1; derived, no published config sets them);
      * ``group``: GROUP_CFG with ``norm`` removed, JAX's default group
        norm (derived);
      * ``lss_intermediate`` and ``lss``: lift_splat_shoot_intermediate
        (max fusion, intermediate frames) and lift_splat_shoot (late
        frames: one agent a forward) built from LSS_FROM's m2 block
        (its grid, images, encoder, backbone), the shrink, heads and
        loss of that config, ``load_lift_splat_shoot_params`` and the
        labels on the camera grid (derived: the repo publishes none)."""
    from heal_tpu_torch.config import reparse
    from heal_tpu_torch.tools.train import load_config

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "heal_tpu", "configs", "opv2v")
    scene_args = flagship_cfg()["fusion"]["args"]

    def synthetic(rel, n_train, n_test):
        cfg = load_config(os.path.join(root, rel))
        cfg["fusion"]["dataset"] = "synthetic"
        cfg["fusion"]["args"] = dict(scene_args, num_scenes_train=n_train,
                                     num_scenes_test=n_test)
        cfg["train_params"]["batch_size"] = n_train
        return cfg

    out = {name: synthetic(f"camera_only/{name}.yaml", CAMERA_BATCH,
                           CAMERA_FRAMES) for name in CAMERA_ONLY}
    for method in ALIGNERS:
        cfg = synthetic(ALIGNER_CFG, 4, ALIGNER_FRAMES)
        cfg["model"]["args"]["m4"]["aligner_args"]["core_method"] = method
        out[f"aligner_{method}"] = cfg
    out["iou"] = synthetic(IOU_CFG, IOU_BATCH, IOU_FRAMES)
    out["iou"]["model"]["args"]["use_iou"] = True
    out["iou"]["loss"]["args"]["iou"] = {"weight": 1.0, "sigma": 1.0}
    out["group"] = synthetic(GROUP_CFG, GROUP_BATCH, GROUP_FRAMES)
    del out["group"]["model"]["args"]["norm"]
    for name, fusion, model in (
            ("lss_intermediate", "intermediateheter",
             "lift_splat_shoot_intermediate"),
            ("lss", "lateheter", "lift_splat_shoot")):
        cfg = synthetic(LSS_FROM, CAMERA_BATCH, LSS_FRAMES)
        a = cfg["model"]["args"]
        m2 = a["m2"]
        grid = m2["encoder_args"]["grid_conf"]
        square = [grid["xbound"][0], grid["ybound"][0], -3,
                  grid["xbound"][1], grid["ybound"][1], 1]
        cfg["yaml_parser"] = "load_lift_splat_shoot_params"
        cfg["fusion"]["core_method"] = fusion
        cfg["fusion"]["args"]["grid_conf"] = grid
        cfg["cav_lidar_range"] = square
        cfg["preprocess"]["cav_lidar_range"] = square
        post = cfg["postprocess"]
        post["gt_range"] = square
        post["anchor_args"].update(cav_lidar_range=square, feature_stride=1)
        cfg["model"] = {"core_method": model, "args": {
            **m2["encoder_args"], "base_bev_backbone": m2["backbone_args"],
            "shrink_header": a["shrink_header"],
            "anchor_number": a["anchor_number"], "dir_args": a["dir_args"],
            "fusion_method": "max", "max": {}}}
        out[name] = reparse(cfg)
    return out


def _stats_ms(serve_s) -> dict:
    """Median, min and max ms of the frames after the first."""
    ms = [1e3 * s for s in (serve_s[1:] or serve_s)]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def _fmt(st: dict) -> str:
    return f"{st['median']:.3f} [{st['min']:.3f}, {st['max']:.3f}]"


def _snapshot(model, prefixes) -> dict:
    return {n: t.detach().clone() for n, t in model.state_dict().items()
            if n.split(".")[0] in prefixes}


def phase_camera_options(cfgs: dict) -> dict:
    """The camera-only table, the four other aligners, use_iou, group
    norm and the standalone LSS detectors (module docstring, phase 12);
    returns each kernel's launches over the phase and the measurements."""
    from heal_tpu_torch.models.fuse import softmax_shift_biases
    from heal_tpu_torch.models.layers import channels_last
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import build_weights, device_frames

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    total = {k: 0 for k in _counts()}
    rows = {}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    def served_path(name, cfg, frames, launches, hw=(128, 256),
                    model32=None):
        """Serve ``frames`` f32 and bf16; exact launches, heads vs plain;
        -> the row."""
        torch.cuda.empty_cache()
        if model32 is None:
            model32 = channels_last(build_weights(cfg, seed=SEED).to(dev))
        model32.eval()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs, served = _serve(cfg, model32, frames, name, hw)
        peak = torch.cuda.max_memory_allocated() / 2**30
        forwards = 2 * len(_forwards(frames))
        k4 = k4_per_forward(model32)  # an f32 forward: V2X-ViT's branches
        want = {"pillar_tables": forwards * launches[0],
                "shift_rows": forwards * launches[1],
                "shift_rows_backward": 0, "column_conv": 0,
                "window_attention": k4 * len(_forwards(frames))}
        if served != want:
            raise AssertionError(f"{name} served: launches {served}, want "
                                 f"{want}")
        add(served)
        row = {"launches_per_forward": dict(zip(KERNELS, (*launches, 0,
                                                          k4))),
            "heads_rel": heads_vs_plain(model32, frames, name, hw),
            "serve_peak_gib": peak}
        for d, r in runs.items():
            row[f"serve_ms_{d}"] = _stats_ms(r["serve_s"])
        return row

    def trained_path(name, cfg, batch, steps, launches, backward=None):
        """``steps`` f32 train steps (the first warm) through
        build_trainer; exact launches (kernel 2 ``backward`` times a step
        backward, by default as often as forward), every fusion parameter
        with a gradient (nonzero but the softmax shifts); -> (the
        trainer, the row)."""
        torch.cuda.empty_cache()
        _zero_counts()
        tr = train_tool.build_trainer(cfg, dev, 1)
        step = _steps(tr, batch, steps)
        trained = _counts()
        back = launches[1] if backward is None else backward
        want = {"pillar_tables": 0, "shift_rows": steps * launches[1],
                "shift_rows_backward": steps * back, "column_conv": 0,
                "window_attention": 0}
        if trained != want:
            raise AssertionError(f"{name} training launches {trained}, "
                                 f"want {want}")
        add(trained)
        fusion = {n: p for n, p in tr.model.named_parameters()
                  if p.requires_grad and (
                      n.split(".")[0] in ("fusion", "pyramid_backbone")
                      or n.startswith("fusions_"))}
        dead = no_gradient(fusion, tr.model)
        if dead:
            raise AssertionError(f"{name}: fusion parameters without a "
                                 f"gradient: {dead[:5]}")
        step["fusion_params"] = len(fusion)
        step["shifts"] = len(set(fusion) & softmax_shift_biases(tr.model))
        return tr, step

    # the camera-only table: one set of frames and one train batch
    t0 = time.perf_counter()
    first = cfgs[CAMERA_ONLY[0]]
    frames = device_frames(first, dev, CAMERA_FRAMES)
    batch, _ = next(train_tool.device_batches(first, CAMERA_BATCH, dev))
    torch.cuda.synchronize()
    print(f"[camera] {len(frames)} camera-only test frames and one train "
          f"batch of {CAMERA_BATCH} assembled and copied once in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in CAMERA_ONLY:
        cfg = cfgs[name]
        k2 = CAMERA_LAUNCHES[name]
        row = served_path(name, cfg, frames, (0, k2))
        tr, row["train"] = trained_path(name, cfg, batch, 2, (0, k2),
                                        CAMERA_BACKWARD[name])
        del tr
        rows[name] = row
        st = row["train"]
        print(f"[camera] camera_only/{name}.yaml "
              f"({cfg['model']['core_method']}): serve ms/frame median "
              f"[min, max] of {CAMERA_FRAMES - 1} after the first, f32 "
              f"{_fmt(row['serve_ms_f32'])}, bf16 "
              f"{_fmt(row['serve_ms_bf16'])} (peak "
              f"{row['serve_peak_gib']:.3f} GiB); launches a frame kernel 1 "
              f"0, kernel 2 {k2} (a step {CAMERA_BACKWARD[name]} backward); f32 "
              "heads vs plain max rel err "
              f"{row['heads_rel']:.3e} (tol {HEADS_TOL}); train step "
              f"{st['ms']:.3f} ms f32 (batch {st['batch']}, after a warm "
              f"one), peak {st['peak_gib']:.3f} GiB, losses "
              + ", ".join(f"{x:.4f}" for x in st["losses"])
              + f"; {st['fusion_params']} fusion parameters with a gradient"
              f" ({st['shifts']} softmax shifts)")
    del frames, batch

    # the four other aligners on the m4 stage-2 model: a warm and a timed
    # step at the published batch, the base bit-equal, every aligner
    # parameter moved; then ALIGNER_FRAMES frames served
    for method in ALIGNERS:
        name = f"aligner_{method}"
        cfg = cfgs[name]
        batch, _ = next(train_tool.device_batches(
            cfg, cfg["train_params"]["batch_size"], dev))
        torch.cuda.empty_cache()
        _zero_counts()
        tr = train_tool.build_trainer(cfg, dev, 1)
        fixed = tuple(tr.model.fix_modules)
        base = _snapshot(tr.model, fixed)
        aligner = {n: p.detach().clone()
                   for n, p in tr.model.named_parameters()
                   if ".aligner." in n}
        step = _steps(tr, batch, 2)
        trained = _counts()
        if any(trained.values()):
            raise AssertionError(f"{name} training launches {trained}")
        moved = _snapshot(tr.model, fixed)
        bad = [n for n, t in base.items() if not torch.equal(t, moved[n])]
        if bad or not base:
            raise AssertionError(f"{name}: base entries moved: {bad[:3]}")
        still = [n for n, p in tr.model.named_parameters()
                 if n in aligner and torch.equal(p.detach(), aligner[n])]
        if still or not aligner:
            raise AssertionError(f"{name}: aligner parameters that did not "
                                 f"move: {still[:5]}")
        model = tr.model
        del tr, batch
        frames = device_frames(cfg, dev, ALIGNER_FRAMES)
        row = served_path(name, cfg, frames, OPTION_LAUNCHES["aligner"],
                          model32=model)
        row["train"] = step
        row["aligner_params"] = len(aligner)
        row["base_entries"] = len(base)
        del model, frames
        rows[name] = row
        print(f"[camera] {ALIGNER_CFG} with aligner {method}: stage-2 step "
              f"{step['ms']:.3f} ms f32 (batch {step['batch']}, after a warm "
              f"one), peak {step['peak_gib']:.3f} GiB, losses "
              + ", ".join(f"{x:.4f}" for x in step["losses"])
              + f"; {len(base)} base entries "
              f"bit-equal, all {len(aligner)} aligner parameters moved; "
              f"serve ms/frame f32 {_fmt(row['serve_ms_f32'])}, bf16 "
              f"{_fmt(row['serve_ms_bf16'])} (peak "
              f"{row['serve_peak_gib']:.3f} GiB); launches a frame kernel 1 "
              f"1, kernel 2 0; heads vs plain {row['heads_rel']:.3e}")

    # use_iou: served, two steps with a nonzero IoU term
    cfg = cfgs["iou"]
    frames = device_frames(cfg, dev, IOU_FRAMES)
    row = served_path("iou", cfg, frames, OPTION_LAUNCHES["iou"])
    del frames
    batch, _ = next(train_tool.device_batches(cfg, IOU_BATCH, dev))
    tr, step = trained_path("iou", cfg, batch, 2, OPTION_LAUNCHES["iou"])
    iou_terms = [t.get("iou_loss", 0.0) for t in step["terms"]]
    if not all(math.isfinite(x) and x > 0 for x in iou_terms):
        raise AssertionError(f"iou_loss {iou_terms}")
    row["train"], row["iou_loss"] = step, iou_terms
    rows["iou"] = row
    k2 = OPTION_LAUNCHES["iou"][1]
    del tr, batch
    print(f"[camera] {IOU_CFG} with use_iou (derived): serve ms/frame f32 "
          f"{_fmt(row['serve_ms_f32'])}, bf16 {_fmt(row['serve_ms_bf16'])} "
          f"(peak {row['serve_peak_gib']:.3f} GiB);"
          f" launches a frame kernel 1 1, kernel 2 {k2}; heads and iou_preds"
          f" vs plain {row['heads_rel']:.3e}; train step {step['ms']:.3f} ms"
          f" f32 (batch {step['batch']}), peak {step['peak_gib']:.3f} GiB, "
          "iou_loss " + ", ".join(f"{x:.5f}" for x in iou_terms))

    # group norm on heter_model_late: a late frame, one step
    cfg = cfgs["group"]
    frames = device_frames(cfg, dev, GROUP_FRAMES)
    row = served_path("group", cfg, frames, OPTION_LAUNCHES["group"])
    del frames
    batch, _ = next(train_tool.device_batches(cfg, GROUP_BATCH, dev))
    tr, row["train"] = trained_path("group", cfg, batch, 2,
                                    OPTION_LAUNCHES["group"])
    kinds = {m.kind for m in tr.model.modules()
             if type(m).__name__ == "Norm"}
    if kinds != {"group"} or tr.model.branch_m1.encoder.fused:
        raise AssertionError(f"group: norms {kinds}")
    del tr, batch
    rows["group"] = row
    st = row["train"]
    print(f"[camera] {GROUP_CFG} on group norm (derived): a late frame "
          f"after a warm one f32 {row['serve_ms_f32']['median']:.3f} ms, bf16 "
          f"{row['serve_ms_bf16']['median']:.3f} ms (peak "
          f"{row['serve_peak_gib']:.3f} GiB); no kernel launched "
          f"(the m1 encoder on its general path); heads vs plain "
          f"{row['heads_rel']:.3e}; train step {st['ms']:.3f} ms f32 "
          f"(batch {st['batch']}, after a warm one), peak "
          f"{st['peak_gib']:.3f} GiB, losses "
          + ", ".join(f"{x:.4f}" for x in st["losses"]))

    # the standalone LSS detectors, their BEV the 128 x 128 camera grid
    for name in ("lss_intermediate", "lss"):
        cfg = cfgs[name]
        frames = device_frames(cfg, dev, LSS_FRAMES)
        row = served_path(name, cfg, frames, OPTION_LAUNCHES[name],
                          hw=(128, 128))
        del frames
        rows[name] = row
        print(f"[camera] {cfg['model']['core_method']} (derived from "
              f"{LSS_FROM}): serve ms/frame f32 {_fmt(row['serve_ms_f32'])},"
              f" bf16 {_fmt(row['serve_ms_bf16'])} (peak "
              f"{row['serve_peak_gib']:.3f} GiB); launches a forward "
              f"{row['launches_per_forward']}; heads vs plain "
              f"{row['heads_rel']:.3e}")
    print(f"[camera] phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}")
    return {"launches": total, "rows": rows}


def legacy_cfgs() -> dict:
    """Phase 13's configs, every one derived (no published config names
    these models), each keeping its base config's published widths and
    data blocks, read through the port's loader, on the synthetic backend
    with the flagship's scene arguments (DAIR-V2X's with AF_AGENTS
    agents): LEGACY_BATCH train scenes (the batch), LEGACY_FRAMES test
    scenes. The new modules take heal_tpu's defaults (VoxelNet's VFE 32
    and 3D convs 64, SSFA 128, FPV-RCNN's 16 proposals an agent, 512
    keypoints, grid 4):
      * ``multiscale``: LEGACY_LIDAR with point_pillar_baseline_multiscale
        (max at each of its three levels);
      * ``disconet``: LEGACY_DISCONET with point_pillar_disconet,
        point_pillar_disconet_loss and ``kd_flag``; ``disconet_teacher``:
        the same file with point_pillar_disconet_teacher on early fusion
        (the merged view it is trained on);
      * ``voxel_net`` (early fusion) and ``voxel_net_intermediate`` (max):
        LEGACY_LIDAR with 0.4 m voxel cubes (10 z layers) and
        voxel_net_loss;
      * ``pixor`` (early) and ``pixor_intermediate`` (max): LEGACY_PIXOR at
        ``bev_res`` 0.4 over 10 z slabs, the anchor-free heads, loss and
        decode (its train batches get CenterPoint's labels from
        ``center_batch``);
      * ``ciassd``, ``second_ssfa`` and ``second_ssfa_uncertainty`` (early
        fusion, ``presorted`` false): LEGACY_SECOND's SECOND widths and
        0.1 m voxels, ``ciassd_loss`` with the IoU term (weight 1, sigma 1),
        ``point_pillar_uncertainty_loss`` for the last;
      * ``fpvrcnn``: LEGACY_SECOND on ``intermediate2stage``, its
        ``anchor_args`` from the config's postprocess block, ``fpvrcnn_loss``
        (stage 1: the config's loss with the IoU term)."""
    from heal_tpu_torch.tools.train import load_config

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "heal_tpu", "configs")
    scene_args = flagship_cfg()["fusion"]["args"]
    iou = {"weight": 1.0, "sigma": 1.0}

    def derived(rel, core, fusion=None, agents=None, **args):
        cfg = load_config(os.path.join(root, rel))
        cfg["fusion"]["dataset"] = "synthetic"
        cfg["fusion"]["args"] = dict(
            scene_args, num_scenes_train=LEGACY_BATCH,
            num_scenes_test=LEGACY_FRAMES,
            num_agents=agents or scene_args["num_agents"])
        cfg["train_params"]["batch_size"] = LEGACY_BATCH
        if fusion:
            cfg["fusion"]["core_method"] = fusion
        cfg["model"]["core_method"] = core
        cfg["model"]["args"].update(copy.deepcopy(args))
        return cfg

    dair = AF_AGENTS["second"]
    out = {"multiscale": derived(LEGACY_LIDAR,
                                 "point_pillar_baseline_multiscale")}
    out["disconet_teacher"] = derived(
        LEGACY_DISCONET, "point_pillar_disconet_teacher", "early")
    out["disconet"] = derived(LEGACY_DISCONET, "point_pillar_disconet")
    out["disconet"]["kd_flag"] = True
    out["disconet"]["loss"]["core_method"] = "point_pillar_disconet_loss"
    for name, fusion in (("voxel_net", "early"),
                         ("voxel_net_intermediate", "intermediate")):
        out[name] = derived(LEGACY_LIDAR, name, fusion,
                            voxel_size=[0.4, 0.4, 0.4], fusion_method="max",
                            max={})
        out[name]["loss"] = {"core_method": "voxel_net_loss",
                             "args": {"alpha": 1.5, "beta": 1.0, "reg": 2.0}}
    for name, fusion in (("pixor", "early"),
                         ("pixor_intermediate", "intermediate")):
        out[name] = derived(LEGACY_PIXOR, name, fusion, bev_res=0.4,
                            z_slabs=10, fusion_method="max", max={})
    for name in ("ciassd", "second_ssfa", "second_ssfa_uncertainty"):
        cfg = derived(LEGACY_SECOND, name, "early", dair,
                      ssfa={"feature_num": 128}, presorted=False)
        if name.endswith("uncertainty"):
            cfg["loss"]["core_method"] = "point_pillar_uncertainty_loss"
        else:
            cfg["loss"]["core_method"] = "ciassd_loss"
            cfg["loss"]["args"]["iou"] = dict(iou)
        out[name] = cfg
    fpv = derived(LEGACY_SECOND, "fpvrcnn", "intermediate2stage", dair,
                  ssfa={"feature_num": 128})
    fpv["model"]["args"]["anchor_args"] = copy.deepcopy(
        fpv["postprocess"]["anchor_args"])
    fpv["loss"] = {"core_method": "fpvrcnn_loss", "args": {
        "stage1": dict(copy.deepcopy(fpv["loss"]["args"]), iou=dict(iou)),
        "stage2": {}}}
    out["fpvrcnn"] = fpv
    return out


def center_batch(cfg, size: int, dev):
    """The first train batch of ``cfg`` on ``dev`` with CenterPoint's
    labels (``heatmap``, ``box_targets``, ``reg_mask``), made from each
    sample's ground truth by the port's ``generate_center_targets`` as the
    assemblers make them; they make them for ``center_point*`` models
    only, as JAX's do, so PIXOR's anchor-free form gets them here (ROADMAP
    §3)."""
    import numpy as np

    from heal_tpu_torch.data import build_dataset
    from heal_tpu_torch.parallel import to_device
    from heal_tpu_torch.postprocess.targets import generate_center_targets

    ds = build_dataset(cfg, train=True)
    batch = next(ds.batches(size, shuffle=False))
    aa = cfg["postprocess"]["anchor_args"]
    labels = [generate_center_targets(
        g, m, ds.anchors.shape[:2], cfg["preprocess"]["cav_lidar_range"],
        aa["vw"] * aa.get("feature_stride", 2), cfg["postprocess"]["order"])
        for g, m in zip(batch["gt_boxes"], batch["gt_mask"])]
    for key in labels[0]:
        batch[key] = np.stack([lab[key] for lab in labels])
    return to_device(batch, dev)


def captured_shifts(model, inputs) -> list:
    """Kernel 2's calls in one f32 forward of ``model`` on ``inputs``:
    each distinct (shape, axis) once, with the path's own input, shifts
    and bound."""
    from heal_tpu_torch.ops import shift_rows

    seen, real = {}, shift_rows._shift

    def spy(x, s, m, axis, backward=False):
        key = (tuple(x.shape), axis)
        if key not in seen:
            seen[key] = (x.detach().clone(), s.detach().clone(), m, axis)
        return real(x, s, m, axis, backward)

    shift_rows._shift = spy
    try:
        with torch.no_grad():  # not inference mode: the replays need grad
            model(inputs)
    finally:
        shift_rows._shift = real
    return list(seen.values())


def legacy_kernels(name: str, model, inputs, gen) -> list:
    """Both kernels on this path's own inputs against their plain
    versions: kernel 1 on the first frame's encoder arguments (the
    multiscale baseline's agents, the KD teacher's early-fused view), f32
    and bf16; kernel 2 on each distinct call of the frame's warps, f32,
    and on the square shear canvases in bf16 too."""
    cases = []
    pillar, shift = LEGACY_CASES.get(name, (False, False))
    if pillar:
        enc = (model.teacher.encoder if name == "disconet_teacher"
               else model.student.encoder if name == "disconet"
               else model.encoder)
        points, mask = inputs["points"][0], inputs["point_mask"][0]
        if points.dim() == 2:  # one agent (the teacher's view)
            points, mask = points[None], mask[None]
        for dt in (torch.float32, torch.bfloat16):
            cases.append(pillar_case(f"{name} frame",
                                     frame_inputs(enc, points, mask, dt), dt))
    for x, s, m, axis in (captured_shifts(model, inputs) if shift else ()):
        what = f"{name} "
        dts = ((torch.float32, torch.bfloat16) if x.shape[1] == x.shape[2]
               else (torch.float32,))
        for dt in dts:
            cases += shift_case(x.to(dt), s, m, ("rows", "cols")[axis], gen,
                                what)
    return cases


def phase_legacy(cfgs: dict) -> dict:
    """The last detectors on derived configs (module docstring, phase 13);
    returns each kernel's launches over the phase, the kernel cases and
    the measurements."""
    import hashlib

    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.models.fuse import softmax_shift_biases
    from heal_tpu_torch.models.layers import channels_last
    from heal_tpu_torch.tools import checkpoint as ckpt_lib
    from heal_tpu_torch.tools import inference as inference_tool
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools import train_w_kd
    from heal_tpu_torch.tools.inference import build_weights, device_frames

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t_phase = time.perf_counter()
    total = {k: 0 for k in _counts()}
    rows, kernels = {}, []

    def add(counts):
        for k in total:
            total[k] += counts[k]

    def expect(what, got, k1, k2, k2b, k3=0):
        want = {"pillar_tables": k1, "shift_rows": k2,
                "shift_rows_backward": k2b, "column_conv": k3,
                "window_attention": 0}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")
        add(got)

    def moved(tr, start, what, unreached=None):
        """Every trainable parameter moved, but the softmax shifts, which
        need only a gradient, and those under ``unreached`` (a zero
        gradient, LEGACY_UNREACHED)."""
        shifts = softmax_shift_biases(tr.model)
        still = [n for n, p in tr.model.named_parameters()
                 if n in start and n not in shifts
                 and torch.equal(p.detach(), start[n])
                 and not (unreached and n.startswith(unreached)
                          and not bool(p.grad.abs().max() > 0))]
        still += no_gradient({n: p for n, p in tr.model.named_parameters()
                              if n in start and n in shifts}, tr.model)
        if still:
            raise AssertionError(f"{what}: trainable parameters that did "
                                 f"not move: {still[:5]}")
        return len(start)

    tmp = tempfile.TemporaryDirectory()
    teacher_dir = os.path.join(tmp.name, "teacher")
    stage2_calls = []
    real_decode = inference_tool.decode_stage2

    def decode_spy(*a, **k):
        stage2_calls.append(1)
        return real_decode(*a, **k)

    inference_tool.decode_stage2 = decode_spy
    try:
        for name, cfg in cfgs.items():
            torch.cuda.empty_cache()
            k1, k2, k3 = LEGACY_LAUNCHES[name]
            lead = (cfg["train_params"]["max_cav"] if name == "fpvrcnn"
                    else 1)
            frames = device_frames(cfg, dev, LEGACY_FRAMES)
            model32 = channels_last(build_weights(cfg, seed=SEED).to(dev))
            row = {"kernels": legacy_kernels(name, model32, frames[0][1],
                                             gen)}
            kernels += row["kernels"]
            stage2_calls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runs, served = _serve(cfg, model32, frames, name, lead=lead)
            row["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            expect(f"{name} served", served, 2 * LEGACY_FRAMES * k1,
                   2 * LEGACY_FRAMES * k2, 0, LEGACY_FRAMES * k3)
            if name == "fpvrcnn" and len(stage2_calls) != 2 * LEGACY_FRAMES:
                raise AssertionError(f"fpvrcnn: {len(stage2_calls)} stage-2 "
                                     "decodes, want one a frame")
            row["heads_rel"] = heads_vs_plain(model32, frames, name,
                                              lead=lead)
            for d, r in runs.items():
                row[f"serve_ms_{d}"] = _stats_ms(r["serve_s"])
            if name == "disconet_teacher":
                # the teacher's run dir for train_w_kd: config and weights
                os.makedirs(teacher_dir)
                save_yaml(cfg, os.path.join(teacher_dir, "config.yaml"))
                ckpt_lib.save_checkpoint(teacher_dir, model32, 1)
            del model32, frames, runs
            torch.cuda.empty_cache()

            batch = (center_batch(cfg, LEGACY_BATCH, dev)
                     if name.startswith("pixor") else
                     next(train_tool.device_batches(cfg, LEGACY_BATCH,
                                                    dev))[0])
            _zero_counts()
            if name == "disconet":
                teacher = train_w_kd.load_teacher(teacher_dir, dev)
                before = {n: t.clone()
                          for n, t in teacher.state_dict().items()}
                tr = train_tool.build_trainer(
                    cfg, dev, 1, trainer_cls=train_w_kd.KDTrainer,
                    teacher=teacher)
            else:
                tr = train_tool.build_trainer(cfg, dev, 1)
            start = {n: p.detach().clone()
                     for n, p in tr.model.named_parameters()
                     if p.requires_grad}
            row["train"] = _steps(tr, batch, 2)
            k1_step = 1 if name == "disconet" else 0  # the KD teacher
            expect(f"{name} training", _counts(), 2 * k1_step, 2 * k2,
                   2 * k2)
            unreached = LEGACY_UNREACHED.get(name)
            if name == "fpvrcnn" and any(
                    t["rcnn_reg_loss"] for t in row["train"]["terms"]):
                unreached = None  # a foreground RoI: the layer is reached
            row["trainable"] = moved(tr, start, name, unreached)
            if name == "disconet":
                bad = [n for n, t in teacher.state_dict().items()
                       if not torch.equal(t, before[n])]
                kd = [t["kd_loss"] for t in row["train"]["terms"]]
                if bad or not all(x > 0 for x in kd):
                    raise AssertionError(f"KD step: teacher entries moved "
                                         f"{bad[:3]}, kd_loss {kd}")
                row["teacher_entries"] = len(before)
                del teacher, before
            del tr, batch, start
            if name == "disconet":
                # the CLI: one epoch of one step from the teacher's run dir
                student_yaml = os.path.join(tmp.name, "student.yaml")
                save_yaml(cfg, student_yaml)
                tpath = ckpt_lib.find_checkpoint(teacher_dir)[1]
                with open(tpath, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                _zero_counts()
                t0 = time.perf_counter()
                out_dir = train_w_kd.main([
                    "-y", student_yaml, "--teacher_dir", teacher_dir,
                    "--model_dir", os.path.join(tmp.name, "student"),
                    "--epochs", "1"])
                torch.cuda.synchronize()
                row["cli_s"] = time.perf_counter() - t0
                expect("train_w_kd", _counts(), 1, k2, k2)
                with open(tpath, "rb") as f:
                    if hashlib.sha256(f.read()).hexdigest() != digest:
                        raise AssertionError("train_w_kd wrote the teacher")
                if ckpt_lib.find_checkpoint(out_dir)[0] != 1:
                    raise AssertionError("train_w_kd saved no checkpoint")
            rows[name] = row

            step = row["train"]
            print(f"[legacy] {name} ({cfg['model']['core_method']} on "
                  f"{cfg['fusion']['core_method']} fusion): serve ms/frame "
                  f"median [min, max] of {LEGACY_FRAMES - 1} after the first"
                  f", f32 {_fmt(row['serve_ms_f32'])}, bf16 "
                  f"{_fmt(row['serve_ms_bf16'])} (peak "
                  f"{row['serve_peak_gib']:.3f} GiB); launches a frame "
                  f"kernel 1 {k1}, kernel 2 {k2}, kernel 3 {k3} (f32); f32 "
                  f"heads vs plain max rel"
                  f" err {row['heads_rel']:.3e} (tol {HEADS_TOL}); train "
                  f"step {step['ms']:.3f} ms f32 (batch {step['batch']}, "
                  f"after a warm one), peak {step['peak_gib']:.3f} GiB, "
                  "losses " + ", ".join(f"{x:.4f}" for x in step["losses"])
                  + f"; all {row['trainable']} trainable parameters moved "
                  "(the softmax shifts: with a gradient); launches a step "
                  f"kernel 1 {k1_step}, kernel 2 {k2} forward and {k2} "
                  "backward"
                  + (f"; KD: kd_loss "
                     + ", ".join(f"{t['kd_loss']:.4f}" for t in step["terms"])
                     + f", the teacher's {row['teacher_entries']} entries "
                     "bit-equal; train_w_kd's epoch of one step "
                     f"{row['cli_s']:.3f} s, its teacher checkpoint "
                     "unchanged" if name == "disconet" else "")
                  + (f"; decode_stage2 served every frame"
                     if name == "fpvrcnn" else ""))
    finally:
        inference_tool.decode_stage2 = real_decode
        tmp.cleanup()
    print(f"[legacy] phase {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return {"launches": total, "rows": rows, "kernels": kernels}


def optional_packages() -> dict:
    """Which optional packages this host has: matplotlib (PNG writing),
    scikit-learn (t-SNE), open3d (the interactive viewer)."""
    import importlib.util

    return {name: importlib.util.find_spec(name) is not None
            for name in ("matplotlib", "sklearn", "open3d")}


def check_layouts(ref: dict, sd: dict, dev) -> dict:
    """The transplant's layout maps held element by element on the
    flagship: every port entry of ``sd`` against its reference weight in
    ``ref`` (utils/transplant._reference_entry), exactly: the PFN linear
    transposed, OIHW convs as they are, each ConvTranspose2d weight as it
    is (deconv_kernel's double flip undone by the bridge), BN entries
    1:1, each grouped ResNeXt conv block-diagonal with zeros off the
    blocks; then on the card the last grouped conv's dense kernel
    against F.conv2d(groups=32) with the reference weight, f32 (TF32
    off). -> the counts and that error."""
    import torch.nn.functional as F

    from heal_tpu_torch.utils.transplant import _reference_entry

    counts = {"exact": 0, "transposed": 0, "grouped": 0, "deconv": 0}
    grouped = None
    for key, t in sd.items():
        entry = _reference_entry(key, tuple(t.shape), "")
        if entry is None:
            continue
        w = ref[entry[0]]
        if key.endswith("pfn_kernel"):
            ok = torch.equal(t, w.T)
            counts["transposed"] += 1
        elif tuple(w.shape) != tuple(t.shape):  # grouped conv2
            g, ig = 32, w.shape[1]
            og = w.shape[0] // g
            want = torch.zeros_like(t)
            for i in range(g):
                want[i * og:(i + 1) * og, i * ig:(i + 1) * ig] = \
                    w[i * og:(i + 1) * og]
            ok = torch.equal(t, want)
            counts["grouped"] += 1
            grouped = (w, t)
        else:
            ok = torch.equal(t, w)
            counts["deconv" if key.endswith("ConvTranspose_0.kernel")
                   else "exact"] += 1
        if not ok:
            raise AssertionError(f"transplant layout: {key} <- {entry[0]}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    w, dense = (x.to(dev) for x in grouped)
    x = torch.randn((1, w.shape[1] * 32, 32, 64), generator=gen, device=dev)
    counts["grouped_rel"] = rel_err(F.conv2d(x, dense, padding=1),
                                    F.conv2d(x, w, padding=1, groups=32))[1]
    if not counts["grouped_rel"] <= KERNEL_TOL[torch.float32]:
        raise AssertionError(f"grouped -> dense on the card: "
                             f"{counts['grouped_rel']}")
    return counts


def _column_values(cols, feats, sites: dict):
    """The column engine's ``feats`` (1, Vc, Z, C) at the oracle's active
    ``sites`` (one sample), and whether every site is an occupied voxel
    of ``cols``."""
    _, _, w = cols["grid"]
    c = sites["coords"][sites["valid"]].long()
    key2 = (c[:, 1] * w + c[:, 2]).to(torch.int32)
    ck = cols["ckeys"][0].contiguous()
    pos = torch.clamp(torch.searchsorted(ck, key2), max=ck.shape[0] - 1)
    found = (ck[pos] == key2) & cols["occ"][0, pos, c[:, 0]]
    return feats[0, pos, c[:, 0]], bool(found.all())


def oracle_vs_columns(points, mask, lidar_range, voxel_size, gen) -> dict:
    """The oracle engine (ops/sparse_conv.py) against the column engine
    (ops/column_conv.py) on one cloud, capacities holding every voxel:
    the same active sites after voxelizing and after a strided conv, the
    voxel means, and a submanifold and a strided conv with the same
    seeded weights, within ORACLE_TOL (f32). -> the sites and errors."""
    from heal_tpu_torch.ops import column_conv as cc
    from heal_tpu_torch.ops import sparse_conv as sc

    cap = int(mask.sum())
    sp = sc.voxelize_points(points, mask, lidar_range, voxel_size, cap)
    cols = cc.voxelize_columns(points[None], mask[None], lidar_range,
                               voxel_size, cap)
    out = {"voxels": int(sp["valid"].sum())}
    if out["voxels"] != int(cols["occ"].sum()):
        raise AssertionError("oracle vs columns: voxel counts differ")
    errs = {}
    got, found = _column_values(cols, cols["feats"], sp)
    errs["means"] = rel_err(sp["feats"][sp["valid"]], got)[1]
    w1 = 0.3 * torch.randn((27, 4, 16), generator=gen, device=points.device)
    sp = dict(sp, feats=sc.subm_conv(sp, w1))
    cols = dict(cols, feats=cc.subm_conv(cols, w1))
    got, found2 = _column_values(cols, cols["feats"], sp)
    errs["subm"] = rel_err(sp["feats"][sp["valid"]], got)[1]
    w2 = 0.3 * torch.randn((27, 16, 8), generator=gen, device=points.device)
    sites = sc.downsample_sites(sp, 8 * cap)
    o_sp = sc.strided_conv(sp, sites, w2)
    cols2 = cc.strided_conv(cols, cc.downsample_columns(cols, 4 * cap), w2)
    out["strided_sites"] = int(sites["valid"].sum())
    if (out["strided_sites"] != int(cols2["occ"].sum())
            or sites["grid"] != cols2["grid"]):
        raise AssertionError("oracle vs columns: strided sites differ")
    got, found3 = _column_values(cols2, cols2["feats"], sites)
    errs["strided"] = rel_err(o_sp[sites["valid"]], got)[1]
    if not (found and found2 and found3):
        raise AssertionError("oracle vs columns: a site is missing")
    if not max(errs.values()) <= ORACLE_TOL:
        raise AssertionError(f"oracle vs columns: {errs}")
    out["rel"] = errs
    return out


def _events_ms(fn, n: int = 3) -> float:
    """Median device ms of ``fn`` over ``n`` calls after a warm one."""
    fn()
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def keypoint_messages(model, inputs) -> list:
    """FPV-RCNN's messages of one frame: each sending agent's (not the
    ego's) valid keypoints (K, 3) and features (K, C) as the keypoint
    encoder hands them on, on the host."""
    got = {}
    hook = model.kp_encoder.register_forward_hook(
        lambda mod, inp, out: got.update(out=out))
    try:
        with torch.inference_mode():
            model(inputs)
    finally:
        hook.remove()
    kp, feat, kmask = got["out"]
    agents = inputs["agent_mask"].reshape(-1)
    return [(kp[j][kmask[j]].float().cpu().numpy(),
             feat[j][kmask[j]].float().cpu().numpy())
            for j in range(1, kp.shape[0]) if bool(agents[j])]


def where2comm_messages(model, inputs, lidar_range) -> list:
    """Where2comm's messages of one frame: each sending agent's BEV cells
    under its communication mask, as (cell centres (n, 3) in metres,
    features (n, C)) on the host."""
    from heal_tpu_torch.models.fuse.fusion_in_one import Where2commFusion
    from heal_tpu_torch.models.fuse.where2comm_comm import CommMask

    got = {}
    hooks = []
    for mod in model.modules():
        if isinstance(mod, CommMask):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o: got.update(mask=o[0])))
        elif isinstance(mod, Where2commFusion):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a: got.update(feat=a[0])))
    try:
        with torch.inference_mode():
            model(inputs)
    finally:
        for h in hooks:
            h.remove()
    mask, feat = got["mask"][0, ..., 0], got["feat"][0]  # (L, h, w), (L, h, w, C)
    if mask.shape != feat.shape[:3]:
        raise AssertionError(f"where2comm: mask {tuple(mask.shape)} vs "
                             f"features {tuple(feat.shape)}")
    _, h, w = mask.shape
    x0, y0, _, x1, y1, _ = lidar_range
    out = []
    for j in range(1, mask.shape[0]):
        if not bool(inputs["agent_mask"][0, j]):
            continue
        iy, ix = torch.nonzero(mask[j] > 0, as_tuple=True)
        xy = torch.stack([x0 + (ix + 0.5) * (x1 - x0) / w,
                          y0 + (iy + 0.5) * (y1 - y0) / h,
                          torch.zeros_like(iy, dtype=torch.float32)], -1)
        out.append((xy.float().cpu().numpy(),
                    feat[j][mask[j] > 0].float().cpu().numpy()))
    return out


def cpm_frame(messages: list) -> dict:
    """A frame's CPM bytes (raw, quantized, compressed) summed over its
    senders' messages (utils/cpm_size.cpm_size_bytes)."""
    from heal_tpu_torch.utils.cpm_size import cpm_size_bytes

    sizes = [cpm_size_bytes(c, f) for c, f in messages]
    return {k: sum(s[k] for s in sizes) for k in ("raw", "quantized",
                                                   "compressed")}


def footprints_drawn(canvas, corners) -> list:
    """For each GT box (corners (K, 8, 3)): the pixels drawn on
    ``canvas`` (a CanvasBEV) inside its footprint's bounding rectangle."""
    drawn = canvas.get_canvas().any(axis=-1)
    h, w = canvas.shape
    out = []
    for box in corners:
        rows, cols, _ = canvas.get_canvas_coords(box[:4, :2])
        r0, r1 = max(int(rows.min()), 0), min(int(rows.max()), h - 1)
        c0, c1 = max(int(cols.min()), 0), min(int(cols.max()), w - 1)
        out.append(int(drawn[r0:r1 + 1, c0:c1 + 1].sum()))
    return out


def tools_cfgs() -> dict:
    """Phase 14's configs: the flagship (TOOLS_FRAMES test scenes), the m3
    stage-2 config (its encoder args, one frame), stage 1 of the protocol
    for the ap_curve run (AP_SCENES, AP_BATCH, a checkpoint and a
    validation every epoch), phase 13's FPV-RCNN and phase 10's
    CenterPoint with Where2comm (CPM_FRAMES test scenes each)."""
    cfg = flagship_cfg()
    cfg["fusion"]["args"]["num_scenes_test"] = TOOLS_FRAMES
    pcfgs = protocol_cfgs()
    m3 = pcfgs["stage2_m3"]
    m3["fusion"]["args"]["num_scenes_test"] = 1
    ap = pcfgs["stage1"]
    ap["fusion"]["args"].update(num_scenes_train=AP_SCENES[0],
                                num_scenes_test=AP_SCENES[1])
    ap["train_params"].update(batch_size=AP_BATCH, save_freq=1, eval_freq=1)
    fpv = legacy_cfgs()["fpvrcnn"]
    w2c = anchor_free_cfgs()["center_point"]
    for c in (fpv, w2c):
        c["fusion"]["args"]["num_scenes_test"] = CPM_FRAMES
    return {"flagship": cfg, "m3": m3, "ap": ap, "fpvrcnn": fpv,
            "where2comm": w2c}


def phase_tools(cfgs: dict) -> dict:
    """The tools, viewers and weight transplant (module docstring, phase
    14); returns each kernel's launches over the phase."""
    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.models.layers import channels_last
    from heal_tpu_torch.models.second import SecondRefEncoder
    from heal_tpu_torch.tools import ap_curve, bench_matrix, profiler
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import (build_weights, device_frames,
                                                ego_points, run_inference)
    from heal_tpu_torch.utils import box_np
    from heal_tpu_torch.utils.cpm_size import save_ply
    from heal_tpu_torch.utils.transplant import (
        synthetic_reference, transplant_heter_pyramid_collab,
        transplant_second_encoder)
    from heal_tpu_torch.visualization import feature_analysis as fa
    from heal_tpu_torch.visualization.canvas import CanvasBEV

    import numpy as np

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t_phase = time.perf_counter()
    total = {k: 0 for k in _counts()}
    rows = {}

    def expect(what, k1, k2, k2b=0, k3=0):
        got = _counts()
        want = {"pillar_tables": k1, "shift_rows": k2,
                "shift_rows_backward": k2b, "column_conv": k3,
                "window_attention": 0}
        if got != want:
            raise AssertionError(f"{what}: launches {got}, want {want}")
        for k in total:
            total[k] += got[k]
        _zero_counts()

    have = optional_packages()
    print("[tools] the card's host: " + ", ".join(
        f"{k} {'installed' if v else 'not installed'}"
        for k, v in have.items()))
    if not have["matplotlib"]:
        print("[tools] matplotlib is not installed here: PNG writing "
              "(visualize, save_canvas, scatter_by_label) is held on the "
              "CPU only (tests/test_torch_visualization.py); the numpy "
              "canvases are checked here")
    if not have["sklearn"]:
        print("[tools] scikit-learn is not installed here: t-SNE is held "
              "on the CPU only; CKA and MMD are checked here")
    tmp = tempfile.TemporaryDirectory()
    try:
        # -- transplant: a synthetic opencood checkpoint into the flagship
        cfg = cfgs["flagship"]
        k1, k2, _ = TOOLS_LAUNCHES
        model = build_weights(cfg, seed=SEED)
        sd = model.state_dict()
        ref = synthetic_reference(sd, seed=SEED)
        new = transplant_heter_pyramid_collab(ref, sd, cfg["model"]["args"])
        model.load_state_dict(new, strict=True)
        layout = check_layouts(ref, new, dev)
        model32 = channels_last(model.to(dev))
        frames = device_frames(cfg, dev, TOOLS_FRAMES)
        _zero_counts()
        runs, served = _serve(cfg, model32, frames, "transplanted flagship")
        _zero_counts()
        if served != {"pillar_tables": 2 * TOOLS_FRAMES * k1,
                      "shift_rows": 2 * TOOLS_FRAMES * k2,
                      "shift_rows_backward": 0, "column_conv": 0,
                      "window_attention": 0}:
            raise AssertionError(f"transplanted flagship: launches {served}")
        for k in total:
            total[k] += served[k]
        heads = heads_vs_plain(model32, frames, "transplanted flagship")
        _zero_counts()  # the comparison's launches are not the path's
        rows["transplant"] = dict(layout, entries=len(ref), of=len(sd),
                                  heads_rel=heads)
        print(f"[tools] transplant: {len(ref)} opencood entries into "
              f"{len(sd)} of the flagship's, loaded strictly; layouts "
              f"exact: {layout['transposed']} PFN transposed, "
              f"{layout['exact']} OIHW convs / norms / biases, "
              f"{layout['deconv']} ConvTranspose2d (double flip undone), "
              f"{layout['grouped']} grouped -> dense block-diagonal "
              f"(F.conv2d groups=32 on the card: rel "
              f"{layout['grouped_rel']:.3e}); served {TOOLS_FRAMES} frames "
              f"f32 {_fmt(_stats_ms(runs['f32']['serve_s']))}, bf16 "
              f"{_fmt(_stats_ms(runs['bf16']['serve_s']))} ms; launches a "
              f"frame {k1} + {k2}; f32 heads vs plain {heads:.3e} (tol "
              f"{HEADS_TOL})")

        # -- --save_vis, the canvases and the feature analysis
        vis_dir = os.path.join(tmp.name, "vis_run")
        os.makedirs(vis_dir)
        save_yaml(cfg, os.path.join(vis_dir, "config.yaml"))
        feats = {}
        hook = model32.branch_m1.register_forward_hook(
            lambda m, i, o: feats.update(bev=o[0]))
        try:
            if have["matplotlib"]:
                res = run_inference(vis_dir, cfg, device=dev, model=model32,
                                    frames=frames[:1], save_vis=True,
                                    vis_interval=1)
                png = os.path.join(vis_dir, "vis", "bev_00000.png")
                if not os.path.getsize(png) > 0:
                    raise AssertionError("--save_vis wrote no picture")
            else:
                res = run_inference(vis_dir, cfg, device=dev, model=model32,
                                    frames=frames[:1])
        finally:
            hook.remove()
        expect("--save_vis", k1, k2)
        batch = frames[0][0]
        post = cfg["postprocess"]
        gt = box_np.boxes_to_corners_3d(
            batch["gt_boxes"][0][batch["gt_mask"][0] > 0], post["order"])
        g = post["gt_range"]
        canvas = CanvasBEV((512, 1024), (g[0], g[1], g[3], g[4]))
        canvas.draw_canvas_points(ego_points(batch)[:, :2])
        canvas.draw_boxes(gt, colors=(0, 255, 0))
        drawn = footprints_drawn(canvas, gt)
        if not (gt.shape[0] and min(drawn) > 0):
            raise AssertionError(f"canvas: GT footprints drawn {drawn}")
        bev = feats["bev"]  # (agents, C, h, w) on the card
        cells = torch.randperm(bev.shape[2] * bev.shape[3], generator=gen,
                               device=dev)[:CKA_CELLS]
        a, b = (bev[i].flatten(1)[:, cells].T.float().cpu().numpy()
                .astype(np.float64) for i in (0, 1))
        cka = {"linear": fa.linear_cka(a, b), "kernel": fa.kernel_cka(a, b),
               "self": fa.linear_cka(a, a)}
        mmd = {"linear": fa.mmd_linear(a, b), "rbf": fa.mmd_rbf(a, b)}
        if not (0.0 <= cka["linear"] <= 1.0 and 0.0 <= cka["kernel"] <= 1.0
                and abs(cka["self"] - 1.0) <= 1e-6):
            raise AssertionError(f"CKA out of range: {cka}")
        tsne = "held on the CPU only"
        if have["sklearn"]:
            emb = fa.tsne_embed(np.concatenate([a[:256], b[:256]]))
            if emb.shape != (512, 2) or not np.isfinite(emb).all():
                raise AssertionError("t-SNE: bad embedding")
            tsne = "an embedding of 512 cells"
        rows["vis"] = {"cka": cka, "mmd": mmd, "drawn": drawn}
        print(f"[tools] --save_vis: "
              + ("bev_00000.png written" if have["matplotlib"] else
                 "the PNG held on the CPU only")
              + f" ({res['frames']} frame, 1 + 15 launches); CanvasBEV: "
              f"pixels drawn in each of the {len(drawn)} GT footprints "
              f"(min {min(drawn)}); {CKA_CELLS} BEV cells of agents 0 and "
              f"1 from the card: linear CKA {cka['linear']:.6f}, kernel CKA"
              f" {cka['kernel']:.6f}, self {cka['self']:.9f}; MMD linear "
              f"{mmd['linear']:.6f}, rbf {mmd['rbf']:.6f}; t-SNE {tsne}")
        del model32, model, frames, runs

        # -- SecondRefEncoder: a synthetic spconv checkpoint, the oracle
        m3 = cfgs["m3"]
        enc_args = m3["model"]["args"]["m3"]["encoder_args"]
        lr, vs = tuple(enc_args["lidar_range"]), tuple(enc_args["voxel_size"])
        enc = SecondRefEncoder(vs, lr)
        esd = enc.state_dict()
        rsd = synthetic_reference(esd, seed=SEED, prefix="encoder_m3")
        enc.load_state_dict(transplant_second_encoder(rsd, esd, "encoder_m3"),
                            strict=True)
        ck = "VmapSecondRefStack_0.conv_out.kernel"
        if not torch.equal(enc.state_dict()[ck], rsd[
                "encoder_m3.spconv_block.conv_out.0.weight"].reshape(3, 64,
                                                                     128)):
            raise AssertionError("SECOND transplant: conv_out layout")
        enc = enc.to(dev).eval()
        batch, _ = next(train_tool.device_batches(m3, 1, dev, train=False))
        pts = batch["inputs_m3"]["points"]
        msk = batch["inputs_m3"]["point_mask"]
        pts = pts.reshape(-1, *pts.shape[-2:])[:1]
        msk = msk.reshape(-1, msk.shape[-1])[:1]
        col = build_weights(m3, seed=SEED).branch_m3.encoder.to(dev).eval()
        with torch.inference_mode():
            out = enc(pts, msk)
            ref_ms = _events_ms(lambda: enc(pts, msk))
            col_ms = _events_ms(lambda: col(pts, msk))
            oracle = oracle_vs_columns(pts[0], msk[0], lr, vs, gen)
        if not (torch.isfinite(out).all() and out.abs().max() > 0):
            raise AssertionError("SecondRefEncoder: bad output")
        # the column encoder's warm and 3 timed forwards, f32
        expect("SecondRef and the oracle", 0, 0, k3=4 * M3_LAUNCHES)
        rows["second_ref"] = dict(oracle, ms=ref_ms, column_ms=col_ms,
                                  bev=list(out.shape))
        print(f"[tools] SecondRefEncoder (m3's encoder args, "
              f"{len(rsd)} spconv entries transplanted, loaded strictly): "
              f"BEV {tuple(out.shape)} in {ref_ms:.3f} ms a frame f32 "
              f"(median of 3 after a warm one) vs the column engine's "
              f"encoder {col_ms:.3f} ms; oracle vs column engine on "
              f"{int(msk[0].sum())} points: {oracle['voxels']} voxels and "
              f"{oracle['strided_sites']} strided sites the same, rel err "
              + ", ".join(f"{k} {v:.3e}" for k, v in oracle["rel"].items())
              + f" (tol {ORACLE_TOL})")
        del enc, col, batch, pts, msk, out
        torch.cuda.empty_cache()

        # -- the profiler on the flagship, f32 and bf16, --train at batch 2
        yaml = os.path.join(tmp.name, "flagship.yaml")
        save_yaml(cfg, yaml)
        fwd = 1 + 5 + TOOLS_ITERS
        steps = 1 + TOOLS_ITERS // 2
        for dname in ("f32", "bf16"):
            torch.cuda.reset_peak_memory_stats()
            rep = profiler.main(["-y", yaml, "--device", "cuda", "--iters",
                                 str(TOOLS_ITERS), "--dtype", dname,
                                 "--train"])
            expect(f"profiler {dname}", k1 * fwd, k2 * (fwd + steps),
                   k2 * steps)
            fl = rep["flops"]
            if not (fl["counter_flops"] > 0 and fl["kernel_ops"][
                    "pillar_tables"] > 0 and fl["kernel_ops"]["shift_rows"]
                    > 0):
                raise AssertionError(f"profiler: FLOP count {fl}")
            rows[f"profiler_{dname}"] = rep
            print(f"[tools] profiler {dname}: params {rep['params']}; "
                  f"FlopCounterMode {fl['counter_flops']} FLOPs a frame "
                  f"({fl['by_op']}), kernel 1 {fl['kernel_ops']['pillar_tables']}"
                  f" and kernel 2 {fl['kernel_ops']['shift_rows']} "
                  f"operations apart; {rep['inference']['latency_ms']:.3f} "
                  f"ms a forward ({rep['inference']['fps']:.2f} fps, "
                  f"{TOOLS_ITERS} after 5 warm, CUDA events); train step "
                  f"{rep['training']['step_ms']:.3f} ms at batch "
                  f"{rep['training']['batch_size']} "
                  f"({rep['training']['samples_per_sec']:.2f} samples/s); "
                  f"peak {rep['memory']['peak_bytes_in_use'] / 2**30:.3f} "
                  "GiB")
        torch.cuda.empty_cache()

        # -- bench_matrix's six rows, one CLI call each
        bench = []
        for name in ("pp_max", "second", "lss", "heter4", "train",
                     "train_bf16"):
            torch.cuda.empty_cache()
            (row,) = bench_matrix.main(["--paths", name, "--frames",
                                        str(BENCH_FRAMES), "--out",
                                        os.path.join(tmp.name, "bench.json")])
            if name.startswith("train"):
                n = 1 + BENCH_STEPS
                expect(f"bench {name}", 0, BENCH_TRAIN_SHIFTS * n,
                       BENCH_TRAIN_SHIFTS * n)
            else:
                n = 4 * BENCH_FRAMES  # a warm pass and 3 timed
                b1, b2, b3 = BENCH_LAUNCHES[name]
                expect(f"bench {name}", b1 * n, b2 * n, k3=b3 * n)
            if not row["fps"] > 0:
                raise AssertionError(f"bench {name}: {row}")
            bench.append(row)
            print(f"[tools] bench_matrix {json.dumps(row)}")
        rows["bench"] = bench

        # -- ap_curve over a 2-epoch stage-1 run of the CLI
        ap = cfgs["ap"]
        run_dir = os.path.join(tmp.name, "ap_run")
        ap_yaml = os.path.join(tmp.name, "ap.yaml")
        save_yaml(ap, ap_yaml)
        t0 = time.perf_counter()
        train_tool.main(["-y", ap_yaml, "--model_dir", run_dir, "--epochs",
                         str(AP_EPOCHS), "--no_final_inference", "--device",
                         "cuda"])
        train_s = time.perf_counter() - t0
        steps = AP_EPOCHS * (AP_SCENES[0] // AP_BATCH)
        vals = AP_EPOCHS * (AP_SCENES[1] // AP_BATCH)
        expect("the ap_curve run's training", k1 * vals,
               k2 * (steps + vals), k2 * steps)
        scripts = os.path.join(run_dir, "scripts", "heal_tpu_torch")
        built = [f for _, _, fs in os.walk(scripts) for f in fs
                 if f.endswith((".so", ".o"))]
        if not os.path.isdir(scripts) or built:
            raise AssertionError(f"the run's scripts/ snapshot: {built}")
        t0 = time.perf_counter()
        curve = ap_curve.main(["--model_dir", run_dir, "--max_batches",
                               str(AP_FRAMES)])
        curve_s = time.perf_counter() - t0
        expect("ap_curve", k1 * AP_EPOCHS * AP_FRAMES,
               k2 * AP_EPOCHS * AP_FRAMES)
        with open(os.path.join(run_dir, "ap_curve.json")) as f:
            if json.load(f) != curve:
                raise AssertionError("ap_curve.json differs from the curve")
        if ([r["epoch"] for r in curve] != list(range(1, AP_EPOCHS + 1))
                or not all(0.0 <= r[k] <= 1.0 for r in curve
                           for k in ("ap_30", "ap_50", "ap_70"))):
            raise AssertionError(f"ap_curve: {curve}")
        rows["ap_curve"] = curve
        print(f"[tools] ap_curve: tools/train.py {AP_EPOCHS} epochs of "
              f"{AP_SCENES[0] // AP_BATCH} steps at batch {AP_BATCH} in "
              f"{train_s:.1f} s (scripts/heal_tpu_torch snapshot, no built "
              f"library), then {len(curve)} epochs served {AP_FRAMES} "
              f"frames each in {curve_s:.1f} s: " + "; ".join(
                  f"epoch {r['epoch']} ap_30 {r['ap_30']:.4f} ap_50 "
                  f"{r['ap_50']:.4f} ap_70 {r['ap_70']:.4f}" for r in curve))

        # -- CPM sizes: FPV-RCNN's keypoints, Where2comm's sent cells
        cpm = {}
        for name, launches in (("fpvrcnn", (0, 0, M3_LAUNCHES)),
                               ("where2comm", AF_LAUNCHES["center_point"])):
            c = cfgs[name]
            torch.cuda.empty_cache()
            model = channels_last(build_weights(c, seed=SEED).to(dev)).eval()
            frames = device_frames(c, dev, CPM_FRAMES)
            sizes = []
            for _, x in frames:
                msgs = (keypoint_messages(model, x) if name == "fpvrcnn" else
                        where2comm_messages(model, x,
                                            c["model"]["args"]["lidar_range"]))
                if not msgs:
                    raise AssertionError(f"cpm {name}: no sender")
                sizes.append(cpm_frame(msgs))
            expect(f"cpm {name}", launches[0] * CPM_FRAMES,
                   launches[1] * CPM_FRAMES, k3=launches[2] * CPM_FRAMES)
            kb = {k: statistics.mean(s[k] for s in sizes) / 1024
                  for k in ("raw", "quantized", "compressed")}
            if not kb["raw"] > 0:
                raise AssertionError(f"cpm {name}: {kb}")
            cpm[name] = kb
            ply = ""
            if name == "fpvrcnn":  # the reference's draco input: keypoints
                path = save_ply(os.path.join(tmp.name, "kp.ply"), *msgs[0])
                ply = f"; a message as PLY {os.path.getsize(path)} bytes"
            print(f"[tools] cpm_size {name}: "
                  f"{len(msgs)} sender(s) a frame, KB a frame (mean of "
                  f"{CPM_FRAMES}) raw {kb['raw']:.3f}, quantized "
                  f"{kb['quantized']:.3f}, zlib {kb['compressed']:.3f}{ply}")
            del model, frames
        rows["cpm"] = cpm
    finally:
        tmp.cleanup()
    print(f"[tools] phase {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}")
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


def _mesh_deltas(aux, grads, ref_aux, ref) -> tuple[float, float, float]:
    """(|loss delta|, max |gradient delta|, the loss) of a sharded step
    against one process."""
    loss = float(ref_aux["total_loss"])
    d_loss = abs(float(aux["total_loss"]) - loss)
    d_grad = max((grads[k].float() - ref[k].float()).abs().max().item()
                 for k in ref)
    return d_loss, d_grad, loss


def _max_grad(grads: dict) -> float:
    return max(g.float().abs().max().item() for g in grads.values())


def _within_multi_tol(what: str, d_loss: float, d_grad: float,
                      loss: float) -> None:
    scale = max(1.0, loss)
    if not (math.isfinite(loss) and d_loss <= MULTI_TOL["loss"] * scale
            and d_grad <= MULTI_TOL["grad"] * scale):
        raise AssertionError(f"{what}: the sharded step is not one "
                             f"process's: |dloss| {d_loss}, max |dgrad| "
                             f"{d_grad}, loss {loss}")


HOST_CLOCKS = ("process CPU", "main-thread CPU", "in Python's GC")


@contextlib.contextmanager
def _host_clocks():
    """-> a callable giving (process CPU s, this thread's CPU s, s spent
    in Python's garbage collector so far) while the context is open: what
    a step's host clock spends besides waiting for the card."""
    import gc

    spent, start = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            spent[0] += time.perf_counter() - start[0]

    gc.callbacks.append(on_gc)
    try:
        yield lambda: (time.process_time(), time.thread_time(), spent[0])
    finally:
        gc.callbacks.remove(on_gc)


def _thread_names() -> list:
    import threading

    return sorted(t.name for t in threading.enumerate())


def _kernel_ms(step) -> dict:
    """{kernel name: (device ms, calls)} of one call of ``step``, from a
    torch.profiler trace of the card (empty if the trace has no device
    time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            ms, n = out.get(e.key, (0.0, 0))
            out[e.key] = (ms + us / 1e3, n + e.count)
    return out


def _profile_diff(steps: dict) -> dict:
    """Trace one call of each of ``steps`` (name -> callable, two of
    them) and print the device totals and the MULTI_PROFILE_TOP kernels
    whose device time differs most; -> {name: total device ms}."""
    (a, fa), (b, fb) = steps.items()
    prof = {a: _kernel_ms(fa), b: _kernel_ms(fb)}
    total = {k: sum(ms for ms, _ in v.values()) for k, v in prof.items()}
    if not all(total.values()):
        print(f"[multi] torch.profiler: no device time in the trace "
              f"({a} {total[a]}, {b} {total[b]})")
        return total
    zero = (0.0, 0)

    def delta(k):
        return prof[b].get(k, zero)[0] - prof[a].get(k, zero)[0]

    keys = sorted(set(prof[a]) | set(prof[b]), key=lambda k: -abs(delta(k)))
    print(f"[multi] torch.profiler, one step each: device time {a} "
          f"{total[a]:.3f} ms in {sum(n for _, n in prof[a].values())} "
          f"kernels, {b} {total[b]:.3f} ms in "
          f"{sum(n for _, n in prof[b].values())}; the "
          f"{MULTI_PROFILE_TOP} kernels that differ most ({b} - {a}, ms; "
          "calls): " + "; ".join(
              f"{k[:70]} {delta(k):+.3f} ({prof[a].get(k, zero)[1]} / "
              f"{prof[b].get(k, zero)[1]})" for k in keys[:MULTI_PROFILE_TOP]))
    return total


def phase_multi_device(cfg, dev=torch.device("cuda")) -> dict:
    """Phase 16: the flagship on the device mesh; -> the launch counts of
    the one-rank mesh step and of the tools/train.main run."""
    import torch.distributed as dist

    from heal_tpu_torch.config import save_yaml
    from heal_tpu_torch.data import build_dataset
    from heal_tpu_torch.models import build_model
    from heal_tpu_torch.parallel import launch, to_device
    from heal_tpu_torch.parallel.sharding import make_mesh
    from heal_tpu_torch.tools import checkpoint as ckpt_lib
    from heal_tpu_torch.tools import dryrun_multichip as dry
    from heal_tpu_torch.tools import train as train_tool
    from heal_tpu_torch.tools.inference import build_weights

    bs = cfg["train_params"]["batch_size"]
    host = next(build_dataset(cfg, train=True).batches(bs, shuffle=False))
    batch = to_device(host, dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init.pth")
        torch.save(build_weights(cfg, seed=SEED).state_dict(), init)
        t0 = time.perf_counter()
        launch.init_rank(0, 1, dev.type, "file://" + os.path.join(tmp, "rdv"))
        try:
            mesh = make_mesh(1, 1, 1, 1)
            print(f"[multi] one-rank NCCL world up in "
                  f"{time.perf_counter() - t0:.3f} s: {mesh}, backend "
                  f"{dist.get_backend()}")
            torch.use_deterministic_algorithms(True, warn_only=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                plain = train_tool.build_trainer(cfg, dev, 1, resume=init)
                ref_aux = plain.gradients(batch)
                ref = _grad_leaves(plain.model)
                meshed = train_tool.build_trainer(cfg, dev, 1, resume=init,
                                                  mesh=mesh)
                _zero_counts()
                aux = meshed.gradients(batch)
                torch.cuda.synchronize()
                step_counts = _counts()
                grads = _grad_leaves(meshed.model)
            torch.use_deterministic_algorithms(False)
            loose = sorted({str(w.message).split(" does not have")[0]
                            for w in caught
                            if "deterministic" in str(w.message)})
            d_loss, d_grad, loss = _mesh_deltas(aux, grads, ref_aux, ref)
            print(f"[multi] flagship step, one-rank NCCL mesh vs the plain "
                  f"Trainer (same weights and batch of {bs}, deterministic, "
                  f"TF32 off): loss {loss:.4f}, |dloss| {d_loss:.3e}, max "
                  f"|dgrad| {d_grad:.3e} over {len(ref)} leaves (max |g| "
                  f"{_max_grad(ref):.3e}; bound: bit-equal); launches "
                  f"{step_counts}; ops without a deterministic kernel: "
                  f"{loose or 'none'}")
            if not (math.isfinite(loss) and d_loss == 0.0 and d_grad == 0.0):
                raise AssertionError(
                    f"the one-rank NCCL step is not the plain step: |dloss| "
                    f"{d_loss}, max |dgrad| {d_grad}")
            want = {"pillar_tables": 0, "shift_rows": 15, "column_conv": 0,
                    "shift_rows_backward": 15, "window_attention": 0}
            if step_counts != want:
                raise AssertionError(f"the mesh step launched {step_counts}, "
                                     f"want {want}")
            times = {"plain": [], "mesh": []}
            clock_s = {"plain": [], "mesh": []}
            torch.cuda.reset_peak_memory_stats()
            with _host_clocks() as clocks:
                for name in ("plain", "mesh", "mesh", "plain"):
                    tr = plain if name == "plain" else meshed
                    for _ in range(MULTI_TIMED):
                        torch.cuda.synchronize()
                        c0 = clocks()
                        t = time.perf_counter()
                        tr.train_step(batch)
                        torch.cuda.synchronize()
                        times[name].append(time.perf_counter() - t)
                        clock_s[name].append([b - a for a, b in
                                              zip(c0, clocks())])
            peak = torch.cuda.max_memory_allocated() / 2**30
            ms = {k: 1e3 * statistics.median(v) for k, v in times.items()}
            print(f"[multi] f32 train step, median of {2 * MULTI_TIMED} in "
                  f"turns (plain, mesh, mesh, plain): plain "
                  f"{ms['plain']:.3f} ms, one-rank mesh {ms['mesh']:.3f} ms "
                  f"(mesh - plain {ms['mesh'] - ms['plain']:+.3f} "
                  f"ms); ranges plain "
                  f"{1e3 * min(times['plain']):.3f}-"
                  f"{1e3 * max(times['plain']):.3f}, mesh "
                  f"{1e3 * min(times['mesh']):.3f}-"
                  f"{1e3 * max(times['mesh']):.3f} ms; peak {peak:.3f} GiB "
                  "(both models resident)")
            med = {k: [1e3 * statistics.median(c[i] for c in v)
                       for i in range(len(HOST_CLOCKS))]
                   for k, v in clock_s.items()}
            print("[multi] host clocks a step, medians (plain / mesh): "
                  + "; ".join(f"{what} {med['plain'][i]:.3f} / "
                              f"{med['mesh'][i]:.3f} ms"
                              for i, what in enumerate(HOST_CLOCKS))
                  + f"; Python threads {_thread_names()}")
            device_ms = _profile_diff({
                "plain": lambda: plain.train_step(batch),
                "mesh": lambda: meshed.train_step(batch)})
            out["step"] = dict(step_counts, ms=ms, peak_gib=peak,
                               d_loss=d_loss, d_grad=d_grad,
                               device_ms=device_ms)
            del plain, meshed
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        # MULTI_STEPS steps through the CLI: one batch an epoch
        run_cfg = copy.deepcopy(cfg)
        run_cfg["fusion"]["args"]["num_scenes_train"] = bs
        run_cfg["fusion"]["args"]["num_scenes_test"] = bs
        run_cfg["train_params"]["eval_freq"] = MULTI_STEPS
        run_cfg["train_params"]["save_freq"] = MULTI_STEPS
        cfg_path = os.path.join(tmp, "flagship.yaml")
        save_yaml(run_cfg, cfg_path)
        run = os.path.join(tmp, "run")
        _zero_counts()
        t0 = time.perf_counter()
        train_tool.main(["-y", cfg_path, "--model_dir", run, "--epochs",
                         str(MULTI_STEPS), "--devices", "1", "--device",
                         dev.type, "--no_final_inference"])
        main_s = time.perf_counter() - t0
        main_counts = _counts()
        with open(os.path.join(run, "train_log.jsonl")) as f:
            losses = [json.loads(line)["total_loss"] for line in f]
        _, path = ckpt_lib.find_checkpoint(run)
        one = build_model(train_tool.load_config(cfg_path)["model"])
        one.load_state_dict(torch.load(path), strict=True)
        print(f"[multi] tools/train.main --devices 1 --device cuda: "
              f"{MULTI_STEPS} steps (an epoch of one batch of {bs} each) and "
              f"a validation in {main_s:.3f} s; losses "
              + ", ".join(f"{x:.4f}" for x in losses)
              + f"; launches {main_counts}; {os.path.basename(path)} loaded "
              "strictly into one process's model")
        if not (len(losses) == MULTI_STEPS
                and all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"--devices 1: losses {losses}")
        if (main_counts["shift_rows_backward"] < 15 * MULTI_STEPS
                or main_counts["shift_rows"] < 15 * MULTI_STEPS):
            raise AssertionError(f"--devices 1 launched {main_counts}")
        out["main"] = main_counts

        # two gloo ranks on the one card, a mesh axis each
        agent_cfg = copy.deepcopy(cfg)
        agent_cfg["train_params"]["max_cav"] = MULTI_AGENTS
        cfgs = {name: agent_cfg if name == "agent" else cfg
                for name in GLOO_MESHES}
        batches = {name: host if name != "agent" else next(
            build_dataset(agent_cfg, train=True).batches(bs, shuffle=False))
            for name in GLOO_MESHES}
        jobs = [dict(cfg=cfgs[n], state=init, batch=batches[n], dims=d,
                     dtype="float32") for n, d in GLOO_MESHES.items()]
        t0 = time.perf_counter()
        results = dry.sharded_results(jobs, 2, dev.type, timeout_s=300.0,
                                      backend="gloo")
        world_s = time.perf_counter() - t0
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            singles = {n: dry.one_process(cfgs[n], init, batches[n], dev)
                       for n in GLOO_MESHES}
        torch.use_deterministic_algorithms(False)
        for (name, dims), res in zip(GLOO_MESHES.items(), results):
            single = singles[name]
            d_loss, d_grad = dry.equivalence_deltas(res, single)
            loss = single["aux"]["total_loss"]
            print(f"[multi] two gloo ranks on one card, {name} mesh "
                  f"{'x'.join(map(str, dims))}"
                  + (f" ({MULTI_AGENTS} agent slots)" if name == "agent"
                     else "")
                  + f": loss {loss:.4f}, |dloss| {d_loss:.3e}, max |dgrad| "
                  f"{d_grad:.3e} (max |g| {_max_grad(single['grads']):.3e}) "
                  "against one process")
            _within_multi_tol(f"gloo {name}", d_loss, d_grad, loss)
        print(f"[multi] the gloo world (two ranks, {len(jobs)} steps, each "
              f"rank's model build included) took {world_s:.3f} s")
    return out


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
    conv = phase_column_conv(pcfgs["final"])
    torch.cuda.empty_cache()
    attn = phase_window_attention()
    torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trees = disk_trees(tmp)
        readers = pcd_readers(trees["opv2v"], tmp)
        disk = phase_disk(disk_cfgs(trees), trees, readers, smi)
    torch.cuda.empty_cache()
    camera = phase_camera_options(camera_cfgs())
    torch.cuda.empty_cache()
    legacy = phase_legacy(legacy_cfgs())
    torch.cuda.empty_cache()
    tools = phase_tools(tools_cfgs())
    torch.cuda.empty_cache()
    phase_pipeline()
    torch.cuda.empty_cache()
    multi = phase_multi_device(cfg)
    # kernel 3's row: its own cases (phase_column_conv), its launches from
    # every phase's run as the others'
    rows["column_conv"] = conv
    for name in rows:
        i = KERNELS.index(name)
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
            c: AF_LAUNCHES[c][i] for c in AF_CFGS}
        rows[name]["disk_launches"] = disk["launches"][name]
        rows[name]["disk_launches_per_frame"] = {
            c: DISK_LAUNCHES[c][i] for c in DISK_CFGS}
        rows[name]["camera_and_options_launches"] = camera["launches"][name]
        rows[name]["camera_and_options_launches_per_forward"] = {
            c: r["launches_per_forward"][name]
            for c, r in camera["rows"].items()}
        rows[name]["legacy_launches"] = legacy["launches"][name]
        rows[name]["legacy_launches_per_frame"] = {
            c: n[i] for c, n in LEGACY_LAUNCHES.items()}
        rows[name]["tools_launches"] = tools["launches"][name]
        rows[name]["tools_launches_per_frame"] = {
            "flagship": TOOLS_LAUNCHES[i],
            **{f"bench_{c}": n[i]
               for c, n in BENCH_LAUNCHES.items()}}
    rows["shift_rows"]["disk_launches_per_step"] = 15
    for name in rows:
        rows[name]["multi_device_launches"] = (multi["step"][name]
                                               + multi["main"][name])
        rows[name]["multi_device_launches_per_step"] = multi["step"][name]
    rows["shift_rows"]["multi_device_backward_launches"] = (
        multi["step"]["shift_rows_backward"]
        + multi["main"]["shift_rows_backward"])
    # phases 10, 11 and 13's own kernel cases (the CenterPoint frame's,
    # the disk frame's, the multiscale frame's and the KD teacher's kernel
    # 1, the fusion warps' kernel 2) join the rows' cases and worst errors
    for case_list in [r["kernels"] for r in anchor_free["rows"].values()] + [
            disk["kernels"], legacy["kernels"]]:
        for case in case_list:
            row = rows["pillar_tables" if "u" in case else "shift_rows"]
            row["cases"].append(case)
            err = ("backward_max_abs_err"
                   if case.get("direction") == "backward" else "max_abs_err")
            row[err] = max(row[err], case["max_abs_err"])
    for name in rows:
        rows[name]["train_launches"] = trained[name]
    rows["shift_rows"]["backward_launches"] = trained["shift_rows_backward"]
    rows["shift_rows"]["tools_backward_launches"] = tools["launches"][
        "shift_rows_backward"]
    rows["shift_rows"]["fusion_timings_backward_launches_per_step"] = {
        c: r["train_launches_per_step"]["shift_rows_backward"]
        for c, r in fusion["rows"].items() if "train_launches_per_step" in r}

    meta = {
        "pillar_tables": ("heal_tpu_torch/csrc/pillar_tables.cu",
                          "heal_tpu/ops/pallas_pillar.py:214"),
        "shift_rows": ("heal_tpu_torch/csrc/shift_rows.cu",
                       "heal_tpu/ops/pallas_shear.py:54"),
        "column_conv": ("heal_tpu_torch/csrc/column_conv.cu",
                        "none: JAX's column engine is XLA ops"),
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
              f", {k['disk_launches']} in the disk phase (a frame: "
              f"{k['disk_launches_per_frame']})"
              f", {k['camera_and_options_launches']} in the camera and "
              f"options phase (a forward: "
              f"{k['camera_and_options_launches_per_forward']})"
              f", {k['legacy_launches']} in the legacy detectors phase (a "
              f"frame: {k['legacy_launches_per_frame']})"
              f", {k['tools_launches']} in the tools phase (a frame: "
              f"{k['tools_launches_per_frame']})"
              f", {k['multi_device_launches']} in the device-mesh phase "
              f"({k['multi_device_launches_per_step']} a mesh step)"
              + f"; {k['bytes']} bytes, bound {k['bound_ms']:.4f} ms "
              f"({k['bound_by']}), {k['ms']:.4f} ms = {k['pct_of_bound']:.1f}%"
              f" of bound, plain {k['plain_ms']:.4f} ms, library call "
              + (f"{k['library_ms']:.4f} ms" if k["library_ms"] is not None
                 else "none"))
    print(f"[kernels] column_conv: {conv['launches_per_m3_forward']} "
          f"launches an m3 forward; the dense frame's 64 -> 64 subm "
          f"{conv['ms']:.4f} ms = {conv['pct_of_bound']:.1f}% of its bound "
          f"{conv['bound_ms']:.4f} ms ({conv['bound_by']}), plain "
          f"{conv['plain_ms']:.4f} ms; the m3 encoder " + ", ".join(
              f"{f} {e['ms']:.3f} ms (plain layers {e['plain_ms']:.3f} ms)"
              for f, e in conv["encoder"].items()))
    # kernel 4's row: its own cases and fusion (phase_window_attention),
    # its launches from every phase's run as the others' (0 on the
    # flagship's path; k4_per_forward an f32 V2X-ViT forward)
    phases = {"protocol": protocol, "baselines": baselines,
              "fusion_timings": fusion, "pose": pose,
              "anchor_free": anchor_free, "disk": disk,
              "camera_and_options": camera, "legacy": legacy, "tools": tools}
    kernels.append({
        "name": "window_attention", "route": "cuda",
        "source": "heal_tpu_torch/csrc/window_attention.cu",
        "replaces": "none: JAX's MSwin is flax attention, XLA ops",
        "launches": launches["window_attention"],
        "train_launches": trained["window_attention"],
        **{f"{p}_launches": r["launches"]["window_attention"]
           for p, r in phases.items()},
        "multi_device_launches": (multi["step"]["window_attention"]
                                  + multi["main"]["window_attention"]),
        **attn})
    print(f"[kernels] window_attention: {attn['launches_per_v2xvit_forward']}"
          f" launches a published V2X-ViT forward, "
          f"{kernels[-1]['launches']} serving the flagship, "
          f"{kernels[-1]['train_launches']} training it, "
          f"{kernels[-1]['baselines_launches']} in the baselines phase, "
          f"{kernels[-1]['fusion_timings_launches']} in the fusion timings "
          f"phase, {kernels[-1]['camera_and_options_launches']} in the "
          f"camera and options phase; window 16 "
          f"{attn['ms']:.4f} ms = {attn['pct_of_bound']:.1f}% of its bound "
          f"{attn['bound_ms']:.4f} ms ({attn['bound_by']}), plain "
          f"{attn['plain_ms']:.4f} ms, F.scaled_dot_product_attention "
          f"{attn['library_ms']:.4f} ms; the fusion {attn['fusion_ms']:.3f} "
          f"ms (plain {attn['fusion_plain_ms']:.3f} ms)")
    print(f"[card] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
