"""Inference + AP evaluation for the port.

Counterpart of heal_tpu/tools/inference.py ``run_inference``: dataset
(the port's numpy host side) -> model -> decode + rotated NMS ->
AP@0.3/0.5/0.7 with the VOC matcher of utils/eval_np.py, and for each
camera agent type its depth RMSE (``depth_rmse_mX``,
utils/camera.depth_metric) beside the AP, and for Where2comm the mean
``comm_rate`` over the frames. Intermediate and early fusion run one
forward a frame; late fusion (``late``, ``lateheter``) one forward at
batch 1 per agent sample, the ego's first, each decoded with its
``transformation_matrix`` to the ego and merged by one cross-agent NMS
(postprocess/decode.fuse_and_nms), as JAX does. A two-stage model
(FPV-RCNN: ``rcnn_cls`` in its outputs) is evaluated on its refined
collaborative detections (postprocess/decode.decode_stage2), not on the
per-agent stage-1 heads. ``save_vis`` draws every ``vis_interval``-th
frame's detections (red), GT boxes (green) and the ego's points in BEV
to ``<model_dir>/vis/bev_{n:05d}.png`` (visualization/simple_vis.py), as
JAX's ``--save_vis`` does.

    python -m heal_tpu_torch.tools.inference --config heal_tpu/configs/opv2v_m1_pyramid.yaml \
        [--checkpoint net.pt | --seed 0] [--dtype bf16] [--max_batches 8] \
        [--model_dir runs/x --save_vis]

A checkpoint is a ``torch.save``d state_dict with the bridged key names
(utils/bridge.py, tools/checkpoint.py) or a heal_tpu ``.ckpt``; with
``--model_dir`` and no ``--checkpoint`` the run's best-validation (else
newest) checkpoint is served; without any the weights are a seeded random
init. ``noise_setting``, ``cfg_override`` and ``override_range`` change
the config as JAX's do (merged in with ``update_dict``, then the
config's ``yaml_parser`` runs again); the in-order and pose-noise
evaluations (tools/inference_heter_in_order.py, inference_w_noise.py)
drive them.
"""
from __future__ import annotations

import argparse
import copy
import os
import time

import numpy as np
import torch

from .. import trace
from ..config import load_yaml, reparse
from ..data import assembler_class, build_dataset
from ..data.scene import collate
from ..models import build_model
from ..models.layers import channels_last, init_weights
from ..models.registry import model_class
from ..postprocess.decode import (decode_stage2, fuse_and_nms,
                                  post_process_single, strip_padding)
from ..utils import box_np, camera, eval_np
from ..utils.common_np import update_dict
from . import checkpoint as ckpt_lib

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
# the top-level batch keys a model reads, unless its class names its own
# (``batch_keys``); every inputs_mX and slots_mX is read as well
_BATCH_KEYS = ("agent_mask", "pairwise_affine", "agent_modality")


def build_weights(cfg: dict, checkpoint: str | None = None, seed: int = 0):
    """The eval-mode model of ``cfg``, from a checkpoint or a seeded init."""
    model = build_model(cfg["model"],
                        max_cav=cfg["train_params"].get("max_cav", 5))
    if checkpoint is not None:
        model.load_state_dict(ckpt_lib.load_state_dict(checkpoint),
                              strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model


def apply_overrides(cfg: dict, *, noise_setting: dict | None = None,
                    cfg_override: dict | None = None,
                    override_range=None) -> dict:
    """A copy of ``cfg`` changed as JAX's run_inference changes it: the
    noise setting replaced, ``cfg_override`` merged in (``update_dict``),
    ``override_range`` (x, y half-extents) written into the lidar, GT and
    anchor ranges; after either of the last two the config's
    ``yaml_parser`` runs again."""
    cfg = copy.deepcopy(cfg)
    if noise_setting is not None:
        cfg["noise_setting"] = noise_setting
    if cfg_override:
        update_dict(cfg, copy.deepcopy(cfg_override))
    if override_range is not None:
        r = override_range
        new_range = [-r[0], -r[1], -3, r[0], r[1], 1]
        update_dict(cfg, {
            "preprocess": {"cav_lidar_range": new_range},
            "postprocess": {"gt_range": new_range,
                            "anchor_args": {"cav_lidar_range": new_range}},
        })
    if cfg_override or override_range is not None:
        cfg = reparse(cfg)
    return cfg


def batch_keys(cfg: dict) -> tuple:
    """The top-level batch keys ``cfg``'s model reads."""
    return getattr(model_class(cfg["model"]["core_method"]), "batch_keys",
                   _BATCH_KEYS)


def _model_inputs(batch: dict, keys, device) -> dict:
    """The arrays the model reads (``keys``, every inputs_mX and
    slots_mX), as tensors on ``device``; an array the batch holds under
    two keys (collate aliases ``points`` and ``inputs_m1/points``)
    crosses once. Points, affines and labels stay f32 whatever the
    model's dtype. Each array's copy is pageable and blocking
    (``host_sync.h2d``)."""
    memo: dict = {}

    def conv(x):
        if id(x) not in memo:  # keep x alive: its id stays unique
            memo[id(x)] = (x, torch.from_numpy(np.asarray(x)).to(device))
            trace.count("host_sync.h2d")
        return memo[id(x)][1]

    out = {}
    for k, v in batch.items():
        if k.startswith("inputs_") and isinstance(v, dict):
            out[k] = {kk: conv(vv) for kk, vv in v.items()}
        elif k in keys or k.startswith("slots_"):
            out[k] = conv(v)
    return out


def frame_inputs(batch: dict, keys, device, late: bool):
    """One test frame's model inputs on ``device``: a dict, or for late
    fusion a list of them, the ego's then each agent sample's (batch 1
    each). Opens the frame's request in the tracer (span
    ``serve.inputs``)."""
    with trace.request("serve.inputs"):
        if not late:
            return _model_inputs(batch, keys, device)
        return [_model_inputs(batch, keys, device)] + [
            _model_inputs(collate([s]), keys, device)
            for s in batch["agent_samples"][0]]


def device_frames(cfg: dict, device, max_batches: int | None = None) -> list:
    """The test split of ``cfg`` as (numpy batch, model inputs on
    ``device``) pairs, one frame each (:func:`frame_inputs`): assembled
    and copied once, for :func:`run_inference`'s ``frames`` (several
    models on one set of frames)."""
    dataset = build_dataset(cfg, train=False)
    keys, late = batch_keys(cfg), assembler_class(cfg).late
    out = []
    for batch in dataset.batches(1, shuffle=False):
        out.append((batch, frame_inputs(batch, keys, torch.device(device),
                                        late)))
        if max_batches and len(out) >= max_batches:
            break
    return out


def ego_points(batch: dict):
    """The ego's valid points (P, 4) of a host batch, or None where the
    batch carries no ``points`` (JAX inference.py's ``--save_vis``)."""
    pts = batch.get("points")
    if pts is None:
        return None
    if pts.ndim == 4:  # (B, agents, N, 4)
        return pts[0, 0][batch["point_mask"][0, 0]]
    return pts[0][batch["point_mask"][0]]


def run_inference(
    model_dir: str | None = None,
    cfg: dict | None = None,
    *,
    device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
    checkpoint: str | None = None,
    seed: int = 0,
    model: torch.nn.Module | None = None,
    max_batches: int | None = None,
    collect_heads: bool = False,
    note: str = "",
    noise_setting: dict | None = None,
    cfg_override: dict | None = None,
    override_range=None,
    frames: list | None = None,
    save_vis: bool = False,
    vis_interval: int = 40,
) -> dict:
    """Serve the test split of ``cfg`` (or ``model_dir``'s config.yaml)
    and return the AP dict of utils/eval_np.py (written to
    ``model_dir``/eval_<note>.yaml when there is a model_dir), plus:

      * ``frames``: frames served;
      * ``serve_s``: per-frame seconds from the host batch to the host
        detections (transfer, forward, decode, NMS), synchronised;
      * ``data_s``: per-frame seconds the host spent assembling the batch;
      * ``depth_rmse_mX``: each camera type's depth RMSE in metres over
        the pixels with a lidar return (JAX's ``depth_metric``);
      * ``heads`` (``collect_heads``): f32 CPU copies of the cls/reg/dir
        head outputs of every forward (one a frame; late fusion one per
        agent sample, the ego's first);
      * ``comm_rate``: Where2comm's mean fraction of cells sent.

    ``model`` (already on ``device`` in ``dtype``) skips the weight setup.
    ``frames`` (from :func:`device_frames`, on ``device``) are served
    instead of assembling the test split; ``data_s`` is then 0.
    ``save_vis`` writes frame n's BEV picture to
    ``model_dir``/vis/bev_{n:05d}.png for every n divisible by
    ``vis_interval`` (needs a ``model_dir``).
    """
    if save_vis and model_dir is None:
        raise ValueError("save_vis writes into model_dir/vis: give a "
                         "model_dir")
    if cfg is None:
        cfg = load_yaml("", model_dir=model_dir)
    cfg = apply_overrides(cfg, noise_setting=noise_setting,
                          cfg_override=cfg_override,
                          override_range=override_range)
    late, keys = assembler_class(cfg).late, batch_keys(cfg)
    device = torch.device(device)
    dataset = build_dataset(cfg, train=False)
    if model is None and checkpoint is None and model_dir is not None:
        checkpoint = ckpt_lib.find_checkpoint(model_dir)[1]
        if checkpoint:
            print(f"[inference] loading {checkpoint}")
    if model is None:
        model = build_weights(cfg, checkpoint, seed)
        model = model.to(device=device, dtype=dtype)
        model = channels_last(model)

    post = cfg["postprocess"]
    anchors = torch.from_numpy(np.asarray(dataset.anchors, np.float32)).to(
        device)
    gt_range = torch.tensor(post["gt_range"], dtype=torch.float32,
                            device=device)
    stat = eval_np.new_result_stat((0.3, 0.5, 0.7))
    serve_s, data_s, heads, comm_rates = [], [], [], []
    # camera depth RMSE: each camera type's grid maps bins back to metres
    depth_grids = {
        m: s["grid_conf"] for m, s in
        (cfg.get("heter") or {}).get("modality_setting", {}).items()
        if s.get("sensor_type") == "camera" and "grid_conf" in s}
    depth_sse = {m: [0.0, 0] for m in depth_grids}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def decode(out, t_matrix):
        return post_process_single(
            out["cls_preds"][0].float(),
            out["reg_preds"][0].float(),
            out["dir_preds"][0].float() if "dir_preds" in out else None,
            anchors,
            torch.from_numpy(np.asarray(t_matrix, np.float32)).to(device),
            gt_range,
            order=post["order"],
            score_threshold=post["target_args"]["score_threshold"],
            nms_threshold=post["nms_thresh"],
            # anchor-free models (CenterPoint) mark their outputs: the
            # model says so, not its name
            anchor_free=bool(out.get("anchor_free", False)),
        )

    if frames is None:
        frames = ((b, None) for b in dataset.batches(1, shuffle=False))
    t_data = time.perf_counter()
    with torch.inference_mode():
        for batch, inputs in frames:
            data_s.append(0.0 if inputs is not None
                          else time.perf_counter() - t_data)
            sync()
            t0 = time.perf_counter()
            if inputs is None:
                inputs = frame_inputs(batch, keys, device, late)
            if late:
                # one forward per agent sample, decoded in the ego frame
                outs = [model(x) for x in inputs]
                dets = [decode(o, t) for o, t in zip(outs, [
                    batch["transformation_matrix"][0]] + [
                    s["transformation_matrix"]
                    for s in batch["agent_samples"][0]])]
                det = fuse_and_nms([d["corners"] for d in dets],
                                   [d["scores"] for d in dets],
                                   [d["valid"] for d in dets],
                                   nms_threshold=post["nms_thresh"])
            else:
                outs = [model(inputs)]
                o = outs[0]
                if "rcnn_cls" in o:  # two-stage: the refined detections
                    det = decode_stage2(
                        o["boxes_fused"][0].float(), o["valid_fused"][0],
                        o["rcnn_cls"][0].float(), o["rcnn_reg"][0].float(),
                        gt_range,
                        score_threshold=post["target_args"][
                            "score_threshold"],
                        nms_threshold=post["nms_thresh"])
                else:
                    det = decode(o, batch["transformation_matrix"][0])
            dense = strip_padding(det)  # copies to the host: synchronises
            serve_s.append(time.perf_counter() - t0)
            if collect_heads:
                heads += [{k: o[k].float().cpu() for k in
                           ("cls_preds", "reg_preds", "dir_preds") if k in o}
                          for o in outs]
            # late fusion reports neither, as in JAX
            out = {} if late else outs[0]
            if "comm_rate" in out:  # where2comm's bandwidth
                comm_rates.append(float(out["comm_rate"]))
            for m, gc in depth_grids.items():
                if f"depth_items_{m}" in out:
                    sse, n = camera.depth_metric(
                        out[f"depth_items_{m}"].float().cpu().numpy(),
                        batch[f"inputs_{m}"]["depth_bins"], gc["ddiscr"],
                        gc["mode"])
                    depth_sse[m][0] += sse
                    depth_sse[m][1] += n
            gt_mask = batch["gt_mask"][0] > 0
            gt_corners = box_np.boxes_to_corners_3d(
                batch["gt_boxes"][0][gt_mask], post["order"]
            )
            for t in (0.3, 0.5, 0.7):
                eval_np.calculate_tp_fp(
                    dense["corners"], dense["scores"], gt_corners, stat, t
                )
            n = len(serve_s) - 1
            if save_vis and n % vis_interval == 0:
                from ..visualization import visualize

                visualize(dense["corners"], gt_corners, ego_points(batch),
                          post["gt_range"], os.path.join(
                              model_dir, "vis", f"bev_{n:05d}.png"))
            if max_batches and len(serve_s) >= max_batches:
                break
            t_data = time.perf_counter()

    result = eval_np.eval_final_results(
        stat, save_path=model_dir, infer_info=note or "intermediate"
    )
    if comm_rates:
        result["comm_rate"] = float(np.mean(comm_rates))
        print(f"[inference] comm_rate {result['comm_rate']:.4f}")
    for m, (sse, n) in sorted(depth_sse.items()):
        if n:
            result[f"depth_rmse_{m}"] = float(np.sqrt(sse / n))
            print(f"[inference] depth_rmse_{m} "
                  f"{result[f'depth_rmse_{m}']:.4f} m over {n} px")
    result["frames"] = len(serve_s)
    result["serve_s"] = serve_s
    result["data_s"] = data_s
    if collect_heads:
        result["heads"] = heads
    return result


def main(argv=None):
    p = argparse.ArgumentParser("heal_tpu_torch inference")
    p.add_argument("--config", default=None,
                   help="config yaml (default: <model_dir>/config.yaml)")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="torch state_dict; a seeded random init without one")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="f32")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--range", default=None, help="e.g. 102.4,102.4")
    p.add_argument("--note", default="")
    p.add_argument("--save_vis", action="store_true",
                   help="write BEV pictures to <model_dir>/vis")
    p.add_argument("--vis_interval", type=int, default=40)
    args = p.parse_args(argv)
    if args.config is None and args.model_dir is None:
        p.error("give --config or --model_dir")
    cfg = None
    if args.config is not None:
        cfg = load_yaml(args.config)
    result = run_inference(
        args.model_dir, cfg, device=args.device, dtype=_DTYPES[args.dtype],
        checkpoint=args.checkpoint, seed=args.seed,
        max_batches=args.max_batches, note=args.note,
        save_vis=args.save_vis, vis_interval=args.vis_interval,
        override_range=([float(x) for x in args.range.split(",")]
                        if args.range else None),
    )
    frames = result["frames"]
    steady = result["serve_s"][1:] or result["serve_s"]
    print(f"[inference] {frames} frames; serve {np.mean(steady) * 1e3:.2f} "
          f"ms/frame after the first; host data "
          f"{np.mean(result['data_s']) * 1e3:.2f} ms/frame")
    return result


if __name__ == "__main__":
    main()
