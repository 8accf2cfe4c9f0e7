"""Inference + AP evaluation for the port (intermediate fusion).

Counterpart of heal_tpu/tools/inference.py ``run_inference`` for the
intermediate-fusion path: dataset (the port's numpy host side) -> model
-> decode + rotated NMS -> AP@0.3/0.5/0.7 with the VOC matcher of
utils/eval_np.py.
Late fusion, two-stage models, depth metrics, comm rate and
visualisation are not ported yet.

    python -m heal_tpu_torch.tools.inference --config heal_tpu/configs/opv2v_m1_pyramid.yaml \
        [--checkpoint net.pt | --seed 0] [--dtype bf16] [--max_batches 8]

A checkpoint is a ``torch.save``d state_dict with the bridged key names
(utils/bridge.py, tools/checkpoint.py); with ``--model_dir`` and no
``--checkpoint`` the run's best-validation (else newest) checkpoint is
served; without any the weights are a seeded random init.
"""
from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch

from ..config import load_yaml
from ..data import build_dataset
from ..models import build_model
from ..models.layers import init_weights
from ..postprocess.decode import post_process_single, strip_padding
from ..utils import box_np, eval_np

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def build_weights(cfg: dict, checkpoint: str | None = None, seed: int = 0):
    """The eval-mode model of ``cfg``, from a checkpoint or a seeded init."""
    model = build_model(cfg["model"])
    if checkpoint is not None:
        sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model


def _model_inputs(batch: dict, modalities, device) -> dict:
    """The arrays the model reads, as tensors on ``device``. Points,
    affines and labels stay f32 whatever the model's dtype."""
    keys = ["agent_mask", "pairwise_affine"]
    keys += [f"slots_{m}" for m in modalities]
    out = {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in keys}
    for m in modalities:
        out[f"inputs_{m}"] = {
            k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch[f"inputs_{m}"].items()
        }
    return out


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
) -> dict:
    """Serve the test split of ``cfg`` (or ``model_dir``'s config.yaml)
    and return the AP dict of utils/eval_np.py, plus:

      * ``frames``: frames served;
      * ``serve_s``: per-frame seconds from the host batch to the host
        detections (transfer, forward, decode, NMS), synchronised;
      * ``data_s``: per-frame seconds the host spent assembling the batch;
      * ``heads`` (``collect_heads``): per-frame f32 CPU copies of the
        cls/reg/dir head outputs.

    ``model`` (already on ``device`` in ``dtype``) skips the weight setup.
    """
    if cfg is None:
        cfg = load_yaml("", model_dir=model_dir)
    cfg = copy.deepcopy(cfg)
    if cfg["fusion"]["core_method"] not in (
        "intermediate", "intermediateheter", "intermediateheterinfer"
    ):
        raise NotImplementedError(
            f"fusion {cfg['fusion']['core_method']!r} is not ported "
            "(intermediate fusion only)"
        )
    device = torch.device(device)
    dataset = build_dataset(cfg, train=False)
    if model is None and checkpoint is None and model_dir is not None:
        from .checkpoint import find_checkpoint

        checkpoint = find_checkpoint(model_dir, best=True)[1]
    if model is None:
        model = build_weights(cfg, checkpoint, seed)
        model = model.to(device=device, dtype=dtype)
        model = model.to(memory_format=torch.channels_last)

    post = cfg["postprocess"]
    anchors = torch.from_numpy(np.asarray(dataset.anchors, np.float32)).to(
        device)
    gt_range = torch.tensor(post["gt_range"], dtype=torch.float32,
                            device=device)
    stat = eval_np.new_result_stat((0.3, 0.5, 0.7))
    serve_s, data_s, heads = [], [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    batches = dataset.batches(1, shuffle=False)
    t_data = time.perf_counter()
    with torch.inference_mode():
        for batch in batches:
            data_s.append(time.perf_counter() - t_data)
            sync()
            t0 = time.perf_counter()
            out = model(_model_inputs(batch, dataset.modalities, device))
            det = post_process_single(
                out["cls_preds"][0].float(),
                out["reg_preds"][0].float(),
                out["dir_preds"][0].float() if "dir_preds" in out else None,
                anchors,
                torch.from_numpy(
                    np.asarray(batch["transformation_matrix"][0], np.float32)
                ).to(device),
                gt_range,
                order=post["order"],
                score_threshold=post["target_args"]["score_threshold"],
                nms_threshold=post["nms_thresh"],
            )
            dense = strip_padding(det)  # copies to the host: synchronises
            serve_s.append(time.perf_counter() - t0)
            if collect_heads:
                heads.append({k: out[k].float().cpu() for k in
                              ("cls_preds", "reg_preds", "dir_preds")
                              if k in out})
            gt_mask = batch["gt_mask"][0] > 0
            gt_corners = box_np.boxes_to_corners_3d(
                batch["gt_boxes"][0][gt_mask], post["order"]
            )
            for t in (0.3, 0.5, 0.7):
                eval_np.calculate_tp_fp(
                    dense["corners"], dense["scores"], gt_corners, stat, t
                )
            if max_batches and len(serve_s) >= max_batches:
                break
            t_data = time.perf_counter()

    result = eval_np.eval_final_results(
        stat, save_path=model_dir, infer_info="intermediate"
    )
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
    args = p.parse_args(argv)
    if args.config is None and args.model_dir is None:
        p.error("give --config or --model_dir")
    cfg = None
    if args.config is not None:
        cfg = load_yaml(args.config)
    result = run_inference(
        args.model_dir, cfg, device=args.device, dtype=_DTYPES[args.dtype],
        checkpoint=args.checkpoint, seed=args.seed,
        max_batches=args.max_batches,
    )
    frames = result["frames"]
    steady = result["serve_s"][1:] or result["serve_s"]
    print(f"[inference] {frames} frames; serve {np.mean(steady) * 1e3:.2f} "
          f"ms/frame after the first; host data "
          f"{np.mean(result['data_s']) * 1e3:.2f} ms/frame")
    return result


if __name__ == "__main__":
    main()
