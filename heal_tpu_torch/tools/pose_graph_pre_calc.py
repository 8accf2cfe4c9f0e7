"""Pre-compute per-frame single-view detections for CoAlign box alignment.

Counterpart of heal_tpu/tools/pose_graph_pre_calc.py: run a stage-1
detector over the test split and dump, per frame, per scene agent, its
detected box centers and scores (and with the uncertainty detector,
``point_pillar_uncertainty``, each box's log-var x / y and log-kappa yaw)
to JSON. The ``box_align.precalc_path`` hook of data/builder.py reads the
dump to refine noisy poses before fusion.

The dump holds one entry per scene agent, unfiltered and in scene order:
the hook zips the entries against ``scene["agents"]`` by position, so a
comm-range filter or a max_cav cap here would shift detections onto the
wrong agents. Each agent is detected in its own frame:

  * ``heter*`` models: the agent becomes a one-agent scene (its own ego,
    of the dataset's first modality) run through the dataset's assembler;
  * plain detectors: fusion is set to ``late`` and the agent's points in
    range are padded to ``max_points``, presorted by the assembler's
    ``_presort`` (the sorted-scatter contract of presorted encoders).

    python -m heal_tpu_torch.tools.pose_graph_pre_calc --model_dir runs/stage1 \\
        [--out stage1_boxes.json] [--max_frames N] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..config import load_yaml
from ..data import build_dataset
from ..data.scene import collate
from ..models.layers import channels_last
from ..postprocess.decode import post_process_single, strip_padding
from . import checkpoint as ckpt_lib
from .inference import batch_keys, build_weights, frame_inputs


def agent_points(assembler, agent: dict, max_points: int):
    """An agent's points inside the lidar range, at most ``max_points``,
    presorted, padded: -> (points (max_points, 4), mask (max_points,))."""
    rng = assembler.params["preprocess"]["cav_lidar_range"]
    p = np.asarray(agent["points"], np.float32)
    m = ((p[:, 0] >= rng[0]) & (p[:, 0] <= rng[3])
         & (p[:, 1] >= rng[1]) & (p[:, 1] <= rng[4])
         & (p[:, 2] >= rng[2]) & (p[:, 2] <= rng[5]))
    p = p[m][:max_points]
    pts = np.zeros((max_points, 4), np.float32)
    msk = np.zeros(max_points, bool)
    pts[:len(p)] = assembler._presort(p[:, :4])
    msk[:len(p)] = True
    return pts, msk


def pre_calc(model_dir: str, out: str | None = None,
             max_frames: int | None = None, device="cuda") -> dict:
    """Detect every agent of the first ``max_frames`` test scenes with
    ``model_dir``'s checkpoint; write the dump (default
    ``<model_dir>/stage1_boxes.json``) and return it:
    {str(frame): [{centers, scores(, uncertainty)} per scene agent]}."""
    cfg = load_yaml("", model_dir=model_dir)
    heter = cfg["model"]["core_method"].startswith("heter")
    if not heter:
        cfg["fusion"]["core_method"] = "late"  # single-agent forwards
    dataset = build_dataset(cfg, train=False)
    path = ckpt_lib.find_checkpoint(model_dir)[1]
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {model_dir}")
    device = torch.device(device)
    model = build_weights(cfg, path).to(device)
    if device.type == "cuda":
        model = channels_last(model)

    post = cfg["postprocess"]
    anchors = torch.from_numpy(np.asarray(dataset.anchors, np.float32)).to(
        device)
    gt_range = torch.tensor(post["gt_range"], dtype=torch.float32,
                            device=device)
    eye = torch.eye(4, device=device)
    keys = batch_keys(cfg)
    max_points = cfg["preprocess"]["args"].get("max_points", 30000)
    # the stage-1 detector is single-modality: every agent's raw points
    # go through it whatever its type in the alliance
    base_modality = dataset.modalities[0]

    def inputs(agent, objects):
        if heter:
            one = {"agents": [dict(agent, modality=base_modality)],
                   "objects": objects}
            return frame_inputs(collate([dataset.assembler.assemble(one)]),
                                keys, device, late=False)
        pts, msk = agent_points(dataset.assembler, agent, max_points)
        return {"points": torch.from_numpy(pts)[None].to(device),
                "point_mask": torch.from_numpy(msk)[None].to(device)}

    results = {}
    with torch.inference_mode():
        for idx in range(len(dataset.backend)):
            if max_frames and idx >= max_frames:
                break
            scene = dataset.backend.scene(idx)
            per_agent = []
            for agent in scene["agents"]:
                o = model(inputs(agent, scene["objects"]))
                det = post_process_single(
                    o["cls_preds"][0].float(), o["reg_preds"][0].float(),
                    o["dir_preds"][0].float() if "dir_preds" in o else None,
                    anchors, eye, gt_range, order=post["order"],
                    score_threshold=post["target_args"]["score_threshold"],
                    nms_threshold=post["nms_thresh"],
                    unc_preds=o["unc_preds"][0].float()
                    if "unc_preds" in o else None)
                dense = strip_padding(det)
                entry = {"centers": dense["boxes"][:, :2].tolist(),
                         "scores": dense["scores"].tolist()}
                if "uncertainty" in dense:
                    entry["uncertainty"] = dense["uncertainty"].tolist()
                per_agent.append(entry)
            results[str(idx)] = per_agent
    out = out or os.path.join(model_dir, "stage1_boxes.json")
    with open(out, "w") as f:
        json.dump(results, f)
    print(f"[pose_graph_pre_calc] wrote {out} ({len(results)} frames)")
    return results


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("heal_tpu_torch pose_graph_pre_calc")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return pre_calc(args.model_dir, args.out, args.max_frames, args.device)


if __name__ == "__main__":
    main()
