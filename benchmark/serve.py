"""Serve mode: one client in a closed loop over the traffic's distinct
frames, each frame assembled by the program's host side in set-up.

Per frame, timed by the host clock from the dispatch of its inputs to
its detections on the host: the inputs to the device
(``tools/inference.frame_inputs``), the model's forward, the decode and
NMS (``postprocess/decode.post_process_single``) and the copy of the
kept boxes to the host (``strip_padding``), as ``tools/inference.py``
serves a test split. The next frame leaves when the previous one's
detections are back, as an ego vehicle's perception loop runs: the
system is offered as many frames as it completes, its knee.

After the window every served frame's detections, and the heads of the
last serving of each distinct frame, are held to the plain reference
(``check.py``).
"""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from . import check, harness, trace
from .traffic import scenes as gen
from . import weights as wlib


class Program:
    """The port's serving path for one configuration on one device."""

    def __init__(self, hypes: dict, ref_shapes: dict, seed: int, device):
        from heal_tpu_torch.config import reparse
        from heal_tpu_torch.data import assembler_class
        from heal_tpu_torch.models import build_model
        from heal_tpu_torch.models.layers import channels_last
        from heal_tpu_torch.postprocess.anchors import generate_anchor_box
        from heal_tpu_torch.tools.inference import batch_keys

        self.hypes = reparse(copy.deepcopy(hypes))
        self.device = torch.device(device)
        self.assembler = assembler_class(self.hypes)(self.hypes, train=False)
        self.keys = batch_keys(self.hypes)
        model = build_model(self.hypes["model"],
                            max_cav=self.hypes["train_params"]["max_cav"])
        model = model.to(self.device)
        model.load_state_dict(wlib.make(ref_shapes, seed, self.device),
                              strict=True)
        if self.device.type == "cuda":
            model = channels_last(model)
        self.model = model.eval()
        post = self.hypes["postprocess"]
        self.post = post
        self.anchors = torch.from_numpy(np.asarray(generate_anchor_box(
            post["anchor_args"], post["order"]), np.float32)).to(self.device)
        self.gt_range = torch.tensor(post["gt_range"], dtype=torch.float32,
                                     device=self.device)

    def assemble(self, scene: dict) -> dict:
        from heal_tpu_torch.data.scene import collate

        return collate([self.assembler.assemble(scene)])

    def serve(self, batch: dict, spans=None):
        """-> (head outputs on the device, kept detections on the host)."""
        from heal_tpu_torch.postprocess.decode import (post_process_single,
                                                       strip_padding)
        from heal_tpu_torch.tools.inference import frame_inputs

        rf = torch.profiler.record_function
        with torch.inference_mode():
            with rf("transfer"):
                inputs = frame_inputs(batch, self.keys, self.device, False)
            with rf("forward"):
                out = self.model(inputs)
            if spans is not None:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with rf("decode_nms"):
                det = post_process_single(
                    out["cls_preds"][0].float(), out["reg_preds"][0].float(),
                    out["dir_preds"][0].float(), self.anchors,
                    torch.from_numpy(np.asarray(
                        batch["transformation_matrix"][0], np.float32)).to(
                        self.device),
                    self.gt_range, order=self.post["order"],
                    score_threshold=self.post["target_args"][
                        "score_threshold"],
                    nms_threshold=self.post["nms_thresh"])
                dense = strip_padding(det)
            if spans is not None:
                spans.host.setdefault("decode_nms", []).append(
                    time.perf_counter() - t0)
        heads = {k: out[k] for k in ("cls_preds", "reg_preds", "dir_preds")}
        return heads, {"corners": dense["corners"], "scores": dense["scores"]}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(c: dict, args, device, t_start: float, ref,
        program_cls=Program) -> dict:
    """One run of the cell ``c`` (harness.cell) on ``device``;
    ``program_cls`` stands in for the program in the tests' controls."""
    hypes = c["config_file"]["hypes"]
    traffic = c["traffic_file"]
    ref_shapes = wlib.shapes_of(ref.build(hypes))
    program = program_cls(hypes, ref_shapes, args.seed, device)
    frames = gen.scenes(hypes, traffic, args.seed, traffic["frames"])
    batches = [program.assemble(s) for s in frames]
    for _ in range(traffic["warmup_passes"]):
        for b in batches:
            program.serve(b)
    sync(device)
    setup_s = time.perf_counter() - t_start

    spans = None
    if args.trace:
        spans = trace.Spans()
        for m in c["per_layer"]:
            for name, glob, attr in getattr(
                    harness.module("metrics", m["name"]), "SPANS", ()):
                if attr == "__call__":
                    spans.on_modules(name, program.model, glob)
                else:
                    obj = program.model.get_submodule(glob)
                    spans.on_method(name, obj, attr)

    latency, served, heads = [], [], {}
    n = len(batches)
    t0 = time.perf_counter()
    deadline = t0 + args.seconds
    while True:
        k = len(latency) % n
        t = time.perf_counter()
        h, dets = program.serve(batches[k], spans)
        latency.append(time.perf_counter() - t)
        if spans is not None:
            spans.frame()
        served.append((k, dets))
        heads[k] = h
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0

    ctx = {"frames": len(latency), "window_s": window_s}
    if args.trace:
        ctx.update(traced(program, batches, spans, traffic))
    peak = (int(torch.cuda.max_memory_allocated(device))
            if torch.device(device).type == "cuda" else 0)
    del program, batches
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.serve(ref, hypes, frames, heads, served, args.seed,
                          device)
    if args.trace:
        ctx.update(flops_per_frame(ref, hypes, frames[0], args.seed, device))
    return {"end_to_end": end_to_end(latency, window_s, setup_s),
            "ctx": ctx, "numbers": numbers, "attempted": len(latency),
            "memory_peak_bytes": peak}


def end_to_end(latency: list, window_s: float, setup_s: float) -> dict:
    """Frames over the whole window, and the 95th percentile of every
    frame's latency."""
    return {"setup_s": setup_s,
            "serve_frames_per_s": len(latency) / window_s,
            "serve_p95_ms": float(np.percentile(latency, 95)) * 1e3}


def traced(program, batches, spans, traffic) -> dict:
    """Stage means from the window's spans, then a profiled stretch of
    ``traced_frames`` frames with kernel 2's calls recorded
    (``trace.stretch``)."""
    import heal_tpu_torch.ops.shift_rows as sr

    stages = spans.mean_ms()
    spans.remove()
    calls = {"rows": trace.Calls(sr, "shift_rows"),
             "cols": trace.Calls(sr, "shift_cols")}
    count = traffic["traced_frames"]
    order = [i % len(batches) for i in range(count)]
    red = trace.stretch(lambda i: program.serve(batches[order[i]]), count,
                        min(count, 4), calls.values())
    return {"stages_ms": stages, "trace": red,
            "shift_calls": {k: v.calls for k, v in calls.items()},
            "traced_batches": [batches[i] for i in order],
            "hypes": program.hypes}


def flops_per_frame(ref, hypes, scene, seed, device) -> dict:
    from .reference import assemble
    from .work import flops

    model = ref.build(hypes).to(device).eval()
    model.load_state_dict(wlib.make(wlib.shapes_of(model), seed, device))
    batch = ref.to_device(assemble.collate([assemble.assemble(
        hypes, scene, train=False)]), device)
    with torch.no_grad():
        total = flops.count(lambda: model(batch))
    return {"flops_per_item": total}
