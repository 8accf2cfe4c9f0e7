"""Profiler: params, FLOPs, inference and train throughput, memory.

Counterpart of heal_tpu/tools/profiler.py (the reference's
tools/profiler/{params_calc.py, traintp_calc.py}) for the port:

  * ``count_params``: the model's parameter count;
  * ``flop_count``: one eval forward under
    ``torch.utils.flop_counter.FlopCounterMode`` in place of XLA's
    ``cost_analysis``. The counter sees the ATen products (convolutions,
    matmuls); kernels 1, 2 and 3 are launches of their own that it
    cannot see, so they run outside it on every device (their plain
    versions too, on the CPU) and their operations are reported apart,
    from the counts their bounds use (kernels/cases.pillar_work for
    kernel 1, three a blended element for kernel 2, 2*27*Cin*Cout an
    output voxel for kernel 3). ``counter_flops`` is not XLA's
    ``flops``: XLA counts every elementwise op of the fused program;
    the counter counts only products;
  * ``profile_inference``: the frame already on the device, ``warmup``
    forwards, then ``iters`` timed with CUDA events (the host clock on
    the CPU) -> fps and ms a frame;
  * ``profile_training``: the port's ``Trainer.train_step`` on one batch
    -> samples/s and ms a step;
  * ``memory_stats``: ``torch.cuda.memory_allocated`` and
    ``max_memory_allocated``.

    python -m heal_tpu_torch.tools.profiler -y cfg.yaml [--train] \\
        [--iters 50] [--device cuda] [--dtype f32|bf16]

prints one JSON report.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import time

import torch

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@contextlib.contextmanager
def kernels_apart(ops: dict):
    """Run kernels 1, 2, 3 and 4 outside any dispatch mode (a
    FlopCounterMode then sees none of their work, on the card or in their
    plain versions on the CPU), adding each call's operations to ``ops``
    under ``pillar_tables`` / ``shift_rows`` / ``column_conv`` /
    ``window_attention`` (kernel 3: the conv's products at every output
    voxel, as its plain version multiplies; kernel 4: the q k^T and P V
    products, as its plain version's two batched products. Off the card
    V2X-ViT calls kernel 4's plain version itself, and the counter counts
    that)."""
    from torch.utils._python_dispatch import _disable_current_modes

    from ..kernels.cases import pillar_work
    from ..ops import column_conv, pillar, shift_rows, window_attention

    saved = (pillar.pillar_tables, shift_rows._shift,
             column_conv.column_conv_layer,
             column_conv.column_conv_layer_plain,
             window_attention.window_attention)

    def tables(*args, **kw):
        with _disable_current_modes():
            ops["pillar_tables"] += pillar_work(args)["flops"]
            return saved[0](*args, **kw)

    def shift(x, *args, **kw):
        with _disable_current_modes():
            ops["shift_rows"] += 3 * x.numel()
            return saved[1](x, *args, **kw)

    def conv(fn):
        # the layer takes kernel 3 on the card and its plain version
        # elsewhere; kernel 3's wrapper on a CPU tensor calls the plain
        # version, which counts then
        def call(cols, table, weights, *args, out_cols=None, **kw):
            with _disable_current_modes():
                if fn is saved[3] or cols["feats"].is_cuda:
                    b, _, _, cin = cols["feats"].shape
                    dst = cols if out_cols is None else out_cols
                    ops["column_conv"] += (
                        2 * 27 * cin * weights.shape[-1] * b
                        * dst["cvalid"].shape[1] * dst["grid"][0])
                return fn(cols, table, weights, *args, out_cols=out_cols,
                          **kw)
        return call

    def attention(qkv, table, window, heads, dh):
        with _disable_current_modes():
            n, h, w = qkv.shape[:3]
            ops["window_attention"] += (4 * n * h * w * window * window
                                        * heads * dh)
            return saved[4](qkv, table, window, heads, dh)

    (pillar.pillar_tables, shift_rows._shift, column_conv.column_conv_layer,
     column_conv.column_conv_layer_plain,
     window_attention.window_attention) = (
        tables, shift, conv(saved[2]), conv(saved[3]), attention)
    try:
        yield ops
    finally:
        (pillar.pillar_tables, shift_rows._shift,
         column_conv.column_conv_layer,
         column_conv.column_conv_layer_plain,
         window_attention.window_attention) = saved


def forward(model, inputs):
    """One forward of a frame: a dict of inputs, or for late fusion a
    list of them (one forward each)."""
    if isinstance(inputs, list):
        return [model(x) for x in inputs]
    return model(inputs)


def flop_count(model, inputs) -> dict:
    """The counter's FLOPs of one eval forward (``counter_flops``, and by
    ATen op), with kernels 1, 2, 3 and 4's operations apart
    (``kernel_ops``)."""
    from torch.utils.flop_counter import FlopCounterMode

    ops = {"pillar_tables": 0, "shift_rows": 0, "column_conv": 0,
           "window_attention": 0}
    with torch.inference_mode(), kernels_apart(ops), \
            FlopCounterMode(display=False) as counter:
        forward(model, inputs)
    by_op = {str(k): int(v) for k, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"counter_flops": int(counter.get_total_flops()),
            "by_op": by_op, "kernel_ops": ops}


class _Clock:
    """Elapsed ms between ``start`` and ``stop``: CUDA events on the card,
    the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return self.t0.elapsed_time(t1)
        return (time.perf_counter() - self.t0) * 1e3


def profile_inference(model, inputs, iters: int = 50, warmup: int = 5,
                      device="cuda") -> dict:
    clock = _Clock(device)
    with torch.inference_mode():
        for _ in range(warmup):
            forward(model, inputs)
        clock.start()
        for _ in range(iters):
            forward(model, inputs)
        ms = clock.stop()
    return {"fps": iters / ms * 1e3, "latency_ms": ms / iters}


def profile_training(trainer, batch, batch_size: int, iters: int = 20,
                     device="cuda") -> dict:
    clock = _Clock(device)
    trainer.train_step(batch)  # warm: allocator, autotuning
    clock.start()
    for _ in range(iters):
        trainer.train_step(batch)
    ms = clock.stop()
    return {"samples_per_sec": iters * batch_size / ms * 1e3,
            "step_ms": ms / iters}


def memory_stats(device="cuda") -> dict:
    if torch.device(device).type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("heal_tpu_torch profiler")
    p.add_argument("--hypes_yaml", "-y", required=True)
    p.add_argument("--train", action="store_true")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="f32")
    args = p.parse_args(argv)

    from ..data import assembler_class, build_dataset
    from ..models.layers import channels_last
    from .inference import batch_keys, build_weights, frame_inputs
    from .train import build_trainer, device_batches, load_config

    device = torch.device(args.device)
    dtype = _DTYPES[args.dtype]
    cfg = load_config(args.hypes_yaml)
    batch = next(build_dataset(cfg, train=False).batches(1, shuffle=False))
    inputs = frame_inputs(batch, batch_keys(cfg), device,
                          assembler_class(cfg).late)
    model = build_weights(cfg, seed=0).to(device=device, dtype=dtype).eval()
    if device.type == "cuda":
        model = channels_last(model)
        torch.cuda.reset_peak_memory_stats(device)

    report = {
        "params": count_params(model),
        "dtype": args.dtype,
        "flops": flop_count(model, inputs),
        "inference": profile_inference(model, inputs, args.iters,
                                       device=device),
    }
    del model
    if args.train:
        tcfg = copy.deepcopy(cfg)
        tcfg["train_params"]["bf16"] = args.dtype == "bf16"
        bs = tcfg["train_params"]["batch_size"]
        trainer = build_trainer(tcfg, device, 4)
        tb, _ = next(device_batches(tcfg, bs, device))
        report["training"] = profile_training(
            trainer, tb, bs, max(args.iters // 2, 1), device=device)
        report["training"]["batch_size"] = bs
        del trainer, tb
    report["memory"] = memory_stats(device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
