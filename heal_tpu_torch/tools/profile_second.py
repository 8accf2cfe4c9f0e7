"""Where the SECOND encoder's device time goes, on one GPU.

    python -m heal_tpu_torch.tools.profile_second [--agents 5] \\
        [--dtype f32|bf16] [--train] [--top 15]

The published m3 encoder (heal_tpu/configs/opv2v/heal/stage2/
m3_alignto_m1.yaml: a (40, 1024, 2048) voxel grid, channels 16/32/64/64,
column capacities 24000/16000/12000/8000) with seeded weights, on the
first ``--agents`` agents of that config's test split, served by the
synthetic backend with the flagship's scene arguments (4 agents, 14
vehicles, up to 30000 points an agent). Prints the device time of the
forward (eval, no gradient), or with ``--train`` of the forward and
backward of the encoder's output summed, as CUDA events around 5 calls
after 2 warm ones, then the ``torch.profiler`` table of the device
kernels by total time over one call. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os

import torch

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
CFG = os.path.join(REPO, "heal_tpu", "configs", "opv2v", "heal", "stage2",
                   "m3_alignto_m1.yaml")
FLAGSHIP = os.path.join(REPO, "heal_tpu", "configs", "opv2v_m1_pyramid.yaml")


def encoder_and_inputs(agents: int, dtype, device):
    """The m3 encoder (seeded, on ``device`` in ``dtype``) and the points
    and masks of ``agents`` agents of the config's test split."""
    from .inference import build_weights
    from .train import device_batches, load_config

    cfg = load_config(CFG)
    cfg["fusion"]["dataset"] = "synthetic"
    cfg["fusion"]["args"] = dict(load_config(FLAGSHIP)["fusion"]["args"],
                                 num_scenes_test=agents)
    enc = build_weights(cfg, seed=0).branch_m3.encoder.to(device, dtype)
    batch, _ = next(device_batches(cfg, agents, device, train=False))
    return (enc, batch["inputs_m3"]["points"].flatten(0, 1),
            batch["inputs_m3"]["point_mask"].flatten(0, 1))


def main(argv=None):
    p = argparse.ArgumentParser("heal_tpu_torch profile_second")
    p.add_argument("--agents", type=int, default=5)
    p.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    p.add_argument("--train", action="store_true",
                   help="forward and backward, in train mode")
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_second needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    enc, pts, mask = encoder_and_inputs(args.agents, dtype, "cuda")

    def call():
        if args.train:
            enc.train()
            enc(pts, mask).float().sum().backward()
        else:
            with torch.no_grad():
                enc.eval()(pts, mask)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        call()
    end.record()
    torch.cuda.synchronize()
    what = "forward + backward" if args.train else "forward"
    print(f"[profile_second] {torch.cuda.get_device_name(0)}: the m3 encoder"
          f" {what}, {args.dtype}, {pts.shape[0]} agents "
          f"({int(mask.sum())} points): {start.elapsed_time(end) / 5:.3f} ms "
          f"a call (CUDA events, mean of 5); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=args.top, max_name_column_width=70))


if __name__ == "__main__":
    main()
