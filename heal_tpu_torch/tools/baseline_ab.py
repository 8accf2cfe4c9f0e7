"""Baseline-provenance A/B: params and forward FLOPs of the flagship model,
the port vs the PyTorch reference, at the benchmark scale.

Counterpart of heal_tpu/tools/baseline_ab.py (reference protocol:
tools/profiler/params_calc.py:28-60, FLOPs and the parameter count on one
sample). The port's row: the flagship heal_tpu/configs/opv2v_m1_pyramid.yaml
(5 m1 agent slots, 204.8 m x 102.4 m at 0.4 m, a 512 x 256 BEV) with seeded
weights, its parameters and one frame's forward FLOPs from
tools/profiler.flop_count (the counter's products, kernels 1 and 2's
operations apart). The reference's row: opencood's HeterPyramidCollab
with the same model args, imported through the repository's test shim
(tests/ref_shim.py: stand-ins for the reference's missing third-party
imports) and counted with conv / linear forward hooks (2 x MACs) on
``--pillars`` full pillars an agent. Without the opencood tree the
reference's row is not made up: the port's row is printed and the tool
exits with an error that names the missing tree.

    python -m heal_tpu_torch.tools.baseline_ab [--pillars 15000] \\
        [--agents 5] [--device cuda] [--reference DIR]
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGSHIP = os.path.join(REPO, "heal_tpu", "configs", "opv2v_m1_pyramid.yaml")


def _shim():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import ref_shim

    return ref_shim


def reference_root(given: str | None = None) -> str:
    """The opencood tree: ``given``, else the one the test shim reads."""
    return given or _shim().REF_ROOT


def flagship_cfg() -> dict:
    from .train import load_config

    cfg = load_config(FLAGSHIP)
    cfg["fusion"]["args"]["num_scenes_test"] = 1
    return cfg


def ours_flops_params(device="cuda") -> tuple[int, dict]:
    """The flagship's parameter count and one frame's
    :func:`tools.profiler.flop_count` (its own 5 agent slots), eval, f32."""
    from ..data import build_dataset
    from ..models.layers import channels_last
    from .inference import batch_keys, build_weights, frame_inputs
    from .profiler import count_params, flop_count

    device = torch.device(device)
    cfg = flagship_cfg()
    batch = next(build_dataset(cfg, train=False).batches(1, shuffle=False))
    inputs = frame_inputs(batch, batch_keys(cfg), device, False)
    model = build_weights(cfg, seed=0).to(device).eval()
    if device.type == "cuda":
        model = channels_last(model)
    return count_params(model), flop_count(model, inputs)


def reference_flops_params(num_pillars: int, num_agents: int,
                           root: str) -> tuple[int, int]:
    """opencood's HeterPyramidCollab (m1) with the flagship's model args:
    parameters and conv / linear MACs x 2 on one frame of ``num_pillars``
    full pillars an agent (CPU)."""
    if not os.path.isdir(root):
        raise FileNotFoundError(f"the opencood reference tree {root} is "
                                "absent")
    shim = _shim()
    shim.REF_ROOT = root
    shim.load_reference()
    from opencood.models.heter_pyramid_collab import HeterPyramidCollab

    cfg = flagship_cfg()
    model = HeterPyramidCollab(cfg["model"]["args"]).eval()
    params = sum(p.numel() for p in model.parameters())
    macs = [0]

    def hook(mod, inp, out):
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            fan = (mod.in_channels // mod.groups * mod.kernel_size[0]
                   * mod.kernel_size[1])
            macs[0] += out.numel() * fan
        elif isinstance(mod, torch.nn.Linear):
            macs[0] += out.numel() * mod.in_features
        elif isinstance(mod, torch.nn.Conv1d):
            macs[0] += (out.numel() * mod.in_channels // mod.groups
                        * mod.kernel_size[0])

    for mod in model.modules():
        mod.register_forward_hook(hook)
    x0, y0, _, x1, y1, _ = cfg["preprocess"]["cav_lidar_range"]
    vx, vy = cfg["preprocess"]["args"]["voxel_size"][:2]
    ny, nx = int(round((y1 - y0) / vy)), int(round((x1 - x0) / vx))
    n = num_pillars * num_agents
    gen = torch.Generator().manual_seed(0)
    coords = torch.stack([
        torch.arange(n) % num_agents, torch.zeros(n, dtype=torch.long),
        torch.randint(0, ny, (n,), generator=gen),
        torch.randint(0, nx, (n,), generator=gen)], dim=1)
    data = {
        "inputs_m1": {
            "voxel_features": torch.randn(n, 32, 4, generator=gen),
            "voxel_coords": coords,
            "voxel_num_points": torch.full((n,), 32, dtype=torch.long),
        },
        "agent_modality_list": ["m1"] * num_agents,
        "record_len": torch.tensor([num_agents]),
        "pairwise_t_matrix": torch.eye(4)[None, None, None].repeat(
            1, num_agents, num_agents, 1, 1),
    }
    with torch.no_grad():
        model(data)
    return params, 2 * macs[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser("heal_tpu_torch baseline_ab")
    p.add_argument("--pillars", type=int, default=15000,
                   help="full pillars an agent fed to the reference (the "
                        "port voxelizes its own synthetic frame)")
    p.add_argument("--agents", type=int, default=5,
                   help="agents of the reference's frame")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reference", default=None,
                   help="the opencood tree (default: the test shim's)")
    a = p.parse_args(argv)

    ours_p, ours = ours_flops_params(a.device)
    k = ours["kernel_ops"]
    print(f"ours:      params {ours_p / 1e6:.2f} M  counter FLOPs "
          f"{ours['counter_flops'] / 1e9:.1f} G (FlopCounterMode, convs and "
          f"matmuls) + kernel 1 {k['pillar_tables'] / 1e9:.4f} G, kernel 2 "
          f"{k['shift_rows'] / 1e9:.4f} G operations")
    root = reference_root(a.reference)
    try:
        ref_p, ref_f = reference_flops_params(a.pillars, a.agents, root)
    except FileNotFoundError as e:
        print(f"baseline_ab: {e}; no reference row", file=sys.stderr)
        return 1
    print(f"reference: params {ref_p / 1e6:.2f} M  fwd FLOPs "
          f"{ref_f / 1e9:.1f} G (conv/linear hooks, {a.pillars} "
          "pillars/agent)")
    print()
    print("| side | params (M) | forward FLOPs (G/frame) | method |")
    print("|---|---|---|---|")
    print(f"| reference (torch CPU) | {ref_p / 1e6:.2f} | {ref_f / 1e9:.1f} | "
          f"conv/linear MAC hooks, {a.agents} agents x {a.pillars} pillars |")
    print(f"| heal_tpu_torch | {ours_p / 1e6:.2f} | "
          f"{ours['counter_flops'] / 1e9:.1f} | FlopCounterMode, kernels 1 "
          "and 2 apart |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
