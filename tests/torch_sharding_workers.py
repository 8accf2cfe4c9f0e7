"""Rank functions for tests/test_torch_sharding.py.

The ranks are started with the ``spawn`` method, which imports the
function's module in every child: this module imports torch and the
port only, so a rank starts without jax.
"""
from __future__ import annotations

import numpy as np
import torch

from heal_tpu_torch.losses.center_point_loss import CenterPointLoss
from heal_tpu_torch.losses.pixor_loss import PixorLoss
from heal_tpu_torch.losses.point_pillar_loss import depth_focal_loss
from heal_tpu_torch.losses.voxel_net_loss import VoxelNetLoss
from heal_tpu_torch.models.layers import Dropout
from heal_tpu_torch.parallel import launch
from heal_tpu_torch.parallel.sharding import make_mesh

B = 2  # global batch
DROP_SHAPE = (B * 3, 5, 7)  # (B*L, ...), the batch outermost
DROP_SEED = 123


def loss_inputs() -> dict:
    """Seeded global predictions and labels of the batch-normalised
    losses: CenterPoint's heatmap and boxes (one sample without a
    positive), a camera's depth logits and bins (one sample's pixels all
    invalid), VoxelNet's anchors and PIXOR's label map."""
    rng = np.random.default_rng(7)
    heat = rng.uniform(0, 0.9, (B, 8, 8, 1))
    heat[0, 2, 3, 0] = heat[0, 5, 1, 0] = 1.0
    reg_mask = np.zeros((B, 8, 8), np.float64)
    reg_mask[0, 2, 3] = reg_mask[0, 5, 1] = 1.0
    bins = rng.integers(0, 6, (B * 2, 4, 4))
    bins[2:] = 6  # no lidar return
    pos = (rng.uniform(size=(B, 4, 4, 2)) < 0.2).astype(np.float64)
    label_map = np.concatenate([
        (rng.uniform(size=(B, 6, 6, 1)) < 0.3).astype(np.float64),
        rng.normal(size=(B, 6, 6, 6))], -1)
    f = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    return {
        "center": ({"cls_preds": f(rng.normal(size=(B, 8, 8, 1))),
                    "reg_preds": f(rng.normal(size=(B, 8, 8, 7)))},
                   {"heatmap": f(heat), "reg_mask": f(reg_mask),
                    "box_targets": f(rng.normal(size=(B, 8, 8, 7)))}),
        "depth": (f(rng.normal(size=(B * 2, 4, 4, 6))),
                  torch.tensor(bins)),
        "voxel": ({"cls_preds": f(rng.normal(size=(B, 4, 4, 2))),
                   "reg_preds": f(rng.normal(size=(B, 4, 4, 14)))},
                  {"pos_equal_one": f(pos),
                   "neg_equal_one": f(1.0 - pos),
                   "targets": f(rng.normal(size=(B, 4, 4, 14)))}),
        "pixor": ({"cls_preds": f(rng.normal(size=(B, 6, 6, 1))),
                   "reg_preds": f(rng.normal(size=(B, 6, 6, 6)))},
                  {"label_map": f(label_map)}),
    }


def loss_terms(inputs: dict, mesh=None) -> dict:
    """name -> (loss, the predictions it differentiates) on ``inputs``."""
    center, voxel, pixor = CenterPointLoss({}), VoxelNetLoss(
        {"alpha": 1.5, "beta": 1.0, "reg": 2.0}), PixorLoss(
        {"alpha": 1.0, "beta": 1.0})
    for loss in (center, voxel, pixor):
        loss.mesh = mesh
    out = {}
    for name, fn in (("center", center), ("voxel", voxel),
                     ("pixor", pixor)):
        preds, targets = inputs[name]
        preds = {k: v.clone().requires_grad_() for k, v in preds.items()}
        out[name] = (fn(preds, targets)[0], preds["cls_preds"])
    logits = inputs["depth"][0].clone().requires_grad_()
    out["depth"] = (depth_focal_loss(logits, inputs["depth"][1], mesh=mesh),
                    logits)
    return out


def _local(inputs: dict, mesh) -> dict:
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(conv(v) for v in x)
        return mesh.take(x, 0, "data")
    return conv(inputs)


def dropout_draw(mesh=None) -> torch.Tensor:
    """Train-mode Dropout(0.5) on ones of DROP_SHAPE (this rank's rows
    under a data axis) with the step stream seeded DROP_SEED."""
    drop = Dropout(0.5).train()
    drop.mesh = mesh
    drop.generator = torch.Generator().manual_seed(DROP_SEED)
    rows = DROP_SHAPE[0] // (1 if mesh is None else mesh.shape["data"])
    return drop(torch.ones((rows,) + DROP_SHAPE[1:]))


def rank_losses(rank: int, world: int, init: str, out_path: str) -> None:
    """A (2, 1, 1) mesh: each loss on this rank's samples, its value and
    the gradient of its predictions; the dropout rows. Rank 0 saves the
    world's (values averaged, gradient rows stacked)."""
    launch.init_rank(rank, world, "cpu", init, timeout_s=60)
    try:
        torch.set_num_threads(1)
        mesh = make_mesh(world, world, 1, 1)
        out = {}
        for name, (loss, preds) in loss_terms(
                _local(loss_inputs(), mesh), mesh).items():
            loss.backward()
            value = mesh.mean_scalars({"v": loss})["v"]
            rows = [torch.empty_like(preds.grad) for _ in range(world)]
            torch.distributed.all_gather(rows, preds.grad)
            out[name] = (float(value), torch.cat(rows) / world)
        rows = dropout_draw(mesh)
        parts = [torch.empty_like(rows) for _ in range(world)]
        torch.distributed.all_gather(parts, rows)
        out["dropout"] = torch.cat(parts)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        torch.distributed.destroy_process_group()
