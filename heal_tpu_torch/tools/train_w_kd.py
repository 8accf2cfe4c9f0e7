"""DiscoNet's knowledge-distillation trainer (torch).

Counterpart of heal_tpu/tools/train_w_kd.py: a frozen teacher, trained on
the early-fused view (every agent's points in the ego frame, merged),
supervises the intermediate-fusion student through
``point_pillar_disconet_loss``'s feature-imitation term:

    python -m heal_tpu_torch.tools.train_w_kd -y student.yaml \\
        --teacher_dir runs/teacher [--model_dir runs/student] \\
        [--epochs N] [--device cuda]

The student's config sets ``kd_flag: true``, so each sample carries
``teacher_points`` / ``teacher_point_mask`` (data/scene.py). The teacher
is built from ``--teacher_dir``'s config.yaml and loaded strictly from
its newest checkpoint (tools/checkpoint.find_checkpoint: bestval first,
a port ``.pth`` or a heal_tpu ``.ckpt``); it runs in eval mode under
``torch.no_grad``, so its weights and running statistics never move and
its PointPillars encoder takes kernel 1, once a step. Its
``spatial_features_2d``, detached, joins the student's outputs as
``teacher_feature`` before the loss. As JAX's, the loop takes every
epoch's shuffled batches (``seed=epoch``), prints the mean loss and
saves a checkpoint after each epoch; it runs no validation and no final
inference.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..data import build_dataset
from ..parallel import Trainer
from . import checkpoint as ckpt_lib
from .inference import build_weights
from .train import build_trainer, device_batches, load_config, setup_run_dir


@dataclasses.dataclass
class KDTrainer(Trainer):
    """``Trainer`` whose outputs carry the frozen teacher's feature."""

    teacher: torch.nn.Module | None = None

    @torch.no_grad()
    def teacher_feature(self, batch: dict) -> torch.Tensor:
        """The teacher's map of the batch's early-fused view."""
        self.teacher.eval()
        out = self.teacher({"points": batch["teacher_points"],
                            "point_mask": batch["teacher_point_mask"]})
        return out["spatial_features_2d"].float()

    def outputs(self, batch: dict) -> dict:
        out = super().outputs(batch)
        if self.teacher is not None:
            out["teacher_feature"] = self.teacher_feature(batch)
        return out


def load_teacher(teacher_dir: str, device) -> torch.nn.Module:
    """The teacher of ``teacher_dir`` (its config.yaml and newest
    checkpoint), loaded strictly, on ``device``, frozen, in eval mode."""
    cfg = load_config("", model_dir=teacher_dir)
    _, path = ckpt_lib.find_checkpoint(teacher_dir)
    if not path:
        raise FileNotFoundError(f"no checkpoint in {teacher_dir}")
    teacher = build_weights(cfg, checkpoint=path).to(device).eval()
    teacher.requires_grad_(False)
    print(f"[kd] teacher {cfg['model']['core_method']} from {path}")
    return teacher


def main(argv=None) -> str:
    p = argparse.ArgumentParser("heal_tpu_torch train_w_kd")
    p.add_argument("--hypes_yaml", "-y", required=True)
    p.add_argument("--teacher_dir", required=True)
    p.add_argument("--model_dir", default="")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = load_config(args.hypes_yaml)
    model_dir = setup_run_dir(cfg, args.model_dir)
    device = torch.device(args.device)
    teacher = load_teacher(args.teacher_dir, device)

    train_ds = build_dataset(cfg, train=True)
    batch_size = cfg["train_params"]["batch_size"]
    epochs = args.epochs or cfg["train_params"]["epoches"]
    steps = max(len(train_ds) // batch_size, 1)
    trainer = build_trainer(cfg, device, steps, trainer_cls=KDTrainer,
                            teacher=teacher)
    for epoch in range(epochs):
        losses = [trainer.train_step(batch)["total_loss"]
                  for batch, _ in device_batches(cfg, batch_size, device,
                                                 shuffle=True, seed=epoch,
                                                 dataset=train_ds)]
        print(f"[kd epoch {epoch}] loss "
              f"{float(torch.stack(losses).mean()):.4f}")
        ckpt_lib.save_checkpoint(model_dir, trainer.model, epoch + 1)
    return model_dir


if __name__ == "__main__":
    main()
