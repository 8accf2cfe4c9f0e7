"""Trainer CLI for the port.

Counterpart of heal_tpu/tools/train.py on one device:

    python -m heal_tpu_torch.tools.train -y heal_tpu/configs/opv2v_m1_pyramid.yaml \\
        [--model_dir runs/x] [--epochs N] [--init_from net.pth] [--device cuda]

The run dir gets ``config.yaml``, ``train_log.jsonl`` and the checkpoints
of tools/checkpoint.py (every ``save_freq`` epochs, and the best
validation loss every ``eval_freq`` epochs). With ``--model_dir`` holding
a run, training resumes from its newest checkpoint: the weights and the
running statistics, and the learning-rate schedule at that epoch's step;
the Adam moments restart, as in JAX. ``train_params.bf16`` selects the
bf16 compute policy (parallel/trainer.py). The final inference on the
test split runs in-process unless ``--no_final_inference``.

The host data comes from the port's own numpy host side (config/,
data/, postprocess/anchors.py and targets.py); host->device copies are
pinned and asynchronous. :func:`load_config` and :func:`device_batches`
are the entry points to it (configs and batches) for other programs too.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import load_yaml, save_yaml
from ..data import build_dataset
from ..models import build_loss
from ..parallel import Trainer, build_optimizer, to_device
from . import checkpoint as ckpt_lib
from .inference import build_weights
from .logging import MetricLogger


def load_config(path: str = "", model_dir: str | None = None) -> dict:
    """The config at ``path`` (or ``model_dir``'s config.yaml), with the
    fields its ``yaml_parser`` derives (anchor grid sizes)."""
    return load_yaml(path, model_dir=model_dir)


def device_batches(cfg: dict, batch_size: int, device, *, train: bool = True,
                   shuffle: bool = False, seed: int = 0, dataset=None):
    """Batches of ``cfg``'s train (or test) split on ``device``: yields
    (batch, seconds the host spent assembling it). ``dataset``: one
    already built from ``cfg``."""
    if dataset is None:
        dataset = build_dataset(cfg, train=train)
    host = dataset.batches(batch_size, shuffle=shuffle, seed=seed)
    while True:
        t0 = time.perf_counter()
        batch = next(host, None)
        if batch is None:
            return
        host_s = time.perf_counter() - t0
        yield to_device(batch, device), host_s


def parse_args(argv=None):
    p = argparse.ArgumentParser("heal_tpu_torch train")
    p.add_argument("--hypes_yaml", "-y", default=None)
    p.add_argument("--model_dir", default="", help="resume / output dir")
    p.add_argument("--epochs", type=int, default=None, help="override epochs")
    p.add_argument("--init_from", default=None,
                   help="port checkpoint to load loosely before training")
    p.add_argument("--no_final_inference", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def setup_run_dir(cfg: dict, model_dir: str) -> str:
    if not model_dir:
        stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
        model_dir = os.path.join("heal_tpu_logs", f"{cfg['name']}_{stamp}")
    os.makedirs(model_dir, exist_ok=True)
    save_yaml(cfg, os.path.join(model_dir, "config.yaml"))
    return model_dir


def main(argv=None) -> str:
    args = parse_args(argv)
    if not (args.hypes_yaml or args.model_dir):
        raise SystemExit("need -y or --model_dir")
    cfg = load_config(args.hypes_yaml or "", model_dir=args.model_dir or None)
    model_dir = setup_run_dir(cfg, args.model_dir)
    device = torch.device(args.device)

    train_ds = build_dataset(cfg, train=True)
    val_ds = build_dataset(cfg, train=False)
    tp = cfg["train_params"]
    batch_size = tp["batch_size"]
    epochs = args.epochs or tp["epoches"]
    eval_freq = tp.get("eval_freq", 2)
    save_freq = tp.get("save_freq", 2)
    steps_per_epoch = max(len(train_ds) // batch_size, 1)

    model = build_weights(cfg, seed=0)
    if args.init_from:
        left = ckpt_lib.loose_load(model, args.init_from)
        print(f"[train] loaded {args.init_from}; {len(left)} keys left out")
    start_epoch, path = (ckpt_lib.find_checkpoint(model_dir)
                         if args.model_dir else (0, None))
    if path:
        model.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True))
        print(f"[train] resumed from {path} (epoch {start_epoch})")
    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    optimizer, schedule = build_optimizer(
        model.parameters(), cfg["optimizer"], cfg.get("lr_scheduler"),
        steps_per_epoch)
    trainer = Trainer(
        model=model, criterion=build_loss(cfg["loss"]), optimizer=optimizer,
        schedule=schedule,
        supervise_single=cfg["model"]["args"].get("supervise_single", False),
        single_weight=cfg["loss"]["args"].get("single_weight", 1.0),
        bf16=bool(tp.get("bf16", False)),
        step=start_epoch * steps_per_epoch,
    )

    logger = MetricLogger(model_dir)
    best_val = float("inf")
    for epoch in range(start_epoch, epochs):
        if hasattr(train_ds.backend, "reinitialize"):
            train_ds.backend.reinitialize(seed=epoch)
        losses, data_s = [], 0.0
        t0 = time.time()
        for batch, host_s in device_batches(cfg, batch_size, device,
                                            shuffle=True, seed=epoch,
                                            dataset=train_ds):
            data_s += host_s
            aux = trainer.train_step(batch)
            # device scalars; one sync at the epoch's end
            losses.append({k: v for k, v in aux.items() if v.dim() == 0})
        dt = time.time() - t0
        mean_aux = {k: float(torch.stack([x[k] for x in losses]).mean())
                    for k in losses[0]}
        rate = len(losses) * batch_size / dt
        logger.log(epoch, dict(mean_aux, samples_per_sec=rate,
                               host_data_s=data_s))
        print(f"[epoch {epoch}] loss {mean_aux['total_loss']:.4f} "
              f"({rate:.2f} samples/s; host data {data_s:.2f} s of "
              f"{dt:.2f} s)")

        if (epoch + 1) % save_freq == 0 or epoch == epochs - 1:
            ckpt_lib.save_checkpoint(model_dir, model, epoch + 1)
        if (epoch + 1) % eval_freq == 0 or epoch == epochs - 1:
            vlosses = [
                float(trainer.eval_step(b)["total_loss"])
                for b, _ in device_batches(cfg, batch_size, device,
                                           dataset=val_ds)
            ]
            vloss = float(np.mean(vlosses)) if vlosses else float("inf")
            print(f"[epoch {epoch}] val loss {vloss:.4f}")
            if vloss < best_val:
                best_val = vloss
                ckpt_lib.save_checkpoint(model_dir, model, epoch + 1,
                                         bestval=True)

    if not args.no_final_inference:
        from .inference import run_inference

        result = run_inference(model_dir, device=device)
        print(f"[train] final inference: ap_30 {result['ap_30']:.4f} "
              f"ap_50 {result['ap_50']:.4f} ap_70 {result['ap_70']:.4f}")
    return model_dir


if __name__ == "__main__":
    main()
