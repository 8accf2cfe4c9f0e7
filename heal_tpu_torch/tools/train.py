"""Trainer CLI for the port.

Counterpart of heal_tpu/tools/train.py on one device:

    python -m heal_tpu_torch.tools.train -y heal_tpu/configs/opv2v_m1_pyramid.yaml \\
        [--model_dir runs/x] [--epochs N] [--init_from net.pth|net.ckpt] \\
        [--device cuda]

The run dir gets ``config.yaml``, ``train_log.jsonl`` and the checkpoints
of tools/checkpoint.py (every ``save_freq`` epochs, and the best
validation loss every ``eval_freq`` epochs). With ``--model_dir`` holding
a run, training resumes as JAX's does: from the checkpoint
``find_checkpoint`` picks (bestval while there is one) and at that file's
epoch, with its weights and running statistics only, so the Adam moments
AND the learning-rate schedule restart at update 0 (JAX replaces only
params and batch_stats, so ``TrainState.step`` starts over).
``train_params.bf16`` selects the bf16 compute policy
(parallel/trainer.py). The final inference on the test split runs
in-process unless ``--no_final_inference`` (late fusion: one forward per
agent sample and the cross-agent NMS, tools/inference.py). Late and
early fusion train on single samples; a late validation batch carries
its ``agent_samples``, which stay on the host. ``supervise_single`` is
taken from the model args for intermediate fusion only
(:func:`supervise_single`).

The input stream is JAX's (heal_tpu/tools/train.py:165-219): with
``train_params.cache_device_batches`` every train and validation batch is
assembled unshuffled and copied to the device ONCE, and each epoch takes
the cached batches in the order ``np.random.default_rng(epoch)
.permutation`` gives, with no backend reinitialisation; without it, the
backend is reinitialised with ``seed=epoch`` (where it can be), the
samples are shuffled with that seed, and a worker thread assembles and
pins the next ``PREFETCH_DEPTH`` batches (data/prefetch.py) while the
card runs the current step.

HEAL stage 2: ``--init_from`` (a port ``.pth`` or a heal_tpu ``.ckpt``)
is loaded loosely, the first 10 keys it leaves out are printed, and then
the model's ``fix_modules`` (``heter_pyramid_single``: the pyramid,
shrink and heads) are frozen (parallel/freezing.py): the optimizer holds
only the other parameters.

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
from ..data import assembler_class, build_dataset
from ..data.prefetch import prefetch
from ..models import build_loss
from ..models.layers import channels_last
from ..parallel import Trainer, build_optimizer, pin, to_device
from ..parallel.freezing import freeze, trainable_parameters
from ..postprocess.anchors import generate_anchor_box
from . import checkpoint as ckpt_lib
from .inference import build_weights
from .logging import MetricLogger

PREFETCH_DEPTH = 3  # batches the worker runs ahead (JAX train.py:218)


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
                   help="checkpoint (.pth or heal_tpu .ckpt) to load loosely "
                        "before training (HEAL stage 2: the stage-1 base)")
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


def epoch_batches(train_ds, batch_size: int, epoch: int, device,
                  cached: list | None = None):
    """The train batches of ``epoch`` on ``device``, in JAX's order:
    ``cached`` (the device cache of ``cache_device_batches``) permuted by
    ``default_rng(epoch)``; else the backend reinitialised and the samples
    shuffled with ``seed=epoch``, assembled and pinned in the prefetch
    worker, and copied here, on the consumer's stream."""
    if cached is not None:
        for i in np.random.default_rng(epoch).permutation(len(cached)):
            yield cached[i]
        return
    if hasattr(train_ds.backend, "reinitialize"):
        train_ds.backend.reinitialize(seed=epoch)
    host = train_ds.batches(batch_size, shuffle=True, seed=epoch)
    for batch in prefetch(host, lambda b: pin(b, device),
                          depth=PREFETCH_DEPTH):
        yield to_device(batch, device)


def cache_batches(dataset, batch_size: int, device) -> list:
    """Every batch of ``dataset``, unshuffled, on ``device``."""
    return [to_device(b, device)
            for b in dataset.batches(batch_size, shuffle=False)]


def _nbytes(batches: list) -> int:
    seen: dict = {}

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, torch.Tensor):
            seen[id(x)] = x.nbytes

    for b in batches:
        walk(b)
    return sum(seen.values())


def supervise_single(cfg: dict) -> bool:
    """Whether the step adds the ``_single`` loss: ``supervise_single``
    of the model args, taken only where the assembler emits the per-agent
    labels, the intermediate ones (HEAL reads the flag from its dataset;
    its late and early datasets define none). JAX passes the flag
    whatever the fusion, and its step on a late config that sets it, as
    every published ``single/m*_pretrain.yaml`` does, fails on the
    missing labels (ROADMAP §3)."""
    return (assembler_class(cfg).single_labels
            and bool(cfg["model"]["args"].get("supervise_single", False)))


def build_trainer(cfg: dict, device, steps_per_epoch: int, *,
                  init_from: str | None = None,
                  resume: str | None = None, trainer_cls: type = Trainer,
                  **fields) -> Trainer:
    """The ``Trainer`` of ``cfg`` on ``device``: the seeded init (seed 0),
    ``init_from`` loaded loosely (its left-out keys printed), ``resume``
    loaded strictly, then the model's ``fix_modules`` frozen and the
    optimizer built from the parameters left to train. Its update count
    starts at 0 whatever is loaded, as JAX's ``TrainState.step`` does.
    A loss with an IoU branch gets the anchor grid the assemblers label
    with (JAX's train.py passes ``train_ds.anchors``). ``trainer_cls``
    (a ``Trainer`` subclass) is built with the extra ``fields``."""
    model = build_weights(cfg, seed=0)
    if init_from:
        left = ckpt_lib.loose_load(model, init_from)
        print(f"[train] loaded {init_from}; {len(left)} keys left out")
    if resume:
        model.load_state_dict(ckpt_lib.load_state_dict(resume))
    device = torch.device(device)
    model = model.to(device)
    if device.type == "cuda":
        model = channels_last(model)

    fix_modules = tuple(getattr(model, "fix_modules", ()))
    if fix_modules:
        freeze(model, fix_modules)
        print(f"[train] frozen modules: {fix_modules}")
    optimizer, schedule = build_optimizer(
        trainable_parameters(model), cfg["optimizer"],
        cfg.get("lr_scheduler"), steps_per_epoch)
    criterion = build_loss(cfg["loss"])
    if hasattr(criterion, "set_anchors"):
        post = cfg["postprocess"]
        criterion.set_anchors(generate_anchor_box(post["anchor_args"],
                                                  post["order"]))
    return trainer_cls(
        model=model, criterion=criterion, optimizer=optimizer,
        schedule=schedule, supervise_single=supervise_single(cfg),
        single_weight=cfg["loss"]["args"].get("single_weight", 1.0),
        bf16=bool(cfg["train_params"].get("bf16", False)),
        fix_modules=fix_modules, **fields,
    )


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

    start_epoch, path = (ckpt_lib.find_checkpoint(model_dir)
                         if args.model_dir else (0, None))
    trainer = build_trainer(cfg, device, steps_per_epoch,
                            init_from=args.init_from, resume=path)
    if path:
        print(f"[train] resumed from {path} (epoch {start_epoch}; the "
              "learning-rate schedule restarts at update 0, as in JAX)")
    model = trainer.model

    cached_train = cached_val = None
    if tp.get("cache_device_batches"):
        cached_train = cache_batches(train_ds, batch_size, device)
        cached_val = cache_batches(val_ds, batch_size, device)
        print(f"[train] cached {len(cached_train)} train batches on device "
              f"({_nbytes(cached_train) / 1e9:.2f} GB)")

    logger = MetricLogger(model_dir)
    best_val = float("inf")
    for epoch in range(start_epoch, epochs):
        batches = epoch_batches(train_ds, batch_size, epoch, device,
                                cached_train)
        losses, wait_s = [], 0.0
        t0 = time.time()
        while True:
            tw = time.perf_counter()
            batch = next(batches, None)
            wait_s += time.perf_counter() - tw
            if batch is None:
                break
            aux = trainer.train_step(batch)
            losses.append({k: v for k, v in aux.items() if v.dim() == 0})
        mean_aux = {k: float(torch.stack([x[k] for x in losses]).mean())
                    for k in losses[0]}  # the epoch's one sync
        dt = time.time() - t0
        rate = len(losses) * batch_size / dt
        logger.log(epoch, dict(mean_aux, samples_per_sec=rate,
                               input_wait_s=wait_s, epoch_s=dt))
        print(f"[epoch {epoch}] loss {mean_aux['total_loss']:.4f} "
              f"({rate:.2f} samples/s; {dt:.2f} s, of which {wait_s:.2f} s "
              "waiting for input)")

        if (epoch + 1) % save_freq == 0 or epoch == epochs - 1:
            ckpt_lib.save_checkpoint(model_dir, model, epoch + 1)
        if (epoch + 1) % eval_freq == 0 or epoch == epochs - 1:
            val = cached_val if cached_val is not None else (
                b for b, _ in device_batches(cfg, batch_size, device,
                                             dataset=val_ds))
            vlosses = [float(trainer.eval_step(b)["total_loss"])
                       for b in val]
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
