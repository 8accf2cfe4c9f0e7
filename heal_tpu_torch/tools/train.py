"""Trainer CLI for the port.

Counterpart of heal_tpu/tools/train.py, on one device or a device mesh:

    python -m heal_tpu_torch.tools.train -y heal_tpu/configs/opv2v_m1_pyramid.yaml \\
        [--model_dir runs/x] [--epochs N] [--init_from net.pth|net.ckpt] \\
        [--device cuda] [--devices N|DxAxM]

``--devices`` (JAX's flag, read as JAX reads it: N = data parallel,
DxAxM = data x agent x model; 0, the default, = one device without a
mesh) trains over D*A*M processes, one per device, on the
parallel/sharding.py mesh: NCCL on ``cuda`` (rank r on device
r % device_count; more ranks than devices raises), gloo on ``cpu``.
Outside ``torchrun`` the tool starts the ranks itself (``spawn``); under
``torchrun --nproc_per_node N -m heal_tpu_torch.tools.train ...
--devices N`` it joins the world torchrun made. Every rank takes the
same seeded order and assembles only its ``B/D`` samples of each global
batch (``batch_size`` must divide by D), so step k computes what one
process computes on global batch k. Rank 0 alone writes the run dir,
the log and the checkpoints (gathered into the one-device layout) and
runs the final inference.

The run dir gets ``config.yaml``, a snapshot of the package under
``scripts/`` (:func:`backup_source`), ``train_log.jsonl`` and the checkpoints
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
import tempfile
import time

import numpy as np
import torch

from ..config import load_yaml, save_yaml
from ..data import assembler_class, build_dataset
from ..data.prefetch import prefetch
from ..models import build_loss
from ..models.layers import channels_last
from ..parallel import Trainer, build_optimizer, pin, to_device
from ..parallel import launch
from ..parallel.freezing import freeze, trainable_parameters
from ..parallel.sharding import make_mesh, parse_devices, shard_state
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
    p.add_argument("--devices", default="0",
                   help="device mesh: N (data parallel) or DxAxM (data x "
                        "agent x model); 0 = one device, no mesh")
    return p.parse_args(argv)


def backup_source(model_dir: str) -> None:
    """Snapshot the heal_tpu_torch source into ``<model_dir>/scripts``
    (JAX train.py ``backup_source``; reference tools/train_utils
    .backup_script), so a run stays reproducible after the tree moves on.
    Built kernels and loaders (``_build/``, ``*.so``, ``*.o``) are left
    out; a run dir that has the snapshot keeps it."""
    import shutil

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(model_dir, "scripts")
    if os.path.exists(dst):
        return
    shutil.copytree(
        pkg_root, os.path.join(dst, "heal_tpu_torch"),
        ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so", "*.o"))


def run_dir_name(cfg: dict, model_dir: str) -> str:
    """``model_dir``, or a new time-stamped one under heal_tpu_logs/."""
    if model_dir:
        return model_dir
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S")
    return os.path.join("heal_tpu_logs", f"{cfg['name']}_{stamp}")


def setup_run_dir(cfg: dict, model_dir: str) -> str:
    model_dir = run_dir_name(cfg, model_dir)
    os.makedirs(model_dir, exist_ok=True)
    save_yaml(cfg, os.path.join(model_dir, "config.yaml"))
    backup_source(model_dir)
    return model_dir


def data_part(mesh) -> tuple[int, int]:
    """(this rank's data index, the data size) of ``mesh``: the part of
    each global batch the rank assembles (``FusionDataset.batches``),
    every agent kept (the models split ``inputs_*`` themselves); (0, 1)
    with no mesh."""
    if mesh is None:
        return 0, 1
    return mesh.coords["data"], mesh.shape["data"]


def epoch_batches(train_ds, batch_size: int, epoch: int, device,
                  cached: list | None = None, mesh=None):
    """The train batches of ``epoch`` on ``device``, in JAX's order:
    ``cached`` (the device cache of ``cache_device_batches``) permuted by
    ``default_rng(epoch)``; else the backend reinitialised and the samples
    shuffled with ``seed=epoch``, this rank's part of each batch
    (:func:`data_part`) assembled and pinned in the prefetch worker, and
    copied here, on the consumer's stream."""
    if cached is not None:
        for i in np.random.default_rng(epoch).permutation(len(cached)):
            yield cached[i]
        return
    if hasattr(train_ds.backend, "reinitialize"):
        train_ds.backend.reinitialize(seed=epoch)
    host = train_ds.batches(batch_size, shuffle=True, seed=epoch,
                            process_split=False, part=data_part(mesh))
    for batch in prefetch(host, lambda b: pin(b, device),
                          depth=PREFETCH_DEPTH):
        yield to_device(batch, device)


def cache_batches(dataset, batch_size: int, device, mesh=None) -> list:
    """Every batch of ``dataset``, unshuffled, on ``device`` (this rank's
    slice of each under a mesh)."""
    return [to_device(b, device)
            for b in dataset.batches(batch_size, shuffle=False,
                                     process_split=False,
                                     part=data_part(mesh))]


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
                  mesh=None, **fields) -> Trainer:
    """The ``Trainer`` of ``cfg`` on ``device``: the seeded init (seed 0),
    ``init_from`` loaded loosely (its left-out keys printed), ``resume``
    loaded strictly, then the model's ``fix_modules`` frozen and the
    optimizer built from the parameters left to train. Its update count
    starts at 0 whatever is loaded, as JAX's ``TrainState.step`` does.
    A loss with an IoU branch gets the anchor grid the assemblers label
    with (JAX's train.py passes ``train_ds.anchors``). ``trainer_cls``
    (a ``Trainer`` subclass) is built with the extra ``fields``. Under a
    device ``mesh`` the whole model is placed on it
    (``sharding.shard_state``) before the optimizer is built."""
    model = build_weights(cfg, seed=0)
    if init_from:
        left = ckpt_lib.loose_load(model, init_from)
        print(f"[train] loaded {init_from}; {len(left)} keys left out")
    if resume:
        model.load_state_dict(ckpt_lib.load_state_dict(resume))
    device = torch.device(device)
    model = model.to(device)
    if mesh is not None:
        shard_state(model, mesh)
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
        fix_modules=fix_modules, mesh=mesh, **fields,
    )


def main(argv=None) -> str:
    """Train as the arguments say; -> the run dir. With ``--devices``
    the ranks of the mesh train together (module docstring)."""
    args = parse_args(argv)
    if not (args.hypes_yaml or args.model_dir):
        raise SystemExit("need -y or --model_dir")
    if args.devices == "0":
        return train(args)
    n = int(np.prod(parse_devices(args.devices)))
    launch.check_world(n, torch.device(args.device).type)
    under_torchrun = launch.torchrun_rank()
    if under_torchrun is not None:
        rank, world = under_torchrun
        if world != n:
            raise ValueError(f"--devices {args.devices} is {n} ranks; "
                             f"torchrun started {world}")
        return _rank_main(rank, n, "env://", args)
    # one run dir for every rank, named here
    cfg = load_config(args.hypes_yaml or "", model_dir=args.model_dir or None)
    args.run_dir = run_dir_name(cfg, args.model_dir)
    if n == 1:
        with tempfile.TemporaryDirectory() as tmp:
            return _rank_main(0, 1, "file://" + os.path.join(tmp, "rdv"),
                              args)
    launch.spawn(_rank_main, n, (args,))
    return args.run_dir


def _rank_main(rank: int, world: int, init_method: str, args) -> str:
    """One rank of ``--devices``: join the world, train on the mesh,
    leave the world."""
    device = launch.init_rank(rank, world, torch.device(args.device).type,
                              init_method)
    try:
        if device.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        data, agent, model = parse_devices(args.devices)
        mesh = make_mesh(world, data, agent, model)
        return train(args, mesh=mesh, device=device)
    finally:
        torch.distributed.destroy_process_group()


def train(args, mesh=None, device=None) -> str:
    """The training run of ``args`` on ``device`` (``args.device``), as
    rank ``mesh.rank`` of a device mesh or alone (``mesh`` None)."""
    lead = mesh is None or mesh.rank == 0
    cfg = load_config(args.hypes_yaml or "", model_dir=args.model_dir or None)
    model_dir = getattr(args, "run_dir", None) or args.model_dir
    if lead:
        model_dir = setup_run_dir(cfg, model_dir)
    device = torch.device(device or args.device)

    train_ds = build_dataset(cfg, train=True)
    val_ds = build_dataset(cfg, train=False)
    tp = cfg["train_params"]
    batch_size = tp["batch_size"]
    epochs = args.epochs or tp["epoches"]
    eval_freq = tp.get("eval_freq", 2)
    save_freq = tp.get("save_freq", 2)
    steps_per_epoch = max(len(train_ds) // batch_size, 1)
    if mesh is not None:
        if batch_size % mesh.shape["data"]:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"the mesh's data axis ({mesh.shape['data']})")
        if lead:
            print(f"[train] mesh over {mesh.size} devices ("
                  + ", ".join(f"{a}={s}" for a, s in mesh.shape.items())
                  + f"), {device.type}")

    # (the other ranks may look before rank 0 made a new dir)
    start_epoch, path = (ckpt_lib.find_checkpoint(model_dir)
                         if args.model_dir and os.path.isdir(model_dir)
                         else (0, None))
    trainer = build_trainer(cfg, device, steps_per_epoch,
                            init_from=args.init_from, resume=path, mesh=mesh)
    if path and lead:
        print(f"[train] resumed from {path} (epoch {start_epoch}; the "
              "learning-rate schedule restarts at update 0, as in JAX)")
    model = trainer.model

    cached_train = cached_val = None
    if tp.get("cache_device_batches"):
        cached_train = cache_batches(train_ds, batch_size, device, mesh)
        cached_val = cache_batches(val_ds, batch_size, device, mesh)
        if lead:
            print(f"[train] cached {len(cached_train)} train batches on "
                  f"device ({_nbytes(cached_train) / 1e9:.2f} GB)")

    logger = MetricLogger(model_dir) if lead else None
    best_val = float("inf")
    for epoch in range(start_epoch, epochs):
        batches = epoch_batches(train_ds, batch_size, epoch, device,
                                cached_train, mesh)
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
        if lead:
            logger.log(epoch, dict(mean_aux, samples_per_sec=rate,
                                   input_wait_s=wait_s, epoch_s=dt))
            print(f"[epoch {epoch}] loss {mean_aux['total_loss']:.4f} "
                  f"({rate:.2f} samples/s; {dt:.2f} s, of which "
                  f"{wait_s:.2f} s waiting for input)")

        if (epoch + 1) % save_freq == 0 or epoch == epochs - 1:
            ckpt_lib.save_checkpoint(model_dir, model, epoch + 1, mesh=mesh)
        if (epoch + 1) % eval_freq == 0 or epoch == epochs - 1:
            val = cached_val if cached_val is not None else (
                to_device(b, device)
                for b in val_ds.batches(batch_size, shuffle=False,
                                        process_split=False,
                                        part=data_part(mesh)))
            vlosses = [float(trainer.eval_step(b)["total_loss"])
                       for b in val]
            vloss = float(np.mean(vlosses)) if vlosses else float("inf")
            if lead:
                print(f"[epoch {epoch}] val loss {vloss:.4f}")
            if vloss < best_val:
                best_val = vloss
                ckpt_lib.save_checkpoint(model_dir, model, epoch + 1,
                                         bestval=True, mesh=mesh)

    if lead:
        logger.close()
    if mesh is not None:
        torch.distributed.barrier()
    if not args.no_final_inference and lead:
        from .inference import run_inference

        result = run_inference(model_dir, device=device)
        print(f"[train] final inference: ap_30 {result['ap_30']:.4f} "
              f"ap_50 {result['ap_50']:.4f} ap_70 {result['ap_70']:.4f}")
    return model_dir


if __name__ == "__main__":
    main()
