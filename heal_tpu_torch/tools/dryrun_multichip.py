"""One sharded train step against one process, on a device mesh.

The port's counterpart of ``__graft_entry__.dryrun_multichip`` and
``sharded_equivalence_deltas``:

    python -m heal_tpu_torch.tools.dryrun_multichip [--devices N] \\
        [--device cuda|cpu]

On the tiny flagship config (tests/configs/entry_tiny.yaml with an agent
capacity of 2 per agent rank, a sample per data rank, as JAX's dryrun
cuts it) it factors N ranks over (data, agent, model) with
``factor_mesh``, starts them on ``--device`` (the card unless asked for
the CPU; parallel/launch.py: NCCL on cuda, one rank per device, more
ranks than devices refused; gloo on the CPU), and holds one sharded
step's loss and gradients, gathered into the one-device layout, against
one process's on the same global batch and weights: at the seeded init
(loss 1e-5 and gradients 1e-3 relative to max(1, loss), JAX's bounds),
and after 20 one-process warm-up steps (gradients 5e-4 relative to
max(1, max|g|)). It prints both deltas and exits non-zero past a bound.

:func:`sharded_results` runs a list of jobs (a config, a checkpoint, a
global batch, a mesh, a dtype) in one world; the CPU tests use it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import warnings

import numpy as np
import torch

from ..config import load_yaml
from ..data import build_dataset
from ..parallel import launch, to_device
from ..parallel.sharding import (factor_mesh, full_state_dict, full_tensors,
                                 make_mesh, shard_batch)
from .train import build_trainer

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "configs", "entry_tiny.yaml")
STEPS_PER_EPOCH = 4
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def tiny_cfg(agents: int = 4, norm: str | None = None) -> dict:
    """entry_tiny with an agent capacity of ``agents`` (``max_cav`` =
    ``num_agents``, as tests/test_sharding.py and JAX's dryrun set them)
    and optionally another ``norm``."""
    cfg = load_yaml(TINY)
    cfg["train_params"]["max_cav"] = agents
    cfg["fusion"]["args"]["num_agents"] = agents
    cfg["fusion"]["args"]["num_scenes_train"] = 4
    if norm is not None:
        cfg["model"]["args"]["norm"] = norm
    return cfg


def global_batch(cfg: dict, batch_size: int) -> dict:
    """The first unshuffled training batch (numpy)."""
    ds = build_dataset(cfg, train=True, native_iou=False)
    return next(ds.batches(batch_size, shuffle=False, process_split=False))


def _cast(batch: dict, dtype) -> dict:
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x
    return conv(batch)


def reproducible() -> None:
    """TF32 off and deterministic algorithms (where CUDA has them): the
    steps are compared at f32 bounds, which the card's order of atomic
    sums would exceed through train-mode batch norm."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.filterwarnings("ignore", message=".*deterministic")


def _trainer(cfg, state_path, device, dtype, mesh=None):
    trainer = build_trainer(cfg, device, STEPS_PER_EPOCH, resume=state_path,
                            mesh=mesh)
    trainer.model.to(dtype)
    return trainer


def _result(trainer, aux) -> dict:
    grads = {k: p.grad for k, p in trainer.model.named_parameters()
             if p.grad is not None}
    if trainer.mesh is not None:
        grads = full_tensors(trainer.model, grads)
        state = full_state_dict(trainer.model)
    else:
        state = trainer.model.state_dict()
    cpu = lambda t: t.detach().cpu()  # noqa: E731
    return {"aux": {k: float(v) for k, v in aux.items() if v.dim() == 0},
            "grads": {k: cpu(v) for k, v in grads.items()},
            "buffers": {k: cpu(v) for k, v in state.items()
                        if k not in grads}}


def one_process(cfg: dict, state_path: str, batch: dict, device="cpu",
                dtype: str = "float32") -> dict:
    """One process's step on the global ``batch`` from the state_dict at
    ``state_path``: {"aux": the scalar loss terms, "grads", "buffers"
    (the running statistics after the step)}."""
    trainer = _trainer(cfg, state_path, device, DTYPES[dtype])
    aux = trainer.gradients(_cast(to_device(batch, device), DTYPES[dtype]))
    return _result(trainer, aux)


def _rank_jobs(rank: int, world: int, init: str, device_type: str,
               jobs_path: str, out_path: str, timeout_s: float,
               backend: str | None) -> None:
    """One rank: every job's sharded step; rank 0 saves the results."""
    device = launch.init_rank(rank, world, device_type, init, timeout_s,
                              backend)
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        reproducible()
        out = []
        for job in torch.load(jobs_path, weights_only=False):
            mesh = make_mesh(world, *job["dims"])
            dtype = DTYPES[job["dtype"]]
            trainer = _trainer(job["cfg"], job["state"], device, dtype, mesh)
            local = shard_batch(job["batch"], mesh, ("data",))
            aux = trainer.gradients(_cast(to_device(local, device), dtype))
            out.append(_result(trainer, aux))
        if rank == 0:
            torch.save(out, out_path)
    finally:
        torch.distributed.destroy_process_group()


def sharded_results(jobs: list, n: int, device_type: str = "cpu",
                    timeout_s: float = 60.0,
                    backend: str | None = None) -> list:
    """Each job's sharded step over a world of ``n`` ranks, as
    :func:`one_process` reports it (gradients and buffers in the
    one-device layout). A job: {"cfg", "state" (a state_dict path),
    "batch" (global, numpy), "dims" (data, agent, model), "dtype"}. Every
    collective is bounded by ``timeout_s``, and the world by 4x that.
    ``backend``: see parallel/launch.init_rank."""
    with tempfile.TemporaryDirectory() as tmp:
        jobs_path = os.path.join(tmp, "jobs.pt")
        out_path = os.path.join(tmp, "out.pt")
        torch.save(jobs, jobs_path)
        launch.spawn(_rank_jobs, n, (device_type, jobs_path, out_path,
                                     timeout_s, backend),
                     timeout_s=4 * timeout_s)
        return torch.load(out_path, weights_only=False)


def equivalence_deltas(sharded: dict, single: dict) -> tuple[float, float]:
    """max |loss delta| and max |gradient delta| between a sharded and a
    one-process step (``sharded_equivalence_deltas``)."""
    d_loss = abs(sharded["aux"]["total_loss"] - single["aux"]["total_loss"])
    if sharded["grads"].keys() != single["grads"].keys():
        raise ValueError("the two steps have different parameters")
    d_grads = max(float((sharded["grads"][k].double()
                         - single["grads"][k].double()).abs().max())
                  for k in single["grads"])
    return d_loss, d_grads


def grad_scale(result: dict) -> float:
    return max(float(g.abs().max()) for g in result["grads"].values())


def warm_state(cfg: dict, state_path: str, batch: dict, steps: int,
               out_path: str, device="cpu") -> str:
    """``steps`` one-process train steps on ``batch`` from
    ``state_path``; -> the path of the warmed state_dict."""
    trainer = _trainer(cfg, state_path, device, torch.float32)
    b = to_device(batch, device)
    for _ in range(steps):
        trainer.train_step(b)
    torch.save(trainer.model.state_dict(), out_path)
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser("heal_tpu_torch dryrun_multichip")
    p.add_argument("--devices", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    n = args.devices
    device = torch.device(args.device)
    launch.check_world(n, device.type)
    data, agent, model = factor_mesh(n)
    cfg = tiny_cfg(2 * agent)
    batch = global_batch(cfg, max(2, data))
    reproducible()
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init.pth")
        torch.save(build_trainer(cfg, "cpu", STEPS_PER_EPOCH).model
                   .state_dict(), init)
        warm = warm_state(cfg, init, batch, 20,
                          os.path.join(tmp, "warm.pth"), device)
        jobs = [dict(cfg=cfg, state=path, batch=batch,
                     dims=(data, agent, model), dtype="float32")
                for path in (init, warm)]
        results = sharded_results(jobs, n, device.type)
        for name, path, res in zip(("init", "post-warmup"), (init, warm),
                                   results):
            single = one_process(cfg, path, batch, device)
            d_loss, d_grads = equivalence_deltas(res, single)
            loss = single["aux"]["total_loss"]
            gscale = grad_scale(single)
            bound = (1e-3 * max(1.0, loss) if name == "init"
                     else 5e-4 * max(1.0, gscale))
            print(f"[dryrun_multichip] {n} ranks (data={data}, "
                  f"agent={agent}, model={model}), {name}: loss={loss:.4f} "
                  f"max|dloss|={d_loss:.2e} max|dgrads|={d_grads:.2e} "
                  f"(max|grad|={gscale:.2e}, bound {bound:.2e})")
            ok &= np.isfinite(loss) and d_loss < 1e-5 * max(1.0, loss)
            ok &= d_grads < bound
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
