"""Starting the ranks of a device mesh (parallel/sharding.py).

One process per device. ``spawn`` starts them with the ``spawn`` start
method and a ``file://`` rendezvous in a fresh temporary directory, so
concurrent worlds on one host never share a port; ``init_rank`` joins
one rank to its world, NCCL on a CUDA device and gloo on the CPU (the
backend follows the device unless a caller names one; nothing falls
back from one to the other).
Under ``torchrun`` the ranks exist already and join through ``env://``.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from multiprocessing.connection import wait

import torch
import torch.distributed as dist


def check_world(n: int, device_type: str) -> None:
    """Refuse a world of ``n`` ranks the host cannot hold: more ranks on
    ``cuda`` than visible CUDA devices (NCCL takes one rank per device;
    nothing shares a card or falls back to the CPU), or a device type
    with no process-group backend."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if n > count:
            raise ValueError(f"{n} ranks on cuda, but {count} CUDA devices "
                             "are visible (one rank per device)")
    elif device_type != "cpu":
        raise ValueError(f"no process-group backend for {device_type!r}")


def init_rank(rank: int, world: int, device_type: str, init_method: str,
              timeout_s: float | None = None,
              backend: str | None = None) -> torch.device:
    """Join rank ``rank`` of ``world`` to the default process group; ->
    its device (CUDA rank r on device r % device_count). ``timeout_s``
    bounds every collective (None: torch's default). ``backend``: the
    device's (NCCL for cuda, gloo for the CPU) unless named; gloo also
    carries CUDA tensors, and unlike NCCL it lets several ranks share one
    card (chip_smoke.py's two-rank runs on one H100)."""
    check_world(1, device_type)
    if device_type == "cuda":
        backend = backend or "nccl"
        if backend == "nccl":
            check_world(world, device_type)
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device, backend = torch.device("cpu"), backend or "gloo"
    kwargs = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    if backend == "nccl":
        kwargs["device_id"] = device  # the rank's card, for every collective
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kwargs)
    return device


def torchrun_rank() -> tuple[int, int] | None:
    """(rank, world size) when started by torchrun, else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


def spawn(fn, n: int, args: tuple = (), timeout_s: float | None = None):
    """Run ``fn(rank, n, init_method, *args)`` in ``n`` fresh processes
    and wait for all of them. Raises RuntimeError naming the first rank
    that failed (the others are then stopped), or TimeoutError when
    ``timeout_s`` passes first. ``fn`` and ``args`` are pickled: a
    module-level function and plain values."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=fn, args=(r, n, init) + tuple(args))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while True:
                # one snapshot: a rank that exits after it still has a
                # readable sentinel, so the wait below never gets an
                # empty list (which would block for good)
                alive = [p for p in procs if p.is_alive()]
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(
                        f"rank {failed[0]} of {n} exited with code "
                        f"{procs[failed[0]].exitcode}")
                if not alive:
                    break
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(f"ranks {stuck} of {n} still running "
                                       f"after {timeout_s} s")
                wait([p.sentinel for p in alive],
                     timeout=left if left is None else min(left, 1.0))
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(f"rank {failed[0]} of {n} exited with "
                                   f"code {procs[failed[0]].exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
