"""Double-buffered host input pipeline.

The port's copy of heal_tpu/data/prefetch.py (``prefetch``): a daemon
worker thread runs the host side of batch k+1..k+depth (assembly, and the
``transform`` given, e.g. pinning) while the consumer's step k runs on
the card. Worker exceptions re-raise at the consumer.

Where the host->device copy is issued: on the CONSUMER's stream, after
the batch leaves the queue (tools/train.py hands the worker
``parallel.pin``, and the loop calls ``parallel.to_device`` on what it
gets). A copy issued from the worker on the default stream would be
ordered behind the step already queued there and overlap nothing; a copy
on a side stream that the consumer does not wait on is a race, and
waiting on it needs an event per batch and ``record_stream`` on every
tensor. The copy from pinned memory is asynchronous for the host either
way, and it is a few MB against a step of tens of ms: what costs the host
time, the assembly and the pinning, is what moves to the worker.

Several hosts: ``FusionDataset.batches(process_split=True)`` gives each
host (:func:`host_index`) its equal slice of one seeded epoch order
(:func:`process_shard`), JAX's DistributedSampler counterpart; on one
host it is the whole order. The ranks of one host split each batch
over the mesh's data axis (parallel/sharding.shard_batch).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator

_SENTINEL = object()


def prefetch(batches: Iterable, transform: Callable | None = None,
             depth: int = 2) -> Iterator:
    """Iterate ``batches`` with a ``depth``-deep background pipeline;
    ``transform`` runs in the worker thread. The worker is a daemon:
    abandoning the iterator early leaves at most ``depth`` batches
    buffered, not a thread blocked for ever past the process's end."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    errors: list[BaseException] = []

    def worker():
        try:
            for b in batches:
                q.put(transform(b) if transform is not None else b)
        except BaseException as e:  # re-raised on the consumer side
            errors.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if errors:
                raise errors[0]
            return
        yield item


def host_index() -> tuple[int, int]:
    """(this host's index, the host count): torchrun's node rank and node
    count (``GROUP_RANK``, ``WORLD_SIZE`` / ``LOCAL_WORLD_SIZE``); (0, 1)
    outside torchrun. The port's counterpart of jax.process_index() /
    process_count()."""
    if "GROUP_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        per = int(os.environ["LOCAL_WORLD_SIZE"])
        return (int(os.environ["GROUP_RANK"]),
                int(os.environ["WORLD_SIZE"]) // per)
    return 0, 1


def process_shard(n: int, index: int | None = None,
                  count: int | None = None) -> tuple[int, int]:
    """(start, stop) of process ``index``'s equal slice of n samples, of
    ``count`` (default: this host of :func:`host_index`); the remainder is
    dropped, so every process runs the same number of steps."""
    if index is None or count is None:
        index, count = host_index()
    per = n // count
    return index * per, (index + 1) * per
