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
"""
from __future__ import annotations

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
