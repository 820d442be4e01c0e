"""Bounded-queue prefetch on a host thread, ported from the JAX package's
``raft_tpu/utils/prefetch.py``:

  * worker exceptions are re-raised in the consumer (never swallowed into a
    silent early end-of-stream);
  * the producer uses timeout-puts and re-checks ``stop`` so it can never
    block forever on a full queue after the consumer abandons the iterator;
  * closing the generator (``.close()`` / GC / ``break``) sets ``stop`` and
    drains, so no thread outlives the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

__all__ = ["prefetch"]

_DONE = object()


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a background thread, ``depth`` items ahead."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            put(_Failure(e))
            return
        put(_DONE)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _Failure):
                raise item.exc
            yield item
    finally:
        stop.set()
        # Drain so a blocked producer observes stop promptly.
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
