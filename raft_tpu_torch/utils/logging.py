"""Durable training scalars as JSONL.

Ported from the JAX package's ``raft_tpu/utils/logging.py`` without its
TensorBoard writer (``tensorboardX`` is not a dependency of the port) and
its structured-event stream (no flight recorder is ported to feed it):
``log(step, scalars)`` appends one flat numeric record per log boundary
to ``scalars.jsonl`` (a restart continues the file). Writes are
serialized under a lock; a record after ``close()`` is a counted no-op
(``dropped_records``), never a raise.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._lock = threading.Lock()
        self._closed = False
        self.dropped_records = 0

    @property
    def closed(self) -> bool:
        return self._closed

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        with self._lock:
            if self._closed:
                self.dropped_records += 1
                return
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
