"""Durable training and serving scalars and structured events as JSONL.

Ported from the JAX package's ``raft_tpu/utils/logging.py`` without its
TensorBoard writer (``tensorboardX`` is not a dependency of the port).
Two record streams:

  * ``log(step, scalars)`` -> ``scalars.jsonl`` — flat numeric records,
    one per log boundary (a restart continues the file).
  * ``log_event(record)`` -> ``events.jsonl`` — structured (non-scalar)
    records: flight-recorder postmortem bundles, anything JSON-able. The
    file is opened on first use, so scalar-only runs never create it.

Writes are serialized under a lock (the serve worker thread logs while
the owner may log from the main thread); a record after ``close()`` is a
counted no-op (``dropped_records``), never a raise on a closed file.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._events = None  # events.jsonl, opened on first log_event
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

    def log_event(self, record: Dict[str, Any]) -> None:
        """Persist one structured (non-scalar) record to ``events.jsonl``.

        The flight recorder's postmortem sink: nested dicts/lists pass
        through as JSON (non-serializable leaves fall back to ``repr``).
        A closed logger drops (counted) instead of raising — events fire
        exactly during the teardowns and faults where a raise would mask
        the original problem.
        """
        rec = dict(record)
        rec.setdefault("time", time.time())
        with self._lock:
            if self._closed:
                self.dropped_records += 1
                return
            if self._events is None:
                self._events = open(os.path.join(self.log_dir, "events.jsonl"), "a")
            self._events.write(json.dumps(rec, default=repr) + "\n")
            self._events.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._jsonl.close()
            if self._events is not None:
                self._events.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
