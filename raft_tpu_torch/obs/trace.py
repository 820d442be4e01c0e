"""Request tracing: low-overhead monotonic-clock spans into a bounded ring.

The port's copy of the JAX package's ``raft_tpu/obs/trace.py`` (pure
Python; the port keeps its own so that it never imports the JAX package).

The serving tier answers "where did this request's 180 ms go?" with a
*trace*: a per-request record of named spans (admit, queue_wait, dispatch,
fetch, ...) stamped with ``time.monotonic()`` at the point the engine
already holds the relevant timestamps — the hot path pays an attribute
check and a tuple append per span, nothing else. Completed traces land in
a preallocated ring (``collections.deque(maxlen=...)`` — a bounded ring
whose append is a single GIL-atomic op, so the record path takes **no
lock**; only :meth:`Tracer.snapshot` copies under one).

Sampling is deterministic and counter-based (:meth:`Tracer.start` returns
``None`` for unsampled requests — every call site guards with ``if trace
is not None`` or stores the ``None`` and lets the span helpers no-op), so
``trace_sample_rate=0.02`` records every 50th request without an RNG on
the hot path and A/B runs are reproducible.

A trace is finished exactly once (set-once, mirroring ``Request.finish``);
the finished record is a plain JSON-able dict::

    {"trace_id": "t-000007", "kind": "pair", "rid": 7,
     "t_start": <monotonic>, "wall_start": <epoch>, "ok": True,
     "error": None, "dur_ms": 181.4,
     "spans": [{"name": "admit", "t0_ms": 0.0, "dur_ms": 0.4}, ...],
     ...meta}

Span ``t0_ms`` is relative to the trace start, so a trace reads as a
timeline without clock arithmetic.

**Propagation**: a trace born at one component can be *joined* by every
component a request crosses. :class:`TraceContext` carries the
edge-chosen ``trace_id`` (and, in-process, the live edge :class:`Trace`
to stitch into); ``Tracer.start(trace_id=...)`` adopts an
externally-sampled id — the sampling decision was made once, at the edge,
so an adopted start always traces. A finished child record (sealed in
another process, on another monotonic clock) is merged back with
:meth:`Trace.absorb`, which maps the child's timestamps onto the
absorbing trace's clock via the handshake-estimated offset and tags every
absorbed span with its process lane (``proc="worker-<pid>"`` etc.).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Trace", "TraceContext", "Tracer", "dedupe_traces"]


class Trace:
    """One in-flight trace: spans accumulate, :meth:`finish` seals it."""

    __slots__ = (
        "trace_id", "kind", "rid", "t_start", "wall_start", "_spans",
        "_meta", "_sink", "_done", "_lock", "record",
    )

    def __init__(
        self,
        trace_id: str,
        kind: str,
        rid: Optional[int],
        sink: Callable[[Dict[str, Any]], None],
        *,
        t_start: Optional[float] = None,
    ):
        self.trace_id = trace_id
        self.kind = kind
        self.rid = rid
        self.t_start = time.monotonic() if t_start is None else float(t_start)
        self.wall_start = time.time()
        self._spans: List[tuple] = []
        self._meta: Dict[str, Any] = {}
        self._sink = sink
        self._done = False
        self._lock = threading.Lock()
        # the sealed record, set exactly once by finish() — readable by
        # whoever holds the Trace after the request completes (the
        # worker's reply piggyback, the engine's in-process stitch)
        self.record: Optional[Dict[str, Any]] = None

    def add_span(
        self, name: str, t0: float, t1: Optional[float] = None, **attrs
    ) -> None:
        """Record one span from monotonic timestamps the caller already
        holds (the hot-path form: no context manager, no extra clock
        reads beyond what the engine takes anyway)."""
        if self._done:
            return
        if t1 is None:
            t1 = time.monotonic()
        self._spans.append((name, t0, t1, attrs or None))

    def span(self, name: str, **attrs):
        """Context-manager form for host-side regions (trainer windows)."""
        return _SpanCtx(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """A zero-duration marker span (retry, remap, early exit)."""
        now = time.monotonic()
        self.add_span(name, now, now, **attrs)

    def annotate(self, **meta) -> None:
        """Attach metadata keys to the finished record (level, bucket...)."""
        if not self._done:
            self._meta.update(meta)

    def absorb(
        self,
        record: Optional[Dict[str, Any]],
        *,
        proc: Optional[str] = None,
        t_offset_s: float = 0.0,
    ) -> None:
        """Stitch a finished child trace record's spans into this trace.

        The child was recorded on another component's clock —
        potentially another process's ``time.monotonic()``.
        ``t_offset_s`` is that clock minus ours (the handshake-estimated
        RPC-midpoint offset; 0 in-process), so every absorbed span lands
        on this trace's timeline within the estimate's +-rtt/2 error
        bound. Each span is tagged ``proc=<lane>`` so a stitched trace
        renders as per-process lanes. ``None``/unsealed records are
        no-ops (a child that never finished contributes nothing).
        """
        if not record:
            return
        base = float(record.get("t_start", self.t_start)) - t_offset_s
        for sp in record.get("spans", ()):
            attrs = {
                k: v for k, v in sp.items()
                if k not in ("name", "t0_ms", "dur_ms")
            }
            if proc is not None:
                attrs["proc"] = proc
            t0 = base + sp["t0_ms"] / 1e3
            self.add_span(sp["name"], t0, t0 + sp["dur_ms"] / 1e3, **attrs)

    def finish(
        self, *, ok: bool = True, error: Optional[str] = None, **meta
    ) -> Optional[Dict[str, Any]]:
        """Seal the trace exactly once and push it to the recorder ring.

        Later calls are no-ops (worker/caller completion races mirror
        ``Request.finish``). Returns the record, or ``None`` if already
        finished.
        """
        with self._lock:
            if self._done:
                return None
            self._done = True
        t_end = time.monotonic()
        self._meta.update(meta)
        t0 = self.t_start
        rec: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "rid": self.rid,
            "t_start": t0,
            "wall_start": self.wall_start,
            "dur_ms": (t_end - t0) * 1e3,
            "ok": bool(ok) and error is None,
            "error": error,
            "spans": [
                {
                    "name": name,
                    "t0_ms": (s0 - t0) * 1e3,
                    "dur_ms": (s1 - s0) * 1e3,
                    **(attrs or {}),
                }
                for name, s0, s1, attrs in self._spans
            ],
        }
        rec.update(self._meta)
        self.record = rec
        try:
            self._sink(rec)
        except Exception:
            pass  # telemetry must never fail the request it describes
        return rec


class TraceContext:
    """The propagated half of a trace: the edge-chosen id, plus — when
    the absorbing trace lives in this process — the live :class:`Trace`
    to stitch child spans into.

    Crossing a process boundary only the ``trace_id`` travels (one
    optional field on the submit record); the worker engine adopts it
    via ``Tracer.start(trace_id=...)`` and its sealed record rides the
    result reply back, where the parent calls :meth:`absorb`.
    """

    __slots__ = ("trace_id", "trace")

    def __init__(self, trace_id: str, trace: Optional[Trace] = None):
        self.trace_id = str(trace_id)
        self.trace = trace

    def absorb(
        self,
        record: Optional[Dict[str, Any]],
        *,
        proc: Optional[str] = None,
        t_offset_s: float = 0.0,
    ) -> None:
        """Stitch a child record into the carried trace (no-op when the
        context crossed a process boundary and carries only the id)."""
        if self.trace is not None and record:
            self.trace.absorb(record, proc=proc, t_offset_s=t_offset_s)


def dedupe_traces(records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """One record per trace_id across merged trace streams, keeping the
    richest (most spans) — with propagation, a sampled request exists
    both as the stitched edge record AND as the worker engine's own
    record under the same id; phase breakdowns must count it once.
    Records without a trace_id pass through untouched, order preserved.
    """
    best: Dict[str, Dict[str, Any]] = {}
    order: List[Any] = []
    for rec in records:
        tid = rec.get("trace_id")
        if tid is None:
            order.append(rec)
            continue
        prev = best.get(tid)
        if prev is None:
            best[tid] = rec
            order.append(tid)
        elif len(rec.get("spans") or ()) > len(prev.get("spans") or ()):
            best[tid] = rec
    return [best[x] if isinstance(x, str) else x for x in order]


class _SpanCtx:
    __slots__ = ("_trace", "_name", "_attrs", "_t0")

    def __init__(self, trace: Trace, name: str, attrs):
        self._trace = trace
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._trace.add_span(
            self._name, self._t0, time.monotonic(), **(self._attrs or {})
        )


class Tracer:
    """Samples, ids, and collects traces for one component.

    ``sample_rate`` in [0, 1]: 0 disables (``start`` returns ``None``
    before taking any clock reading), 1 traces everything, fractional
    rates sample deterministically by request counter — request ``n`` is
    traced iff ``floor(n*rate) > floor((n-1)*rate)``, i.e. evenly spaced,
    reproducible, RNG-free.

    Completed records go to a bounded ring (``capacity`` most recent) and
    to any ``on_finish`` callbacks (the flight recorder's last-N-traces
    ring hangs off one).
    """

    _ids = itertools.count()  # process-wide: trace ids never collide

    def __init__(
        self,
        sample_rate: float = 0.0,
        *,
        capacity: int = 256,
        prefix: str = "t",
        on_finish: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(
                f"sample_rate must be in [0, 1], got {sample_rate}"
            )
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.sample_rate = float(sample_rate)
        self.prefix = prefix
        self._ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=int(capacity)
        )
        self._counter = itertools.count()
        self._on_finish = on_finish
        self._lock = threading.Lock()
        self.started = 0
        self.finished = 0

    def start(
        self, kind: str, rid: Optional[int] = None,
        *, t_start: Optional[float] = None, trace_id: Optional[str] = None,
    ) -> Optional[Trace]:
        """Begin a trace, or return ``None`` when this request is not
        sampled (the common case; callers thread the ``None`` through).

        ``trace_id`` adopts an externally-propagated id: the
        sampling decision was made once at the edge, so an adopted start
        bypasses this tracer's own rate entirely — a rate-0 engine still
        joins a trace the front door chose to record.
        """
        if trace_id is not None:
            self.started += 1
            return Trace(
                str(trace_id), kind, rid, self._record, t_start=t_start
            )
        rate = self.sample_rate
        if rate <= 0.0:
            return None
        n = next(self._counter)
        if rate < 1.0 and int((n + 1) * rate) == int(n * rate):
            return None
        self.started += 1
        tid = f"{self.prefix}-{next(Tracer._ids):08x}"
        return Trace(tid, kind, rid, self._record, t_start=t_start)

    def _record(self, rec: Dict[str, Any]) -> None:
        self._ring.append(rec)  # deque(maxlen): bounded, lock-free append
        self.finished += 1
        if self._on_finish is not None:
            try:
                self._on_finish(rec)
            except Exception:
                pass

    def snapshot(self) -> List[Dict[str, Any]]:
        """Copy of the completed-trace ring, oldest first (the only
        locking operation on the tracer)."""
        with self._lock:
            return list(self._ring)

    def find(self, trace_id: str) -> Optional[Dict[str, Any]]:
        for rec in reversed(self.snapshot()):
            if rec.get("trace_id") == trace_id:
                return rec
        return None
