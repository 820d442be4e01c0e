"""Flight recorder: a bounded ring of structured events + a postmortem dump.

The port's copy of the JAX package's ``raft_tpu/obs/recorder.py``, with
the same bundle schema: a bundle the port dumps passes the JAX
``validate_bundle`` and ``scripts/postmortem.py`` reads it.

When the failure ladder fires — a shed burst, a degradation step, a
watchdog trip, a NaN-skip window, a rollback — counters say how often,
not what happened in the seconds before. The flight recorder keeps the
last ``capacity`` structured events and the last ``trace_capacity``
completed request traces in bounded rings (``deque(maxlen)``: O(1)
lock-free appends, oldest evicted), and on a triggering fault dumps
everything as one JSON-able **postmortem bundle**:

    {"schema": "raft-postmortem/4", "reason": "watchdog_trip:serve/apply",
     "dumped_wall": <epoch>, "dumped_t": <monotonic>,
     "events":  [{"t": ..., "wall": ..., "kind": "shed", ...}, ...],
     "traces":  [<finished trace records, raft_tpu_torch.obs.trace>],
     "extra":   {...caller context...}}

Dump triggers: ``Watchdog`` trips (:mod:`raft_tpu_torch.utils.faults`),
page-severity alerts (:mod:`raft_tpu_torch.obs.alerts`) and
:class:`~raft_tpu_torch.train.stability.DivergenceError` escalation.
Bundles go to every registered sink (:func:`file_sink` writes
``postmortem_<n>_<reason>.json``; :func:`logger_sink` persists through
``MetricLogger.log_event``) and stay readable in-process
(:meth:`FlightRecorder.bundles`).

Recording is cheap enough for the hot path's *event*-rate operations
(sheds, level changes, drain phases — not per-request), and the recorder
never raises into the code it observes.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["FlightRecorder", "file_sink", "logger_sink", "validate_bundle"]

# /2 adds the alert-engine surface: an ``alerts`` list of the
# burn-rate alerts active at dump time, plus the ``alert_fire`` /
# ``alert_resolve`` event vocabulary in the ring. /3 adds the
# fleet-stitching identity — ``proc`` (the producing component's lane:
# frontend / router / engine / trainer) and ``pid`` — so
# ``scripts/postmortem.py --fleet`` can assemble one cross-process
# timeline from a parent bundle plus the worker bundles in the same dump
# directory, and stitched traces (spans tagged with a ``proc`` lane) are
# schema-checked. /4 adds the wire identity — ``transport``
# ("local" / "unix" / "tcp": how this component reaches its peer) and
# ``endpoint`` (the "host:port" a remote link dials, null for local) —
# plus the ``net_connect`` / ``net_disconnect`` / ``net_reconnect`` /
# ``net_keepalive_miss`` event vocabulary, so ``--fleet`` can place a
# partition window on the timeline. The validator reads all versions —
# /1 through /3 bundles on disk stay valid forever.
SCHEMA = "raft-postmortem/4"
_SCHEMAS = (
    "raft-postmortem/1", "raft-postmortem/2", "raft-postmortem/3", SCHEMA,
)

# Every event carries these; everything else is kind-specific payload.
_EVENT_REQUIRED = ("t", "wall", "kind")
_BUNDLE_REQUIRED = (
    "schema", "reason", "dumped_wall", "dumped_t", "events", "traces",
    "extra",
)
_BUNDLE_REQUIRED_V2 = _BUNDLE_REQUIRED + ("alerts",)
_BUNDLE_REQUIRED_V3 = _BUNDLE_REQUIRED_V2 + ("proc", "pid")
_BUNDLE_REQUIRED_V4 = _BUNDLE_REQUIRED_V3 + ("transport", "endpoint")


class FlightRecorder:
    """Bounded event + trace rings with a one-call postmortem dump."""

    def __init__(
        self,
        capacity: int = 512,
        trace_capacity: int = 32,
        *,
        bundle_capacity: int = 8,
        proc: str = "unknown",
        transport: str = "local",
        endpoint: Optional[str] = None,
    ):
        if capacity < 1 or trace_capacity < 1 or bundle_capacity < 1:
            raise ValueError(
                "capacity, trace_capacity, and bundle_capacity must be >= 1"
            )
        # the fleet lane this recorder's bundles belong to (schema /3):
        # "frontend" / "router" / "engine" / "trainer" — a worker
        # engine's bundle carries proc="engine" plus the worker's pid,
        # which is how --fleet tells worker lanes apart
        self.proc = str(proc)
        # the wire this component's peer link rides (schema /4):
        # "local" (same process / no link), "unix" (a domain socket),
        # or "tcp" — with the dialed "host:port" when there is one. A
        # ConnectionSupervisor's link recorder sets transport="tcp" +
        # endpoint, which is how --fleet finds the partition window.
        self.transport = str(transport)
        self.endpoint = None if endpoint is None else str(endpoint)
        self.capacity = int(capacity)
        self.trace_capacity = int(trace_capacity)
        self._events: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=self.capacity)
        )
        self._traces: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=self.trace_capacity)
        )
        self._bundles: "collections.deque[Dict[str, Any]]" = (
            collections.deque(maxlen=int(bundle_capacity))
        )
        self._sinks: List[Callable[[Dict[str, Any]], None]] = []
        self._lock = threading.Lock()
        self.events_recorded = 0
        self.traces_recorded = 0
        self.dumps = 0
        # set by the owning engine to its AlertEngine's
        # ``active`` — every bundle then carries the alerts live at dump
        # time (schema /2). None (or a raising provider) dumps [].
        self.alerts_provider: Optional[Callable[[], List[Dict[str, Any]]]] = (
            None
        )

    # -- recording (hot-ish path: event rate, never per-request) -----------

    def record(self, kind: str, /, **fields) -> None:
        """Append one structured event; oldest evicted past capacity.

        ``kind`` is positional-only so payload fields can never collide
        with (or silently overwrite) the event's own kind."""
        ev = {"t": time.monotonic(), "wall": time.time(), "kind": kind}
        fields.pop("kind", None)
        ev.update(fields)
        self._events.append(ev)     # deque(maxlen): bounded, lock-free
        self.events_recorded += 1

    def add_trace(self, trace_record: Dict[str, Any]) -> None:
        """Keep a finished trace (the tracer's ``on_finish`` sink)."""
        self._traces.append(trace_record)
        self.traces_recorded += 1

    def add_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            self._sinks.append(sink)

    # -- introspection -----------------------------------------------------

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e.get("kind") == kind]
        return evs

    def traces(self) -> List[Dict[str, Any]]:
        return list(self._traces)

    def bundles(self) -> List[Dict[str, Any]]:
        return list(self._bundles)

    @property
    def last_bundle(self) -> Optional[Dict[str, Any]]:
        return self._bundles[-1] if self._bundles else None

    # -- dumping -----------------------------------------------------------

    def dump(
        self, reason: str, extra: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        """Freeze the rings into a postmortem bundle and fan it out.

        Never raises: a failing sink is swallowed (the bundle stays
        readable in-process either way) — the recorder must not add a
        failure mode to the fault path that triggered it.
        """
        alerts: List[Dict[str, Any]] = []
        if self.alerts_provider is not None:
            try:
                alerts = list(self.alerts_provider())
            except Exception:
                alerts = []
        bundle: Dict[str, Any] = {
            "schema": SCHEMA,
            "reason": str(reason),
            "proc": self.proc,
            "pid": os.getpid(),
            "transport": self.transport,
            "endpoint": self.endpoint,
            "dumped_wall": time.time(),
            "dumped_t": time.monotonic(),
            "events": list(self._events),
            "traces": list(self._traces),
            "alerts": alerts,
            "extra": dict(extra or {}),
        }
        self._bundles.append(bundle)
        self.dumps += 1
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(bundle)
            except Exception:
                pass
        return bundle


def file_sink(directory: str, *, keep: int = 16) -> Callable:
    """A dump sink writing ``postmortem_<n>_<reason>.json`` files
    (atomic rename; at most ``keep`` retained, oldest deleted)."""
    os.makedirs(directory, exist_ok=True)
    counter = {"n": 0}
    lock = threading.Lock()

    def sink(bundle: Dict[str, Any]) -> None:
        with lock:
            n = counter["n"]
            counter["n"] += 1
        slug = "".join(
            c if (c.isalnum() or c in "-_") else "-"
            for c in bundle.get("reason", "dump")
        )[:48]
        path = os.path.join(directory, f"postmortem_{n:04d}_{slug}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bundle, f, default=repr)
        os.replace(tmp, path)
        olds = sorted(
            p for p in os.listdir(directory)
            if p.startswith("postmortem_") and p.endswith(".json")
        )
        for p in olds[:-keep]:
            try:
                os.remove(os.path.join(directory, p))
            except OSError:
                pass

    return sink


def logger_sink(metric_logger) -> Callable:
    """A dump sink persisting bundles through
    :meth:`raft_tpu_torch.utils.logging.MetricLogger.log_event` (the JSONL
    events file survives the process; a closed logger drops silently by
    that method's own contract)."""

    def sink(bundle: Dict[str, Any]) -> None:
        metric_logger.log_event({"kind": "postmortem", "bundle": bundle})

    return sink


def validate_bundle(bundle: Any) -> List[str]:
    """Schema check for a postmortem bundle; returns a list of problems
    (empty = valid). Shared by ``scripts/postmortem.py --check`` and the
    flight-recorder tests — one schema, one validator."""
    problems: List[str] = []
    if not isinstance(bundle, dict):
        return [f"bundle is {type(bundle).__name__}, expected dict"]
    schema = bundle.get("schema")
    if schema == SCHEMA:
        required = _BUNDLE_REQUIRED_V4
    elif schema == "raft-postmortem/3":
        required = _BUNDLE_REQUIRED_V3
    elif schema == "raft-postmortem/2":
        required = _BUNDLE_REQUIRED_V2
    else:
        required = _BUNDLE_REQUIRED
    for key in required:
        if key not in bundle:
            problems.append(f"missing bundle key {key!r}")
    if schema not in _SCHEMAS:
        problems.append(
            f"schema is {schema!r}, expected one of {list(_SCHEMAS)}"
        )
    if schema in (SCHEMA, "raft-postmortem/3") and "proc" in bundle and (
        not isinstance(bundle["proc"], str)
    ):
        problems.append("proc is not a string")
    if schema == SCHEMA:
        if "transport" in bundle and not isinstance(bundle["transport"], str):
            problems.append("transport is not a string")
        if "endpoint" in bundle and bundle["endpoint"] is not None and (
            not isinstance(bundle["endpoint"], str)
        ):
            problems.append("endpoint is not a string or null")
    alerts = bundle.get("alerts", [])
    if not isinstance(alerts, list):
        problems.append("alerts is not a list")
        alerts = []
    for i, al in enumerate(alerts):
        if not isinstance(al, dict) or "rule" not in al:
            problems.append(f"alerts[{i}] missing 'rule'")
    events = bundle.get("events", [])
    if not isinstance(events, list):
        problems.append("events is not a list")
        events = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"events[{i}] is not a dict")
            continue
        for key in _EVENT_REQUIRED:
            if key not in ev:
                problems.append(f"events[{i}] missing {key!r}")
        if "t" in ev and not isinstance(ev["t"], (int, float)):
            problems.append(f"events[{i}].t is not numeric")
    if events:
        ts = [e.get("t") for e in events if isinstance(e.get("t"), (int, float))]
        if ts != sorted(ts):
            problems.append("events are not in monotonic time order")
    traces = bundle.get("traces", [])
    if not isinstance(traces, list):
        problems.append("traces is not a list")
        traces = []
    for i, tr in enumerate(traces):
        if not isinstance(tr, dict):
            problems.append(f"traces[{i}] is not a dict")
            continue
        for key in ("trace_id", "kind", "spans", "dur_ms"):
            if key not in tr:
                problems.append(f"traces[{i}] missing {key!r}")
        spans = tr.get("spans", [])
        if not isinstance(spans, list):
            problems.append(f"traces[{i}].spans is not a list")
            continue
        for j, sp in enumerate(spans):
            if not isinstance(sp, dict) or "name" not in sp or (
                "dur_ms" not in sp or "t0_ms" not in sp
            ):
                problems.append(
                    f"traces[{i}].spans[{j}] missing name/t0_ms/dur_ms"
                )
            elif "proc" in sp and not isinstance(sp["proc"], str):
                # the stitched-trace contract (/3): a span's process
                # lane, when tagged, is a lane name --fleet can group on
                problems.append(f"traces[{i}].spans[{j}].proc not a string")
    if not isinstance(bundle.get("extra", {}), dict):
        problems.append("extra is not a dict")
    return problems
