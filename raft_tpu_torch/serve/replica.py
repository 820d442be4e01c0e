"""One routed serving replica: a ServeEngine plus its lifecycle state.

The port's copy of the JAX package's ``raft_tpu/serve/replica.py``. A
:class:`Replica` is what the :class:`~raft_tpu_torch.serve.router.ServeRouter`
owns: not a bare :class:`~raft_tpu_torch.serve.ServeEngine` but an engine
**factory** plus the state machine the router's health loop drives::

    starting -> healthy -> (draining -> healthy')      planned restart
                        -> (unhealthy -> healthy')     evict, cooldown, readmit
    any      -> stopped                                router shutdown

The factory (``factory(**overrides) -> ServeEngine``, engine returned
*unstarted*) is the whole point: an evicted replica is re-admitted by
building a **fresh** engine, so a wedged worker thread or a poisoned pool
never survives into the readmitted instance, and a draining restart
passes ``overrides`` through the same seam to swap config or weights.
On the card every (re)built engine captures its own CUDA graph set at
``start()``; no capture is shared between replicas. Replicas built from
one ``nn.Module`` share its weights on the card.

Health bookkeeping lives here too, so the router's monitor stays a thin
loop: the last good heartbeat, the watchdog-trip baseline between probes,
and a bounded window of router-observed dispatch outcomes (the error-rate
budget is judged on what the *router* saw, because a replica whose worker
died mid-batch fails requests without updating its own counters).

Backends: ``"thread"`` (the factory's engine runs in this process) and
``"process"`` (the engine runs in a spawned worker process behind a
:class:`~raft_tpu_torch.serve.worker.ProcessEngineClient`, its own
interpreter and CUDA context; the factory must be picklable and
``worker_options`` are the client's knobs). ``"remote"`` (a worker behind
TCP) raises ``NotImplementedError`` (ROADMAP queue 1 item 4b-ii).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Optional

from raft_tpu_torch.serve.engine import ServeEngine

__all__ = ["Replica", "ReplicaState"]


class ReplicaState:
    """The router-visible lifecycle states (plain strings, JSON-able)."""

    STARTING = "starting"
    HEALTHY = "healthy"
    DRAINING = "draining"
    UNHEALTHY = "unhealthy"
    STOPPED = "stopped"


class Replica:
    """A routed engine replica: engine + factory + health bookkeeping.

    Thread-safety: the router serializes lifecycle transitions
    (start/evict/restart/stop) under its own lock; the fields mutated on
    the dispatch path (``note_ok``/``note_error``, inflight) take this
    replica's lock only.
    """

    def __init__(
        self,
        replica_id: str,
        factory: Callable[..., ServeEngine],
        *,
        error_window: int = 32,
        backend: str = "thread",
        worker_options: Optional[Dict[str, Any]] = None,
    ):
        if backend not in ("thread", "process", "remote"):
            raise ValueError(f"backend must be 'thread', 'process', or 'remote', got {backend!r}")
        if backend == "remote":
            raise NotImplementedError(
                "backend='remote' (an engine in a worker behind TCP) is not ported yet: "
                "ROADMAP queue 1 item 4b-ii, the TCP remote arm"
            )
        self.replica_id = str(replica_id)
        self.factory = factory
        self.backend = backend
        self.endpoint: Optional[str] = None  # a remote worker's address (item 4b-ii)
        self.worker_options = dict(worker_options or {})
        self.engine: Optional[ServeEngine] = None
        self.state = ReplicaState.STARTING
        self.generation = 0           # bumped by every (re)build
        self.cooldown_until = 0.0     # monotonic; eviction sets it
        self.last_heartbeat = 0.0     # monotonic of the last good probe
        self.last_evict_reason: Optional[str] = None
        self._trip_baseline = 0       # watchdog trips at the last probe
        self._lock = threading.Lock()
        self._outcomes: collections.deque = collections.deque(maxlen=max(1, int(error_window)))
        self.inflight = 0             # router-observed outstanding requests
        self.dispatched = 0
        self.errors = 0
        self.deadline_misses = 0
        self.evictions = 0
        # monitor-maintained dispatch score: the router's heartbeat writes
        # queue fullness + degradation here once per beat; the dispatch
        # path reads it instead of calling engine.health() per request. A
        # shed nudges it up until the next beat (note_shed), so
        # consecutive picks spread.
        self.score_base = 0.0
        # per-class shed tally: which priority classes this replica priced
        # out ("default" when the dispatch carried no class)
        self.sheds_by_class: Dict[str, int] = {}
        # the weights this generation serves (engine.variables_hash),
        # cached at start() so snapshot() never touches the engine
        self.variables_hash: Optional[str] = None

    def note_shed(self, priority: Optional[str] = None) -> None:
        """Pressure feedback between heartbeats: this replica just shed
        (Overloaded/Draining); make it look expensive until the next
        probe recomputes the truth."""
        self.score_base += 1.0
        cls = priority or "default"
        with self._lock:
            self.sheds_by_class[cls] = self.sheds_by_class.get(cls, 0) + 1

    # -- lifecycle (called by the router under its lock) -------------------

    def build(self, **overrides) -> ServeEngine:
        """Build (not start) a fresh engine through the factory; the old
        one, if any, must already be stopped by the caller. The replica
        lets go of the old engine first: on the card the two never hold
        their memory together. Process backend: the "engine" is a
        :class:`~raft_tpu_torch.serve.worker.ProcessEngineClient` that
        spawns a fresh worker on start (the same rebuild-not-resuscitate
        contract, with a new PID)."""
        self.engine = None
        if self.backend == "process":
            from raft_tpu_torch.serve.worker import ProcessEngineClient

            self.engine = ProcessEngineClient(self.factory, overrides, **self.worker_options)
        else:
            self.engine = self.factory(**overrides)
        self.generation += 1
        self._trip_baseline = 0
        with self._lock:
            self._outcomes.clear()
        return self.engine

    def start(self, **overrides) -> None:
        """Build + boot (blocking: on the card the graph set is captured
        here)."""
        self.build(**overrides)
        self.engine.start()
        self.state = ReplicaState.HEALTHY
        self.last_heartbeat = time.monotonic()
        self.score_base = 0.0  # fresh engine: idle until a probe says else
        try:
            # one stats() call per (re)boot: the weights this generation serves
            self.variables_hash = self.engine.stats().get("variables_hash")
        except Exception:
            self.variables_hash = None

    @property
    def supports_init_flow(self) -> bool:
        """Whether this replica's engine accepts an ``init_flow`` seed on
        pair submits (the engine's own capability check)."""
        return bool(getattr(self.engine, "supports_init_flow", False))

    def stop_engine(self, graceful: bool = False, timeout: float = 30.0) -> None:
        """Tear down the current engine, tolerating an already-dead one."""
        eng = self.engine
        if eng is None:
            return
        try:
            eng.close(graceful=graceful, timeout=timeout)
        except Exception:
            # a replica being evicted may be arbitrarily broken; teardown
            # is best-effort by design (the rebuild is the real recovery)
            pass

    def dump_worker_postmortem(self, reason: str) -> bool:
        """Pull the worker's own flight-recorder bundle into the parent's
        dump directory (process backend; a thread engine shares the
        parent's recorder already). Best-effort: a SIGKILLed worker has
        nothing left to dump, and that must not block the eviction that
        found it."""
        dump = getattr(self.engine, "dump_postmortem", None)
        if dump is None:
            return False
        try:
            return bool(dump(reason))
        except Exception:
            return False

    # -- dispatch-path bookkeeping ----------------------------------------

    def note_ok(self) -> None:
        with self._lock:
            self.dispatched += 1
            self._outcomes.append(1)

    def note_error(self) -> None:
        with self._lock:
            self.dispatched += 1
            self.errors += 1
            self._outcomes.append(0)

    def note_deadline_miss(self) -> None:
        """A dispatch that missed its caller's deadline, kept OUT of the
        eviction error window: deadline misses under load are correlated
        across replicas (queue wait, not replica fault), so budgeting them
        would evict the whole fleet in a load spike."""
        with self._lock:
            self.dispatched += 1
            self.deadline_misses += 1

    def error_rate(self) -> float:
        """Router-observed dispatch failure fraction over the window (0.0
        until the window has any samples)."""
        with self._lock:
            if not self._outcomes:
                return 0.0
            return 1.0 - sum(self._outcomes) / len(self._outcomes)

    def window_full(self) -> bool:
        with self._lock:
            return len(self._outcomes) == self._outcomes.maxlen

    def trip_delta(self, trips_now: int) -> int:
        """Watchdog trips since the previous probe (monotone counter from
        ``engine.health()``); updates the baseline."""
        delta = max(0, trips_now - self._trip_baseline)
        self._trip_baseline = trips_now
        return delta

    # -- introspection -----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            inflight, dispatched, errors, deadline_misses = (
                self.inflight, self.dispatched, self.errors, self.deadline_misses,
            )
            sheds_by_class = dict(self.sheds_by_class)
        now = time.monotonic()
        return {
            "state": self.state,
            "backend": self.backend,
            "endpoint": self.endpoint,
            "pid": getattr(self.engine, "pid", None),
            "generation": self.generation,
            "variables_hash": self.variables_hash,
            "inflight": inflight,
            "dispatched": dispatched,
            "errors": errors,
            "deadline_misses": deadline_misses,
            "sheds_by_class": sheds_by_class,
            "error_rate": self.error_rate(),
            "evictions": self.evictions,
            "last_evict_reason": self.last_evict_reason,
            "cooldown_remaining_s": max(0.0, self.cooldown_until - now),
            "heartbeat_age_s": now - self.last_heartbeat if self.last_heartbeat else None,
        }
