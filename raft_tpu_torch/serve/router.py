"""Horizontal serving tier: N engine replicas behind one router.

The port's copy of the JAX package's ``raft_tpu/serve/router.py``. One
:class:`~raft_tpu_torch.serve.ServeEngine` is one worker thread on the card,
in this process or in a worker process of its own. :class:`ServeRouter`
owns N independent :class:`~raft_tpu_torch.serve.replica.Replica`
instances, each with its own engine, config and worker, boots them
concurrently, and exposes the **same caller API as a single engine**:
``submit`` / ``submit_tiled`` / ``open_stream`` / ``submit_frame`` /
``health`` / ``stats``.

On one card the replicas share the device: the tier buys fault isolation
(an evicted replica is rebuilt from its factory, with a fresh worker, pool
and graph set) and rolling restarts, not requests/s. Each (re)built engine
captures its own CUDA graph set at boot.

The routing mechanics, in the order a request meets them:

* **least-loaded dispatch**: pairwise requests go to the healthy replica
  with the best score. The monitor's heartbeat maintains the score
  (queue-fullness fraction + degradation level, refreshed each beat; a
  shed nudges it in between); dispatch reads it plus the router-observed
  inflight tiebreak, with no ``engine.health()`` call per request. Each
  replica keeps its own bounded shedding queue.
* **stream affinity**: stream frames hash to a replica via a
  consistent-hash ring (``md5`` over virtual nodes), because a stream's
  cached frame lives on exactly one replica. When the replica set changes
  only ~1/N of streams remap, and a remapped stream *re-primes* on its new
  home (one ``primed`` frame, then flow again).
* **re-route on replica fault**: a dispatch that fails for replica reasons
  (engine stopped, drain in progress, injected chaos) is retried on the
  next-best replica within the request's remaining deadline. Terminal
  errors (``InvalidInput``, ``PoisonedInput``) and the caller's own
  deadline are never retried.
* **cross-replica shedding**: the router raises ``Overloaded`` only when
  *every* healthy replica shed the request, with the smallest of the
  replicas' ``retry_after_ms``.
* **health-driven eviction**: a monitor thread heartbeats every replica
  (probes run with a timeout, so a wedged engine cannot wedge the
  monitor). A replica that reports unhealthy, stops heartbeating, burns
  watchdog trips or exceeds the router-observed error-rate budget is
  evicted: out of the ring and the candidate set, its queued work failed
  fast (and so re-routed by the blocked callers), then probed back in
  after a cooldown, rebuilt from its factory if its engine did not
  survive.
* **draining restarts**: :meth:`ServeRouter.restart_replica` quiesces one
  replica through the engine's ``drain`` (in-flight finishes, queued work
  re-routes via the retryable ``Draining``), rebuilds it through the
  replica factory with the given overrides, boots it and re-admits it.

* **guarded rollouts**: :meth:`ServeRouter.add_candidate` boots a
  candidate replica outside the fleet and starts a
  :class:`~raft_tpu_torch.serve.rollout.RolloutController` ladder: shadow
  (live replies mirrored to the candidate through each submit closure's
  ``**mkw`` seam, ``shadow=True``), canary (a fraction of pair dispatches
  served by the candidate, a failure re-served by an incumbent), then
  promotion through draining restarts or an automatic rollback.

``FaultInjector.patch_router`` exposes the chaos seams
(``router.heartbeat``, ``router.dispatch``; the candidate's beat goes
through the heartbeat seam too). Every lifecycle transition is
a flight-recorder event, every eviction dumps a postmortem bundle
(:meth:`ServeRouter.dump_postmortem`), and :meth:`ServeRouter.prometheus`
exposes the whole tier in one scrape, each replica's series labelled
``replica=``.

The router holds no reference cycle: its gauges and alert snapshot close
over its counters and replica list, or read the router weakly, and its
rollout controller holds it weakly, so a closed router and its stopped
engines are freed as soon as the caller lets go.

Replicas and rollout candidates run in this process (``backend='thread'``)
or each in a spawned worker process (``backend='process'``, a picklable
factory, ``worker_options`` for the worker client; an evicted live worker
dumps its own postmortem bundle into ``worker_options['dump_dir']``). Not
ported yet: remote replicas (``add_remote_replica``,
``backend='remote'``; ROADMAP queue 1 item 4b-ii) raise
``NotImplementedError``.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from raft_tpu_torch.obs import (
    AlertEngine,
    AlertRule,
    FlightRecorder,
    MetricsRegistry,
    TraceContext,
    logger_sink,
    rate,
    relabel_prometheus,
)
from raft_tpu_torch.serve.engine import ServeEngine, ServeResult, _weakly
from raft_tpu_torch.serve.errors import (
    DeadlineExceeded,
    Draining,
    EngineStopped,
    InvalidInput,
    Overloaded,
    PoisonedInput,
    ServeError,
)
from raft_tpu_torch.serve.replica import Replica, ReplicaState
from raft_tpu_torch.serve.rollout import RolloutConfig, RolloutController, RolloutStage
from raft_tpu_torch.serve.tiler import TilePlanner, blend_tiles

__all__ = ["ServeRouter", "RouterConfig", "ConsistentHashRing", "RouterStream"]


def _hash64(key: str) -> int:
    """Stable 64-bit point on the ring (md5: deterministic across
    processes and machines, unlike Python's salted ``hash``)."""
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """Classic consistent hashing over virtual nodes.

    Each member owns ``vnodes`` pseudo-random points on a 64-bit ring; a key
    maps to the member owning the first point clockwise of the key's hash.
    Removing a member moves only the keys it owned (~1/N of them), and
    re-adding it restores exactly the original mapping. Not thread-safe;
    the router mutates it under its lock.
    """

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        self._points: List[int] = []          # sorted hash points
        self._owner: Dict[int, str] = {}      # point -> member
        self._members: set = set()

    def add(self, member: str) -> None:
        if member in self._members:
            return
        self._members.add(member)
        for v in range(self.vnodes):
            h = _hash64(f"{member}#{v}")
            # keep the first owner if two vnode labels ever collide
            if h in self._owner:
                continue
            bisect.insort(self._points, h)
            self._owner[h] = member

    def remove(self, member: str) -> None:
        if member not in self._members:
            return
        self._members.discard(member)
        dead = [h for h, m in self._owner.items() if m == member]
        for h in dead:
            del self._owner[h]
            i = bisect.bisect_left(self._points, h)
            if i < len(self._points) and self._points[i] == h:
                del self._points[i]

    def members(self) -> frozenset:
        return frozenset(self._members)

    def lookup(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        i = bisect.bisect_right(self._points, _hash64(key))
        if i == len(self._points):
            i = 0
        return self._owner[self._points[i]]


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Knobs for :class:`ServeRouter`.

    Args:
        virtual_nodes: ring points per replica for stream affinity.
        heartbeat_interval_s: monitor probe cadence per replica.
        heartbeat_timeout_s: a replica whose last *good* heartbeat is older
            than this (stalled or failing probes) is evicted.
        error_rate_budget: router-observed dispatch failure fraction (over
            ``error_window`` outcomes) beyond which a replica is evicted;
            judged only once the window is full. Only replica-fault
            failures count; deadline misses do not.
        error_window: outcomes in the error-rate window.
        watchdog_trip_budget: device-watchdog trips between two consecutive
            heartbeats that evict.
        cooldown_s: how long an evicted replica sits out before the monitor
            probes it back in (rebuilding its engine from the factory when
            it did not survive).
        drain_timeout_s: quiesce bound for a draining restart; a replica
            that cannot drain in time is restarted anyway.
        max_attempts: bound on per-request re-routes across replicas
            (``None`` = one attempt per replica).
        default_deadline_ms: deadline when a request carries none (``None``
            = the first healthy replica's engine default).
        alert_short_window_s / alert_long_window_s: the burn-rate alert
            windows of the tier rules (eviction rate, heartbeat-miss rate,
            fleet-wide shed rate, no healthy replica).
    """

    virtual_nodes: int = 64
    heartbeat_interval_s: float = 0.25
    heartbeat_timeout_s: float = 2.0
    error_rate_budget: float = 0.5
    error_window: int = 16
    watchdog_trip_budget: int = 3
    cooldown_s: float = 2.0
    drain_timeout_s: float = 30.0
    max_attempts: Optional[int] = None
    default_deadline_ms: Optional[float] = None
    alert_short_window_s: float = 5.0
    alert_long_window_s: float = 60.0

    def __post_init__(self):
        if self.virtual_nodes < 1:
            raise ValueError(f"virtual_nodes must be >= 1, got {self.virtual_nodes}")
        if self.heartbeat_interval_s <= 0 or self.heartbeat_timeout_s <= 0:
            raise ValueError(
                "heartbeat_interval_s and heartbeat_timeout_s must be "
                f"positive, got {self.heartbeat_interval_s} / {self.heartbeat_timeout_s}"
            )
        if not (0.0 < self.error_rate_budget <= 1.0):
            raise ValueError(f"error_rate_budget must be in (0, 1], got {self.error_rate_budget}")
        if self.error_window < 1:
            raise ValueError(f"error_window must be >= 1, got {self.error_window}")
        if self.watchdog_trip_budget < 1:
            raise ValueError(f"watchdog_trip_budget must be >= 1, got {self.watchdog_trip_budget}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {self.cooldown_s}")
        if self.max_attempts is not None and self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1 or None, got {self.max_attempts}")
        if not (0 < self.alert_short_window_s <= self.alert_long_window_s):
            raise ValueError(
                f"need 0 < alert_short_window_s <= alert_long_window_s, "
                f"got {self.alert_short_window_s} / {self.alert_long_window_s}"
            )


class RouterStream:
    """Caller-facing handle for one routed video stream (the router's mirror
    of :class:`~raft_tpu_torch.serve.StreamSession`). Frames follow the
    stream's consistent-hash home replica; a migration (evict/drain) shows
    up as one ``primed=True`` frame while the new home re-primes."""

    def __init__(self, router: "ServeRouter", stream_id: int):
        self._router = router
        self.stream_id = stream_id

    def submit(self, frame, *, deadline_ms: Optional[float] = None, num_flow_updates: Optional[int] = None,
               trace_ctx: Optional[TraceContext] = None, priority: Optional[str] = None,
               tenant: Optional[str] = None) -> ServeResult:
        kw = {} if trace_ctx is None else {"trace_ctx": trace_ctx}
        if priority is not None:
            kw["priority"] = priority
        if tenant is not None:
            kw["tenant"] = tenant
        return self._router.submit_frame(
            self.stream_id, frame, deadline_ms=deadline_ms, num_flow_updates=num_flow_updates, **kw,
        )

    def close(self) -> None:
        self._router.close_stream(self.stream_id)

    def __enter__(self) -> "RouterStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_ROUTER_COUNTERS = (
    "routed", "completed", "rerouted", "shed_all_replicas",
    "no_healthy_replicas", "evictions", "readmissions",
    "restarts", "drains", "heartbeat_misses", "stream_remaps",
    "streams_opened",
    # rollout accounting: always present (zero with no candidate), never
    # in the engine aggregate the autoscaler reads
    "mirrored", "mirror_shed", "canary_routed",
    # tiled: whole-plan affinity dispatches vs per-tile fan-outs
    "tiled_routed", "tiled_fanout",
)


class ServeRouter:
    """N ServeEngine replicas behind a single-engine-shaped API.

    Example::

        def factory(**overrides):      # an unstarted engine per call
            return ServeEngine(model, dataclasses.replace(cfg, **overrides))

        with ServeRouter.from_factory(factory, 2) as router:
            result = router.submit(image1, image2)
            router.restart_replica("r1", ladder=(12,))   # draining restart
    """

    def __init__(self, replicas: Sequence[Replica], config: Optional[RouterConfig] = None, *, logger=None):
        if not replicas:
            raise ValueError("at least one replica is required")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.config = config or RouterConfig()
        self._logger = logger
        self._replicas: List[Replica] = list(replicas)
        self._by_id: Dict[str, Replica] = {r.replica_id: r for r in replicas}
        self._ring = ConsistentHashRing(self.config.virtual_nodes)
        self._lock = threading.RLock()
        # registry-backed counters + the tier-level flight recorder; every
        # eviction dumps a postmortem bundle. The wider trace ring holds
        # the replicas' traces aggregated at dump time AND the re-routed
        # requests' traces pinned at re-route time.
        self.metrics = MetricsRegistry("router")
        self.recorder = FlightRecorder(trace_capacity=128, proc="router")
        if logger is not None:
            self.recorder.add_sink(logger_sink(logger))
        self._counters = self.metrics.counter_group("counters", _ROUTER_COUNTERS)
        # per-class all-replicas-shed tally, keyed by the dispatch's
        # priority class ("default" when none rode the call)
        self._qos_all_shed: Dict[str, int] = {}
        # router-side tile planner, mirrored lazily from the first healthy
        # replica's config
        self._tiler: Optional[TilePlanner] = None
        self._tiler_cap = 0
        # gauges and the alert snapshot close over the replica list and the
        # counters, never over the router, and the recorder reads the
        # alerts weakly: no reference cycle
        replicas_ref, counters = self._replicas, self._counters
        self.metrics.gauge(
            "healthy_count", lambda: sum(1 for r in replicas_ref if r.state == ReplicaState.HEALTHY)
        )
        self.metrics.gauge("replica_count", lambda: len(replicas_ref))
        # tier burn-rate alerts, evaluated from the monitor thread over the
        # router's own counters. eviction_burn is ticket severity (every
        # eviction already dumps its own postmortem); no_healthy_replicas
        # is the page.
        s_w, l_w = self.config.alert_short_window_s, self.config.alert_long_window_s
        self._alerts = AlertEngine(
            (
                AlertRule("eviction_burn", rate("evictions"), 0.0, s_w, l_w),
                AlertRule("heartbeat_miss_burn", rate("heartbeat_misses"), 0.5, s_w, l_w),
                AlertRule("fleet_shed_burn", rate("shed_all_replicas"), 0.5, s_w, l_w),
                AlertRule("no_healthy_replicas", rate("no_healthy_replicas"), 0.0, s_w, l_w, severity="page"),
            ),
            snapshot_fn=lambda: dict(counters),
            recorder=self.recorder,
        )
        self._alerts.register_gauges(self.metrics)
        self.recorder.alerts_provider = _weakly(self._alerts.active, [])
        self._stream_homes: Dict[int, str] = {}
        # every replica a stream has ever been served on: a drain window
        # can leave cached frame state on an interim home, which must be
        # cleared when the stream leaves (remap) or closes
        self._stream_visited: Dict[int, set] = {}
        # stream -> ring-home cache, cleared by every ring mutation
        # (_ring_add/_ring_remove): a frame pays one dict lookup
        self._affinity: Dict[int, str] = {}
        self._next_sid = 0
        self._default_deadline_ms: float = self.config.default_deadline_ms or 0.0
        self._started = False
        self._stop_event = threading.Event()
        self._monitor_thread: Optional[threading.Thread] = None
        # an attached Autoscaler is evaluated from the monitor loop; its
        # actions call add_replica / remove_replica
        self._autoscaler = None
        # fired after every successful draining restart (the one seam every
        # serving-weights swap goes through)
        self._weights_listeners: List[Callable[..., None]] = []
        # the guarded rollout: the candidate replica and its ladder live in a
        # RolloutController OUTSIDE self._replicas (invisible to _pick, the
        # ring, the stats aggregate and the autoscaler); the monitor drives
        # it as it drives the autoscaler
        self._rollout: Optional[RolloutController] = None
        # reserved under _lock while a candidate boots: add_candidate lets
        # go of the lock for the (slow) boot, and without the reservation
        # two concurrent calls would both pass the one-ladder check
        self._rollout_pending = False
        self.metrics.gauge("rollout_active", _weakly(self._rollout_active, 0.0),
                           help="1 while a candidate rollout ladder is live")
        # probes run off-thread so a wedged engine stalls a probe future,
        # never the monitor loop
        self._probe_pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * len(self._replicas)), thread_name_prefix="raft-router-probe",
        )

    @classmethod
    def from_factory(cls, factory: Callable[..., ServeEngine], num_replicas: int,
                     config: Optional[RouterConfig] = None, *, backend: str = "thread",
                     worker_options: Optional[Dict[str, Any]] = None, **kw) -> "ServeRouter":
        """Build N replicas over one engine factory.

        ``factory(**overrides) -> ServeEngine`` (unstarted) is called once
        per replica at boot and again on every rebuild: evicted-replica
        recovery and draining restarts both go through it.

        ``backend="process"`` runs every replica's engine in its own spawned
        worker process behind the same surface: the factory is pickled into
        the child, so it must be a module-level callable, and
        ``worker_options`` forwards
        :class:`~raft_tpu_torch.serve.worker.ProcessEngineClient` knobs:
        ``ring_slots``, ``slot_bytes`` (size both rings to ``/dev/shm``)
        and ``dump_dir``. ``backend="remote"`` raises
        ``NotImplementedError`` (ROADMAP queue 1 item 4b-ii).
        """
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
        cfg = config or RouterConfig()
        replicas = [
            Replica(f"r{i}", factory, error_window=cfg.error_window, backend=backend, worker_options=worker_options)
            for i in range(num_replicas)
        ]
        return cls(replicas, cfg, **kw)

    @property
    def replicas(self) -> List[Replica]:
        return list(self._replicas)

    @property
    def variables_hash(self) -> Optional[str]:
        """The fleet's serving-weights identity: the single hash when every
        replica that reports one agrees, else ``None``."""
        hashes = {r.variables_hash for r in self._replicas if r.variables_hash is not None}
        return hashes.pop() if len(hashes) == 1 else None

    @property
    def supports_init_flow(self) -> bool:
        """Whether pair submits may carry an ``init_flow`` seed: every
        replica's engine must accept it (dispatch can pick any of them)."""
        if not self._replicas:
            return False
        return all(r.supports_init_flow for r in self._replicas)

    def add_weights_listener(self, fn: Callable[..., None]) -> None:
        """Register ``fn(replica_id=..., generation=...)`` to fire after
        every successful draining restart. Listener exceptions are
        swallowed (cache hygiene must never fail a restart)."""
        with self._lock:
            self._weights_listeners.append(fn)

    def _fire_weights_listeners(self, **kw) -> None:
        with self._lock:
            listeners = list(self._weights_listeners)
        for fn in listeners:
            try:
                fn(**kw)
            except Exception:
                pass

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeRouter":
        """Boot every replica concurrently (on the card their warm-ups, each
        capturing its graph set, take turns), then start the health
        monitor. Replicas that fail to boot start life evicted (probed back
        in after cooldown); at least one must come up."""
        if self._started:
            return self
        with ThreadPoolExecutor(max_workers=len(self._replicas), thread_name_prefix="raft-router-boot") as ex:
            futs = {ex.submit(rep.start): rep for rep in self._replicas}
            boot_errors: Dict[str, str] = {}
            for fut, rep in futs.items():
                try:
                    fut.result()
                except Exception as e:
                    rep.state = ReplicaState.UNHEALTHY
                    rep.last_evict_reason = f"boot failed: {e!r}"
                    rep.cooldown_until = time.monotonic() + self.config.cooldown_s
                    boot_errors[rep.replica_id] = repr(e)
        healthy = [r for r in self._replicas if r.state == ReplicaState.HEALTHY]
        if not healthy:
            raise ServeError(f"no replica booted: {boot_errors}")
        with self._lock:
            for rep in healthy:
                self._ring_add(rep.replica_id)
            if not self._default_deadline_ms:
                self._default_deadline_ms = healthy[0].engine.config.default_deadline_ms
        self._started = True
        self._monitor_thread = threading.Thread(target=self._monitor, name="raft-router-monitor", daemon=True)
        self._monitor_thread.start()
        return self

    def stop(self) -> None:
        self.close(graceful=False)

    def close(self, graceful: bool = False, *, timeout: Optional[float] = 30.0) -> None:
        """Stop monitor and replicas (``graceful=True`` drains each replica
        first: in-flight work finishes, queued work gets the retryable
        ``Draining``)."""
        self._stop_event.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=10.0)
        rollout = self._rollout
        if rollout is not None:
            try:
                rollout.shutdown()
            except Exception:
                pass
        with ThreadPoolExecutor(max_workers=len(self._replicas), thread_name_prefix="raft-router-stop") as ex:
            list(ex.map(lambda rep: rep.stop_engine(graceful=graceful, timeout=timeout), self._replicas))
        for rep in self._replicas:
            rep.state = ReplicaState.STOPPED
        self._probe_pool.shutdown(wait=False)
        self._started = False

    def __enter__(self) -> "ServeRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- public serving API (the single-engine surface) --------------------

    def submit(self, image1, image2, *, deadline_ms: Optional[float] = None,
               num_flow_updates: Optional[int] = None, trace_ctx: Optional[TraceContext] = None,
               priority: Optional[str] = None, tenant: Optional[str] = None, init_flow=None) -> ServeResult:
        """Serve one pair on the least-loaded healthy replica; re-routes
        across replicas on replica faults, sheds only when every healthy
        replica shed. ``trace_ctx`` threads a trace born elsewhere through
        the pick and the replica's dispatch; ``priority`` / ``tenant`` ride
        to the replica engine; ``init_flow`` (a warm-start seed) rides only
        when given, so engines without the kwarg keep working, and never
        through the mirror seam: a candidate may not seed, and a mirror
        failing on a hint would read as a candidate fault."""
        deadline = self._resolve_deadline(deadline_ms)
        kw: Dict[str, Any] = {} if trace_ctx is None else {"trace_ctx": trace_ctx}
        if priority is not None:
            kw["priority"] = priority
        if tenant is not None:
            kw["tenant"] = tenant

        # **mkw is the mirror seam: the rollout controller replays this
        # closure against the candidate engine with shadow=True; live
        # dispatch passes nothing through it
        def _call(eng, rem, **mkw):
            skw = dict(kw)
            if init_flow is not None and not mkw.get("shadow"):
                skw["init_flow"] = init_flow
            return eng.submit(image1, image2, deadline_ms=rem, num_flow_updates=num_flow_updates, **skw, **mkw)

        return self._dispatch("pair", _call, deadline, trace_ctx=trace_ctx, priority=priority)

    def _tiled_planner(self) -> Optional[TilePlanner]:
        """Lazy router-side mirror of the replicas' tile planner, built from
        the first healthy replica's config. Every replica of a fleet shares
        one ServeConfig, so the mirror plans exactly as the engines do."""
        with self._lock:
            if self._tiler is not None:
                return self._tiler
        for rep in self._healthy():
            cfg = getattr(rep.engine, "config", None)
            if cfg is None:
                continue
            tiler = TilePlanner(
                cfg.buckets, overlap_px=cfg.tile_overlap_px, pad_penalty=cfg.tile_pad_penalty,
                max_tiles=cfg.tile_max_tiles,
            )
            with self._lock:
                if self._tiler is None:
                    self._tiler = tiler
                    self._tiler_cap = cfg.queue_capacity
                return self._tiler
        return None

    def submit_tiled(self, image1, image2, *, deadline_ms: Optional[float] = None,
                     num_flow_updates: Optional[int] = None, trace_ctx: Optional[TraceContext] = None,
                     priority: Optional[str] = None, tenant: Optional[str] = None) -> ServeResult:
        """Serve an off-bucket pair tiled, affinity first.

        Default arm: the whole plan rides ONE replica's
        :meth:`ServeEngine.submit_tiled` (one ``put_many`` acquisition, one
        blend). The fan-out arm (per-tile dispatch across replicas, blended
        by the router) engages only when one replica's queue cannot hold
        the plan (``n_tiles > queue_capacity``).
        """
        deadline = self._resolve_deadline(deadline_ms)
        kw: Dict[str, Any] = {}
        if priority is not None:
            kw["priority"] = priority
        if tenant is not None:
            kw["tenant"] = tenant
        plan = None
        tiler = self._tiled_planner()
        a1 = np.asarray(image1)
        if tiler is not None and a1.ndim == 3:
            plan = tiler.plan((int(a1.shape[0]), int(a1.shape[1])))  # ShapeRejected when infeasible
        if plan is not None and plan.n_tiles > max(1, self._tiler_cap):
            return self._submit_tiled_fanout(
                image1, image2, plan, tiler, deadline, num_flow_updates=num_flow_updates, trace_ctx=trace_ctx, **kw,
            )
        skw = dict(kw)
        if trace_ctx is not None:
            skw["trace_ctx"] = trace_ctx

        def _call(eng, rem, **mkw):
            fn = getattr(eng, "submit_tiled", None) or eng.submit
            return fn(image1, image2, deadline_ms=rem, num_flow_updates=num_flow_updates, **skw, **mkw)

        self._counters["tiled_routed"] += 1
        return self._dispatch("tiled", _call, deadline, trace_ctx=trace_ctx, priority=priority)

    def _submit_tiled_fanout(self, image1, image2, plan, tiler, deadline, *, num_flow_updates=None,
                             trace_ctx=None, **kw) -> ServeResult:
        """Per-tile cross-replica fan-out + router-side blend: the spill arm
        for plans too large for any single replica's queue. Tiles ride the
        ordinary :meth:`submit` dispatch (re-routing, shedding and QoS all
        apply per tile); one failed tile fails the request with its typed
        error."""
        self._counters["tiled_fanout"] += 1
        a1, a2 = np.asarray(image1), np.asarray(image2)
        t0 = time.monotonic()

        def one(t):
            rem = max(1.0, (deadline - time.monotonic()) * 1e3)
            return self.submit(
                a1[t.y0:t.y0 + t.h, t.x0:t.x0 + t.w], a2[t.y0:t.y0 + t.h, t.x0:t.x0 + t.w],
                deadline_ms=rem, num_flow_updates=num_flow_updates, trace_ctx=trace_ctx, **kw,
            )

        with ThreadPoolExecutor(max_workers=min(8, plan.n_tiles), thread_name_prefix="raft-router-tile") as ex:
            results = list(ex.map(one, plan.tiles))
        flow = blend_tiles(plan, tiler.weights(plan), [r.flow for r in results])
        return ServeResult(
            flow=flow,
            rid=results[0].rid,
            bucket=plan.bucket,
            num_flow_updates=min(r.num_flow_updates for r in results),
            level=max(r.level for r in results),
            degraded=any(r.degraded for r in results),
            latency_ms=(time.monotonic() - t0) * 1e3,
            exit_reason="target",
            trace_id=None if trace_ctx is None else trace_ctx.trace_id,
            tiled=True,
            tiles=plan.n_tiles,
        )

    def open_stream(self) -> RouterStream:
        """Open a routed stream session (consistent-hash affinity)."""
        self._check_started()
        with self._lock:
            sid = self._next_sid
            self._next_sid += 1
            self._counters["streams_opened"] += 1
        return RouterStream(self, sid)

    def submit_frame(self, stream_id: int, frame, *, deadline_ms: Optional[float] = None,
                     num_flow_updates: Optional[int] = None, trace_ctx: Optional[TraceContext] = None,
                     priority: Optional[str] = None, tenant: Optional[str] = None) -> ServeResult:
        """Advance a routed stream by one frame on its affinity replica.

        Sticky: the frame goes to the ring's home for this stream (where
        the previous frame's features are cached). On a replica fault the
        stream migrates to the new ring home and re-primes (one ``primed``
        result). ``Overloaded`` from the home is raised to the caller rather
        than spilled: spilling would thrash the encoder cache under exactly
        the load that makes the cache matter.
        """
        deadline = self._resolve_deadline(deadline_ms)
        kw: Dict[str, Any] = {} if trace_ctx is None else {"trace_ctx": trace_ctx}
        if priority is not None:
            kw["priority"] = priority
        if tenant is not None:
            kw["tenant"] = tenant
        return self._dispatch(
            "stream",
            lambda eng, rem, **mkw: eng.submit_frame(
                stream_id, frame, deadline_ms=rem, num_flow_updates=num_flow_updates, **kw, **mkw,
            ),
            deadline,
            sticky_sid=stream_id,
            trace_ctx=trace_ctx,
            priority=priority,
        )

    def close_stream(self, stream_id: int) -> None:
        with self._lock:
            self._stream_homes.pop(stream_id, None)
            self._affinity.pop(stream_id, None)
            visited = self._stream_visited.pop(stream_id, set())
            reps = [self._by_id[h] for h in visited if h in self._by_id]
        # clear EVERY home the stream ever touched, not just the last one:
        # a drain window can leave cached frame state on an interim home
        for rep in reps:
            self._close_stream_on(rep, stream_id)
        # a mirrored stream keeps shadow state on the candidate too
        rollout = self._rollout
        if rollout is not None:
            self._close_stream_on(rollout.candidate, stream_id)

    def _close_stream_on(self, rep: Replica, stream_id: int) -> None:
        """Best-effort drop of one replica's cached state for a stream (a
        dying home loses its cache anyway)."""
        eng = rep.engine
        if eng is None:
            return
        try:
            eng.close_stream(stream_id)
        except Exception:
            pass

    def health(self) -> dict:
        """Aggregate liveness: healthy iff any replica serves."""
        with self._lock:
            snaps = {
                rep.replica_id: dict(rep.snapshot(), ring=rep.replica_id in self._ring.members())
                for rep in self._replicas
            }
        healthy = [rid for rid, s in snaps.items() if s["state"] == ReplicaState.HEALTHY]
        return {
            "ready": self._started and bool(healthy),
            "healthy": self._started and bool(healthy),
            "healthy_count": len(healthy),
            "replica_count": len(self._replicas),
            "replicas": snaps,
        }

    def stats(self) -> dict:
        """Router counters + per-replica snapshots and engine stats + an
        ``aggregate`` block (engine counters summed across replicas, waste
        fractions recomputed from the summed numerators)."""
        with self._lock:
            counters = dict(self._counters)
            qos_all_shed = dict(self._qos_all_shed)
        per_replica: Dict[str, Any] = {}
        engine_stats: Dict[str, dict] = {}
        for rep in list(self._replicas):
            per_replica[rep.replica_id] = rep.snapshot()
            if rep.engine is not None:
                try:
                    engine_stats[rep.replica_id] = rep.engine.stats()
                except Exception:
                    pass  # a broken replica has no stats to give
        agg: Dict[str, Any] = {}
        for st in engine_stats.values():
            for k, v in st.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                agg[k] = agg.get(k, 0) + v
        disp_si = agg.get("dispatched_slot_iters", 0)
        disp_rows = agg.get("dispatched_rows", 0)
        if disp_si:
            agg["padding_waste"] = agg.get("idle_slot_iters", 0) / disp_si
        elif disp_rows:
            agg["padding_waste"] = agg.get("padded_rows", 0) / disp_rows
        else:
            agg["padding_waste"] = 0.0
        hits, misses = agg.get("encode_cache_hits", 0), agg.get("encode_cache_misses", 0)
        agg["encoder_cache_hit_rate"] = hits / (hits + misses) if hits + misses else None
        # fleet QoS view: per-class engine counters summed across replicas
        # (quantiles don't sum: read them per engine), tenant quota state
        # merged, plus the router's own per-class all-replicas-shed tally;
        # enabled iff ANY replica enforces
        qos: Dict[str, Any] = {"enabled": False, "shed_all_replicas": qos_all_shed, "classes": {}, "tenants": {}}
        for st in engine_stats.values():
            q = st.get("qos")
            if not isinstance(q, dict):
                continue
            qos["enabled"] = qos["enabled"] or bool(q.get("enabled"))
            for cls, cstats in (q.get("classes") or {}).items():
                dst = qos["classes"].setdefault(cls, {})
                for k, v in (cstats or {}).items():
                    if k in ("p50_ms", "p99_ms") or isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    dst[k] = dst.get(k, 0) + v
            for ten, tstats in (q.get("tenants") or {}).items():
                dst = qos["tenants"].setdefault(ten, {})
                for k, v in (tstats or {}).items():
                    if isinstance(v, bool) or not isinstance(v, (int, float)):
                        continue
                    dst[k] = dst.get(k, 0) + v
        autoscaler = self._autoscaler
        try:
            asc = autoscaler.snapshot() if autoscaler is not None else {"attached": False}
        except Exception:
            asc = {"attached": autoscaler is not None}
        # the rollout view: always present; no candidate ever added reads
        # {"active": False}. The candidate's numbers live ONLY here: it is
        # outside self._replicas, so nothing above (aggregate, qos,
        # per-replica) carries its load into the sizing signals
        rollout = self._rollout
        try:
            ro_snap = rollout.snapshot() if rollout is not None else {"active": False}
        except Exception:
            ro_snap = {"active": rollout is not None}
        return {
            "router": counters,
            "replica_count": len(self._replicas),
            "replicas": per_replica,
            "engines": engine_stats,
            "aggregate": agg,
            "obs": {"events_recorded": self.recorder.events_recorded, "postmortem_dumps": self.recorder.dumps},
            "alerts": self._alerts.snapshot(),
            "autoscaler": asc,
            "qos": qos,
            "rollout": ro_snap,
        }

    def alerts(self) -> Dict[str, Any]:
        """The tier's burn-rate alert surface: the router's own active
        alerts plus every live replica engine's."""
        out = self._alerts.snapshot()
        out["active"] = self._alerts.active()
        engines: Dict[str, Any] = {}
        for rep in list(self._replicas):
            eng = rep.engine
            if eng is None:
                continue
            try:
                engines[rep.replica_id] = eng.alerts()
            except Exception:
                pass  # a broken replica has no alerts to give
        out["engines"] = engines
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition: the router's registry + every live
        replica's engine registry, each replica's series labelled
        ``replica="rN"`` (N replicas expose the same names), in one
        scrape. A live rollout candidate's series carry
        ``replica="candidate"``; they are not the fleet's, so a rule that
        sums over ``replica=`` must leave it out."""
        parts = [self.metrics.prometheus_text()]
        for rep in list(self._replicas):
            eng = rep.engine
            if eng is not None:
                try:
                    parts.append(relabel_prometheus(eng.prometheus(), replica=rep.replica_id))
                except Exception:
                    pass
        rollout = self._rollout
        eng = None if rollout is None else rollout.candidate.engine
        if eng is not None:
            try:
                parts.append(relabel_prometheus(eng.prometheus(), replica="candidate"))
            except Exception:
                pass
        return "".join(parts)

    def dump_postmortem(self, reason: str, extra: Optional[dict] = None) -> dict:
        """Freeze the tier's state into a postmortem bundle: the router's
        lifecycle events, the replicas' most recent request traces (pulled
        from each engine's tracer at dump time), per-replica snapshots and
        each live engine's own recent flight-recorder events. Invoked on
        every eviction; callable any time."""
        engines_extra: Dict[str, Any] = {}
        for rep in list(self._replicas):
            eng = rep.engine
            if eng is None:
                continue
            try:
                for rec in eng.tracer.snapshot()[-16:]:
                    self.recorder.add_trace(rec)
                engines_extra[rep.replica_id] = {"events": eng.recorder.events()[-32:], "generation": rep.generation}
            except Exception:
                pass  # a broken replica contributes nothing, blocks nothing
        with self._lock:
            replicas = {rep.replica_id: rep.snapshot() for rep in self._replicas}
        return self.recorder.dump(reason, extra=dict({"replicas": replicas, "engines": engines_extra}, **(extra or {})))

    # -- dispatch ----------------------------------------------------------

    def _check_started(self) -> None:
        if not self._started:
            raise ServeError("router is not running (call start())")

    def _resolve_deadline(self, deadline_ms: Optional[float]) -> float:
        self._check_started()
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms
        if deadline_ms <= 0:
            raise InvalidInput(f"deadline_ms must be positive, got {deadline_ms}")
        return time.monotonic() + deadline_ms / 1e3

    def _ring_add(self, replica_id: str) -> None:
        """Every ring mutation comes through here (caller holds the router
        lock): membership changed, so the stream-affinity cache is stale."""
        self._ring.add(replica_id)
        self._affinity.clear()

    def _ring_remove(self, replica_id: str) -> None:
        self._ring.remove(replica_id)
        self._affinity.clear()

    def _healthy(self, exclude=()) -> List[Replica]:
        with self._lock:
            return [r for r in self._replicas if r.state == ReplicaState.HEALTHY and r.replica_id not in exclude]

    def _score(self, rep: Replica) -> float:
        """Dispatch score, read (not probed) per request: the heartbeat's
        ``score_base`` (queue fullness + degradation level, ``inf`` for a
        draining engine), a shed's nudge, and the router's own outstanding
        count as the idle-fleet tiebreak."""
        return rep.score_base + 0.01 * rep.inflight

    def _pick(self, exclude=()) -> Optional[Replica]:
        # lock-free read: the list mutates only under the router lock, and
        # a stale element at worst scores a replica the state check rejects
        best, best_score = None, float("inf")
        for rep in self._replicas:
            if rep.state != ReplicaState.HEALTHY or rep.replica_id in exclude:
                continue
            s = self._score(rep)
            if s < best_score:
                best, best_score = rep, s
        return best

    def _pick_sticky(self, stream_id: int, exclude=()) -> Optional[Replica]:
        # fast path: the cached ring home (one dict get, no md5, no lock);
        # a concurrent clear at worst misses into the recompute below
        home = self._affinity.get(stream_id)
        if home is None:
            with self._lock:
                home = self._ring.lookup(str(stream_id))
                if home is not None:
                    self._affinity[stream_id] = home
        if home is None or home in exclude:
            return None
        rep = self._by_id.get(home)
        if rep is None or rep.state != ReplicaState.HEALTHY:
            return None
        return rep

    def _dispatch(self, kind: str, fn, deadline: float, *, sticky_sid: Optional[int] = None,
                  trace_ctx: Optional[TraceContext] = None, priority: Optional[str] = None) -> ServeResult:
        """The routing loop: pick, dispatch, classify, maybe re-route."""
        # the sheds' retry hints and the last fault's repr, never the
        # exceptions: one held in a local of this frame, which its own
        # traceback holds, would keep the frame, this router and the failed
        # engine's frames alive until a garbage collection
        tried: set = set()
        sheds: List[float] = []
        last_err: Optional[str] = None
        max_attempts = self.config.max_attempts or len(self._replicas)
        edge_trace = None if trace_ctx is None else trace_ctx.trace
        # the canary pick: during the canary stage the rollout claims a
        # deterministic fraction of pair dispatches for the candidate. The
        # claimed attempt rides the SAME loop below (one extra attempt
        # granted): a candidate shed or fault falls through to the
        # incumbents, so a canary request is re-served, never dropped
        ro = self._rollout
        canary_rep = ro.maybe_canary_pick(kind) if ro is not None and sticky_sid is None else None
        if canary_rep is not None:
            max_attempts += 1
        for attempt in range(max_attempts):
            remaining_ms = (deadline - time.monotonic()) * 1e3
            if remaining_ms <= 0:
                break
            t_pick = time.monotonic()
            if canary_rep is not None and canary_rep.replica_id not in tried:
                rep = canary_rep
            elif sticky_sid is not None:
                rep = self._pick_sticky(sticky_sid, tried)
            else:
                rep = self._pick(tried)
            if rep is None:
                break
            was_canary = rep is canary_rep
            if edge_trace is not None:
                # the routing decision joins the propagated trace
                edge_trace.add_span("route_pick", t_pick, proc="router", replica=rep.replica_id, attempt=attempt + 1)
            tried.add(rep.replica_id)
            if attempt > 0:
                with self._lock:
                    self._counters["rerouted"] += 1
            with rep._lock:
                rep.inflight += 1
            try:
                self._before_dispatch(rep, kind)
                eng = rep.engine
                if eng is None:  # between engines (a rebuild lets go of the old one first)
                    raise EngineStopped(f"replica {rep.replica_id} is rebuilding")
                res = fn(eng, remaining_ms)
            except Draining as e:
                # the replica is leaving, not loaded: migrate everything,
                # sticky streams included (the ring already dropped a
                # router-drained replica, so the re-pick lands elsewhere)
                rep.note_shed(priority)
                sheds.append(e.retry_after_ms)
                if was_canary:
                    ro.note_canary_outcome(False, None, None)
                continue
            except Overloaded as e:
                # shed: the replica is fine, just full; not an error-budget
                # event, but score feedback between heartbeats
                rep.note_shed(priority)
                sheds.append(e.retry_after_ms)
                if was_canary:
                    ro.note_canary_outcome(False, None, None)
                if sticky_sid is not None:
                    raise  # sticky: never spill a stream for load
                continue
            except (InvalidInput, PoisonedInput):
                raise  # terminal: the request's own fault, never re-routed
            except DeadlineExceeded:
                # not an error-budget event: deadline misses under load are
                # correlated across replicas, and counting them would turn
                # a load spike into a fleet-wide eviction
                rep.note_deadline_miss()
                if was_canary:
                    ro.note_canary_outcome(False, None, None)
                raise  # the caller's deadline is global; a retry cannot win
            except Exception as e:
                rep.note_error()
                last_err = repr(e)
                if was_canary:
                    ro.note_canary_outcome(False, None, None)
                self._on_dispatch_fault(rep, e)
                continue
            else:
                rep.note_ok()
                if was_canary:
                    ro.note_canary_outcome(True, res.latency_ms, res.num_flow_updates)
                if sticky_sid is not None:
                    self._note_stream_home(sticky_sid, rep.replica_id)
                with self._lock:
                    self._counters["routed"] += 1
                    self._counters["completed"] += 1
                if attempt > 0:
                    # the request survived a replica fault: link the landing
                    # replica to the request's engine trace
                    tid = getattr(res, "trace_id", None)
                    self.recorder.record(
                        "reroute", replica=rep.replica_id, req_kind=kind, attempts=attempt + 1, trace_id=tid,
                    )
                    if tid is not None:
                        rec = rep.engine.tracer.find(tid)
                        if rec is not None:
                            self.recorder.add_trace(rec)
                if ro is not None and not was_canary:
                    # mirror after the reply: the live result exists and the
                    # caller's latency is banked; the closure goes to the
                    # rollout's bounded mirror queue (a full queue sheds)
                    ro.maybe_mirror(kind, fn, res)
                return res
            finally:
                with rep._lock:
                    rep.inflight -= 1
        # exhausted: classify the collective failure
        if sheds:
            cls = priority or "default"
            with self._lock:
                self._counters["shed_all_replicas"] += 1
                self._qos_all_shed[cls] = self._qos_all_shed.get(cls, 0) + 1
            retry_ms = min(sheds)
            raise Overloaded(
                f"all {len(sheds)} reachable replicas shed this request; retry in ~{retry_ms:.0f}ms",
                retry_after_ms=retry_ms,
            )
        if last_err is not None:
            raise ServeError(f"request failed on all {len(tried)} attempted replicas; last error: {last_err}")
        if (deadline - time.monotonic()) <= 0 and tried:
            raise DeadlineExceeded("request deadline expired while re-routing across replicas")
        with self._lock:
            self._counters["no_healthy_replicas"] += 1
        raise Overloaded(
            "no healthy replica available (all evicted or draining); retry after cooldown",
            retry_after_ms=self.config.cooldown_s * 1e3 / 2,
        )

    def _note_stream_home(self, sid: int, replica_id: str) -> None:
        prev_rep: Optional[Replica] = None
        with self._lock:
            prev = self._stream_homes.get(sid)
            self._stream_homes[sid] = replica_id
            self._stream_visited.setdefault(sid, set()).add(replica_id)
            if prev is not None and prev != replica_id:
                self._counters["stream_remaps"] += 1
                prev_rep = self._by_id.get(prev)
        if prev_rep is not None:
            # the old home's cached frame must not survive the remap: were
            # the stream mapped back there, a stale frame would pair with
            # the next one (wrong flow instead of a re-prime)
            self._close_stream_on(prev_rep, sid)

    def _on_dispatch_fault(self, rep: Replica, err: BaseException) -> None:
        """Dispatch-path eviction triggers (prompter than the monitor): a
        stopped engine evicts at once; repeated faults evict once the error
        window is full and over budget."""
        if isinstance(err, EngineStopped):
            self._evict(rep, "engine stopped")
        elif rep.window_full() and rep.error_rate() > self.config.error_rate_budget:
            self._evict(rep, f"error rate {rep.error_rate():.2f}")

    # -- health monitor ----------------------------------------------------

    def _probe_health(self, rep: Replica) -> dict:
        """Heartbeat seam (``FaultInjector.patch_router`` wraps it): one
        replica's ``engine.health()``, run on a probe thread."""
        return rep.engine.health()

    def _before_dispatch(self, rep: Replica, kind: str) -> None:
        """Dispatch seam (``FaultInjector.patch_router`` wraps it): fired on
        the caller's thread just before the replica dispatch."""

    def _monitor(self) -> None:
        """Beat every ``heartbeat_interval_s`` until the router closes."""
        while not self._stop_event.wait(self.config.heartbeat_interval_s):
            self._beat()

    def _beat(self) -> None:
        """One monitor beat: heartbeat every replica, evict on the health
        ladder, probe evicted replicas back in after cooldown; then the
        alerts, the autoscaler, and the rollout (its candidate's heartbeat,
        then one control beat). Survives any per-probe failure."""
        for rep in list(self._replicas):
            try:
                if rep.state == ReplicaState.HEALTHY:
                    self._heartbeat(rep)
                elif rep.state == ReplicaState.UNHEALTHY and time.monotonic() >= rep.cooldown_until:
                    self._readmit(rep)
            except Exception:
                pass  # the monitor never dies; the next beat retries
        self._alerts.maybe_observe()
        autoscaler = self._autoscaler
        if autoscaler is not None:
            try:
                autoscaler.maybe_evaluate()
            except Exception:
                pass  # sizing never takes down health monitoring
        rollout = self._rollout
        if rollout is not None:
            # the candidate rides the fleet's heartbeat-to-evict ladder (a
            # crash becomes an eviction, which the controller turns into a
            # rollback); then the gate verdict, the stage clock, promotion
            try:
                cand = rollout.candidate
                if cand.state == ReplicaState.HEALTHY and rollout.stage not in RolloutStage.TERMINAL:
                    self._heartbeat(cand)
                rollout.maybe_observe()
            except Exception:
                pass  # rollouts never take down health monitoring

    def _heartbeat(self, rep: Replica) -> None:
        fut = self._probe_pool.submit(self._probe_health, rep)
        try:
            h = fut.result(timeout=self.config.heartbeat_timeout_s)
        except Exception:
            with self._lock:
                self._counters["heartbeat_misses"] += 1
            self.recorder.record("heartbeat_miss", replica=rep.replica_id, age_s=time.monotonic() - rep.last_heartbeat)
            if time.monotonic() - rep.last_heartbeat >= self.config.heartbeat_timeout_s:
                self._evict(rep, "heartbeat stalled")
            return
        if not h.get("healthy", False):
            self._evict(rep, "reported unhealthy")
            return
        # the dispatch score, once per beat; an engine draining on its own
        # prices itself out here
        if h.get("draining", False):
            rep.score_base = float("inf")
        else:
            depth = h.get("queue_depth", 0) / max(1, h.get("queue_capacity", 1))
            rep.score_base = depth + 0.1 * h.get("level", 0)
        rep.last_heartbeat = time.monotonic()
        trips = int(h.get("watchdog_trips", 0))
        if rep.trip_delta(trips) >= self.config.watchdog_trip_budget:
            self._evict(rep, "watchdog trip budget")
        elif rep.window_full() and rep.error_rate() > self.config.error_rate_budget:
            self._evict(rep, f"error rate {rep.error_rate():.2f}")

    def _evict(self, rep: Replica, reason: str) -> None:
        """Mark unhealthy, leave the ring, fail its queued work fast (the
        blocked callers' dispatch loops then re-route it), start cooldown."""
        with self._lock:
            if rep.state != ReplicaState.HEALTHY:
                return
            rep.state = ReplicaState.UNHEALTHY
            rep.evictions += 1
            rep.last_evict_reason = reason
            rep.cooldown_until = time.monotonic() + self.config.cooldown_s
            self._ring_remove(rep.replica_id)
            self._counters["evictions"] += 1
        self._log()
        self.recorder.record("evict", replica=rep.replica_id, reason=reason, generation=rep.generation)
        # an eviction is exactly the incident the flight recorder exists for
        self.dump_postmortem(f"evict:{rep.replica_id}")
        # a process-backed replica also dumps ITS OWN recorder into the
        # parent's dump directory while it still can (a worker killed
        # outright has nothing left to say: best-effort)
        rep.dump_worker_postmortem(f"evict:{rep.replica_id}:{reason}")
        # rescue queued work off-thread: stop() fails every pending request
        # (EngineStopped, retryable at the router) and may block joining a
        # wedged worker; never block the monitor or a dispatch on it
        threading.Thread(target=rep.stop_engine, name=f"raft-evict-{rep.replica_id}", daemon=True).start()

    def _readmit(self, rep: Replica) -> None:
        """Cooldown expired: probe the replica back in, rebuilding the engine
        from the factory when it did not survive eviction.

        The transition is a CAS under the router lock: only an UNHEALTHY
        replica is claimed (to STARTING for a rebuild, or straight to
        HEALTHY when the engine survived), so a concurrent
        ``restart_replica``, which claims DRAINING under the same lock and
        refuses STARTING, can never build a second engine for the replica.
        """
        eng = rep.engine
        try:
            alive = eng is not None and bool(eng.health().get("healthy", False))
        except Exception:
            alive = False
        del eng  # a rebuild below lets go of the old engine: hold nothing of it here
        with self._lock:
            if rep.state != ReplicaState.UNHEALTHY:
                return  # claimed by restart_replica under the lock
            if alive:
                rep.state = ReplicaState.HEALTHY
                rep.last_heartbeat = time.monotonic()
                self._ring_add(rep.replica_id)
                self._counters["readmissions"] += 1
            else:
                rep.state = ReplicaState.STARTING
        if alive:
            self._log()
            self.recorder.record("readmit", replica=rep.replica_id, rebuilt=False, generation=rep.generation)
            return
        try:
            rep.stop_engine(graceful=False)
            rep.start()
        except Exception as e:
            with self._lock:
                rep.state = ReplicaState.UNHEALTHY
                rep.last_evict_reason = f"readmit failed: {e!r}"
                rep.cooldown_until = time.monotonic() + self.config.cooldown_s
            self.recorder.record("readmit_failed", replica=rep.replica_id, error=repr(e))
            return
        with self._lock:
            rep.last_heartbeat = time.monotonic()
            self._ring_add(rep.replica_id)
            self._counters["readmissions"] += 1
        self._log()
        self.recorder.record("readmit", replica=rep.replica_id, rebuilt=True, generation=rep.generation)

    # -- fleet sizing (the autoscaler's two verbs) -------------------------

    def attach_autoscaler(self, autoscaler) -> None:
        """Wire an :class:`~raft_tpu_torch.serve.autoscale.Autoscaler`: the
        monitor loop calls its ``maybe_evaluate`` each beat."""
        self._autoscaler = autoscaler

    def add_replica(self, *, reason: Optional[str] = None, signals: Optional[Dict[str, Any]] = None) -> str:
        """Grow the fleet by one replica cloned from the first replica's
        factory, backend and worker options, and boot it. A replica that
        fails to boot is left evicted (probed back in after cooldown).
        Returns the new replica id.
        ``reason``/``signals`` (from the autoscaler) ride the scale_up
        flight-recorder event."""
        self._check_started()
        with self._lock:
            proto = self._replicas[0]
            i = len(self._replicas)
            while f"r{i}" in self._by_id:
                i += 1
            rep = Replica(f"r{i}", proto.factory, error_window=self.config.error_window, backend=proto.backend,
                          worker_options=proto.worker_options)
            self._replicas.append(rep)
            self._by_id[rep.replica_id] = rep
        self.recorder.record("scale_up", replica=rep.replica_id, reason=reason, signals=signals)
        try:
            rep.start()
        except Exception as e:
            with self._lock:
                rep.state = ReplicaState.UNHEALTHY
                rep.last_evict_reason = f"scale-up boot failed: {e!r}"
                rep.cooldown_until = time.monotonic() + self.config.cooldown_s
            self.recorder.record("scale_up_failed", replica=rep.replica_id, error=repr(e))
            return rep.replica_id
        with self._lock:
            rep.last_heartbeat = time.monotonic()
            self._ring_add(rep.replica_id)
        self._log()
        return rep.replica_id

    def add_remote_replica(self, endpoint: str, **kw) -> str:
        """Join a remote TCP worker: not ported yet."""
        raise NotImplementedError(
            "remote replicas (a worker behind TCP) are not ported yet: "
            "ROADMAP queue 1 item 4b-ii, the TCP remote arm"
        )

    def remove_replica(self, replica_id: str, *, drain: bool = True, reason: Optional[str] = None,
                       signals: Optional[Dict[str, Any]] = None) -> None:
        """Shrink the fleet by one replica, draining it first by default
        (in-flight work finishes, queued work re-routes via ``Draining``,
        ~1/N streams remap)."""
        rep = self._by_id.get(replica_id)
        if rep is None:
            raise ValueError(f"unknown replica {replica_id!r}")
        with self._lock:
            if len(self._replicas) <= 1:
                raise ServeError("cannot remove the last replica")
            if rep.state == ReplicaState.DRAINING:
                raise ServeError(f"replica {replica_id} is already draining")
            rep.state = ReplicaState.DRAINING
            self._ring_remove(rep.replica_id)
        self.recorder.record(
            "scale_down", replica=replica_id, drain=drain, generation=rep.generation, reason=reason, signals=signals,
        )
        try:
            rep.stop_engine(graceful=drain, timeout=self.config.drain_timeout_s)
        finally:
            with self._lock:
                rep.state = ReplicaState.STOPPED
                self._by_id.pop(replica_id, None)
                try:
                    self._replicas.remove(rep)
                except ValueError:
                    pass
        self._log()

    # -- draining restart --------------------------------------------------

    def restart_replica(self, replica_id: str, *, graceful: bool = True, **overrides) -> None:
        """Drain one replica, rebuild it through its factory (``overrides``
        swap config or weights), boot, re-admit.

        While draining the replica takes no new work (ring + candidate
        exclusion), in-flight requests finish, and queued ones re-route
        through their callers' dispatch loops: zero accepted requests
        dropped. Streams homed here remap and re-prime on their interim
        home; after re-admission the ring maps them back.
        """
        rep = self._by_id.get(replica_id)
        if rep is None:
            raise ValueError(f"unknown replica {replica_id!r}")
        with self._lock:
            if rep.state not in (ReplicaState.HEALTHY, ReplicaState.UNHEALTHY):
                raise ServeError(f"replica {replica_id} is {rep.state}; cannot restart")
            rep.state = ReplicaState.DRAINING
            self._ring_remove(rep.replica_id)
            self._counters["drains"] += 1
        self._log()
        # the drain phases are recorded here too: the rebuild discards the
        # old engine and its recorder
        self.recorder.record("drain_begin", replica=replica_id, graceful=graceful, generation=rep.generation)
        try:
            rep.stop_engine(graceful=graceful, timeout=self.config.drain_timeout_s)
            self.recorder.record("drain_done", replica=replica_id)
            rep.start(**overrides)
        except Exception as e:
            with self._lock:
                rep.state = ReplicaState.UNHEALTHY
                rep.last_evict_reason = f"restart failed: {e!r}"
                rep.cooldown_until = time.monotonic() + self.config.cooldown_s
            self.recorder.record("restart_failed", replica=replica_id, error=repr(e))
            raise ServeError(f"draining restart of {replica_id} failed: {e!r}") from e
        with self._lock:
            rep.state = ReplicaState.HEALTHY
            rep.last_heartbeat = time.monotonic()
            self._ring_add(rep.replica_id)
            self._counters["restarts"] += 1
        self._log()
        self.recorder.record("restart_done", replica=replica_id, generation=rep.generation)
        # the weights may have moved: anything keyed on the old
        # variables_hash must drop its state now
        self._fire_weights_listeners(replica_id=replica_id, generation=rep.generation)

    # -- guarded rollout ---------------------------------------------------

    @property
    def rollout(self) -> Optional[RolloutController]:
        """The current (possibly terminal) rollout ladder, or None."""
        return self._rollout

    def _rollout_active(self) -> float:
        """The ``rollout_active`` gauge: 1 while a ladder is live."""
        rollout = self._rollout
        return 1.0 if rollout is not None and rollout.stage not in RolloutStage.TERMINAL else 0.0

    def add_candidate(self, factory: Optional[Callable[..., ServeEngine]] = None, *,
                      rollout_config: Optional[RolloutConfig] = None, backend: Optional[str] = None,
                      worker_options: Optional[Dict[str, Any]] = None, **overrides) -> RolloutController:
        """Boot a candidate replica and start the guarded rollout ladder
        (shadow -> canary -> promoted, automatic rollback on a breach).

        ``factory`` / ``overrides`` say what is trialled: by default the
        first replica's factory with ``overrides`` applied (a config
        trial, exactly what a promotion replays through
        ``restart_replica(**overrides)``); pass another ``factory`` to
        trial a new checkpoint. The candidate boots on the caller's thread
        (on the card its warm-up takes its turn with any other boot) and
        lives OUTSIDE the replica list: it takes no live traffic until the
        canary stage, and its load never reaches QoS quotas or the
        autoscaler's signals. ``backend`` and ``worker_options`` default to
        the first replica's: a process candidate boots its own worker (its
        mirrors cannot carry ``shadow=``, so they land in that worker's own
        counters); ``backend='remote'`` raises ``NotImplementedError``
        (ROADMAP queue 1 item 4b-ii). Returns the
        :class:`~raft_tpu_torch.serve.rollout.RolloutController`; its
        ``wait()`` blocks until promotion (the final snapshot) or rollback
        (:class:`~raft_tpu_torch.serve.errors.RolloutAborted`).
        """
        self._check_started()
        with self._lock:
            current = self._rollout
            if self._rollout_pending or (current is not None and current.stage not in RolloutStage.TERMINAL):
                stage = "booting" if self._rollout_pending else current.stage
                raise ServeError(
                    f"a rollout is already {stage}; wait for it to terminate (or roll it back) before starting "
                    f"another"
                )
            # reserve the slot while holding the lock: the boot below is
            # slow and lock-free, and a concurrent add_candidate must fail
            # here, not orphan a booted candidate
            self._rollout_pending = True
        try:
            with self._lock:
                proto = self._replicas[0]
                cand = Replica("candidate", factory or proto.factory, error_window=self.config.error_window,
                               backend=backend or proto.backend,
                               worker_options=proto.worker_options if worker_options is None else worker_options)
            self.recorder.record("rollout_candidate", backend=cand.backend, overrides=sorted(overrides))
            # the boot error's repr, never the error: its traceback holds the
            # failed engine's frames
            boot_error = None
            try:
                cand.start(**overrides)
            except Exception as e:
                boot_error = repr(e)
            if boot_error is not None:
                self.recorder.record("rollout_candidate_failed", error=boot_error)
                cand.stop_engine()
                cand.engine = None
                raise ServeError(f"candidate failed to boot: {boot_error}")
            controller = RolloutController(self, cand, overrides, rollout_config)
        except BaseException:
            with self._lock:
                self._rollout_pending = False
            raise
        with self._lock:
            self._rollout = controller
            self._rollout_pending = False
        self._log()
        return controller

    # -- accounting --------------------------------------------------------

    def _log(self) -> None:
        """After a lifecycle transition: the router counters through the
        scalar MetricLogger (step = total lifecycle transitions)."""
        if self._logger is None:
            return
        with self._lock:
            scalars = {f"router/{k}": float(v) for k, v in self._counters.items()}
            step = self._counters["evictions"] + self._counters["readmissions"] + self._counters["restarts"]
        try:
            self._logger.log(step, scalars)
        except Exception:
            pass  # telemetry must never take down routing
