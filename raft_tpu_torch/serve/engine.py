"""Fault-isolated serving engine for RAFT optical flow.

The port of the JAX package's ``raft_tpu/serve/engine.py``. One worker
thread owns the device; callers interact only through a bounded
deadline-aware queue and never touch the card (every host-to-device copy
of a request happens on the worker). The ladder of defenses, outermost
first:

  1. **validate** — shape/dtype/nonfinite checked at admission
     (:class:`~raft_tpu_torch.serve.errors.InvalidInput`).
  2. **bucket** — resolutions are closed over a configured bucket set
     (:mod:`raft_tpu_torch.serve.bucketing`); a novel shape is rejected
     or, under ``unknown_shape='slow_path'``, rate-limited and queued
     for the worker, which runs it alone at its natural shape (one graph
     capture per novel shape and iteration count, kept for the engine's
     life), so a capture stampede cannot form behind the batcher.
  3. **shed** — the queue is bounded; excess load fails fast with a
     retryable :class:`~raft_tpu_torch.serve.errors.Overloaded`.
  4. **degrade** — under sustained pressure the controller steps the
     iteration target down the anytime ladder; every response reports
     the level it was served at.
  5. **isolate** — a request whose flow comes back non-finite fails
     alone with :class:`~raft_tpu_torch.serve.errors.PoisonedInput`
     while its neighbours finish; the worker survives any per-dispatch
     failure.

Two engines share this front end:

  * **Resident iteration pool** (``pool_capacity > 0``, the default;
    :mod:`raft_tpu_torch.serve.pool`): the dispatch unit is one GRU
    iteration across a fixed slot array. Each loop retires slots whose
    requests are done (target reached, converged, deadline-driven early
    exit or expired), admits queued requests into freed slots, and
    advances every occupied pool by ONE ``step``. Up to
    ``pipeline_depth`` ticks stay dispatched but unfetched; the pacing
    token (the packed converged mask) is copied to pinned host memory
    behind each tick and read when the window is full. Slots are
    isolated by construction (inference is per sample), so a poisoned
    slot fails alone.
  * **Whole-request engine** (``pool_capacity=0``): a formed batch is
    zero-padded to the next rung of ``config.batch_ladder`` and runs the
    whole forward as one program (the set is closed: ``buckets x
    batch ladder x iteration ladder``). The worker keeps up to
    ``pipeline_depth`` batches dispatched but unfetched, staging batch
    N+1 in rotating pinned host buffers while batch N computes; a
    buffer is rewritten only once an event shows its copy done, and each
    batch's flow is copied to pinned memory right behind its replay. The
    window drains first when load is shed or the queue is past the
    degradation high-watermark. A batch that comes back non-finite is
    retried as singles, so exactly the poisoned request is quarantined.
    This engine serves ``edge``: the int8 pyramid's scale is one a level
    over the whole batch, so its rows cannot move between pool slots.

**Streams** (:meth:`ServeEngine.open_stream`) encode each video frame
once and reuse frame t's feature and context maps as pair (t, t+1)'s
first-frame inputs (``RAFT.encode_frame``, then ``RAFT.iterate`` in the
whole-request engine or ``begin_features`` in the pool). The cached maps
stay on the card. Sessions are LRU-bounded (``stream_cache_size``); a
dropped, expired or poisoned frame invalidates its session, so the next
frame primes again (``flow=None``). With ``stream_warm_start`` (pool
only) the previous pair's 1/8-grid flow, forward-warped, seeds the next
pair's refinement.

On the card every program of the closed set is a CUDA graph
(:mod:`raft_tpu_torch.serve.aot`), captured at ``start()`` with
``warmup=True`` or on the worker at first use, and replayed after; a
failed capture raises and nothing falls back to eager execution. On the
CPU (``device='cpu'``) the same programs run eagerly.

**Tiling** (:meth:`ServeEngine.submit_tiled`; automatic under
``unknown_shape='tiled'``): an off-bucket pair is planned into
bucket-shaped tiles (:mod:`raft_tpu_torch.serve.tiler`), both images are
sliced at the same offsets, the tiles ride ONE ``put_many`` acquisition
through either engine's captured programs (no capture for a new shape),
and their fetched flows are blended on the host.

**QoS** (``qos_enabled``; :mod:`raft_tpu_torch.serve.qos`): every entry
point takes ``priority``/``tenant``. On, a tenant's quota is charged once
a request (a retryable ``QuotaExceeded`` on breach), a full queue
preempts strictly lower classes (the victim finishes with a retryable
``Overloaded``), and under degradation pressure lower classes brown out
first, through ladder rungs only. Per-class accounting
(``stats()['qos']``) runs either way.

**Observability**: per-request traces (``trace_sample_rate``; spans
admit / queue_wait / batch_form / encode / dispatch / fetch, ``refine`` in
the pool; ``trace_id`` on every sampled :class:`ServeResult`; a
``trace_ctx`` joins a trace born elsewhere), a metrics registry with
Prometheus text (:meth:`ServeEngine.prometheus`, with the QoS
``class=``/``tenant=`` series), burn-rate alerts
(:meth:`ServeEngine.alerts`), and a flight recorder
(``engine.recorder``) whose bounded ring of fault-ladder events is dumped
as a postmortem bundle on a page-severity alert or a device-deadline
watchdog trip. ``apply_timeout_s`` guards each dispatch AND the host's
wait on it (a replay returns once it is queued: the stall shows in the
wait); a trip fails the dispatch's requests with ``DeadlineExceeded``
from the watcher thread, resets the pool, and the worker drains the
stream before its next replay, so an abandoned replay's outputs never
reach a later request.

**Shadow traffic** (``shadow=True`` on every entry point and
``submit_many`` item): a rollout's mirrored request is served as any other
but counted only in the ``shadow_*`` twins of ``submitted`` /
``completed`` / ``shed`` / ``expired``; it charges no QoS class and takes
no tenant token, so nothing the autoscaler, the QoS stats or the burn-rate
alerts read moves with mirrored load.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import functools
import hashlib
import math
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.device import resolve_device
from raft_tpu_torch.graphs import rows_like
from raft_tpu_torch.inference import FlowEstimator
from raft_tpu_torch.obs import (
    RESIDUAL_BUCKETS,
    AlertEngine,
    AlertRule,
    DeviceTimeLedger,
    FlightRecorder,
    MetricsRegistry,
    TraceContext,
    Tracer,
    gauge_value,
    logger_sink,
    profile,
    rate,
    ratio_rate,
)
from raft_tpu_torch.serve import aot
from raft_tpu_torch.serve.batch import BatchPrograms
from raft_tpu_torch.serve.bucketing import BucketRouter, TokenBucket
from raft_tpu_torch.serve.config import ServeConfig
from raft_tpu_torch.serve.degradation import DegradationController
from raft_tpu_torch.serve.errors import (
    DeadlineExceeded,
    Draining,
    EngineStopped,
    InvalidInput,
    Overloaded,
    PoisonedInput,
    QuotaExceeded,
    ServeError,
    ShapeRejected,
)
from raft_tpu_torch.serve.pool import (
    RESID_SENTINEL,
    BucketPool,
    PoolPrograms,
    _SlotMeta,
    forward_warp_flow,
    unpack_converged,
    zero_state,
)
from raft_tpu_torch.serve.qos import QosPolicy, QosStats, brownout_level, qos_stats_block, validate_priority
from raft_tpu_torch.serve.queue import MicroBatchQueue, Request
from raft_tpu_torch.serve.tiler import TilePlanner, blend_tiles, nearest_bucket
from raft_tpu_torch.utils.faults import Watchdog

__all__ = ["ServeEngine", "ServeResult", "StreamSession"]

_COUNTERS = (
    "submitted", "completed", "shed", "shed_slow_path", "rejected",
    "invalid", "expired", "quarantined", "retried_singles",
    "nonfinite_batches", "batches", "slow_path", "watchdog_trips", "worker_errors",
    "padded_rows", "dispatched_rows", "encode_cache_hits",
    "encode_cache_misses", "stream_primes", "stream_invalidations",
    "stream_evictions", "inflight_peak", "pool_ticks", "pool_admitted",
    "pool_resets", "idle_slot_iters", "dispatched_slot_iters",
    "early_exit_iters_saved", "early_exits_deadline",
    "early_exits_converged", "early_exit_iters_saved_deadline",
    "early_exit_iters_saved_converged", "stream_warm_starts", "drained",
    # mirrored rollout traffic is counted HERE, never under submitted/
    # completed/shed/expired: the autoscaler, QoS and alert signals those
    # feed must be blind to it
    "shadow_submitted", "shadow_completed", "shadow_shed", "shadow_expired",
)

# one engine warms up at a time in a process: a capture on the card must
# not overlap another engine's warm-up, whose device work between its own
# captures is refused ("operation not permitted when stream is capturing")
# and invalidates the capture under way; the captures take turns anyway
_BOOT_LOCK = threading.Lock()

@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One served request: the flow plus how it was served.

    ``num_flow_updates``/``level`` report the degradation state the
    request actually ran at (``degraded`` is their boolean shadow).
    ``flow`` is ``None`` exactly when ``primed`` is True: the stream frame
    opened (or re-opened, after an invalidation) a pair and there was
    nothing to pair it with yet. ``exit_reason`` says why refinement
    stopped where it did: ``'target'`` (the request's own iteration
    target), ``'deadline'`` (finalized early because the deadline would
    have expired first) or ``'converged'`` (the flow-update residual
    stayed below ``pool_converge_thresh``). ``retried_single``: served
    by the singles retry of a batch that came back non-finite;
    ``warm_started``: the pool seeded its refinement with an
    ``init_flow``. ``tiled``: served as ``tiles`` bucket-shaped tiles
    blended on the host (``num_flow_updates``/``level`` then report the
    most conservative tile: the fewest updates, the highest level).
    ``trace_id``: the id of this request's sampled trace (``None`` when
    tracing is off or the request was not sampled), found in
    ``engine.tracer`` and the flight recorder's ring; ``residuals``
    (pool, traced requests only): the per-iteration flow-update residual
    trajectory (RMS ||delta flow|| in 1/8-grid pixels, oldest first).
    """

    flow: Optional[np.ndarray]       # (H, W, 2) float32, caller resolution
    rid: int
    bucket: Tuple[int, int]
    num_flow_updates: int
    level: int
    degraded: bool
    latency_ms: float
    slow_path: bool = False
    retried_single: bool = False
    primed: bool = False
    exit_reason: str = "target"
    trace_id: Optional[str] = None
    residuals: Optional[Tuple[float, ...]] = None
    warm_started: bool = False
    tiled: bool = False
    tiles: int = 0

    @property
    def early_exit(self) -> bool:
        """True when the request stopped before its own target."""
        return self.exit_reason in ("deadline", "converged")


class _Token:
    """A dispatch's result on its way to the host: a pool tick's packed
    converged mask or a batch's flow, copied into pinned memory behind
    the dispatch that made it (an event marks the copy's end), or the
    result itself on the CPU."""

    __slots__ = ("host", "event")

    def __init__(self, host, event=None):
        self.host = host
        self.event = event

    def fetch(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


class _StreamState:
    """Worker-side cache entry for one stream session (LRU-bounded): the
    last frame's feature and context maps, on the engine's device."""

    __slots__ = ("sid", "bucket", "hw", "fmap", "ctx", "busy", "flow8")

    def __init__(self, sid: int, bucket: Tuple[int, int], hw: Tuple[int, int]):
        self.sid = sid
        self.bucket = bucket
        self.hw = hw
        self.fmap: Optional[torch.Tensor] = None  # (1, Cf, h/8, w/8)
        self.ctx: Optional[torch.Tensor] = None   # (1, Cc, h/8, w/8)
        self.busy = False                         # one in-flight frame per stream
        # warm start: the previous pair's final 1/8-grid flow (host), cached
        # beside the frame maps and invalidated with them: a stream never
        # warm-starts across a gap
        self.flow8: Optional[np.ndarray] = None   # (h/8, w/8, 2)


class StreamSession:
    """Caller-facing handle for one served video stream.

    Feed frames in order via :meth:`submit`; each returns a
    :class:`ServeResult` whose ``flow`` is the flow from the previous
    frame to this one, or ``None`` (``primed=True``) when this frame
    opens a fresh pair. One outstanding frame per session (``submit``
    blocks); open several sessions for concurrency.
    """

    def __init__(self, engine: "ServeEngine", stream_id: int):
        self._engine = engine
        self.stream_id = stream_id

    def submit(self, frame, *, deadline_ms: Optional[float] = None, num_flow_updates: Optional[int] = None,
               trace_ctx: Optional[TraceContext] = None, priority: Optional[str] = None,
               tenant: Optional[str] = None) -> ServeResult:
        return self._engine.submit_frame(
            self.stream_id, frame, deadline_ms=deadline_ms, num_flow_updates=num_flow_updates,
            trace_ctx=trace_ctx, priority=priority, tenant=tenant,
        )

    def close(self) -> None:
        self._engine.close_stream(self.stream_id)

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-unfetched batch in the whole-request window."""

    live: List[Request]
    iters: int
    level: int
    t0: float
    token: _Token
    kind: str                                   # 'pair' | 'stream'
    # stream only: per-request (fmap1, fmap2, ctx, init_flow) rows for the
    # singles retry (init_flow unused by the whole-request iterate)
    retry_rows: Optional[List[Tuple[Any, Any, Any, Any]]] = None


class _StagingPool:
    """Rotating preallocated host buffers, keyed by (role, bucket).

    ``slots`` buffers a key, pinned for the card. Rows are written in
    place and pad rows zeroed, replacing a per-batch ``np.zeros`` +
    ``np.concatenate``. The host runs ahead of the device, so a buffer is
    rewritten only once the copy that read it has finished: :meth:`mark`
    records one event, after the dispatches that read the buffers filled
    since the last mark, and a refill waits for it.
    """

    def __init__(self, slots: int, pin: bool):
        self._slots = max(2, int(slots))
        self._pin = pin
        self._rings: Dict[Any, List[list]] = {}
        self._idx: Dict[Any, int] = {}
        self._unmarked: List[list] = []

    def fill(self, key, shape, rows: List[np.ndarray], rung: int) -> torch.Tensor:
        """Copy ``rows`` (each ``(1, ...)``) in, zero the pad tail, and
        return the ``rung``-row slice of a rotating ``shape`` buffer."""
        shape = tuple(shape)
        ring = self._rings.get(key)
        if ring is None or tuple(ring[0][0].shape) != shape:
            ring = [[torch.zeros(shape, dtype=torch.float32, pin_memory=self._pin), None]
                    for _ in range(self._slots)]
            self._rings[key] = ring
            self._idx[key] = 0
        i = self._idx[key]
        self._idx[key] = (i + 1) % len(ring)
        slot = ring[i]
        if slot[1] is not None:
            slot[1].synchronize()  # the copy that last read this buffer
            slot[1] = None
        buf = slot[0].numpy()
        for j, row in enumerate(rows):
            buf[j] = row[0]
        if rung > len(rows):
            buf[len(rows):rung] = 0.0
        self._unmarked.append(slot)
        return slot[0][:rung]

    def mark(self) -> None:
        """Every buffer filled since the last mark has been read by the
        work enqueued so far on the current stream: record that."""
        event = None
        if self._pin:
            event = torch.cuda.Event()
            event.record()
        for slot in self._unmarked:
            slot[1] = event
        self._unmarked.clear()


class ServeEngine:
    """Deadline-aware, load-shedding, degradation-capable RAFT server.

    Args:
        model: a built :class:`~raft_tpu_torch.models.RAFT` (a torch
            module carries its weights); moved to ``device``, eval mode.
        config: the :class:`ServeConfig`; default ``ServeConfig()``.
        device: the CUDA card unless ``'cpu'`` is named; raises when no
            card is present.
        logger: an optional :class:`~raft_tpu_torch.utils.logging.
            MetricLogger`: the serving counters go to its scalars every
            ``config.log_every_batches`` batches, and postmortem bundles
            to its events file.

    Example::

        cfg = ServeConfig(buckets=((440, 1024),), warmup=True)
        with ServeEngine(raft_for_serving(ServeConfig.preset("quality")), cfg) as engine:
            result = engine.submit(image1, image2)   # ServeResult
    """

    def __init__(self, model, config: Optional[ServeConfig] = None, *, device=None, logger=None):
        self.config = cfg = config or ServeConfig()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._router = BucketRouter(cfg.buckets)
        self._queue = MicroBatchQueue(cfg.queue_capacity, qos=cfg.qos_enabled, aging_ms=cfg.qos_aging_ms)
        # per-class accounting always runs (a stable stats schema); the
        # admission policy exists only when QoS is on
        self._qos_stats = QosStats(cfg.latency_window)
        self._qos_policy = QosPolicy(cfg.qos_tenant_quotas) if cfg.qos_enabled else None
        self._controller = DegradationController(
            cfg.ladder,
            slo_p99_ms=cfg.slo_p99_ms,
            high_watermark=cfg.high_watermark,
            low_watermark=cfg.low_watermark,
            cooldown=cfg.cooldown_batches,
            recover_after=cfg.recover_after,
        )
        self._slow_tokens = TokenBucket(cfg.slow_path_per_s, cfg.slow_path_burst)
        # the tile planner holds no device state: submit_tiled works on
        # any engine; unknown_shape='tiled' only routes submit() to it
        self._tiler = TilePlanner(
            cfg.buckets, overlap_px=cfg.tile_overlap_px, pad_penalty=cfg.tile_pad_penalty,
            max_tiles=cfg.tile_max_tiles,
        )
        self._tiler_counters = dict.fromkeys(
            ("requests", "completed", "failures", "tiles_submitted", "tiles_retried", "admission_acquisitions"), 0
        )
        self._tiler_blend_ms: List[float] = []
        self._tiler_px = [0, 0]  # [useful canvas px, dispatched px]
        # the slow path's whole-request forward: one graph per (natural
        # shape, iterations), captured and replayed on the worker
        self._apply = FlowEstimator(self.model, num_flow_updates=cfg.ladder[0], device=self.device)
        # the serving-weights identity, computed once by variables_hash
        self._variables_hash: Optional[str] = None
        # the whole-request engine's batch ladder (and the encode rungs of
        # its streams), pinned staging, and its programs; the iteration
        # pool uses the programs' encode for stream and seeded admissions
        self._batch_ladder: Tuple[int, ...] = cfg.resolved_batch_ladder()
        self._max_batch = cfg.max_batch
        self._staging = _StagingPool(cfg.pipeline_depth + 1, pin=self.device.type == "cuda")
        self._batch_progs = BatchPrograms(self.model, self.device)
        # rings of pinned host buffers for results on their way to the host
        self._host_rings: Dict[Any, List[torch.Tensor]] = {}
        self._pools: Dict[Tuple[int, int], BucketPool] = {}
        self._pool_cap = cfg.pool_capacity
        self._admit_ladder: Tuple[int, ...] = ()
        self._admit_cap = 0
        # residual-history length = the full-quality iteration target, so
        # any admitted request's whole trajectory fits the rolling window
        self._resid_len = cfg.ladder[0]
        self._conv_thresh = float(cfg.pool_converge_thresh or 0.0)
        # warm start is a host-side admission decision of the pool
        self._warm_start = bool(cfg.stream_warm_start and cfg.pool_capacity > 0)
        self._pool_progs: Optional[PoolPrograms] = None
        if cfg.pool_capacity > 0:
            self._admit_ladder = cfg.resolved_admit_ladder()
            self._admit_cap = self._admit_ladder[-1]
            self._pool_progs = PoolPrograms(self.model, self.device, resid_len=self._resid_len)
            self._pool_progs.set_knobs(
                self._conv_thresh,
                min(cfg.pool_converge_streak, self._resid_len),
                min(max(cfg.pool_min_iters, 1), self._resid_len),
            )
        # stream sessions (encode-once feature cache), LRU order
        self._streams_on = cfg.stream_cache_size > 0
        self._streams: "collections.OrderedDict[int, _StreamState]" = collections.OrderedDict()
        self._streams_lock = threading.Lock()
        self._next_sid = 0
        self._lock = threading.Lock()
        # the observability spine: the metrics registry (the counter dict
        # is a registry-backed CounterGroup), the per-request tracer, and
        # the fault flight recorder
        self.metrics = MetricsRegistry("serve")
        self.recorder = FlightRecorder(proc="engine")
        self.tracer = Tracer(cfg.trace_sample_rate, prefix="srv", on_finish=self.recorder.add_trace)
        self._logger = logger
        if logger is not None:
            # postmortem bundles persist through the logger's events file
            self.recorder.add_sink(logger_sink(logger))
        self._counters = self.metrics.counter_group("counters", _COUNTERS)
        self._latency_hist = self.metrics.histogram("latency_ms")
        self.ledger = DeviceTimeLedger(cfg.ledger_sample_every, device=self.device, registry=self.metrics)
        self._resid_final = self.metrics.histogram("final_residual", bounds=RESIDUAL_BUCKETS)
        self._resid_iter_sum = np.zeros(self._resid_len)
        self._resid_iter_cnt = np.zeros(self._resid_len, np.int64)
        # burn-rate alerting over the engine's own counters, evaluated
        # from the worker loop; a page-severity fire dumps a postmortem,
        # and every bundle carries the alerts active at dump time. The
        # alert snapshot and the gauges close over the parts they read,
        # never over the engine, and the obs objects that point back at
        # each other (registry, alerts, ledger, recorder) do so weakly: the
        # engine sits in no reference cycle, so its last reference going
        # frees it (on the card, its graphs' memory) at once, not at the
        # next garbage collection
        s_w, l_w = cfg.alert_short_window_s, cfg.alert_long_window_s
        self._alerts = AlertEngine(
            (
                AlertRule("slo_burn", ratio_rate(("expired", "shed"), "submitted"), 0.1, s_w, l_w, severity="page"),
                AlertRule("quarantine_burn", ratio_rate("quarantined", "submitted"), 0.05, s_w, l_w),
                AlertRule("watchdog_trips", rate("watchdog_trips"), 0.0, s_w, l_w, severity="page"),
                AlertRule("device_time_drift", gauge_value("device_time_drift"), 1.5, s_w, l_w),
            ),
            snapshot_fn=functools.partial(_alert_snapshot, self._counters, self._lock, _weakly(self.ledger.drift, 0.0)),
            recorder=self.recorder,
        )
        self._alerts.register_gauges(self.metrics)
        self.recorder.alerts_provider = _weakly(self._alerts.active, [])
        self.metrics.gauge("queue_depth", self._queue.depth)
        self.metrics.gauge("queue_forming", self._queue.forming)
        ctrl, engine = self._controller, weakref.ref(self)
        self.metrics.gauge("degradation_level", lambda: ctrl.level)
        self.metrics.gauge("num_flow_updates", lambda: ctrl.num_flow_updates)
        # the pools hold device state: read them through the engine, weakly
        self.metrics.gauge("pool_occupied", lambda: _pool_occupied(engine()))
        self._last_level = 0  # degradation level at the last observe
        self._next_rid = 0
        self._boot: Dict[str, Any] = {
            "source": "none",
            "boot_to_ready_ms": None,
            "programs_total": 0,
            "programs_captured": 0,
            "captures": 0,
            "smoke_runs": 0,
        }
        self._ttfd: List[float] = []   # admission-wait samples
        self._latency: Dict[Tuple[int, int], List[float]] = {}
        self._batch_ms_ewma = 50.0
        self._quarantined_rids: List[int] = []
        self._stop = threading.Event()
        self._draining = threading.Event()
        # dispatched-but-unfetched batches (whole-request worker); written
        # only by the worker, read by drain()'s quiesce poll
        self._inflight_n = 0
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watchdog: Optional[Watchdog] = None

    @classmethod
    def from_estimator(cls, estimator: FlowEstimator, config: Optional[ServeConfig] = None) -> "ServeEngine":
        """Serve an existing :class:`FlowEstimator`'s model on its device."""
        return cls(estimator.model, config, device=estimator.device)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeEngine":
        """Warm up (optional), then start the worker. Idempotent.

        Boot is measured: ``stats()['boot']`` reports boot-to-ready time,
        the programs captured, and the process's capture events in the
        boot window."""
        if self._thread is not None and self._thread.is_alive():
            return self
        if self._stop.is_set():
            raise EngineStopped("engine was stopped; build a new one")
        t0 = time.monotonic()
        ev0 = aot.capture_events()
        if self.config.apply_timeout_s is not None and self._watchdog is None:
            # callback-mode sections only: never interrupts the main
            # thread; a trip records and dumps through the flight recorder
            self._watchdog = Watchdog(self.config.apply_timeout_s, install_handler=False, recorder=self.recorder)
        if self.config.warmup:
            with _BOOT_LOCK:
                self._warmup()
        worker = self._worker_pool if self._pool_progs is not None else self._worker
        self._thread = threading.Thread(target=worker, name="raft-serve-worker", daemon=True)
        self._thread.start()
        self._ready.set()
        self._boot["boot_to_ready_ms"] = (time.monotonic() - t0) * 1e3
        self._boot["captures"] = aot.capture_events() - ev0
        self.recorder.record("boot", **self._boot)
        return self

    def stop(self) -> None:
        self._stop.set()
        for req in self._queue.close():
            req.finish(error=EngineStopped("engine stopping"))
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        if self._watchdog is not None:
            self._watchdog.close()
        self._ready.clear()
        self._log_counters(force=True)

    @property
    def is_draining(self) -> bool:
        """True between :meth:`drain` and :meth:`stop`."""
        return self._draining.is_set()

    def drain(self, *, timeout: Optional[float] = 30.0) -> bool:
        """Quiesce without dropping accepted work.

        Three phases, in order: stop admitting (``submit`` and
        ``submit_frame`` raise the retryable
        :class:`~raft_tpu_torch.serve.errors.Draining`); fail queued
        requests with the same ``Draining``; let dispatched batches
        complete and the pool retire every resident at its own target.
        Returns True once quiesced within ``timeout`` seconds (``None``
        waits forever), False on timeout. Idempotent. Each phase is a
        flight-recorder event (``drain_begin``, ``drain_queued_failed``,
        ``drain_quiesced`` or ``drain_timeout``)."""
        if not self._draining.is_set():
            self.recorder.record("drain_begin", timeout=timeout)
        self._draining.set()
        retry_ms = self.config.drain_retry_after_ms
        n_failed = 0
        for req in self._queue.drain():
            if req.finish(
                error=Draining(
                    f"engine draining for restart; retry in ~{retry_ms:.0f}ms",
                    retry_after_ms=retry_ms,
                )
            ):
                self._count("drained")
                n_failed += 1
                if req.kind == "stream":
                    self._invalidate_stream(req.stream_id)
        if n_failed:
            self.recorder.record("drain_queued_failed", n=n_failed)
        deadline = None if timeout is None else time.monotonic() + timeout
        ok = True
        while not self._quiesced():
            if not (self._thread is not None and self._thread.is_alive()):
                ok = self._quiesced()
                break
            if deadline is not None and time.monotonic() > deadline:
                ok = False
                break
            time.sleep(0.005)
        self.recorder.record("drain_quiesced" if ok else "drain_timeout", ok=ok)
        return ok

    def _quiesced(self) -> bool:
        """Nothing queued, no batch popped but not yet dispatched, nothing
        dispatched but unfetched, no pool residents."""
        if self._queue.depth() or self._queue.forming():
            return False
        if self._pool_progs is not None:
            return all(p.occupied_count() == 0 for p in self._pools.values())
        return self._inflight_n == 0

    def close(self, graceful: bool = False, *, timeout: Optional[float] = 30.0) -> None:
        """Stop the engine; ``graceful=True`` drains first."""
        if graceful:
            self.drain(timeout=timeout)
        self.stop()

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _warmup(self) -> None:
        """Capture the worker's whole program set before the worker starts
        (:func:`raft_tpu_torch.serve.aot.warm_engine`), then run one tiny
        execution per program family and bucket as a smoke check that the
        captured set replays."""
        with torch.inference_mode(), self._on_device():
            self._boot.update(aot.warm_engine(self))
            if self._pool_progs is not None:
                self._smoke_pool()
            else:
                self._smoke()

    def _smoke(self) -> None:
        """The whole-request families at the smallest rung and the ladder
        floor, per bucket."""
        iters, r = self.config.ladder[-1], self._batch_ladder[0]
        for bucket in self._router.buckets:
            z = np.zeros((r,) + tuple(bucket) + (3,), np.float32)
            _host_flow(self._run_batch(z, z, iters))
            self._boot["smoke_runs"] += 1
            if self._streams_on:
                fm, cx = self._run_encode(z)
                zf, zc = rows_like(fm, r), rows_like(cx, r)
                _host_flow(self._run_iterate(zf, zf, zc, iters))
                self._boot["smoke_runs"] += 1

    def _smoke_pool(self) -> None:
        """One admission -> step -> retirement chain per bucket at the
        smallest admission rung, and a stream admission when streams are
        on."""
        r = self._admit_ladder[0]
        idx, mask = np.zeros((r,), np.int64), np.asarray([True] + [False] * (r - 1))
        for bucket in self._router.buckets:
            bh, bw = bucket
            pool = self._pool_for(bucket)
            z = torch.zeros((r, 3, bh, bw), dtype=torch.float32)
            rows = self._run_pool_begin(z, z)
            self._pool_insert(pool.state, rows, idx, mask)
            self._run_pool_step(pool).fetch()
            c1, hid, _ = self._pool_gather(pool.state["coords1"], pool.state["hidden"], pool.state["resid_hist"], idx)
            self._run_pool_final(c1, hid).cpu()
            self._boot["smoke_runs"] += 1
            if self._streams_on:
                fm, cx = self._run_encode(np.zeros((r, bh, bw, 3), np.float32))
                zf, zc = rows_like(fm, r), rows_like(cx, r)
                zi = torch.zeros((r, 2, bh // 8, bw // 8), dtype=torch.float32)
                self._pool_insert(pool.state, self._run_pool_begin_features(zf, zf, zc, zi), idx, mask)
                self._boot["smoke_runs"] += 1

    def _on_device(self):
        """The worker's device context (the card's index), or nothing on
        the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- public API --------------------------------------------------------

    def submit(self, image1, image2, *, deadline_ms: Optional[float] = None,
               num_flow_updates: Optional[int] = None, init_flow=None, trace_ctx: Optional[TraceContext] = None,
               priority: Optional[str] = None, tenant: Optional[str] = None, shadow: bool = False) -> ServeResult:
        """Serve one raw [0, 255] ``(H, W, 3)`` pair; returns :class:`ServeResult`.

        ``num_flow_updates`` caps this request's refinement iterations
        (validated against the full-quality ``ladder[0]``); the pool
        honors it exactly, the whole-request engine at ladder-rung
        granularity (a batch runs at the largest of its members' rungs,
        so nobody's quality is cut below their ask).

        ``init_flow`` is a best-effort warm-start hint: an ``(h, w, 2)``
        flow on the caller's 1/8 refinement grid (1/8-grid pixels) that
        seeds this pair's refinement. Honored only where the engine can
        seed (:attr:`supports_init_flow`: the pool with streams on),
        otherwise ignored: a seed changes convergence speed, never the
        fixed point.

        ``priority`` / ``tenant`` classify the request for QoS
        (``'interactive'`` | ``'standard'`` | ``'batch'``; ``None`` takes
        the config defaults). With ``qos_enabled`` the tenant's quota is
        charged (a retryable
        :class:`~raft_tpu_torch.serve.errors.QuotaExceeded` on breach)
        and the class drives shedding and brownout; off, they are
        accounting only.

        ``shadow`` marks the request as mirrored rollout traffic: served as
        any other, counted only in the ``shadow_*`` counters, no tenant
        quota charged and no QoS class counted, so the submitted /
        completed / shed / expired counters the autoscaler, the QoS stats
        and the burn-rate alerts read never move.

        Under ``unknown_shape='tiled'`` an off-bucket pair is served by
        :meth:`submit_tiled` (``init_flow`` is dropped: a tile has no
        seed of its own).

        ``trace_ctx`` (a :class:`~raft_tpu_torch.obs.TraceContext`) joins
        this request to a trace sampled elsewhere: the engine's spans
        record under the propagated ``trace_id`` (the engine's own rate is
        bypassed) and, when the context carries a live trace, the sealed
        record is stitched into it before this call returns.

        Blocks the calling thread until the result, the deadline, or a
        typed :class:`~raft_tpu_torch.serve.errors.ServeError`."""
        if self.config.unknown_shape == "tiled":
            a1 = np.asarray(image1)
            if a1.ndim == 3 and self._router.route(int(a1.shape[0]), int(a1.shape[1])) is None:
                # fan out before any accounting, so the request is charged
                # and counted once, by submit_tiled
                return self.submit_tiled(image1, image2, deadline_ms=deadline_ms, num_flow_updates=num_flow_updates,
                                         trace_ctx=trace_ctx, priority=priority, tenant=tenant, shadow=shadow)
        t_sub = time.monotonic()
        deadline_ms = self._check_live(deadline_ms)
        pr, ten = self._qos_resolve(priority, tenant)
        iters = self._validate_iters(num_flow_updates)
        p1, p2, hw = self._admit(image1, image2)
        rel = None if shadow else self._qos_charge(pr, ten)
        t_adm = time.monotonic()
        bucket = self._router.route(*hw)
        rid = self._new_rid(shadow=shadow)
        if not shadow:
            self._qos_stats.count(pr, "submitted")
        trace = self.tracer.start("pair", rid, t_start=t_sub, trace_id=None if trace_ctx is None else trace_ctx.trace_id)
        if trace is not None:
            trace.add_span("admit", t_sub, t_adm)
            trace.annotate(priority=pr, tenant=ten)
        deadline = time.monotonic() + deadline_ms / 1e3
        try:
            if bucket is None:
                return self._submit_slow(rid, p1, p2, hw, deadline, deadline_ms, iters, trace=trace, priority=pr,
                                         tenant=ten, shadow=shadow)
            req = Request(
                rid, bucket, self._router.pad_to(p1, bucket), self._router.pad_to(p2, bucket), hw, deadline,
                iters=iters, priority=pr, tenant=ten, shadow=shadow,
            )
            if init_flow is not None:
                req.init8 = self._prepare_init_flow(init_flow, bucket)
                req.warm = req.init8 is not None
            req.trace = trace
            if rel is not None:
                req.add_done_callback(rel)
            return self._enqueue_and_wait(req, deadline_ms)
        finally:
            # the release is one-shot: the done callback covers the worker's
            # completions, this call a shed (the request never finishes) and
            # every error before the request existed
            if rel is not None:
                rel()
            # in-process stitch: the engine's sealed record joins the
            # caller's trace on every exit path (success, shed, deadline)
            if trace_ctx is not None and trace is not None:
                trace_ctx.absorb(trace.record, proc="engine")

    def submit_many(self, items: List[Dict[str, Any]]) -> List[Request]:
        """Coalesced pairwise admission: validate and admit a burst,
        enqueueing every admissible request under ONE queue lock
        (:meth:`MicroBatchQueue.put_many`).

        Each item is a dict: ``image1``, ``image2``, optional
        ``deadline_ms`` / ``num_flow_updates`` / ``trace_ctx`` (its
        ``trace_id`` is adopted) / ``priority`` / ``tenant`` / ``shadow``
        (as in :meth:`submit`), and an optional ``on_done`` callable
        invoked with the request handle on completion. Returns one
        :class:`Request` handle per item, in order (``wait``, then
        ``result`` or ``error``). An item that fails validation,
        admission, its tenant's quota or the queue's shed comes back
        already finished, carrying its typed error; the rest of the burst
        is unaffected. Un-bucketed shapes take the slow path (or, under
        ``unknown_shape='tiled'``, the tiler) inline, as :meth:`submit`
        would (this call blocks until they are served).

        The tiler's fan-out rides two internal item keys: ``p1``/``p2``/
        ``hw`` (already-admitted ``(1, h, w, 3)`` slices, not admitted
        again) and ``skip_quota`` (the tiled request was charged once for
        all its tiles).
        """
        return self._submit_many(items)[0]

    def _submit_many(self, items: List[Dict[str, Any]]) -> Tuple[List[Request], int]:
        """:meth:`submit_many`, and the queue acquisitions it took (0 or 1)."""
        prepared: List[Request] = []
        handles: List[Request] = []
        for it in items:
            cb = it.get("on_done")
            ctx = it.get("trace_ctx")
            sh = bool(it.get("shadow", False))
            t_sub = time.monotonic()
            try:
                deadline_ms = self._check_live(it.get("deadline_ms"))
                pr, ten = self._qos_resolve(it.get("priority"), it.get("tenant"))
                iters = self._validate_iters(it.get("num_flow_updates"))
                if "p1" in it:
                    # a tile of a tiled request: its slices were admitted
                    # with the request; admitting again would rescale them
                    p1, p2 = it["p1"], it["p2"]
                    hw = (int(it["hw"][0]), int(it["hw"][1]))
                else:
                    p1, p2, hw = self._admit(it["image1"], it["image2"])
                rel = None if sh or it.get("skip_quota") else self._qos_charge(pr, ten)
            except Exception as e:
                handles.append(self._finished_handle(error=e, on_done=cb))
                continue
            bucket = self._router.route(*hw)
            rid = self._new_rid(shadow=sh)
            if not sh:
                self._qos_stats.count(pr, "submitted")
            trace = self.tracer.start("pair", rid, t_start=t_sub, trace_id=None if ctx is None else ctx.trace_id)
            if trace is not None:
                trace.add_span("admit", t_sub, time.monotonic())
                trace.annotate(priority=pr, tenant=ten)
            deadline = time.monotonic() + deadline_ms / 1e3
            if bucket is None:
                # rare (un-bucketed shape): served now, through the slow path
                # or the tiler
                req = Request(rid, hw, None, None, hw, deadline, iters=iters, priority=pr, tenant=ten, shadow=sh)
                if rel is not None:
                    req.add_done_callback(rel)
                if cb is not None:
                    req.add_done_callback(cb)
                try:
                    req.finish(result=self._submit_slow(rid, p1, p2, hw, deadline, deadline_ms, iters, trace=trace,
                                                        priority=pr, tenant=ten, shadow=sh))
                except Exception as e:
                    req.finish(error=e)
                handles.append(req)
                continue
            req = Request(
                rid, bucket, self._router.pad_to(p1, bucket), self._router.pad_to(p2, bucket), hw, deadline,
                iters=iters, priority=pr, tenant=ten, shadow=sh,
            )
            req.trace = trace
            if rel is not None:
                req.add_done_callback(rel)
            if cb is not None:
                req.add_done_callback(cb)
            prepared.append(req)
            handles.append(req)
        if not prepared:
            return handles, 0
        preempted: List[Request] = []
        outcomes = self._queue.put_many(prepared, retry_after_ms=self._retry_after_ms(), preempted=preempted)
        for req, err in zip(prepared, outcomes):
            if err is None:
                continue
            if isinstance(err, Overloaded):
                self._count_outcome(req, "shed")
                if not req.shadow:
                    self._qos_stats.count(req.priority, "shed")
                self._record_shed(req, err)
            req.finish(error=err)
        # the burst may displace queued lower-class work: each victim is
        # finished with the typed retryable shed
        self._qos_preempted(preempted, prepared[0])
        return handles, 1

    def submit_tiled(self, image1, image2, *, deadline_ms: Optional[float] = None,
                     num_flow_updates: Optional[int] = None, trace_ctx: Optional[TraceContext] = None,
                     priority: Optional[str] = None, tenant: Optional[str] = None,
                     shadow: bool = False) -> ServeResult:
        """Serve an off-bucket pair as bucket-shaped tiles.

        The :class:`~raft_tpu_torch.serve.tiler.TilePlanner` picks the
        cheapest (bucket, overlap-stride) tiling of ``(H, W)``; both
        images are sliced at the same offsets (views of the admitted
        arrays) and pushed through :meth:`submit_many` under ONE
        :meth:`MicroBatchQueue.put_many` acquisition, so a tiled request
        costs admission one acquisition however many tiles it has. The
        tiles run on the engine's captured programs (no capture for a new
        shape); their fetched flows are blended on the host under
        feathered linear-ramp weights cached per plan.

        A tile that fails terminally fails the request with that tile's
        typed error; a shed tile (retryable, with ``retry_after_ms``) is
        retried inside the request's own deadline. The tenant's quota is
        charged once for the request; its tiles inherit its class and
        ride ``skip_quota`` items. An on-bucket shape falls through to
        :meth:`submit`. Works whatever ``config.unknown_shape`` says;
        ``'tiled'`` only makes :meth:`submit` route here.

        Returns a :class:`ServeResult` with ``tiled=True`` and
        ``tiles=N``; ``num_flow_updates``/``level``/``degraded`` report
        the most conservative tile. A traced request's record (kind
        ``'tiled'``) carries ``admit``, ``tiled_submit`` and
        ``tiled_blend`` spans; ``trace_ctx`` joins it to a trace born
        elsewhere, and ``shadow`` counts its tiles in the ``shadow_*``
        counters, as in :meth:`submit`.
        """
        a1 = np.asarray(image1)
        if a1.ndim == 3 and self._router.route(int(a1.shape[0]), int(a1.shape[1])) is not None:
            return self.submit(image1, image2, deadline_ms=deadline_ms, num_flow_updates=num_flow_updates,
                               trace_ctx=trace_ctx, priority=priority, tenant=tenant, shadow=shadow)
        t_sub = time.monotonic()
        deadline_ms = self._check_live(deadline_ms)
        pr, ten = self._qos_resolve(priority, tenant)
        iters = self._validate_iters(num_flow_updates)
        p1, p2, hw = self._admit(image1, image2)
        rel = None if shadow else self._qos_charge(pr, ten)
        t_adm = time.monotonic()
        # the request is an envelope: its tiles carry the engine's
        # submitted/completed/shed accounting (they are real queue
        # citizens), the ``tiler`` stats block counts the envelope, so
        # its rid leaves the submitted counter alone
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        trace = self.tracer.start("tiled", rid, t_start=t_sub,
                                  trace_id=None if trace_ctx is None else trace_ctx.trace_id)
        if trace is not None:
            trace.add_span("admit", t_sub, t_adm)
            trace.annotate(priority=pr, tenant=ten)
        deadline = time.monotonic() + deadline_ms / 1e3
        try:
            return self._run_tiled(rid, p1, p2, hw, deadline, iters, trace=trace, priority=pr, tenant=ten,
                                   shadow=shadow, t_sub=t_sub)
        finally:
            if rel is not None:
                rel()
            if trace_ctx is not None and trace is not None:
                trace_ctx.absorb(trace.record, proc="engine")

    def _run_tiled(self, rid, p1, p2, hw, deadline, req_iters=None, *, trace=None, priority=None, tenant=None,
                   shadow=False, t_sub=None) -> ServeResult:
        """The tiled fan-out: plan, slice, one ``put_many``, wait, blend.

        ``p1``/``p2`` are admitted ``(1, H, W, 3)`` arrays; the tile
        slices are views into them. Each tile's flow is cropped back to
        the tile by its own completion and reaches the blend as a host
        array of its own, fetched before any later replay of its program.
        """
        t0 = t_sub if t_sub is not None else time.monotonic()
        try:
            plan = self._tiler.plan(hw)
        except ShapeRejected:
            self._count("rejected")
            with self._lock:
                self._tiler_counters["failures"] += 1
            if trace is not None:
                trace.finish(ok=False, error="ShapeRejected")
            raise
        with self._lock:
            self._tiler_counters["requests"] += 1
            self._tiler_px[0] += plan.hw[0] * plan.hw[1]
            self._tiler_px[1] += plan.dispatched_px
        t_fan = time.monotonic()
        items: List[Dict[str, Any]] = [
            {
                "p1": p1[:, t.y0:t.y0 + t.h, t.x0:t.x0 + t.w],
                "p2": p2[:, t.y0:t.y0 + t.h, t.x0:t.x0 + t.w],
                "hw": (t.h, t.w),
                "deadline_ms": max(1.0, (deadline - time.monotonic()) * 1e3),
                "num_flow_updates": req_iters,
                "priority": priority,
                "tenant": tenant,
                "shadow": shadow,
                "skip_quota": True,
            }
            for t in plan.tiles
        ]
        # the one-acquisition property: the whole fan-out rides a single
        # put_many (retries below take their own, counted as tiles_retried)
        handles, acq = self._submit_many(items)
        with self._lock:
            self._tiler_counters["tiles_submitted"] += len(items)
            self._tiler_counters["admission_acquisitions"] += acq
        if trace is not None:
            trace.add_span("tiled_submit", t_fan, tiles=len(items), bucket=f"{plan.bucket[0]}x{plan.bucket[1]}",
                           put_many_acquisitions=acq)
        try:
            results: List[ServeResult] = []
            for i, h in enumerate(handles):
                while True:
                    if not h.wait(max(0.0, deadline - time.monotonic()) + 0.05):
                        h.finish(error=DeadlineExceeded(
                            f"tiled request {rid} missed its deadline waiting on tile {i + 1}/{len(handles)}"
                        ))
                    if h.error is None:
                        break
                    err = h.error
                    retry_ms = getattr(err, "retry_after_ms", None)
                    if retry_ms is not None and deadline - time.monotonic() > retry_ms / 1e3:
                        # a shed tile: back off and retry inside the
                        # request's own deadline; a terminal tile error
                        # fails the whole request, typed
                        time.sleep(retry_ms / 1e3)
                        with self._lock:
                            self._tiler_counters["tiles_retried"] += 1
                        it = dict(items[i], deadline_ms=max(1.0, (deadline - time.monotonic()) * 1e3))
                        h = self._submit_many([it])[0][0]
                        continue
                    _raise_copy(err)
                results.append(h.result)
            t_blend = time.monotonic()
            flow = blend_tiles(plan, self._tiler.weights(plan), [r.flow for r in results])
            now = time.monotonic()
            blend_ms = (now - t_blend) * 1e3
            with self._lock:
                self._tiler_counters["completed"] += 1
                self._tiler_blend_ms.append(blend_ms)
                del self._tiler_blend_ms[: -self.config.latency_window]
            reasons = {r.exit_reason for r in results}
            res = ServeResult(
                flow=flow,
                rid=rid,
                bucket=plan.bucket,
                num_flow_updates=min(r.num_flow_updates for r in results),
                level=max(r.level for r in results),
                degraded=any(r.degraded for r in results),
                latency_ms=(now - t0) * 1e3,
                exit_reason=reasons.pop() if len(reasons) == 1 else "target",
                trace_id=None if trace is None else trace.trace_id,
                tiled=True,
                tiles=plan.n_tiles,
            )
            if trace is not None:
                trace.add_span("tiled_blend", t_blend, now)
                trace.annotate(tiled=True, tiles=plan.n_tiles, bucket=f"{plan.bucket[0]}x{plan.bucket[1]}",
                               waste_frac=round(plan.waste_frac, 4), blend_ms=round(blend_ms, 3),
                               latency_ms=round(res.latency_ms, 3))
                trace.finish(ok=True)
            return res
        except BaseException as e:
            with self._lock:
                self._tiler_counters["failures"] += 1
            if trace is not None:
                trace.finish(ok=False, error=type(e).__name__)
            raise

    def _finished_handle(self, *, error, on_done=None) -> Request:
        """A pre-failed handle for a ``submit_many`` item that never
        reached the queue."""
        req = Request(-1, (0, 0), None, None, (0, 0), time.monotonic())
        if on_done is not None:
            req.add_done_callback(on_done)
        req.finish(error=error)
        return req

    def open_stream(self) -> StreamSession:
        """Start a stream session: encode-once feature caching per frame.

        Consecutive frames of a video share a frame per pair; the session
        caches each frame's feature and context maps (on the card) so pair
        (t, t+1) pays the encoder only for frame t+1; ``stats()`` reports
        the hit rate as ``encoder_cache_hit_rate``. Sessions are
        LRU-bounded (``config.stream_cache_size``); an evicted or
        invalidated session primes again (``flow=None`` for that frame).
        """
        if not self._streams_on:
            raise InvalidInput("stream serving is disabled (stream_cache_size=0)")
        with self._streams_lock:
            sid = self._next_sid
            self._next_sid += 1
        return StreamSession(self, sid)

    def submit_frame(self, stream_id: int, frame, *, deadline_ms: Optional[float] = None,
                     num_flow_updates: Optional[int] = None, trace_ctx: Optional[TraceContext] = None,
                     priority: Optional[str] = None, tenant: Optional[str] = None,
                     shadow: bool = False) -> ServeResult:
        """Advance stream ``stream_id`` by one frame.

        Returns flow(previous frame -> this frame) at the caller's
        resolution, or a ``primed=True`` result (``flow=None``) when this
        frame opens a fresh pair (first frame, or first after an
        invalidation or eviction). One outstanding frame per stream.
        ``trace_ctx`` joins a trace sampled elsewhere, ``priority`` /
        ``tenant`` classify the frame for QoS, and ``shadow`` counts it in
        the ``shadow_*`` counters, as in :meth:`submit`.
        """
        if not self._streams_on:
            raise InvalidInput("stream serving is disabled (stream_cache_size=0)")
        t_sub = time.monotonic()
        deadline_ms = self._check_live(deadline_ms)
        pr, ten = self._qos_resolve(priority, tenant)
        iters = self._validate_iters(num_flow_updates)
        p, hw = self._admit_frame(frame)
        t_adm = time.monotonic()
        bucket = self._router.route(*hw)
        if bucket is None:
            self._count("rejected")
            raise ShapeRejected(
                f"no bucket admits stream frame shape {hw} (buckets: "
                f"{list(self._router.buckets)}); streams have no slow path "
                f"— resize or reconfigure"
            )
        with self._streams_lock:
            st = self._streams.get(stream_id)
            if st is None:
                st = _StreamState(stream_id, bucket, hw)
                self._streams[stream_id] = st
                self._evict_streams_locked()
            self._streams.move_to_end(stream_id)
            if st.busy:
                raise InvalidInput(
                    f"stream {stream_id} already has a frame in flight; "
                    f"streams are strictly ordered — submit sequentially"
                )
            if st.bucket != bucket or st.hw != hw:
                # resolution change mid-stream: prime again rather than
                # pair frames across different buckets
                st.fmap = st.ctx = st.flow8 = None
                st.bucket, st.hw = bucket, hw
            st.busy = True
        req = None
        rel = None
        try:
            rel = None if shadow else self._qos_charge(pr, ten)
            rid = self._new_rid(shadow=shadow)
            if not shadow:
                self._qos_stats.count(pr, "submitted")
            deadline = time.monotonic() + deadline_ms / 1e3
            req = Request(
                rid, bucket, None, self._router.pad_to(p, bucket), hw, deadline, kind="stream",
                stream_id=stream_id, iters=iters, priority=pr, tenant=ten, shadow=shadow,
            )
            req.trace = self.tracer.start("stream", rid, t_start=t_sub,
                                          trace_id=None if trace_ctx is None else trace_ctx.trace_id)
            if req.trace is not None:
                req.trace.add_span("admit", t_sub, t_adm)
                req.trace.annotate(stream_id=stream_id, priority=pr, tenant=ten)
            if rel is not None:
                req.add_done_callback(rel)
            return self._enqueue_and_wait(req, deadline_ms)
        finally:
            if rel is not None:
                rel()  # one-shot: covers the shed path (the request unfinished)
            with self._streams_lock:
                st.busy = False
            if trace_ctx is not None and req is not None and req.trace is not None:
                trace_ctx.absorb(req.trace.record, proc="engine")

    def close_stream(self, stream_id: int) -> None:
        """Drop a stream session and its cached maps."""
        with self._streams_lock:
            self._streams.pop(stream_id, None)

    @property
    def variables_hash(self) -> str:
        """The serving-weights identity: sha256 over the model's
        ``state_dict()`` (parameters and persistent buffers, in its fixed
        order): each entry's name, shape and dtype, then its bytes. Two
        engines over the same weights agree; one changed value changes it.
        It is not the JAX engine's hash (the two packages' parameter trees
        differ in names and layouts). Cached: the walk runs once an
        engine."""
        if self._variables_hash is None:
            digest = hashlib.sha256()
            for name, t in self.model.state_dict().items():
                t = t.detach().cpu().contiguous()
                digest.update(f"{name}:{tuple(t.shape)}:{t.dtype}".encode())
                digest.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
            self._variables_hash = digest.hexdigest()
        return self._variables_hash

    @property
    def supports_init_flow(self) -> bool:
        """Whether pair submits can honor an ``init_flow`` seed: seeded
        admission runs ``encode`` + ``begin_features``, so both the
        iteration pool and stream serving must be on."""
        return self._pool_progs is not None and self._streams_on

    def _prepare_init_flow(self, init_flow, bucket) -> Optional[np.ndarray]:
        """Validate and pad a caller-grid ``(h8, w8, 2)`` seed to the
        bucket's 1/8 grid (``(1, bh/8, bw/8, 2)``, zeros beyond the
        caller's extent: a zero seed is the cold start). ``None`` when
        this engine cannot seed; a malformed seed raises ``InvalidInput``."""
        if not self.supports_init_flow:
            return None
        arr = np.asarray(init_flow, np.float32)
        if arr.ndim != 3 or arr.shape[-1] != 2:
            raise InvalidInput(f"init_flow must be (h/8, w/8, 2), got {arr.shape}")
        if not np.all(np.isfinite(arr)):
            raise InvalidInput("init_flow contains non-finite values")
        bh8, bw8 = bucket[0] // 8, bucket[1] // 8
        out = np.zeros((1, bh8, bw8, 2), np.float32)
        h, w = min(arr.shape[0], bh8), min(arr.shape[1], bw8)
        out[0, :h, :w] = arr[:h, :w]
        return out

    def health(self) -> dict:
        """Liveness/readiness for an external supervisor or LB probe."""
        with self._lock:
            trips = self._counters["watchdog_trips"]
            quarantined = self._counters["quarantined"]
        return {
            "ready": self._ready.is_set(),
            "healthy": self._thread is not None and self._thread.is_alive() and not self._stop.is_set(),
            "draining": self._draining.is_set(),
            "queue_depth": self._queue.depth(),
            "queue_capacity": self.config.queue_capacity,
            "level": self._controller.level,
            "num_flow_updates": self._controller.num_flow_updates,
            "watchdog_trips": trips,
            "quarantined": quarantined,
        }

    def stats(self) -> dict:
        """Serving counters + degradation + per-bucket latency quantiles +
        hot-path efficiency (padding waste, encoder cache hit rate), pool
        occupancy, convergence, device-time ledger, tracing and
        flight-recorder accounting (``obs``), burn-rate alerts,
        captured-program counts and the kernel launches the graphs'
        replays made."""
        with self._lock:
            counters = dict(self._counters)
            latency = {
                f"{bh}x{bw}": {
                    "n": len(v),
                    "p50_ms": float(np.percentile(v, 50)) if v else None,
                    "p99_ms": float(np.percentile(v, 99)) if v else None,
                }
                for (bh, bw), v in self._latency.items()
            }
            quarantined = list(self._quarantined_rids)
            ttfd = list(self._ttfd)
            r_sum = self._resid_iter_sum.copy()
            r_cnt = self._resid_iter_cnt.copy()
        counters["queue_depth"] = self._queue.depth()
        disp_si = counters["dispatched_slot_iters"]
        if self._pool_progs is not None:
            # idle-slot-iterations / dispatched-slot-iterations: the
            # fraction of dispatched refinement work that advanced nobody
            padding_waste = counters["idle_slot_iters"] / disp_si if disp_si else 0.0
        else:
            # padded rows / dispatched rows of the whole-request batches
            rows = counters["dispatched_rows"]
            padding_waste = counters["padded_rows"] / rows if rows else 0.0
        hits, misses = counters["encode_cache_hits"], counters["encode_cache_misses"]
        pools = list(self._pools.values())
        occupied = sum(p.occupied_count() for p in pools)
        return {
            **counters,
            "padding_waste": padding_waste,
            "mesh_devices": 1,  # the port serves on one card
            "variables_hash": self.variables_hash,
            "encoder_cache_hit_rate": hits / (hits + misses) if hits + misses else None,
            "batch_ladder": list(self._batch_ladder),
            "boot": dict(self._boot),
            # tracing + flight-recorder accounting; the rings live on
            # engine.tracer / engine.recorder, Prometheus text on
            # engine.prometheus()
            "obs": {
                "trace_sample_rate": self.config.trace_sample_rate,
                "traces_started": self.tracer.started,
                "traces_finished": self.tracer.finished,
                "events_recorded": self.recorder.events_recorded,
                "postmortem_dumps": self.recorder.dumps,
            },
            "ledger": self.ledger.breakdown(),
            "alerts": self._alerts.snapshot(),
            "convergence": {
                "enabled": self._pool_progs is not None,
                "threshold": self.config.pool_converge_thresh,
                "streak": self.config.pool_converge_streak,
                "warm_start": self._warm_start,
                "n": self._resid_final.count,
                "final_residual_p50": self._resid_final.quantile(0.50),
                "final_residual_p99": self._resid_final.quantile(0.99),
                "resid_by_iter": [round(float(s / c), 6) if c else None for s, c in zip(r_sum, r_cnt)],
            },
            "pool": {
                "capacity": self._pool_cap,
                "mesh_devices": 1,
                # the occupied fraction of the card's slots across buckets
                "per_device_occupancy": [occupied / (self._pool_cap * max(1, len(pools)))]
                if self._pool_progs is not None else [],
                "occupied": occupied,
                "ticks": counters["pool_ticks"],
                "occupancy": 1.0 - counters["idle_slot_iters"] / disp_si if disp_si else 0.0,
                "ttfd_p50_ms": float(np.percentile(ttfd, 50)) if ttfd else None,
                "tick_ms_ewma": float(np.mean([p.tick_ewma_ms for p in pools])) if pools else None,
            },
            "programs": self.program_counts(),
            "launches": self.graph_launches(),
            "degradation": self._controller.snapshot(),
            "latency": latency,
            "quarantined_rids": quarantined,
            # per-class counters and latency, per-tenant quota state;
            # "enabled" says whether enforcement is on
            "qos": qos_stats_block(self.config.qos_enabled, self.config.qos_aging_ms, self._qos_stats,
                                   self._qos_policy),
            "tiler": self._tiler_block(),
        }

    def _tiler_block(self) -> dict:
        """The ``stats()['tiler']`` block: the tiled requests' envelope
        accounting (their tiles count in the engine's own counters)."""
        with self._lock:
            c = dict(self._tiler_counters)
            blend = list(self._tiler_blend_ms)
            useful, dispatched = self._tiler_px
        return {
            "enabled": self.config.unknown_shape == "tiled",
            "overlap_px": self.config.tile_overlap_px,
            "plans_built": self._tiler.plans_built,
            "plan_cache_hits": self._tiler.plan_cache_hits,
            **c,
            # traffic-weighted dispatched-pixel overhead over every tiled
            # request served (None until the first)
            "waste_frac": 1.0 - useful / dispatched if dispatched else None,
            "blend_ms": {
                "n": len(blend),
                "p50_ms": float(np.percentile(blend, 50)) if blend else None,
                "p99_ms": float(np.percentile(blend, 99)) if blend else None,
            },
        }

    def prometheus(self) -> str:
        """Prometheus text exposition of this engine's metrics registry
        (counters, queue/degradation/pool gauges, latency and device-time
        histograms, per-alert-rule gauges), plus the QoS series: per-class
        counters labeled ``class=`` and per-tenant quota state labeled
        ``tenant=``."""
        text = self.metrics.prometheus_text()

        def esc(s: str) -> str:
            return s.replace("\\", "\\\\").replace('"', '\\"')

        lines = ["# TYPE serve_qos_class counter"]
        for cls, cstats in sorted(self._qos_stats.snapshot().items()):
            for k in QosStats.COUNTER_KEYS:
                lines.append(f'serve_qos_class{{class="{esc(cls)}",key="{k}"}} {int(cstats.get(k, 0))}')
        tenants = self._qos_policy.snapshot() if self._qos_policy is not None else {}
        if tenants:
            lines.append("# TYPE serve_qos_tenant gauge")
            for ten, tstats in sorted(tenants.items()):
                for k in ("inflight", "quota_refused"):
                    lines.append(f'serve_qos_tenant{{tenant="{esc(ten)}",key="{k}"}} {int(tstats.get(k, 0))}')
        return text + "\n".join(lines) + "\n"

    def device_time_breakdown(self) -> Dict[str, Any]:
        """Per-program-family device-time attribution from the ledger
        (empty when ``config.ledger_sample_every == 0``)."""
        return self.ledger.breakdown()

    def alerts(self) -> Dict[str, Any]:
        """The burn-rate alert surface: active alerts (rule, severity,
        live burn), fire/resolve counters, and the configured rules."""
        snap = self._alerts.snapshot()
        snap["active"] = self._alerts.active()
        return snap

    def _log_counters(self, force: bool = False) -> None:
        """The serving counters through the logger, every
        ``log_every_batches`` batches (and always when ``force``)."""
        if self._logger is None:
            return
        every = self.config.log_every_batches
        with self._lock:
            step = self._counters["batches"]
            if not force and (step == 0 or every <= 0 or step % every):
                return
            scalars = {f"serve/{k}": float(v) for k, v in self._counters.items()}
        scalars["serve/queue_depth"] = float(self._queue.depth())
        scalars["serve/level"] = float(self._controller.level)
        scalars["serve/num_flow_updates"] = float(self._controller.num_flow_updates)
        self._logger.log(step, scalars)

    def program_counts(self) -> Dict[str, int]:
        """Captured-program count per program family (-1 on the CPU, where
        nothing is captured): ``pairwise`` counts the whole-request graphs
        and the slow path's. After ``warmup=True`` these stay constant
        under any admitted traffic: the worker never captures."""
        counts = self._batch_progs.counts()
        if self.device.type == "cuda":
            counts["pairwise"] += len(self._apply.programs())
        if self._pool_progs is not None:
            counts.update(self._pool_progs.counts())
        return counts

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by this engine's graph replays, by kernel
        (replays x launches per graph; the wrappers count eager launches
        only)."""
        total = dict(self._apply.graph_launches())
        progs = list(self._batch_progs.graphs().values())
        if self._pool_progs is not None:
            progs += list(self._pool_progs.graphs().values())
        for prog in progs:
            for k, n in prog.replayed_launches().items():
                total[k] = total.get(k, 0) + n
        return total

    # -- admission ---------------------------------------------------------

    def _check_live(self, deadline_ms: Optional[float]) -> float:
        if not self._ready.is_set() or self._stop.is_set():
            raise EngineStopped("serve engine is not running")
        if self._draining.is_set():
            retry_ms = self.config.drain_retry_after_ms
            raise Draining(
                f"engine draining for restart; retry in ~{retry_ms:.0f}ms",
                retry_after_ms=retry_ms,
            )
        if deadline_ms is None:
            deadline_ms = self.config.default_deadline_ms
        if deadline_ms <= 0:
            raise InvalidInput(f"deadline_ms must be positive, got {deadline_ms}")
        return deadline_ms

    def _new_rid(self, shadow: bool = False) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._counters["shadow_submitted" if shadow else "submitted"] += 1
        return rid

    def _count_outcome(self, r: Request, key: str) -> None:
        """Count a request's outcome, in its ``shadow_*`` twin for mirrored
        rollout traffic, so every signal read from the live counters stays
        blind to shadow load."""
        self._count(f"shadow_{key}" if r.shadow else key)

    def _validate_iters(self, n: Optional[int]) -> Optional[int]:
        """Validate a per-request ``num_flow_updates`` against the
        configured full-quality top of the ladder."""
        if n is None:
            return None
        full = self.config.ladder[0]
        if int(n) != n or not (1 <= int(n) <= full):
            raise InvalidInput(
                f"num_flow_updates must be an int in [1, {full}] (the "
                f"configured full-quality ladder top), got {n!r}"
            )
        return int(n)

    def _admit(self, image1, image2):
        """Validate one raw pair; returns normalized (1,H,W,3) + (H, W)."""
        a1, a2 = np.asarray(image1), np.asarray(image2)
        if a1.ndim != 3 or a2.ndim != 3:
            raise InvalidInput(
                f"serve requests are single (H, W, 3) pairs, got shapes "
                f"{a1.shape} / {a2.shape}; submit batch members individually "
                f"(the engine micro-batches internally)"
            )
        if a1.shape != a2.shape:
            raise InvalidInput(f"image shapes differ: {a1.shape} vs {a2.shape}")
        try:
            # owns the [0,255] -> [-1,1] contract AND the nonfinite reject
            p1 = FlowEstimator._normalize(a1)
            p2 = FlowEstimator._normalize(a2)
        except ValueError as e:
            self._count("invalid")
            raise InvalidInput(str(e)) from e
        return p1, p2, (int(a1.shape[0]), int(a1.shape[1]))

    def _admit_frame(self, frame):
        """Validate one raw stream frame; returns normalized (1,H,W,3) + (H, W)."""
        a = np.asarray(frame)
        if a.ndim != 3:
            raise InvalidInput(f"stream frames are single (H, W, 3) images, got {a.shape}")
        try:
            p = FlowEstimator._normalize(a)
        except ValueError as e:
            self._count("invalid")
            raise InvalidInput(str(e)) from e
        return p, (int(a.shape[0]), int(a.shape[1]))

    def _iter_rung(self, n: Optional[int]) -> int:
        """The whole-request engine's granularity for a per-request
        iteration cap: the largest ladder entry <= n (floor at the ladder's
        last entry: the program set stays closed)."""
        if n is None:
            return self.config.ladder[0]
        for it in self.config.ladder:          # strictly descending
            if it <= n:
                return it
        return self.config.ladder[-1]

    def _honor_iters(self, live: List[Request], ctrl_iters: int) -> int:
        """A whole-request batch runs at the largest of its members' rungs
        capped by the degradation target; the iterations that saves count
        as ``early_exit_iters_saved``."""
        iters = min(ctrl_iters, max(self._iter_rung(r.iters) for r in live))
        if iters < ctrl_iters:
            with self._lock:
                self._counters["early_exit_iters_saved"] += (ctrl_iters - iters) * len(live)
        return iters

    def _enqueue_and_wait(self, req: Request, deadline_ms: float) -> ServeResult:
        preempted: List[Request] = []
        try:
            self._queue.put(req, retry_after_ms=self._retry_after_ms(), preempted=preempted)
        except Overloaded as e:
            self._count_outcome(req, "shed")
            if not req.shadow:
                self._qos_stats.count(req.priority, "shed")
            self._record_shed(req, e)
            if req.trace is not None:
                req.trace.finish(ok=False, error="Overloaded")
            raise
        self._qos_preempted(preempted, req)
        if not req.wait(max(0.0, req.remaining) + 0.05):
            # worker still busy past our deadline: fail caller-side (set-once
            # means a simultaneous worker finish wins harmlessly)
            if req.finish(error=DeadlineExceeded(f"request {req.rid} missed its {deadline_ms:.0f}ms deadline")) \
                    and not req.shadow:
                self._qos_stats.count(req.priority, "expired")
            self._count_outcome(req, "expired")
        if req.error is not None:
            _raise_copy(req.error)
        return req.result

    def _record_shed(self, req: Request, err: Overloaded) -> None:
        """The flight-recorder events of a queue shed: ``shed``, and with
        QoS on ``qos_shed`` naming the request's class and tenant (not for
        shadow traffic, which no class is charged for)."""
        self.recorder.record("shed", rid=req.rid, req_kind=req.kind, retry_after_ms=err.retry_after_ms)
        if self.config.qos_enabled and not req.shadow:
            self.recorder.record("qos_shed", rid=req.rid, priority=req.priority, tenant=req.tenant,
                                 retry_after_ms=err.retry_after_ms)

    def _submit_slow(self, rid, p1, p2, hw, deadline, deadline_ms, req_iters=None, *, trace=None,
                     priority="standard", tenant="default", shadow=False) -> ServeResult:
        """Un-bucketed shape: reject, tile, or queue it rate-limited for
        the worker, which runs it alone (:meth:`_run_slow`)."""
        if self.config.unknown_shape == "reject":
            self._count("rejected")
            if trace is not None:
                trace.finish(ok=False, error="ShapeRejected")
            buckets = tuple(self._router.buckets)
            raise ShapeRejected(
                f"no bucket admits shape {hw} (buckets: {list(buckets)}); "
                f"resize, reconfigure, or set unknown_shape='slow_path' or 'tiled'",
                supported_buckets=buckets,
                nearest=nearest_bucket(hw, buckets),
            )
        if self.config.unknown_shape == "tiled":
            # only submit_many items land here under 'tiled' (submit routes
            # to submit_tiled before any accounting); their rid was counted
            # submitted, so a tiled success is counted completed here
            res = self._run_tiled(rid, p1, p2, hw, deadline, req_iters, trace=trace, priority=priority,
                                  tenant=tenant, shadow=shadow)
            self._count("shadow_completed" if shadow else "completed")
            return res
        if not self._slow_tokens.try_take():
            # a shadow request lands in its twin here too (the JAX engine
            # counts it as a live slow-path shed and completion)
            if shadow:
                self._count("shadow_shed")
            else:
                self._count("shed_slow_path")
                self._qos_stats.count(priority, "shed")
            self.recorder.record("shed", rid=rid, req_kind="slow_path")
            if trace is not None:
                trace.finish(ok=False, error="Overloaded")
            raise Overloaded(
                f"slow path over its {self.config.slow_path_per_s}/s rate",
                retry_after_ms=self._slow_tokens.retry_after_ms(),
            )
        shape = self._router.natural_shape(*hw)
        req = Request(
            rid, shape, self._router.pad_to(p1, shape), self._router.pad_to(p2, shape), hw, deadline,
            slow_path=True, kind="slow", iters=req_iters, priority=priority, tenant=tenant, shadow=shadow,
        )
        req.trace = trace
        return self._enqueue_and_wait(req, deadline_ms)

    def _run_slow(self, req: Request) -> None:
        """One slow-path request on the worker: the whole-request forward
        at its natural shape (its graph captured here on first use), its
        fetch inside the device-deadline section."""
        iters = self._controller.num_flow_updates
        if req.iters is not None:
            iters = min(iters, req.iters)
        key = ("pairwise", 1, req.bucket[0], req.bucket[1], int(iters))
        t0 = time.monotonic()
        self._trace_queue_wait([req], t0)

        def run():
            with profile.annotate("serve/pairwise"):
                return self.ledger.run(key, lambda: self._apply._forward(req.p1, req.p2, iters))

        out, tripped = self._guarded_dispatch([req], run)
        if tripped:
            self._after_trip()
            return
        self._trace_span([req], "dispatch", t0, iters=iters, slow_path=True)
        flow = self._request_flow(req, out[0])
        if not np.isfinite(flow).all():
            self._quarantine(req)
            return
        self._count("slow_path")
        self._finish_ok(req, flow, iters)

    # -- the whole-request worker ---------------------------------------

    def _worker(self) -> None:
        """The batch thread (``pool_capacity=0``): survives any per-batch
        failure by contract.

        Runs a bounded dispatch pipeline: up to ``pipeline_depth`` batches
        are dispatched but unfetched at once, so batch N+1 is assembled,
        staged and dispatched while batch N computes. Completion order is
        dispatch order; a full window, an idle queue, shedding or a queue
        past the degradation high-watermark drain the oldest batch first
        (under flood the window must not extend residence). A slow-path
        request comes alone and runs whole, in turn.
        """
        cfg = self.config
        inflight: "collections.deque[_Inflight]" = collections.deque()
        last_sheds = self._shed_count()

        def complete_oldest() -> None:
            inf = inflight.popleft()
            try:
                self._complete(inf)
            except Exception as e:  # isolation: fail the batch, not the worker
                self._count("worker_errors")
                err = ServeError(f"batch execution failed: {e!r}")
                for r in inf.live:
                    r.finish(error=err)
            finally:
                self._inflight_n = len(inflight)

        def cap(bucket, kind):
            return 1 if kind == "slow" else self._max_batch

        with torch.inference_mode(), self._on_device():
            while not self._stop.is_set():
                sheds = self._shed_count()
                shedding, last_sheds = sheds > last_sheds, sheds
                if inflight and (
                    len(inflight) >= cfg.pipeline_depth
                    or self._queue.depth() == 0
                    or shedding
                    or self._queue.depth() >= cfg.high_watermark * self._queue.capacity
                ):
                    complete_oldest()
                    continue
                batch: List[Request] = []
                try:
                    batch = self._queue.next_batch(
                        self._max_batch, cfg.max_wait_ms / 1e3, poll=0.0 if inflight else 0.05, cap=cap
                    )
                    live = self._filter_live(batch)
                    if live and live[0].kind == "slow":
                        self._run_slow(live[0])
                    elif live:
                        inf = self._dispatch_stream(live) if live[0].kind == "stream" else self._dispatch_pair(live)
                        if inf is not None:
                            inflight.append(inf)
                            self._inflight_n = len(inflight)
                            with self._lock:
                                self._counters["inflight_peak"] = max(self._counters["inflight_peak"], len(inflight))
                except Exception as e:  # isolation: fail the batch, not the worker
                    self._count("worker_errors")
                    err = ServeError(f"batch execution failed: {e!r}")
                    for r in batch:
                        r.finish(error=err)
                finally:
                    if batch:
                        # ack only once the batch is visible downstream (in
                        # the window, or its requests finished), so drain()'s
                        # quiesce check never races the pop
                        self._queue.task_done()
                self._log_counters()
                self._alerts.maybe_observe()
            # drain the pipeline, then anything admitted during shutdown
            while inflight:
                complete_oldest()
        for r in self._queue.close():
            r.finish(error=EngineStopped("engine stopping"))

    def _rung(self, k: int) -> int:
        """Smallest batch-ladder rung >= k (k <= max_batch by formation)."""
        for b in self._batch_ladder:
            if b >= k:
                return b
        return self._batch_ladder[-1]

    def _note_padding(self, rung: int, k: int) -> None:
        with self._lock:
            self._counters["dispatched_rows"] += rung
            self._counters["padded_rows"] += rung - k

    def _dispatch_pair(self, live: List[Request]) -> Optional[_Inflight]:
        """Stage a pair batch at its rung and dispatch its whole forward;
        the flow starts for pinned memory behind the replay."""
        bucket = live[0].bucket
        iters, level = self._qos_levels(live, *self._observe(live))
        iters = self._honor_iters(live, iters)
        rung = self._rung(len(live))
        shape = (self._max_batch,) + tuple(bucket) + (3,)
        t_form = time.monotonic()
        self._trace_queue_wait(live, t_form)
        p1 = self._staging.fill(("p1", bucket), shape, [r.p1 for r in live], rung)
        p2 = self._staging.fill(("p2", bucket), shape, [r.p2 for r in live], rung)
        self._note_padding(rung, len(live))
        t0 = time.monotonic()
        self._trace_span(live, "batch_form", t_form, t0, rung=rung)

        def run():
            flow = self._run_batch(p1, p2, iters)
            self._staging.mark()
            return self._to_host(flow, ("flow", bucket), self._max_batch)

        token, tripped = self._guarded_dispatch(live, run)
        if tripped:
            self._after_trip()
            return None  # requests already failed (and the trip counted)
        self._trace_span(live, "dispatch", t0, iters=iters)
        return _Inflight(live, iters, level, t0, token, "pair")

    def _dispatch_stream(self, live: List[Request]) -> Optional[_Inflight]:
        """Stream batch: encode the new frames (one program per rung),
        transact each session's feature cache, then dispatch the iterate
        stage for the requests that had a cached previous frame.

        The encode stage is waited for (its per-row finite check decides
        what the cache keeps); the iterate stage, 12-32 refinements, is
        what pipelines against the next batch.
        """
        bucket = live[0].bucket
        iters, level = self._qos_levels(live, *self._observe(live))
        iters = self._honor_iters(live, iters)
        rung = self._rung(len(live))
        shape = (self._max_batch,) + tuple(bucket) + (3,)
        t_form = time.monotonic()
        self._trace_queue_wait(live, t_form)
        frames = self._staging.fill(("frames", bucket), shape, [r.p2 for r in live], rung)
        self._note_padding(rung, len(live))
        t0 = time.monotonic()
        self._trace_span(live, "batch_form", t_form, t0, rung=rung)
        enc, tripped = self._guarded_dispatch(live, lambda: self._encode_checked(frames, len(live)))
        if tripped:
            self._after_trip()
            for r in live:
                self._invalidate_stream(r.stream_id)
            return None
        self._trace_span(live, "encode", t0, rung=rung)
        flow_reqs, rows = self._stream_transact(live, *enc, iters, level)
        if not flow_reqs:
            return None
        rung2 = self._rung(len(flow_reqs))
        f1, f2, cx = (_stack_rows([rr[k] for rr in rows], rung2) for k in range(3))
        self._note_padding(rung2, len(flow_reqs))
        t_d = time.monotonic()
        token, tripped = self._guarded_dispatch(
            flow_reqs,
            lambda: self._to_host(self._run_iterate(f1, f2, cx, iters), ("flow", bucket), self._max_batch),
        )
        if tripped:
            self._after_trip()
            for r in flow_reqs:
                self._invalidate_stream(r.stream_id)
            return None
        self._trace_span(flow_reqs, "dispatch", t_d, iters=iters)
        return _Inflight(flow_reqs, iters, level, t0, token, "stream", retry_rows=rows)

    def _encode_checked(self, frames, n: int):
        """One encode batch and, per live row, whether its feature and
        context maps are finite (a host fetch: the encode's wait)."""
        fmap, ctx = self._run_encode(frames)
        self._staging.mark()
        finite = (torch.isfinite(fmap[:n]).flatten(1).all(1) & torch.isfinite(ctx[:n]).flatten(1).all(1)).tolist()
        return fmap, ctx, finite

    def _complete(self, inf: _Inflight) -> None:
        """Fetch one in-flight batch's flow and finish its requests. The
        fetch is the host's wait on the replay: a device stall shows here,
        so it runs inside the device-deadline section."""
        t_f = time.monotonic()
        flow, tripped = self._guarded_dispatch(inf.live, inf.token.fetch)
        self._trace_span(inf.live, "fetch", t_f)
        batch_ms = (time.monotonic() - inf.t0) * 1e3
        with self._lock:
            self._counters["batches"] += 1
            self._batch_ms_ewma += 0.2 * (batch_ms - self._batch_ms_ewma)
        if tripped:
            # requests already failed (and the trip counted); the fetch
            # waited out the stalled replay, its token is dropped unread
            self._after_trip()
            if inf.kind == "stream":
                for r in inf.live:
                    self._invalidate_stream(r.stream_id)
            return
        flow = flow.transpose(0, 2, 3, 1)
        flows = [self._request_flow(r, flow[i]) for i, r in enumerate(inf.live)]
        if all(np.isfinite(f).all() for f in flows):
            for r, f in zip(inf.live, flows):
                self._finish_ok(r, f, inf.iters, level=inf.level)
        else:
            # non-finite output: retry the batch as singles so exactly the
            # poisoned request is quarantined
            self._count("nonfinite_batches")
            if inf.kind == "stream":
                self._retry_singles_stream(inf)
            else:
                self._retry_singles(inf.live, inf.iters, inf.level)

    def _retry_singles(self, live: List[Request], iters: int, level: int) -> None:
        for r in live:
            if r.done:
                continue
            t_r = time.monotonic()
            try:
                f = self._request_flow(r, _host_flow(self._run_batch(r.p1, r.p2, iters))[0])
                if r.trace is not None:
                    r.trace.add_span("retry_single", t_r, iters=iters)
            except Exception as e:
                r.finish(error=ServeError(f"single retry failed: {e!r}"))
                self._count("worker_errors")
                continue
            if np.isfinite(f).all():
                self._count("retried_singles")
                self._finish_ok(r, f, iters, level=level, retried=True)
            else:
                self._quarantine(r)

    def _retry_singles_stream(self, inf: _Inflight) -> None:
        """The singles retry of a stream batch, from its saved feature
        rows. A frame that is non-finite even alone is quarantined AND its
        session invalidated: a stream that just failed a frame primes
        again rather than pair across the failure."""
        for r, (f1, f2, cx, _init) in zip(inf.live, inf.retry_rows or []):
            if r.done:
                continue
            t_r = time.monotonic()
            try:
                f = self._request_flow(r, _host_flow(self._run_iterate(f1, f2, cx, inf.iters))[0])
                if r.trace is not None:
                    r.trace.add_span("retry_single", t_r, iters=inf.iters)
            except Exception as e:
                r.finish(error=ServeError(f"single retry failed: {e!r}"))
                self._count("worker_errors")
                self._invalidate_stream(r.stream_id)
                continue
            if np.isfinite(f).all():
                self._count("retried_singles")
                self._finish_ok(r, f, inf.iters, level=inf.level, retried=True)
            else:
                self._quarantine(r)
                self._invalidate_stream(r.stream_id)

    # -- the pool worker -------------------------------------------------

    def _pool_for(self, bucket: Tuple[int, int]) -> BucketPool:
        """The bucket's pool, allocated (and its step captured, before any
        slot holds a request: the capture's eager warm-up runs a step)
        on first use."""
        pool = self._pools.get(bucket)
        if pool is None:
            state = zero_state(self._pool_progs, self._pool_cap, bucket)
            self._pool_progs.capture_step(state)
            pool = self._pools[bucket] = BucketPool(bucket, self._pool_cap, state)
        return pool

    def _rung_admit(self, k: int) -> int:
        """Smallest admission rung >= k (k <= admit cap by formation)."""
        for r in self._admit_ladder:
            if r >= k:
                return r
        return self._admit_ladder[-1]

    def _worker_pool(self) -> None:
        """The iteration-pool worker: one GRU iteration per dispatch.
        Survives any per-dispatch failure: an admission failure costs that
        admission cohort, a tick failure the residents, never the
        thread."""
        with torch.inference_mode(), self._on_device():
            while not self._stop.is_set():
                try:
                    for pool in list(self._pools.values()):
                        self._pool_retire(pool)
                    self._pool_admit()
                    for pool in list(self._pools.values()):
                        if pool.occupied_count():
                            self._pool_tick(pool)
                except Exception as e:  # isolation: fail residents, not the worker
                    self._count("worker_errors")
                    self._pool_fail_all(ServeError(f"pool tick failed: {e!r}"))
                self._log_counters()
                self._alerts.maybe_observe()
            self._pool_fail_all(EngineStopped("engine stopping"))
        for r in self._queue.close():
            r.finish(error=EngineStopped("engine stopping"))

    def _pool_fail_all(self, err: ServeError) -> None:
        for pool in self._pools.values():
            metas = pool.clear()
            for m in metas:
                m.req.finish(error=err)
                if m.req.kind == "stream":
                    self._invalidate_stream(m.req.stream_id)
            if metas:
                with self._lock:
                    self._counters["pool_resets"] += 1
                self.recorder.record("pool_reset", bucket=f"{pool.bucket[0]}x{pool.bucket[1]}", residents=len(metas),
                                     error=repr(err))

    def _pool_reset_tripped(self, pool: BucketPool, why: str) -> None:
        """A watchdog trip in one of ``pool``'s dispatches: its residents
        were failed by the watcher's callback; free every slot, drop the
        pending tokens unread, record the reset, and drain the stream."""
        cleared = pool.clear()
        for m in cleared:
            if m.req.kind == "stream":
                self._invalidate_stream(m.req.stream_id)
        with self._lock:
            self._counters["pool_resets"] += 1
        self.recorder.record("pool_reset", bucket=f"{pool.bucket[0]}x{pool.bucket[1]}", residents=len(cleared),
                             error=why)
        self._after_trip()

    def _pool_retire(self, pool: BucketPool) -> None:
        """Free slots whose requests are finished, expired, or due:
        target reached, converged (past ``pool_min_iters``), or a
        deadline-driven early exit — strictest first."""
        cfg = self.config
        due: List[Tuple[int, _SlotMeta, str]] = []
        for i, meta in pool.occupied():
            r = meta.req
            if r.done:
                # caller side already finished it (its deadline tripped)
                pool.release(i)
                continue
            remaining_ms = r.remaining * 1e3
            if remaining_ms <= 0:
                if r.finish(error=DeadlineExceeded(f"request {r.rid} expired after {meta.done} pool iterations")):
                    self._count_outcome(r, "expired")
                    if not r.shadow:
                        self._qos_stats.count(r.priority, "expired")
                pool.release(i)
                continue
            need = meta.target - meta.done
            if need <= 0:
                due.append((i, meta, "target"))
            elif meta.converged and meta.done >= cfg.pool_min_iters:
                due.append((i, meta, "converged"))
            elif (
                cfg.pool_early_exit
                and meta.done >= cfg.pool_min_iters
                and remaining_ms < (need + 1) * pool.tick_ewma_ms * self._qos_forecast_slack(r)
            ):
                # the deadline would expire before the remaining
                # iterations finish: cash in the anytime ladder now
                due.append((i, meta, "deadline"))
        if due:
            self._pool_finalize(pool, due)

    def _pool_finalize(self, pool: BucketPool, due: List[Tuple[int, _SlotMeta, str]]) -> None:
        """Gather finished slots' carry, run the final upsample, and
        complete their requests; a non-finite flow quarantines exactly
        its own request. More due slots than the top rung finalize in
        chunks, keeping the program set closed."""
        while len(due) > self._admit_cap:
            self._pool_finalize(pool, due[: self._admit_cap])
            due = due[self._admit_cap:]
        rung = self._rung_admit(len(due))
        idx = np.asarray([i for i, _, _ in due] + [due[0][0]] * (rung - len(due)), np.int64)
        live = [m.req for _, m, _ in due]
        # with warm start on, the retiring streams' final 1/8-grid coords
        # ride the fetch the finalize already pays
        fetch_c1 = self._warm_start and any(m.req.kind == "stream" for _, m, _ in due)

        def run():
            c1, hid, res = self._pool_gather(pool.state["coords1"], pool.state["hidden"], pool.state["resid_hist"],
                                             idx)
            return (_host_flow(self._run_pool_final(c1, hid)), res.cpu().numpy(),
                    c1.cpu().numpy() if fetch_c1 else None)

        t_f = time.monotonic()
        for _, meta, _ in due:
            if meta.req.trace is not None:
                # the pool's refinement window, admission insert -> finalize
                meta.req.trace.add_span("refine", meta.admitted_t, t_f, iters=meta.done)
        out, tripped = self._guarded_dispatch(live, run)
        self._trace_span(live, "fetch", t_f)
        with self._lock:
            self._counters["batches"] += 1
        if tripped:
            # requests already failed by the watchdog callback; their
            # slots are dead weight now: free them, then drain the stream
            for i, meta, _ in due:
                pool.release(i)
                if meta.req.kind == "stream":
                    self._invalidate_stream(meta.req.stream_id)
            self._after_trip()
            return
        flows, resids, c1_rows = out
        for pos, (i, meta, reason) in enumerate(due):
            r = meta.req
            f = self._request_flow(r, flows[pos])
            # a converged slot froze at converged_done iterations: later
            # ticks changed nothing and were accounted as idle
            eff = meta.converged_done if meta.converged else meta.done
            k = min(eff, self._resid_len)
            traj = resids[pos, self._resid_len - k:] if k else resids[pos, :0]
            # a slot can freeze and retire by target before the host sees
            # the mask: trim sentinel entries, iterations the flow never ran
            n_sent = int((traj >= RESID_SENTINEL * 0.5).sum())
            if n_sent:
                traj = traj[n_sent:]
                eff -= n_sent
                k = len(traj)
            if np.isfinite(f).all():
                saved = max(0, self._controller.ladder[meta.level] - eff)
                with self._lock:
                    self._counters["early_exit_iters_saved"] += saved
                    if reason in ("deadline", "converged"):
                        self._counters[f"early_exits_{reason}"] += 1
                        self._counters[f"early_exit_iters_saved_{reason}"] += saved
                    if k:
                        i0 = eff - k
                        self._resid_iter_sum[i0:eff] += traj
                        self._resid_iter_cnt[i0:eff] += 1
                if k:
                    self._resid_final.observe(float(traj[-1]))
                    if r.trace is not None:
                        r.trace.annotate(final_residual=round(float(traj[-1]), 6))
                if c1_rows is not None and r.kind == "stream":
                    self._store_stream_flow(r.stream_id, c1_rows[pos])
                self._finish_ok(r, f, eff, level=meta.level, exit_reason=reason, warm_started=meta.warm,
                                residuals=tuple(float(x) for x in traj) if (k and r.trace is not None) else None)
            else:
                self._quarantine(r)
                if r.kind == "stream":
                    self._invalidate_stream(r.stream_id)
            pool.release(i)

    def _pool_admit(self) -> None:
        """Fill free slots from the queue (slot-granularity admission):
        one encode + state-init dispatch at the next admission rung, then
        the cohort's in-place inserts, so a late arrival's first iteration
        is the very next tick. A slow-path request comes alone and runs
        whole, between ticks."""

        def cap(bucket, kind):
            if kind == "slow":
                return 1  # run alone at its natural shape
            pool = self._pools.get(bucket)
            return self._pool_cap if pool is None else pool.free_count()

        busy = any(p.occupied_count() or p.pending for p in self._pools.values())
        batch = self._queue.next_batch(self._admit_cap, 0.0, poll=0.0 if busy else 0.05, cap=cap)
        if not batch:
            return
        live: List[Request] = []
        try:
            live = self._filter_live(batch)
            if live and live[0].kind == "slow":
                self._run_slow(live[0])
            elif live:
                pool = self._pool_for(live[0].bucket)
                ctrl_iters, level = self._observe(live)
                if live[0].kind == "stream":
                    self._pool_admit_stream(pool, live, ctrl_iters, level)
                else:
                    self._pool_admit_pairs(pool, live, ctrl_iters, level)
        except Exception as e:  # isolation: fail the admission, not the worker
            self._count("worker_errors")
            err = ServeError(f"pool admission failed: {e!r}")
            for r in live:
                if r.finish(error=err) and r.kind == "stream":
                    self._invalidate_stream(r.stream_id)
        finally:
            # ack only once the cohort is visible downstream, so drain()'s
            # quiesce check never races the pop
            self._queue.task_done()

    def _filter_live(self, batch: List[Request]) -> List[Request]:
        """Fail queue-expired requests; invalidate streams with a dropped
        frame (pairing across the gap would be flow between
        non-consecutive frames)."""
        live: List[Request] = []
        for r in batch:
            if r.done or r.remaining <= 0:
                if r.finish(error=DeadlineExceeded(f"request {r.rid} expired in queue")):
                    self._count_outcome(r, "expired")
                    if not r.shadow:
                        self._qos_stats.count(r.priority, "expired")
                if r.kind == "stream":
                    self._invalidate_stream(r.stream_id)
            else:
                live.append(r)
        return live

    def _observe(self, live: List[Request]) -> Tuple[int, int]:
        depth_now = self._queue.depth() + len(live)
        iters = self._controller.observe(
            min(1.0, depth_now / self._queue.capacity), self._p99(live[0].bucket)
        )
        level = self._controller.level
        if level != self._last_level:
            # each controller move is a fault-ladder event: the seconds of
            # context before an incident show the pressure ramp
            self.recorder.record("degradation_step", frm=self._last_level, to=level, num_flow_updates=iters,
                                 queue_depth=depth_now)
            self._last_level = level
        return iters, level

    def _pool_admit_pairs(self, pool: BucketPool, live: List[Request], ctrl_iters: int, level: int) -> None:
        seeded = [r for r in live if r.init8 is not None]
        if seeded:
            # seeded pairs admit through encode + begin_features, the one
            # admission that takes an init_flow; the rest of the cohort
            # keeps the one-dispatch begin_pair below
            self._pool_admit_pairs_seeded(pool, seeded, ctrl_iters, level)
            live = [r for r in live if r.init8 is None]
            if not live:
                return
        bh, bw = pool.bucket
        rung = self._rung_admit(len(live))
        t_form = time.monotonic()
        self._trace_queue_wait(live, t_form)
        pad = [np.zeros((1, bh, bw, 3), np.float32)] * (rung - len(live))
        p1 = np.concatenate([r.p1 for r in live] + pad)
        p2 = np.concatenate([r.p2 for r in live] + pad)
        t0 = time.monotonic()
        self._trace_span(live, "batch_form", t_form, t0, rung=rung)
        rows, tripped = self._guarded_dispatch(live, lambda: self._run_pool_begin(_nchw(p1), _nchw(p2)))
        if tripped:
            self._after_trip()
            return
        self._trace_span(live, "dispatch", t0, rung=rung)
        self._pool_insert_live(pool, rows, live, ctrl_iters, level)

    def _pool_admit_pairs_seeded(self, pool: BucketPool, live: List[Request], ctrl_iters: int, level: int) -> None:
        """Admit seeded pairs: encode both frames, then initialize the
        slots from the features with the ``init_flow`` seed. Every program
        is one the stream path captured at the same rungs; pad lanes
        carry encode(0) rows that the insert mask discards."""
        rung = self._rung_admit(len(live))
        shape = (self._admit_cap,) + tuple(pool.bucket) + (3,)
        t_form = time.monotonic()
        self._trace_queue_wait(live, t_form)
        p1 = self._staging.fill(("pool_p1", pool.bucket), shape, [r.p1 for r in live], rung)
        p2 = self._staging.fill(("pool_p2", pool.bucket), shape, [r.p2 for r in live], rung)
        t_e = time.monotonic()
        self._trace_span(live, "batch_form", t_form, t_e, rung=rung)

        def encode():
            # one encode graph serves both frames: keep the first's outputs
            # before the second replay overwrites them
            f1, c1 = (t.clone() for t in self._run_encode(p1))
            f2, _ = self._run_encode(p2)
            return f1, c1, f2

        out, tripped = self._guarded_dispatch(live, encode)
        if tripped:
            self._after_trip()
            return
        f1, c1, f2 = out
        self._trace_span(live, "encode", t_e, rung=rung)
        ishape = (self._admit_cap, 2) + tuple(f1.shape[2:])
        init = self._staging.fill(("pool_init", pool.bucket), ishape, [_nchw_rows(r.init8) for r in live], rung)
        t0 = time.monotonic()
        rows, tripped = self._guarded_dispatch(live, lambda: self._run_pool_begin_features(f1, f2, c1, init))
        self._staging.mark()
        if tripped:
            self._after_trip()
            return
        self._trace_span(live, "dispatch", t0, rung=rung)
        self._pool_insert_live(pool, rows, live, ctrl_iters, level)

    def _pool_admit_stream(self, pool: BucketPool, live: List[Request], ctrl_iters: int, level: int) -> None:
        """Stream frames into the pool: encode the new frames, transact
        the sessions' caches, and admit the pairs that had a cached
        previous frame from features (warm-started when on)."""
        rung = self._rung_admit(len(live))
        shape = (self._admit_cap,) + tuple(pool.bucket) + (3,)
        t_form = time.monotonic()
        self._trace_queue_wait(live, t_form)
        frames = self._staging.fill(("pool_frames", pool.bucket), shape, [r.p2 for r in live], rung)
        t_e = time.monotonic()
        enc, tripped = self._guarded_dispatch(live, lambda: self._encode_checked(frames, len(live)))
        if tripped:
            self._after_trip()
            for r in live:
                self._invalidate_stream(r.stream_id)
            return
        self._trace_span(live, "encode", t_e, rung=rung)
        flow_reqs, rows = self._stream_transact(live, *enc, ctrl_iters, level)
        if not flow_reqs:
            return
        rung2 = self._rung_admit(len(flow_reqs))
        f1, f2, cx = (_stack_rows([rr[k] for rr in rows], rung2) for k in range(3))
        ishape = (self._admit_cap, 2) + tuple(f1.shape[2:])
        init = self._staging.fill(("pool_init", pool.bucket), ishape, [_nchw_rows(rr[3]) for rr in rows], rung2)
        t0 = time.monotonic()
        state_rows, tripped = self._guarded_dispatch(
            flow_reqs, lambda: self._run_pool_begin_features(f1, f2, cx, init))
        self._staging.mark()
        if tripped:
            self._after_trip()
            for r in flow_reqs:
                self._invalidate_stream(r.stream_id)
            return
        self._trace_span(flow_reqs, "dispatch", t0, rung=rung2)
        self._pool_insert_live(pool, state_rows, flow_reqs, ctrl_iters, level)

    def _pool_insert_live(self, pool: BucketPool, rows, live: List[Request], ctrl_iters: int, level: int) -> None:
        """Write each admitted request's rows into a free slot. The
        per-request iteration target is fixed here: the request's own
        ``num_flow_updates`` capped by the degradation level's target,
        which under QoS pressure browns out by the request's class."""
        now = time.monotonic()
        rung = int(rows["coords1"].shape[0])
        slots = [pool.alloc() for _ in live]
        idx = np.asarray(slots + [0] * (rung - len(slots)), np.int64)
        mask = np.asarray([True] * len(slots) + [False] * (rung - len(slots)), bool)
        self._pool_insert(pool.state, rows, idx, mask)
        ladder = self._controller.ladder
        for i, r in zip(slots, live):
            requested = r.iters if r.iters is not None else self.config.ladder[0]
            eff_level, eff_iters = level, ctrl_iters
            if self.config.qos_enabled and level > 0:
                eff_level = brownout_level(level, r.rank, len(ladder))
                eff_iters = ladder[eff_level]
            pool.slots[i] = _SlotMeta(req=r, target=max(1, min(requested, eff_iters)), level=eff_level,
                                      admitted_t=now, warm=r.warm)
            with self._lock:
                self._counters["pool_admitted"] += 1
                self._ttfd.append((now - r.t_submit) * 1e3)
                del self._ttfd[: -self.config.latency_window]

    def _pool_tick(self, pool: BucketPool) -> None:
        """Advance every slot of ``pool`` by ONE refinement iteration.
        Already-converged slots are frozen on device (idle slot
        iterations). When the pacing window is full, the oldest tick's
        token — its packed converged mask — is fetched: the host's wait on
        the tick's replay, where a device stall shows. A watchdog trip in
        the launch or the fetch resets the pool (:meth:`_pool_reset_tripped`)."""
        occupied = pool.occupied()
        live = [m.req for _, m in occupied]
        live_n = len(occupied)
        frozen_n = sum(1 for _, m in occupied if m.converged)
        token, tripped = self._guarded_dispatch(live, lambda: self._run_pool_step(pool))
        if tripped:
            self._pool_reset_tripped(pool, "watchdog trip")
            return
        for _, m in occupied:
            if not m.converged:
                m.done += 1
        # snapshot (slot, rid, done-after-tick): the fetched mask is only
        # believed for the occupant it was computed for
        occupants = tuple((i, m.req.rid, m.done) for i, m in occupied if not m.converged)
        with self._lock:
            self._counters["pool_ticks"] += 1
            self._counters["batches"] += 1
            self._counters["dispatched_slot_iters"] += pool.capacity
            self._counters["idle_slot_iters"] += pool.capacity - live_n + frozen_n
            self._counters["inflight_peak"] = max(self._counters["inflight_peak"], len(pool.pending) + 1)
        pool.pending.append((time.monotonic(), token, occupants))
        while len(pool.pending) > self.config.pipeline_depth:
            _, tok, occ = pool.pending.popleft()
            mask, tripped = self._guarded_dispatch(live, tok.fetch)
            pool.note_drain(time.monotonic())
            with self._lock:
                self._batch_ms_ewma += 0.2 * (pool.tick_ewma_ms - self._batch_ms_ewma)
            if tripped:
                self._pool_reset_tripped(pool, "watchdog trip (drain)")
                return
            self._apply_converged_mask(pool, mask, occ)

    def _apply_converged_mask(self, pool: BucketPool, mask, occupants) -> None:
        """Mark slots the fetched token reports converged, for the same
        request that held the slot at dispatch; its done-after-tick count
        becomes the iterations its frozen flow reflects."""
        if self._conv_thresh <= 0.0 or mask is None:
            return
        bits = unpack_converged(mask, pool.capacity)
        for slot, rid, done_after in occupants:
            if not bits[slot]:
                continue
            m = pool.slots[slot]
            if m is not None and m.req.rid == rid and not m.converged:
                m.converged = True
                m.converged_done = done_after

    # -- the device deadline and the trace spans -----------------------------

    def _guarded_dispatch(self, live: List[Request], fn):
        """Run one dispatch, or the host's wait on one, under the
        per-dispatch device deadline (``apply_timeout_s``).

        Returns ``(result, tripped)``. On a trip the watcher thread has
        already failed ``live`` with ``DeadlineExceeded`` and counted it;
        ``fn`` still runs to its end (work queued on the card cannot be
        cancelled), and the caller drops its result and calls
        :meth:`_after_trip` before any further replay.
        """
        if self._watchdog is None:
            return fn(), False
        tripped: List[str] = []

        def on_timeout(name, _live=live, _tripped=tripped):
            # the watcher thread's callback: fail the dispatch's requests
            # and count the trip now (the stalled dispatch may hold the
            # worker a while yet; it is abandoned when it returns)
            _tripped.append(name)
            self._count("watchdog_trips")
            for r in _live:
                r.finish(error=DeadlineExceeded(f"device execution exceeded {self.config.apply_timeout_s:g}s"))

        with self._watchdog.section("serve/apply", on_timeout=on_timeout):
            out = fn()
        return out, bool(tripped)

    def _after_trip(self) -> None:
        """After a tripped dispatch: wait until the stream has drained the
        stalled work, so the next replay starts behind it and no abandoned
        replay still writes a buffer a later request reads."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _trace_queue_wait(self, live: List[Request], now: float) -> None:
        """Per-request span from submission to batch formation."""
        for r in live:
            if r.trace is not None:
                r.trace.add_span("queue_wait", r.t_submit, now)

    def _trace_span(self, live: List[Request], name: str, t0: float, t1: Optional[float] = None, **attrs) -> None:
        """One shared-timestamp span recorded on every sampled request."""
        if t1 is None:
            t1 = time.monotonic()
        for r in live:
            if r.trace is not None:
                r.trace.add_span(name, t0, t1, **attrs)

    # -- dispatch seams ----------------------------------------------------

    def _to_host(self, t: torch.Tensor, key, rows: int = 0) -> _Token:
        """``t`` on its way to the host: copied, behind the work that makes
        it, into the next buffer of a ring of ``pipeline_depth + 1`` pinned
        buffers (one ring per ``key``, each buffer room for ``rows`` rows),
        an event marking the copy's end; ``t`` itself on the CPU. A worker
        keeps at most ``pipeline_depth`` results unfetched, so a buffer
        comes round again only after its result was read."""
        if self.device.type != "cuda":
            return _Token(t)
        n = max(rows, t.shape[0])
        ring = self._host_rings.get(key)
        if ring is None or ring[0].shape[0] < n or ring[0].shape[1:] != t.shape[1:]:
            ring = self._host_rings[key] = [
                torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype, pin_memory=True)
                for _ in range(self.config.pipeline_depth + 1)
            ]
        ring.append(ring.pop(0))
        host = ring[-1][: t.shape[0]]
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _Token(host, event)

    def _run_batch(self, p1, p2, iters: int) -> torch.Tensor:
        """One padded pair batch's whole forward (host NHWC ``(rung, bh,
        bw, 3)`` images): its ``(rung, 2, bh, bw)`` flow on the device,
        valid until the program's next replay."""
        key = ("pairwise", p1.shape[0], p1.shape[1], p1.shape[2], int(iters))
        with profile.annotate("serve/pairwise"):
            return self.ledger.run(key, lambda: self._batch_progs.run_pairwise(p1, p2, iters))

    def _run_encode(self, frames):
        """One frame-encode batch (host NHWC): (feature map, raw context)
        on the device, valid until the program's next replay."""
        key = ("encode", frames.shape[0], frames.shape[1], frames.shape[2])
        with profile.annotate("serve/encode"):
            return self.ledger.run(key, lambda: self._batch_progs.run_encode(frames))

    def _run_iterate(self, f1, f2, ctx, iters: int) -> torch.Tensor:
        """One refinement batch from encoded frames (device tensors)."""
        key = ("iterate", f1.shape[0], f1.shape[2], f1.shape[3], int(iters))
        with profile.annotate("serve/iterate"):
            return self.ledger.run(key, lambda: self._batch_progs.run_iterate(f1, f2, ctx, iters))

    def _run_pool_begin_features(self, f1, f2, ctx, init_flow):
        """One pool admission from encoded frames, with the warm-start
        seed ``init_flow`` ``(r, 2, h8, w8)`` (zeros: the cold start)."""
        key = ("pool_begin_features", f1.shape[0], f1.shape[2], f1.shape[3])
        with profile.annotate("serve/pool_begin_features"):
            return self.ledger.run(key, lambda: self._pool_progs.run_begin_features(f1, f2, ctx, init_flow))

    def _request_flow(self, req: Request, flow: np.ndarray) -> np.ndarray:
        """Per-request output hook (a seam: tests poison a request's flow
        here, through the batch pass and its singles retry alike)."""
        return flow

    def _run_pool_begin(self, p1: torch.Tensor, p2: torch.Tensor):
        """One pool admission (pair encode + state init) from host NCHW
        images; the copy to the card happens here, on the worker."""
        key = ("pool_begin_pair", p1.shape[0], p1.shape[2], p1.shape[3])
        with profile.annotate("serve/pool_begin"):
            return self.ledger.run(key, lambda: self._pool_progs.run_begin_pair(p1, p2))

    def _run_pool_step(self, pool: BucketPool) -> _Token:
        """ONE refinement iteration across all of ``pool``'s slots, and its
        pacing token on its way to the host."""
        c = pool.state["coords1"]
        key = ("pool_step", c.shape[0], c.shape[2], c.shape[3])
        with profile.annotate("serve/pool_step"):
            return self.ledger.run(
                key, lambda: self._to_host(self._pool_progs.run_step(pool.state), ("token", pool.bucket))
            )

    def _run_pool_final(self, coords1, hidden) -> torch.Tensor:
        """The final upsample of retiring slots' carry."""
        key = ("pool_final", coords1.shape[0], coords1.shape[2], coords1.shape[3])
        with profile.annotate("serve/pool_final"):
            return self.ledger.run(key, lambda: self._pool_progs.run_final(coords1, hidden))

    def _pool_insert(self, state, rows, idx, mask):
        """Write the admission cohort's rows into their slots (eager index
        copies; padding lanes carry ``mask=False``)."""
        c = rows["coords1"]
        key = ("pool_insert", c.shape[0], c.shape[2], c.shape[3])
        return self.ledger.run(key, lambda: PoolPrograms.insert(state, rows, idx, mask))

    def _pool_gather(self, coords1, hidden, resid_hist, idx):
        """The recurrent carry + residual history of the slots in ``idx``."""
        key = ("pool_gather", len(idx), coords1.shape[2], coords1.shape[3])
        return self.ledger.run(key, lambda: PoolPrograms.gather(coords1, hidden, resid_hist, idx))

    # -- the stream session cache ----------------------------------------

    def _stream_transact(self, live: List[Request], fmap: torch.Tensor, ctx: torch.Tensor, finite: List[bool],
                         iters: int, level: int):
        """Transact each session's feature cache against an encode batch
        (shared by both engines; ``finite``: per live row, whether its
        maps are finite, :meth:`_encode_checked`). Primes finish at once; returns the
        requests that had a cached previous frame and their (prev fmap,
        new fmap, prev context, init_flow) rows for the refinement stage,
        the maps ``(1, C, h8, w8)`` on the device.

        ``init_flow`` (host ``(1, h8, w8, 2)``) is the warm-start seed: the
        previous pair's cached final flow forward-warped by itself, or
        zeros (the cold start, bit for bit) when warm start is off, the
        session has no flow yet, or the whole-request engine serves (its
        iterate takes no seed)."""
        h8, w8 = int(fmap.shape[2]), int(fmap.shape[3])
        zero_flow = np.zeros((1, h8, w8, 2), np.float32)
        flow_reqs: List[Request] = []
        rows: List[Tuple[Any, Any, Any, np.ndarray]] = []
        with self._streams_lock:
            for i, r in enumerate(live):
                st = self._streams.get(r.stream_id)
                if st is None:
                    st = _StreamState(r.stream_id, r.bucket, r.orig_hw)
                    self._streams[r.stream_id] = st
                    self._evict_streams_locked()
                self._streams.move_to_end(r.stream_id)
                if not finite[i]:
                    # an encoder-poisoned frame: never cache it, never pair it
                    st.fmap = st.ctx = st.flow8 = None
                    self._quarantine(r)
                    continue
                # copies out of the encode program's outputs, which its
                # next replay overwrites
                fm_new, cx_new = fmap[i:i + 1].clone(), ctx[i:i + 1].clone()
                prev_fm, prev_cx, prev_flow = st.fmap, st.ctx, st.flow8
                st.fmap, st.ctx = fm_new, cx_new
                st.flow8 = None  # consumed (or stale); refreshed at retirement
                if prev_fm is None:
                    self._count("encode_cache_misses")
                    self._count("stream_primes")
                    self._finish_ok(r, None, iters, level=level, primed=True)
                else:
                    self._count("encode_cache_hits")
                    init = zero_flow
                    if self._warm_start and prev_flow is not None:
                        init = forward_warp_flow(prev_flow)[None]
                        r.warm = True
                        self._count("stream_warm_starts")
                    flow_reqs.append(r)
                    rows.append((prev_fm, fm_new, prev_cx, init))
        return flow_reqs, rows

    def _store_stream_flow(self, stream_id: Optional[int], c1_row: np.ndarray) -> None:
        """Cache a retiring stream pair's final 1/8-grid flow (``coords1``
        ``(2, h8, w8)`` less the grid) on its session for the next
        admission's warm start; skipped when the session is gone or was
        invalidated meanwhile (a stream never warm-starts across a gap)."""
        if stream_id is None:
            return
        c1 = np.moveaxis(np.asarray(c1_row, np.float32), 0, -1)   # (h8, w8, 2), (x, y)
        h8, w8 = c1.shape[:2]
        ys, xs = np.meshgrid(np.arange(h8, dtype=np.float32), np.arange(w8, dtype=np.float32), indexing="ij")
        flow8 = c1 - np.stack([xs, ys], axis=-1)
        with self._streams_lock:
            st = self._streams.get(stream_id)
            if st is not None and st.fmap is not None:
                st.flow8 = flow8

    def _invalidate_stream(self, stream_id: Optional[int]) -> None:
        if stream_id is None:
            return
        with self._streams_lock:
            st = self._streams.get(stream_id)
            if st is not None and (st.fmap is not None or st.ctx is not None):
                st.fmap = st.ctx = st.flow8 = None
                self._count("stream_invalidations")

    def _evict_streams_locked(self) -> None:
        """LRU-evict cached sessions beyond the bound (never a busy one)."""
        excess = len(self._streams) - self.config.stream_cache_size
        if excess <= 0:
            return
        for sid in [s for s, st in self._streams.items() if not st.busy][:excess]:
            del self._streams[sid]
            self._count("stream_evictions")

    # -- completion and accounting ---------------------------------------

    def _quarantine(self, r: Request) -> None:
        r.finish(
            error=PoisonedInput(
                f"request {r.rid} produced non-finite flow even when executed "
                f"alone; quarantined (co-batched requests were unaffected)"
            )
        )
        with self._lock:
            self._counters["quarantined"] += 1
            self._quarantined_rids.append(r.rid)
            del self._quarantined_rids[:-100]
        self.recorder.record("quarantine", rid=r.rid, req_kind=r.kind)

    def _finish_ok(self, r: Request, flow: Optional[np.ndarray], iters: int, *, level: Optional[int] = None,
                   retried: bool = False, primed: bool = False, exit_reason: str = "target",
                   warm_started: bool = False, residuals: Optional[Tuple[float, ...]] = None) -> ServeResult:
        level = self._controller.level if level is None else level
        latency_ms = (time.monotonic() - r.t_submit) * 1e3
        if r.trace is not None:
            r.trace.annotate(bucket=f"{r.bucket[0]}x{r.bucket[1]}", level=level, num_flow_updates=iters,
                             retried_single=retried, primed=primed, exit_reason=exit_reason,
                             warm_started=warm_started, latency_ms=round(latency_ms, 3))
        result = ServeResult(
            flow=None if flow is None else self._router.crop(flow, r.orig_hw),
            rid=r.rid,
            bucket=r.bucket,
            num_flow_updates=iters,
            level=level,
            degraded=level > 0,
            latency_ms=latency_ms,
            slow_path=r.slow_path,
            retried_single=retried,
            primed=primed,
            exit_reason=exit_reason,
            trace_id=None if r.trace is None else r.trace.trace_id,
            residuals=residuals,
            warm_started=warm_started,
        )

        def _account(r_: Request) -> None:
            # counted BEFORE the waiter wakes, so a stats read issued after
            # the caller observed this result always sees it counted
            self._latency_hist.observe(latency_ms)
            if not r_.shadow:
                self._qos_stats.count(r_.priority, "completed")
                self._qos_stats.observe_latency(r_.priority, latency_ms)
            with self._lock:
                self._counters["shadow_completed" if r_.shadow else "completed"] += 1
                self._latency.setdefault(r_.bucket, []).append(latency_ms)
                del self._latency[r_.bucket][: -self.config.latency_window]

        r.finish(result=result, on_first=_account)
        return result

    def _count(self, key: str) -> None:
        with self._lock:
            self._counters[key] += 1

    # -- QoS ---------------------------------------------------------------

    def _qos_resolve(self, priority: Optional[str], tenant: Optional[str]) -> Tuple[str, str]:
        """The request's class and tenant (the config's defaults when
        unspecified; an unknown class raises ``InvalidInput``)."""
        cfg = self.config
        pr = validate_priority(priority if priority is not None else cfg.qos_default_priority)
        return pr, (tenant if tenant else cfg.qos_default_tenant)

    def _qos_charge(self, priority: str, tenant: str):
        """Charge one admission against the tenant's quota.

        Returns a one-shot releaser (attach it as a done callback AND call
        it on every abandonment path: only the first call releases), or
        ``None`` when QoS is off. Raises the retryable
        :class:`~raft_tpu_torch.serve.errors.QuotaExceeded` on breach."""
        policy = self._qos_policy
        if policy is None:
            return None
        try:
            policy.admit(tenant, priority)
        except QuotaExceeded as e:
            self._qos_stats.count(priority, "quota_refused")
            self.recorder.record("quota_breach", tenant=tenant, priority=priority, retry_after_ms=e.retry_after_ms)
            raise
        lock = threading.Lock()
        done = [False]

        def rel(_req=None):
            with lock:
                if done[0]:
                    return
                done[0] = True
            policy.release(tenant)

        return rel

    def _qos_preempted(self, preempted: List[Request], by: Request) -> None:
        """Finish queue-displaced lower-class victims with the typed
        retryable shed: a preempted request is never silently lost, and
        counts exactly once, as a shed."""
        if not preempted:
            return
        retry_ms = self._retry_after_ms()
        for v in preempted:
            err = Overloaded(
                f"request {v.rid} ({v.priority}) preempted by a higher-class arrival; retry in ~{retry_ms:.0f}ms",
                retry_after_ms=retry_ms,
            )
            if v.finish(error=err):
                self._count_outcome(v, "shed")
                if v.shadow:
                    continue
                self._qos_stats.count(v.priority, "preempted")
                self.recorder.record("qos_preempt", rid=v.rid, priority=v.priority, tenant=v.tenant, by_rid=by.rid,
                                     by_priority=by.priority, retry_after_ms=retry_ms)

    def _qos_levels(self, live: List[Request], iters: int, level: int) -> Tuple[int, int]:
        """Class-aware brownout of a whole-request batch: under pressure
        the batch runs at the highest class present's level (nobody's
        quality is cut below their class's entitlement); a batch of
        batch-class requests browns out first. Always a ladder rung, so
        always a captured program."""
        if not self.config.qos_enabled or level <= 0:
            return iters, level
        eff = brownout_level(level, min(r.rank for r in live), len(self._controller.ladder))
        return self._controller.ladder[eff], eff

    def _qos_forecast_slack(self, r: Request) -> float:
        """The pool's deadline forecast, by class: under pressure a
        lower-class slot forecasts with extra slack, so it cashes in the
        anytime ladder earlier and frees its slot for higher-class work."""
        if not self.config.qos_enabled or self._controller.level <= 0:
            return 1.0
        return 1.0 + 0.5 * r.rank

    def _shed_count(self) -> int:
        with self._lock:
            return self._counters["shed"]

    def _p99(self, bucket) -> Optional[float]:
        with self._lock:
            v = self._latency.get(bucket)
            if not v or len(v) < 8:
                return None
            return float(np.percentile(v, 99))

    def _retry_after_ms(self) -> float:
        """A shed caller's backoff hint. In the pool a queued request
        needs roughly (depth / capacity) cohorts of full-target
        iterations, each one tick (the EWMA tracks tick time); in the
        whole-request engine (depth / max_batch) batches (the EWMA tracks
        batch time)."""
        with self._lock:
            ewma = self._batch_ms_ewma
        depth = max(1, self._queue.depth())
        if self._pool_progs is not None:
            return max(1.0, math.ceil(depth / self._pool_cap) * self.config.ladder[0] * ewma)
        return max(1.0, math.ceil(depth / self._max_batch) * ewma)


def _pool_occupied(engine: Optional["ServeEngine"]) -> int:
    """Occupied slots across the engine's pools (0 once it is gone)."""
    return 0 if engine is None else sum(p.occupied_count() for p in engine._pools.values())


def _raise_copy(err: BaseException) -> None:
    """Raise a copy of a request's stored error. Raised itself, the stored
    error would take a traceback through the frames that hold its request,
    which holds the error: a reference cycle keeping the engine (and on the
    card its graphs) alive after ``stop()`` until a garbage collection."""
    raise copy.copy(err)


def _weakly(method, default):
    """``method`` called through a weak reference to its object:
    ``default`` once the object is gone."""
    ref = weakref.WeakMethod(method)

    def call():
        m = ref()
        return default if m is None else m()

    return call


def _alert_snapshot(counters, lock, drift) -> Dict[str, float]:
    """What the alert rules see: the engine counters plus the device-time
    drift gauge, one flat dict."""
    with lock:
        snap: Dict[str, float] = dict(counters)
    snap["device_time_drift"] = drift()
    return snap


def _nchw(x: np.ndarray) -> torch.Tensor:
    """Host ``(B, H, W, 3)`` -> host ``(B, 3, H, W)``, contiguous."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _nchw_rows(x: np.ndarray) -> np.ndarray:
    """A host ``(1, h, w, C)`` row as ``(1, C, h, w)``."""
    return np.moveaxis(x, -1, 1)


def _host_flow(flow: torch.Tensor) -> np.ndarray:
    """A device ``(B, 2, H, W)`` flow, now, as host ``(B, H, W, 2)``."""
    return flow.permute(0, 2, 3, 1).float().cpu().numpy()


def _stack_rows(rows: List[torch.Tensor], rung: int) -> torch.Tensor:
    """Device rows ``(1, ...)`` stacked and zero-padded to ``rung`` rows."""
    return torch.cat(rows + [torch.zeros_like(rows[0])] * (rung - len(rows)))

