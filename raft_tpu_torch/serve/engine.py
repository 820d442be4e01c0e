"""Fault-isolated serving engine for RAFT optical flow: the pool path.

The port of the JAX package's ``raft_tpu/serve/engine.py``, its default
path: ``submit`` through the resident GRU-iteration pool. One worker
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
     iteration target down the anytime ladder; in the pool a level is a
     per-request target fixed at admission.
  5. **quarantine** — slots are isolated by construction (inference is
     per sample end to end), so a request whose flow comes back
     non-finite fails alone with
     :class:`~raft_tpu_torch.serve.errors.PoisonedInput` while its
     neighbours finish.

The dispatch unit is one GRU iteration across a fixed slot array
(:mod:`raft_tpu_torch.serve.pool`): each loop retires slots whose
requests are done (target reached, converged, deadline-driven early exit
or expired), admits queued requests into freed slots, and advances every
occupied pool by ONE ``step``. Up to ``pipeline_depth`` ticks stay
dispatched but unfetched; the pacing token (the packed converged mask)
is copied to pinned host memory behind each tick and read when the window
is full.

On the card every program of the closed set is a CUDA graph
(:mod:`raft_tpu_torch.serve.aot`), captured at ``start()`` with
``warmup=True`` or on the worker at first use, and replayed after; a
failed capture raises and nothing falls back to eager execution. On the
CPU (``device='cpu'``) the same programs run eagerly.

Not ported yet (the engine raises ``NotImplementedError`` naming the
knob): the whole-request engine (``pool_capacity=0``), streams
(``open_stream``, ``stream_warm_start``), ``submit_many``, tiling
(``unknown_shape='tiled'``), QoS, tracing, the device-deadline watchdog
(``apply_timeout_s``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.device import resolve_device
from raft_tpu_torch.inference import FlowEstimator
from raft_tpu_torch.obs import RESIDUAL_BUCKETS, DeviceTimeLedger, MetricsRegistry
from raft_tpu_torch.serve import aot
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
    ServeError,
    ShapeRejected,
)
from raft_tpu_torch.serve.pool import (
    RESID_SENTINEL,
    BucketPool,
    PoolPrograms,
    _SlotMeta,
    unpack_converged,
    zero_state,
)
from raft_tpu_torch.serve.queue import MicroBatchQueue, Request

__all__ = ["ServeEngine", "ServeResult"]

_COUNTERS = (
    "submitted", "completed", "shed", "shed_slow_path", "rejected",
    "invalid", "expired", "quarantined", "batches", "slow_path",
    "worker_errors", "inflight_peak", "pool_ticks", "pool_admitted",
    "pool_resets", "idle_slot_iters", "dispatched_slot_iters",
    "early_exit_iters_saved", "early_exits_deadline",
    "early_exits_converged", "early_exit_iters_saved_deadline",
    "early_exit_iters_saved_converged", "drained",
)


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One served request: the flow plus how it was served.

    ``num_flow_updates``/``level`` report the degradation state the
    request actually ran at (``degraded`` is their boolean shadow).
    ``exit_reason`` says why refinement stopped where it did: ``'target'``
    (the request's own iteration target), ``'deadline'`` (finalized early
    because the deadline would have expired first) or ``'converged'``
    (the flow-update residual stayed below ``pool_converge_thresh``).
    """

    flow: np.ndarray                 # (H, W, 2) float32, caller resolution
    rid: int
    bucket: Tuple[int, int]
    num_flow_updates: int
    level: int
    degraded: bool
    latency_ms: float
    slow_path: bool = False
    exit_reason: str = "target"

    @property
    def early_exit(self) -> bool:
        """True when the request stopped before its own target."""
        return self.exit_reason in ("deadline", "converged")


def _check_ported(cfg: ServeConfig) -> None:
    """Refuse the knobs whose path the port has not reached: never run an
    approximation of it."""
    todo = [
        (cfg.pool_capacity == 0, "pool_capacity=0 (the whole-request batch engine)"),
        (cfg.stream_warm_start, "stream_warm_start (stream serving)"),
        (cfg.unknown_shape == "tiled", "unknown_shape='tiled' (the tiler)"),
        (cfg.apply_timeout_s is not None, "apply_timeout_s (the device-deadline watchdog)"),
        (cfg.trace_sample_rate > 0, "trace_sample_rate > 0 (request tracing)"),
        (cfg.qos_enabled, "qos_enabled (QoS enforcement)"),
    ]
    for asked, knob in todo:
        if asked:
            raise NotImplementedError(f"ServeConfig {knob} is not ported to raft_tpu_torch yet")


class _Token:
    """A tick's pacing token on its way to the host: the packed converged
    mask, copied into pinned memory behind the tick (an event marks the
    copy's end), or the mask itself on the CPU."""

    __slots__ = ("host", "event")

    def __init__(self, host, event=None):
        self.host = host
        self.event = event

    def fetch(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy().copy()


class ServeEngine:
    """Deadline-aware, load-shedding, degradation-capable RAFT server.

    Args:
        model: a built :class:`~raft_tpu_torch.models.RAFT` (a torch
            module carries its weights); moved to ``device``, eval mode.
        config: the :class:`ServeConfig`; default ``ServeConfig()``.
        device: the CUDA card unless ``'cpu'`` is named; raises when no
            card is present.

    Example::

        cfg = ServeConfig(buckets=((440, 1024),), warmup=True)
        with ServeEngine(raft_for_serving(ServeConfig.preset("quality")), cfg) as engine:
            result = engine.submit(image1, image2)   # ServeResult
    """

    def __init__(self, model, config: Optional[ServeConfig] = None, *, device=None):
        self.config = cfg = config or ServeConfig()
        _check_ported(cfg)
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._router = BucketRouter(cfg.buckets)
        self._queue = MicroBatchQueue(cfg.queue_capacity)
        self._controller = DegradationController(
            cfg.ladder,
            slo_p99_ms=cfg.slo_p99_ms,
            high_watermark=cfg.high_watermark,
            low_watermark=cfg.low_watermark,
            cooldown=cfg.cooldown_batches,
            recover_after=cfg.recover_after,
        )
        self._slow_tokens = TokenBucket(cfg.slow_path_per_s, cfg.slow_path_burst)
        # the slow path's whole-request forward: one graph per (natural
        # shape, iterations), captured and replayed on the worker
        self._apply = FlowEstimator(self.model, num_flow_updates=cfg.ladder[0], device=self.device)
        self._pools: Dict[Tuple[int, int], BucketPool] = {}
        self._pool_cap = cfg.pool_capacity
        self._admit_ladder: Tuple[int, ...] = cfg.resolved_admit_ladder()
        self._admit_cap = self._admit_ladder[-1]
        # residual-history length = the full-quality iteration target, so
        # any admitted request's whole trajectory fits the rolling window
        self._resid_len = cfg.ladder[0]
        self._conv_thresh = float(cfg.pool_converge_thresh or 0.0)
        self._pool_progs = PoolPrograms(self.model, self.device, resid_len=self._resid_len)
        self._pool_progs.set_knobs(
            self._conv_thresh,
            min(cfg.pool_converge_streak, self._resid_len),
            min(max(cfg.pool_min_iters, 1), self._resid_len),
        )
        # per bucket: a ring of pinned host buffers for the pacing tokens
        self._token_rings: Dict[Tuple[int, int], List[Any]] = {}
        self._lock = threading.Lock()
        self.metrics = MetricsRegistry("serve")
        self._counters = self.metrics.counter_group("counters", _COUNTERS)
        self._latency_hist = self.metrics.histogram("latency_ms")
        self.ledger = DeviceTimeLedger(cfg.ledger_sample_every, device=self.device, registry=self.metrics)
        self._resid_final = self.metrics.histogram("final_residual", bounds=RESIDUAL_BUCKETS)
        self._resid_iter_sum = np.zeros(self._resid_len)
        self._resid_iter_cnt = np.zeros(self._resid_len, np.int64)
        self.metrics.gauge("queue_depth", self._queue.depth)
        self.metrics.gauge("degradation_level", lambda: self._controller.level)
        self.metrics.gauge("num_flow_updates", lambda: self._controller.num_flow_updates)
        self.metrics.gauge(
            "pool_occupied", lambda: sum(p.occupied_count() for p in self._pools.values())
        )
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
        self._ready = threading.Event()
        self._thread: Optional[threading.Thread] = None

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
        if self.config.warmup:
            self._warmup()
        self._thread = threading.Thread(target=self._worker_pool, name="raft-serve-worker", daemon=True)
        self._thread.start()
        self._ready.set()
        self._boot["boot_to_ready_ms"] = (time.monotonic() - t0) * 1e3
        self._boot["captures"] = aot.capture_events() - ev0
        return self

    def stop(self) -> None:
        self._stop.set()
        for req in self._queue.close():
            req.finish(error=EngineStopped("engine stopping"))
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._ready.clear()

    @property
    def is_draining(self) -> bool:
        """True between :meth:`drain` and :meth:`stop`."""
        return self._draining.is_set()

    def drain(self, *, timeout: Optional[float] = 30.0) -> bool:
        """Quiesce without dropping accepted work.

        Three phases, in order: stop admitting (``submit`` raises the
        retryable :class:`~raft_tpu_torch.serve.errors.Draining`); fail
        queued requests with the same ``Draining``; let the pool retire
        every resident at its own target. Returns True once quiesced
        within ``timeout`` seconds (``None`` waits forever), False on
        timeout. Idempotent."""
        self._draining.set()
        retry_ms = self.config.drain_retry_after_ms
        for req in self._queue.drain():
            if req.finish(
                error=Draining(
                    f"engine draining for restart; retry in ~{retry_ms:.0f}ms",
                    retry_after_ms=retry_ms,
                )
            ):
                self._count("drained")
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._quiesced():
            if not (self._thread is not None and self._thread.is_alive()):
                return self._quiesced()
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def _quiesced(self) -> bool:
        """Nothing queued, no batch popped but not yet admitted, no pool
        residents."""
        if self._queue.depth() or self._queue.forming():
            return False
        return all(p.occupied_count() == 0 for p in self._pools.values())

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
        (:func:`raft_tpu_torch.serve.aot.warm_engine`), then run one
        admission -> step -> retirement chain per bucket as a smoke check
        that the captured set replays."""
        with torch.inference_mode(), self._on_device():
            self._boot.update(aot.warm_engine(self))
            self._smoke_pool()

    def _smoke_pool(self) -> None:
        r = self._admit_ladder[0]
        for bucket in self._router.buckets:
            bh, bw = bucket
            pool = self._pool_for(bucket)
            z = torch.zeros((r, 3, bh, bw), dtype=torch.float32)
            rows = self._run_pool_begin(z, z)
            self._pool_insert(pool.state, rows, np.zeros((r,), np.int64), np.asarray([True] + [False] * (r - 1)))
            self._run_pool_step(pool).fetch()
            c1, hid, _ = self._pool_gather(
                pool.state["coords1"], pool.state["hidden"], pool.state["resid_hist"], np.zeros((r,), np.int64)
            )
            self._run_pool_final(c1, hid).cpu()
            self._boot["smoke_runs"] += 1

    def _on_device(self):
        """The worker's device context (the card's index), or nothing on
        the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # -- public API --------------------------------------------------------

    def submit(self, image1, image2, *, deadline_ms: Optional[float] = None,
               num_flow_updates: Optional[int] = None) -> ServeResult:
        """Serve one raw [0, 255] ``(H, W, 3)`` pair; returns :class:`ServeResult`.

        ``num_flow_updates`` caps this request's refinement iterations
        (validated against the full-quality ``ladder[0]``); the pool
        honors it exactly. Blocks the calling thread until the result,
        the deadline, or a typed :class:`~raft_tpu_torch.serve.errors.
        ServeError`."""
        deadline_ms = self._check_live(deadline_ms)
        iters = self._validate_iters(num_flow_updates)
        p1, p2, hw = self._admit(image1, image2)
        bucket = self._router.route(*hw)
        rid = self._new_rid()
        deadline = time.monotonic() + deadline_ms / 1e3
        if bucket is None:
            return self._submit_slow(rid, p1, p2, hw, deadline, deadline_ms, iters)
        req = Request(
            rid, bucket, self._router.pad_to(p1, bucket), self._router.pad_to(p2, bucket), hw, deadline,
            iters=iters,
        )
        return self._enqueue_and_wait(req, deadline_ms)

    def open_stream(self):
        """Stream serving is not ported yet."""
        raise NotImplementedError(
            "ServeConfig stream_cache_size / open_stream (stream serving) is not ported to raft_tpu_torch yet"
        )

    def health(self) -> dict:
        """Liveness/readiness for an external supervisor or LB probe."""
        with self._lock:
            quarantined = self._counters["quarantined"]
        return {
            "ready": self._ready.is_set(),
            "healthy": self._thread is not None and self._thread.is_alive() and not self._stop.is_set(),
            "draining": self._draining.is_set(),
            "queue_depth": self._queue.depth(),
            "queue_capacity": self.config.queue_capacity,
            "level": self._controller.level,
            "num_flow_updates": self._controller.num_flow_updates,
            "quarantined": quarantined,
        }

    def stats(self) -> dict:
        """Serving counters + degradation + per-bucket latency quantiles +
        pool occupancy, convergence, device-time ledger, captured-program
        counts and the kernel launches the graphs' replays made."""
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
        # idle-slot-iterations / dispatched-slot-iterations: the fraction
        # of dispatched refinement work that advanced nobody
        padding_waste = counters["idle_slot_iters"] / disp_si if disp_si else 0.0
        pools = list(self._pools.values())
        return {
            **counters,
            "padding_waste": padding_waste,
            "boot": dict(self._boot),
            "ledger": self.ledger.breakdown(),
            "convergence": {
                "threshold": self.config.pool_converge_thresh,
                "streak": self.config.pool_converge_streak,
                "n": self._resid_final.count,
                "final_residual_p50": self._resid_final.quantile(0.50),
                "final_residual_p99": self._resid_final.quantile(0.99),
                "resid_by_iter": [round(float(s / c), 6) if c else None for s, c in zip(r_sum, r_cnt)],
            },
            "pool": {
                "capacity": self._pool_cap,
                "occupied": sum(p.occupied_count() for p in pools),
                "ticks": counters["pool_ticks"],
                "occupancy": 1.0 - padding_waste if disp_si else 0.0,
                "ttfd_p50_ms": float(np.percentile(ttfd, 50)) if ttfd else None,
                "tick_ms_ewma": float(np.mean([p.tick_ewma_ms for p in pools])) if pools else None,
            },
            "programs": self.program_counts(),
            "launches": self.graph_launches(),
            "degradation": self._controller.snapshot(),
            "latency": latency,
            "quarantined_rids": quarantined,
        }

    def device_time_breakdown(self) -> Dict[str, Any]:
        """Per-program-family device-time attribution from the ledger
        (empty when ``config.ledger_sample_every == 0``)."""
        return self.ledger.breakdown()

    def program_counts(self) -> Dict[str, int]:
        """Captured-program count per program family (-1 on the CPU, where
        nothing is captured). After ``warmup=True`` these stay constant
        under any admitted traffic: the worker never captures."""
        counts = {"pairwise": len(self._apply.programs()) if self.device.type == "cuda" else -1}
        counts.update(self._pool_progs.counts())
        return counts

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by this engine's graph replays, by kernel
        (replays x launches per graph; the wrappers count eager launches
        only)."""
        total = dict(self._apply.graph_launches())
        for prog in self._pool_progs.graphs().values():
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

    def _new_rid(self) -> int:
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._counters["submitted"] += 1
        return rid

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

    def _enqueue_and_wait(self, req: Request, deadline_ms: float) -> ServeResult:
        try:
            self._queue.put(req, retry_after_ms=self._retry_after_ms())
        except Overloaded:
            self._count("shed")
            raise
        if not req.wait(max(0.0, req.remaining) + 0.05):
            # worker still busy past our deadline: fail caller-side (set-once
            # means a simultaneous worker finish wins harmlessly)
            req.finish(error=DeadlineExceeded(f"request {req.rid} missed its {deadline_ms:.0f}ms deadline"))
            self._count("expired")
        if req.error is not None:
            raise req.error
        return req.result

    def _submit_slow(self, rid, p1, p2, hw, deadline, deadline_ms, req_iters=None) -> ServeResult:
        """Un-bucketed shape: reject, or queue it rate-limited for the
        worker, which runs it alone (:meth:`_run_slow`)."""
        if self.config.unknown_shape == "reject":
            self._count("rejected")
            buckets = tuple(self._router.buckets)
            raise ShapeRejected(
                f"no bucket admits shape {hw} (buckets: {list(buckets)}); "
                f"resize, reconfigure, or set unknown_shape='slow_path'",
                supported_buckets=buckets,
                nearest=_nearest_bucket(hw, buckets),
            )
        if not self._slow_tokens.try_take():
            self._count("shed_slow_path")
            raise Overloaded(
                f"slow path over its {self.config.slow_path_per_s}/s rate",
                retry_after_ms=self._slow_tokens.retry_after_ms(),
            )
        shape = self._router.natural_shape(*hw)
        req = Request(
            rid, shape, self._router.pad_to(p1, shape), self._router.pad_to(p2, shape), hw, deadline,
            slow_path=True, kind="slow", iters=req_iters,
        )
        return self._enqueue_and_wait(req, deadline_ms)

    def _run_slow(self, req: Request) -> None:
        """One slow-path request on the worker: the whole-request forward
        at its natural shape (its graph captured here on first use)."""
        iters = self._controller.num_flow_updates
        if req.iters is not None:
            iters = min(iters, req.iters)
        key = ("pairwise", 1, req.bucket[0], req.bucket[1], int(iters))
        flow = self.ledger.run(key, lambda: self._apply._forward(req.p1, req.p2, iters))[0]
        if not np.isfinite(flow).all():
            self._quarantine(req)
            return
        self._count("slow_path")
        self._finish_ok(req, flow, iters)

    # -- the pool worker -------------------------------------------------

    def _pool_for(self, bucket: Tuple[int, int]) -> BucketPool:
        """The bucket's pool, allocated (and its step captured, before any
        slot holds a request: the capture's eager warm-up runs a step)
        on first use."""
        pool = self._pools.get(bucket)
        if pool is None:
            state = zero_state(self._pool_progs, self._pool_cap, bucket)
            self._pool_progs.capture_step(state)
            if self.device.type == "cuda":
                token_bytes = -(-self._pool_cap // 8)
                self._token_rings[bucket] = [
                    torch.empty((token_bytes,), dtype=torch.uint8, pin_memory=True)
                    for _ in range(self.config.pipeline_depth + 1)
                ]
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
            self._pool_fail_all(EngineStopped("engine stopping"))
        for r in self._queue.close():
            r.finish(error=EngineStopped("engine stopping"))

    def _pool_fail_all(self, err: ServeError) -> None:
        for pool in self._pools.values():
            metas = pool.clear()
            for m in metas:
                m.req.finish(error=err)
            if metas:
                with self._lock:
                    self._counters["pool_resets"] += 1

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
                    self._count("expired")
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
                and remaining_ms < (need + 1) * pool.tick_ewma_ms
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
        c1, hid, res = self._pool_gather(pool.state["coords1"], pool.state["hidden"], pool.state["resid_hist"], idx)
        flows = self._run_pool_final(c1, hid).permute(0, 2, 3, 1).float().cpu().numpy()
        resids = res.cpu().numpy()
        with self._lock:
            self._counters["batches"] += 1
        for pos, (i, meta, reason) in enumerate(due):
            r = meta.req
            f = flows[pos]
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
                self._finish_ok(r, f, eff, level=meta.level, exit_reason=reason)
            else:
                self._quarantine(r)
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
                self._pool_admit_pairs(pool, live, ctrl_iters, level)
        except Exception as e:  # isolation: fail the admission, not the worker
            self._count("worker_errors")
            err = ServeError(f"pool admission failed: {e!r}")
            for r in live:
                r.finish(error=err)
        finally:
            # ack only once the cohort is visible downstream, so drain()'s
            # quiesce check never races the pop
            self._queue.task_done()

    def _filter_live(self, batch: List[Request]) -> List[Request]:
        """Fail queue-expired requests."""
        live: List[Request] = []
        for r in batch:
            if r.done or r.remaining <= 0:
                if r.finish(error=DeadlineExceeded(f"request {r.rid} expired in queue")):
                    self._count("expired")
            else:
                live.append(r)
        return live

    def _observe(self, live: List[Request]) -> Tuple[int, int]:
        depth_now = self._queue.depth() + len(live)
        iters = self._controller.observe(
            min(1.0, depth_now / self._queue.capacity), self._p99(live[0].bucket)
        )
        return iters, self._controller.level

    def _pool_admit_pairs(self, pool: BucketPool, live: List[Request], ctrl_iters: int, level: int) -> None:
        bh, bw = pool.bucket
        rung = self._rung_admit(len(live))
        pad = [np.zeros((1, bh, bw, 3), np.float32)] * (rung - len(live))
        p1 = np.concatenate([r.p1 for r in live] + pad)
        p2 = np.concatenate([r.p2 for r in live] + pad)
        rows = self._run_pool_begin(_nchw(p1), _nchw(p2))
        self._pool_insert_live(pool, rows, live, ctrl_iters, level)

    def _pool_insert_live(self, pool: BucketPool, rows, live: List[Request], ctrl_iters: int, level: int) -> None:
        """Write each admitted request's rows into a free slot. The
        per-request iteration target is fixed here: the request's own
        ``num_flow_updates`` capped by the degradation level's target."""
        now = time.monotonic()
        rung = int(rows["coords1"].shape[0])
        slots = [pool.alloc() for _ in live]
        idx = np.asarray(slots + [0] * (rung - len(slots)), np.int64)
        mask = np.asarray([True] * len(slots) + [False] * (rung - len(slots)), bool)
        self._pool_insert(pool.state, rows, idx, mask)
        for i, r in zip(slots, live):
            requested = r.iters if r.iters is not None else self.config.ladder[0]
            pool.slots[i] = _SlotMeta(req=r, target=max(1, min(requested, ctrl_iters)), level=level, admitted_t=now)
            with self._lock:
                self._counters["pool_admitted"] += 1
                self._ttfd.append((now - r.t_submit) * 1e3)
                del self._ttfd[: -self.config.latency_window]

    def _pool_tick(self, pool: BucketPool) -> None:
        """Advance every slot of ``pool`` by ONE refinement iteration.
        Already-converged slots are frozen on device (idle slot
        iterations). When the pacing window is full, the oldest tick's
        token — its packed converged mask — is fetched."""
        occupied = pool.occupied()
        live_n = len(occupied)
        frozen_n = sum(1 for _, m in occupied if m.converged)
        token = self._run_pool_step(pool)
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
            mask = tok.fetch()
            pool.note_drain(time.monotonic())
            with self._lock:
                self._batch_ms_ewma += 0.2 * (pool.tick_ewma_ms - self._batch_ms_ewma)
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

    # -- dispatch seams ----------------------------------------------------

    def _run_pool_begin(self, p1: torch.Tensor, p2: torch.Tensor):
        """One pool admission (pair encode + state init) from host NCHW
        images; the copy to the card happens here, on the worker."""
        key = ("pool_begin_pair", p1.shape[0], p1.shape[2], p1.shape[3])
        return self.ledger.run(key, lambda: self._pool_progs.run_begin_pair(p1, p2))

    def _run_pool_step(self, pool: BucketPool) -> _Token:
        """ONE refinement iteration across all of ``pool``'s slots, and its
        pacing token on its way to the host."""
        c = pool.state["coords1"]
        key = ("pool_step", c.shape[0], c.shape[2], c.shape[3])

        def run():
            token = self._pool_progs.run_step(pool.state)
            if self.device.type != "cuda":
                return _Token(token)
            ring = self._token_rings[pool.bucket]
            ring.append(ring.pop(0))
            host = ring[-1]
            host.copy_(token, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return _Token(host, event)

        return self.ledger.run(key, run)

    def _run_pool_final(self, coords1, hidden) -> torch.Tensor:
        """The final upsample of retiring slots' carry."""
        key = ("pool_final", coords1.shape[0], coords1.shape[2], coords1.shape[3])
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

    def _finish_ok(self, r: Request, flow: np.ndarray, iters: int, *, level: Optional[int] = None,
                   exit_reason: str = "target") -> ServeResult:
        level = self._controller.level if level is None else level
        latency_ms = (time.monotonic() - r.t_submit) * 1e3
        result = ServeResult(
            flow=self._router.crop(flow, r.orig_hw),
            rid=r.rid,
            bucket=r.bucket,
            num_flow_updates=iters,
            level=level,
            degraded=level > 0,
            latency_ms=latency_ms,
            slow_path=r.slow_path,
            exit_reason=exit_reason,
        )

        def _account(r_: Request) -> None:
            # counted BEFORE the waiter wakes, so a stats read issued after
            # the caller observed this result always sees it counted
            self._latency_hist.observe(latency_ms)
            with self._lock:
                self._counters["completed"] += 1
                self._latency.setdefault(r_.bucket, []).append(latency_ms)
                del self._latency[r_.bucket][: -self.config.latency_window]

        r.finish(result=result, on_first=_account)
        return result

    def _count(self, key: str) -> None:
        with self._lock:
            self._counters[key] += 1

    def _p99(self, bucket) -> Optional[float]:
        with self._lock:
            v = self._latency.get(bucket)
            if not v or len(v) < 8:
                return None
            return float(np.percentile(v, 99))

    def _retry_after_ms(self) -> float:
        """A shed caller's backoff hint: a queued request needs roughly
        (depth / capacity) cohorts of full-target iterations, each one
        tick (the EWMA tracks tick time)."""
        with self._lock:
            ewma = self._batch_ms_ewma
        cohorts = math.ceil(max(1, self._queue.depth()) / self._pool_cap)
        return max(1.0, cohorts * self.config.ladder[0] * ewma)


def _nchw(x: np.ndarray) -> torch.Tensor:
    """Host ``(B, H, W, 3)`` -> host ``(B, 3, H, W)``, contiguous."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def _nearest_bucket(hw: Tuple[int, int], buckets) -> Optional[Tuple[int, int]]:
    """The bucket a rejected caller should resize toward (the JAX
    package's ``tiler.nearest_bucket``): the smallest containing bucket,
    else the least L1 shape distance, ties to the smaller area, then to
    configuration order."""
    if not buckets:
        return None
    containing = [b for b in buckets if b[0] >= hw[0] and b[1] >= hw[1]]
    if containing:
        return min(containing, key=lambda b: (b[0] * b[1], b))
    best = min(buckets, key=lambda b: (abs(b[0] - hw[0]) + abs(b[1] - hw[1]), b[0] * b[1]))
    return (int(best[0]), int(best[1]))
