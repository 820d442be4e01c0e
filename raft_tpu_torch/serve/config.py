"""Serving configuration: the named precision presets and every knob of the
serving engine in one validated dataclass.

The port's copy of the JAX package's ``raft_tpu/serve/config.py`` (the
port cannot import it: importing ``raft_tpu.serve`` loads jax), with the
same defaults and error messages. ``PRESETS`` maps each deployment preset
to :class:`~raft_tpu_torch.models.RAFTConfig` precision knobs that change
activation and storage casts only, never the parameters:

  quality     fp32 everywhere, the paper-native reference point.
  throughput  bf16 convs + bf16 correlation storage on the fused kernel,
              the default serving preset.
  edge        int8 correlation storage on the fused kernel with fp32
              convs; inference only (the quantized lookup has no gradient).

The defaults encode the paper-native operating point: ``ladder=(32, 20,
12)`` spans the published 32-iteration protocol down to the common fast
setting (``num_flow_updates`` is a runtime accuracy/latency dial, which is
what makes degradation under load a first-class mechanism). Buckets are
**padded** ``(H, W)`` shapes (each divisible by 8, the model contract).

The JAX package's AOT artifact and compilation-cache knobs
(``warmup_artifact``, ``compilation_cache_dir``, ``warmup_workers``) and
its mesh (``mesh_devices``) have no field here: the port captures CUDA
graphs at every boot, on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["PRESETS", "ServeConfig"]

PRESETS: Dict[str, Dict[str, Optional[str]]] = {
    "quality": dict(
        compute_dtype="float32", corr_dtype=None, corr_impl=None,
    ),
    "throughput": dict(
        compute_dtype="bfloat16", corr_dtype="bfloat16", corr_impl="fused",
    ),
    "edge": dict(
        compute_dtype="float32", corr_dtype="int8", corr_impl="fused",
    ),
}


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs for :class:`raft_tpu_torch.serve.ServeEngine`.

    Args:
        buckets: admitted padded shapes, each ``(H, W)`` divisible by 8.
            An input is routed to the smallest-area bucket that contains
            its %8-padded shape.
        pool_capacity: slots per bucket in the resident iteration pool —
            the dispatch unit is one GRU *iteration* across all slots
            (continuous batching over RAFT's anytime refinement loop).
            Requests join a slot when admitted, advance one
            ``iterate_step`` per tick, and leave as soon as their own
            iteration target (the per-request ``num_flow_updates``, a
            degradation target, or a deadline-driven early exit) is met.
            ``0`` is the whole-request engine: a formed batch runs the
            whole forward at the next rung of ``batch_ladder`` (the one
            engine that serves ``edge``: the int8 pyramid's scale is
            batch-wide, so its rows cannot move between slots).
        pool_min_iters: floor on refinement iterations a pooled request
            runs before a deadline-driven or convergence exit may
            finalize it.
        pool_early_exit: finalize a pooled request whose deadline would
            expire before its remaining iterations finish at its current
            iteration count instead of letting it expire.
        pool_converge_thresh: residual-driven early exit — retire a
            pooled request once its flow-update residual (the per-slot
            RMS ||delta flow|| the step program reduces on device,
            1/8-grid pixels) has stayed below this threshold for
            ``pool_converge_streak`` consecutive iterations. Converged
            slots freeze on device and the converged mask rides the tick
            pacing token. ``None`` (default) disables. The threshold is
            a 0-dim device tensor the step graph reads, so any threshold
            runs on the one captured step program.
        pool_converge_streak: consecutive sub-threshold residuals
            required before a slot counts as converged (must fit the
            residual history, ``<= ladder[0]``, when the feature is on).
        stream_warm_start: seed each stream pair with the previous
            pair's forward-warped 1/8-grid flow (pool engine only).
        max_batch: how many queued requests are encoded and admitted per
            tick; with ``pool_capacity`` it bounds the admission ladder.
        batch_ladder: ascending padded batch sizes; must start at 1 and
            end at ``max_batch``. ``None`` derives the powers-of-two
            ladder ``(1, 2, 4, ..., max_batch)``.
        pipeline_depth: bound on dispatched-but-unfetched pool ticks or
            whole-request batches (1 = strictly synchronous).
        stream_cache_size: LRU bound on cached stream sessions
            (``open_stream``); ``0`` disables stream serving and its
            programs.
        max_wait_ms: how long the batch thread waits for stragglers after
            the first request of a batch arrives (capped by that request's
            own deadline slack).
        queue_capacity: bound on queued requests; an arrival beyond it is
            shed with a retryable :class:`~raft_tpu_torch.serve.errors.
            Overloaded`.
        default_deadline_ms: deadline applied when a request carries none.
        ladder: descending ``num_flow_updates`` degradation ladder;
            ``ladder[0]`` is full quality, the last entry the floor.
        slo_p99_ms: p99 latency objective; ``None`` disables the latency
            trigger (queue pressure still degrades).
        high_watermark / low_watermark: queue-fullness fractions that
            trigger a degradation step down / allow a step back up.
        cooldown_batches: minimum batches between controller level moves.
        recover_after: consecutive calm batches required per step back up.
        unknown_shape: ``'reject'`` (default) fails un-bucketed shapes at
            admission with :class:`~raft_tpu_torch.serve.errors.
            ShapeRejected`; ``'slow_path'`` queues them rate-limited for
            the worker, which runs each whole between pool ticks (a novel
            shape costs one graph capture there, kept for the engine's
            life); ``'tiled'`` fans the pair into bucket-shaped tiles
            (:mod:`raft_tpu_torch.serve.tiler`) served through the
            captured set, no new capture, and blends the per-tile flows
            on the host (results carry ``tiled=True``).
        slow_path_per_s / slow_path_burst: sustained slow-path admission
            rate (token bucket) and its burst.
        tile_overlap_px: per-seam overlap floor for the tile planner;
            must be >= the 8 px 1/8-grid receptive margin.
        tile_pad_penalty: cost-model weight on the replicate-padded
            fraction of dispatched tile pixels (0 = tile count only).
        tile_max_tiles: upper bound on tiles per request; a shape whose
            cheapest plan exceeds it is ``ShapeRejected`` even under
            ``'tiled'``.
        apply_timeout_s: device-execution deadline per dispatch, enforced
            by a callback-mode :class:`~raft_tpu_torch.utils.faults.
            Watchdog` around each dispatch AND the host's wait on it (a
            replay returns once queued: the wait is where a device stall
            shows). A trip fails the dispatch's requests with
            :class:`~raft_tpu_torch.serve.errors.DeadlineExceeded` from
            the watcher thread, dumps a postmortem bundle, resets the
            pool (``pool_reset``), and the worker drains the stream
            before its next replay. ``None`` (default) disables.
        warmup: capture the worker's whole program set inside
            ``start()``, so readiness implies the worker never captures.
        precision / compute_dtype / corr_dtype / corr_impl: the
            deployment precision of the *model this engine serves* —
            see :meth:`preset` and :meth:`model_overrides`. The engine
            itself never casts.
        drain_retry_after_ms: the backoff hint carried by the typed
            :class:`~raft_tpu_torch.serve.errors.Draining` error.
        trace_sample_rate: fraction of requests recorded as traces
            (:mod:`raft_tpu_torch.obs.trace`; deterministic
            counter-based sampling, no RNG). ``0`` (default) disables:
            the hot path then pays one attribute check per span site.
            Sampled results carry ``trace_id``; the finished records
            live on ``engine.tracer`` and the flight recorder's ring.
        ledger_sample_every: device-time ledger cadence: every Kth
            execution of each program family is timed
            (:mod:`raft_tpu_torch.obs.ledger`); 0 disables.
        alert_short_window_s / alert_long_window_s: the two windows of
            the burn-rate alert engine (:mod:`raft_tpu_torch.obs.alerts`).
            A rule fires only when its burn exceeds threshold over BOTH
            windows (fast detection + blip rejection) and resolves with
            hysteresis. Engine rules: SLO burn (expired+shed fraction of
            submissions, page severity — fires the postmortem dump),
            quarantine fraction, watchdog-trip rate (page), device-time
            EWMA drift. Exposed via ``engine.alerts()`` / the ``alerts``
            stats block / per-rule Prometheus gauges.
        latency_window: per-bucket ring-buffer size for p50/p99 tracking.
        log_every_batches: serving-counter cadence through the engine's
            ``logger`` (a :class:`~raft_tpu_torch.utils.logging.
            MetricLogger`): one record every this many batches, and one
            at ``stop()``.
        qos_enabled: multi-tenant QoS enforcement. Off (default) the
            serve path is the priority-blind engine: priority/tenant ride
            along as accounting only. On, admission charges per-tenant
            quotas (``qos_tenant_quotas``), a full queue sheds lowest-
            class-first (an interactive arrival preempts a queued batch
            request; the victim gets a retryable ``Overloaded``), batch
            formation seeds highest-class-first with the ``qos_aging_ms``
            starvation guard, and degradation and the pool's
            deadline-forecast retirement brown out low classes first.
        qos_default_priority: class assumed when a request carries none
            (``'interactive'`` | ``'standard'`` | ``'batch'``).
        qos_default_tenant: tenant assumed when a request carries none.
        qos_tenant_quotas: per-tenant admission quotas, a tuple of
            ``(tenant, rate_rps, burst, max_concurrent)`` rows.
            ``rate_rps <= 0`` disables the rate arm, ``max_concurrent <=
            0`` the concurrency arm; an unlisted tenant is unlimited. An
            over-quota request is refused with the retryable
            :class:`~raft_tpu_torch.serve.errors.QuotaExceeded` before the
            queue ever sees it.
        qos_aging_ms: starvation guard — a queued request older than
            this competes at interactive rank: it can no longer be
            preempted and it seeds batches first.
    """

    buckets: Tuple[Tuple[int, int], ...] = ((440, 1024),)
    pool_capacity: int = 8
    pool_min_iters: int = 1
    pool_early_exit: bool = True
    pool_converge_thresh: Optional[float] = None
    pool_converge_streak: int = 2
    stream_warm_start: bool = False
    max_batch: int = 8
    batch_ladder: Optional[Tuple[int, ...]] = None
    pipeline_depth: int = 2
    stream_cache_size: int = 16
    max_wait_ms: float = 5.0
    queue_capacity: int = 64
    default_deadline_ms: float = 1000.0
    ladder: Tuple[int, ...] = (32, 20, 12)
    slo_p99_ms: Optional[float] = None
    high_watermark: float = 0.75
    low_watermark: float = 0.25
    cooldown_batches: int = 2
    recover_after: int = 2
    unknown_shape: str = "reject"
    slow_path_per_s: float = 1.0
    slow_path_burst: int = 2
    tile_overlap_px: int = 16
    tile_pad_penalty: float = 1.0
    tile_max_tiles: int = 64
    apply_timeout_s: Optional[float] = None
    warmup: bool = False
    precision: Optional[str] = None
    compute_dtype: str = "float32"
    corr_dtype: Optional[str] = None
    corr_impl: Optional[str] = None
    drain_retry_after_ms: float = 2000.0
    trace_sample_rate: float = 0.0
    ledger_sample_every: int = 0
    alert_short_window_s: float = 5.0
    alert_long_window_s: float = 60.0
    latency_window: int = 256
    log_every_batches: int = 50
    qos_enabled: bool = False
    qos_default_priority: str = "standard"
    qos_default_tenant: str = "default"
    qos_tenant_quotas: Tuple[Tuple[str, float, float, int], ...] = ()
    qos_aging_ms: float = 500.0

    @classmethod
    def preset(cls, name: str = "throughput", **overrides) -> "ServeConfig":
        """A named deployment preset (default ``'throughput'``); any field
        can be overridden."""
        if name not in PRESETS:
            raise ValueError(
                f"unknown precision preset {name!r}; choose from {sorted(PRESETS)}"
            )
        kw = dict(PRESETS[name], precision=name)
        kw.update(overrides)
        return cls(**kw)

    def model_overrides(self) -> Dict[str, Optional[str]]:
        """The :class:`~raft_tpu_torch.models.RAFTConfig` overrides this
        config's precision fields imply (only non-default knobs, so it
        composes with any base architecture)."""
        kw: Dict[str, Optional[str]] = {}
        if self.compute_dtype != "float32":
            kw["compute_dtype"] = self.compute_dtype
        if self.corr_dtype is not None:
            kw["corr_dtype"] = self.corr_dtype
        if self.corr_impl is not None:
            kw["corr_impl"] = self.corr_impl
        return kw

    def resolved_batch_ladder(self) -> Tuple[int, ...]:
        """The effective ascending rung set (defaults to powers of two)."""
        if self.batch_ladder is not None:
            return tuple(self.batch_ladder)
        rungs = [1]
        while rungs[-1] * 2 < self.max_batch:
            rungs.append(rungs[-1] * 2)
        if rungs[-1] != self.max_batch:
            rungs.append(self.max_batch)
        return tuple(rungs)

    def resolved_admit_ladder(self) -> Tuple[int, ...]:
        """Admission rungs for the iteration pool: the batch ladder capped
        at ``min(max_batch, pool_capacity)`` (a tick never admits more
        requests than it has free slots or encode bandwidth for)."""
        cap = min(self.max_batch, max(1, self.pool_capacity))
        rungs = [r for r in self.resolved_batch_ladder() if r < cap]
        return tuple(rungs) + (cap,)

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("at least one shape bucket is required")
        for b in self.buckets:
            if len(b) != 2 or b[0] <= 0 or b[1] <= 0:
                raise ValueError(f"bucket must be positive (H, W), got {b!r}")
            if b[0] % 8 or b[1] % 8:
                raise ValueError(
                    f"bucket {b!r} violates the %8 model contract; configure "
                    f"padded shapes (H and W divisible by 8)"
                )
        if len(set(self.buckets)) != len(self.buckets):
            raise ValueError(f"duplicate buckets in {self.buckets!r}")
        if not self.ladder or any(i <= 0 for i in self.ladder):
            raise ValueError(f"ladder must be positive iters, got {self.ladder!r}")
        if list(self.ladder) != sorted(self.ladder, reverse=True) or len(
            set(self.ladder)
        ) != len(self.ladder):
            raise ValueError(
                f"ladder must be strictly descending (full -> floor), got "
                f"{self.ladder!r}"
            )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.batch_ladder is not None:
            bl = tuple(self.batch_ladder)
            if not bl or any(int(b) != b or b < 1 for b in bl):
                raise ValueError(
                    f"batch_ladder must be positive ints, got {bl!r}"
                )
            if list(bl) != sorted(set(bl)):
                raise ValueError(
                    f"batch_ladder must be strictly ascending, got {bl!r}"
                )
            if bl[0] != 1:
                raise ValueError(
                    f"batch_ladder must start at 1 (the singles-isolation "
                    f"retry size), got {bl!r}"
                )
            if bl[-1] != self.max_batch:
                raise ValueError(
                    f"batch_ladder must end at max_batch={self.max_batch}, "
                    f"got {bl!r}"
                )
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {self.pipeline_depth}"
            )
        if self.pool_capacity < 0:
            raise ValueError(
                f"pool_capacity must be >= 0 (0 = whole-request batch "
                f"fallback), got {self.pool_capacity}"
            )
        if self.pool_min_iters < 1:
            raise ValueError(
                f"pool_min_iters must be >= 1, got {self.pool_min_iters}"
            )
        if self.pool_converge_thresh is not None and not (
            self.pool_converge_thresh > 0.0
        ):
            raise ValueError(
                f"pool_converge_thresh must be positive or None (off), "
                f"got {self.pool_converge_thresh}"
            )
        if self.pool_converge_streak < 1:
            raise ValueError(
                f"pool_converge_streak must be >= 1, got "
                f"{self.pool_converge_streak}"
            )
        if (
            self.pool_converge_thresh is not None
            and self.pool_converge_streak > self.ladder[0]
        ):
            # only enforced when the feature is ON: the default streak
            # must not invalidate existing short-ladder configs
            raise ValueError(
                f"pool_converge_streak ({self.pool_converge_streak}) must "
                f"fit the residual history (ladder[0]={self.ladder[0]}): a "
                f"streak longer than the full-quality target can never fire"
            )
        if self.stream_cache_size < 0:
            raise ValueError(
                f"stream_cache_size must be >= 0, got {self.stream_cache_size}"
            )
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {self.queue_capacity}"
            )
        if self.unknown_shape not in ("reject", "slow_path", "tiled"):
            raise ValueError(
                f"unknown_shape must be 'reject', 'slow_path', or "
                f"'tiled', got {self.unknown_shape!r}"
            )
        # tiler knobs: validated even under 'reject', so a config later
        # flipped to 'tiled' cannot carry a latent bad plan
        if self.tile_overlap_px < 8:
            raise ValueError(
                f"tile_overlap_px must be >= 8 (the 1/8-grid receptive "
                f"margin), got {self.tile_overlap_px}"
            )
        if self.tile_pad_penalty < 0:
            raise ValueError(
                f"tile_pad_penalty must be >= 0, got "
                f"{self.tile_pad_penalty}"
            )
        if self.tile_max_tiles < 1:
            raise ValueError(
                f"tile_max_tiles must be >= 1, got {self.tile_max_tiles}"
            )
        if not (0.0 <= self.low_watermark <= self.high_watermark <= 1.0):
            raise ValueError(
                f"need 0 <= low_watermark <= high_watermark <= 1, got "
                f"{self.low_watermark} / {self.high_watermark}"
            )
        if self.max_wait_ms < 0 or self.default_deadline_ms <= 0:
            raise ValueError("max_wait_ms must be >= 0 and default_deadline_ms > 0")
        if self.apply_timeout_s is not None and self.apply_timeout_s <= 0:
            raise ValueError(
                f"apply_timeout_s must be positive or None, got "
                f"{self.apply_timeout_s}"
            )
        if self.drain_retry_after_ms <= 0:
            raise ValueError(
                f"drain_retry_after_ms must be positive, got "
                f"{self.drain_retry_after_ms}"
            )
        if not (0.0 <= self.trace_sample_rate <= 1.0):
            raise ValueError(
                f"trace_sample_rate must be in [0, 1], got "
                f"{self.trace_sample_rate}"
            )
        if self.ledger_sample_every < 0:
            raise ValueError(
                f"ledger_sample_every must be >= 0 (0 = off), got "
                f"{self.ledger_sample_every}"
            )
        if not (0 < self.alert_short_window_s <= self.alert_long_window_s):
            raise ValueError(
                f"need 0 < alert_short_window_s <= alert_long_window_s, "
                f"got {self.alert_short_window_s} / "
                f"{self.alert_long_window_s}"
            )
        if self.precision is not None and self.precision not in PRESETS:
            raise ValueError(
                f"unknown precision preset {self.precision!r}; choose "
                f"from {sorted(PRESETS)}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}"
            )
        if self.corr_dtype not in (None, "bfloat16", "int8"):
            raise ValueError(
                f"corr_dtype must be None, 'bfloat16', or 'int8', got "
                f"{self.corr_dtype!r}"
            )
        if self.corr_dtype == "int8" and self.corr_impl != "fused":
            raise ValueError(
                "corr_dtype='int8' requires corr_impl='fused' (the "
                "quantized pyramid lives in the fused lookup kernel)"
            )
        # QoS: validated even when disabled, so a config that will later
        # be flipped on cannot carry a latent bad quota table
        _qos_classes = ("interactive", "standard", "batch")
        if self.qos_default_priority not in _qos_classes:
            raise ValueError(
                f"qos_default_priority must be one of {_qos_classes}, got "
                f"{self.qos_default_priority!r}"
            )
        if not self.qos_default_tenant:
            raise ValueError("qos_default_tenant must be a non-empty string")
        if self.qos_aging_ms <= 0:
            raise ValueError(
                f"qos_aging_ms must be positive, got {self.qos_aging_ms}"
            )
        seen_tenants = set()
        for row in self.qos_tenant_quotas:
            if len(row) != 4:
                raise ValueError(
                    f"each qos_tenant_quotas row must be (tenant, rate_rps, "
                    f"burst, max_concurrent), got {row!r}"
                )
            tenant, rate_rps, burst, max_conc = row
            if not tenant or not isinstance(tenant, str):
                raise ValueError(
                    f"quota tenant must be a non-empty string, got {tenant!r}"
                )
            if tenant in seen_tenants:
                raise ValueError(f"duplicate quota row for tenant {tenant!r}")
            seen_tenants.add(tenant)
            if rate_rps > 0 and burst < 1:
                raise ValueError(
                    f"quota burst must be >= 1 when rate_rps > 0, got "
                    f"{burst!r} for tenant {tenant!r}"
                )
            if int(max_conc) != max_conc:
                raise ValueError(
                    f"quota max_concurrent must be an int, got {max_conc!r} "
                    f"for tenant {tenant!r}"
                )
