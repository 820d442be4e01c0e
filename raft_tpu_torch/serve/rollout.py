"""Guarded rollouts: shadow mirroring, canary promotion, auto-rollback.

The port's copy of the JAX package's ``raft_tpu/serve/rollout.py``. A
:class:`RolloutController` makes deploying a new checkpoint or config a
supervised, reversible operation on a
:class:`~raft_tpu_torch.serve.router.ServeRouter` (created by
:meth:`~raft_tpu_torch.serve.router.ServeRouter.add_candidate`):

* **shadow**: the router duplicates a deterministic counter-sampled
  fraction of live pair, tiled and stream traffic to a *candidate*
  replica, AFTER the live reply is produced (the caller's latency is
  untouched). Mirrored submits are fire-and-forget through a bounded queue
  (a full queue is a counted shed, never a blocked caller), never retried,
  and ride the engine's ``shadow=True`` seam, so they land in the
  ``shadow_*`` twin counters: outside QoS quotas and every counter the
  autoscaler's signals and the burn-rate alerts read.
* **paired diff gate**: every mirrored request yields a candidate result
  to compare with the live one: endpoint-flow disagreement on the 1/8 grid
  (mean and p99 px), latency ratio, extra updates a request, and error
  rate, in a bounded sample ring judged with the two-window discipline of
  :mod:`raft_tpu_torch.obs.alerts` (a metric breaches only when it exceeds
  its threshold over BOTH the short and the long window).
* **canary**: once the shadow gate has held for its window, a
  deterministic 1-in-k fraction of live *pair* dispatches is served by the
  candidate for real (streams keep their ring home: spilling one would
  thrash its encoder cache). A failed canary request falls back into the
  router's re-route loop and is served by an incumbent, never dropped.
  Mirroring goes on over the non-canary remainder.
* **promoted / rolled back**: when the canary gate holds, the candidate's
  factory and overrides are rolled across the fleet through the draining
  restart, one replica at a time, each checked against the candidate's
  ``variables_hash``. A gate breach, a candidate crash or eviction (the
  candidate rides the router's heartbeat-to-evict ladder) or a failed
  promotion rolls back: canary routing stops at once, the candidate is
  torn down, and any promoted replica is restarted onto its saved
  factory, so the fleet converges to one ``variables_hash``.

Every transition is a flight-recorder event (``rollout_*``) on the
router's recorder, and a rollback dumps a postmortem bundle.
:meth:`RolloutController.wait` blocks until the ladder ends: the final
snapshot on promotion, the typed
:class:`~raft_tpu_torch.serve.errors.RolloutAborted` on rollback.

A thread-backed candidate's mirrors ride ``shadow=True``. A process
candidate's wire has no ``shadow`` key (the JAX wire's), so its mirrors go
out without it and land in that worker's own counters, which the fleet
does not see. The controller holds its router weakly, as the
:class:`~raft_tpu_torch.serve.autoscale.Autoscaler` does: the router holds
the controller, and neither sits in a reference cycle; at every terminal
stage the mirror queue (which holds the callers' closures, images and
live results) is drained and the candidate lets go of its stopped engine,
so the engine is freed without a collection.
"""

from __future__ import annotations

import collections
import dataclasses
import queue as _queue
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.serve.errors import RolloutAborted, ServeError
from raft_tpu_torch.serve.replica import Replica, ReplicaState

__all__ = ["RolloutConfig", "RolloutController", "RolloutStage"]


class RolloutStage:
    """Ladder stages (plain strings, JSON-able, like ReplicaState)."""

    SHADOW = "shadow"
    CANARY = "canary"
    PROMOTING = "promoting"
    PROMOTED = "promoted"
    ROLLED_BACK = "rolled_back"

    TERMINAL = (PROMOTED, ROLLED_BACK)


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Knobs for :class:`RolloutController`.

    Args:
        mirror_fraction: fraction of live traffic duplicated to the
            candidate during shadow and canary (deterministic 1-in-k
            counter sampling, k = round(1/fraction): no RNG on the hot path).
        canary_fraction: fraction of live pair dispatches served by the
            candidate during canary (the same counter sampling).
        mirror_queue_depth: bound on queued mirror work; a full queue
            sheds the mirror (counted), never blocks the caller.
        min_samples: paired diffs the long window must hold before the
            gate is trusted (to advance OR to breach): a stage never
            advances on silence, and one early outlier cannot roll back.
        shadow_hold_s / canary_hold_s: how long each stage's gate must
            hold (breach-free, sample floor met) before advancing.
        short_window_s / long_window_s: the two gate windows (a breach
            needs BOTH over threshold).
        flow_diff_mean_px: gate on the window-mean endpoint-flow
            disagreement (px on the 1/8 grid) between candidate and live.
        flow_diff_p99_px: gate on the window-mean of per-request p99
            disagreement.
        latency_ratio: gate on the candidate/live mean latency ratio.
        iters_delta: gate on the mean extra flow updates a request the
            candidate needed (a convergence regression).
        error_rate: gate on the candidate's mirrored and canary failure
            fraction.
        auto_promote: advance canary -> promoted without an operator;
            False parks the ladder at canary until :meth:`promote`.
        candidate_deadline_ms: deadline for mirrored submits (``None``:
            the router's default deadline).
    """

    mirror_fraction: float = 0.25
    canary_fraction: float = 0.125
    mirror_queue_depth: int = 64
    min_samples: int = 16
    shadow_hold_s: float = 5.0
    canary_hold_s: float = 5.0
    short_window_s: float = 2.0
    long_window_s: float = 10.0
    flow_diff_mean_px: float = 1.0
    flow_diff_p99_px: float = 4.0
    latency_ratio: float = 3.0
    iters_delta: float = 8.0
    error_rate: float = 0.25
    auto_promote: bool = True
    candidate_deadline_ms: Optional[float] = None

    def __post_init__(self):
        if not (0.0 < self.mirror_fraction <= 1.0):
            raise ValueError(f"mirror_fraction must be in (0, 1], got {self.mirror_fraction}")
        if not (0.0 < self.canary_fraction <= 1.0):
            raise ValueError(f"canary_fraction must be in (0, 1], got {self.canary_fraction}")
        if self.mirror_queue_depth < 1:
            raise ValueError(f"mirror_queue_depth must be >= 1, got {self.mirror_queue_depth}")
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {self.min_samples}")
        if not (0 < self.short_window_s <= self.long_window_s):
            raise ValueError(
                f"need 0 < short_window_s <= long_window_s, got {self.short_window_s} / {self.long_window_s}"
            )
        for name in ("flow_diff_mean_px", "flow_diff_p99_px", "latency_ratio", "iters_delta", "error_rate"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive, got {getattr(self, name)}")


def _every(fraction: float) -> int:
    """Deterministic sampling stride: mirror or canary every k-th request."""
    return max(1, int(round(1.0 / fraction)))


def _flow_diff(live_flow, cand_flow) -> Optional[Tuple[float, float]]:
    """Endpoint disagreement (mean, p99) in px on the subsampled 1/8 grid,
    or None when the pair is not comparable (a primed frame, a shape
    mismatch, a missing or non-finite flow)."""
    if live_flow is None or cand_flow is None:
        return None
    a = np.asarray(live_flow)[::8, ::8]
    b = np.asarray(cand_flow)[::8, ::8]
    if a.shape != b.shape:
        return None
    epe = np.sqrt(np.sum((a - b) ** 2, axis=-1, dtype=np.float64))
    if epe.size == 0 or not np.all(np.isfinite(epe)):
        return None
    return float(epe.mean()), float(np.percentile(epe, 99))


class _DiffGate:
    """Bounded paired-diff windows and the two-window breach judgement.

    One sample per mirrored pair (or canary outcome), timestamped into a
    ring; each gate metric is recomputed over the short AND the long
    window and breaches only when both exceed the threshold with the
    sample floor met. ``now`` is the clock (injectable for tests).
    """

    def __init__(self, config: RolloutConfig, now=time.monotonic):
        self.config = config
        self._now = now
        self._ring: "collections.deque" = collections.deque(maxlen=2048)
        self._lock = threading.Lock()

    def add(self, *, flow_mean: Optional[float] = None, flow_p99: Optional[float] = None,
            lat_live_ms: Optional[float] = None, lat_cand_ms: Optional[float] = None,
            iters_live: Optional[int] = None, iters_cand: Optional[int] = None, error: bool = False) -> None:
        with self._lock:
            self._ring.append((self._now(), {
                "flow_mean": flow_mean,
                "flow_p99": flow_p99,
                "lat_live_ms": lat_live_ms,
                "lat_cand_ms": lat_cand_ms,
                "iters_live": iters_live,
                "iters_cand": iters_cand,
                "error": 1.0 if error else 0.0,
            }))

    def _window(self, window_s: float) -> List[Dict[str, Any]]:
        cut = self._now() - window_s
        return [s for (t, s) in self._ring if t >= cut]

    @staticmethod
    def _metrics(samples: List[Dict[str, Any]]) -> Dict[str, Optional[float]]:
        def vals(key):
            return [s[key] for s in samples if s[key] is not None]

        flow, p99s = vals("flow_mean"), vals("flow_p99")
        ll, lc = vals("lat_live_ms"), vals("lat_cand_ms")
        il, ic = vals("iters_live"), vals("iters_cand")
        errs = [s["error"] for s in samples]
        return {
            "samples": float(len(samples)),
            "flow_mean_px": sum(flow) / len(flow) if flow else None,
            "flow_p99_px": sum(p99s) / len(p99s) if p99s else None,
            "latency_ratio": (sum(lc) / len(lc)) / max(1e-9, sum(ll) / len(ll)) if ll and lc else None,
            "iters_delta": sum(ic) / len(ic) - sum(il) / len(il) if il and ic else None,
            "error_rate": sum(errs) / len(errs) if errs else None,
        }

    def evaluate(self) -> Dict[str, Any]:
        """Both windows' metrics and the verdict. ``breach`` names the
        first over-threshold metric (None while the gate holds); ``ready``
        is True once the long window carries the sample floor (a gate that
        has seen nothing neither advances nor rolls back)."""
        cfg = self.config
        with self._lock:
            short = self._metrics(self._window(cfg.short_window_s))
            long_ = self._metrics(self._window(cfg.long_window_s))
        ready = long_["samples"] >= cfg.min_samples
        breach = None
        checks = (
            ("flow_mean", "flow_mean_px", cfg.flow_diff_mean_px),
            ("flow_p99", "flow_p99_px", cfg.flow_diff_p99_px),
            ("latency", "latency_ratio", cfg.latency_ratio),
            ("iters", "iters_delta", cfg.iters_delta),
            ("errors", "error_rate", cfg.error_rate),
        )
        if ready:
            for reason, key, thr in checks:
                s, l = short[key], long_[key]
                if s is not None and l is not None and s > thr and l > thr:
                    breach = reason
                    break
        return {"ready": bool(ready), "breach": breach, "short": short, "long": long_}


class RolloutController:
    """Drives one candidate through shadow -> canary -> promoted.

    Owned by the router (created by
    :meth:`~raft_tpu_torch.serve.router.ServeRouter.add_candidate`), which
    it holds weakly. The candidate
    :class:`~raft_tpu_torch.serve.replica.Replica` lives OUTSIDE the
    router's replica list: invisible to dispatch picks, the stream ring,
    the stats aggregate, the autoscaler and the fleet's Prometheus series;
    it is reached only through the mirror queue and the canary pick, both
    implemented here. The router's monitor beats the candidate and calls
    :meth:`maybe_observe` each beat (no control thread of its own).
    """

    def __init__(self, router, candidate: Replica, overrides: Dict[str, Any],
                 config: Optional[RolloutConfig] = None):
        self._router = weakref.ref(router)
        self.candidate = candidate
        self.overrides = dict(overrides)
        self.config = config or RolloutConfig()
        self.gate = _DiffGate(self.config)
        self.stage = RolloutStage.SHADOW
        self.abort_reason: Optional[str] = None
        self._stage_t0 = time.monotonic()
        self._t_start = self._stage_t0
        self._stage_history: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._mirror_seq = 0
        self._canary_seq = 0
        self._mirror_every = _every(self.config.mirror_fraction)
        self._canary_every = _every(self.config.canary_fraction)
        # mirror errors by class name: the evidence the gate's error_rate sums
        self.mirror_errors: Dict[str, int] = {}
        self.canary_routed = 0
        self.canary_errors = 0
        self.promoted_replicas: List[str] = []
        # replica_id -> incumbent factory, saved BEFORE promotion touches
        # the replica: rollback restores from here, so even a restart that
        # completes after the rollback (or one that failed mid-drain)
        # converges back to the incumbent build
        self._saved_factories: Dict[str, Callable] = {}
        self.rollbacks = 0
        # a candidate behind a worker client has the wire's fixed signature:
        # the shadow flag stays on this side, and its mirrored load lands in
        # the worker's own (fleet-invisible) counters
        self._shadow_kw = candidate.backend == "thread"
        self._mirror_q: "_queue.Queue" = _queue.Queue(maxsize=self.config.mirror_queue_depth)
        self._mirror_thread = threading.Thread(target=self._mirror_loop, name="raft-rollout-mirror", daemon=True)
        self._promote_thread: Optional[threading.Thread] = None
        self._note_stage(RolloutStage.SHADOW, from_stage=None)
        self._mirror_thread.start()

    @property
    def router(self):
        """The router this ladder runs on (held weakly; None once freed)."""
        return self._router()

    # -- hot-path hooks (called from the router's dispatch) ----------------

    def maybe_mirror(self, kind: str, fn: Callable, live_res) -> None:
        """Counter-sampled, fire-and-forget duplication of one live
        result's request to the candidate. Runs on the caller's thread
        AFTER the live reply exists: a counter and a bounded put; a full
        queue sheds the mirror (counted), never the caller."""
        if self.stage not in (RolloutStage.SHADOW, RolloutStage.CANARY):
            return
        if self.candidate.state != ReplicaState.HEALTHY:
            return
        if getattr(live_res, "slow_path", False):
            return  # a slow-path flow is a rate-limited oddity, not signal
        with self._lock:
            self._mirror_seq += 1
            if self._mirror_seq % self._mirror_every != 0:
                return
        try:
            self._mirror_q.put_nowait((kind, fn, live_res))
        except _queue.Full:
            router = self.router
            if router is not None:
                with router._lock:
                    router._counters["mirror_shed"] += 1

    def maybe_canary_pick(self, kind: str) -> Optional[Replica]:
        """During canary, claim every k-th live *pair* dispatch for the
        candidate (streams keep their ring home). The dispatch loop treats
        the returned replica like any other: a candidate shed or fault
        falls through to the incumbents, so a canary request is re-served,
        never dropped."""
        if self.stage != RolloutStage.CANARY or kind != "pair":
            return None
        cand = self.candidate
        if cand.state != ReplicaState.HEALTHY:
            return None
        with self._lock:
            self._canary_seq += 1
            if self._canary_seq % self._canary_every != 0:
                return None
            self.canary_routed += 1
        router = self.router
        if router is not None:
            with router._lock:
                router._counters["canary_routed"] += 1
        return cand

    def note_canary_outcome(self, ok: bool, latency_ms: Optional[float], iters: Optional[int]) -> None:
        """Canary outcomes feed the same gate as mirrored diffs: a
        candidate failing real traffic breaches ``error_rate`` exactly as
        one failing mirrored traffic."""
        if not ok:
            with self._lock:
                self.canary_errors += 1
        self.gate.add(lat_cand_ms=latency_ms, iters_cand=iters, error=not ok)

    # -- mirror worker -----------------------------------------------------

    def _mirror_loop(self) -> None:
        while True:
            item = self._mirror_q.get()
            if item is None or self.stage in RolloutStage.TERMINAL:
                return
            try:
                self._mirror_one(*item)
            except Exception:
                pass  # the mirror lane never takes anything down
            # hold nothing of a served mirror while parked on the queue
            del item

    def _mirror_one(self, kind: str, fn: Callable, live_res) -> None:
        eng = self.candidate.engine
        router = self.router
        if eng is None or router is None or self.stage in RolloutStage.TERMINAL:
            return
        deadline_ms = self.config.candidate_deadline_ms or router._default_deadline_ms
        with router._lock:
            router._counters["mirrored"] += 1
        try:
            res = fn(eng, deadline_ms, **({"shadow": True} if self._shadow_kw else {}))
        except Exception as e:
            # a typed shed is counted, never retried: the error mix is the
            # evidence, and a retry would only blur it
            name = type(e).__name__
            with self._lock:
                self.mirror_errors[name] = self.mirror_errors.get(name, 0) + 1
            self.gate.add(error=True)
            return
        # stream frames reach the candidate at the mirror stride, so its
        # warm-start state lags the live replica's frame history: their
        # flow gap measures the stride, not the weights. Streams feed
        # latency, iterations and errors; only stateless pairs feed the
        # flow gate.
        diff = _flow_diff(getattr(live_res, "flow", None), getattr(res, "flow", None)) if kind == "pair" else None
        self.gate.add(
            flow_mean=diff[0] if diff else None,
            flow_p99=diff[1] if diff else None,
            lat_live_ms=getattr(live_res, "latency_ms", None),
            lat_cand_ms=getattr(res, "latency_ms", None),
            iters_live=getattr(live_res, "num_flow_updates", None),
            iters_cand=getattr(res, "num_flow_updates", None),
            error=False,
        )

    # -- control loop (driven by the router's monitor thread) --------------

    def maybe_observe(self) -> None:
        """One monitor beat: candidate health, gate verdict, stage clock.
        Every failure converges to rollback; nothing here raises into the
        monitor."""
        stage = self.stage
        if stage in RolloutStage.TERMINAL or stage == RolloutStage.PROMOTING:
            return
        router = self.router
        if router is None:
            return
        if self.candidate.state != ReplicaState.HEALTHY:
            # the candidate rides the fleet's heartbeat-to-evict ladder (the
            # router beats it just before this call); an evicted or crashed
            # candidate is a rollback, not a readmission
            self._rollback("candidate_crash")
            return
        verdict = self.gate.evaluate()
        if verdict["breach"] is not None:
            router.recorder.record(
                "rollout_breach", stage=stage, reason=verdict["breach"],
                short=_round_metrics(verdict["short"]), long=_round_metrics(verdict["long"]),
            )
            self._rollback(verdict["breach"])
            return
        held_s = time.monotonic() - self._stage_t0
        if stage == RolloutStage.SHADOW:
            if verdict["ready"] and held_s >= self.config.shadow_hold_s:
                self._note_stage(RolloutStage.CANARY, from_stage=stage)
        elif stage == RolloutStage.CANARY:
            if verdict["ready"] and held_s >= self.config.canary_hold_s and self.config.auto_promote:
                self.promote()

    def promote(self) -> None:
        """Advance canary -> promoting (idempotent); the rolling restart
        runs on its own thread: a fleet-wide drain cycle must never stall
        the monitor beat that triggered it."""
        with self._lock:
            if self.stage != RolloutStage.CANARY:
                return
            self._promote_thread = threading.Thread(target=self._do_promote, name="raft-rollout-promote",
                                                    daemon=True)
        self._note_stage(RolloutStage.PROMOTING, from_stage=RolloutStage.CANARY)
        self._promote_thread.start()

    def _do_promote(self) -> None:
        """Roll the candidate's factory and overrides across every
        incumbent through the zero-drop draining restart, then retire the
        candidate. The candidate's *factory* is installed first: a
        draining restart rebuilds a replica through its own stored
        factory, so a restart alone would boot the OLD weights while
        reporting "promoted". Each restart is then checked against the
        candidate's ``variables_hash``: a replica back on other weights is
        a rollback. A restart failure mid-fleet rolls every touched
        replica back; the fleet converges to ONE weights hash either way."""
        router = self.router
        if router is None:
            return
        cand_factory = self.candidate.factory
        cand_hash = self.candidate.variables_hash
        for rep in router.replicas:
            if self.stage != RolloutStage.PROMOTING:
                return  # rolled back under us
            with self._lock:
                self._saved_factories.setdefault(rep.replica_id, rep.factory)
            rep.factory = cand_factory
            try:
                router.restart_replica(rep.replica_id, graceful=True, **self.overrides)
            except Exception:
                self._rollback("promote_failed")
                return
            if cand_hash is not None and rep.variables_hash is not None and rep.variables_hash != cand_hash:
                # the rebuilt replica does not serve the candidate's
                # weights (a non-deterministic factory, a checkpoint that
                # moved): never report this as promoted
                self._rollback("promote_hash_mismatch")
                return
            with self._lock:
                self.promoted_replicas.append(rep.replica_id)
        self._retire_candidate()
        self._note_stage(RolloutStage.PROMOTED, from_stage=RolloutStage.PROMOTING)
        router.recorder.record("rollout_promoted", replicas=list(self.promoted_replicas),
                               variables_hash=self.candidate.variables_hash)
        self._done.set()

    # -- rollback ----------------------------------------------------------

    def _rollback(self, reason: str) -> None:
        with self._lock:
            if self.stage in RolloutStage.TERMINAL:
                return
            from_stage = self.stage
            self.abort_reason = reason
            self.rollbacks += 1
            promoted = list(self.promoted_replicas)
        # the stage flips FIRST: the dispatch hooks read it without the
        # lock, so the canary pick and mirroring stop before the (slow)
        # teardown below begins
        self._note_stage(RolloutStage.ROLLED_BACK, from_stage=from_stage)
        router = self.router
        if router is not None:
            router.recorder.record("rollout_rollback", stage=from_stage, reason=reason, promoted=promoted,
                                   canary_routed=self.canary_routed)
        # un-promote on a worker thread: each restart is a full drain cycle
        # and rollback may fire from the monitor beat
        threading.Thread(target=self._undo, name="raft-rollout-rollback", daemon=True).start()
        # a rollback is exactly the incident the recorder exists for
        try:
            router.dump_postmortem(f"rollout_rollback:{reason}", extra={"rollout": self.snapshot()})
        except Exception:
            pass

    def _undo(self) -> None:
        """Restore every replica promotion touched. The touched set is read
        AFTER the promote thread has been joined: a restart in flight when
        the rollback fired is in ``_saved_factories`` (saved before it
        began), so the fleet converges to the incumbent build even when a
        rollback races a mid-drain promotion."""
        pt = self._promote_thread
        if pt is not None and pt is not threading.current_thread():
            pt.join()
        with self._lock:
            touched = dict(self._saved_factories)
        router = self.router
        for rid, factory in touched.items():
            rep = None if router is None else router._by_id.get(rid)
            if rep is None:
                continue  # removed (a scale-down) meanwhile
            rep.factory = factory
            try:
                router.restart_replica(rid, graceful=True)
            except Exception:
                pass  # an unrestartable replica is the monitor's (its factory is restored)
        self._retire_candidate()
        self._done.set()

    def _retire_candidate(self) -> None:
        """Stop the candidate's engine and let go of it (with the mirror
        queue drained, nothing holds it: it is freed without a
        collection). The candidate is marked stopped first: the monitor
        beats a healthy candidate while the ladder is promoting, and a
        beat on its stopping engine would evict it."""
        self._stop_mirror()
        if self.candidate.state != ReplicaState.UNHEALTHY:
            self.candidate.state = ReplicaState.STOPPED
        try:
            self.candidate.stop_engine(graceful=False)
        except Exception:
            pass
        self.candidate.engine = None

    def _stop_mirror(self) -> None:
        """Terminal-stage cleanup: drain the queued mirror work (it holds
        the callers' closures and live results) and release the worker
        thread with the None sentinel, so repeated rollouts on one router
        leave no parked thread behind."""
        while True:
            try:
                self._mirror_q.get_nowait()
            except _queue.Empty:
                break
        try:
            self._mirror_q.put_nowait(None)
        except _queue.Full:
            pass  # racing mirrors refilled the queue; the loop's own terminal check retires it

    def shutdown(self) -> None:
        """Router teardown: stop the mirror worker and the candidate. A
        ladder still running ends as a rollback (reason ``'shutdown'``),
        so ``wait()`` never hangs."""
        if self.stage not in RolloutStage.TERMINAL:
            with self._lock:
                if self.stage not in RolloutStage.TERMINAL:
                    self.abort_reason = self.abort_reason or "shutdown"
                    from_stage = self.stage
                    self.stage = RolloutStage.ROLLED_BACK
                    self._stage_history.append({
                        "stage": RolloutStage.ROLLED_BACK,
                        "from": from_stage,
                        "t_s": round(time.monotonic() - self._t_start, 3),
                    })
            self._retire_candidate()
            self._done.set()
        try:
            self._mirror_q.put_nowait(None)
        except _queue.Full:
            pass

    # -- operator surface --------------------------------------------------

    def wait(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until the ladder ends. Returns the final snapshot on
        promotion; raises :class:`RolloutAborted` on rollback and
        :class:`ServeError` on timeout."""
        if not self._done.wait(timeout=timeout):
            raise ServeError(f"rollout still {self.stage} after {timeout}s")
        if self.stage == RolloutStage.ROLLED_BACK:
            raise RolloutAborted(
                f"rollout rolled back during {self._last_live_stage()}: {self.abort_reason}",
                stage=self._last_live_stage(),
                reason=self.abort_reason or "",
            )
        return self.snapshot()

    def _last_live_stage(self) -> str:
        for entry in reversed(self._stage_history):
            if entry["stage"] == RolloutStage.ROLLED_BACK:
                return entry.get("from") or RolloutStage.SHADOW
        return self.stage

    def snapshot(self) -> Dict[str, Any]:
        """The ``rollout`` stats block (``router.stats()['rollout']``)."""
        verdict = self.gate.evaluate()
        with self._lock:
            mirror_errors = dict(self.mirror_errors)
            history = [dict(h) for h in self._stage_history]
        router = self.router
        counters = {"mirrored": 0, "mirror_shed": 0}
        if router is not None:
            with router._lock:
                counters = {k: router._counters[k] for k in counters}
        return {
            "active": self.stage not in RolloutStage.TERMINAL,
            "stage": self.stage,
            "abort_reason": self.abort_reason,
            "stage_history": history,
            "candidate": self.candidate.snapshot(),
            "overrides": sorted(self.overrides),
            "mirrored": counters["mirrored"],
            "mirror_shed": counters["mirror_shed"],
            "mirror_errors": mirror_errors,
            "canary_routed": self.canary_routed,
            "canary_errors": self.canary_errors,
            "promoted_replicas": list(self.promoted_replicas),
            "rollbacks": self.rollbacks,
            "gate": {
                "ready": verdict["ready"],
                "breach": verdict["breach"],
                "short": _round_metrics(verdict["short"]),
                "long": _round_metrics(verdict["long"]),
            },
        }

    # -- internals ---------------------------------------------------------

    def _note_stage(self, stage: str, from_stage: Optional[str]) -> None:
        with self._lock:
            self.stage = stage
            self._stage_t0 = time.monotonic()
            self._stage_history.append({"stage": stage, "from": from_stage,
                                        "t_s": round(self._stage_t0 - self._t_start, 3)})
        router = self.router
        if router is not None:
            router.recorder.record("rollout_stage", stage=stage, from_stage=from_stage,
                                   candidate_hash=self.candidate.variables_hash)


def _round_metrics(m: Dict[str, Optional[float]]) -> Dict[str, Any]:
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in m.items()}
