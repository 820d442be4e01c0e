"""Signal-driven fleet sizing: grow, shrink and drain replicas from the load
the tier already measures.

The port's copy of the JAX package's ``raft_tpu/serve/autoscale.py``. The
:class:`Autoscaler` closes the loop with signals the tier already exports
(no new always-on thread: the router's monitor loop evaluates it):

=====================  =====================================================
signal                 source
=====================  =====================================================
arrival rate (req/s)   Δ ``submitted`` across replica engines
                       (``router.stats()['aggregate']``) per eval interval
shed rate              Δ(``shed`` + ``shed_slow_path``) / Δ ``submitted``
SLO miss rate          Δ ``expired`` / Δ ``submitted``
occupancy              mean queue fullness (``queue_depth /
                       queue_capacity``) over healthy replicas' ``health()``
degraded level         mean degradation level over healthy replicas
healthy fraction       ``health()['healthy_count'] / replica_count``
=====================  =====================================================

With QoS enforcement on anywhere in the fleet, the rates are those of the
interactive and standard classes, and the class-blind signals (occupancy,
degraded level) stop voting to grow: a best-effort flood must not buy
replicas.

Decision rule, SRE-style hysteresis: **scale up** when shed rate, SLO miss
rate, occupancy or degraded level has exceeded its threshold for
``up_after`` consecutive evaluations; **scale down** when occupancy has
stayed below ``down_occupancy`` with zero shedding and no degradation for
``down_after`` consecutive evaluations. Every action starts a cooldown in
which neither direction fires, and the fleet is clamped to
``[min_replicas, max_replicas]``. Scale-up adds a replica through
:meth:`~raft_tpu_torch.serve.router.ServeRouter.add_replica` (the replica
template's factory); scale-down drains the newest replica through
:meth:`~raft_tpu_torch.serve.router.ServeRouter.remove_replica`. Actions
run on a short-lived thread: booting an engine (on the card, capturing its
graph set) must never stall the health monitor that triggered it.

The autoscaler holds its router weakly (the router holds the autoscaler),
so the pair forms no reference cycle.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

__all__ = ["Autoscaler", "AutoscaleConfig"]


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Knobs for :class:`Autoscaler`.

    Args:
        min_replicas / max_replicas: hard fleet-size bounds (the configured
            count, including evicted-but-recovering replicas).
        eval_interval_s: seconds between signal evaluations (the monitor
            beats faster; evaluations are rate-limited to this).
        up_shed_rate: shed fraction of submissions that votes to grow.
        up_slo_miss_rate: deadline-expired fraction that votes to grow.
        up_occupancy: mean healthy-replica queue fullness that votes to
            grow.
        up_degraded_level: mean degradation level across healthy replicas
            that votes to grow (the anytime ladder is the engine's first
            load response: it cuts iterations before it queues or sheds);
            ``None`` disables.
        down_occupancy: mean occupancy below which (with zero shed and zero
            degradation) an evaluation votes to shrink.
        up_after / down_after: consecutive voting evaluations required
            before acting.
        cooldown_s: seconds after any action during which no further action
            fires (covers a replica's boot).
    """

    min_replicas: int = 1
    max_replicas: int = 4
    eval_interval_s: float = 2.0
    up_shed_rate: float = 0.02
    up_slo_miss_rate: float = 0.05
    up_occupancy: float = 0.7
    up_degraded_level: Optional[float] = 0.5
    down_occupancy: float = 0.2
    up_after: int = 2
    down_after: int = 5
    cooldown_s: float = 15.0

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got {self.min_replicas} / {self.max_replicas}"
            )
        if self.eval_interval_s <= 0:
            raise ValueError(f"eval_interval_s must be positive, got {self.eval_interval_s}")
        for name in ("up_shed_rate", "up_slo_miss_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.up_degraded_level is not None and self.up_degraded_level < 0:
            raise ValueError(f"up_degraded_level must be >= 0 or None, got {self.up_degraded_level}")
        if not (0.0 <= self.down_occupancy < self.up_occupancy <= 1.0):
            raise ValueError(
                f"need 0 <= down_occupancy < up_occupancy <= 1, got {self.down_occupancy} / {self.up_occupancy}"
            )
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError(f"up_after and down_after must be >= 1, got {self.up_after} / {self.down_after}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {self.cooldown_s}")


class Autoscaler:
    """Grows and shrinks a :class:`~raft_tpu_torch.serve.router.ServeRouter`
    fleet from its own load signals (attach with ``Autoscaler(router)``;
    the router's monitor loop does the rest)."""

    def __init__(self, router, config: Optional[AutoscaleConfig] = None):
        self._router = weakref.ref(router)
        self.config = config or AutoscaleConfig()
        self._lock = threading.Lock()
        self._last_eval = 0.0
        self._last_counters: Optional[Dict[str, float]] = None
        self._last_t = 0.0
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0.0
        self._action_thread: Optional[threading.Thread] = None
        self.scale_ups = 0
        self.scale_downs = 0
        self.evaluations = 0
        self.history: "collections.deque[Dict[str, Any]]" = collections.deque(maxlen=256)
        router.attach_autoscaler(self)

    @property
    def router(self):
        """The router this autoscaler sizes (held weakly)."""
        router = self._router()
        if router is None:
            raise ReferenceError("the autoscaler's router is gone")
        return router

    # -- signal collection -------------------------------------------------

    def signals(self) -> Dict[str, Any]:
        """One evaluation's signals, as deltas since the previous evaluation
        (the counters are monotone; the decision needs rates)."""
        now = time.monotonic()
        router = self.router
        stats = router.stats()
        agg = stats.get("aggregate", {})
        qos = stats.get("qos") if isinstance(stats.get("qos"), dict) else {}
        qos_hc = bool(qos.get("enabled"))
        if qos_hc:
            classes = qos.get("classes") or {}

            def hc(key: str) -> float:
                return float(sum((classes.get(p) or {}).get(key, 0) or 0 for p in ("interactive", "standard")))

            counters = {"submitted": hc("submitted"), "shed": hc("shed") + hc("preempted"), "expired": hc("expired")}
        else:
            counters = {
                "submitted": float(agg.get("submitted", 0)),
                "shed": float(agg.get("shed", 0) + agg.get("shed_slow_path", 0)),
                "expired": float(agg.get("expired", 0)),
            }
        prev, prev_t = self._last_counters, self._last_t
        self._last_counters, self._last_t = counters, now
        dt = max(now - prev_t, 1e-6) if prev is not None else None
        d = {k: max(0.0, counters[k] - (prev or counters)[k]) for k in counters}
        occ: List[float] = []
        levels: List[float] = []
        for rep in router.replicas:
            if rep.state != "healthy" or rep.engine is None:
                continue
            try:
                h = rep.engine.health()
                occ.append(h.get("queue_depth", 0) / max(1, h.get("queue_capacity", 1)))
                levels.append(float(h.get("level", 0)))
            except Exception:
                pass  # an unprobeable replica is the monitor's problem
        health = router.health()
        return {
            "arrival_rps": (d["submitted"] / dt) if dt else 0.0,
            "shed_rate": d["shed"] / max(1.0, d["submitted"] + d["shed"]),
            "slo_miss_rate": d["expired"] / max(1.0, d["submitted"]),
            "occupancy": sum(occ) / len(occ) if occ else 0.0,
            # the anytime ladder hides load from the queue: a degraded
            # fleet is an under-provisioned fleet, whatever its depth
            "degraded_level": sum(levels) / len(levels) if levels else 0.0,
            "healthy_count": health.get("healthy_count", 0),
            "replica_count": health.get("replica_count", 0),
            "warmed_up": dt is not None,
            # True: the rates above are interactive + standard burn, and
            # decide() ignores the class-blind signals
            "qos_high_class": qos_hc,
        }

    # -- decision ----------------------------------------------------------

    def decide(self, sig: Dict[str, Any], now: float) -> Dict[str, Any]:
        """The decision step (testable without a fleet): updates the
        hysteresis streaks and returns ``{"action": "up" | "down" | "hold",
        "reason": ...}`` honoring the bounds and the cooldown."""
        cfg = self.config
        n = int(sig.get("replica_count", 0))
        hc = bool(sig.get("qos_high_class", False))
        tag = "high_class_" if hc else ""
        reasons = []
        if sig["shed_rate"] > cfg.up_shed_rate:
            reasons.append(f"{tag}shed_rate {sig['shed_rate']:.3f}")
        if sig["slo_miss_rate"] > cfg.up_slo_miss_rate:
            reasons.append(f"{tag}slo_miss_rate {sig['slo_miss_rate']:.3f}")
        # occupancy and degraded_level are class-blind: with QoS on they
        # stop being scale-up votes
        if not hc and sig["occupancy"] > cfg.up_occupancy:
            reasons.append(f"occupancy {sig['occupancy']:.2f}")
        if not hc and cfg.up_degraded_level is not None and sig.get("degraded_level", 0.0) > cfg.up_degraded_level:
            reasons.append(f"degraded_level {sig['degraded_level']:.2f}")
        pressure = bool(reasons) and sig.get("warmed_up", True)
        calm = (
            sig.get("warmed_up", True)
            and sig["shed_rate"] == 0.0
            and sig["occupancy"] < cfg.down_occupancy
            and sig.get("degraded_level", 0.0) == 0.0
        )
        self._up_streak = self._up_streak + 1 if pressure else 0
        self._down_streak = self._down_streak + 1 if calm else 0

        def verdict(action: str, reason: str) -> Dict[str, Any]:
            # every decision carries its hysteresis state: "why didn't it
            # scale" is usually "the streak wasn't there yet"
            return {"action": action, "reason": reason, "up_streak": self._up_streak,
                    "down_streak": self._down_streak}

        if now < self._cooldown_until:
            return verdict("hold", f"cooldown ({self._cooldown_until - now:.1f}s left)")
        if n < cfg.min_replicas:
            return verdict("up", "below min_replicas")
        if pressure and self._up_streak >= cfg.up_after and n < cfg.max_replicas:
            return verdict("up", ", ".join(reasons))
        if pressure and n >= cfg.max_replicas:
            return verdict("hold", f"at max_replicas ({cfg.max_replicas}); " + ", ".join(reasons))
        if calm and self._down_streak >= cfg.down_after and n > cfg.min_replicas:
            return verdict(
                "down", f"occupancy {sig['occupancy']:.2f} < {cfg.down_occupancy} for {self._down_streak} evals"
            )
        return verdict("hold", "within band")

    # -- driving (called from the router's monitor loop) -------------------

    def maybe_evaluate(self) -> Optional[Dict[str, Any]]:
        """Rate-limited evaluate-and-act; the router's monitor calls this
        every heartbeat. Returns the decision when one was made."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_eval < self.config.eval_interval_s:
                return None
            self._last_eval = now
        return self.evaluate_once()

    def evaluate_once(self) -> Dict[str, Any]:
        """One full evaluation: signals -> decision -> (maybe) action."""
        now = time.monotonic()
        sig = self.signals()
        decision = self.decide(sig, now)
        decision["signals"] = sig
        decision["t"] = now
        with self._lock:
            self.evaluations += 1
            self.history.append(decision)
        if decision["action"] != "hold":
            self._apply(decision)
        return decision

    def _apply(self, decision: Dict[str, Any]) -> None:
        """Run the scale action on a short-lived thread; one action in
        flight at a time, the cooldown starting at decision time."""
        with self._lock:
            if self._action_thread is not None and self._action_thread.is_alive():
                return
            self._cooldown_until = time.monotonic() + self.config.cooldown_s
            self._up_streak = self._down_streak = 0
            action = decision["action"]
            if action == "up":
                self.scale_ups += 1
            else:
                self.scale_downs += 1
            reason, signals = decision.get("reason"), decision.get("signals")
            router_ref = self._router

            def run():
                # the scale event carries the complete signal vector, so a
                # postmortem bundle alone answers "why did it scale"
                router = router_ref()
                if router is None:
                    return
                try:
                    if action == "up":
                        router.add_replica(reason=reason, signals=signals)
                    else:
                        victim = self._pick_victim()
                        if victim is not None:
                            router.remove_replica(victim, drain=True, reason=reason, signals=signals)
                except Exception:
                    pass  # the next evaluation sees the true fleet state

            self._action_thread = threading.Thread(target=run, name="raft-autoscale-action", daemon=True)
            self._action_thread.start()

    def _pick_victim(self) -> Optional[str]:
        """Scale-down choice: the newest healthy replica (the longest-lived
        keep the most stream affinity), else any non-draining replica."""
        reps = self.router.replicas
        healthy = [r for r in reps if r.state == "healthy"]
        pool = healthy or [r for r in reps if r.state != "draining"]
        return pool[-1].replica_id if pool else None

    def explain(self, n: int = 32) -> List[Dict[str, Any]]:
        """The last ``n`` evaluations in full, oldest first: action, reason,
        the complete signal vector and the streaks at decision time. Every
        evaluation lands here, not just actions, so "why did it scale" and
        "why didn't it" are both answerable."""
        with self._lock:
            return [dict(d) for d in list(self.history)[-max(1, int(n)):]]

    def snapshot(self) -> Dict[str, Any]:
        """The autoscaler's stats block (``stats()['autoscaler']`` on the
        router)."""
        with self._lock:
            last = self.history[-1] if self.history else None
            actions = [
                {"t": d["t"], "action": d["action"], "reason": d["reason"],
                 "replica_count": d["signals"].get("replica_count")}
                for d in self.history
                if d["action"] != "hold"
            ]
            return {
                "attached": True,
                "actions": actions,
                "min_replicas": self.config.min_replicas,
                "max_replicas": self.config.max_replicas,
                "evaluations": self.evaluations,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "cooldown_remaining_s": max(0.0, self._cooldown_until - time.monotonic()),
                "last_decision": last,
            }
