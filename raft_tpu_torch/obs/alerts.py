"""Burn-rate alerting: multi-window rules over metric snapshots.

The port's copy of the JAX package's ``raft_tpu/obs/alerts.py``. The
multi-window burn-rate pattern over the registry's own counters:

  * a **rule** names a burn function (``(prev_snapshot, cur_snapshot,
    dt_s) -> burn``), a threshold, and two windows;
  * the rule **fires** only when the burn exceeds the threshold over the
    *short* window AND the *long* window — the short window gives fast
    detection, the long window rejects blips;
  * it **resolves** with hysteresis: both windows must fall below
    ``threshold * resolve_ratio`` (no flapping at the boundary).

Firing and resolving are typed flight-recorder events (``alert_fire`` /
``alert_resolve``, carrying rule, severity, windows, and the measured
burn), so alert history rides every postmortem bundle; a rule with
``severity='page'`` additionally auto-dumps a bundle the moment it fires.

Wiring: ``ServeEngine`` evaluates its engine rule set (SLO burn =
expired+shed fraction, quarantine, watchdog trips, device-time EWMA
drift via :class:`~raft_tpu_torch.obs.ledger.DeviceTimeLedger`) from its
worker loop and exposes ``alerts()`` and per-rule Prometheus gauges. The
engine never raises into the loop that drives it.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "AlertRule",
    "AlertEngine",
    "rate",
    "ratio_rate",
    "gauge_value",
]

BurnFn = Callable[[Dict[str, float], Dict[str, float], float], float]


def rate(key: str) -> BurnFn:
    """Burn = counter increase per second over the window."""

    def burn(prev, cur, dt):
        return max(0.0, cur.get(key, 0) - prev.get(key, 0)) / max(dt, 1e-9)

    return burn


def ratio_rate(num_keys, den_key: str) -> BurnFn:
    """Burn = (sum of numerator counter deltas) / denominator delta over
    the window — e.g. ``(expired + shed) / submitted`` is the fraction
    of admitted traffic that missed its SLO. Zero when the denominator
    did not move (no traffic = no burn)."""
    if isinstance(num_keys, str):
        num_keys = (num_keys,)
    num_keys = tuple(num_keys)

    def burn(prev, cur, dt):
        den = cur.get(den_key, 0) - prev.get(den_key, 0)
        if den <= 0:
            return 0.0
        num = sum(
            max(0.0, cur.get(k, 0) - prev.get(k, 0)) for k in num_keys
        )
        return num / den

    return burn


def gauge_value(key: str) -> BurnFn:
    """Burn = the current value of a gauge-like snapshot key (e.g. the
    device-time drift ratio) — windows then just demand persistence."""

    def burn(prev, cur, dt):
        return float(cur.get(key, 0.0))

    return burn


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One burn-rate rule. ``burn`` is evaluated over the short and the
    long window independently; both must exceed ``threshold`` (strictly)
    to fire, and both must drop below ``threshold * resolve_ratio`` to
    resolve. ``severity='page'`` dumps a postmortem bundle on fire."""

    name: str
    burn: BurnFn
    threshold: float
    short_s: float = 5.0
    long_s: float = 60.0
    severity: str = "ticket"
    resolve_ratio: float = 0.5

    def __post_init__(self):
        if not self.name:
            raise ValueError("rule name must be non-empty")
        if not (0 < self.short_s <= self.long_s):
            raise ValueError(
                f"need 0 < short_s <= long_s, got {self.short_s} / "
                f"{self.long_s}"
            )
        if self.severity not in ("ticket", "page"):
            raise ValueError(
                f"severity must be 'ticket' or 'page', got {self.severity!r}"
            )
        if not (0.0 <= self.resolve_ratio <= 1.0):
            raise ValueError(
                f"resolve_ratio must be in [0, 1], got {self.resolve_ratio}"
            )


class AlertEngine:
    """Evaluates a rule set against a ring of timestamped snapshots.

    ``observe(snapshot)`` appends and evaluates; call it from any
    periodic loop (engine worker, router monitor) — ``maybe_observe``
    self-throttles to ``min_interval_s``. A broken event sink is
    isolated (recorded nowhere, raised never), mirroring the flight
    recorder's own contract.
    """

    def __init__(
        self,
        rules: Sequence[AlertRule],
        *,
        snapshot_fn: Optional[Callable[[], Dict[str, float]]] = None,
        recorder=None,
        now: Callable[[], float] = time.monotonic,
        capacity: int = 512,
        min_interval_s: Optional[float] = None,
    ):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.rules: Tuple[AlertRule, ...] = tuple(rules)
        self._snapshot_fn = snapshot_fn
        self._recorder = recorder
        self._now = now
        self._ring: "collections.deque[Tuple[float, Dict[str, float]]]" = (
            collections.deque(maxlen=int(capacity))
        )
        self._active: Dict[str, Dict[str, Any]] = {}
        self._sinks: List[Callable[[Dict[str, Any]], None]] = []
        self._lock = threading.Lock()
        self.fired = 0
        self.resolved = 0
        if min_interval_s is None:
            min_interval_s = (
                min((r.short_s for r in rules), default=1.0) / 4.0
            )
        self.min_interval_s = max(0.01, float(min_interval_s))
        self._next_t = 0.0

    def add_sink(self, sink: Callable[[Dict[str, Any]], None]) -> None:
        """Subscribe to fire/resolve events (dashboards, tests). A
        raising sink is swallowed per event."""
        with self._lock:
            self._sinks.append(sink)

    # -- evaluation --------------------------------------------------------

    def maybe_observe(
        self, snapshot: Optional[Dict[str, float]] = None
    ) -> None:
        """Throttled :meth:`observe` — safe to call every loop tick."""
        t = self._now()
        if t < self._next_t:
            return
        self._next_t = t + self.min_interval_s
        try:
            self.observe(snapshot, t=t)
        except Exception:
            pass  # alerting must never take down the loop that drives it

    def observe(
        self,
        snapshot: Optional[Dict[str, float]] = None,
        *,
        t: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Record one snapshot and evaluate every rule. Returns the
        fire/resolve transitions this evaluation produced."""
        if snapshot is None:
            if self._snapshot_fn is None:
                raise ValueError(
                    "no snapshot given and no snapshot_fn configured"
                )
            snapshot = self._snapshot_fn()
        if t is None:
            t = self._now()
        with self._lock:
            self._ring.append((t, dict(snapshot)))
            transitions: List[Dict[str, Any]] = []
            for rule in self.rules:
                burn_s = self._burn_locked(rule, rule.short_s, t)
                burn_l = self._burn_locked(rule, rule.long_s, t)
                active = rule.name in self._active
                if not active and burn_s > rule.threshold and (
                    burn_l > rule.threshold
                ):
                    info = {
                        "event": "alert_fire",
                        "rule": rule.name,
                        "severity": rule.severity,
                        "burn": round(burn_s, 6),
                        "burn_long": round(burn_l, 6),
                        "threshold": rule.threshold,
                        "short_s": rule.short_s,
                        "long_s": rule.long_s,
                        "fired_t": t,
                    }
                    self._active[rule.name] = info
                    self.fired += 1
                    transitions.append(info)
                elif active:
                    floor = rule.threshold * rule.resolve_ratio
                    if burn_s <= floor and burn_l <= floor:
                        info = dict(
                            self._active.pop(rule.name),
                            event="alert_resolve",
                            burn=round(burn_s, 6),
                            burn_long=round(burn_l, 6),
                            resolved_t=t,
                        )
                        self.resolved += 1
                        transitions.append(info)
                    else:
                        # keep the live burn fresh for dumps/dashboards
                        self._active[rule.name]["burn"] = round(burn_s, 6)
            sinks = list(self._sinks)
        for info in transitions:
            self._emit(info)
            for sink in sinks:
                try:
                    sink(info)
                except Exception:
                    pass  # broken sink isolation
        return transitions

    def _burn_locked(
        self, rule: AlertRule, window_s: float, t_now: float
    ) -> float:
        """Burn over one window: current snapshot vs the oldest snapshot
        inside the window (or the ring's oldest during warm-up — the
        standard startup behavior: the window is as long as the data)."""
        if len(self._ring) < 2:
            return 0.0
        t_cut = t_now - window_s
        prev_t, prev = self._ring[0]
        for ts, snap in self._ring:
            if ts >= t_cut:
                prev_t, prev = ts, snap
                break
        cur_t, cur = self._ring[-1]
        dt = cur_t - prev_t
        if dt <= 0:
            return 0.0
        try:
            return float(rule.burn(prev, cur, dt))
        except Exception:
            return 0.0  # a broken burn fn must not break evaluation

    def _emit(self, info: Dict[str, Any]) -> None:
        rec = self._recorder
        if rec is None:
            return
        try:
            fields = {
                k: v for k, v in info.items() if k not in ("event",)
            }
            rec.record(info["event"], **fields)
            if (
                info["event"] == "alert_fire"
                and info["severity"] == "page"
            ):
                # page severity: the postmortem is taken NOW, while the
                # burn is live — the bundle carries the alert_fire event
                # plus everything that led up to it
                rec.dump(f"alert:{info['rule']}", extra={"alert": fields})
        except Exception:
            pass

    # -- exposure ----------------------------------------------------------

    def active(self) -> List[Dict[str, Any]]:
        """Currently-firing alerts, oldest first."""
        with self._lock:
            return sorted(
                (dict(v) for v in self._active.values()),
                key=lambda a: a["fired_t"],
            )

    def is_active(self, rule_name: str) -> bool:
        with self._lock:
            return rule_name in self._active

    def snapshot(self) -> Dict[str, Any]:
        """The ``alerts`` block for a ``stats()`` surface."""
        active = self.active()
        return {
            "active": [a["rule"] for a in active],
            "fired": self.fired,
            "resolved": self.resolved,
            "rules": [r.name for r in self.rules],
        }

    def register_gauges(self, registry) -> None:
        """One 0/1 gauge per rule (+ an active count) in a
        :class:`~raft_tpu_torch.obs.MetricsRegistry` — the Prometheus surface.
        """
        registry.gauge(
            "alerts_active", lambda: len(self._active),
            help="currently firing alert rules",
        )
        for rule in self.rules:
            registry.gauge(
                f"alert/{rule.name}",
                (lambda name=rule.name: 1.0 if self.is_active(name) else 0.0),
                help=f"1 while rule {rule.name} is firing",
            )
