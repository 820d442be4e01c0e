"""Metrics registry: typed counters, gauges and histograms.

The port's copy of the JAX package's ``raft_tpu/obs/metrics.py``, the parts
the serving engine's ``stats()`` and device-time ledger read:

  * :class:`CounterGroup` — a ``MutableMapping`` of named counters that
    works as a counter dict (``group[k] += 1``, ``dict(group)``).
  * :class:`Gauge` — a point-in-time value, either ``set()`` explicitly
    or read through a callback at snapshot time (queue depth, pool
    occupancy, degradation level).
  * :class:`Histogram` — fixed-bucket latency/duration distribution;
    fixed bounds keep ``observe()`` an O(#buckets) scan with no
    allocation.

``MetricsRegistry.snapshot()`` is a flat ``{name: number}`` view; the
Prometheus and JSONL sinks wait for the observability slice.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, MutableMapping, Optional, Sequence, Tuple

__all__ = [
    "CounterGroup",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS_MS",
    "DEVICE_TIME_BUCKETS_MS",
    "RESIDUAL_BUCKETS",
]

# Default fixed bucket bounds for request/phase latencies (ms). The last
# implicit bucket is +inf, Prometheus-style.
LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)

# Per-instrument bucket sets. Device-time samples need sub-ms
# resolution — a pool tick at a small bucket is fractions of a
# millisecond, far below the request-latency buckets' floor — and
# flow-update residuals live on a log scale in 1/8-grid pixels.
DEVICE_TIME_BUCKETS_MS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 5000.0,
)
RESIDUAL_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0,
)


class Gauge:
    """A point-in-time value: ``set()`` or a snapshot-time callback."""

    __slots__ = ("name", "help", "_value", "_fn")

    def __init__(
        self, name: str, help: str = "",
        fn: Optional[Callable[[], float]] = None,
    ):
        self.name = name
        self.help = help
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")  # a broken probe must not break snapshot
        return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative-bucket snapshot, Prometheus
    convention). ``observe()`` is a bounded scan, no allocation."""

    __slots__ = ("name", "help", "bounds", "_counts", "_sum", "_n")

    def __init__(
        self, name: str, bounds: Sequence[float] = LATENCY_BUCKETS_MS,
        help: str = "",
    ):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(
                f"histogram bounds must be ascending and non-empty, "
                f"got {bounds!r}"
            )
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # last = +inf
        self._sum = 0.0
        self._n = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for b in self.bounds:
            if v <= b:
                break
            i += 1
        self._counts[i] += 1
        self._sum += v
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-upper-bound quantile estimate (None when empty). The
        +inf bucket reports the last finite bound — an underestimate,
        flagged by the snapshot's ``_inf`` count being nonzero."""
        n = self._n
        if n == 0:
            return None
        target = q * n
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self._n,
            "sum": round(self._sum, 3),
            "p50": self.quantile(0.50),
            "p99": self.quantile(0.99),
            "inf": self._counts[-1],
        }


class CounterGroup(MutableMapping):
    """A named family of counters that works as a counter dict: the
    engine's ``self._counters[k] += 1`` (under the engine lock) and
    ``dict(self._counters)``; the registry sees every key as
    ``<group>/<key>``.
    """

    def __init__(self, name: str, keys: Sequence[str] = ()):
        self.name = name
        self._values: Dict[str, int] = {k: 0 for k in keys}

    def __getitem__(self, k: str) -> int:
        return self._values[k]

    def __setitem__(self, k: str, v: int) -> None:
        self._values[k] = v

    def __delitem__(self, k: str) -> None:
        del self._values[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def snapshot(self) -> Dict[str, int]:
        return dict(self._values)


class MetricsRegistry:
    """One component's metric namespace; the snapshot/exposition root."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._groups: Dict[str, CounterGroup] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- registration ------------------------------------------------------

    def counter_group(
        self, name: str, keys: Sequence[str] = ()
    ) -> CounterGroup:
        with self._lock:
            g = self._groups.get(name)
            if g is None:
                g = self._groups[name] = CounterGroup(name, keys)
            else:
                for k in keys:
                    g._values.setdefault(k, 0)
            return g

    def gauge(
        self, name: str, fn: Optional[Callable[[], float]] = None,
        help: str = "",
    ) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name, help, fn=fn)
            elif fn is not None:
                g._fn = fn
            return g

    def histogram(
        self, name: str, bounds: Optional[Sequence[float]] = None,
        help: str = "",
    ) -> Histogram:
        """Register (or fetch) a histogram, with per-instrument buckets.

        ``bounds=None`` means "whatever this instrument already uses"
        (``LATENCY_BUCKETS_MS`` on first registration). Explicit bounds
        are honored on first registration; explicitly re-registering an
        instrument with *different* bounds raises instead of silently
        keeping the old ones (device time needs finer sub-ms buckets
        than request latency, and a dropped bucket spec must fail
        loudly, not misbucket quietly)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(
                    name,
                    LATENCY_BUCKETS_MS if bounds is None else bounds,
                    help,
                )
            elif bounds is not None and tuple(
                float(b) for b in bounds
            ) != h.bounds:
                raise ValueError(
                    f"histogram {name!r} is already registered with bounds "
                    f"{h.bounds}; re-registering with {tuple(bounds)} would "
                    f"silently misbucket — pick a new name or drop the "
                    f"bounds argument"
                )
            return h

    # -- sinks -------------------------------------------------------------

    def _full(self, name: str) -> str:
        return f"{self.namespace}/{name}" if self.namespace else name

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name: number}`` view of everything registered.

        Histograms expand to ``<name>_count`` / ``<name>_sum`` /
        ``<name>_p50`` / ``<name>_p99``; counter groups to their keys.
        """
        out: Dict[str, float] = {}
        with self._lock:
            groups = list(self._groups.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
        for g in groups:
            for k, v in g.snapshot().items():
                out[self._full(f"{g.name}/{k}")] = v
        for ga in gauges:
            out[self._full(ga.name)] = ga.value
        for h in hists:
            s = h.snapshot()
            base = self._full(h.name)
            out[f"{base}_count"] = s["count"]
            out[f"{base}_sum"] = s["sum"]
            if s["p50"] is not None:
                out[f"{base}_p50"] = s["p50"]
                out[f"{base}_p99"] = s["p99"]
        return out
