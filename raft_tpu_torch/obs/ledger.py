"""Device-time ledger: per-program-family device-time attribution.

The port's counterpart of the JAX package's ``raft_tpu/obs/ledger.py``.
Every Kth execution of each **program family** (pool begin/step/final per
bucket and rung, the slow path's forward) is run as a *timed dispatch*
and folded into per-family EWMA + fixed-bucket histograms of device
milliseconds. On the card the interval is a pair of ``torch.cuda.Event``s
recorded on the current stream around the dispatch, read once the second
has completed (JAX blocks on the result with ``block_until_ready``); on
the CPU, where the work runs synchronously, it is the host clock around
the call.

Sampling is deterministic and counter-based (no RNG on the hot path):
execution ``n`` of a family is timed iff ``n % sample_every == 0``.
Unsampled executions still count, so the ledger *extrapolates* each
family's total device time (``mean sampled ms x executions``);
``sample_every=1`` makes the estimate exact. A timed dispatch waits for
its end event, which serializes the dispatch pipeline at that seam.

Unlike the JAX ledger's enqueue-to-ready interval, the events bracket
only the work enqueued between them, so device work still draining ahead
of the timed program does not count.

Exposure: :meth:`DeviceTimeLedger.breakdown` feeds
``ServeEngine.device_time_breakdown()`` and the ``ledger`` block of
``stats()``; constructed with a :class:`~raft_tpu_torch.obs.MetricsRegistry`,
each family also registers a ``device_ms/<family>`` histogram there. The
ledger never raises into the dispatch it times.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from raft_tpu_torch.obs.metrics import DEVICE_TIME_BUCKETS_MS, Histogram

__all__ = ["DeviceTimeLedger"]


def _family_name(key: Any) -> str:
    """Stable printable name for a program-family key. Keys are the
    engine's overlay tuples (``(family, *shape dims[, iters])``) so a
    ledger family and a compiled program correspond 1:1."""
    if isinstance(key, tuple):
        return "/".join(str(k) for k in key)
    return str(key)


class _Family:
    """One program family's accounting (mutated under the ledger lock
    only for registration; counters ride the GIL like obs.Counter)."""

    __slots__ = (
        "key", "name", "executions", "sampled", "ms_sum", "ewma_ms", "hist",
    )

    def __init__(self, key: Any, hist: Histogram):
        self.key = key
        self.name = _family_name(key)
        self.executions = 0
        self.sampled = 0
        self.ms_sum = 0.0
        self.ewma_ms: Optional[float] = None
        self.hist = hist

    def record(self, ms: float) -> None:
        self.sampled += 1
        self.ms_sum += ms
        self.ewma_ms = (
            ms if self.ewma_ms is None
            else self.ewma_ms + 0.2 * (ms - self.ewma_ms)
        )
        self.hist.observe(ms)

    @property
    def mean_ms(self) -> Optional[float]:
        return self.ms_sum / self.sampled if self.sampled else None

    def snapshot(self) -> Dict[str, Any]:
        mean = self.mean_ms
        return {
            "executions": self.executions,
            "sampled": self.sampled,
            "mean_ms": None if mean is None else round(mean, 4),
            "ewma_ms": (
                None if self.ewma_ms is None else round(self.ewma_ms, 4)
            ),
            "p50_ms": self.hist.quantile(0.50),
            "p99_ms": self.hist.quantile(0.99),
            "est_total_ms": (
                0.0 if mean is None else round(mean * self.executions, 3)
            ),
        }


class DeviceTimeLedger:
    """Counter-sampled timed dispatches per program family.

    ``sample_every=0`` (the default) disables the ledger entirely: the
    hot path pays one int comparison per dispatch and records nothing.
    ``sample_every=K >= 1`` times every Kth execution per family between
    two CUDA events on ``device``'s current stream (the host clock on the
    CPU) and accounts the elapsed milliseconds.
    """

    def __init__(
        self,
        sample_every: int = 0,
        *,
        device=None,
        registry=None,
        bounds=DEVICE_TIME_BUCKETS_MS,
    ):
        if sample_every < 0:
            raise ValueError(
                f"sample_every must be >= 0 (0 = off), got {sample_every}"
            )
        self.sample_every = int(sample_every)
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._registry = registry
        self._bounds = tuple(bounds)
        self._families: Dict[Any, _Family] = {}
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return self.sample_every > 0

    def _fam(self, key: Any) -> _Family:
        fam = self._families.get(key)
        if fam is None:
            with self._lock:
                fam = self._families.get(key)
                if fam is None:
                    name = f"device_ms/{_family_name(key)}"
                    hist = (
                        self._registry.histogram(name, bounds=self._bounds)
                        if self._registry is not None
                        else Histogram(name, self._bounds)
                    )
                    fam = self._families[key] = _Family(key, hist)
        return fam

    def run(self, key: Any, fn: Callable[[], Any]) -> Any:
        """Execute one dispatch under the ledger.

        Off: ``fn()`` verbatim. On: count the execution; every Kth per
        family additionally waits for the work it enqueued and records
        its device ms. Telemetry failures never propagate into
        the dispatch they time.
        """
        k = self.sample_every
        if k <= 0:
            return fn()
        fam = self._fam(key)
        n = fam.executions
        fam.executions = n + 1
        if n % k:
            return fn()
        if not self._cuda:
            t0 = time.perf_counter()
            out = fn()
            fam.record((time.perf_counter() - t0) * 1e3)
            return out
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        try:
            end.synchronize()
            fam.record(start.elapsed_time(end))
        except RuntimeError:
            pass  # the ledger must never fail the dispatch it measures
        return out

    # -- exposure ----------------------------------------------------------

    def breakdown(self) -> Dict[str, Any]:
        """Per-family device-time attribution plus the extrapolated
        total. ``share`` is each family's fraction of the estimated
        total device time — the "where do the milliseconds go" answer.
        """
        with self._lock:
            fams = list(self._families.values())
        by_family = {f.name: f.snapshot() for f in fams}
        total = sum(s["est_total_ms"] for s in by_family.values())
        for s in by_family.values():
            s["share"] = (
                round(s["est_total_ms"] / total, 4) if total else 0.0
            )
        return {
            "sample_every": self.sample_every,
            "families": len(by_family),
            "sampled_dispatches": sum(
                s["sampled"] for s in by_family.values()
            ),
            "est_total_device_ms": round(total, 3),
            "by_family": by_family,
        }
