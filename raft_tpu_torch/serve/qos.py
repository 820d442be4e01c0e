"""Multi-tenant QoS: priority classes, per-tenant quotas, class accounting.

The port's copy of the JAX package's ``raft_tpu/serve/qos.py``. Three
priority classes, strictly ordered::

    interactive > standard > batch

A request carries its class (and its tenant) from the ``submit*`` kwargs
into the engine, where load decisions become class-aware:

  * **admission** — per-tenant token-bucket rate + concurrency caps
    (:class:`QosPolicy`) refuse over-quota work with a retryable
    :class:`~raft_tpu_torch.serve.errors.QuotaExceeded` *before* it can
    displace anyone else's;
  * **shedding** — a full :class:`~raft_tpu_torch.serve.queue.MicroBatchQueue`
    sheds lowest-class-first: an arriving interactive request preempts a
    queued batch request (the victim gets a retryable ``Overloaded``,
    never silence), with an aging guard (:func:`effective_rank`) so a
    batch request that has waited past ``qos_aging_ms`` becomes
    un-preemptable and seeds like an interactive one — batch always
    progresses;
  * **brownout** — under degradation pressure low classes drop extra
    ladder levels first (:func:`brownout_level`): interactive keeps full
    quality longest, batch softens first. Every level is a rung of the
    configured ladder, so brownout adds no program to the captured set.

Everything is **default-off**: with ``ServeConfig.qos_enabled=False``
(the default) no admission, shedding, or quality decision changes. The
accounting in :class:`QosStats` runs either way (counters only), so
``stats()['qos']`` is a stable schema whether or not enforcement is on.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.serve.bucketing import TokenBucket
from raft_tpu_torch.serve.errors import InvalidInput, QuotaExceeded

__all__ = [
    "PRIORITIES",
    "DEFAULT_PRIORITY",
    "DEFAULT_TENANT",
    "QOS_STATS_KEYS",
    "QOS_CLASS_KEYS",
    "rank_of",
    "validate_priority",
    "effective_rank",
    "brownout_level",
    "QosPolicy",
    "QosStats",
    "qos_stats_block",
]

# strict class order, best first; rank = index (lower rank = higher class)
PRIORITIES: Tuple[str, ...] = ("interactive", "standard", "batch")
_RANK: Dict[str, int] = {p: i for i, p in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = "standard"
DEFAULT_TENANT = "default"

# stats()['qos'] block schema
QOS_STATS_KEYS = frozenset(("enabled", "aging_ms", "classes", "tenants"))
# per-class sub-block schema
QOS_CLASS_KEYS = frozenset((
    "submitted", "completed", "shed", "preempted", "expired",
    "quota_refused", "n", "p50_ms", "p99_ms",
))


def rank_of(priority: str) -> int:
    """Class rank (0 = interactive ... 2 = batch); unknown -> standard."""
    return _RANK.get(priority, _RANK[DEFAULT_PRIORITY])


def validate_priority(priority: Optional[str]) -> str:
    """Resolve/validate a priority kwarg; ``None`` means the default."""
    if priority is None:
        return DEFAULT_PRIORITY
    if priority not in _RANK:
        raise InvalidInput(
            f"unknown priority {priority!r}; choose from {list(PRIORITIES)}"
        )
    return priority


def effective_rank(rank: int, t_submit: float, aging_ms: float,
                   now: Optional[float] = None) -> int:
    """The starvation guard: a request that has waited past ``aging_ms``
    competes at interactive rank (0) regardless of class — it can no
    longer be preempted past, and batch formation seeds it first."""
    if now is None:
        now = time.monotonic()
    if (now - t_submit) * 1e3 >= aging_ms:
        return 0
    return rank


def brownout_level(level: int, rank: int, n_levels: int) -> int:
    """Class-aware degradation: under pressure (``level > 0``) each class
    drops ``rank`` extra ladder levels (clamped) — interactive holds the
    controller's level, batch browns out first. At ``level == 0`` (calm)
    every class serves full quality."""
    if level <= 0:
        return level
    return min(level + rank, n_levels - 1)


class _TenantState:
    """One tenant's live quota state (under the policy lock)."""

    __slots__ = ("bucket", "max_concurrent", "inflight", "refused")

    def __init__(self, rate_rps: float, burst: float, max_concurrent: int):
        # rate <= 0 disables the rate arm (concurrency-only quota)
        self.bucket = (
            TokenBucket(rate_rps, max(1, int(burst))) if rate_rps > 0 else None
        )
        self.max_concurrent = int(max_concurrent)
        self.inflight = 0
        self.refused = 0


class QosPolicy:
    """Per-tenant token-bucket rate + concurrency-cap admission.

    ``quotas`` is a tuple of ``(tenant, rate_rps, burst, max_concurrent)``
    rows (the :attr:`~raft_tpu_torch.serve.ServeConfig.qos_tenant_quotas`
    wire-safe shape). A tenant without a row is unlimited; ``rate_rps <=
    0`` disables the rate arm; ``max_concurrent <= 0`` disables the
    concurrency arm. :meth:`admit` raises a retryable
    :class:`~raft_tpu_torch.serve.errors.QuotaExceeded`; every admitted request
    must be paired with exactly one :meth:`release`.
    """

    def __init__(
        self,
        quotas: Iterable[Tuple[str, float, float, int]] = (),
    ):
        self._lock = threading.Lock()
        self._tenants: Dict[str, _TenantState] = {}
        for tenant, rate_rps, burst, max_concurrent in quotas or ():
            self._tenants[str(tenant)] = _TenantState(
                float(rate_rps), float(burst), int(max_concurrent)
            )

    def admit(self, tenant: str, priority: str) -> None:
        """Charge one request against ``tenant``'s quota or refuse it."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                return  # un-quota'd tenant: unlimited
            if 0 < st.max_concurrent <= st.inflight:
                st.refused += 1
                raise QuotaExceeded(
                    f"tenant {tenant!r} at its concurrency cap "
                    f"({st.max_concurrent} in flight)",
                    retry_after_ms=50.0,
                    tenant=tenant,
                )
            if st.bucket is not None and not st.bucket.try_take():
                st.refused += 1
                raise QuotaExceeded(
                    f"tenant {tenant!r} over its request rate",
                    retry_after_ms=st.bucket.retry_after_ms(),
                    tenant=tenant,
                )
            st.inflight += 1

    def release(self, tenant: str) -> None:
        """Return one concurrency slot (a request completed or failed)."""
        with self._lock:
            st = self._tenants.get(tenant)
            if st is not None:
                st.inflight = max(0, st.inflight - 1)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                t: {
                    "inflight": st.inflight,
                    "quota_refused": st.refused,
                    "max_concurrent": st.max_concurrent,
                    "rate_limited": st.bucket is not None,
                }
                for t, st in self._tenants.items()
            }


class QosStats:
    """Per-class serving counters + latency quantiles.

    Counters-only (never a behavior input), so it runs whether or not QoS
    enforcement is on — ``stats()['qos']['classes']`` is a stable schema
    either way. Keys per class are :data:`QOS_CLASS_KEYS`.
    """

    COUNTER_KEYS = (
        "submitted", "completed", "shed", "preempted", "expired",
        "quota_refused",
    )

    def __init__(self, window: int = 256):
        self._lock = threading.Lock()
        self._window = int(window)
        self._counts: Dict[str, Dict[str, int]] = {
            p: {k: 0 for k in self.COUNTER_KEYS} for p in PRIORITIES
        }
        self._latency: Dict[str, list] = {p: [] for p in PRIORITIES}

    def count(self, priority: str, key: str, n: int = 1) -> None:
        cls = priority if priority in _RANK else DEFAULT_PRIORITY
        with self._lock:
            self._counts[cls][key] += n

    def observe_latency(self, priority: str, latency_ms: float) -> None:
        cls = priority if priority in _RANK else DEFAULT_PRIORITY
        with self._lock:
            v = self._latency[cls]
            v.append(float(latency_ms))
            del v[: -self._window]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out = {}
            for p in PRIORITIES:
                v = self._latency[p]
                out[p] = dict(self._counts[p])
                out[p]["n"] = len(v)
                out[p]["p50_ms"] = (
                    float(np.percentile(v, 50)) if v else None
                )
                out[p]["p99_ms"] = (
                    float(np.percentile(v, 99)) if v else None
                )
            return out


def qos_stats_block(
    enabled: bool,
    aging_ms: float,
    stats: QosStats,
    policy: Optional[QosPolicy],
) -> Dict[str, object]:
    """Assemble the pinned ``stats()['qos']`` block."""
    return {
        "enabled": bool(enabled),
        "aging_ms": float(aging_ms),
        "classes": stats.snapshot(),
        "tenants": {} if policy is None else policy.snapshot(),
    }
