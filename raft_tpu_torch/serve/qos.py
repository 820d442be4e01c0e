"""QoS priority classes: the part the request queue needs.

The port's copy of the rank helpers of the JAX package's
``raft_tpu/serve/qos.py``. Three priority classes, strictly ordered::

    interactive > standard > batch

A request carries its class; the queue's QoS arm sheds lowest-class-first
and seeds batches highest-class-first, with an aging guard
(:func:`effective_rank`) so a request that has waited past ``aging_ms``
competes at interactive rank. The engine's enforcement (``QosPolicy``,
tenant quotas, brownout) waits for the QoS slice: the port's engine raises
``NotImplementedError`` for ``qos_enabled=True``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

__all__ = ["PRIORITIES", "DEFAULT_PRIORITY", "rank_of", "effective_rank"]

# strict class order, best first; rank = index (lower rank = higher class)
PRIORITIES: Tuple[str, ...] = ("interactive", "standard", "batch")
_RANK: Dict[str, int] = {p: i for i, p in enumerate(PRIORITIES)}
DEFAULT_PRIORITY = "standard"


def rank_of(priority: str) -> int:
    """Class rank (0 = interactive ... 2 = batch); unknown -> standard."""
    return _RANK.get(priority, _RANK[DEFAULT_PRIORITY])


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
