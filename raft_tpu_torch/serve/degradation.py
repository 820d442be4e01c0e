"""Adaptive anytime-iteration degradation: RAFT's accuracy/latency dial.

The port's copy of the JAX package's ``raft_tpu/serve/degradation.py``.

RAFT is an anytime algorithm — every GRU refinement iteration emits a
valid flow, and the published protocol itself spans 32 (eval) down to 12
(fast) iterations. That makes load shedding *gradual* here in a way most
models cannot have: under pressure the controller steps
``num_flow_updates`` down a configured ladder (serving slightly softer
flow to everyone) before the queue ever has to shed anyone, and steps back
up once drained.

The controller is deliberately boring: observed once per formed batch
(queue fullness + per-bucket p99), hysteresis via distinct high/low
watermarks, a cooldown between moves, and ``recover_after`` consecutive
calm batches per step up — so one traffic spike cannot make it oscillate.
Every transition is recorded (the acceptance test asserts the down *and*
the recovery), and per-level occupancy counts feed the bench's
degradation-occupancy metric.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

__all__ = ["DegradationController"]


class DegradationController:
    """Step ``num_flow_updates`` down/up a ladder from load signals."""

    def __init__(
        self,
        ladder: Sequence[int],
        *,
        slo_p99_ms: Optional[float] = None,
        high_watermark: float = 0.75,
        low_watermark: float = 0.25,
        cooldown: int = 2,
        recover_after: int = 2,
    ):
        ladder = tuple(int(i) for i in ladder)
        if not ladder or any(i <= 0 for i in ladder):
            raise ValueError(f"ladder must be positive iters, got {ladder!r}")
        if list(ladder) != sorted(ladder, reverse=True) or len(set(ladder)) != len(
            ladder
        ):
            raise ValueError(f"ladder must be strictly descending, got {ladder!r}")
        if not (0.0 <= low_watermark <= high_watermark <= 1.0):
            raise ValueError(
                f"need 0 <= low <= high <= 1, got {low_watermark}/{high_watermark}"
            )
        self.ladder = ladder
        self.slo_p99_ms = slo_p99_ms
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.cooldown = max(0, int(cooldown))
        self.recover_after = max(1, int(recover_after))
        self._level = 0
        self._since_move = self.cooldown  # free to act from the first batch
        self._calm = 0
        self._occupancy = [0] * len(ladder)
        self.transitions: List[dict] = []
        self._lock = threading.Lock()

    @property
    def level(self) -> int:
        with self._lock:
            return self._level

    @property
    def num_flow_updates(self) -> int:
        with self._lock:
            return self.ladder[self._level]

    def observe(self, queue_frac: float, p99_ms: Optional[float] = None) -> int:
        """One batch's load sample in, the iters to run it at out."""
        with self._lock:
            self._since_move += 1
            over_slo = (
                self.slo_p99_ms is not None
                and p99_ms is not None
                and p99_ms > self.slo_p99_ms
            )
            pressured = queue_frac >= self.high_watermark or over_slo
            calm = queue_frac <= self.low_watermark and not over_slo
            if pressured:
                self._calm = 0
                if (
                    self._level < len(self.ladder) - 1
                    and self._since_move >= self.cooldown
                ):
                    self._move(
                        +1,
                        reason=(
                            f"p99 {p99_ms:.0f}ms > SLO {self.slo_p99_ms:.0f}ms"
                            if over_slo
                            else f"queue {queue_frac:.0%} >= "
                            f"{self.high_watermark:.0%}"
                        ),
                    )
            elif calm:
                self._calm += 1
                if (
                    self._level > 0
                    and self._calm >= self.recover_after
                    and self._since_move >= self.cooldown
                ):
                    self._move(-1, reason=f"drained ({self._calm} calm batches)")
                    self._calm = 0
            else:
                self._calm = 0
            self._occupancy[self._level] += 1
            return self.ladder[self._level]

    def _move(self, delta: int, *, reason: str) -> None:
        src = self._level
        self._level += delta
        self._since_move = 0
        self.transitions.append(
            {
                "direction": "down" if delta > 0 else "up",
                "from_iters": self.ladder[src],
                "to_iters": self.ladder[self._level],
                "reason": reason,
            }
        )

    def snapshot(self) -> dict:
        """Level, iters, transition counts, per-level batch occupancy.

        Occupancy keys are the ladder's iteration counts *as strings*:
        the snapshot feeds JSON surfaces (stats sinks, the process-fleet
        control channel, HTTP /statz), and integer dict keys do not
        survive any of them byte-identically.
        """
        with self._lock:
            return {
                "level": self._level,
                "num_flow_updates": self.ladder[self._level],
                "ladder": self.ladder,
                "steps_down": sum(
                    1 for t in self.transitions if t["direction"] == "down"
                ),
                "steps_up": sum(
                    1 for t in self.transitions if t["direction"] == "up"
                ),
                "transitions": list(self.transitions),
                "occupancy": {
                    str(iters): n
                    for iters, n in zip(self.ladder, self._occupancy)
                },
            }
