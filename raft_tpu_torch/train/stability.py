"""Training-stability escalation: budgeted skips -> rollback -> death.

The port's own copy of the JAX package's ``raft_tpu/train/stability.py``
(pure Python). The in-step divergence guard (``train.step``,
``numerics_policy='skip'``) turns a transient numeric fault into a skipped
update on the device. This module owns what happens when skipping stops
being enough:

  * :class:`StabilityMonitor` is consulted by the Trainer at log
    boundaries: a window whose skipped-step count breaches
    ``skip_budget`` means the run is persistently diverging, and
    escalates to a rollback.
  * Rollback = restore the last known-good checkpoint
    (``checkpoint.manager.CheckpointManager.restore_known_good``), perturb
    the data-order seed (the pipeline state is ``(seed, step)``, so a new
    seed replays different batches over the same step range), and
    optionally scale the LR down (``rollback_lr_scale``).
  * After ``max_rollbacks`` escalations the monitor raises
    :class:`DivergenceError` carrying the full attempt trail.

Nothing here runs on the hot path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = [
    "DivergenceError",
    "RollbackAttempt",
    "StabilityPolicy",
    "StabilityMonitor",
    "perturb_seed",
]

# Large odd stride so perturbed seeds never collide with nearby user seeds
# (seed, seed+1, ... are the natural choices for ablation sweeps).
_SEED_STRIDE = 1_000_003


def perturb_seed(base_seed: int, attempt: int) -> int:
    """Deterministic per-attempt data-order seed (attempt 1 = first rollback)."""
    return int(base_seed) + attempt * _SEED_STRIDE


class DivergenceError(RuntimeError):
    """Training diverged past every recovery rung.

    ``attempts`` is the ``RollbackAttempt`` trail (oldest first) so the
    post-mortem — when it diverged, what was restored, which seeds/LR
    scales were tried — reads straight out of the exception.
    """

    def __init__(self, msg: str, attempts: Tuple = ()):
        super().__init__(msg)
        self.attempts = tuple(attempts)


@dataclasses.dataclass(frozen=True)
class RollbackAttempt:
    """One rung of the escalation ladder, for the attempt trail."""

    at_step: int        # boundary step where the budget breached
    to_step: int        # known-good step restored
    window_skips: int   # skipped updates in the breaching window
    seed: int           # data-order seed after perturbation
    lr_scale: float     # cumulative LR scale after this rollback

    def describe(self) -> str:
        return (
            f"step {self.at_step}: {self.window_skips} skips in window -> "
            f"rolled back to step {self.to_step} "
            f"(seed={self.seed}, lr_scale={self.lr_scale:g})"
        )


@dataclasses.dataclass(frozen=True)
class StabilityPolicy:
    """Escalation knobs (mirrored on ``TrainConfig`` / scripts/train.py)."""

    skip_budget: int = 5          # skipped steps tolerated per log window
    max_rollbacks: int = 3        # rollbacks before DivergenceError
    rollback_lr_scale: float = 1.0  # multiplied into the LR per rollback

    def __post_init__(self):
        if self.skip_budget < 0:
            raise ValueError(
                f"skip_budget must be >= 0, got {self.skip_budget}"
            )
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}"
            )
        if not 0.0 < self.rollback_lr_scale <= 1.0:
            raise ValueError(
                f"rollback_lr_scale must be in (0, 1], "
                f"got {self.rollback_lr_scale}"
            )


class StabilityMonitor:
    """Boundary-time divergence bookkeeping for the Trainer.

    Usage (Trainer, at each log boundary)::

        if monitor.breached(window_skips):
            monitor.check_escalation(step, window_skips)   # may raise
            ... restore known-good, reseed, maybe scale LR ...
            monitor.record_rollback(step, to_step, window_skips)
    """

    def __init__(self, policy: StabilityPolicy, *, base_seed: int = 0):
        self.policy = policy
        self.base_seed = int(base_seed)
        self.rollbacks: List[RollbackAttempt] = []
        self.total_skipped = 0

    # -- boundary-side API -------------------------------------------------

    def breached(self, window_skips: int) -> bool:
        """Did this window's skip count blow the per-window budget?"""
        self.total_skipped += int(window_skips)
        return int(window_skips) > self.policy.skip_budget

    def check_escalation(self, at_step: int, window_skips: int) -> None:
        """Raise :class:`DivergenceError` when the rollback budget is spent
        (or rollback is impossible — ``can_rollback=False`` from the
        Trainer means no checkpoint manager to restore from)."""
        if len(self.rollbacks) >= self.policy.max_rollbacks:
            raise DivergenceError(self._death_message(at_step, window_skips), self.rollbacks)

    def fail(self, at_step: int, window_skips: int, reason: str) -> None:
        """Unconditional escalation to death (e.g. no checkpoint dir)."""
        raise DivergenceError(f"{self._death_message(at_step, window_skips)} ({reason})", self.rollbacks)

    def next_seed(self) -> int:
        """Data-order seed for the NEXT rollback attempt."""
        return perturb_seed(self.base_seed, len(self.rollbacks) + 1)

    def next_lr_scale(self) -> float:
        """Cumulative LR scale after the NEXT rollback attempt."""
        return self.policy.rollback_lr_scale ** (len(self.rollbacks) + 1)

    def record_rollback(
        self, at_step: int, to_step: int, window_skips: int,
        *, seed: Optional[int] = None, lr_scale: Optional[float] = None,
    ) -> RollbackAttempt:
        attempt = RollbackAttempt(
            at_step=int(at_step),
            to_step=int(to_step),
            window_skips=int(window_skips),
            seed=int(seed if seed is not None else self.next_seed()),
            lr_scale=float(
                lr_scale if lr_scale is not None else self.next_lr_scale()
            ),
        )
        self.rollbacks.append(attempt)
        return attempt

    # -- reporting ---------------------------------------------------------

    def _death_message(self, at_step: int, window_skips: int) -> str:
        trail = "; ".join(a.describe() for a in self.rollbacks) or "none"
        return (
            f"persistent divergence: {window_skips} skipped updates in the "
            f"window ending at step {at_step} exceed skip_budget="
            f"{self.policy.skip_budget} after "
            f"{len(self.rollbacks)}/{self.policy.max_rollbacks} rollbacks "
            f"(attempt trail: {trail})"
        )
