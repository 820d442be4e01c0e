"""Fault-tolerance primitives of the training data path.

The port's own copy of the input-pipeline part of the JAX package's
``raft_tpu/utils/faults.py``:

  * :class:`DataFaultPolicy`: what the input pipeline does with a sample
    that fails to load: retry transient ``OSError``s with capped
    exponential backoff, quarantine-and-skip deterministic parse errors,
    bounded by a bad-sample budget (``data.pipeline.TrainPipeline``);
  * :func:`retry_transient`: the backoff loop;
  * :class:`BadSampleBudgetError` and :class:`CheckpointRestoreError`
    (``checkpoint.manager``).

The stall watchdog and the fault injectors are not ported yet (ROADMAP
queue 1 item 3g).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional, Tuple

__all__ = [
    "BadSampleBudgetError",
    "CheckpointRestoreError",
    "DataFaultPolicy",
    "retry_transient",
]


class BadSampleBudgetError(RuntimeError):
    """The data pipeline quarantined more distinct samples than allowed."""


class CheckpointRestoreError(RuntimeError):
    """No retained checkpoint restored and validated.

    ``attempts`` is the ``[(step, repr(error)), ...]`` trail of every step
    tried (newest first) so the failure is diagnosable from the message
    alone.
    """

    def __init__(self, msg: str, attempts: Tuple = ()):
        super().__init__(msg)
        self.attempts = tuple(attempts)


# Golden-ratio conjugate: frac(k * phi) is a low-discrepancy sequence in
# [0, 1): successive retry attempts get well-spread jitter fractions from
# the attempt counter alone, no RNG.
_JITTER_PHI = 0.6180339887498949


def retry_transient(
    fn: Callable[[], Any],
    *,
    attempts: int = 3,
    base_delay: float = 0.5,
    max_delay: float = 8.0,
    transient: Tuple[type, ...] = (OSError, TimeoutError),
    jitter: float = 0.25,
    max_elapsed: Optional[float] = None,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
) -> Any:
    """Call ``fn()``, retrying ``transient`` errors with capped exponential
    backoff plus multiplicative jitter. The last failure re-raises; anything
    outside ``transient`` (deterministic parse errors, real bugs) propagates
    immediately.

    The jitter is **deterministic**: attempt ``k`` sleeps
    ``min(base * 2^k, max_delay) * (1 + jitter * frac((k + 1) * phi))`` —
    a counter-derived golden-ratio fraction instead of ``random()``, so
    retry schedules are reproducible in tests and the hot reconnect path
    never touches an RNG. ``max_elapsed`` is a wall-budget on the whole
    loop: once the elapsed time
    plus the next backoff would cross it, the current failure re-raises
    instead of sleeping: the budget bounds *time*, ``attempts`` bounds
    *tries*, and whichever is hit first ends the loop.
    """
    delay = base_delay
    t0 = time.monotonic()
    for attempt in range(attempts):
        try:
            return fn()
        except transient as e:
            if attempt == attempts - 1:
                raise
            pause = min(delay, max_delay) * (
                1.0 + jitter * ((attempt + 1) * _JITTER_PHI % 1.0)
            )
            if max_elapsed is not None and (
                time.monotonic() - t0 + pause > max_elapsed
            ):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(pause)
            delay *= 2.0
    raise AssertionError("unreachable")  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class DataFaultPolicy:
    """What the input pipeline does when ``dataset[idx]`` raises.

    * ``transient`` errors (network/filesystem flakes — ``OSError`` and
      subclasses) are retried up to ``max_retries`` extra times with capped
      exponential backoff.
    * ``deterministic`` errors (parse failures — ``ValueError``: bad magic,
      corrupt header, truncated payload) are never retried; the bytes on
      disk will not change.
    * After retries are exhausted (or immediately, for deterministic
      errors): ``mode='skip'`` quarantines the index — it is skipped
      without re-reading on every future draw — and refills the batch slot
      from the index stream; ``mode='raise'`` propagates (fail-fast, the
      pre-fault-policy behavior, still with transient retries).
    * The run fails with :class:`BadSampleBudgetError` once more than
      ``max_bad_samples`` *distinct* samples are quarantined: mass
      corruption is a storage incident, not something to skip through.

    Counters (``data/skipped`` = skipped draws, ``data/retries`` = transient
    retries) surface through the trainer's log boundary.
    """

    mode: str = "skip"  # 'skip' | 'raise'
    max_bad_samples: int = 64
    max_retries: int = 2
    base_delay: float = 0.1
    max_delay: float = 5.0
    transient: Tuple[type, ...] = (OSError,)
    deterministic: Tuple[type, ...] = (ValueError,)

    def __post_init__(self):
        if self.mode not in ("skip", "raise"):
            raise ValueError(
                f"DataFaultPolicy.mode must be 'skip' or 'raise', got {self.mode!r}"
            )
