"""Typed serving errors: every failure a caller can see, classified.

The port's copy of the JAX package's ``raft_tpu/serve/errors.py`` (the
port cannot import it: importing ``raft_tpu.serve`` loads jax), without
the artifact and rollout errors, whose features are not ported.

The serving contract (the JAX package's docs/failure_model.md, serving ladder) is that a
request fails in exactly one of a small set of ways, each telling the
caller what to do next:

  * retryable (``.retryable`` is True) — :class:`Overloaded` (back off
    ``retry_after_ms`` and resubmit, nothing is wrong with the request) and
    :class:`DeadlineExceeded` (the request was fine but the engine could
    not meet its deadline; resubmit with a looser one).
  * terminal — :class:`InvalidInput` / :class:`ShapeRejected` (the request
    itself is malformed; resubmitting verbatim will fail again) and
    :class:`PoisonedInput` (the isolating quarantine error: this exact
    input drives the model non-finite even alone — one poisoned request
    costs one request, never a batch or the worker).
  * lifecycle — :class:`EngineStopped` (shutdown races; resubmit against a
    live engine).

Everything derives from :class:`ServeError` so callers can catch the whole
family; nothing here ever escapes as an unhandled exception type the API
does not document.
"""

from __future__ import annotations

__all__ = [
    "ServeError",
    "Overloaded",
    "Draining",
    "QuotaExceeded",
    "DeadlineExceeded",
    "InvalidInput",
    "ShapeRejected",
    "PoisonedInput",
    "EngineStopped",
]


class ServeError(RuntimeError):
    """Base class for every error the serving layer raises to callers."""

    retryable = False


class Overloaded(ServeError):
    """The bounded queue (or slow-path rate limit) shed this request.

    Retryable by contract: the request is well-formed, the engine is just
    at capacity. ``retry_after_ms`` is the engine's estimate of when a slot
    frees up (queue depth x recent batch latency).
    """

    retryable = True

    def __init__(self, msg: str, retry_after_ms: float = 50.0):
        super().__init__(msg)
        self.retry_after_ms = float(retry_after_ms)


class Draining(Overloaded):
    """The engine is quiescing for a restart (config reload, checkpoint
    swap, planned shutdown) and is not admitting new work.

    Retryable by contract — nothing is wrong with the request, this
    exact engine is just on its way out. ``retry_after_ms`` (inherited
    from :class:`Overloaded`) estimates when a replacement admits again.
    Subclasses :class:`Overloaded` so clients' existing shed/backoff
    paths treat a drain exactly like a shed.
    """


class QuotaExceeded(Overloaded):
    """This *tenant* is over its admission quota (rate or concurrency).

    The multi-tenant QoS refusal: unlike :class:`Overloaded`
    proper — the engine is at capacity, anyone's request would shed —
    this request was refused because its tenant exhausted its own
    token-bucket rate or concurrency cap; other tenants are unaffected.
    Retryable after ``retry_after_ms`` (the tenant's bucket refill
    estimate). The frontend maps it to HTTP 429 where a capacity shed is
    503. ``tenant`` names the offender (best-effort; the message carries
    it across the wire either way).
    """

    def __init__(self, msg: str, retry_after_ms: float = 50.0,
                 tenant: str = ""):
        super().__init__(msg, retry_after_ms=retry_after_ms)
        self.tenant = tenant


class DeadlineExceeded(ServeError):
    """The request's deadline passed before a result was produced.

    Raised both for requests that expired waiting in the queue (shed
    without execution) and for requests whose batch was still on device
    when the deadline hit. Retryable with a looser deadline.
    """

    retryable = True


class InvalidInput(ServeError, ValueError):
    """The request failed admission validation (shape/dtype/nonfinite).

    Terminal: resubmitting the same bytes fails the same way. Also a
    ``ValueError`` so pre-serve callers of the bare ``FlowEstimator``
    contract catch it naturally.
    """


class ShapeRejected(InvalidInput):
    """No configured shape bucket admits this resolution.

    Terminal under ``unknown_shape='reject'``; under ``'slow_path'`` the
    request is instead routed to the rate-limited slow path, and under
    ``'tiled'`` it is fanned into bucket-shaped tiles — in
    both cases this error is only raised when that arm itself cannot
    serve the shape (e.g. no feasible plan within ``tile_max_tiles``).

    Machine-readable serviceability fields: the frontend maps
    this error to HTTP 422 with an ``X-Raft-Supported-Buckets`` header,
    and both fields round-trip the wire so a client can resize instead
    of guessing:

    * ``supported_buckets`` — the rejecting tier's bucket set, as
      ``((H, W), ...)`` (empty when unknown).
    * ``nearest`` — the bucket the caller should resize toward, or
      ``None``.
    """

    def __init__(self, msg: str, supported_buckets=(), nearest=None):
        super().__init__(msg)
        self.supported_buckets = tuple(
            (int(b[0]), int(b[1])) for b in supported_buckets
        )
        self.nearest = (
            None if nearest is None else (int(nearest[0]), int(nearest[1]))
        )


class PoisonedInput(ServeError):
    """This input produced non-finite flow even when executed alone.

    The isolating quarantine error (the inference mirror of training's
    data quarantine): the batch it rode in was retried as singles, every
    co-batched request got its real result, and only this one failed.
    """


class EngineStopped(ServeError):
    """The engine is not running (never started, stopping, or stopped)."""

