"""Shape-bucket admission: inputs become members of a closed shape set.

The port's copy of the JAX package's ``raft_tpu/serve/bucketing.py``. The
engine captures one CUDA graph per input shape (the counterpart of XLA's
one program per shape); with free-form resolutions a traffic mix is a
capture stampede — each novel shape stalls every request behind a
capture. The router closes the shape set at
admission: an input is padded (replicate, bottom/right) into the smallest
configured bucket that contains its %8-padded shape, so the whole set of
captured programs is closed and capturable at startup. An input fitting no bucket never reaches the
batch thread: it is rejected outright or routed to the rate-limited
slow path (:class:`TokenBucket`), per config.

Bottom/right padding (the `'downstream'` convention of
``raft_tpu_torch.eval.padder.InputPadder``) keeps the valid region at a fixed
origin so the flow crop back to the caller's resolution is a pure slice.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["BucketRouter", "TokenBucket"]


class BucketRouter:
    """Route raw ``(H, W)`` resolutions into the configured bucket set."""

    def __init__(self, buckets: Sequence[Tuple[int, int]], *, factor: int = 8):
        for b in buckets:
            if b[0] % factor or b[1] % factor:
                raise ValueError(
                    f"bucket {tuple(b)!r} is not %{factor}-aligned"
                )
        self.factor = factor
        # smallest-area-first so route() finds the tightest fit greedily
        self.buckets: Tuple[Tuple[int, int], ...] = tuple(
            sorted((tuple(b) for b in buckets), key=lambda b: (b[0] * b[1], b))
        )

    def route(self, h: int, w: int) -> Optional[Tuple[int, int]]:
        """Smallest bucket containing the %factor-padded input, else None."""
        ph = h + (-h) % self.factor
        pw = w + (-w) % self.factor
        for bh, bw in self.buckets:
            if bh >= ph and bw >= pw:
                return (bh, bw)
        return None

    def natural_shape(self, h: int, w: int) -> Tuple[int, int]:
        """The %factor-padded shape itself (the slow path's 'bucket')."""
        return (h + (-h) % self.factor, w + (-w) % self.factor)

    @staticmethod
    def pad_to(img: np.ndarray, bucket: Tuple[int, int]) -> np.ndarray:
        """Replicate-pad ``(..., H, W, C)`` bottom/right up to ``bucket``."""
        h, w = img.shape[-3], img.shape[-2]
        bh, bw = bucket
        if h > bh or w > bw:
            raise ValueError(f"image ({h}, {w}) exceeds bucket {bucket}")
        if (h, w) == (bh, bw):
            return img
        pad = [(0, 0)] * (img.ndim - 3) + [(0, bh - h), (0, bw - w), (0, 0)]
        return np.pad(img, pad, mode="edge")

    @staticmethod
    def crop(flow: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
        """Crop bucket-resolution flow back to the caller's ``(h, w)``."""
        h, w = hw
        return flow[..., :h, :w, :]


class TokenBucket:
    """Thread-safe token bucket: the slow path's capture-stampede brake.

    ``rate`` tokens/s sustained, ``burst`` capacity. ``try_take`` never
    blocks — the slow path sheds (retryable ``Overloaded``) rather than
    queueing, because a queued novel-shape request would just be a capture
    stampede with extra steps.
    """

    def __init__(self, rate: float, burst: int = 1, *, clock=time.monotonic):
        if rate <= 0 or burst < 1:
            raise ValueError(f"need rate > 0 and burst >= 1, got {rate}/{burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def try_take(self) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def retry_after_ms(self) -> float:
        """Milliseconds until one token accrues (a shed caller's backoff hint)."""
        with self._lock:
            deficit = max(0.0, 1.0 - self._tokens)
        return deficit / self.rate * 1e3
