"""Deadline-aware micro-batching queue: bounded, shedding, EDF-seeded.

The port's copy of the JAX package's ``raft_tpu/serve/queue.py`` (without
``put_many``, which serves ``submit_many``, not ported yet).

The queue is the engine's backpressure boundary. It is *bounded* —
``put`` on a full queue raises a retryable
:class:`~raft_tpu_torch.serve.errors.Overloaded` immediately instead of buying the
caller a slot of unbounded latency (shed early, shed cheap: a request the
engine cannot serve by its deadline is better failed at admission than
executed late for nobody).

Batch formation is earliest-deadline-first: the seed of each batch is the
queued request with the least slack, and the straggler wait
(``max_wait``) is additionally capped by the seed's own remaining
deadline, so the queue never dawdles a tight request past its deadline to
fill a batch. Only same-bucket, same-kind requests co-batch (one captured
program per batch; pairwise and stream requests run different programs);
others stay queued for the next round.

Completion is set-once: whichever side finishes a request first (worker
result, worker error, caller-side deadline) wins and the other side's
finish is a no-op, so worker/caller races are benign by construction.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from raft_tpu_torch.serve.errors import EngineStopped, Overloaded
from raft_tpu_torch.serve.qos import effective_rank, rank_of

__all__ = ["Request", "MicroBatchQueue"]


class Request:
    """One in-flight serving request (internal to the engine)."""

    __slots__ = (
        "rid", "bucket", "p1", "p2", "orig_hw", "deadline", "t_submit",
        "slow_path", "kind", "iters", "priority", "rank",
        "_event", "_lock", "_done", "_callbacks", "result", "error",
    )

    def __init__(
        self,
        rid: int,
        bucket: Tuple[int, int],
        p1: np.ndarray,
        p2: np.ndarray,
        orig_hw: Tuple[int, int],
        deadline: float,
        *,
        slow_path: bool = False,
        kind: str = "pair",
        iters: Optional[int] = None,
        priority: str = "standard",
    ):
        self.rid = rid
        self.bucket = bucket
        self.p1 = p1          # (1, bh, bw, 3) float32, normalized + padded
        self.p2 = p2
        self.orig_hw = orig_hw
        self.deadline = deadline            # time.monotonic() timestamp
        self.t_submit = time.monotonic()
        self.slow_path = slow_path
        self.kind = kind                    # 'pair', or 'slow' (the engine's slow path); streams wait
        self.iters = iters    # per-request num_flow_updates cap (None = full)
        self.priority = priority            # QoS class
        self.rank = rank_of(priority)       # 0 = interactive ... 2 = batch
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._done = False
        self._callbacks: List = []
        self.result = None
        self.error: Optional[BaseException] = None

    @property
    def remaining(self) -> float:
        """Seconds of deadline slack left (negative when expired)."""
        return self.deadline - time.monotonic()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def finish(self, result=None, error: Optional[BaseException] = None,
               on_first=None) -> bool:
        """Complete the request exactly once; later calls are no-ops.

        ``on_first`` (optional) runs only on the winning call, BEFORE the
        waiter is woken or any done-callback fires — completion
        accounting rides it, so a caller that has observed the result can
        never read counters that predate it (the reply callback and the
        stats reader may live in different threads or processes).
        """
        with self._lock:
            if self._done:
                return False
            self._done = True
            self.result = result
            self.error = error
            callbacks, self._callbacks = self._callbacks, []
        if on_first is not None:
            try:
                on_first(self)
            except Exception:
                pass  # accounting never breaks completion
        self._event.set()
        for fn in callbacks:
            try:
                fn(self)
            except Exception:
                pass  # a completion observer never breaks the worker
        return True

    def add_done_callback(self, fn) -> None:
        """Invoke ``fn(self)`` when the request completes — immediately
        if it already has."""
        with self._lock:
            if not self._done:
                self._callbacks.append(fn)
                return
        try:
            fn(self)
        except Exception:
            pass

    def wait(self, timeout: Optional[float]) -> bool:
        return self._event.wait(timeout)


class MicroBatchQueue:
    """Bounded FIFO with EDF-seeded, bucket-homogeneous batch formation."""

    def __init__(self, capacity: int, *, qos: bool = False,
                 aging_ms: float = 500.0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        # QoS arm: lowest-class-first shedding + class-aware EDF seeding
        # with the aging starvation guard. Off (default) the queue is
        # priority-blind.
        self._qos = bool(qos)
        self._aging_ms = float(aging_ms)
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._forming = 0   # batches popped but not yet task_done()-acked

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    def forming(self) -> int:
        """Batches :meth:`next_batch` has popped that the worker has not
        yet acknowledged via :meth:`task_done` — work that is in neither
        ``depth()`` nor the engine's own dispatch bookkeeping. A quiesce
        check that ignores this can declare the engine idle while the
        worker holds accepted requests it is about to dispatch."""
        with self._cond:
            return self._forming

    def task_done(self) -> None:
        """Acknowledge one non-empty :meth:`next_batch` result: its
        requests are now reflected downstream (dispatched, admitted, or
        finished). Every non-empty ``next_batch`` must be matched."""
        with self._cond:
            self._forming = max(0, self._forming - 1)

    def _preempt_victim_locked(self, req: Request) -> Optional[Request]:
        """Pick the queued request ``req`` may displace (QoS).

        Lowest class first, newest arrival first among equals; a request
        whose age has crossed ``aging_ms`` is starvation-protected (its
        effective rank is interactive) and can no longer be displaced.
        ``None`` when nobody strictly lower-class is preemptable.
        """
        now = time.monotonic()
        victim: Optional[Request] = None
        v_key = None
        for r in self._q:
            eff = effective_rank(r.rank, r.t_submit, self._aging_ms, now)
            if eff <= req.rank:
                continue  # same or higher class: never preempted
            key = (eff, r.t_submit)  # lowest class, then newest
            if v_key is None or key > v_key:
                victim, v_key = r, key
        return victim

    def put(
        self,
        req: Request,
        *,
        retry_after_ms: float = 50.0,
        preempted: Optional[List[Request]] = None,
    ) -> None:
        """Admit or shed. Full queue -> retryable :class:`Overloaded`.

        With QoS on, a full queue first tries to displace a queued
        strictly-lower-class request (lowest class, newest first, aging-
        protected requests excluded): the victim is *removed and appended
        to the caller's ``preempted`` list* — the caller owns finishing
        it with a typed retryable error (never silently lost) — and the
        arrival is admitted in its place. Only when no victim exists does
        the arrival shed as before.
        """
        with self._cond:
            if self._closed:
                raise EngineStopped("serve engine is stopped")
            if len(self._q) >= self.capacity:
                victim = (
                    self._preempt_victim_locked(req) if self._qos else None
                )
                if victim is None:
                    raise Overloaded(
                        f"queue at capacity ({self.capacity}); retry in "
                        f"~{retry_after_ms:.0f}ms",
                        retry_after_ms=retry_after_ms,
                    )
                self._q.remove(victim)
                if preempted is not None:
                    preempted.append(victim)
            self._q.append(req)
            self._cond.notify()

    def next_batch(
        self,
        max_batch: int,
        max_wait: float,
        *,
        poll: float = 0.05,
        cap=None,
    ) -> List[Request]:
        """Form the next micro-batch; ``[]`` on an idle poll tick.

        Blocks at most ``poll`` seconds for a first request (so the worker
        loop stays responsive to shutdown), then gathers same-bucket
        requests until the batch is full or ``min(max_wait, seed slack)``
        elapses.

        ``cap`` (optional) is a ``(bucket, kind) -> int`` callable giving
        the admission headroom per class — slot-granularity admission for
        the iteration pool. The EDF seed is chosen among requests whose
        class has headroom (a bucket whose pool is momentarily full must
        not head-of-line-block admission into other buckets), and the
        batch size is additionally bounded by the seed's headroom.
        """
        with self._cond:
            if not self._q:
                if poll > 0:
                    self._cond.wait(poll)
                if not self._q:
                    return []
            candidates = self._q
            if cap is not None:
                candidates = [
                    r for r in self._q if cap(r.bucket, r.kind) > 0
                ]
                if not candidates:
                    return []
            if self._qos:
                # class-aware EDF: highest class first (aging promotes a
                # starved request to interactive rank — batch always
                # progresses), earliest deadline within a class
                now = time.monotonic()
                seed = min(
                    candidates,
                    key=lambda r: (
                        effective_rank(
                            r.rank, r.t_submit, self._aging_ms, now
                        ),
                        r.deadline,
                    ),
                )
            else:
                seed = min(candidates, key=lambda r: r.deadline)
            if cap is not None:
                max_batch = min(max_batch, cap(seed.bucket, seed.kind))
            # mark the batch in-formation BEFORE the first pop (same
            # lock hold), so no observer can ever see the popped work in
            # neither depth() nor forming(); the caller acks with
            # task_done() once its own bookkeeping reflects the batch
            self._forming += 1
            try:
                self._q.remove(seed)
                batch = [seed]
                t_end = time.monotonic() + max(
                    0.0, min(max_wait, seed.remaining)
                )
                while len(batch) < max_batch:
                    for r in [
                        r
                        for r in self._q
                        if r.bucket == seed.bucket and r.kind == seed.kind
                    ]:
                        if len(batch) >= max_batch:
                            break
                        self._q.remove(r)
                        batch.append(r)
                    if len(batch) >= max_batch:
                        break
                    left = t_end - time.monotonic()
                    if left <= 0 or self._closed:
                        break
                    self._cond.wait(left)
                return batch
            except BaseException:
                self._forming -= 1
                raise

    def drain(self) -> List[Request]:
        """Empty the queue *without* closing it; return what was queued.

        The drain seam (:meth:`ServeEngine.drain`): queued-but-undispatched
        requests are handed back for a typed
        :class:`~raft_tpu_torch.serve.errors.Draining` failure while the worker keeps
        running — in-flight dispatches finish normally and the queue can
        keep forming (empty) batches until the engine quiesces.
        """
        with self._cond:
            drained = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        return drained

    def close(self) -> List[Request]:
        """Stop admitting; return (drained) whatever was still queued."""
        with self._cond:
            self._closed = True
            drained = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        return drained
