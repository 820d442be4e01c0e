"""Host-sync tripwire: proves the training hot loop never waits on the card.

The port's counterpart of the JAX package's ``raft_tpu/utils/tripwire.py``:
:class:`HostSyncTripwire`, and :class:`CopyTripwire` over the port's
cross-process transport (:mod:`raft_tpu_torch.serve.ipc`).

The fused window dispatch (``train.step.make_window_step``) only pays off
if nothing between log boundaries forces a device->host synchronization:
one stray ``float(metrics['loss'])`` inside the loop serializes every
window behind a blocking transfer. :class:`HostSyncTripwire` makes that
property testable: while installed it monkeypatch-counts the
Python-level ways a CUDA tensor reaches the host —

  * ``Tensor.item``, ``tolist``, ``numpy`` and ``cpu``, the explicit
    fetches;
  * the implicit conversions ``float(t)`` / ``int(t)`` / ``bool(t)`` /
    ``t.__index__()``, which block on the card exactly like a fetch but
    hide in innocuous-looking code;
  * ``torch.cuda.synchronize``, ``torch.cuda.Event.synchronize`` and
    ``torch.cuda.Stream.synchronize``, the explicit waits.

A tensor site counts only for tensors on one of ``device_types``
(``('cuda',)`` by default; a CPU test passes ``('cpu',)`` to hold the
same code to the same rule on the CPU). Counting is gated on an ``armed``
flag so a test can scope the assertion to the hot region (arm at
dispatch, disarm at the log boundary) while the patches stay installed
for a whole run. The patches are process-global (syncs from worker
threads are caught too), restored on ``__exit__``, and test/bench-only:
nothing in the library imports this on the hot path. Syncs made inside
PyTorch's C++ (a pageable copy, ``nonzero``) are not seen here;
``torch.cuda.set_sync_debug_mode`` reports those.

Usage::

    with HostSyncTripwire() as tw:
        for _ in range(n_windows):
            state, metrics = window_fn(state, window)   # must not sync
        tw.assert_none("inside the training window")
        with tw.pause():
            host = metrics["loss"].cpu()                # boundary: allowed
"""

from __future__ import annotations

import collections
import threading
from contextlib import contextmanager
from typing import Dict, List, Tuple

__all__ = ["HostSyncError", "HostSyncTripwire", "CopyError", "CopyTripwire"]

_MISSING = object()


class HostSyncError(AssertionError):
    """The guarded region synced with the device when it must not have."""


class CopyError(AssertionError):
    """The guarded region copied transport buffers it must not have."""


class HostSyncTripwire:
    """Counts host-sync entry points while installed and armed.

    ``counts`` maps site name (``'item'``, ``'cpu'``, ``'__float__'``,
    ``'cuda.synchronize'``, ``'Event.synchronize'``, ...) to the number of
    armed hits. Thread-safe.
    """

    TENSOR_SITES = ("item", "tolist", "numpy", "cpu", "__float__", "__int__", "__bool__", "__index__")

    def __init__(self, armed: bool = True, *, device_types: Tuple[str, ...] = ("cuda",)):
        self.counts: collections.Counter = collections.Counter()
        self.device_types = tuple(device_types)
        self._armed = armed
        self._lock = threading.Lock()
        self._originals: List[Tuple[object, str, object]] = []

    # -- scoping -----------------------------------------------------------

    @property
    def armed(self) -> bool:
        return self._armed

    def arm(self) -> None:
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    @contextmanager
    def pause(self):
        """Temporarily stop counting (boundary work: fetches are legal)."""
        was, self._armed = self._armed, False
        try:
            yield self
        finally:
            self._armed = was

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()

    # -- results -----------------------------------------------------------

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def assert_none(self, where: str = "the guarded region") -> None:
        if self.total:
            raise HostSyncError(
                f"{self.total} host sync(s) inside {where}: "
                f"{dict(self.counts)} — the hot path must not fetch, "
                "block on, or implicitly convert device values"
            )

    def _hit(self, site: str) -> None:
        if self._armed:
            with self._lock:
                self.counts[site] += 1

    # -- installation ------------------------------------------------------

    def _patch(self, owner, name: str, wrapped) -> None:
        self._originals.append((owner, name, owner.__dict__.get(name, _MISSING)))
        setattr(owner, name, wrapped)

    def __enter__(self) -> "HostSyncTripwire":
        import torch

        types = self.device_types
        for site in self.TENSOR_SITES:
            orig = getattr(torch.Tensor, site)

            def wrapped(t, *a, _orig=orig, _site=site, **kw):
                if self._armed and t.device.type in types:
                    self._hit(_site)
                return _orig(t, *a, **kw)

            self._patch(torch.Tensor, site, wrapped)

        def wrap(owner, name, site):
            orig = getattr(owner, name)

            def wrapped(*a, **kw):
                self._hit(site)
                return orig(*a, **kw)

            self._patch(owner, name, wrapped)

        wrap(torch.cuda, "synchronize", "cuda.synchronize")
        wrap(torch.cuda.Event, "synchronize", "Event.synchronize")
        wrap(torch.cuda.Stream, "synchronize", "Stream.synchronize")
        return self

    def __exit__(self, *exc) -> None:
        while self._originals:
            owner, name, orig = self._originals.pop()
            if orig is _MISSING:
                delattr(owner, name)  # the inherited method shows through again
            else:
                setattr(owner, name, orig)


class CopyTripwire:
    """Counts transport-path buffer copies while installed and armed.

    The cross-process serving transport (:mod:`raft_tpu_torch.serve.ipc`)
    notes every buffer copy it performs (shm-ring put/get copies,
    tensor-body pack/unpack materializations, contiguity fixups) through a
    module-level hook. This tripwire registers a listener on that hook
    (the :class:`HostSyncTripwire` pattern: arm/disarm scoping, counts by
    site, ``assert_none``), so "this path moves bytes by reference" is an
    assertion a test makes, not a claim a docstring repeats.

    ``counts`` maps ipc copy site (``'ring_put'``, ``'ring_get'``,
    ``'pack_copy'``, ``'unpack_copy'``, ``'pack_contig'``) to armed hits;
    ``bytes_copied`` totals their payload sizes. Thread-safe, and scoped to
    THIS process: a worker process's own copies are its own (read them
    through the worker's transport stats instead).

    Usage::

        with CopyTripwire() as tw:
            client.submit(...)                 # the copying path
            assert tw.counts["ring_put"] == 2  # measured, not argued
            tw.reset()
            zero_copy_roundtrip()
            tw.assert_none("the reserved-slot request path")
    """

    def __init__(self, armed: bool = True):
        self.counts: collections.Counter = collections.Counter()
        self.bytes_copied = 0
        self._armed = armed
        self._lock = threading.Lock()

    # -- scoping (the HostSyncTripwire surface) ----------------------------

    @property
    def armed(self) -> bool:
        return self._armed

    def arm(self) -> None:
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    @contextmanager
    def pause(self):
        """Temporarily stop counting (legal-copy boundary work)."""
        was, self._armed = self._armed, False
        try:
            yield self
        finally:
            self._armed = was

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()
            self.bytes_copied = 0

    # -- results -----------------------------------------------------------

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)

    def assert_none(self, where: str = "the guarded region") -> None:
        if self.total:
            raise CopyError(
                f"{self.total} transport buffer cop(ies) inside {where}: "
                f"{dict(self.counts)} ({self.bytes_copied} bytes) — this "
                "path must move bytes by reference, not by copy"
            )

    def _hit(self, site: str, nbytes: int) -> None:
        if self._armed:
            with self._lock:
                self.counts[site] += 1
                self.bytes_copied += int(nbytes)

    # -- installation ------------------------------------------------------

    def __enter__(self) -> "CopyTripwire":
        from raft_tpu_torch.serve import ipc

        ipc.add_copy_listener(self._hit)
        return self

    def __exit__(self, *exc) -> None:
        from raft_tpu_torch.serve import ipc

        ipc.remove_copy_listener(self._hit)
