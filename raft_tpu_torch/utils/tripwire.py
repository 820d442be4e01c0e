"""Host-sync tripwire: proves the training hot loop never waits on the card.

The port's counterpart of the JAX package's ``raft_tpu/utils/tripwire.py``
(its :class:`HostSyncTripwire`; the transport's ``CopyTripwire`` waits for
the serving host layer, ROADMAP queue 1 item 4).

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

__all__ = ["HostSyncError", "HostSyncTripwire"]

_MISSING = object()


class HostSyncError(AssertionError):
    """The guarded region synced with the device when it must not have."""


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
