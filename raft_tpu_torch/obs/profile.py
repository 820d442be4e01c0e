"""Opt-in profiler ranges around the engine's and the trainer's dispatches.

The port's counterpart of the JAX package's ``raft_tpu/obs/profile.py``.
The spans in :mod:`raft_tpu_torch.obs.trace` time the *host's* view of a
request; correlating them with what the card executed needs named ranges
in the profiler timeline. A range on every dispatch would put a profiler
call on the hot path, so this module is a process-wide toggle:

    from raft_tpu_torch.obs import profile
    profile.enable()                      # or RAFT_OBS_PROFILE=1
    ...
    with profile.annotate("serve/pool_step"):
        program.replay()                   # a named range around the launch

Each range is ``torch.profiler.record_function(name)``: it shows up as a
CPU-side range in a ``torch.profiler`` trace (and, under
``torch.autograd.profiler.emit_nvtx``, as an NVTX range for Nsight).
Disabled (the default), :func:`annotate` returns a shared no-op context
manager — the cost is one global read and a truth test per dispatch.
Nothing here starts a profiler by itself.
"""

from __future__ import annotations

import contextlib
import os

__all__ = ["enable", "disable", "enabled", "annotate"]

_NULL = contextlib.nullcontext()
_on = os.environ.get("RAFT_OBS_PROFILE", "") not in ("", "0", "false")


def enable(on: bool = True) -> None:
    """Turn dispatch-window profiler ranges on (process-wide)."""
    global _on
    _on = bool(on)


def disable() -> None:
    enable(False)


def enabled() -> bool:
    return _on


def annotate(name: str):
    """A named profiler range when enabled, a shared no-op otherwise."""
    if not _on:
        return _NULL
    import torch

    return torch.profiler.record_function(name)
