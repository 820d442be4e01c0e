"""The serving engine's closed program set, captured as CUDA graphs.

The port's counterpart of the JAX package's ``raft_tpu/serve/aot.py``
(its pool-mode enumeration and warmup): where JAX lowers and compiles each
program ahead of time, the port captures each one as a CUDA graph
(:mod:`raft_tpu_torch.graphs`) before the worker starts, so readiness
implies the worker never captures. :func:`program_specs` enumerates the
set, per bucket: the capacity-wide ``pool_step``, and ``pool_begin_pair``
and ``pool_final`` at every admission rung. ``insert`` and ``gather`` are
eager index copies and have no program. :func:`capture_events` (a process
count of captures) takes the place of ``compile_events()``.

The JAX module's warmup-artifact, fingerprint and persistent-cache tiers
have no counterpart: a CUDA graph holds device pointers of the process
that captured it and cannot be serialized, so every boot captures.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Tuple

from raft_tpu_torch.graphs import capture_events

__all__ = ["ProgramSpec", "capture_events", "program_specs", "warm_engine"]


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One program of the closed set: its key (the engine's dispatch and
    ledger key) and a function that captures it."""

    key: Tuple
    capture: Callable[[], Any]


def program_specs(engine) -> List[ProgramSpec]:
    """Every program the engine's worker may dispatch, in pool mode."""
    progs = engine._pool_progs
    cap = engine._pool_cap
    specs: List[ProgramSpec] = []
    for bucket in engine._router.buckets:
        bh, bw = bucket
        h8, w8 = bh // 8, bw // 8

        def state(b=bucket):
            return engine._pool_for(b).state

        specs.append(ProgramSpec(("pool_step", cap, h8, w8), lambda s=state: progs.capture_step(s())))
        for r in engine._admit_ladder:
            specs.append(ProgramSpec(
                ("pool_begin_pair", r, bh, bw), lambda r=r, b=bucket: progs.capture_begin_pair(r, b)
            ))
            specs.append(ProgramSpec(
                ("pool_final", r, h8, w8),
                lambda r=r, s=state: progs.capture_final(s()["coords1"][:r], s()["hidden"][:r]),
            ))
    return specs


def warm_engine(engine) -> Dict[str, Any]:
    """Capture the engine's whole program set (on the card; the CPU runs
    eagerly and captures nothing). Returns the ``stats()['boot']``
    accounting, less the ready time the engine stamps itself."""
    t0 = time.monotonic()
    before = capture_events()
    specs = program_specs(engine)
    for spec in specs:
        spec.capture()
    captured = capture_events() - before
    return {
        "source": "capture" if engine.device.type == "cuda" else "eager",
        "programs_total": len(specs),
        "programs_captured": captured,
        "capture_ms": (time.monotonic() - t0) * 1e3,
    }
