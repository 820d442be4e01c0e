"""Resident GRU-iteration pool: iteration-level continuous batching.

The port of the JAX package's ``raft_tpu/serve/pool.py``. RAFT's
refinement loop is an *anytime* ladder — every GRU iteration emits a valid
flow — so the serving engine's dispatch unit is one ``RAFT.iterate_step``
across a fixed-capacity on-device slot array of per-request recurrent
state (continuous batching, Yu et al., OSDI '22, applied to RAFT's
recurrence). Requests join a free slot when admitted and leave the moment
their own iteration target is met; late arrivals fill freed slots
mid-flight.

The program set stays closed, per bucket, and on the card each program is
a CUDA graph captured once (the counterpart of the JAX package's jitted
programs; :mod:`raft_tpu_torch.graphs`):

  * ``begin_pair`` — admission encode + state init, one graph per
    admission rung (``ServeConfig.resolved_admit_ladder``);
  * ``step`` — ONE refinement iteration across all ``capacity`` slots
    (one graph per bucket), writing the pool state in place;
  * ``final`` — the final convex upsample of retiring slots, one graph
    per rung.

``insert`` and ``gather`` are index copies of a few launches each
(``index_copy_`` / ``index_select`` on the persistent state tensors, the
counterpart of the donated in-place scatter of the JAX ``insert``); they
run eagerly and are not captured.

Inputs of a graph live in static buffers filled before each replay: the
admission images, the retiring slots' carry, and the convergence knobs
``thresh``/``streak``/``min_iters``, which are 0-dim device tensors (as
they are traced scalars in JAX: a Python float would be baked into the
graph, and one step graph could no longer serve every threshold). The
pool state — the pyramid levels ``(capacity, h8*w8, hl, wl)``, ``coords1``
``(capacity, 2, h8, w8)``, ``hidden``, ``context`` (NCHW, where the JAX
state is NHWC), ``resid_hist`` and ``converged`` — is persistent device
tensors that ``step`` overwrites in place.

Convergence telemetry and residual-driven early exit, as in JAX: the step
reduces each slot's RMS flow update over the 1/8 grid into a rolling
``(capacity, resid_len)`` history; a slot already converged at dispatch is
frozen by ``torch.where`` (its coords/hidden/history pass through bit for
bit); the streak and age tests run on device; and the converged mask,
packed big-endian into bytes (``np.packbits``' order, so
:func:`unpack_converged` reads both packages' tokens alike), is the tick's
pacing token. Admission seeds the history with ``RESID_SENTINEL`` so a
fresh slot cannot look converged before it has run ``streak`` real
iterations.

Memory: slot state is dominated by the correlation pyramid (about 261 MB a
slot for raft_large at 440x1024 in fp32).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.graphs import GraphProgram
from raft_tpu_torch.models.corr import QuantizedPyramid

__all__ = [
    "PoolPrograms", "BucketPool", "zero_state", "unpack_converged",
    "RESID_HISTORY", "RESID_SENTINEL",
]

# Default length of the rolling per-slot residual history. The engine
# passes its full-quality iteration target (``ladder[0]``) instead.
RESID_HISTORY = 32

# Admission seed for the residual history: any value comfortably above
# every plausible convergence threshold (finite rather than inf, so the
# history stays arithmetic-friendly).
RESID_SENTINEL = 1e30

# per-slot leaves of the pool state, the pyramid's levels aside
_LEAVES = ("coords1", "hidden", "context", "resid_hist", "converged")


def unpack_converged(packed, capacity: int):
    """Host-side inverse of the step program's packed pacing token: the
    per-slot converged bool vector for ``capacity`` slots."""
    return np.unpackbits(np.asarray(packed, np.uint8))[:capacity].astype(bool)


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """``np.packbits`` of a bool vector on the tensor's device: big-endian
    bit order, zero-padded to whole bytes, ``uint8``."""
    n = bits.shape[0]
    padded = torch.zeros(-(-n // 8) * 8, dtype=torch.int64, device=bits.device)
    padded[:n] = bits.to(torch.int64)
    # 128, 64, ..., 1 made on the device: a host tensor would be a copy
    # from pageable memory, which a graph capture refuses
    weights = 2 ** torch.arange(7, -1, -1, device=bits.device)
    return (padded.view(-1, 8) * weights).sum(dim=1).to(torch.uint8)


def _levels(state):
    return state["pyramid"]


def _map_state(state, fn):
    """``fn(leaf)`` over every per-slot tensor of a state or row dict."""
    out = {k: fn(state[k]) for k in _LEAVES if k in state}
    out["pyramid"] = tuple(fn(lvl) for lvl in _levels(state))
    return out


@dataclasses.dataclass
class _SlotMeta:
    """Host-side bookkeeping for one resident request."""

    req: Any                 # serve.queue.Request
    target: int              # iterations this request runs (admission-time)
    level: int               # degradation level it was admitted at
    done: int = 0            # iterate_step dispatches applied so far
    admitted_t: float = 0.0  # time.monotonic() at admission
    # set when a fetched pacing token reports this slot's flow converged
    # on device; the device froze the slot from the tick AFTER detection,
    # so `converged_done` is the iteration count the frozen flow reflects
    converged: bool = False
    converged_done: int = 0


class PoolPrograms:
    """The closed program set of the iteration pool.

    The eager bodies (:meth:`begin_pair`, :meth:`step`, :meth:`final`,
    :meth:`insert`, :meth:`gather`) are the counterparts of the JAX
    package's jitted programs and run as they are on the CPU. On the card
    :meth:`run_begin_pair`, :meth:`run_step` and :meth:`run_final` replay
    one CUDA graph per program key (captured on first use or by
    :meth:`capture_begin_pair` / :meth:`capture_step` /
    :meth:`capture_final`); all graphs of one instance share one memory
    pool. Call everything under ``torch.inference_mode()``.
    """

    def __init__(self, model, device, resid_len: int = RESID_HISTORY):
        self.resid_len = int(resid_len)
        if self.resid_len < 1:
            raise ValueError(f"resid_len must be >= 1, got {resid_len}")
        self.model = model
        self.device = torch.device(device)
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        # key -> (graph program, its static input buffers)
        self._programs: Dict[Tuple, Tuple[GraphProgram, Tuple]] = {}
        # the step's convergence knobs: 0-dim device tensors the step graph
        # reads, refilled in place by set_knobs (never re-captured)
        self.thresh = torch.zeros((), dtype=torch.float32, device=self.device)
        self.streak = torch.ones((), dtype=torch.int64, device=self.device)
        self.min_iters = torch.ones((), dtype=torch.int64, device=self.device)

    # -- the program bodies --------------------------------------------------

    def begin_pair(self, image1, image2):
        """Admission rows: ``RAFT.begin_pair`` of ``(r, 3, bh, bw)``
        images plus a sentinel-seeded residual history and a cleared
        converged bit."""
        rows = self.model.begin_pair(image1, image2)
        if isinstance(rows["pyramid"], QuantizedPyramid):
            raise NotImplementedError(
                "corr_dtype='int8' in the iteration pool: the int8 pyramid "
                "has one scale a level over the whole batch, so its rows "
                "cannot move between slots; serve 'edge' later"
            )
        b = rows["coords1"].shape[0]
        rows["resid_hist"] = torch.full(
            (b, self.resid_len), RESID_SENTINEL, dtype=torch.float32, device=image1.device
        )
        rows["converged"] = torch.zeros((b,), dtype=torch.bool, device=image1.device)
        return rows

    def step(self, state, thresh, streak, min_iters) -> torch.Tensor:
        """ONE refinement iteration across every slot of ``state``,
        written into ``state`` in place; returns the packed converged mask
        (the pacing token). ``thresh`` (<= 0 disables), ``streak`` and
        ``min_iters`` are 0-dim tensors on the state's device."""
        R = self.resid_len
        out = self.model.iterate_step(state)
        c_old = state["coords1"]
        # per-slot RMS of this iteration's flow update (1/8-grid pixels),
        # rolled into the history: a pure observer of the step's coords
        delta = out["coords1"] - c_old
        resid = torch.sqrt(torch.mean(torch.sum(delta * delta, dim=1), dim=(1, 2)))
        hist = torch.cat([state["resid_hist"][:, 1:], resid[:, None]], dim=1)
        # a slot converged at dispatch time freezes: coords/hidden/history
        # pass through bit for bit
        frozen = state["converged"]
        f4 = frozen[:, None, None, None]
        coords1 = torch.where(f4, c_old, out["coords1"])
        hidden = torch.where(f4, state["hidden"], out["hidden"])
        hist = torch.where(frozen[:, None], state["resid_hist"], hist)
        # streak test over the history tail: positions [R - streak, R)
        # all below thresh
        tail = torch.arange(R, device=hist.device) >= (R - streak)
        streak_ok = torch.all((hist < thresh) | ~tail[None, :], dim=1)
        # age gate: the m-th-newest position must hold a real residual
        m = torch.clamp(torch.maximum(streak, min_iters), 1, R)
        pos = (R - m).to(torch.int64).reshape(1, 1).expand(hist.shape[0], 1)
        age_ok = torch.gather(hist, 1, pos)[:, 0] < RESID_SENTINEL * 0.5
        converged = frozen | (streak_ok & age_ok & (thresh > 0.0))
        state["coords1"].copy_(coords1)
        state["hidden"].copy_(hidden)
        state["resid_hist"].copy_(hist)
        state["converged"].copy_(converged)
        return packbits(converged)

    def final(self, coords1, hidden):
        """The final upsample of retiring slots' carry: ``(r, 2, H, W)``."""
        return self.model.finalize_flow(coords1, hidden)

    @staticmethod
    def insert(state, rows, idx, mask):
        """Write every admitted row of ``rows`` into its slot, in place.

        ``idx[j]`` is the slot row ``j`` lands in and ``mask[j]`` whether
        it is a real admission (padding lanes touch nothing); where two
        real rows name one slot the later wins, as the JAX scan applies
        them in order. Returns ``state``."""
        idx = np.asarray(idx, np.int64)
        last: Dict[int, int] = {}
        for j in np.flatnonzero(np.asarray(mask, bool)):
            last[int(idx[j])] = int(j)
        if not last:
            return state
        dev = state["coords1"].device
        slots = torch.tensor(list(last), dtype=torch.int64, device=dev)
        src = torch.tensor(list(last.values()), dtype=torch.int64, device=dev)
        for k in _LEAVES:
            state[k].index_copy_(0, slots, rows[k].index_select(0, src))
        for lvl, row in zip(_levels(state), _levels(rows)):
            lvl.index_copy_(0, slots, row.index_select(0, src))
        return state

    @staticmethod
    def gather(coords1, hidden, resid_hist, idx):
        """The recurrent carry and residual history of the slots in
        ``idx``."""
        i = torch.as_tensor(np.asarray(idx, np.int64), device=coords1.device)
        return coords1.index_select(0, i), hidden.index_select(0, i), resid_hist.index_select(0, i)

    def set_knobs(self, thresh: float, streak: int, min_iters: int) -> None:
        """Refill the step's convergence knobs in place (a captured step
        graph reads the new values at its next replay)."""
        self.thresh.fill_(float(thresh))
        self.streak.fill_(int(streak))
        self.min_iters.fill_(int(min_iters))

    # -- the captured set ----------------------------------------------------

    def _program(self, key, make):
        entry = self._programs.get(key)
        if entry is None:
            static, fn = make()
            entry = self._programs[key] = (GraphProgram(fn, self.device, pool=self._pool, name=key[0]), static)
        return entry

    def capture_begin_pair(self, rung: int, bucket: Tuple[int, int]):
        """The ``begin_pair`` program of ``rung`` rows at ``bucket``,
        captured now on the card."""
        bh, bw = bucket

        def make():
            x1 = torch.zeros((rung, 3, bh, bw), dtype=torch.float32, device=self.device)
            x2 = torch.zeros_like(x1)
            return (x1, x2), lambda: self.begin_pair(x1, x2)

        prog, static = self._program(("pool_begin_pair", rung, bh, bw), make)
        prog.capture()
        return prog, static

    def run_begin_pair(self, image1: torch.Tensor, image2: torch.Tensor):
        """Admission rows of an ``(r, 3, bh, bw)`` pair: the captured
        program's outputs on the card (valid until its next replay), the
        eager body on the CPU."""
        if self.device.type != "cuda":
            return self.begin_pair(image1.to(self.device), image2.to(self.device))
        r, _, bh, bw = image1.shape
        prog, (x1, x2) = self.capture_begin_pair(r, (bh, bw))
        x1.copy_(image1)
        x2.copy_(image2)
        return prog()

    def capture_step(self, state):
        """The capacity-wide ``step`` program over ``state``, captured now
        on the card. One graph per state: its leaves are the graph's
        buffers, so it serves that state only."""
        c = state["coords1"]
        key = ("pool_step", c.shape[0], c.shape[2], c.shape[3])
        prog, static = self._program(
            key, lambda: ((state,), lambda: self.step(state, self.thresh, self.streak, self.min_iters))
        )
        if static[0] is not state:
            raise ValueError(f"{key}: the step program was captured over another pool state")
        prog.capture()
        return prog

    def run_step(self, state) -> torch.Tensor:
        """One tick over ``state`` at the current knobs; returns the
        pacing token (the captured program's output on the card)."""
        if self.device.type != "cuda":
            return self.step(state, self.thresh, self.streak, self.min_iters)
        return self.capture_step(state)()

    def capture_final(self, coords1: torch.Tensor, hidden: torch.Tensor):
        """The ``final`` program for carry shaped like ``coords1`` and
        ``hidden``, captured now on the card."""
        r, _, h8, w8 = coords1.shape

        def make():
            c = torch.zeros_like(coords1, device=self.device)
            h = torch.zeros_like(hidden, device=self.device)
            return (c, h), lambda: self.final(c, h)

        prog, static = self._program(("pool_final", r, h8, w8), make)
        prog.capture()
        return prog, static

    def run_final(self, coords1: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        """Flow of the retiring slots' carry (the captured program's output
        on the card, valid until its next replay)."""
        if self.device.type != "cuda":
            return self.final(coords1, hidden)
        prog, (c, h) = self.capture_final(coords1, hidden)
        c.copy_(coords1)
        h.copy_(hidden)
        return prog()

    def graphs(self) -> Dict[Tuple, GraphProgram]:
        """Every captured program, by key."""
        return {k: prog for k, (prog, _) in self._programs.items() if prog.captured}

    def counts(self) -> Dict[str, int]:
        """Captured-program count per pool program (-1 where there are no
        graphs: on the CPU). ``insert`` and ``gather`` run eagerly and
        capture nothing."""
        if self.device.type != "cuda":
            return {k: -1 for k in ("pool_begin_pair", "pool_step", "pool_final", "pool_insert", "pool_gather")}
        counts = {"pool_begin_pair": 0, "pool_step": 0, "pool_final": 0, "pool_insert": 0, "pool_gather": 0}
        for key in self.graphs():
            counts[key[0]] += 1
        return counts


def zero_state(progs: PoolPrograms, capacity: int, bucket: Tuple[int, int]):
    """An all-zeros pool state for ``capacity`` slots of ``bucket`` on the
    programs' device, shaped and typed like the rows ``begin_pair`` gives
    one zero pair."""
    bh, bw = bucket
    x = torch.zeros((1, 3, bh, bw), dtype=torch.float32, device=progs.device)
    row = progs.begin_pair(x, x)
    return _map_state(row, lambda t: torch.zeros((capacity,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device))


class BucketPool:
    """One bucket's resident slot array + host-side slot table."""

    def __init__(self, bucket: Tuple[int, int], capacity: int, state):
        self.bucket = bucket
        self.capacity = int(capacity)
        self.state = state                     # device tensors, lead dim = capacity
        self.slots: List[Optional[_SlotMeta]] = [None] * self.capacity
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        # dispatched-but-unfetched tick tokens (the pacing window):
        # (dispatch time, token, occupants) where occupants snapshots
        # (slot, rid, done-after-tick) at dispatch — a fetched mask bit is
        # only believed for the same (slot, rid) it was dispatched for
        self.pending: "collections.deque[Tuple[float, Any, Tuple]]" = collections.deque()
        self.tick_ewma_ms = 50.0               # device time per tick (est.)
        self.last_drain_t: Optional[float] = None

    def occupied(self) -> List[Tuple[int, _SlotMeta]]:
        return [(i, m) for i, m in enumerate(self.slots) if m is not None]

    def occupied_count(self) -> int:
        return self.capacity - len(self._free)

    def free_count(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        return self._free.pop()

    def release(self, i: int) -> None:
        self.slots[i] = None
        self._free.append(i)
        if len(self._free) == self.capacity:
            # pool went idle: drop pacing state so the next burst doesn't
            # inherit a stale tick-time sample or hold dead tokens
            self.pending.clear()
            self.last_drain_t = None

    def clear(self) -> List[_SlotMeta]:
        """Empty every slot (callers fail/finish the requests); returns
        the evicted metas."""
        metas = [m for m in self.slots if m is not None]
        self.slots = [None] * self.capacity
        self._free = list(range(self.capacity - 1, -1, -1))
        self.pending.clear()
        self.last_drain_t = None
        return metas

    def note_drain(self, now: float) -> None:
        """One pipeline drain completed: fold the drain-to-drain gap into
        the tick-time estimate (the clamp keeps a scheduling stall from
        blowing up the EWMA)."""
        if self.last_drain_t is not None:
            dt = (now - self.last_drain_t) * 1e3
            dt = min(dt, 10.0 * self.tick_ewma_ms)
            self.tick_ewma_ms += 0.25 * (dt - self.tick_ewma_ms)
        self.last_drain_t = now
