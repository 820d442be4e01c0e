"""Waste-aware tile planner + feathered overlap blend.

The port's copy of the JAX package's ``raft_tpu/serve/tiler.py`` (numpy
only). RAFT's all-pairs correlation makes full-resolution programs
quadratic in pixels, so the engine serves a *closed* program set (buckets
x iteration ladder x batch rungs, each a CUDA graph captured at
``start()``) and otherwise rejects any resolution outside it
(``ShapeRejected``). This module fans an arbitrary ``(H, W)`` into
bucket-shaped sub-requests so the program set stays closed (no new
capture for a new shape), and does it as a throughput problem:

* **Planner** (:class:`TilePlanner`): given ``(H, W)`` and the live
  bucket set, enumerate candidate tilings (bucket choice x overlap
  stride) and pick by an explicit cost model::

      cost = n_tiles * bucket_pixels * (1 + pad_penalty * pad_frac)

  where ``pad_frac`` is the replicate-padded fraction of dispatched
  pixels (edge tiles smaller than the bucket pad bottom/right with
  ``mode="edge"``, the admission convention). The overlap floor is
  configurable but never below :data:`RECEPTIVE_MARGIN_PX` (one 1/8-grid
  feature cell on each side of a seam): a seam pixel must sit inside at
  least one tile's receptive interior. Plans are deterministic and
  cached; :meth:`TilePlanner.plan` exposes them for inspection and tests.

* **Blend** (:func:`blend_tiles`): feathered (linear-ramp) overlap
  weights, computed once per plan and cached, applied on the host to the
  already-fetched per-tile flows: it launches nothing on the card.

A note on coordinates: optical flow is a *displacement* field. Both
images of a pair are sliced at identical tile offsets, so a tile's flow
values are already expressed in the shared canvas frame; the tile
coordinate offset applies to where the tile's flow is *placed* on the
canvas (``acc[y0:y0+h, x0:x0+w]``), never to the displacement values
themselves. Adding offsets to the values would shear every seam by the
tile pitch; placement-only offsets are what make seams carry no
systematic bias.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.serve.errors import ShapeRejected

__all__ = [
    "RECEPTIVE_MARGIN_PX",
    "Tile",
    "TilePlan",
    "TilePlanner",
    "blend_tiles",
    "nearest_bucket",
]

# One 1/8-grid feature cell: the refinement operates on stride-8 feature
# maps, so any overlap below 8 px gives a seam pixel no tile in which it
# is at least one feature cell away from a tile boundary.
RECEPTIVE_MARGIN_PX = 8


def nearest_bucket(
    hw: Tuple[int, int], buckets: Sequence[Tuple[int, int]]
) -> Optional[Tuple[int, int]]:
    """The bucket a rejected caller should resize toward (the 422 hint).

    Smallest *containing* bucket when one exists (resize is then pure
    padding); otherwise the bucket minimizing the L1 shape distance,
    ties broken by smaller area then configuration order — deterministic
    so the hint is stable across replicas.
    """
    if not buckets:
        return None
    containing = [
        b for b in buckets if b[0] >= hw[0] and b[1] >= hw[1]
    ]
    if containing:
        return min(containing, key=lambda b: (b[0] * b[1], b))
    best = None
    best_key = None
    for b in buckets:
        key = (abs(b[0] - hw[0]) + abs(b[1] - hw[1]), b[0] * b[1])
        if best_key is None or key < best_key:
            best, best_key = b, key
    return (int(best[0]), int(best[1]))


@dataclasses.dataclass(frozen=True)
class Tile:
    """One planned slice in canvas coordinates (``h``/``w`` never exceed
    the plan's bucket; edge tiles smaller than the bucket replicate-pad
    at admission exactly like any undersized request)."""

    y0: int
    x0: int
    h: int
    w: int


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The deterministic output of :meth:`TilePlanner.plan` for one
    ``(H, W)``: which bucket, which slices, and what it costs."""

    hw: Tuple[int, int]
    bucket: Tuple[int, int]
    tiles: Tuple[Tile, ...]
    grid: Tuple[int, int]          # (rows, cols) of the tile lattice
    overlap: Tuple[int, int]       # minimum per-seam overlap (y, x), px
    dispatched_px: int             # n_tiles * bucket_h * bucket_w
    pad_px: int                    # replicate-padded pixels across tiles
    cost: float                    # the planner's objective for this plan

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def pad_frac(self) -> float:
        """Replicate-padded fraction of dispatched pixels (the cost
        model's penalty term)."""
        return self.pad_px / self.dispatched_px if self.dispatched_px else 0.0

    @property
    def waste_frac(self) -> float:
        """Total overhead fraction: dispatched pixels that are not
        unique canvas coverage (padding + overlap), the gauge
        ``stats()['tiler']`` reports."""
        if not self.dispatched_px:
            return 0.0
        useful = self.hw[0] * self.hw[1]
        return 1.0 - useful / self.dispatched_px


def _axis_tiling(
    extent: int, b: int, overlap: int
) -> Optional[Tuple[List[Tuple[int, int]], int]]:
    """Tile one axis of length ``extent`` with bucket extent ``b`` and a
    per-seam overlap floor; returns ``([(start, length), ...], pad_px)``
    or ``None`` when infeasible (stride would be non-positive).

    ``extent <= b`` is the single replicate-padded tile. Otherwise the
    minimum tile count satisfying ``n*b - (n-1)*overlap >= extent`` is
    used and the starts are spread evenly over ``[0, extent - b]`` —
    every tile is full-bucket-sized, the last ends exactly at
    ``extent`` (zero padding), and every seam's overlap is >= the floor
    by construction of ``n``.
    """
    if extent <= b:
        return [(0, extent)], b - extent
    stride = b - overlap
    if stride <= 0:
        return None
    n = math.ceil((extent - overlap) / stride)
    span = extent - b
    starts = [(i * span) // (n - 1) for i in range(n)]
    return [(s, b) for s in starts], 0


class TilePlanner:
    """Deterministic, cached tiling plans over a fixed bucket set.

    Thread-safe; plans and their feathered blend weights are cached
    (bounded LRU-ish: cleared wholesale at capacity — plans are cheap to
    recompute, the cache exists to make the steady state allocation-free).
    """

    def __init__(
        self,
        buckets: Sequence[Tuple[int, int]],
        *,
        overlap_px: int = 2 * RECEPTIVE_MARGIN_PX,
        pad_penalty: float = 1.0,
        max_tiles: int = 64,
        cache_size: int = 128,
    ):
        if overlap_px < RECEPTIVE_MARGIN_PX:
            raise ValueError(
                f"overlap_px must be >= the {RECEPTIVE_MARGIN_PX}px "
                f"1/8-grid receptive margin, got {overlap_px}"
            )
        if pad_penalty < 0:
            raise ValueError(f"pad_penalty must be >= 0, got {pad_penalty}")
        if max_tiles < 1:
            raise ValueError(f"max_tiles must be >= 1, got {max_tiles}")
        self.buckets = tuple(
            (int(b[0]), int(b[1])) for b in buckets
        )
        self.overlap_px = int(overlap_px)
        self.pad_penalty = float(pad_penalty)
        self.max_tiles = int(max_tiles)
        self._cache_size = int(cache_size)
        self._plans: Dict[Tuple[int, int], TilePlan] = {}
        self._weights: Dict[
            Tuple[Tuple[int, int], Tuple[int, int]], List[np.ndarray]
        ] = {}
        self._lock = threading.Lock()
        self.plans_built = 0
        self.plan_cache_hits = 0

    # -- planning ----------------------------------------------------------

    def _plan_for_bucket(
        self, hw: Tuple[int, int], bucket: Tuple[int, int]
    ) -> Optional[TilePlan]:
        H, W = hw
        bh, bw = bucket
        ys = _axis_tiling(H, bh, self.overlap_px)
        xs = _axis_tiling(W, bw, self.overlap_px)
        if ys is None or xs is None:
            return None
        (rows, _), (cols, _) = ys, xs
        n = len(rows) * len(cols)
        if n > self.max_tiles:
            return None
        tiles = tuple(
            Tile(y0, x0, th, tw)
            for (y0, th) in rows
            for (x0, tw) in cols
        )
        bucket_px = bh * bw
        dispatched = n * bucket_px
        pad_px = sum(bucket_px - t.h * t.w for t in tiles)
        pad_frac = pad_px / dispatched
        cost = n * bucket_px * (1.0 + self.pad_penalty * pad_frac)
        # minimum seam overlap actually realized (reported, not assumed)
        ov_y = (
            min(
                rows[i][0] + rows[i][1] - rows[i + 1][0]
                for i in range(len(rows) - 1)
            )
            if len(rows) > 1 else 0
        )
        ov_x = (
            min(
                cols[i][0] + cols[i][1] - cols[i + 1][0]
                for i in range(len(cols) - 1)
            )
            if len(cols) > 1 else 0
        )
        return TilePlan(
            hw=(H, W), bucket=(bh, bw), tiles=tiles,
            grid=(len(rows), len(cols)), overlap=(ov_y, ov_x),
            dispatched_px=dispatched, pad_px=pad_px, cost=cost,
        )

    def plan(self, hw: Tuple[int, int]) -> TilePlan:
        """The chosen plan for ``(H, W)``: minimum cost across buckets,
        ties broken by fewer tiles, then smaller bucket area, then
        bucket configuration order. Raises the typed
        :class:`~raft_tpu_torch.serve.errors.ShapeRejected` when no bucket yields a
        feasible plan (``max_tiles`` exceeded for every bucket)."""
        hw = (int(hw[0]), int(hw[1]))
        if hw[0] < 1 or hw[1] < 1:
            raise ShapeRejected(
                f"cannot tile degenerate shape {hw}",
                supported_buckets=self.buckets,
            )
        with self._lock:
            cached = self._plans.get(hw)
            if cached is not None:
                self.plan_cache_hits += 1
                return cached
        best: Optional[TilePlan] = None
        best_key = None
        for i, b in enumerate(self.buckets):
            p = self._plan_for_bucket(hw, b)
            if p is None:
                continue
            key = (p.cost, p.n_tiles, b[0] * b[1], i)
            if best_key is None or key < best_key:
                best, best_key = p, key
        if best is None:
            raise ShapeRejected(
                f"no feasible tiling for shape {hw} within "
                f"max_tiles={self.max_tiles} (buckets: "
                f"{list(self.buckets)})",
                supported_buckets=self.buckets,
                nearest=nearest_bucket(hw, self.buckets),
            )
        with self._lock:
            if len(self._plans) >= self._cache_size:
                self._plans.clear()
            self._plans[hw] = best
            self.plans_built += 1
        return best

    # -- blend weights -----------------------------------------------------

    def _axis_weight(
        self, length: int, lead_ov: int, trail_ov: int
    ) -> np.ndarray:
        """Trapezoid profile along one tile axis: a linear ramp
        ``1/(ov+1) .. ov/(ov+1)`` over each *interior* overlap (canvas
        boundaries stay at weight 1), flat 1 between. Two neighbors with
        equal seam overlap sum to exactly 1 across it; uneven rounding
        is absorbed by the normalization in :func:`blend_tiles`."""
        w = np.ones(length, np.float32)
        if lead_ov > 0:
            w[:lead_ov] = np.arange(1, lead_ov + 1, dtype=np.float32) / (
                lead_ov + 1
            )
        if trail_ov > 0:
            w[length - trail_ov:] = np.arange(
                trail_ov, 0, -1, dtype=np.float32
            ) / (trail_ov + 1)
        return w

    def weights(self, plan: TilePlan) -> List[np.ndarray]:
        """Per-tile feathered blend weights, shaped like each tile's
        canvas slice — computed once per ``(hw, bucket)`` and cached."""
        key = (plan.hw, plan.bucket)
        with self._lock:
            cached = self._weights.get(key)
            if cached is not None:
                return cached
        rows, cols = plan.grid
        out: List[np.ndarray] = []
        tiles = plan.tiles
        for idx, t in enumerate(tiles):
            r, c = divmod(idx, cols)
            up = tiles[(r - 1) * cols + c] if r > 0 else None
            down = tiles[(r + 1) * cols + c] if r + 1 < rows else None
            left = tiles[r * cols + (c - 1)] if c > 0 else None
            right = tiles[r * cols + (c + 1)] if c + 1 < cols else None
            lead_y = max(0, up.y0 + up.h - t.y0) if up is not None else 0
            trail_y = (
                max(0, t.y0 + t.h - down.y0) if down is not None else 0
            )
            lead_x = (
                max(0, left.x0 + left.w - t.x0) if left is not None else 0
            )
            trail_x = (
                max(0, t.x0 + t.w - right.x0) if right is not None else 0
            )
            wy = self._axis_weight(t.h, lead_y, trail_y)
            wx = self._axis_weight(t.w, lead_x, trail_x)
            out.append(wy[:, None] * wx[None, :])
        with self._lock:
            if len(self._weights) >= self._cache_size:
                self._weights.clear()
            self._weights[key] = out
        return out


def blend_tiles(
    plan: TilePlan, weights: List[np.ndarray], flows: List[np.ndarray]
) -> np.ndarray:
    """Assemble per-tile flows into one ``(H, W, 2)`` canvas flow.

    Pure host-side numpy on already-fetched arrays: nothing runs on the
    card. Flow *values* are placed, never offset (the module docstring's
    coordinate note).
    """
    H, W = plan.hw
    acc = np.zeros((H, W, 2), np.float32)
    wsum = np.zeros((H, W), np.float32)
    for t, wt, fl in zip(plan.tiles, weights, flows):
        acc[t.y0:t.y0 + t.h, t.x0:t.x0 + t.w] += wt[..., None] * fl
        wsum[t.y0:t.y0 + t.h, t.x0:t.x0 + t.w] += wt
    return acc / np.maximum(wsum, 1e-8)[..., None]
