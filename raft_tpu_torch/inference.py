"""High-level inference API: the estimator owns the input contract.

:class:`FlowEstimator` takes raw [0, 255] images (uint8 or float, single
``(H, W, 3)`` or batched ``(B, H, W, 3)``), normalizes them to [-1, 1],
replicate-pads to a multiple of 8, runs the model under
``torch.inference_mode()`` on its device, and returns flow at the input
resolution as numpy ``(H, W, 2)`` / ``(B, H, W, 2)``. On the card each
(padded shape, ``num_flow_updates``) is captured once as a CUDA graph and
replayed (:mod:`raft_tpu_torch.graphs`), as the JAX estimator compiles one
program per shape and iteration count. :class:`FlowStream` encodes each
frame of a video once and reuses it for the next pair (eagerly).
"""

from __future__ import annotations

import threading
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.device import resolve_device
from raft_tpu_torch.eval.padder import InputPadder
from raft_tpu_torch.graphs import GraphProgram

__all__ = ["FlowEstimator", "FlowStream", "flow_program", "run_flow"]


def flow_program(model, image1: torch.Tensor, image2: torch.Tensor, *, num_flow_updates: int,
                 pool=None, name: str = "flow") -> GraphProgram:
    """``model``'s final flow from the static input buffers ``image1`` and
    ``image2``, as a :class:`~raft_tpu_torch.graphs.GraphProgram` whose
    ``inputs`` are the buffers. The caller fills them before each call
    (:func:`run_flow`); the first call on the card captures the graph on
    what they hold. ``pool`` is the graph memory pool to capture into
    (``None``: the program's own)."""
    prog = GraphProgram(lambda: model(image1, image2, num_flow_updates=num_flow_updates, emit_all=False),
                        image1.device, pool=pool, name=name)
    prog.inputs = (image1, image2)
    return prog


def run_flow(prog: GraphProgram, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
    """One pair through a :func:`flow_program`: the pair copied into its
    input buffers, then one call (a replay on the card)."""
    prog.inputs[0].copy_(image1)
    prog.inputs[1].copy_(image2)
    return prog()


class FlowEstimator:
    """Raw image pairs -> optical flow, with the full input contract owned.

    Args:
        model: a built :class:`~raft_tpu_torch.models.RAFT`; it is moved to
            ``device`` and put in eval mode.
        num_flow_updates: refinement iterations (32 = the published
            protocol), also the maximum a per-call override may ask for.
        pad_mode: ``'sintel'`` splits the vertical pad top/bottom,
            ``'downstream'`` pads bottom-only.
        device: the CUDA card unless ``'cpu'`` is named; raises when no
            card is present.

    On the card each (padded shape, ``num_flow_updates``) is one captured
    CUDA graph, replayed; a failed capture raises. The graphs' input
    buffers are shared by every caller thread, so a call's fill, replay
    and readout hold one lock. The CPU runs the model eagerly.

    Example::

        estimate = FlowEstimator(raft_large(corr_impl="fused"))
        flow = estimate(image1, image2)   # (H, W, 2) float32, pixels
    """

    def __init__(self, model, *, num_flow_updates: int = 32, pad_mode: str = "sintel", device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.num_flow_updates = num_flow_updates
        self.pad_mode = pad_mode
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._lock = threading.Lock()
        self._cache_info: Dict[Tuple[int, ...], int] = {}
        # (padded NHWC shape, iterations) -> program (flow_program)
        self._programs: Dict[Tuple, GraphProgram] = {}

    def cache_info(self) -> Dict[Tuple[int, ...], int]:
        """Per-padded-shape call counts (a snapshot; thread-safe)."""
        with self._lock:
            return dict(self._cache_info)

    def programs(self) -> Dict[Tuple, GraphProgram]:
        """The captured graphs, by (padded NHWC shape, iterations)."""
        with self._lock:
            return {k: prog for k, prog in self._programs.items() if prog.captured}

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by replaying this estimator's graphs, by
        kernel wrapper's name (the wrappers count only eager launches)."""
        total: Dict[str, int] = {}
        for prog in self.programs().values():
            for k, n in prog.replayed_launches().items():
                total[k] = total.get(k, 0) + n
        return total

    @classmethod
    def from_preset(
        cls,
        preset: str = "throughput",
        *,
        arch: str = "raft_large",
        pretrained: bool = True,
        checkpoint: Optional[str] = None,
        device=None,
        seed: int = 0,
        **kw,
    ) -> "FlowEstimator":
        """An estimator at a named deployment precision preset
        (``'quality'``, ``'throughput'``, the default, or ``'edge'``; see
        :mod:`raft_tpu_torch.serve.config`). Weights come from
        ``checkpoint`` (a ``.pth`` or a Flax ``.msgpack``); ``pretrained``
        without a checkpoint raises, since nothing is ever fetched, and
        ``pretrained=False`` gives seeded random weights. Extra ``**kw`` go
        to :class:`FlowEstimator`."""
        from raft_tpu_torch.models.zoo import raft_for_serving
        from raft_tpu_torch.serve.config import ServeConfig

        model = raft_for_serving(
            ServeConfig.preset(preset), arch=arch, pretrained=pretrained,
            checkpoint=checkpoint, device=device, seed=seed,
        )
        return cls(model, device=device, **kw)

    @staticmethod
    def _normalize(img) -> np.ndarray:
        """[0, 255] uint8/float -> [-1, 1] float32 ``(B, H, W, 3)``."""
        img = np.asarray(img)
        if img.ndim == 3:
            img = img[None]
        if img.ndim != 4 or img.shape[-1] != 3:
            raise ValueError(
                f"expected (H, W, 3) or (B, H, W, 3) RGB images, got {img.shape}"
            )
        if img.dtype.kind == "f" and not np.isfinite(img).all():
            # checked before the range heuristic: np.max is NaN-poisoned
            raise ValueError(
                "nonfinite pixel values (NaN/Inf) in input image: rejected "
                "at the API edge — they would poison the correlation volume "
                "downstream"
            )
        if img.dtype.kind == "f" and img.size and float(np.max(img)) <= 1.5:
            # negative values prove pre-normalization; an all-positive
            # low-max image may be a near-black [0, 255] frame, so warn only
            if float(np.min(img)) < 0.0:
                raise ValueError(
                    "images look already normalized (float with negative "
                    "values and max <= 1.5); FlowEstimator expects raw "
                    "[0, 255] values — call the model directly for "
                    "pre-normalized inputs"
                )
            warnings.warn(
                "float image with max <= 1.5: treating as raw [0, 255] "
                "(a near-black frame). If this input is [0, 1]-normalized, "
                "rescale to [0, 255] or call the model directly.",
                stacklevel=3,
            )
        return img.astype(np.float32) / 255.0 * 2.0 - 1.0

    def _validate_iters(self, n: Optional[int]) -> int:
        if n is None:
            return self.num_flow_updates
        if int(n) != n or not (1 <= int(n) <= self.num_flow_updates):
            raise ValueError(
                f"num_flow_updates must be an int in [1, {self.num_flow_updates}] "
                f"(the configured maximum), got {n!r}"
            )
        return int(n)

    def _to_device(self, img: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) numpy -> (B, 3, H, W) on the device."""
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device).permute(0, 3, 1, 2)

    @staticmethod
    def _to_host(flow: torch.Tensor) -> np.ndarray:
        """(B, 2, H, W) -> (B, H, W, 2) numpy."""
        return flow.permute(0, 2, 3, 1).float().cpu().numpy()

    def __call__(self, image1, image2, *, num_flow_updates: Optional[int] = None) -> np.ndarray:
        """Flow from ``image1`` to ``image2`` at the input resolution;
        ``num_flow_updates`` overrides the instance default per call."""
        iters = self._validate_iters(num_flow_updates)
        single = np.asarray(image1).ndim == 3
        im1 = self._normalize(image1)
        im2 = self._normalize(image2)
        if im1.shape != im2.shape:
            raise ValueError(f"image shapes differ: {im1.shape} vs {im2.shape}")
        padder = InputPadder(im1.shape, mode=self.pad_mode)
        p1, p2 = padder.pad(im1, im2)
        flow = padder.unpad(self._forward(p1, p2, iters))
        return flow[0] if single else flow

    def _forward(self, p1: np.ndarray, p2: np.ndarray, iters: int) -> np.ndarray:
        """Flow ``(B, H, W, 2)`` of a padded normalized NHWC pair."""
        with self._lock:
            self._cache_info[p1.shape] = self._cache_info.get(p1.shape, 0) + 1
        with torch.inference_mode():
            if self.device.type != "cuda":
                flow = self.model(
                    self._to_device(p1), self._to_device(p2), num_flow_updates=iters, emit_all=False
                )
                return self._to_host(flow)
            with self._lock:
                prog = self._program(p1.shape, iters)
                return self._to_host(run_flow(prog, self._to_device(p1), self._to_device(p2)))

    def _program(self, shape: Tuple[int, ...], iters: int) -> GraphProgram:
        """The graph of a padded NHWC ``shape`` at ``iters``, made on first
        use (captured at its first call)."""
        key = (shape, iters)
        prog = self._programs.get(key)
        if prog is None:
            # the buffers keep the layout _to_device gives the model
            # (NHWC memory viewed as NCHW): cuDNN picks its kernels by
            # layout, so a replay and an eager call agree bit for bit
            x1 = torch.empty(shape, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2)
            x2 = torch.empty(shape, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2)
            prog = self._programs[key] = flow_program(self.model, x1, x2, num_flow_updates=iters,
                                                      pool=self._pool, name=f"FlowEstimator {key}")
        return prog

    def open_stream(self) -> "FlowStream":
        """Start a video-stream session with encode-once feature caching."""
        return FlowStream(self)


class FlowStream:
    """One video-stream session over a :class:`FlowEstimator`.

    Feed frames in order; each call returns the flow from the previous frame
    to this one, or ``None`` for the first frame. All frames share one
    resolution. One stream, one caller thread.
    """

    def __init__(self, estimator: FlowEstimator):
        self._est = estimator
        self._shape: Optional[Tuple[int, ...]] = None
        self._padder: Optional[InputPadder] = None
        self._fmap = None  # previous frame's feature map (device)
        self._ctx = None  # previous frame's raw context output (device)

    def reset(self) -> None:
        """Drop the cached frame: the next frame primes a fresh pair."""
        self._fmap = None
        self._ctx = None

    def __call__(self, frame) -> Optional[np.ndarray]:
        """Advance the stream by one frame; flow(prev -> frame) or None."""
        est = self._est
        img = est._normalize(frame)
        if self._shape is None:
            self._shape = img.shape
            self._padder = InputPadder(img.shape, mode=est.pad_mode)
        elif img.shape != self._shape:
            raise ValueError(
                f"stream frames must share one resolution; stream is "
                f"{self._shape}, got {img.shape} (open a new stream)"
            )
        p = self._padder.pad(img)
        with torch.inference_mode():
            fmap, ctx = est.model.encode_frame(est._to_device(p))
            prev_fmap, prev_ctx = self._fmap, self._ctx
            self._fmap, self._ctx = fmap, ctx
            if prev_fmap is None:
                return None
            flow = est.model.iterate(
                prev_fmap, fmap, prev_ctx, num_flow_updates=est.num_flow_updates, emit_all=False
            )
            flow = self._padder.unpad(est._to_host(flow))
        return flow[0] if np.asarray(frame).ndim == 3 else flow
