"""The whole-request engine's closed program set, one CUDA graph a key.

The counterpart of the JAX package's jitted ``ServeEngine`` programs for
``pool_capacity=0`` and for stream encodes (``raft_tpu/serve/engine.py``,
``_apply``, ``_encode``, ``_iterate``): where JAX compiles one program per
input shape and static iteration count, the port captures one graph per
key (:mod:`raft_tpu_torch.graphs`) and replays it:

  * ``pairwise`` ``(rung, bh, bw, iters)`` — the whole forward of a padded
    pair batch, ``RAFT.forward(emit_all=False)``;
  * ``encode`` ``(rung, bh, bw)`` — ``RAFT.encode_frame`` of a frame batch
    (stream serving, and the iteration pool's stream and seeded
    admissions);
  * ``iterate`` ``(rung, h8, w8, iters)`` — pyramid, refinement and
    upsample from encoded frames, ``RAFT.iterate(emit_all=False)``.

Images come as host NHWC ``(rung, bh, bw, 3)`` tensors (the engine's
pinned staging buffers) and are copied into static NHWC buffers that the
model reads as NCHW views: the layout ``FlowEstimator`` gives its model,
so both run the same convolution kernels. The feature buffers of
``iterate`` take the layout of ``encode``'s outputs. The graphs of one
(rung, bucket) share their input buffers, and all graphs share one memory
pool: they replay one after another on the worker's stream. A graph's
outputs are overwritten by its next replay, so a caller copies out what
it keeps before dispatching that graph again. On the CPU each program runs
eagerly on the tensors it is given.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from raft_tpu_torch.graphs import GraphProgram, rows_like

__all__ = ["BatchPrograms"]

_FAMILIES = ("pairwise", "encode", "iterate")


class BatchPrograms:
    """``model``'s whole-request programs on ``device``; call everything
    under ``torch.inference_mode()``."""

    def __init__(self, model, device):
        self.model = model
        self.device = torch.device(device)
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self._programs: Dict[Tuple, GraphProgram] = {}
        self._buffers: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}

    # -- static inputs ---------------------------------------------------------

    def _images(self, role: str, rung: int, bucket: Tuple[int, int], n: int):
        """``n`` static image buffers of ``rung`` rows at ``bucket``: NHWC
        storage, each returned as its NCHW view."""
        key = (role, rung) + tuple(bucket)
        bufs = self._buffers.get(key)
        if bufs is None:
            shape = (rung,) + tuple(bucket) + (3,)
            bufs = self._buffers[key] = tuple(
                torch.zeros(shape, dtype=torch.float32, device=self.device).permute(0, 3, 1, 2) for _ in range(n)
            )
        return bufs

    @staticmethod
    def _fill(bufs, hosts) -> None:
        """Copy host NHWC batches into NCHW views of NHWC buffers (the
        storages have the same layout: one contiguous copy each)."""
        for buf, x in zip(bufs, hosts):
            buf.permute(0, 2, 3, 1).copy_(torch.as_tensor(x), non_blocking=True)

    def _program(self, key, fn) -> GraphProgram:
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = GraphProgram(fn, self.device, pool=self._pool, name=str(key))
        prog.capture()
        return prog

    # -- the programs ------------------------------------------------------------

    def capture_pairwise(self, rung: int, bucket: Tuple[int, int], iters: int) -> GraphProgram:
        """The ``pairwise`` program, captured now on the card."""
        x1, x2 = self._images("pair", rung, bucket, 2)
        return self._program(
            ("pairwise", rung) + tuple(bucket) + (int(iters),),
            lambda: self.model(x1, x2, num_flow_updates=int(iters), emit_all=False),
        )

    def run_pairwise(self, p1, p2, iters: int) -> torch.Tensor:
        """Flow ``(rung, 2, bh, bw)`` of host NHWC pair batches (the
        graph's output on the card, valid until its next replay)."""
        if self.device.type != "cuda":
            x1, x2 = (torch.as_tensor(p).to(self.device).permute(0, 3, 1, 2) for p in (p1, p2))
            return self.model(x1, x2, num_flow_updates=int(iters), emit_all=False)
        rung, bh, bw, _ = p1.shape
        prog = self.capture_pairwise(rung, (bh, bw), iters)
        self._fill(self._images("pair", rung, (bh, bw), 2), (p1, p2))
        return prog()

    def capture_encode(self, rung: int, bucket: Tuple[int, int]) -> GraphProgram:
        """The ``encode`` program, captured now on the card."""
        (x,) = self._images("frame", rung, bucket, 1)
        return self._program(("encode", rung) + tuple(bucket), lambda: self.model.encode_frame(x))

    def run_encode(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """(feature map, raw context output) of a host NHWC frame batch,
        both ``(rung, C, bh/8, bw/8)``."""
        if self.device.type != "cuda":
            return self.model.encode_frame(torch.as_tensor(frames).to(self.device).permute(0, 3, 1, 2))
        rung, bh, bw, _ = frames.shape
        prog = self.capture_encode(rung, (bh, bw))
        self._fill(self._images("frame", rung, (bh, bw), 1), (frames,))
        return prog()

    def _features(self, rung: int, bucket: Tuple[int, int]):
        """The static (fmap1, fmap2, context) buffers of ``iterate`` at
        ``rung``, laid out like ``encode``'s outputs."""
        key = ("features", rung) + tuple(bucket)
        bufs = self._buffers.get(key)
        if bufs is None:
            fmap, ctx = self.capture_encode(rung, bucket).outputs
            bufs = self._buffers[key] = (rows_like(fmap, rung), rows_like(fmap, rung), rows_like(ctx, rung))
        return bufs

    def capture_iterate(self, rung: int, bucket: Tuple[int, int], iters: int) -> GraphProgram:
        """The ``iterate`` program, captured now on the card."""
        f1, f2, cx = self._features(rung, bucket)
        return self._program(
            ("iterate", rung, bucket[0] // 8, bucket[1] // 8, int(iters)),
            lambda: self.model.iterate(f1, f2, cx, num_flow_updates=int(iters), emit_all=False),
        )

    def run_iterate(self, fmap1, fmap2, context_out, iters: int) -> torch.Tensor:
        """Flow ``(rung, 2, bh, bw)`` from device feature batches."""
        if self.device.type != "cuda":
            return self.model.iterate(fmap1, fmap2, context_out, num_flow_updates=int(iters), emit_all=False)
        rung, _, h8, w8 = fmap1.shape
        bucket = (8 * h8, 8 * w8)
        prog = self.capture_iterate(rung, bucket, iters)
        for buf, x in zip(self._features(rung, bucket), (fmap1, fmap2, context_out)):
            buf.copy_(x)
        return prog()

    # -- the captured set ---------------------------------------------------------

    def graphs(self) -> Dict[Tuple, GraphProgram]:
        """Every captured program, by key."""
        return {k: p for k, p in self._programs.items() if p.captured}

    def counts(self) -> Dict[str, int]:
        """Captured-program count per family (-1 on the CPU)."""
        if self.device.type != "cuda":
            return dict.fromkeys(_FAMILIES, -1)
        counts = dict.fromkeys(_FAMILIES, 0)
        for key in self.graphs():
            counts[key[0]] += 1
        return counts
