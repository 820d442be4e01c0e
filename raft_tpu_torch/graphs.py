"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package compiles each entry point once per input shape and replays
the compiled program; the port captures the same work once as a CUDA graph
(``torch.cuda.CUDAGraph``) and replays it, so a request costs one graph
launch instead of the ~2000-4000 kernel launches its Python loop would
launch one by one.

A :class:`GraphProgram` wraps a function of no arguments that reads its
inputs from tensors it closes over: *static buffers*, which the caller
fills before each call. The first call on the card warms the function up
eagerly on a side stream (kernel builds, cuDNN and cuBLAS plans, allocator
growth), then captures it; every call replays the graph and returns the
same output tensors, overwritten. On the CPU the function runs eagerly:
there are no graphs there.

A capture that fails raises: nothing falls back to eager execution on the
card. Only one capture may be under way in a process (a CUDA rule), so
captures take one process-wide lock; they use the ``thread_local`` capture
mode, in which other threads' work (an engine worker's replays) goes on.

The warm-up runs with ``torch.backends.cudnn.benchmark`` on: cuDNN times
its candidate algorithms for each convolution shape it has not yet seen
and keeps the fastest, and the capture records that choice. (Its
heuristic sends two fp32 3x3 convolutions of raft_large's update block to
FFT tiling at batch 8, 25-333 ms a call on an H100 against 1.0-1.5 ms
timed.) PyTorch keeps that choice per thread, keyed by shape, precision
and layout but not by the flag, and the first call at a shape fixes it:
on the capturing thread an eager call at a captured shape runs the
graph's algorithm and the two agree bit for bit; another thread may
choose otherwise and round differently.

Launch counts: a kernel wrapper counts a launch where it launches its
kernel (:func:`count_launch`). While a stream is being captured it
launches nothing; the call is recorded for the capture under way instead,
and a program keeps how many launches of each kernel its graph holds
(:attr:`GraphProgram.launches`), so ``replays x launches`` is what its
replays launched.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch

from raft_tpu_torch.device import cudnn_benchmark

__all__ = ["GraphProgram", "capture_events", "count_launch", "replayed_launches", "rows_like"]

# captures are process-wide state in CUDA: one at a time, and one count
_capture_lock = threading.Lock()
_captures = 0
# the warm-up stream, one a device: cuBLAS keeps a workspace for each
# (handle, stream) it has run on for the process's life, so a fresh stream
# a capture would leave one behind for every program ever captured
_warmup_streams: Dict[torch.device, torch.cuda.Stream] = {}
# the launches recorded by the capture under way on this thread
_recording = threading.local()
# kernel launches by every replay in this process, by wrapper name
_replayed: Dict[str, int] = {}
_replayed_lock = threading.Lock()


def capture_events() -> int:
    """Monotonic count of CUDA-graph captures in this process (the
    counterpart of the JAX package's ``aot.compile_events()``): sample it
    before and after a window; a zero delta proves nothing was captured
    inside it."""
    with _capture_lock:
        return _captures


def replayed_launches() -> Dict[str, int]:
    """Kernel launches made by every graph replay in this process so far,
    by kernel wrapper's name: sampled before and after a window, the
    launches its replays made, whatever programs and engines came and went
    inside it."""
    with _replayed_lock:
        return dict(_replayed)


def count_launch(wrapper) -> None:
    """A kernel wrapper's count of one launch on the current CUDA stream:
    its ``launches`` attribute when the kernel runs; while the stream is
    being captured, the capture's own record, by the wrapper's name (the
    graph's replays launch it)."""
    if torch.cuda.is_current_stream_capturing():
        record = getattr(_recording, "launches", None)
        if record is not None:
            record[wrapper.__name__] = record.get(wrapper.__name__, 0) + 1
    else:
        wrapper.launches += 1


def rows_like(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zeros of ``n`` rows shaped, typed and laid out (channels-last or
    not) like the rows of the 4-d ``t``: static buffers that take an
    encoder's outputs keep their layout, so a graph and an eager call see
    the same strides."""
    last = not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last)
    fmt = torch.channels_last if last else torch.contiguous_format
    return torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device, memory_format=fmt).zero_()


class GraphProgram:
    """``fn`` captured once as a CUDA graph on ``device`` and replayed.

    Args:
        fn: a function of no arguments; its inputs are static buffers it
            closes over, its result any tensors (or containers of them).
            Dropped once captured.
        device: where it runs; on the CPU ``fn`` runs eagerly every call.
        pool: a ``torch.cuda.graph_pool_handle()`` shared by the programs
            of one owner (their graphs never run concurrently).
        name: for error messages.
    """

    def __init__(self, fn: Callable, device: torch.device, *, pool=None, name: str = "program"):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.launches: Dict[str, int] = {}  # kernel wrapper's name -> launches per replay
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def capture(self) -> None:
        """Warm ``fn`` up eagerly, then capture it. No-op on the CPU or
        when already captured; raises when the capture fails."""
        global _captures
        if self.device.type != "cuda" or self.graph is not None:
            return
        with _capture_lock, torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            side = _warmup_streams.get(self.device)
            if side is None:
                side = _warmup_streams[self.device] = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with cudnn_benchmark(), torch.cuda.stream(side):
                self.fn()
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            _recording.launches = launches = {}
            try:
                with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                    outputs = self.fn()
            except Exception as e:
                raise RuntimeError(f"capturing {self.name} as a CUDA graph failed: {e!r}") from e
            finally:
                _recording.launches = None
            self.graph, self.outputs, self.launches = graph, outputs, launches
            # the graph needs no Python object to replay; the function's
            # closure (often over the program's owner, which holds this
            # program) would tie the graph's memory into a reference cycle
            # that only a garbage collection frees
            self.fn = None
            _captures += 1

    def __call__(self):
        """Run once: replay on the card (capturing first if needed), call
        ``fn`` on the CPU. Returns the outputs."""
        if self.device.type != "cuda":
            return self.fn()
        if self.graph is None:
            self.capture()
        self.graph.replay()
        self.replays += 1
        with _replayed_lock:
            for k, n in self.launches.items():
                _replayed[k] = _replayed.get(k, 0) + n
        return self.outputs

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches its replays made so far, by kernel wrapper's name."""
        return {k: n * self.replays for k, n in self.launches.items()}
