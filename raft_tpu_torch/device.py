"""Device resolution and numeric precision for the port's entry points.

Every entry point runs on the CUDA card unless the caller asks for the CPU
by name: a machine without a card raises instead of silently falling back,
so a CPU run can never be mistaken for a run on the card.

:func:`fp32_precision` pins what ``float32`` means while the port runs a
model: IEEE fp32 convolutions and matmuls, whatever TF32 flags the caller
has set globally (PyTorch lets cuDNN convolutions use TF32 by default).
:func:`cudnn_benchmark` is the block in which the port lets cuDNN choose
its convolution algorithms by timing them.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Union

import torch

__all__ = ["resolve_device", "fp32_precision", "cudnn_benchmark"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``'cuda'``; a CUDA device must exist, a CPU device is
    taken only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


# fp32_precision's state: how many blocks are open, in any thread, and the
# settings they found when the first of them opened
_lock = threading.Lock()
_depth = 0
_saved: tuple = ()


def _knobs() -> tuple:
    """The per-operator ``fp32_precision`` settings of cuDNN convolutions
    and cuBLAS matmuls."""
    return torch.backends.cudnn.conv, torch.backends.cuda.matmul


@contextlib.contextmanager
def fp32_precision() -> Iterator[None]:
    """IEEE fp32 convolutions and matmuls while any such block is open, in
    any thread; the settings found by the first block come back when the
    last one closes.

    It reads and writes only the per-operator ``fp32_precision`` API
    (PyTorch >= 2.9): reading the legacy ``allow_tf32`` flags raises once a
    caller has used the new API, while the new API reads either kind of
    setting and restoring its values restores the legacy view too. The
    settings are process-global, so the blocks of all threads share one
    count under a lock: a thread that closes its block while another still
    runs leaves the pin in place. Harmless on the CPU, where no setting is
    read.
    """
    global _depth, _saved
    with _lock:
        if _depth == 0:
            _saved = tuple(k.fp32_precision for k in _knobs())
            for k in _knobs():
                k.fp32_precision = "ieee"
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                for k, value in zip(_knobs(), _saved):
                    k.fp32_precision = value


@contextlib.contextmanager
def cudnn_benchmark() -> Iterator[None]:
    """``torch.backends.cudnn.benchmark`` on while the block is open; the
    caller's setting comes back after it. The CUDA-graph warm-up
    (``graphs.GraphProgram``, whose module says why) and the train step
    (``train.step``) run in it.
    """
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved
