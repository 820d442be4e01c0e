"""All-pairs correlation volume + pooled pyramid as one hand-written CUDA
kernel for Hopper (K3), and the ``corr_impl='pallas'`` correlation block.

:func:`fused_volume_pyramid` wraps ``csrc/corr_pyramid.cu``: the fp32
volume ``f1 . f2^T / sqrt(C)`` of each batch element (on the tensor cores,
each operand split into two TF32 halves so the product keeps fp32
accuracy) and its L-1 VALID 2x2 average pools, every level written once,
the level-0 volume never read back. Beside it sits its plain version,
:func:`volume_pyramid_reference`
(``correlation_volume`` + ``pool_pyramid``), which the CPU tests use and
the card smoke test holds the kernel against. The wrapper takes its plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises, at every width (no fallback). It counts its launches in
``fused_volume_pyramid.launches``.

``out_dtype=torch.bfloat16`` is the JAX kernel's ``out_dtype``: the volume
still accumulates and pools in fp32, and each level is rounded to bf16
(round to nearest even) where it is stored, so level l is ``bf16(fp32 level
l)``. The dense block's bf16 pyramid (``CorrBlock(dtype=bf16)``) casts the
volume before pooling instead; both forms are kept, as in the JAX package.

The kernel is inference-only, as the JAX package's is (``pallas_call`` has
no autodiff rule): a call with grad enabled on inputs that require grad
raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List

import torch

from raft_tpu_torch.graphs import count_launch
from raft_tpu_torch.kernels import build
from raft_tpu_torch.models.corr import CorrBlock, correlation_volume, pool_pyramid

__all__ = [
    "MAX_LEVELS",
    "PallasCorrBlock",
    "fused_volume_pyramid",
    "level_dims",
    "volume_pyramid_reference",
]

MAX_LEVELS = 6  # the kernel's 2^(L-1)-row key band fits a block up to here


def level_dims(h: int, w: int, num_levels: int) -> List[tuple]:
    """``(h_l, w_l)`` of each level: halved with the odd tail dropped."""
    dims = [(h, w)]
    for _ in range(num_levels - 1):
        h, w = h // 2, w // 2
        dims.append((h, w))
    return dims


def volume_pyramid_reference(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int, out_dtype=torch.float32
) -> List[torch.Tensor]:
    """Plain version of K3: ``num_levels`` levels of ``(B*h*w, hl, wl)``,
    pooled in fp32 and stored as ``out_dtype``."""
    levels = pool_pyramid(correlation_volume(fmap1, fmap2), num_levels)
    return [lvl.to(out_dtype) for lvl in levels]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("corr_pyramid")
    lib.corr_pyramid_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.corr_pyramid_launch.restype = ctypes.c_int
    return lib


def fused_volume_pyramid(
    fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4, out_dtype=torch.float32
) -> List[torch.Tensor]:
    """K3: the correlation pyramid of two NCHW feature maps in one kernel.

    Args:
        fmap1, fmap2: ``(B, C, h, w)`` fp32 contiguous, on one device.
        num_levels: 1..:data:`MAX_LEVELS`; every level must keep >= 1 px.
        out_dtype: ``torch.float32`` or ``torch.bfloat16`` storage.
    Returns:
        ``num_levels`` levels of ``(B*h*w, hl, wl)`` in ``out_dtype``.
    """
    who = "fused_volume_pyramid"
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{who}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if torch.is_grad_enabled() and (fmap1.requires_grad or fmap2.requires_grad):
        raise RuntimeError(
            f"{who} is inference-only: its inputs require grad. Run under "
            "torch.no_grad()/torch.inference_mode(), or use corr_impl='dense' to train"
        )
    if fmap1.dim() != 4 or fmap1.shape != fmap2.shape:
        raise ValueError(
            f"{who}: needs two (B, C, h, w) maps of one shape, got "
            f"{tuple(fmap1.shape)} and {tuple(fmap2.shape)}"
        )
    if not 1 <= num_levels <= MAX_LEVELS:
        raise ValueError(f"{who}: needs 1..{MAX_LEVELS} levels, got {num_levels}")
    b, c, h, w = fmap1.shape
    dims = level_dims(h, w, num_levels)
    if min(min(d) for d in dims) < 1 or c < 1 or b < 1:
        raise ValueError(f"{who}: a {num_levels}-level pyramid of a {h}x{w} grid has an empty level")
    for name, t in (("fmap1", fmap1), ("fmap2", fmap2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if fmap1.device != fmap2.device or fmap1.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: maps on {fmap1.device} and {fmap2.device}")
    if fmap1.device.type == "cpu":
        return volume_pyramid_reference(fmap1, fmap2, num_levels, out_dtype)
    q = h * w
    outs = [torch.empty((b * q, hl, wl), device=fmap1.device, dtype=out_dtype) for hl, wl in dims]
    ptrs = (ctypes.c_void_p * num_levels)(*[o.data_ptr() for o in outs])
    lib = _lib()
    with torch.cuda.device(fmap1.device):
        stream = torch.cuda.current_stream(fmap1.device).cuda_stream
        rc = lib.corr_pyramid_launch(
            fmap1.data_ptr(), fmap2.data_ptr(), ptrs, b, c, h, w, num_levels,
            1.0 / math.sqrt(c), int(out_dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError_t {rc}")
    count_launch(fused_volume_pyramid)
    return outs


fused_volume_pyramid.launches = 0


class PallasCorrBlock(CorrBlock):
    """Dense correlation block whose pyramid build runs in K3
    (``corr_impl='pallas'``), storing its levels in ``dtype`` (``None``:
    fp32). Lookup and projection stay the plain separable matmuls of
    :class:`CorrBlock` (bf16 weights and rows at bf16), as in the JAX
    package, where the lookup runs in XLA outside any kernel. bf16 feature
    maps (bf16 convs) are widened to fp32 exactly; their products stay
    exact in the kernel's fp32 accumulation, as in the JAX kernel's."""

    def build_pyramid(self, fmap1: torch.Tensor, fmap2: torch.Tensor) -> List[torch.Tensor]:
        self.check_fmaps(fmap1, fmap2)
        return fused_volume_pyramid(
            fmap1.float().contiguous(), fmap2.float().contiguous(), self.num_levels,
            self.dtype or torch.float32,
        )
