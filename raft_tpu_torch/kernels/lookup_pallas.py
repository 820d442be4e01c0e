"""Multi-scale correlation lookup in separable form as a hand-written CUDA
kernel for Hopper (K4), at the JAX package's ``lookup_pyramid_pallas``
entry point.

:func:`lookup_pyramid_pallas` wraps ``csrc/lookup_dense.cu``; it computes
the same taps as K2 (:func:`~raft_tpu_torch.kernels.lookup_xtap.lookup_pyramid_fused`),
in the order of the plain version: a y-pass against the level, then an
x-pass. No model path calls it: the JAX package keeps it as the readable
statement of the fused lookup and the A/B baseline of its lookup bench.
Its plain version is :func:`lookup_pyramid_reference` (``corr.lookup_pyramid``);
the wrapper takes it only for tensors on the CPU, launches the kernel or
raises for CUDA tensors, and counts its launches in
``lookup_pyramid_pallas.launches``. Inference-only, like K1/K2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from raft_tpu_torch.graphs import count_launch
from raft_tpu_torch.kernels import build
from raft_tpu_torch.kernels.lookup_xtap import _check_inputs, _check_no_grad
from raft_tpu_torch.models.corr import lookup_pyramid

__all__ = ["lookup_pyramid_pallas", "lookup_pyramid_reference"]

WARPS_PER_BLOCK = 8  # one (query, level) pair per warp


def lookup_pyramid_reference(
    pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int
) -> torch.Tensor:
    """Plain version of K4: ``(B, h, w, L*S*S)`` taps."""
    return lookup_pyramid(pyramid, centroids, radius)


def _smem_bytes(num_levels: int, radius: int) -> int:
    """A warp-private S x (S+2) y-pass tile per warp."""
    s = 2 * radius + 1
    return WARPS_PER_BLOCK * s * (s + 2) * 4


def _pyramid_args(pyramid):
    n = len(pyramid)
    levels = (ctypes.c_void_p * n)(*[v.data_ptr() for v in pyramid])
    heights = (ctypes.c_int * n)(*[v.shape[1] for v in pyramid])
    widths = (ctypes.c_int * n)(*[v.shape[2] for v in pyramid])
    return levels, heights, widths, n


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("lookup_dense")
    lib.lookup_dense_launch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.lookup_dense_launch.restype = ctypes.c_int
    return lib


def lookup_pyramid_pallas(
    pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int
) -> torch.Tensor:
    """K4: multi-scale (2r+1)^2 bilinear taps, ``(B, h, w, L*(2r+1)^2)``
    fp32, channels ordered level, then x-offset, then y-offset; taps
    outside a level are zero.

    Args:
        pyramid: ``(B*h*w, hl, wl)`` fp32 contiguous levels, any sizes.
        centroids: ``(B, h, w, 2)`` fp32 contiguous level-0 (x, y) centres.
    """
    who = "lookup_pyramid_pallas"
    pyramid = list(pyramid)
    _check_no_grad(who, pyramid, centroids)
    b, h, w, q = _check_inputs(who, pyramid, centroids, radius, smem_bytes=_smem_bytes)
    if pyramid[0].dtype != torch.float32:
        raise TypeError(f"{who}: levels must be float32, got {pyramid[0].dtype}")
    if centroids.device.type == "cpu":
        return lookup_pyramid_reference(pyramid, centroids, radius)
    s = 2 * radius + 1
    out = torch.empty((b, h, w, len(pyramid) * s * s), device=centroids.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(centroids.device):
        stream = torch.cuda.current_stream(centroids.device).cuda_stream
        rc = lib.lookup_dense_launch(
            *_pyramid_args(pyramid), centroids.data_ptr(), out.data_ptr(), q, radius, stream
        )
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError_t {rc}")
    count_launch(lookup_pyramid_pallas)
    return out


lookup_pyramid_pallas.launches = 0
