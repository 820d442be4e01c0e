"""Multi-scale correlation lookup (+ fused ``convcorr1`` projection) as a
hand-written CUDA kernel for Hopper, and the correlation block that uses it.

Two wrappers over ``csrc/lookup_xtap.cu``:

  * :func:`lookup_project_fused` (K1): ``relu(taps @ W^T + b)`` written
    NCHW, the lookup + projection of every refinement step
    (``corr_impl='fused'``); the tap tensor never reaches device memory.
  * :func:`lookup_pyramid_fused` (K2): the taps themselves,
    ``(B, h, w, L*S*S)`` in the reference channel order.

Beside them sit their plain versions, :func:`lookup_project_reference` and
:func:`lookup_pyramid_reference`, which the CPU tests use and the card
smoke test holds the kernels against. A wrapper takes its plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. Each wrapper counts its launches in a plain integer attribute
(``lookup_project_fused.launches``), so a run can show that the main path
went through the kernel.

The kernels are inference-only for now: a call with grad enabled on inputs
that require grad raises (training comes with an ``autograd.Function`` in a
later slice, as the JAX package pairs its kernel with the XLA backward).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from raft_tpu_torch.kernels import build
from raft_tpu_torch.models.corr import CorrBlock, lookup_pyramid, project_taps

__all__ = [
    "FusedLookupCorrBlock",
    "MAX_LEVELS",
    "lookup_project_fused",
    "lookup_project_reference",
    "lookup_pyramid_fused",
    "lookup_pyramid_reference",
]

MAX_LEVELS = 8  # the kernel's pyramid descriptor holds at most this many levels
QUERY_TILE = 32  # queries per thread block
MAX_SMEM_BYTES = 232448  # shared memory one block may use on sm_90


def lookup_pyramid_reference(
    pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int
) -> torch.Tensor:
    """Plain version of K2: ``(B, h, w, L*S*S)`` taps."""
    return lookup_pyramid(pyramid, centroids, radius)


def lookup_project_reference(
    pyramid: Sequence[torch.Tensor],
    centroids: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """Plain version of K1: ``(B, C_out, h, w)`` projected features."""
    taps = lookup_pyramid(pyramid, centroids, radius)
    return project_taps(taps, weight, bias).permute(0, 3, 1, 2)


def _tile_smem_bytes(num_levels: int, radius: int) -> int:
    """K1/K2: a tile's taps, rows padded to a multiple of 4 floats."""
    s = 2 * radius + 1
    return QUERY_TILE * (-(-num_levels * s * s // 4) * 4) * 4


def _check_no_grad(who: str, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{who} is inference-only: its inputs require grad. Run under "
            "torch.no_grad()/torch.inference_mode(), or use corr_impl='dense' "
            "to train (the kernel's autograd.Function is not ported yet)"
        )


def _check_inputs(who: str, pyramid, centroids: torch.Tensor, radius: int, extra=(), smem_bytes=None):
    """Validate the shared arguments; returns (b, h, w, q).

    ``smem_bytes(num_levels, radius)`` is the kernel's dynamic shared
    memory per block (default: K1/K2's tap tile)."""
    if centroids.dim() != 4 or centroids.shape[-1] != 2:
        raise ValueError(f"{who}: centroids must be (B, h, w, 2), got {tuple(centroids.shape)}")
    b, h, w, _ = centroids.shape
    q = b * h * w
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"{who}: needs 1..{MAX_LEVELS} pyramid levels, got {len(pyramid)}")
    if radius < 0:
        raise ValueError(f"{who}: radius must be >= 0, got {radius}")
    if (smem_bytes or _tile_smem_bytes)(len(pyramid), radius) > MAX_SMEM_BYTES:
        raise ValueError(
            f"{who}: {len(pyramid)} levels at radius {radius} need more shared "
            "memory per block than a block has"
        )
    for level, vol in enumerate(pyramid):
        if vol.dim() != 3 or vol.shape[0] != q or vol.shape[1] < 1 or vol.shape[2] < 1:
            raise ValueError(
                f"{who}: level {level} must be (B*h*w={q}, hl, wl), got {tuple(vol.shape)}"
            )
    for name, t in [("centroids", centroids)] + [(f"level {i}", v) for i, v in enumerate(pyramid)] + list(extra):
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
        if t.device != centroids.device:
            raise ValueError(f"{who}: {name} is on {t.device}, centroids on {centroids.device}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if centroids.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {centroids.device}")
    return b, h, w, q


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its launchers' C signatures declared."""
    lib = build.load("lookup_xtap")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    levels_t = ctypes.POINTER(ctypes.c_void_p)
    dims_t = ctypes.POINTER(ctypes.c_int)
    lib.xtap_project_launch.argtypes = [
        levels_t, dims_t, dims_t, i32, ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr,
    ]
    lib.xtap_project_launch.restype = i32
    lib.xtap_lookup_launch.argtypes = [levels_t, dims_t, dims_t, i32, ptr, ptr, i64, i32, ptr]
    lib.xtap_lookup_launch.restype = i32
    return lib


def _pyramid_args(pyramid):
    n = len(pyramid)
    levels = (ctypes.c_void_p * n)(*[v.data_ptr() for v in pyramid])
    heights = (ctypes.c_int * n)(*[v.shape[1] for v in pyramid])
    widths = (ctypes.c_int * n)(*[v.shape[2] for v in pyramid])
    return levels, heights, widths, n


def _raise_on(who: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError_t {rc}")


def lookup_pyramid_fused(
    pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int
) -> torch.Tensor:
    """K2: multi-scale (2r+1)^2 bilinear taps, ``(B, h, w, L*(2r+1)^2)``.

    Args:
        pyramid: ``(B*h*w, hl, wl)`` fp32 contiguous levels, any sizes.
        centroids: ``(B, h, w, 2)`` fp32 contiguous level-0 (x, y) centres.
    """
    who = "lookup_pyramid_fused"
    _check_no_grad(who, centroids, *pyramid)
    b, h, w, q = _check_inputs(who, pyramid, centroids, radius)
    if centroids.device.type == "cpu":
        return lookup_pyramid_reference(pyramid, centroids, radius)
    s = 2 * radius + 1
    out = torch.empty((b, h, w, len(pyramid) * s * s), device=centroids.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(centroids.device):
        stream = torch.cuda.current_stream(centroids.device).cuda_stream
        rc = lib.xtap_lookup_launch(
            *_pyramid_args(pyramid), centroids.data_ptr(), out.data_ptr(), q, radius, stream
        )
    _raise_on(who, rc)
    lookup_pyramid_fused.launches += 1
    return out


lookup_pyramid_fused.launches = 0


def lookup_project_fused(
    pyramid: Sequence[torch.Tensor],
    centroids: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    radius: int,
) -> torch.Tensor:
    """K1: lookup + ``convcorr1`` in one kernel, ``(B, C_out, h, w)``.

    Args:
        pyramid, centroids: as :func:`lookup_pyramid_fused`.
        weight: the conv weight ``(C_out, L*S*S[, 1, 1])``, rows in the
            reference tap order ``l*S*S + i*S + j``.
        bias: ``(C_out,)``.
    """
    who = "lookup_project_fused"
    _check_no_grad(who, centroids, weight, bias, *pyramid)
    s = 2 * radius + 1
    c_in = len(pyramid) * s * s
    if weight.shape[0] < 1 or weight[0].numel() != c_in or weight.dim() not in (2, 4):
        raise ValueError(f"{who}: weight must be (C_out, {c_in}[, 1, 1]), got {tuple(weight.shape)}")
    c_out = weight.shape[0]
    if tuple(bias.shape) != (c_out,):
        raise ValueError(f"{who}: bias must be ({c_out},), got {tuple(bias.shape)}")
    b, h, w, q = _check_inputs(
        who, pyramid, centroids, radius, extra=[("weight", weight), ("bias", bias)]
    )
    if centroids.device.type == "cpu":
        return lookup_project_reference(pyramid, centroids, weight, bias, radius)
    out = torch.empty((b, c_out, h, w), device=centroids.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(centroids.device):
        stream = torch.cuda.current_stream(centroids.device).cuda_stream
        rc = lib.xtap_project_launch(
            *_pyramid_args(pyramid), centroids.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), q, h * w, radius, c_out, stream,
        )
    _raise_on(who, rc)
    lookup_project_fused.launches += 1
    return out


lookup_project_fused.launches = 0


class FusedLookupCorrBlock(CorrBlock):
    """Dense correlation block whose per-step lookup (and the motion
    encoder's ``convcorr1`` projection, via ``index_project``) runs in the
    CUDA kernel (``corr_impl='fused'``).

    The pyramid is the plain list of pooled levels of :class:`CorrBlock`;
    every level size is taken. Numerics equal :class:`CorrBlock`'s up to
    fp32 summation order.
    """

    def index_pyramid(self, pyramid: Sequence[torch.Tensor], centroids: torch.Tensor) -> torch.Tensor:
        return lookup_pyramid_fused(list(pyramid), centroids.contiguous(), self.radius)

    def index_project(
        self,
        pyramid: Sequence[torch.Tensor],
        centroids: torch.Tensor,
        weight: torch.Tensor,
        bias: torch.Tensor,
    ) -> torch.Tensor:
        return lookup_project_fused(list(pyramid), centroids.contiguous(), weight, bias, self.radius)
