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

Levels may be stored as fp32, bf16, or int8 with one fp32 dequantization
factor per level (a :class:`~raft_tpu_torch.models.corr.QuantizedPyramid`,
built by :meth:`FusedLookupCorrBlock.build_pyramid` at ``dtype=int8``). The
reduced-precision forms compute what the JAX kernels compute with
``ydot_in_kernel=True`` (``raft_tpu/kernels/lookup_xtap.py``): level 0 and
the larger levels contract y first, into bf16 rows (bf16 levels) or exact
integer rows from int8 y-weights (int8 levels); the small levels
(:func:`flat_levels`, the JAX ``_split_levels`` rule) take the 4-corner
bilinear sum with fp32 weights. K2 then returns bf16 taps; K1's product
runs at ``proj_dtype`` (fp32: 3xTF32; bf16: taps and weight rounded to
bf16, fp32 sums, fp32 bias) and returns that dtype.

The kernels are inference-only for now: a call with grad enabled on inputs
that require grad raises (training comes with an ``autograd.Function`` in a
later slice, as the JAX package pairs its kernel with the XLA backward).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from raft_tpu_torch.graphs import count_launch
from raft_tpu_torch.kernels import build
from raft_tpu_torch.models.corr import (
    CorrBlock,
    QuantizedPyramid,
    lookup_pyramid,
    project_taps,
    separable_taps,
    _bilinear_weights,
)

__all__ = [
    "FusedLookupCorrBlock",
    "MAX_LEVELS",
    "flat_levels",
    "lookup_project_fused",
    "lookup_project_reference",
    "lookup_pyramid_fused",
    "lookup_pyramid_reference",
    "quantize_pyramid",
]

MAX_LEVELS = 8  # the kernel's pyramid descriptor holds at most this many levels
QUERY_TILE = 32  # K2: queries per thread block
MAX_SMEM_BYTES = 232448  # shared memory one block may use on sm_90
# K1's block tile (csrc/lookup_xtap.cu): queries x channels, weight slices
# of PROJECT_KC columns in a ring of PROJECT_STAGES
PROJECT_BM, PROJECT_BN, PROJECT_KC, PROJECT_STAGES = 32, 256, 16, 3


MAX_LANES = 128  # the JAX kernel's lane row: its level split counts rows of it
# level storage and tap forms, as csrc/lookup_xtap.cu numbers them
_ELEM = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
KIND_FLAT, KIND_YDOT_BF16, KIND_YDOT_INT8 = 0, 1, 2


def flat_levels(pyramid: Sequence[torch.Tensor], radius: int) -> tuple:
    """Which levels take the 4-corner path: the JAX kernel's
    ``_split_levels``/``_flat_max_rows`` (``raft_tpu/kernels/lookup_xtap.py``).
    A level after the first is flat when its ``hl * wl`` values, in rows of
    128 (levels wider than 128 counted at their 128-padded width, as the JAX
    block pads them), fill at most 4 rows at S >= 9 or 16 rows below; with
    ``S * (S + 1) > 128`` no level is. Returns one bool per level."""
    s = 2 * radius + 1
    max_rows = -1 if s * (s + 1) > MAX_LANES else (4 if s >= 9 else 16)
    out = []
    for level, vol in enumerate(pyramid):
        hl, wl = vol.shape[-2], vol.shape[-1]
        if wl > MAX_LANES:
            wl = -(-wl // MAX_LANES) * MAX_LANES
        rows = -(-(hl * wl) // MAX_LANES)
        out.append(level > 0 and rows <= max_rows)
    return tuple(out)


def _level_kinds(pyramid, radius: int) -> tuple:
    """The kernel's tap form of each level (``KIND_*``)."""
    ydot = {torch.bfloat16: KIND_YDOT_BF16, torch.int8: KIND_YDOT_INT8}.get(pyramid[0].dtype, KIND_FLAT)
    return tuple(KIND_FLAT if flat else ydot for flat in flat_levels(pyramid, radius))


def _scales_of(pyramid) -> Optional[torch.Tensor]:
    return pyramid.scales if isinstance(pyramid, QuantizedPyramid) else None


def quantize_pyramid(levels: Sequence[torch.Tensor]) -> QuantizedPyramid:
    """Symmetric int8 levels, one factor per level (the JAX
    ``FusedLookupCorrBlock.build_pyramid`` at ``dtype=int8``): the factor
    is ``max(amax, 1e-12) / 127`` with ``amax`` over the whole level, batch
    included; values are rounded half to even, clipped to +-127."""
    qlevels, scales = [], []
    for v in levels:
        v = v.float()
        sc = torch.clamp(v.abs().max(), min=1e-12) * (1.0 / 127.0)
        q = torch.clamp(torch.round(v * (1.0 / sc)), -127, 127)
        qlevels.append(q.to(torch.int8))
        scales.append(sc)
    return QuantizedPyramid(qlevels, torch.stack(scales).float())


def _xtap_taps_reference(pyramid, centroids: torch.Tensor, radius: int) -> torch.Tensor:
    """The reduced-precision kernels' taps, fp32 ``(B, h, w, L*S*S)``, from
    bf16 or int8 levels (see the module note)."""
    b, h, w, _ = centroids.shape
    q = b * h * w
    s = 2 * radius + 1
    cent = centroids.reshape(q, 2).float()
    scales = _scales_of(pyramid)
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=cent.device)
    features = []
    for level, (vol, flat) in enumerate(zip(pyramid, flat_levels(pyramid, radius))):
        vol = vol.reshape(q, vol.shape[-2], vol.shape[-1])
        cx = cent[:, 0] / (2.0**level)
        cy = cent[:, 1] / (2.0**level)
        if flat:
            # fp32 bilinear weights on the widened values
            taps = separable_taps(vol.float(), cx, cy, radius)
            if scales is not None:
                taps = taps * scales[level]
        else:
            wy = _bilinear_weights(cy.unsqueeze(-1) + r, vol.shape[-2])  # (q, S_j, hl)
            if scales is None:  # bf16 rows from bf16 weights, fp32 sums
                rows = torch.matmul(wy.to(torch.bfloat16).float(), vol.float()).to(torch.bfloat16).float()
            else:  # exact integer rows from round(127 wy), then scale / 127
                rows = torch.matmul(torch.round(wy * 127.0), vol.float()) * (scales[level] * (1.0 / 127.0))
            wx = _bilinear_weights(cx.unsqueeze(-1) + r, vol.shape[-1])  # (q, S_i, wl)
            taps = torch.matmul(wx, rows.transpose(-1, -2))  # (q, S_i, S_j)
        features.append(taps.reshape(b, h, w, s * s))
    return torch.cat(features, dim=-1)


def _is_fp32(pyramid) -> bool:
    return pyramid[0].dtype == torch.float32


def lookup_pyramid_reference(pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain version of K2: ``(B, h, w, L*S*S)`` taps, fp32 for fp32
    levels, bf16 for bf16 and int8 levels."""
    if _is_fp32(pyramid):
        return lookup_pyramid(pyramid, centroids, radius)
    return _xtap_taps_reference(pyramid, centroids, radius).to(torch.bfloat16)


def lookup_project_reference(
    pyramid: Sequence[torch.Tensor],
    centroids: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    radius: int,
    proj_dtype=None,
) -> torch.Tensor:
    """Plain version of K1: ``(B, C_out, h, w)`` projected features at
    ``proj_dtype`` (``None``: fp32; bf16: taps and weight rounded to bf16,
    fp32 sums and bias, relu, then rounded to bf16)."""
    taps = lookup_pyramid(pyramid, centroids, radius) if _is_fp32(pyramid) else (
        _xtap_taps_reference(pyramid, centroids, radius))
    if proj_dtype is None or proj_dtype == torch.float32:
        return project_taps(taps, weight, bias).permute(0, 3, 1, 2)
    if proj_dtype != torch.bfloat16:
        raise ValueError(f"proj_dtype must be None, float32 or bfloat16, got {proj_dtype}")
    w = weight.reshape(weight.shape[0], -1).to(torch.bfloat16).float()
    y = torch.matmul(taps.to(torch.bfloat16).float(), w.t()) + bias.float()
    return torch.relu(y).to(torch.bfloat16).permute(0, 3, 1, 2)


def _tile_smem_bytes(num_levels: int, radius: int) -> int:
    """K2: a tile's taps, rows padded to a multiple of 4 floats."""
    s = 2 * radius + 1
    return QUERY_TILE * (-(-num_levels * s * s // 4) * 4) * 4


def _project_k_pad(c_in: int) -> int:
    """K1: the product's depth, C_in rounded up to the m16n8k8 step of 8
    (zero columns in shared memory only)."""
    return -(-c_in // 8) * 8


def _project_smem_bytes(num_levels: int, radius: int) -> int:
    """K1: the A tile (rows of K padded + 4 floats, 4 mod 8), a region that
    holds the weight ring, the epilogue tile and at least one level's
    (S+1)^2 windows, and a 16-byte table entry per (query, level) window;
    ``project_smem`` in the source."""
    s1 = 2 * radius + 2
    lda = _project_k_pad(num_levels * (s1 - 1) ** 2) + 4
    ring = PROJECT_STAGES * PROJECT_BN * (PROJECT_KC + 4)
    tile = PROJECT_BN * (PROJECT_BM + 4)  # the epilogue's channel-major tile
    region = max(ring, tile, PROJECT_BM * s1 * s1)
    return 4 * (PROJECT_BM * lda + region + 4 * PROJECT_BM * MAX_LEVELS)


def _check_no_grad(who: str, pyramid, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*pyramid, *tensors)):
        if isinstance(pyramid, QuantizedPyramid):
            raise RuntimeError(
                f"{who}: corr_dtype='int8' is inference-only (the quantized lookup "
                "defines no gradient), and an input requires grad. Run under "
                "torch.no_grad()/torch.inference_mode(), or train with corr_dtype "
                "'float32' or 'bfloat16' at corr_impl='dense'"
            )
        raise RuntimeError(
            f"{who} is inference-only: its inputs require grad. Run under "
            "torch.no_grad()/torch.inference_mode(), or use corr_impl='dense' "
            "to train (the kernel's autograd.Function is not ported yet)"
        )


def _check_inputs(who: str, pyramid, centroids: torch.Tensor, radius: int, extra=(), smem_bytes=None):
    """Validate the shared arguments; returns (b, h, w, q).

    Levels share one dtype, fp32, bf16 or int8; int8 levels come as a
    :class:`QuantizedPyramid` with ``(L,)`` fp32 scales. Everything else is
    fp32. ``smem_bytes(num_levels, radius)`` is the kernel's dynamic shared
    memory per block (default: K2's tap tile)."""
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
    dtype = pyramid[0].dtype
    if dtype not in _ELEM or any(v.dtype != dtype for v in pyramid):
        raise TypeError(f"{who}: levels must share one dtype of float32, bfloat16 or int8, got "
                        f"{[v.dtype for v in pyramid]}")
    scales = _scales_of(pyramid)
    if (dtype == torch.int8) != (scales is not None):
        raise TypeError(f"{who}: int8 levels, and only they, come as a QuantizedPyramid with scales")
    fp32 = [("centroids", centroids)] + list(extra)
    if scales is not None:
        if tuple(scales.shape) != (len(pyramid),):
            raise ValueError(f"{who}: scales must be ({len(pyramid)},), got {tuple(scales.shape)}")
        fp32.append(("scales", scales))
    for name, t in fp32:
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: {name} must be float32, got {t.dtype}")
    for name, t in fp32 + [(f"level {i}", v) for i, v in enumerate(pyramid)]:
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
    ints_t = ctypes.POINTER(ctypes.c_int)
    pyramid_t = [levels_t, ints_t, ints_t, ints_t, i32, i32, ptr]
    lib.xtap_project_launch.argtypes = pyramid_t + [ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr]
    lib.xtap_project_launch.restype = i32
    lib.xtap_lookup_launch.argtypes = pyramid_t + [ptr, ptr, i64, i32, ptr]
    lib.xtap_lookup_launch.restype = i32
    return lib


def _pyramid_args(pyramid, radius: int):
    """The launchers' pyramid arguments: level pointers, heights, widths,
    tap forms, level count, storage code and the scales pointer (or 0)."""
    n = len(pyramid)
    levels = (ctypes.c_void_p * n)(*[v.data_ptr() for v in pyramid])
    heights = (ctypes.c_int * n)(*[v.shape[1] for v in pyramid])
    widths = (ctypes.c_int * n)(*[v.shape[2] for v in pyramid])
    kinds = (ctypes.c_int * n)(*_level_kinds(pyramid, radius))
    scales = _scales_of(pyramid)
    return levels, heights, widths, kinds, n, _ELEM[pyramid[0].dtype], (
        scales.data_ptr() if scales is not None else None)


def _raise_on(who: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with cudaError_t {rc}")


def lookup_pyramid_fused(pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int) -> torch.Tensor:
    """K2: multi-scale (2r+1)^2 bilinear taps, ``(B, h, w, L*(2r+1)^2)``,
    fp32 for fp32 levels, bf16 for bf16 and int8 levels.

    Args:
        pyramid: ``(B*h*w, hl, wl)`` contiguous levels, any sizes: fp32,
            bf16, or a :class:`QuantizedPyramid` of int8 levels.
        centroids: ``(B, h, w, 2)`` fp32 contiguous level-0 (x, y) centres.
    """
    who = "lookup_pyramid_fused"
    _check_no_grad(who, pyramid, centroids)
    b, h, w, q = _check_inputs(who, pyramid, centroids, radius)
    if centroids.device.type == "cpu":
        return lookup_pyramid_reference(pyramid, centroids, radius)
    s = 2 * radius + 1
    out_dtype = torch.float32 if _is_fp32(pyramid) else torch.bfloat16
    out = torch.empty((b, h, w, len(pyramid) * s * s), device=centroids.device, dtype=out_dtype)
    lib = _lib()
    with torch.cuda.device(centroids.device):
        stream = torch.cuda.current_stream(centroids.device).cuda_stream
        rc = lib.xtap_lookup_launch(
            *_pyramid_args(pyramid, radius), centroids.data_ptr(), out.data_ptr(), q, radius, stream
        )
    _raise_on(who, rc)
    count_launch(lookup_pyramid_fused)
    return out


lookup_pyramid_fused.launches = 0


def lookup_project_fused(
    pyramid: Sequence[torch.Tensor],
    centroids: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    radius: int,
    proj_dtype=None,
) -> torch.Tensor:
    """K1: lookup + ``convcorr1`` in one kernel, ``(B, C_out, h, w)`` at
    ``proj_dtype``.

    Args:
        pyramid, centroids: as :func:`lookup_pyramid_fused`.
        weight: the fp32 conv weight ``(C_out, L*S*S[, 1, 1])``, rows in the
            reference tap order ``l*S*S + i*S + j``.
        bias: ``(C_out,)`` fp32.
        proj_dtype: ``None``/fp32 (3xTF32 product, fp32 out) or bf16 (taps
            and weight rounded to bf16, fp32 sums and bias, bf16 out).
    """
    who = "lookup_project_fused"
    _check_no_grad(who, pyramid, centroids, weight, bias)
    if proj_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"{who}: proj_dtype must be None, float32 or bfloat16, got {proj_dtype}")
    s = 2 * radius + 1
    c_in = len(pyramid) * s * s
    if weight.shape[0] < 1 or weight[0].numel() != c_in or weight.dim() not in (2, 4):
        raise ValueError(f"{who}: weight must be (C_out, {c_in}[, 1, 1]), got {tuple(weight.shape)}")
    c_out = weight.shape[0]
    if tuple(bias.shape) != (c_out,):
        raise ValueError(f"{who}: bias must be ({c_out},), got {tuple(bias.shape)}")
    b, h, w, q = _check_inputs(
        who, pyramid, centroids, radius, extra=[("weight", weight), ("bias", bias)],
        smem_bytes=_project_smem_bytes,
    )
    if centroids.device.type == "cpu":
        return lookup_project_reference(pyramid, centroids, weight, bias, radius, proj_dtype)
    bf16 = proj_dtype == torch.bfloat16
    out = torch.empty((b, c_out, h, w), device=centroids.device,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    lib = _lib()
    with torch.cuda.device(centroids.device):
        stream = torch.cuda.current_stream(centroids.device).cuda_stream
        rc = lib.xtap_project_launch(
            *_pyramid_args(pyramid, radius), centroids.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), q, h * w, radius, c_out, int(bf16), stream,
        )
    _raise_on(who, rc)
    count_launch(lookup_project_fused)
    return out


lookup_project_fused.launches = 0


class FusedLookupCorrBlock(CorrBlock):
    """Dense correlation block whose per-step lookup (and the motion
    encoder's ``convcorr1`` projection, via ``index_project``) runs in the
    CUDA kernel (``corr_impl='fused'``).

    ``dtype``: ``None`` (fp32), ``torch.bfloat16`` (the volume cast to
    bf16 and pooled in bf16, as :class:`CorrBlock` does) or ``torch.int8``
    (inference only: the fp32 levels pooled first, then each quantized by
    :func:`quantize_pyramid`). The kernels take every level size, so the
    pyramid is quantized at every width; the JAX block leaves it fp32 where
    its kernel cannot run (a y-dot level narrower than S+1 or wider than
    512), a deliberate difference. The pyramid is the plain list of levels,
    or a :class:`QuantizedPyramid`.
    """

    def __init__(self, num_levels: int = 4, radius: int = 4, dtype=None):
        self.quantize = dtype == torch.int8
        super().__init__(num_levels, radius, None if self.quantize else dtype)

    def build_pyramid(self, fmap1: torch.Tensor, fmap2: torch.Tensor):
        levels = super().build_pyramid(fmap1, fmap2)
        return quantize_pyramid(levels) if self.quantize else levels

    def index_pyramid(self, pyramid, centroids: torch.Tensor) -> torch.Tensor:
        return lookup_pyramid_fused(pyramid, centroids.contiguous(), self.radius)

    def index_project(self, pyramid, centroids: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      dtype=None) -> torch.Tensor:
        return lookup_project_fused(pyramid, centroids.contiguous(), weight, bias, self.radius, dtype)
