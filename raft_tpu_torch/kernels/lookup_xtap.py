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
bf16, fp32 sums, fp32 bias) and returns that dtype. The bf16 product reads
a zero-padded bf16 copy of the weight (:func:`project_weight_bf16`), which
:class:`FusedLookupCorrBlock` makes once per weight version and keeps.

The raw wrappers are inference-only: a call with grad enabled on inputs
that require grad raises. Training goes through their differentiable
forms, :func:`lookup_fused_diff` (K2) and :func:`project_fused_diff` (K1),
the JAX package's ``custom_vjp``s of the same names: the forward is the
kernel (its plain version on the CPU), the backward autograd of the dense
block's own formulation (``models.corr.lookup_pyramid`` at the block's
``weight_dtype``, then ``project_taps`` at ``proj_dtype``) recomputed from
the saved inputs. There is no hand-written backward kernel, as the JAX
package has none: on the card the backward is cuBLAS's batched matmuls.
int8 levels stay inference-only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from raft_tpu_torch.device import fp32_precision
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
    "lookup_fused_diff",
    "lookup_project_fused",
    "lookup_project_reference",
    "lookup_pyramid_fused",
    "lookup_pyramid_reference",
    "project_fused_diff",
    "project_weight_bf16",
    "quantize_pyramid",
]

MAX_LEVELS = 8  # the kernel's pyramid descriptor holds at most this many levels
MAX_SMEM_BYTES = 232448  # shared memory one block may use on sm_90
SM_SMEM_BYTES = 233472  # an SM's shared memory, 228 KB
# K1's block tile (csrc/lookup_xtap.cu): queries x channels, weight slices
# of PROJECT_KC columns in a ring of PROJECT_STAGES (3xTF32, rows of KC + 4
# floats), or of PROJECT_KC_BF16 in PROJECT_STAGES_BF16 (bf16 product, rows
# of KC_BF16 / 2 + 4 words)
PROJECT_BM, PROJECT_BN, PROJECT_KC, PROJECT_STAGES = 32, 256, 16, 3
PROJECT_KC_BF16, PROJECT_STAGES_BF16 = 32, 4
TWO_BLOCK_SMEM_BYTES = 115712  # two K1 blocks an SM: (228 KB - 2 x 1 KB reserved) / 2
# K2 and K4 (taps_plan in csrc/lookup_xtap.cu): blocks of TAPS_THREADS take
# TAPS_QUERIES queries where eight blocks an SM fit (TAPS_SMEM_SHARE bytes
# each), fewer otherwise; K2 takes at most K2_MAX_TAPS taps a query (L*S*S),
# K4 S*(S+2) up to K4_MAX_SPAN: the shapes their earlier forms took
TAPS_THREADS, TAPS_QUERIES, TAPS_BLOCKS_PER_SM = 128, 8, 8
TAPS_CHUNK = 16  # bytes a window chunk copies (rows aligned down to it)
TAPS_SMEM_SHARE = SM_SMEM_BYTES // TAPS_BLOCKS_PER_SM - 1024
K2_MAX_TAPS, K4_MAX_SPAN = 1816, 7264


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


def _taps_plan(num_levels: int, radius: int, elem_size: int = 4, k4: bool = False) -> Optional[dict]:
    """K2's and K4's block plan, ``taps_plan`` in the source: the queries a
    block (``nq``), the levels a pass and the shared-memory layout, or
    ``None`` for a shape the entry point does not take (K2 over
    ``K2_MAX_TAPS`` taps a query, K4 ``S*(S+2)`` over ``K4_MAX_SPAN``).
    A block holds a 16-byte table entry per (query, level), one pass's
    windows and the tap tile at output width (fp32 taps from fp32 levels,
    else bf16), whose rows are ``pitch`` bytes apart, alike mod 16 with the
    output's, plus 16 bytes for the span's phase. A window is ``S+1`` rows
    ``rb`` bytes apart: the ``row_chunks`` chunks of ``TAPS_CHUNK`` bytes
    that cover a row's ``S+1`` cells from any phase, rows an odd number of
    16-byte chunks apart. The first of all levels down to one (outer) and ``nq`` =
    8, 4, 2, 1 (inner) that fits ``TAPS_SMEM_SHARE`` (eight blocks an SM),
    else ``MAX_SMEM_BYTES``."""
    s = 2 * radius + 1
    s1, ss = s + 1, s * s
    c = num_levels * ss
    if (s * (s + 2) > K4_MAX_SPAN) if k4 else (c > K2_MAX_TAPS):
        return None
    es = 4 if elem_size == 4 else 2
    row_chunks = -(-(TAPS_CHUNK - elem_size + s1 * elem_size) // TAPS_CHUNK)
    rb = TAPS_CHUNK * (row_chunks | 1)
    for budget in (TAPS_SMEM_SHARE, MAX_SMEM_BYTES):
        for nl in range(num_levels, 0, -1):
            nq = TAPS_QUERIES
            while nq >= 1:
                win_off = 16 * nq * num_levels
                tile_off = (win_off + nl * nq * s1 * rb + 15) & ~15
                pitch = nl * ss * es + ((c - nl * ss) * es) % 16
                smem = tile_off + nq * pitch + 16
                if smem <= budget:
                    return dict(nq=nq, levels_per_pass=nl, rb=rb, row_chunks=row_chunks, pitch=pitch,
                                win_off=win_off, tile_off=tile_off, smem=smem)
                nq //= 2
    return None


def _taps_smem_bytes(num_levels: int, radius: int, elem_size: int = 4, k4: bool = False) -> int:
    """K2's (K4's with ``k4``) dynamic shared memory per block
    (:func:`_taps_plan`); over ``MAX_SMEM_BYTES`` for a shape refused."""
    plan = _taps_plan(num_levels, radius, elem_size, k4)
    return MAX_SMEM_BYTES + 1 if plan is None else plan["smem"]


def _project_k_pad(c_in: int, bf16_product: bool = False) -> int:
    """K1: the product's depth, C_in rounded up to the m16n8k8 step of 8
    (3xTF32) or the m16n8k16 step of 16 (bf16 product); zero columns in
    shared memory, and in the bf16 weight copy."""
    step = 16 if bf16_product else 8
    return -(-c_in // step) * step


def _project_layout(num_levels: int, radius: int, elem_size: int = 4, bf16_product: bool = False):
    """K1's shared memory, ``project_smem`` in the source: ``(bytes,
    levels_per_pass, prefetch)``. A block holds the A tile (rows 4 mod 8
    words: K + 4 floats, or K + 8 bf16), a region for the weight ring (3
    stages of 256 x 20 floats, or 4 of 256 x 20 words at bf16) and the
    epilogue's 256 x 36-float tile, and a 16-byte table entry per (query,
    level) window. fp32 levels at 3xTF32 (the fp32 form) overlay the
    region with as many levels' fp32 windows as it holds. Every other form
    takes all levels' windows in one pass where shared memory allows (the
    most it allows otherwise); bf16 / int8 windows, at storage width in
    rows of ``(S * elem + 7) // 4`` words, lie past the ``prefetch`` ring
    stages that are in flight during the gather, as many as fit; two
    blocks an SM if any such layout fits, else one. More than
    ``MAX_SMEM_BYTES``: refused, as are bf16 / int8 windows of more than
    32 columns (r > 15), which the kernel's column walk cannot take."""
    s = 2 * radius + 1
    s1 = s + 1
    c_in = num_levels * s * s
    table = 16 * PROJECT_BM * MAX_LEVELS
    tile = 4 * PROJECT_BN * (PROJECT_BM + 4)
    k_pad = _project_k_pad(c_in, bf16_product)
    if bf16_product:
        a_bytes, stages = 2 * PROJECT_BM * (k_pad + 8), PROJECT_STAGES_BF16
        stage = 4 * PROJECT_BN * (PROJECT_KC_BF16 // 2 + 4)
    else:
        a_bytes, stages = 4 * PROJECT_BM * (k_pad + 4), PROJECT_STAGES
        stage = 4 * PROJECT_BN * (PROJECT_KC + 4)
    ring = stages * stage
    win_level = 4 * PROJECT_BM * s1 * s1  # one level's fp32 windows
    if elem_size == 4 and not bf16_product:
        region = max(ring, tile, win_level)
        return a_bytes + region + table, region // win_level, 0
    max_prefetch = 0
    if elem_size != 4:
        if s1 > 32:  # the column walk takes a window's S+1 columns in one warp
            return MAX_SMEM_BYTES + 1, 0, 0
        win_level = 4 * PROJECT_BM * s1 * ((s * elem_size + 7) // 4)
        max_prefetch = stages - 1
    for budget in (TWO_BLOCK_SMEM_BYTES, MAX_SMEM_BYTES):
        for nl in range(num_levels, 0, -1):
            for p in range(max_prefetch, -1, -1):
                region = max(ring, tile, p * stage + nl * win_level)
                if a_bytes + region + table <= budget:
                    return a_bytes + region + table, nl, p
    return MAX_SMEM_BYTES + 1, 0, 0


def _project_smem_bytes(num_levels: int, radius: int, elem_size: int = 4, bf16_product: bool = False) -> int:
    """K1's dynamic shared memory per block (:func:`_project_layout`)."""
    return _project_layout(num_levels, radius, elem_size, bf16_product)[0]


def project_weight_bf16(weight: torch.Tensor) -> torch.Tensor:
    """``convcorr1``'s weight as K1's bf16 product reads it: ``(C_out,
    k_pad)`` bf16, each row the ``C_in`` weights rounded to bf16 (RNE), then
    zeros up to ``k_pad``, a multiple of 16 (16-byte rows for the kernel's
    copies)."""
    w = weight.detach().reshape(weight.shape[0], -1)
    out = torch.zeros(w.shape[0], _project_k_pad(w.shape[1], True), dtype=torch.bfloat16, device=w.device)
    out[:, : w.shape[1]] = w
    return out


def _check_no_grad(who: str, pyramid, *tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*pyramid, *tensors)):
        if isinstance(pyramid, QuantizedPyramid):
            raise RuntimeError(
                f"{who}: corr_dtype='int8' is inference-only (the quantized lookup "
                "defines no gradient), and an input requires grad. Run under "
                "torch.no_grad()/torch.inference_mode(), or train with corr_dtype "
                "'float32' or 'bfloat16' (both differentiate through the fused block)"
            )
        raise RuntimeError(
            f"{who} is inference-only: its inputs require grad. Run under "
            "torch.no_grad()/torch.inference_mode(), or differentiate through "
            "lookup_fused_diff / project_fused_diff (the kernel forward, the "
            "dense formulation's backward), as FusedLookupCorrBlock does"
        )


def _check_inputs(who: str, pyramid, centroids: torch.Tensor, radius: int, extra=(), smem_bytes=None):
    """Validate the shared arguments; returns (b, h, w, q).

    Levels share one dtype, fp32, bf16 or int8; int8 levels come as a
    :class:`QuantizedPyramid` with ``(L,)`` fp32 scales. Everything else is
    fp32. ``smem_bytes(num_levels, radius)`` is the kernel's dynamic shared
    memory per block (default: K2's plan, :func:`_taps_smem_bytes`)."""
    if centroids.dim() != 4 or centroids.shape[-1] != 2:
        raise ValueError(f"{who}: centroids must be (B, h, w, 2), got {tuple(centroids.shape)}")
    b, h, w, _ = centroids.shape
    q = b * h * w
    if not 1 <= len(pyramid) <= MAX_LEVELS:
        raise ValueError(f"{who}: needs 1..{MAX_LEVELS} pyramid levels, got {len(pyramid)}")
    if radius < 0:
        raise ValueError(f"{who}: radius must be >= 0, got {radius}")
    if (smem_bytes or _taps_smem_bytes)(len(pyramid), radius) > MAX_SMEM_BYTES:
        raise ValueError(
            f"{who}: {len(pyramid)} levels at radius {radius} need more shared "
            "memory per block than the kernel's plan allows"
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
    lib.xtap_project_launch.argtypes = pyramid_t + [ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr, ptr]
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
            bf16, or a :class:`QuantizedPyramid` of int8 levels, at any
            address (bf16 / int8 levels that start off a 4-byte boundary
            are copied cell by cell, the others in 4-byte words).
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
    weight_bf16: Optional[torch.Tensor] = None,
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
        weight_bf16: for the bf16 product on the card, ``weight``'s
            :func:`project_weight_bf16` copy, made once by a caller that
            launches repeatedly; ``None`` makes it for this call.
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
    bf16 = proj_dtype == torch.bfloat16
    elem_size = pyramid[0].element_size() if pyramid and pyramid[0].dtype in _ELEM else 4
    b, h, w, q = _check_inputs(
        who, pyramid, centroids, radius, extra=[("weight", weight), ("bias", bias)],
        smem_bytes=lambda n, r: _project_smem_bytes(n, r, elem_size, bf16),
    )
    if centroids.device.type == "cpu":
        return lookup_project_reference(pyramid, centroids, weight, bias, radius, proj_dtype)
    for i, v in enumerate(pyramid):
        if elem_size != 4 and v.data_ptr() % 4:
            raise ValueError(f"{who}: level {i} must start 4-byte aligned (the kernel copies bf16 and int8 "
                             "windows in aligned 4-byte words)")
    if bf16:
        if weight_bf16 is None:
            weight_bf16 = project_weight_bf16(weight)
        want = (c_out, _project_k_pad(c_in, True))
        if (weight_bf16.dtype != torch.bfloat16 or tuple(weight_bf16.shape) != want
                or weight_bf16.device != centroids.device or not weight_bf16.is_contiguous()
                or weight_bf16.data_ptr() % 16):
            raise ValueError(f"{who}: weight_bf16 must be a contiguous, 16-byte aligned bf16 {want} tensor "
                             f"on {centroids.device} (project_weight_bf16(weight))")
    out = torch.empty((b, c_out, h, w), device=centroids.device,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    lib = _lib()
    with torch.cuda.device(centroids.device):
        stream = torch.cuda.current_stream(centroids.device).cuda_stream
        rc = lib.xtap_project_launch(
            *_pyramid_args(pyramid, radius), centroids.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), out.data_ptr(), q, h * w, radius, c_out, int(bf16),
            weight_bf16.data_ptr() if bf16 else None, stream,
        )
    _raise_on(who, rc)
    count_launch(lookup_project_fused)
    return out


lookup_project_fused.launches = 0


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _dense_vjp(ctx, fn, tensors, grad):
    """The backward of a differentiable wrapper: ``fn(*tensors)``, the dense
    formulation, recomputed under grad mode (IEEE fp32, as the model's
    entry points pin it) on detached copies of the saved inputs, and its
    vector-Jacobian product with ``grad``: one gradient per tensor, ``None``
    where ``ctx.needs_input_grad`` (offset past the wrapper's leading
    non-tensor arguments by ``ctx.first``) asks for none."""
    needs = [ctx.needs_input_grad[ctx.first + i] for i in range(len(tensors))]
    leaves = [t.detach().requires_grad_(need) for t, need in zip(tensors, needs)]
    wanted = [leaf for leaf in leaves if leaf.requires_grad]
    if not wanted:
        return [None] * len(tensors)
    with torch.enable_grad(), fp32_precision():
        out = fn(*leaves)
    grads = iter(torch.autograd.grad(out, wanted, grad))
    return [next(grads) if leaf.requires_grad else None for leaf in leaves]


class _LookupFn(torch.autograd.Function):
    """K2 forward, the dense lookup's backward (``lookup_fused_diff``)."""

    @staticmethod
    def forward(ctx, radius, weight_dtype, centroids, *levels):
        ctx.radius, ctx.weight_dtype, ctx.first = radius, weight_dtype, 2
        ctx.save_for_backward(centroids, *levels)
        return lookup_pyramid_fused(list(levels), centroids, radius)

    @staticmethod
    def backward(ctx, grad):
        radius, weight_dtype = ctx.radius, ctx.weight_dtype
        grads = _dense_vjp(ctx, lambda c, *lv: lookup_pyramid(list(lv), c, radius, weight_dtype),
                           ctx.saved_tensors, grad)
        return (None, None, *grads)


class _ProjectFn(torch.autograd.Function):
    """K1 forward, the dense lookup + ``convcorr1``'s backward
    (``project_fused_diff``)."""

    @staticmethod
    def forward(ctx, radius, weight_dtype, proj_dtype, weight_bf16, centroids, weight, bias, *levels):
        ctx.radius, ctx.weight_dtype, ctx.proj_dtype, ctx.first = radius, weight_dtype, proj_dtype, 4
        ctx.save_for_backward(centroids, weight, bias, *levels)
        return lookup_project_fused(list(levels), centroids, weight, bias, radius, proj_dtype, weight_bf16)

    @staticmethod
    def backward(ctx, grad):
        radius, weight_dtype, proj_dtype = ctx.radius, ctx.weight_dtype, ctx.proj_dtype

        def dense(c, w, b, *lv):
            taps = lookup_pyramid(list(lv), c, radius, weight_dtype)
            return project_taps(taps, w, b, proj_dtype).permute(0, 3, 1, 2)

        return (None, None, None, None, *_dense_vjp(ctx, dense, ctx.saved_tensors, grad))


def lookup_fused_diff(pyramid, centroids: torch.Tensor, radius: int, weight_dtype=None) -> torch.Tensor:
    """K2 as a differentiable function (the JAX ``lookup_fused_diff``):
    the forward is :func:`lookup_pyramid_fused`, the backward autograd of
    ``models.corr.lookup_pyramid(levels, centroids, radius, weight_dtype)``,
    the dense block's lookup, recomputed from the saved levels and
    centroids. Gradients reach every level and the centroids. Without
    grad (or on int8 levels, which refuse a gradient) it is the raw
    wrapper."""
    if isinstance(pyramid, QuantizedPyramid) or not _needs_grad((*pyramid, centroids)):
        return lookup_pyramid_fused(pyramid, centroids, radius)
    return _LookupFn.apply(radius, weight_dtype, centroids, *pyramid)


def project_fused_diff(pyramid, centroids: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, radius: int,
                       weight_dtype=None, proj_dtype=None, weight_bf16: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 as a differentiable function (the JAX ``project_fused_diff``):
    the forward is :func:`lookup_project_fused`, the backward autograd of
    the dense block's ``project_taps(lookup_pyramid(levels, centroids,
    radius, weight_dtype), weight, bias, proj_dtype)``, NCHW, recomputed
    from the saved inputs. Gradients reach every level, the centroids,
    the weight and the bias. Without grad (or on int8 levels, which
    refuse a gradient) it is the raw wrapper."""
    if isinstance(pyramid, QuantizedPyramid) or not _needs_grad((*pyramid, centroids, weight, bias)):
        return lookup_project_fused(pyramid, centroids, weight, bias, radius, proj_dtype, weight_bf16)
    return _ProjectFn.apply(radius, weight_dtype, proj_dtype, weight_bf16, centroids, weight, bias, *pyramid)


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

    Training (fp32 and bf16 levels): ``index_pyramid`` and
    ``index_project`` go through :func:`lookup_fused_diff` and
    :func:`project_fused_diff`, whose gradients are the dense block's
    (:class:`CorrBlock` at the same ``dtype``). They keep only their
    inputs for the backward, so ``remat_policy='corr'`` computes the
    projection outside any checkpoint (``projection_keeps_inputs``).
    """

    projection_keeps_inputs = True

    def __init__(self, num_levels: int = 4, radius: int = 4, dtype=None):
        self.quantize = dtype == torch.int8
        super().__init__(num_levels, radius, None if self.quantize else dtype)
        self._weight_bf16 = None  # (weight, (data_ptr, version), its project_weight_bf16 copy)

    def weight_bf16(self, weight: torch.Tensor) -> torch.Tensor:
        """:func:`project_weight_bf16` of ``weight``, made once and kept
        while the weight's storage and version are the same (a reload
        refreshes it). A CUDA-graph capture finds it made by the capture's
        eager warm-up; making it during a capture raises, as the copy would
        otherwise run in every replay."""
        try:
            version = weight._version
        except RuntimeError:  # an inference tensor keeps no version counter
            version = None
        key = (weight.data_ptr(), version)
        kept = self._weight_bf16
        if kept is not None and kept[0] is weight and kept[1] == key:
            return kept[2]
        if weight.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "FusedLookupCorrBlock: the bf16 copy of convcorr1's weight is made while a CUDA graph is "
                "captured; run the block eagerly once first (GraphProgram's warm-up does)"
            )
        copy = project_weight_bf16(weight)
        self._weight_bf16 = (weight, key, copy)
        return copy

    def build_pyramid(self, fmap1: torch.Tensor, fmap2: torch.Tensor):
        levels = super().build_pyramid(fmap1, fmap2)
        return quantize_pyramid(levels) if self.quantize else levels

    def index_pyramid(self, pyramid, centroids: torch.Tensor) -> torch.Tensor:
        return lookup_fused_diff(pyramid, centroids.contiguous(), self.radius, self.dtype)

    def index_project(self, pyramid, centroids: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      dtype=None) -> torch.Tensor:
        weight_bf16 = self.weight_bf16(weight) if dtype == torch.bfloat16 and weight.is_cuda else None
        return project_fused_diff(pyramid, centroids.contiguous(), weight, bias, self.radius, self.dtype, dtype,
                                  weight_bf16)
