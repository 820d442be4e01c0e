"""Correlation engine: all-pairs volume, pooled pyramid, multi-scale lookup.

These are the plain PyTorch versions: the oracles the CUDA lookup kernel
(``kernels/lookup_xtap.py``) is held against, and the ``corr_impl='dense'``
block. A correlation block exposes ``build_pyramid(fmap1, fmap2)``,
``index_pyramid(pyramid, centroids)``,
``index_project(pyramid, centroids, weight, bias)`` and ``out_channels``.

Layouts at the public signatures are the JAX package's, so the two compare
like with like: pyramid levels ``(B*Q, hl, wl)``, centroids ``(B, h, w, 2)``
in (x, y) order, taps ``(B, h, w, L*S*S)`` with the channel order level,
then x-offset ``i``, then y-offset ``j`` (S = 2r+1). Feature maps come in
NCHW, the port's conv layout, and ``index_project`` returns its motion
features NCHW for the convs that follow.

Reduced precision follows the JAX package's ``CorrBlock(dtype=...)``
(``raft_tpu/models/corr.py``): the volume is computed in fp32, cast to
bf16 and pooled in bf16 (a bf16 rounding after each add); the lookup carries bf16 bilinear weights and
bf16 rows, with each x-tap product rounded to bf16 and the taps summed in
fp32; ``project_taps(dtype=bf16)`` casts taps, weight and bias to bf16.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops.sampling import bilinear_sample

__all__ = [
    "CorrBlock",
    "LazyCorrFeatures",
    "QuantizedPyramid",
    "map_levels",
    "correlation_volume",
    "pool_pyramid",
    "separable_taps",
    "lookup_pyramid",
    "lookup_pyramid_gather",
    "project_taps",
]


def correlation_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs dot-product volume in fp32, scaled by 1/sqrt(C).

    Args:
        fmap1, fmap2: ``(B, C, h, w)`` feature maps.

    Returns:
        ``(B, h*w, h, w)``: correlation of each query pixel (second axis)
        against every target pixel.
    """
    b, c, h, w = fmap1.shape
    q = fmap1.reshape(b, c, h * w).transpose(1, 2).float()
    t = fmap2.reshape(b, c, h * w).float()
    vol = torch.matmul(q, t) * (1.0 / math.sqrt(c))
    return vol.reshape(b, h * w, h, w)


def _avg_pool_bf16(lvl: torch.Tensor) -> torch.Tensor:
    """VALID 2x2 mean of a bf16 ``(N, h, w)`` level, in bf16: each cell
    ``((a + b) + c) + d`` with a bf16 rounding after every add (the window
    in row-major order), then ``/ 4``, as XLA reduces a bf16 window."""
    hh, ww = lvl.shape[-2] // 2 * 2, lvl.shape[-1] // 2 * 2
    x = lvl[..., :hh, :ww]
    return (((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2]) + x[..., 1::2, 1::2]) / 4


def pool_pyramid(volume: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """VALID 2x2 average pooling of the target dims of ``(B, Q, h, w)``
    into ``num_levels`` levels of ``(B*Q, hl, wl)``; odd tails are dropped.
    A bf16 volume pools in bf16 (:func:`_avg_pool_bf16`)."""
    b, q, h, w = volume.shape
    lvl = volume.reshape(b * q, h, w)
    pyramid = [lvl]
    for _ in range(num_levels - 1):
        if lvl.dtype == torch.bfloat16:
            lvl = _avg_pool_bf16(lvl)
        else:
            lvl = F.avg_pool2d(lvl.unsqueeze(1), 2, stride=2).squeeze(1)
        pyramid.append(lvl)
    return pyramid


class QuantizedPyramid(tuple):
    """int8 pyramid levels with their fp32 dequantization factors: a real
    value is ``level[...] * scales[l]``. A tuple of the levels, so code
    that walks the levels walks these; ``scales`` is ``(L,)`` fp32."""

    def __new__(cls, levels, scales: torch.Tensor):
        obj = super().__new__(cls, levels)
        obj.scales = scales
        return obj


def map_levels(pyramid, fn):
    """``fn`` applied to each level, keeping a :class:`QuantizedPyramid`'s
    scales."""
    levels = tuple(fn(lvl) for lvl in pyramid)
    if isinstance(pyramid, QuantizedPyramid):
        return QuantizedPyramid(levels, pyramid.scales)
    return levels


def _bilinear_weights(pos: torch.Tensor, size: int) -> torch.Tensor:
    """``W[..., k] = relu(1 - |pos - k|)`` for ``k in [0, size)``: the
    two-corner bilinear weights of ``pos`` with zero padding."""
    grid = torch.arange(size, dtype=pos.dtype, device=pos.device)
    return torch.relu(1.0 - torch.abs(pos.unsqueeze(-1) - grid))


def _xtap_products_bf16(t: torch.Tensor, cx: torch.Tensor, radius: int) -> torch.Tensor:
    """``sum_x fp32(bf16(Wx[i, x] * t[j, x]))`` for bf16 rows ``t``
    ``(*batch, S_j, wl)`` and bf16 weights ``Wx = bf16(relu(1 - |pos - x|))``:
    the JAX package's bf16 x-contraction, each product rounded to bf16,
    summed in fp32. Only the two columns around each tap position carry
    weight, so they are gathered. Returns ``(*batch, S_i, S_j)``."""
    wl = t.shape[-1]
    r = torch.arange(-radius, radius + 1, dtype=cx.dtype, device=cx.device)
    pos = cx.unsqueeze(-1) + r  # (*batch, S_i)
    xa = torch.floor(pos)
    out = 0.0
    for col in (xa, xa + 1.0):
        w = torch.relu(1.0 - torch.abs(pos - col))
        w = torch.where((col >= 0) & (col < wl), w, torch.zeros_like(w)).to(torch.bfloat16)
        idx = col.clamp(0, wl - 1).long().unsqueeze(-2).expand(*t.shape[:-1], pos.shape[-1])
        out = out + (t.gather(-1, idx) * w.unsqueeze(-2)).float()  # (*batch, S_j, S_i)
    return out.transpose(-1, -2)


def separable_taps(
    vol: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, radius: int, weight_dtype=None
) -> torch.Tensor:
    """Bilinear (2r+1)^2 taps around per-item centres as two matmuls:

        out[..., i, j] = sum_{y,x} Wx[..., i, x] * Wy[..., j, y] * vol[..., y, x]

    ``i`` indexes x-offsets and ``j`` y-offsets. Out-of-range taps get zero
    weight rows. With ``weight_dtype=torch.bfloat16`` the weights and the
    y-contracted rows are bf16 (each row an fp32 sum rounded once) and each
    x-tap product is rounded to bf16 before the fp32 sum, as the JAX
    package computes it.

    Args:
        vol: ``(*batch, hl, wl)`` values.
        cx, cy: ``(*batch,)`` tap-centre coordinates (pixel units of vol).
    Returns:
        ``(*batch, S, S)`` fp32 taps.
    """
    hl, wl = vol.shape[-2], vol.shape[-1]
    r = torch.arange(-radius, radius + 1, dtype=cx.dtype, device=cx.device)
    wy = _bilinear_weights(cy.unsqueeze(-1) + r, hl)  # (*batch, S, hl)
    if weight_dtype == torch.bfloat16:
        wy = wy.to(torch.bfloat16).float()
        t = torch.matmul(wy, vol.float()).to(torch.bfloat16)  # (*batch, S_j, wl)
        return _xtap_products_bf16(t, cx, radius)
    if weight_dtype is not None:
        raise ValueError(f"weight_dtype must be None or torch.bfloat16, got {weight_dtype}")
    wx = _bilinear_weights(cx.unsqueeze(-1) + r, wl)  # (*batch, S, wl)
    t = torch.matmul(wy, vol.float())  # (*batch, S_j, wl)
    return torch.matmul(wx, t.transpose(-1, -2))  # (*batch, S_i, S_j)


def lookup_pyramid(
    pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int, weight_dtype=None
) -> torch.Tensor:
    """(2r+1)^2 bilinear taps around each centroid at every level, by
    separable dense weights (no gathers).

    Args:
        pyramid: list of ``(B*Q, hl, wl)`` levels.
        centroids: ``(B, h, w, 2)`` level-0 (x, y) coordinates per query.
        weight_dtype: ``None`` (fp32) or ``torch.bfloat16`` (see
            :func:`separable_taps`).

    Returns:
        ``(B, h, w, L*(2r+1)^2)`` correlation features.
    """
    b, h, w, _ = centroids.shape
    q = b * h * w
    s = 2 * radius + 1
    cent = centroids.reshape(q, 2).float()
    features = []
    for level, vol in enumerate(pyramid):
        taps = separable_taps(
            vol.reshape(q, vol.shape[-2], vol.shape[-1]),
            cent[:, 0] / (2.0**level),
            cent[:, 1] / (2.0**level),
            radius,
            weight_dtype,
        )
        features.append(taps.reshape(b, h, w, s * s))
    return torch.cat(features, dim=-1)


def _offset_grid(radius: int, device=None) -> torch.Tensor:
    """(S, S, 2) offsets in (x, y) order; tap (i, j) offsets x by r[i] and
    y by r[j] (the reference's transposed enumeration)."""
    r = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    off_x, off_y = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([off_x, off_y], dim=-1)


def lookup_pyramid_gather(
    pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int
) -> torch.Tensor:
    """Gather-based lookup: the oracle for :func:`lookup_pyramid`."""
    b, h, w, _ = centroids.shape
    s = 2 * radius + 1
    delta = _offset_grid(radius, centroids.device)[None]  # (1, S, S, 2)
    centers = centroids.reshape(b * h * w, 1, 1, 2).float()
    features = []
    for level, vol in enumerate(pyramid):
        coords = centers / (2.0**level) + delta
        taps = bilinear_sample(vol.unsqueeze(-1).float(), coords)  # (B*Q, S, S, 1)
        features.append(taps.reshape(b, h, w, s * s))
    return torch.cat(features, dim=-1)


def project_taps(
    taps: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, dtype=None
) -> torch.Tensor:
    """``relu(taps @ W^T + b)``: the motion encoder's ``convcorr1`` 1x1 conv
    as a matmul over the channel dim.

    Args:
        taps: ``(..., C_in)`` correlation features.
        weight: ``(C_out, C_in)`` or the conv's ``(C_out, C_in, 1, 1)``.
        bias: ``(C_out,)``.
        dtype: the compute dtype (``None``: fp32); taps, weight and bias are
            cast to it, as the conv it stands for would cast them.
    Returns:
        ``(..., C_out)`` in ``dtype``.
    """
    dt = dtype or torch.float32
    w = weight.reshape(weight.shape[0], -1).to(dt)
    return torch.relu(torch.matmul(taps.to(dt), w.t()) + bias.to(dt))


class LazyCorrFeatures:
    """Deferred correlation lookup, passed to the update block in place of
    the materialized tap tensor.

    The motion encoder calls :meth:`project` with its ``convcorr1`` weights,
    which the block's ``index_project`` applies: the fused block runs lookup
    and projection in one kernel, the dense block materializes the taps and
    applies :func:`project_taps`. :meth:`materialize` returns the taps
    themselves.
    """

    def __init__(self, block, pyramid: Sequence[torch.Tensor], centroids: torch.Tensor):
        self.block = block
        self.pyramid = pyramid
        self.centroids = centroids

    @property
    def out_channels(self) -> int:
        return self.block.out_channels

    def materialize(self) -> torch.Tensor:
        """``(B, h, w, L*S*S)`` taps."""
        return self.block.index_pyramid(self.pyramid, self.centroids)

    def project(self, weight: torch.Tensor, bias: torch.Tensor, dtype=None) -> torch.Tensor:
        """``(B, C_out, h, w)`` projected motion features at ``dtype``."""
        return self.block.index_project(self.pyramid, self.centroids, weight, bias, dtype=dtype)


class CorrBlock:
    """Dense correlation block (reference semantics; parameter-free).

    ``dtype`` (``torch.bfloat16`` or ``None`` for fp32) is the storage
    dtype of the pooled pyramid and the lookup's weights and rows; the
    volume is computed in fp32 and the taps come out fp32 either way.
    The coarsest pyramid level must keep >= 2 px per side.
    """

    def __init__(self, num_levels: int = 4, radius: int = 4, dtype=None):
        if dtype not in (None, torch.bfloat16):
            raise ValueError(f"{type(self).__name__}: dtype must be None or torch.bfloat16, got {dtype}")
        self.num_levels = num_levels
        self.radius = radius
        self.dtype = dtype
        self.out_channels = num_levels * (2 * radius + 1) ** 2

    def min_fmap_size(self) -> int:
        return 2 * 2 ** (self.num_levels - 1)

    def check_fmaps(self, fmap1: torch.Tensor, fmap2: torch.Tensor) -> None:
        """Raise unless the two NCHW maps match and keep >= 2 px per side
        at the coarsest level."""
        if fmap1.shape != fmap2.shape:
            raise ValueError("feature maps must have identical shapes")
        min_hw = self.min_fmap_size()
        if min(fmap1.shape[2:4]) < min_hw:
            raise ValueError(
                f"feature maps {tuple(fmap1.shape[2:4])} too small for a "
                f"{self.num_levels}-level pyramid; need >= {min_hw} per side "
                f"(inputs are downsampled 8x, so images must be >= {8 * min_hw} px)"
            )

    def build_pyramid(self, fmap1: torch.Tensor, fmap2: torch.Tensor) -> List[torch.Tensor]:
        self.check_fmaps(fmap1, fmap2)
        vol = correlation_volume(fmap1, fmap2)
        if self.dtype is not None:
            vol = vol.to(self.dtype)
        return pool_pyramid(vol, self.num_levels)

    def index_pyramid(self, pyramid: Sequence[torch.Tensor], centroids: torch.Tensor) -> torch.Tensor:
        return lookup_pyramid(pyramid, centroids, self.radius, self.dtype)

    def index_project(
        self,
        pyramid: Sequence[torch.Tensor],
        centroids: torch.Tensor,
        weight: torch.Tensor,
        bias: torch.Tensor,
        dtype=None,
    ) -> torch.Tensor:
        """Lookup + ``convcorr1`` projection at ``dtype``, NCHW out."""
        taps = self.index_pyramid(pyramid, centroids)
        return project_taps(taps, weight, bias, dtype).permute(0, 3, 1, 2)
