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


def pool_pyramid(volume: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """VALID 2x2 average pooling of the target dims of ``(B, Q, h, w)``
    into ``num_levels`` levels of ``(B*Q, hl, wl)``; odd tails are dropped."""
    b, q, h, w = volume.shape
    lvl = volume.reshape(b * q, h, w)
    pyramid = [lvl]
    for _ in range(num_levels - 1):
        lvl = F.avg_pool2d(lvl.unsqueeze(1), 2, stride=2).squeeze(1)
        pyramid.append(lvl)
    return pyramid


def _bilinear_weights(pos: torch.Tensor, size: int) -> torch.Tensor:
    """``W[..., k] = relu(1 - |pos - k|)`` for ``k in [0, size)``: the
    two-corner bilinear weights of ``pos`` with zero padding."""
    grid = torch.arange(size, dtype=pos.dtype, device=pos.device)
    return torch.relu(1.0 - torch.abs(pos.unsqueeze(-1) - grid))


def separable_taps(
    vol: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor, radius: int
) -> torch.Tensor:
    """Bilinear (2r+1)^2 taps around per-item centres as two matmuls:

        out[..., i, j] = sum_{y,x} Wx[..., i, x] * Wy[..., j, y] * vol[..., y, x]

    ``i`` indexes x-offsets and ``j`` y-offsets. Out-of-range taps get zero
    weight rows.

    Args:
        vol: ``(*batch, hl, wl)`` values.
        cx, cy: ``(*batch,)`` tap-centre coordinates (pixel units of vol).
    Returns:
        ``(*batch, S, S)`` fp32 taps.
    """
    hl, wl = vol.shape[-2], vol.shape[-1]
    r = torch.arange(-radius, radius + 1, dtype=cx.dtype, device=cx.device)
    wx = _bilinear_weights(cx.unsqueeze(-1) + r, wl)  # (*batch, S, wl)
    wy = _bilinear_weights(cy.unsqueeze(-1) + r, hl)  # (*batch, S, hl)
    t = torch.matmul(wy, vol.float())  # (*batch, S_j, wl)
    return torch.matmul(wx, t.transpose(-1, -2))  # (*batch, S_i, S_j)


def lookup_pyramid(
    pyramid: Sequence[torch.Tensor], centroids: torch.Tensor, radius: int
) -> torch.Tensor:
    """(2r+1)^2 bilinear taps around each centroid at every level, by
    separable dense weights (no gathers).

    Args:
        pyramid: list of ``(B*Q, hl, wl)`` levels.
        centroids: ``(B, h, w, 2)`` level-0 (x, y) coordinates per query.

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


def project_taps(taps: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``relu(taps @ W^T + b)``: the motion encoder's ``convcorr1`` 1x1 conv
    as a matmul over the channel dim.

    Args:
        taps: ``(..., C_in)`` correlation features.
        weight: ``(C_out, C_in)`` or the conv's ``(C_out, C_in, 1, 1)``.
        bias: ``(C_out,)``.
    Returns:
        ``(..., C_out)``.
    """
    w = weight.reshape(weight.shape[0], -1).float()
    return torch.relu(torch.matmul(taps.float(), w.t()) + bias.float())


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

    def project(self, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """``(B, C_out, h, w)`` projected motion features."""
        return self.block.index_project(self.pyramid, self.centroids, weight, bias)


class CorrBlock:
    """Dense correlation block (reference semantics; parameter-free).

    The coarsest pyramid level must keep >= 2 px per side.
    """

    def __init__(self, num_levels: int = 4, radius: int = 4):
        self.num_levels = num_levels
        self.radius = radius
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
        return pool_pyramid(correlation_volume(fmap1, fmap2), self.num_levels)

    def index_pyramid(self, pyramid: Sequence[torch.Tensor], centroids: torch.Tensor) -> torch.Tensor:
        return lookup_pyramid(pyramid, centroids, self.radius)

    def index_project(
        self,
        pyramid: Sequence[torch.Tensor],
        centroids: torch.Tensor,
        weight: torch.Tensor,
        bias: torch.Tensor,
    ) -> torch.Tensor:
        """Lookup + ``convcorr1`` projection, NCHW out."""
        taps = self.index_pyramid(pyramid, centroids)
        return project_taps(taps, weight, bias).permute(0, 3, 1, 2)
