"""Flow upsampling: bilinear and learned convex combination (RAFT §3.3).

Semantics of torchvision RAFT's ``upsample_flow``: the mask is laid out as
``(N, 1, 9, factor, factor, h, w)`` and softmaxed over the 9 taps; tap
``k = 3*di + dj`` reads the 3x3 neighbourhood in ``unfold`` order; flow
values are scaled by ``factor`` before they are combined.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from raft_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ["upsample_flow"]


def upsample_flow(
    flow: torch.Tensor, up_mask: Optional[torch.Tensor] = None, factor: int = 8
) -> torch.Tensor:
    """Upsample ``(N, 2, h, w)`` flow by ``factor`` (vectors scaled by ``factor``).

    With ``up_mask`` of shape ``(N, 9*factor*factor, h, w)`` each fine pixel
    is a convex (softmax-weighted) combination of the coarse 3x3
    neighbourhood; otherwise align-corners bilinear interpolation is used.
    """
    n, c, h, w = flow.shape
    if up_mask is None:
        return resize_bilinear_align_corners(flow, h * factor, w * factor) * factor
    expected = (n, 9 * factor * factor, h, w)
    if tuple(up_mask.shape) != expected:
        raise ValueError(f"up_mask shape {tuple(up_mask.shape)} != {expected}")
    weights = up_mask.reshape(n, 1, 9, factor, factor, h, w).softmax(dim=2)
    taps = F.unfold(flow * factor, kernel_size=3, padding=1)
    taps = taps.reshape(n, c, 9, 1, 1, h, w)
    combined = (weights * taps).sum(dim=2)  # (n, c, f, f, h, w)
    combined = combined.permute(0, 1, 4, 2, 5, 3)  # (n, c, h, f, w, f)
    return combined.reshape(n, c, h * factor, w * factor)
