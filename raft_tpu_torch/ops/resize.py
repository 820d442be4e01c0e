"""Aligned-corner bilinear resize (NCHW)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_bilinear_align_corners"]


def resize_bilinear_align_corners(image: torch.Tensor, new_h: int, new_w: int) -> torch.Tensor:
    """Resize ``(N, C, H, W)`` to ``(N, C, new_h, new_w)``, align_corners=True.

    Computed in fp32 and cast back, as the JAX package's sampling-matrix
    form accumulates in fp32.
    """
    if tuple(image.shape[-2:]) == (new_h, new_w):
        return image
    out = F.interpolate(
        image.float(), size=(new_h, new_w), mode="bilinear", align_corners=True
    )
    return out.to(image.dtype)
