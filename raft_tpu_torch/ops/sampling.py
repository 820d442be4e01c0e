"""Bilinear sampling primitives.

``bilinear_sample`` is the explicit four-corner gather with in-bounds
masks: the semantics of ``torch.nn.functional.grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=True)`` on pixel-unit (x, y)
coordinates. It is the gather oracle of the correlation lookup
(``models.corr.lookup_pyramid_gather``), in the JAX package's channel-last
layout so the two packages compare like with like.
"""

from __future__ import annotations

import torch

__all__ = ["bilinear_sample", "coords_grid"]


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` at fractional pixel coordinates with bilinear weights.

    Args:
        img: ``(N, H, W, C)`` tensor.
        coords: ``(N, Hg, Wg, 2)`` tensor of (x, y) pixel coordinates.

    Returns:
        ``(N, Hg, Wg, C)`` tensor; taps outside the image read as zero.
    """
    if coords.shape[-1] != 2:
        raise ValueError(f"coords must have a trailing dim of 2, got {tuple(coords.shape)}")
    n, h, w, c = img.shape
    hg, wg = coords.shape[1], coords.shape[2]
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    wx1 = (x - x0f).unsqueeze(-1).to(img.dtype)
    wy1 = (y - y0f).unsqueeze(-1).to(img.dtype)
    x0 = x0f.long()
    y0 = y0f.long()
    flat = img.reshape(n, h * w, c)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, hg * wg, 1)
        vals = torch.gather(flat, 1, idx.expand(n, hg * wg, c)).reshape(n, hg, wg, c)
        return vals * valid.unsqueeze(-1).to(img.dtype)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    return wy0 * (wx0 * v00 + wx1 * v01) + wy1 * (wx0 * v10 + wx1 * v11)


def coords_grid(batch_size: int, h: int, w: int, *, device=None) -> torch.Tensor:
    """Pixel-index coordinate grid ``(batch_size, 2, h, w)``.

    Channel 0 is x and channel 1 is y, the flow convention (u = horizontal),
    laid out NCHW like the rest of the port's conv stack.
    """
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device, dtype=torch.float32),
        torch.arange(w, device=device, dtype=torch.float32),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=0)[None].repeat(batch_size, 1, 1, 1)
