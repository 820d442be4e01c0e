"""Feature / context encoder: 7x7 stride-2 stem, three 2-block stages, 1x1 head.

Downsamples exactly 8x (stem 2x, stages 1x/2x/2x). Module names
(``convnormrelu``, ``layer1..3`` with children ``0``/``1``, ``conv``)
follow torchvision RAFT's state_dict.
"""

from __future__ import annotations

from typing import Optional, Tuple, Type

import torch.nn as nn

from raft_tpu_torch.models.layers import ConvNormAct, ResidualBlock, conv

__all__ = ["FeatureEncoder"]


class FeatureEncoder(nn.Module):
    """RAFT encoder. ``widths`` = (stem, stage1, stage2, stage3, out)."""

    def __init__(
        self,
        block: Type[nn.Module] = ResidualBlock,
        widths: Tuple[int, int, int, int, int] = (64, 64, 96, 128, 256),
        norm: Optional[str] = "instance",
    ):
        super().__init__()
        stem, w1, w2, w3, out = widths
        self.convnormrelu = ConvNormAct(3, stem, 7, 2, norm, bias=True)
        self.layer1 = nn.Sequential(block(stem, w1, norm, 1), block(w1, w1, norm, 1))
        self.layer2 = nn.Sequential(block(w1, w2, norm, 2), block(w2, w2, norm, 1))
        self.layer3 = nn.Sequential(block(w2, w3, norm, 2), block(w3, w3, norm, 1))
        self.conv = conv(w3, out, 1)

    def forward(self, x):
        x = self.convnormrelu(x)
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv(x)
