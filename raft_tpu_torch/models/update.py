"""Update-block components: motion encoder, ConvGRU stack, flow head, mask
predictor (NCHW).

Module names (``convcorr*``, ``convflow*``, ``conv``, ``convz/r/q``,
``convgru1/2``, ``conv1/2``, ``convrelu``) follow torchvision RAFT's
state_dict.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from raft_tpu_torch.models.corr import project_taps
from raft_tpu_torch.models.layers import ConvNormAct, conv

__all__ = [
    "MotionEncoder",
    "ConvGRU",
    "RecurrentBlock",
    "FlowHead",
    "UpdateBlock",
    "MaskPredictor",
]


class MotionEncoder(nn.Module):
    """Encodes (current flow, correlation features) into motion features.

    ``convcorr1`` only holds the 1x1 conv's parameters (at index 0, the
    torchvision key ``convcorr1.0.weight``): the correlation block applies
    them, fused into its lookup kernel when it has one (the ``project``
    seam of :class:`~raft_tpu_torch.models.corr.LazyCorrFeatures`), at
    ``compute_dtype`` (``None``: fp32). Output carries the raw flow in its
    last two channels.
    """

    compute_dtype = None

    def __init__(
        self,
        corr_channels: int,
        corr_widths: Tuple[int, ...] = (256, 192),
        flow_widths: Tuple[int, int] = (128, 64),
        out_channels: int = 128,
    ):
        super().__init__()
        if len(corr_widths) not in (1, 2):
            raise ValueError("corr_widths must have 1 or 2 entries")
        self.convcorr1 = nn.Sequential(nn.Conv2d(corr_channels, corr_widths[0], 1))
        self.convcorr2 = (
            ConvNormAct(corr_widths[0], corr_widths[1], 3, norm=None)
            if len(corr_widths) == 2
            else None
        )
        self.convflow1 = ConvNormAct(2, flow_widths[0], 7, norm=None)
        self.convflow2 = ConvNormAct(flow_widths[0], flow_widths[1], 3, norm=None)
        self.conv = ConvNormAct(corr_widths[-1] + flow_widths[1], out_channels - 2, 3, norm=None)
        self.out_channels = out_channels

    def forward(self, flow, corr_features):
        """``corr_features`` is a ``LazyCorrFeatures`` handle or the
        materialized ``(B, h, w, C)`` taps; both routes compute
        ``relu(taps @ W^T + b)`` with the same parameters."""
        proj = self.convcorr1[0]
        if hasattr(corr_features, "project"):
            c = corr_features.project(proj.weight, proj.bias, dtype=self.compute_dtype)
        else:
            c = project_taps(corr_features, proj.weight, proj.bias, dtype=self.compute_dtype)
            c = c.permute(0, 3, 1, 2)
        if self.convcorr2 is not None:
            c = self.convcorr2(c)
        f = self.convflow2(self.convflow1(flow))
        joint = self.conv(torch.cat([c, f], dim=1))
        return torch.cat([joint, flow.to(joint.dtype)], dim=1)


class ConvGRU(nn.Module):
    """Convolutional GRU cell: z/r/q gates as single convs over cat(h, x)."""

    def __init__(self, hidden: int, input_size: int, kernel, pad):
        super().__init__()
        self.convz = conv(hidden + input_size, hidden, kernel, 1, padding=pad)
        self.convr = conv(hidden + input_size, hidden, kernel, 1, padding=pad)
        self.convq = conv(hidden + input_size, hidden, kernel, 1, padding=pad)

    def forward(self, h, x):
        hx = torch.cat([h, x.to(h.dtype)], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q


class RecurrentBlock(nn.Module):
    """One or two chained ConvGRUs; raft_large uses separable (1,5)+(5,1)
    kernels, raft_small a single 3x3."""

    def __init__(
        self,
        hidden: int,
        input_size: int,
        kernels: Tuple[Tuple[int, int], ...] = ((1, 5), (5, 1)),
        pads: Tuple[Tuple[int, int], ...] = ((0, 2), (2, 0)),
    ):
        super().__init__()
        if len(kernels) not in (1, 2) or len(kernels) != len(pads):
            raise ValueError("kernels/pads must be matching tuples of length 1 or 2")
        self.hidden = hidden
        self.convgru1 = ConvGRU(hidden, input_size, kernels[0], pads[0])
        self.convgru2 = (
            ConvGRU(hidden, input_size, kernels[1], pads[1]) if len(kernels) == 2 else None
        )

    def forward(self, h, x):
        h = self.convgru1(h, x)
        if self.convgru2 is not None:
            h = self.convgru2(h, x)
        return h


class FlowHead(nn.Module):
    """3x3 -> relu -> 3x3 head predicting the 2-channel delta flow; ``conv2``
    stays fp32 at every compute dtype, so coordinates stay fp32."""

    def __init__(self, in_channels: int, hidden: int):
        super().__init__()
        self.conv1 = conv(in_channels, hidden, 3)
        self.conv2 = conv(hidden, 2, 3)

    def forward(self, x):
        return self.conv2(torch.relu(self.conv1(x)).float())


class UpdateBlock(nn.Module):
    """Motion encoder -> GRU over cat(context, motion) -> flow head."""

    def __init__(self, motion_encoder: MotionEncoder, recurrent_block: RecurrentBlock, flow_head: FlowHead):
        super().__init__()
        self.motion_encoder = motion_encoder
        self.recurrent_block = recurrent_block
        self.flow_head = flow_head

    def forward(self, hidden_state, context, corr_features, flow):
        motion = self.motion_encoder(flow, corr_features)
        x = torch.cat([context, motion], dim=1)
        hidden_state = self.recurrent_block(hidden_state, x)
        return hidden_state, self.flow_head(hidden_state)

    @property
    def hidden_state_size(self) -> int:
        return self.recurrent_block.hidden


class MaskPredictor(nn.Module):
    """Predicts the 8*8*9-channel convex-upsampling mask, scaled by
    ``multiplier`` (torchvision keeps 0.25); ``conv`` stays fp32 at every
    compute dtype, so the upsample's softmax is fp32. Absent in
    raft_small."""

    def __init__(self, in_channels: int, hidden: int, multiplier: float = 0.25):
        super().__init__()
        self.convrelu = ConvNormAct(in_channels, hidden, 3, norm=None)
        self.conv = conv(hidden, 8 * 8 * 9, 1)
        self.multiplier = multiplier

    def forward(self, x):
        return self.multiplier * self.conv(self.convrelu(x).float())
