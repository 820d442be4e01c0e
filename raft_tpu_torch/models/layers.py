"""Core NN building blocks (NCHW).

Module names follow torchvision RAFT's state_dict: a conv-norm-act stage is
an ``nn.Sequential`` whose conv sits at index 0 and whose norm (if any) at
index 1, so ``convnormrelu.0.weight`` and ``convnormrelu.1.running_mean``
are the keys a torchvision ``.pth`` carries, and the JAX package's
``layers_0``/``layers_1`` names map onto them one to one
(``checkpoint.convert.state_dict_from_flax``).

Precision follows the JAX package's ``dtype`` (``raft_tpu/models/layers.py``):
a :class:`Conv2d` with ``compute_dtype`` set casts its input, weight and
bias to that dtype at the call, adds the bias to the product rounded to
that dtype, and returns that dtype (in a :class:`ConvNormAct` with a norm
the bias is added in fp32 and the sum goes to the norm unrounded, as XLA
fuses the JAX module); parameters stay
fp32 tensors, so a loaded checkpoint never changes. Norm statistics are
fp32 (instance norm returns its input's dtype, batch norm fp32, as Flax's
promotion of a bf16 input with fp32 parameters gives).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn

__all__ = [
    "Conv2d",
    "BatchNorm2d",
    "conv",
    "instance_norm",
    "InstanceNorm",
    "ConvNormAct",
    "ResidualBlock",
    "BottleneckBlock",
]

KernelT = Union[int, Tuple[int, int]]


def _pair(k: KernelT) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` when it is set
    (``None``: the parameters' fp32, the input promoted to it). The
    attribute is not state: ``state_dict`` keys and values are those of
    ``nn.Conv2d``."""

    compute_dtype = None

    def product(self, x):
        """The convolution without its bias, rounded to the compute dtype."""
        dt = self.compute_dtype or torch.float32
        return self._conv_forward(x.to(dt), self.weight.to(dt), None)

    def forward(self, x):
        # the bias joins the product once it is rounded to the compute dtype,
        # as the JAX module adds it (and as PyTorch's cuDNN path does; oneDNN
        # on the CPU would add it to the fp32 sum and round once)
        y = self.product(x)
        return y if self.bias is None else y + self.bias.to(y.dtype).view(1, -1, 1, 1)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that normalizes in fp32 and returns fp32 for any
    input dtype (the dtype Flax's BatchNorm gives a bf16 input).

    In train mode it is Flax's ``BatchNorm(use_running_average=False)``
    (``raft_tpu/models/layers.py:107-113``), not torch's: the batch
    variance is the biased one-pass ``max(0, E[x^2] - E[x]^2)``, used both
    to normalize and to update ``running_var`` (torch updates it from the
    unbiased variance), with ``running = (1 - momentum) * running +
    momentum * batch`` (Flax's momentum 0.9 is this momentum 0.1)."""

    def forward(self, x):
        x = x.float()
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)


def conv(
    in_channels: int,
    out_channels: int,
    kernel: KernelT = 3,
    stride: KernelT = 1,
    padding=None,
    bias: bool = True,
) -> Conv2d:
    """:class:`Conv2d` with ``(k-1)//2`` padding per spatial dim by default."""
    kernel = _pair(kernel)
    if padding is None:
        padding = tuple((k - 1) // 2 for k in kernel)
    return Conv2d(
        in_channels, out_channels, kernel, stride=_pair(stride), padding=padding, bias=bias
    )


def instance_norm(x: torch.Tensor, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """Parameter-free instance norm over H and W, one-pass fp32 statistics:
    ``var = max(0, E[x^2] - E[x]^2)`` (the JAX package's formula, clamp
    included)."""
    xf = x.float()
    mu = xf.mean(dim=(2, 3), keepdim=True)
    m2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(m2 - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


class InstanceNorm(nn.Module):
    """:func:`instance_norm` as a module (no parameters, no buffers)."""

    def forward(self, x):
        return instance_norm(x)


def _norm(spec: Optional[str], channels: int) -> Optional[nn.Module]:
    if spec is None:
        return None
    if spec == "batch":
        return BatchNorm2d(channels, eps=1e-5, momentum=0.1)
    if spec == "instance":
        return InstanceNorm()
    raise ValueError(f"unknown norm spec: {spec!r}")


class ConvNormAct(nn.Sequential):
    """Conv -> (norm) -> (relu); conv at index 0, norm at index 1.

    ``bias`` defaults to ``norm is None``, as in the JAX package.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: KernelT = 3,
        stride: KernelT = 1,
        norm: Optional[str] = "batch",
        act: bool = True,
        bias: Optional[bool] = None,
    ):
        use_bias = bias if bias is not None else norm is None
        layers = [conv(in_channels, out_channels, kernel, stride, bias=use_bias)]
        norm_layer = _norm(norm, out_channels)
        if norm_layer is not None:
            layers.append(norm_layer)
        if act:
            layers.append(nn.ReLU())
        super().__init__(*layers)
        self.has_norm = norm_layer is not None

    def forward(self, x):
        if not self.has_norm:
            return super().forward(x)
        # As XLA runs the JAX module (its fusion of the bias add into the
        # norm): the product rounded to the compute dtype, the bias added in
        # fp32, and the sum normalized without another rounding. Instance
        # norm returns the compute dtype, batch norm fp32.
        conv = self[0]
        y = conv.product(x)
        dt = y.dtype
        if conv.bias is not None:
            y = y.float() + conv.bias.to(dt).float().view(1, -1, 1, 1)
        y = self[1](y)
        if isinstance(self[1], InstanceNorm):
            y = y.to(dt)
        return torch.relu(y) if len(self) > 2 else y


class ResidualBlock(nn.Module):
    """Two 3x3 conv-norm-relu stages with an identity / strided-1x1 skip and
    a trailing relu on the sum (torchvision RAFT's residual block)."""

    def __init__(self, in_channels: int, out_channels: int, norm: Optional[str], stride: int = 1):
        super().__init__()
        self.convnormrelu1 = ConvNormAct(in_channels, out_channels, 3, stride, norm, bias=True)
        self.convnormrelu2 = ConvNormAct(out_channels, out_channels, 3, 1, norm, bias=True)
        self.downsample = (
            ConvNormAct(in_channels, out_channels, 1, stride, norm, act=False, bias=True)
            if stride != 1
            else None
        )

    def forward(self, x):
        y = self.convnormrelu2(self.convnormrelu1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1(C/4) -> 3x3(C/4, stride) -> 1x1(C) bottleneck with skip
    (raft_small's block)."""

    def __init__(self, in_channels: int, out_channels: int, norm: Optional[str], stride: int = 1):
        super().__init__()
        mid = out_channels // 4
        self.convnormrelu1 = ConvNormAct(in_channels, mid, 1, 1, norm, bias=True)
        self.convnormrelu2 = ConvNormAct(mid, mid, 3, stride, norm, bias=True)
        self.convnormrelu3 = ConvNormAct(mid, out_channels, 1, 1, norm, bias=True)
        self.downsample = (
            ConvNormAct(in_channels, out_channels, 1, stride, norm, act=False, bias=True)
            if stride != 1
            else None
        )

    def forward(self, x):
        y = self.convnormrelu3(self.convnormrelu2(self.convnormrelu1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)
