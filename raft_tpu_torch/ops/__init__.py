"""Sampling, resize and upsampling ops (NCHW unless stated)."""

from raft_tpu_torch.ops.resize import resize_bilinear_align_corners
from raft_tpu_torch.ops.sampling import bilinear_sample, coords_grid
from raft_tpu_torch.ops.upsample import upsample_flow

__all__ = [
    "bilinear_sample",
    "coords_grid",
    "resize_bilinear_align_corners",
    "upsample_flow",
]
