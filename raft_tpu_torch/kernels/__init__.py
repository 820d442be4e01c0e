"""Hand-written kernels for Hopper (sm_90a) and their wrappers: CUDA C++
for K1-K4, Triton for K5.

Importing this package builds nothing; a kernel is compiled on its first
launch (see :mod:`raft_tpu_torch.kernels.build`).
"""

from raft_tpu_torch.kernels.corr_pallas import (
    PallasCorrBlock,
    fused_volume_pyramid,
    volume_pyramid_reference,
)
from raft_tpu_torch.kernels.inorm_pallas import instance_norm_pallas, instance_norm_reference
from raft_tpu_torch.kernels.lookup_pallas import lookup_pyramid_pallas
from raft_tpu_torch.kernels.lookup_xtap import (
    FusedLookupCorrBlock,
    lookup_project_fused,
    lookup_project_reference,
    lookup_pyramid_fused,
    lookup_pyramid_reference,
)

__all__ = [
    "FusedLookupCorrBlock",
    "PallasCorrBlock",
    "fused_volume_pyramid",
    "instance_norm_pallas",
    "instance_norm_reference",
    "lookup_project_fused",
    "lookup_project_reference",
    "lookup_pyramid_fused",
    "lookup_pyramid_pallas",
    "lookup_pyramid_reference",
    "volume_pyramid_reference",
]
