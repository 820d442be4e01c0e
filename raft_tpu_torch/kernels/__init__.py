"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

Importing this package builds nothing; a kernel is compiled on its first
launch (see :mod:`raft_tpu_torch.kernels.build`).
"""

from raft_tpu_torch.kernels.lookup_xtap import (
    FusedLookupCorrBlock,
    lookup_project_fused,
    lookup_project_reference,
    lookup_pyramid_fused,
    lookup_pyramid_reference,
)

__all__ = [
    "FusedLookupCorrBlock",
    "lookup_project_fused",
    "lookup_project_reference",
    "lookup_pyramid_fused",
    "lookup_pyramid_reference",
]
