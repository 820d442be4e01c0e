"""Host-side utilities."""

from raft_tpu_torch.utils.prefetch import prefetch

__all__ = ["prefetch"]
