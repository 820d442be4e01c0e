"""RAFT model components (NCHW) and the model zoo."""

from raft_tpu_torch.models.corr import CorrBlock, LazyCorrFeatures
from raft_tpu_torch.models.encoders import FeatureEncoder
from raft_tpu_torch.models.raft import RAFT
from raft_tpu_torch.models.zoo import (
    CONFIGS,
    RAFT_LARGE,
    RAFT_SMALL,
    RAFTConfig,
    build_raft,
    load_checkpoint,
    raft_for_serving,
    raft_large,
    raft_small,
)

__all__ = [
    "CONFIGS",
    "CorrBlock",
    "FeatureEncoder",
    "LazyCorrFeatures",
    "RAFT",
    "RAFTConfig",
    "RAFT_LARGE",
    "RAFT_SMALL",
    "build_raft",
    "load_checkpoint",
    "raft_for_serving",
    "raft_large",
    "raft_small",
]
