"""Checkpoint reading and conversion into the port's state_dict layout,
and the training checkpoint manager."""

from raft_tpu_torch.checkpoint.convert import load_msgpack, state_dict_from_flax
from raft_tpu_torch.checkpoint.manager import CheckpointManager, validate_restored

__all__ = ["CheckpointManager", "load_msgpack", "state_dict_from_flax", "validate_restored"]
