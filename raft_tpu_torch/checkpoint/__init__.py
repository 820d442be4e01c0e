"""Checkpoint conversion into the port's state_dict layout."""

from raft_tpu_torch.checkpoint.convert import state_dict_from_flax

__all__ = ["state_dict_from_flax"]
