"""Checkpoint reading and conversion into the port's state_dict layout."""

from raft_tpu_torch.checkpoint.convert import load_msgpack, state_dict_from_flax

__all__ = ["load_msgpack", "state_dict_from_flax"]
