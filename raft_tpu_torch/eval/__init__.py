"""Evaluation protocol: padding and the Sintel validation loop."""

from raft_tpu_torch.eval.padder import InputPadder
from raft_tpu_torch.eval.validate import chained_pairs_per_s, validate, validate_sintel

__all__ = ["InputPadder", "chained_pairs_per_s", "validate", "validate_sintel"]
