"""Evaluation protocol helpers."""

from raft_tpu_torch.eval.padder import InputPadder

__all__ = ["InputPadder"]
