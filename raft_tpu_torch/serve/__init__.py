"""Serving: for now the precision presets (``ServeConfig.preset``); the
engine comes with the serving layer. Imports no engine."""

from raft_tpu_torch.serve.config import PRESETS, ServeConfig

__all__ = ["PRESETS", "ServeConfig"]
