"""Flax variable tree -> the port's state_dict.

The inverse of the JAX package's torch -> Flax converter
(``raft_tpu/checkpoint/convert.py``), so one set of weights loads into both
packages:

  * ``kernel`` (HWIO) -> ``weight`` (OIHW),
  * ``scale`` (norm affine) -> ``weight``,
  * ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``,
    with ``num_batches_tracked`` = 0 as torchvision's BatchNorm carries it,
  * Flax ``layers_N`` module names -> Sequential indices ``N``
    (``convcorr1/layers_0`` -> ``convcorr1.0``).

The result is also the torchvision RAFT key layout, so it loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_flax"]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _module_path(scope: Tuple[str, ...]) -> str:
    return ".".join(p[len("layers_"):] if p.startswith("layers_") else p for p in scope)


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Convert ``{'params': ...[, 'batch_stats': ...]}`` (numpy-convertible
    leaves) to a flat state_dict of fp32 tensors."""
    state: Dict[str, torch.Tensor] = {}

    def put(key: str, arr) -> None:
        if key in state:
            raise ValueError(f"duplicate state_dict key {key!r}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))

    for (*scope, leaf), value in _leaves(variables.get("params", {})):
        arr = np.asarray(value)
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(scope)}: expected a 4-D HWIO kernel, got {arr.shape}")
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            leaf = "weight"
        put(f"{_module_path(tuple(scope))}.{leaf}", arr)
    stats_names = {"mean": "running_mean", "var": "running_var"}
    for (*scope, leaf), value in _leaves(variables.get("batch_stats", {})):
        if leaf not in stats_names:
            raise ValueError(f"unknown batch statistic {'/'.join(scope + [leaf])}")
        module = _module_path(tuple(scope))
        put(f"{module}.{stats_names[leaf]}", np.asarray(value))
        if leaf == "mean":
            state[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return state
