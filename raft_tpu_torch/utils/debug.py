"""Nonfinite detection for the training step.

Ported from the JAX package's ``raft_tpu/utils/debug.py``
(``nonfinite_count``, ``nonfinite_leaf_counts``, ``NumericsError`` and
``format_report``): counts fold on the device to one scalar or one
vector, so a step that carries them makes no host sync; the trainer reads
them at its log boundary. ``localize_nans`` (a ``checkify`` re-run) has
no port: ``torch.autograd.detect_anomaly`` does that job.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

__all__ = ["NumericsError", "nonfinite_count", "nonfinite_leaf_counts", "nonfinite_report", "format_report"]


class NumericsError(RuntimeError):
    """Raised by the Trainer when ``check_numerics`` trips; carries the
    per-leaf report in ``.report``."""

    def __init__(self, message: str, report: Dict[str, int]):
        super().__init__(message)
        self.report = report


def nonfinite_leaf_counts(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-tensor nan/inf counts as one int32 vector on the device (0 for
    a non-float tensor, so the index stays aligned with the list)."""
    if not tensors:
        return torch.zeros((0,), dtype=torch.int32)
    return torch.stack([
        (~torch.isfinite(t)).sum().to(torch.int32) if t.is_floating_point()
        else torch.zeros((), dtype=torch.int32, device=t.device)
        for t in tensors
    ])


def nonfinite_count(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Total nan/inf count over the tensors, one int32 0-d tensor."""
    if not tensors:
        return torch.zeros((), dtype=torch.int32)
    return nonfinite_leaf_counts(tensors).sum().to(torch.int32)


def nonfinite_report(named: Mapping[str, torch.Tensor], *, max_entries: int = 20) -> Dict[str, int]:
    """``{name: count}`` of the float tensors holding nan/inf, host side
    (one fetch per tensor: for a post-mortem, not the loop)."""
    report: Dict[str, int] = {}
    for name, t in named.items():
        if not t.is_floating_point():
            continue
        n = int((~torch.isfinite(t)).sum())
        if n:
            report[name] = n
            if len(report) >= max_entries:
                break
    return report


def format_report(report: Mapping[str, int]) -> str:
    if not report:
        return "(all leaves finite)"
    return "\n".join(f"  {k}: {v} nonfinite" for k, v in report.items())
