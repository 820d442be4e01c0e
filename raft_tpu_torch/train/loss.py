"""RAFT sequence loss and flow metrics (NCHW).

Ported from the JAX package's ``raft_tpu/train/loss.py``: an
exponentially weighted sum of L1 errors over all ``N`` iterative
predictions,

    L = sum_i  gamma^(N-1-i) * mean_valid |f_i - f_gt|_1

with pixels masked out where the ground truth is invalid or its magnitude
reaches ``max_flow``. Layouts are the port's: predictions ``(N, B, 2, H,
W)``, ground truth ``(B, 2, H, W)``, validity ``(B, H, W)``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["sequence_loss", "flow_metrics"]


def sequence_loss(
    flow_preds: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    *,
    gamma: float = 0.8,
    max_flow: float = 400.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Exponentially weighted multi-iteration L1 flow loss.

    ``valid`` is bool or {0, 1} float (a float counts where > 0.5).
    Returns ``(loss, metrics)``: ``epe``/``1px``/``3px``/``5px`` of the
    final prediction over the masked pixels, and ``loss``; every value a
    0-d tensor on the predictions' device.
    """
    n = flow_preds.shape[0]
    mask = torch.linalg.vector_norm(flow_gt, dim=1) < max_flow  # (B, H, W)
    if valid is not None:
        mask = mask & (valid if valid.dtype == torch.bool else valid > 0.5)
    maskf = mask.float()
    denom = torch.clamp(maskf.sum(), min=1.0)
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32, device=flow_preds.device)
    err = torch.abs(flow_preds - flow_gt.unsqueeze(0))  # (N, B, 2, H, W)
    per_iter = (err.sum(dim=2) * maskf.unsqueeze(0)).sum(dim=(1, 2, 3)) / denom
    loss = torch.sum(weights * per_iter)
    metrics = flow_metrics(flow_preds[-1], flow_gt, mask)
    metrics["loss"] = loss
    return loss, metrics


def flow_metrics(
    flow: torch.Tensor, flow_gt: torch.Tensor, valid: Optional[torch.Tensor] = None
) -> Dict[str, torch.Tensor]:
    """EPE and N-px accuracies of ``(B, 2, H, W)`` flow over the valid
    pixels (the reference's metric definitions)."""
    epe = torch.linalg.vector_norm(flow - flow_gt, dim=1)  # (B, H, W)
    maskf = torch.ones_like(epe) if valid is None else valid.float()
    denom = torch.clamp(maskf.sum(), min=1.0)

    def vmean(x):
        return (x * maskf).sum() / denom

    return {
        "epe": vmean(epe),
        "1px": vmean((epe < 1.0).float()),
        "3px": vmean((epe < 3.0).float()),
        "5px": vmean((epe < 5.0).float()),
    }
