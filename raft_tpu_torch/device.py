"""Device resolution for the port's entry points.

Every entry point runs on the CUDA card unless the caller asks for the CPU
by name: a machine without a card raises instead of silently falling back,
so a CPU run can never be mistaken for a run on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``'cuda'``; a CUDA device must exist, a CPU device is
    taken only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
