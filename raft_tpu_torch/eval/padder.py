"""Replicate-padding of inputs to the model's %8 contract (host numpy).

'sintel' mode splits the vertical pad top/bottom, 'downstream' puts it all
at the bottom; the horizontal pad always splits left/right. Arrays are
channel-last ``(..., H, W, C)``, as images arrive from callers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["InputPadder"]


class InputPadder:
    def __init__(self, shape: Tuple[int, ...], mode: str = "sintel", factor: int = 8):
        if mode not in ("sintel", "downstream"):
            raise ValueError(f"pad mode must be 'sintel' or 'downstream', got {mode!r}")
        h, w = shape[-3], shape[-2]
        pad_h = (-h) % factor
        pad_w = (-w) % factor
        if mode == "sintel":
            top, bottom = pad_h // 2, pad_h - pad_h // 2
        else:
            top, bottom = 0, pad_h
        left, right = pad_w // 2, pad_w - pad_w // 2
        self._pads = ((top, bottom), (left, right))

    @property
    def pads(self):
        return self._pads

    def pad(self, *arrays: np.ndarray):
        (t, b), (l, r) = self._pads
        out = [
            np.pad(a, [(0, 0)] * (a.ndim - 3) + [(t, b), (l, r), (0, 0)], mode="edge")
            for a in arrays
        ]
        return out[0] if len(out) == 1 else out

    def unpad(self, array: np.ndarray) -> np.ndarray:
        (t, b), (l, r) = self._pads
        h, w = array.shape[-3], array.shape[-2]
        return array[..., t : h - b, l : w - r, :]
