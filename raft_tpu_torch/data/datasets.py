"""Optical-flow datasets as plain index-able objects returning numpy dicts.

Ported from the JAX package's ``raft_tpu/data/datasets.py``: the base
:class:`FlowDataset` with its Sintel validity rule, and :class:`Sintel`.
The other datasets wait for the training slice.

Sample contract: ``{"image1", "image2": (H, W, 3) uint8,
"flow": (H, W, 2) float32, "valid": (H, W) bool}``; test splits (no
ground truth) carry no ``flow``/``valid``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from raft_tpu_torch.data.io import read_flow, read_image

__all__ = ["FlowDataset", "Sintel"]

Sample = Dict[str, np.ndarray]


class FlowDataset:
    """Base: a list of (img1, img2, flow-or-None) paths."""

    sparse: bool = False

    def __init__(self):
        self._pairs: List[Tuple[str, str, Optional[str]]] = []

    def __len__(self) -> int:
        return len(self._pairs)

    def __getitem__(self, idx: int) -> Sample:
        img1_path, img2_path, flow_path = self._pairs[idx]
        sample: Sample = {"image1": read_image(img1_path), "image2": read_image(img2_path)}
        if flow_path is not None:
            flow, valid = read_flow(flow_path)
            sample["flow"] = flow
            if valid is None:
                # Sintel convention: huge values mark invalid/occluded pixels
                valid = (np.abs(flow) < 1000).all(axis=-1)
            sample["valid"] = valid
            if self.sparse:
                sample["sparse"] = True
        return sample

    def paths(self, idx: int) -> Tuple[str, str, Optional[str]]:
        return self._pairs[idx]


class Sintel(FlowDataset):
    """MPI-Sintel: consecutive frame pairs per scene.

    Layout: ``root/{split}/{dstype}/{scene}/frame_NNNN.png`` with ground
    truth at ``root/{split}/flow/{scene}/frame_NNNN.flo`` (train split only).
    """

    def __init__(self, root: str, split: str = "training", dstype: str = "clean"):
        super().__init__()
        image_root = os.path.join(root, split, dstype)
        flow_root = os.path.join(root, split, "flow")
        has_flow = split != "test" and os.path.isdir(flow_root)
        for scene in sorted(os.listdir(image_root)):
            frames = sorted(glob.glob(os.path.join(image_root, scene, "*.png")))
            for i in range(len(frames) - 1):
                flow = None
                if has_flow:
                    name = os.path.basename(frames[i]).replace(".png", ".flo")
                    flow = os.path.join(flow_root, scene, name)
                self._pairs.append((frames[i], frames[i + 1], flow))
