"""Optical-flow datasets as plain index-able objects returning numpy dicts.

Ported from the JAX package's ``raft_tpu/data/datasets.py``: the base
:class:`FlowDataset` with its Sintel validity rule, the RAFT training
menu (FlyingChairs, FlyingThings3D, Sintel, KITTI-2015, HD1K) and the
mixing wrappers :class:`ConcatDataset` and :class:`RepeatDataset`. KITTI
and HD1K carry sparse ground truth: their samples hold a ``sparse``
marker, which the augmentor reads.

Sample contract: ``{"image1", "image2": (H, W, 3) uint8,
"flow": (H, W, 2) float32, "valid": (H, W) bool}``; test splits (no
ground truth) carry no ``flow``/``valid``.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_tpu_torch.data.io import read_flow, read_image

__all__ = [
    "FlowDataset",
    "Sintel",
    "FlyingChairs",
    "FlyingThings3D",
    "Kitti",
    "HD1K",
    "ConcatDataset",
    "RepeatDataset",
]

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


class ConcatDataset(FlowDataset):
    """Concatenation of index-able flow datasets.

    With the pipeline's uniform shuffling, each part is sampled with
    probability ``len(part) / len(concat)`` — combine with ``RepeatDataset``
    to express the RAFT-recipe mixing weights.
    """

    def __init__(self, parts: Sequence) -> None:
        self.parts = list(parts)
        self._cum = np.cumsum([len(p) for p in self.parts]) if self.parts else np.zeros(0, np.int64)

    def __len__(self) -> int:
        return int(self._cum[-1]) if len(self.parts) else 0

    def _locate(self, idx: int) -> Tuple[int, int]:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        part = int(np.searchsorted(self._cum, idx, side="right"))
        lo = 0 if part == 0 else int(self._cum[part - 1])
        return part, idx - lo

    def __getitem__(self, idx: int) -> Sample:
        part, sub = self._locate(idx)
        return self.parts[part][sub]

    def paths(self, idx: int):
        part, sub = self._locate(idx)
        return self.parts[part].paths(sub)


class RepeatDataset(FlowDataset):
    """``times`` virtual copies of a dataset: a sampling-weight multiplier
    inside a ``ConcatDataset`` mix (the RAFT recipe expresses its S/K/H
    ratios as integer repeats, e.g. 100x Sintel-clean + 5x HD1K + 1x Things).
    """

    def __init__(self, base, times: int) -> None:
        if times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        self.base = base
        self.times = int(times)

    def __len__(self) -> int:
        return self.times * len(self.base)

    def __getitem__(self, idx: int) -> Sample:
        return self.base[idx % len(self.base)]

    def paths(self, idx: int):
        return self.base.paths(idx % len(self.base))


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


class FlyingChairs(FlowDataset):
    """FlyingChairs: ``root/data/NNNNN_{img1,img2}.ppm`` + ``_flow.flo``.

    ``split_file`` (``FlyingChairs_train_val.txt``: 1=train, 2=val) selects
    the split when present; otherwise every pair is used.
    """

    def __init__(self, root: str, split: str = "train", split_file: Optional[str] = None):
        super().__init__()
        flows = sorted(glob.glob(os.path.join(root, "data", "*_flow.flo")))
        labels = None
        split_file = split_file or os.path.join(root, "FlyingChairs_train_val.txt")
        if os.path.exists(split_file):
            labels = np.loadtxt(split_file, dtype=np.int32)
        want = 1 if split == "train" else 2
        for i, flow in enumerate(flows):
            if labels is not None and i < len(labels) and labels[i] != want:
                continue
            base = flow.replace("_flow.flo", "")
            self._pairs.append((base + "_img1.ppm", base + "_img2.ppm", flow))


class FlyingThings3D(FlowDataset):
    """FlyingThings3D (subset layout used by the RAFT recipe).

    Layout: ``root/frames_{pass}/TRAIN/{A,B,C}/seq/left/NNNN.png`` with flow
    at ``root/optical_flow/TRAIN/.../into_{future,past}/left/
    OpticalFlowInto{Future,Past}_NNNN_L.pfm``. Both time directions and both
    camera sides are enumerated.
    """

    def __init__(
        self,
        root: str,
        split: str = "TRAIN",
        dstype: str = "frames_cleanpass",
        cameras: Sequence[str] = ("left", "right"),
    ):
        super().__init__()
        for cam in cameras:
            for direction in ("into_future", "into_past"):
                image_dirs = sorted(
                    glob.glob(os.path.join(root, dstype, split, "*/*", cam))
                )
                flow_dirs = [
                    d.replace(dstype, "optical_flow").replace(
                        cam, os.path.join(direction, cam)
                    )
                    for d in image_dirs
                ]
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob.glob(os.path.join(idir, "*.png")))
                    flows = sorted(glob.glob(os.path.join(fdir, "*.pfm")))
                    if len(images) != len(flows):
                        continue
                    if direction == "into_future":
                        trip = zip(images[:-1], images[1:], flows[:-1])
                    else:
                        trip = zip(images[1:], images[:-1], flows[1:])
                    self._pairs.extend(trip)


class Kitti(FlowDataset):
    """KITTI-2015: sparse 16-bit png ground truth with validity channel."""

    sparse = True

    def __init__(self, root: str, split: str = "training"):
        super().__init__()
        img1s = sorted(glob.glob(os.path.join(root, split, "image_2", "*_10.png")))
        for img1 in img1s:
            img2 = img1.replace("_10.png", "_11.png")
            flow = None
            if split == "training":
                flow = os.path.join(
                    root, split, "flow_occ", os.path.basename(img1)
                )
            self._pairs.append((img1, img2, flow))


class HD1K(FlowDataset):
    """HD1K benchmark suite: 16-bit png flow, sequences of consecutive frames."""

    sparse = True

    def __init__(self, root: str):
        super().__init__()
        seqs: Dict[str, List[str]] = {}
        for img in sorted(
            glob.glob(os.path.join(root, "hd1k_input", "image_2", "*.png"))
        ):
            seq = os.path.basename(img).split("_")[0]
            seqs.setdefault(seq, []).append(img)
        for frames in seqs.values():
            for i in range(len(frames) - 1):
                flow = os.path.join(
                    root,
                    "hd1k_flow_gt",
                    "flow_occ",
                    os.path.basename(frames[i]),
                )
                self._pairs.append((frames[i], frames[i + 1], flow))
