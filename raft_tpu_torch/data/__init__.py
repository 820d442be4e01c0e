"""Datasets, file readers, augmentation and the training input pipeline."""

from raft_tpu_torch.data.datasets import (
    HD1K,
    ConcatDataset,
    FlowDataset,
    FlyingChairs,
    FlyingThings3D,
    Kitti,
    RepeatDataset,
    Sintel,
)
from raft_tpu_torch.data.io import (
    read_flo,
    read_flow,
    read_flow_png,
    read_image,
    read_pfm,
    write_flo,
    write_flow_png,
    write_pfm,
)

__all__ = [
    "HD1K",
    "ConcatDataset",
    "FlowDataset",
    "FlyingChairs",
    "FlyingThings3D",
    "Kitti",
    "RepeatDataset",
    "Sintel",
    "read_flo",
    "read_flow",
    "read_flow_png",
    "read_image",
    "read_pfm",
    "write_flo",
    "write_flow_png",
    "write_pfm",
]
