"""Datasets and file readers."""

from raft_tpu_torch.data.datasets import FlowDataset, Sintel
from raft_tpu_torch.data.io import read_flo, read_flow, read_image, read_pfm, write_flo, write_pfm

__all__ = ["FlowDataset", "Sintel", "read_flo", "read_flow", "read_image", "read_pfm", "write_flo", "write_pfm"]
