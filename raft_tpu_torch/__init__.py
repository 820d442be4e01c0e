"""raft_tpu_torch: RAFT optical flow in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of the JAX package ``raft_tpu``, slice by slice; it imports
neither JAX nor anything of ``raft_tpu``. Entry points run on the CUDA card
unless ``device='cpu'`` is passed.

    from raft_tpu_torch import FlowEstimator, raft_large
    estimate = FlowEstimator(raft_large(corr_impl="fused"))
    flow = estimate(image1, image2)   # (H, W, 2) float32 numpy, pixels

    # a deployment preset: 'quality' | 'throughput' | 'edge'
    estimate = FlowEstimator.from_preset("throughput", checkpoint="raft_large.msgpack")
"""

from raft_tpu_torch.inference import FlowEstimator, FlowStream
from raft_tpu_torch.models import (
    RAFT,
    RAFT_LARGE,
    RAFT_SMALL,
    RAFTConfig,
    build_raft,
    raft_for_serving,
    raft_large,
    raft_small,
)
from raft_tpu_torch.serve import ServeConfig

__all__ = [
    "FlowEstimator",
    "FlowStream",
    "RAFT",
    "RAFTConfig",
    "RAFT_LARGE",
    "RAFT_SMALL",
    "ServeConfig",
    "build_raft",
    "raft_for_serving",
    "raft_large",
    "raft_small",
]
