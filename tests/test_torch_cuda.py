"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test carries the ``cuda`` marker and skips without a card.

This module imports neither JAX nor the JAX package and uses no fixture of
``tests/conftest.py``, so a card machine without the JAX package's
dependencies runs it with
``python -m pytest -m cuda --noconftest tests/test_torch_*.py`` (the JAX
parity modules skip themselves there).

Tolerances: 1e-5 for the taps (a 4-term fp32 bilinear sum per tap, summed
in another order than the plain version's matmuls) and 1e-4 for the
projection (a 100-324-term fp32 dot per output). TF32 is off.
"""

import numpy as np
import pytest
import torch

import raft_tpu_torch as rt
from raft_tpu_torch.kernels import lookup_xtap
from raft_tpu_torch.kernels.lookup_xtap import (
    lookup_project_fused,
    lookup_project_reference,
    lookup_pyramid_fused,
    lookup_pyramid_reference,
)
from raft_tpu_torch.models import corr

pytestmark = pytest.mark.cuda

LOOKUP_TOL = 1e-5
PROJECT_TOL = 1e-4

CASES = {
    # (batch, h, w, radius, levels, centroid range)
    "small": (1, 16, 24, 4, 4, (-6.0, 30.0)),
    "ragged_kitti": (1, 47, 156, 4, 4, (-6.0, 162.0)),
    "batch2": (2, 20, 28, 4, 4, (-6.0, 34.0)),
    "odd_dims": (1, 27, 37, 3, 3, (-6.0, 43.0)),
    "radius1_levels6": (1, 64, 64, 1, 6, (-3.0, 67.0)),
    "far_out": (1, 16, 24, 4, 4, (-500.0, 600.0)),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device):
    b, h, w, radius, levels, (lo, hi) = CASES[case]
    gen = torch.Generator(device="cpu").manual_seed(0)
    f1 = torch.randn(b, 32, h, w, generator=gen).to(device)
    f2 = torch.randn(b, 32, h, w, generator=gen).to(device)
    pyr = corr.pool_pyramid(corr.correlation_volume(f1, f2), levels)
    cents = (torch.rand(b, h, w, 2, generator=gen) * (hi - lo) + lo).to(device)
    return pyr, cents, radius


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_matches_plain(cuda_device, case):
    pyr, cents, radius = _inputs(case, cuda_device)
    before = lookup_pyramid_fused.launches
    got = lookup_pyramid_fused(pyr, cents, radius)
    torch.cuda.synchronize()
    assert lookup_pyramid_fused.launches == before + 1
    want = lookup_pyramid_reference(pyr, cents, radius)
    torch.testing.assert_close(got, want, rtol=LOOKUP_TOL, atol=LOOKUP_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_matches_plain(cuda_device, case):
    pyr, cents, radius = _inputs(case, cuda_device)
    c_in = len(pyr) * (2 * radius + 1) ** 2
    gen = torch.Generator(device="cpu").manual_seed(1)
    weight = (torch.randn(64, c_in, generator=gen) * 0.1).to(cuda_device)
    bias = torch.randn(64, generator=gen).to(cuda_device)
    before = lookup_project_fused.launches
    got = lookup_project_fused(pyr, cents, weight, bias, radius)
    torch.cuda.synchronize()
    assert lookup_project_fused.launches == before + 1
    want = lookup_project_reference(pyr, cents, weight, bias, radius)
    torch.testing.assert_close(got, want, rtol=PROJECT_TOL, atol=PROJECT_TOL)


def test_cuda_path_never_runs_plain_version(cuda_device, monkeypatch):
    """On CUDA tensors the wrappers launch their kernels: the plain
    versions are never called."""
    pyr, cents, radius = _inputs("small", cuda_device)

    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(lookup_xtap, "lookup_pyramid_reference", boom)
    monkeypatch.setattr(lookup_xtap, "lookup_project_reference", boom)
    monkeypatch.setattr(lookup_xtap, "lookup_pyramid", boom)
    lookup_pyramid_fused(pyr, cents, radius)
    weight = torch.zeros(8, len(pyr) * (2 * radius + 1) ** 2, device=cuda_device)
    lookup_project_fused(pyr, cents, weight, torch.zeros(8, device=cuda_device), radius)
    torch.cuda.synchronize()


def test_fused_model_matches_dense(cuda_device):
    """Same weights, fused (K1 on the card) vs dense (plain lookup on the
    card), narrow raft_large-style config, 3 updates; K1 launches once per
    update. The flow head's last conv is scaled so an update moves the flow
    a few pixels (random weights otherwise make the recurrence chaotic)."""
    narrow = dict(
        feature_encoder_widths=(8, 8, 12, 16, 32),
        context_encoder_widths=(8, 8, 12, 16, 48),
        motion_corr_widths=(16, 12),
        motion_flow_widths=(16, 8),
        motion_out_channels=24,
        gru_hidden=32,
        flow_head_hidden=16,
    )
    fused = rt.build_raft(rt.RAFT_LARGE.replace(corr_impl="fused", **narrow), device=cuda_device)
    with torch.no_grad():
        fused.update_block.flow_head.conv2.weight.mul_(0.05)
    dense = rt.build_raft(rt.RAFT_LARGE.replace(corr_impl="dense", **narrow), device=cuda_device)
    dense.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(6)
    a = rng.integers(0, 256, (123, 150, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (123, 150, 3), dtype=np.uint8)
    before = lookup_project_fused.launches
    got = rt.FlowEstimator(fused, num_flow_updates=3)(a, b)
    assert lookup_project_fused.launches - before == 3
    want = rt.FlowEstimator(dense, num_flow_updates=3)(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
