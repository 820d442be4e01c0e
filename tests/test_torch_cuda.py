"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test carries the ``cuda`` marker and skips without a card.

This module imports neither JAX nor the JAX package and uses no fixture of
``tests/conftest.py``, so a card machine without the JAX package's
dependencies runs it with
``python -m pytest -m cuda --noconftest tests/test_torch_*.py`` (the JAX
parity modules skip themselves there).

Tolerances: 1e-5 for the taps of K2 and K4 (a 4-term fp32 bilinear sum per
tap, summed in another order than the plain version's matmuls), 1e-4 for
the K1 projection (a 100-324-term fp32 dot per output) and the K3 volume
(a 32-256-term fp32 dot per cell), 1e-5 for K5 in fp32 and one bf16
rounding step for its bf16 I/O. TF32 is off.
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
    "raft_small_fused": (1, 23, 41, 3, 4, (-6.0, 47.0)),  # C_in 196
    "batch2_ragged_hw": (2, 13, 19, 4, 4, (-6.0, 25.0)),  # 32-query tiles cross the batch at odd h*w
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


@pytest.mark.parametrize("c_out", [256, 96, 48, 20])  # raft_large, raft_small, fixture, ragged
@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_matches_plain(cuda_device, case, c_out):
    pyr, cents, radius = _inputs(case, cuda_device)
    c_in = len(pyr) * (2 * radius + 1) ** 2
    gen = torch.Generator(device="cpu").manual_seed(1)
    weight = (torch.randn(c_out, c_in, generator=gen) * 0.1).to(cuda_device)
    bias = torch.randn(c_out, generator=gen).to(cuda_device)
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


# -- K3, K4, K5 and the evaluation slice -----------------------------------------

VOLUME_TOL = 1e-4  # a 128- or 256-term fp32 dot per cell, summed in another order
INORM_TOL = 1e-5
BF16_RTOL = 2.0**-7  # one bf16 rounding step

VOLUME_CASES = {
    # (batch, channels, h, w, levels)
    "raft_small_sintel": (1, 128, 55, 128, 4),
    "raft_large_sintel": (1, 256, 55, 128, 4),
    "fixture": (1, 48, 12, 17, 3),
    "kitti_ragged_q": (1, 128, 47, 156, 4),
    "batch2": (2, 128, 55, 128, 4),
    "odd_dims": (1, 128, 45, 99, 4),
    "one_level": (1, 32, 9, 13, 1),
    "five_levels": (1, 32, 40, 48, 5),
    "channel_tail": (1, 36, 23, 37, 3),  # C not a multiple of 8: zero-filled channel tail
    "six_levels": (1, 32, 64, 96, 6),
}

INORM_CASES = [(1, 32, 220, 512), (1, 64, 220, 512), (2, 16, 24, 32)]


@pytest.mark.parametrize("case", sorted(VOLUME_CASES))
def test_k3_matches_plain(cuda_device, case):
    from raft_tpu_torch.kernels.corr_pallas import fused_volume_pyramid, volume_pyramid_reference

    b, c, h, w, levels = VOLUME_CASES[case]
    gen = torch.Generator(device="cpu").manual_seed(2)
    f1 = torch.randn(b, c, h, w, generator=gen).to(cuda_device)
    f2 = torch.randn(b, c, h, w, generator=gen).to(cuda_device)
    before = fused_volume_pyramid.launches
    got = fused_volume_pyramid(f1, f2, levels)
    torch.cuda.synchronize()
    assert fused_volume_pyramid.launches == before + 1
    want = volume_pyramid_reference(f1, f2, levels)
    assert len(got) == len(want) == levels
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        torch.testing.assert_close(g, w_, rtol=VOLUME_TOL, atol=VOLUME_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_matches_plain(cuda_device, case):
    from raft_tpu_torch.kernels.lookup_pallas import lookup_pyramid_pallas, lookup_pyramid_reference

    pyr, cents, radius = _inputs(case, cuda_device)
    before = lookup_pyramid_pallas.launches
    got = lookup_pyramid_pallas(pyr, cents, radius)
    torch.cuda.synchronize()
    assert lookup_pyramid_pallas.launches == before + 1
    torch.testing.assert_close(got, lookup_pyramid_reference(pyr, cents, radius), rtol=LOOKUP_TOL, atol=LOOKUP_TOL)


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("shape", INORM_CASES, ids=lambda s: "x".join(map(str, s)))
def test_k5_matches_plain(cuda_device, shape, relu):
    from raft_tpu_torch.kernels.inorm_pallas import instance_norm_pallas, instance_norm_reference

    gen = torch.Generator(device="cpu").manual_seed(4)
    x = (torch.randn(shape, generator=gen) * 3.0 + 1.5).to(cuda_device)
    before = instance_norm_pallas.launches
    got = instance_norm_pallas(x, relu=relu)
    torch.cuda.synchronize()
    assert instance_norm_pallas.launches == before + 1
    torch.testing.assert_close(got, instance_norm_reference(x, relu=relu), rtol=INORM_TOL, atol=INORM_TOL)
    xb = x.to(torch.bfloat16)
    gotb = instance_norm_pallas(xb, relu=relu)
    assert gotb.dtype == torch.bfloat16
    wantb = instance_norm_reference(xb, relu=relu).float()
    assert ((gotb.float() - wantb).abs() <= BF16_RTOL * wantb.abs() + 1e-6).all()


def test_slice_kernels_never_run_plain_version(cuda_device, monkeypatch):
    """On CUDA tensors K3, K4 and K5 launch their kernels: the plain
    versions are never called."""
    from raft_tpu_torch.kernels import corr_pallas, inorm_pallas, lookup_pallas

    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    for mod, name in [(corr_pallas, "volume_pyramid_reference"), (corr_pallas, "pool_pyramid"),
                      (corr_pallas, "correlation_volume"), (lookup_pallas, "lookup_pyramid_reference"),
                      (lookup_pallas, "lookup_pyramid"), (inorm_pallas, "instance_norm_reference"),
                      (inorm_pallas, "instance_norm")]:
        monkeypatch.setattr(mod, name, boom)
    f = torch.randn(1, 16, 16, 16, device=cuda_device)
    pyr = corr_pallas.fused_volume_pyramid(f, f, 3)
    cents = torch.rand(1, 16, 16, 2, device=cuda_device) * 16
    lookup_pallas.lookup_pyramid_pallas(pyr, cents, 3)
    inorm_pallas.instance_norm_pallas(f)
    torch.cuda.synchronize()


def test_pallas_model_matches_dense(cuda_device):
    """Same weights, pallas (K3 on the card) vs dense, narrow raft_small
    config, 3 updates; K3 launches once per pair."""
    from raft_tpu_torch.kernels.corr_pallas import fused_volume_pyramid

    narrow = dict(
        feature_encoder_widths=(8, 8, 12, 16, 32),
        context_encoder_widths=(8, 8, 12, 16, 40),
        motion_corr_widths=(16,),
        motion_flow_widths=(16, 8),
        motion_out_channels=20,
        gru_hidden=24,
        flow_head_hidden=16,
    )
    pallas = rt.build_raft(rt.RAFT_SMALL.replace(corr_impl="pallas", **narrow), device=cuda_device)
    with torch.no_grad():
        pallas.update_block.flow_head.conv2.weight.mul_(0.05)
    dense = rt.build_raft(rt.RAFT_SMALL.replace(corr_impl="dense", **narrow), device=cuda_device)
    dense.load_state_dict(pallas.state_dict())
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (123, 150, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (123, 150, 3), dtype=np.uint8)
    before = fused_volume_pyramid.launches
    got = rt.FlowEstimator(pallas, num_flow_updates=3)(a, b)
    assert fused_volume_pyramid.launches - before == 1
    want = rt.FlowEstimator(dense, num_flow_updates=3)(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("dstype", ["clean", "final"])
def test_golden_epe_pallas_on_the_card(cuda_device, dstype):
    """The trained fixture at corr_impl='pallas' on the card reproduces the
    reference EPE within 1e-3 px (tests/test_epe_golden.py's gate)."""
    import json
    import pathlib

    from raft_tpu_torch.checkpoint import load_msgpack, state_dict_from_flax
    from raft_tpu_torch.data import Sintel
    from raft_tpu_torch.eval import validate

    fixture = pathlib.Path(__file__).resolve().parent / "fixtures" / "epe_golden"
    expected = json.loads((fixture / "expected.json").read_text())
    arch = dict(
        feature_encoder_widths=(16, 16, 24, 32, 48), context_encoder_widths=(16, 16, 24, 32, 80),
        motion_corr_widths=(48,), motion_flow_widths=(32, 16), motion_out_channels=40, gru_hidden=48,
        flow_head_hidden=64, corr_levels=3, corr_radius=3,
    )
    model = rt.build_raft(rt.RAFT_SMALL.replace(corr_impl="pallas", **arch), device=cuda_device)
    model.load_state_dict(state_dict_from_flax(load_msgpack(str(fixture / "weights.msgpack"))), strict=True)
    m = validate(model, Sintel(str(fixture), dstype=dstype), num_flow_updates=32, fps_pairs=0)
    assert abs(m["epe"] - expected["reference"][dstype]) < 1e-3, m
