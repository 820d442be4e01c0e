"""The port's CUDA kernels on the card, against their plain PyTorch
versions. Every test carries the ``cuda`` marker and skips without a card.

This module imports neither JAX nor the JAX package and uses no fixture of
``tests/conftest.py``, so a card machine without the JAX package's
dependencies runs it with
``python -m pytest -m cuda --noconftest tests/test_torch_*.py`` (the JAX
parity modules skip themselves there).

Tolerances: 1e-5 for the taps of K2 and K4 (a 4-term fp32 bilinear sum per
tap, summed in another order than the plain version's matmuls; NaN exactly
where the plain version has it, NaN centroids included), 1e-4 for
the K1 projection (a 100-324-term fp32 dot per output) and the K3 volume
(a 32-256-term fp32 dot per cell), 1e-5 for K5 in fp32 and one bf16
rounding step for its bf16 I/O. The reduced-precision forms: K3's bf16
levels within the fp32 tolerance plus one bf16 ulp of each element (the
fp32 cell, summed in another order, may round the other way); bf16 outputs of K1 and K2 within
two bf16 ulps of their largest magnitude (a tap's fp32 x-combine, fused
into one rounding or not, may round a bf16 value the other way); K1's fp32
output from int8 levels within 1e-4 relative (its integer rows are exact).
No test sets a global TF32 flag: fp32 comparisons rest on the plain
versions' matmuls (IEEE fp32 by default) and on the model's own pin
(``device.fp32_precision``), which ``test_flow_ignores_global_tf32_flags``
checks.
"""

import math

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
    return torch.device("cuda")


# the reduced-precision K1 / K2 forms' edges: bf16 / int8 levels whose rows
# start unaligned (wl * elem % 4 != 0 at some level), centroids just outside
# every level and NaN (EDGE_CENTROIDS), raft_large widths at batch 8
LOWP_EDGE_CASES = {
    "unaligned_w13": (1, 11, 13, 4, 4, (-6.0, 19.0)),  # bf16 26-byte rows, int8 13
    "unaligned_w39": (1, 9, 39, 4, 4, (-6.0, 45.0)),  # levels 39, 19, 9, 4 wide
    "unaligned_w78": (2, 9, 78, 3, 4, (-5.0, 83.0)),  # int8 78-byte rows; r 3, C_in 196
    "edge_centroids": (2, 13, 39, 4, 4, (-6.0, 45.0)),
    "batch8_raft_large": (8, 55, 128, 4, 4, (-6.0, 134.0)),  # Q = 56320
}


def _inputs(case, device):
    b, h, w, radius, levels, (lo, hi) = {**CASES, **LOWP_EDGE_CASES}[case]
    gen = torch.Generator(device="cpu").manual_seed(0)
    f1 = torch.randn(b, 32, h, w, generator=gen).to(device)
    f2 = torch.randn(b, 32, h, w, generator=gen).to(device)
    pyr = corr.pool_pyramid(corr.correlation_volume(f1, f2), levels)
    cents = torch.rand(b, h, w, 2, generator=gen) * (hi - lo) + lo
    if case == "edge_centroids":
        # x and y at -r-2 and at the level-0 size + r + 1 (every window cell
        # outside), one cell inside either edge, and NaN
        cents[0, 0, :8, 0] = torch.tensor([-radius - 2.0, w + radius + 1.0, -radius - 1.0, w + radius,
                                           float("nan"), 3.0, -1.5, w + 0.5])
        cents[0, 0, :8, 1] = torch.tensor([4.0, 5.0, -radius - 2.0, h + radius + 1.0, 2.0, float("nan"),
                                           h + 0.5, -1.5])
        cents[1, -1, -4:] = torch.tensor([[-radius - 2.0, -radius - 2.0], [w + radius + 1.0, h + radius + 1.0],
                                          [float("nan"), float("nan")], [w - 1.0, h - 1.0]])
    return pyr, cents.to(device), radius


@pytest.mark.parametrize("case", sorted(CASES) + sorted(LOWP_EDGE_CASES))
def test_k2_matches_plain(cuda_device, case):
    pyr, cents, radius = _inputs(case, cuda_device)
    before = lookup_pyramid_fused.launches
    got = lookup_pyramid_fused(pyr, cents, radius)
    torch.cuda.synchronize()
    assert lookup_pyramid_fused.launches == before + 1
    want = lookup_pyramid_reference(pyr, cents, radius)
    # a NaN centroid gives NaN taps in the plain version: so must the kernel
    torch.testing.assert_close(got, want, rtol=LOOKUP_TOL, atol=LOOKUP_TOL, equal_nan=True)


@pytest.mark.parametrize("c_out", [256, 96, 48, 20])  # raft_large, raft_small, fixture, ragged
@pytest.mark.parametrize("case", sorted(CASES) + ["edge_centroids"])
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
    # a NaN centroid gives NaN taps, and the plain version a NaN output: so must the kernel
    torch.testing.assert_close(got, want, rtol=PROJECT_TOL, atol=PROJECT_TOL, equal_nan=True)


def test_cuda_path_never_runs_plain_version(cuda_device, monkeypatch):
    """On CUDA tensors the wrappers launch their kernels: the plain
    versions are never called."""
    pyr, cents, radius = _inputs("small", cuda_device)

    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    from raft_tpu_torch.kernels import lookup_pallas

    monkeypatch.setattr(lookup_xtap, "lookup_pyramid_reference", boom)
    monkeypatch.setattr(lookup_xtap, "lookup_project_reference", boom)
    monkeypatch.setattr(lookup_xtap, "lookup_pyramid", boom)
    monkeypatch.setattr(lookup_pallas, "lookup_pyramid_reference", boom)
    monkeypatch.setattr(lookup_pallas, "lookup_pyramid", boom)
    lookup_pyramid_fused(pyr, cents, radius)
    lookup_pallas.lookup_pyramid_pallas(pyr, cents, radius)
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
    "nan_features": (2, 128, 23, 37, 4),  # both NaN bit patterns in each map (_volume_inputs)
}

# (map, batch, channel, y, x, bits) of each NaN in the nan_features case: the
# card's own NaN (0x7fffffff, what a NaN computed on the card is), a host
# NaN (0x7fc00000) and a negative one (0xffffffff), the last query among them
NAN_FEATURES = [(0, 0, 5, 2, 3, 0x7FFFFFFF), (1, 0, 17, 10, 20, 0x7FC00000), (1, 1, 64, 22, 36, -1),
                (0, 1, 127, 22, 36, 0x7FC00000), (1, 1, 3, 0, 0, 0x7FFFFFFF)]


def _volume_inputs(case, device):
    b, c, h, w, levels = VOLUME_CASES[case]
    gen = torch.Generator(device="cpu").manual_seed(2)
    f1 = torch.randn(b, c, h, w, generator=gen)
    f2 = torch.randn(b, c, h, w, generator=gen)
    if case == "nan_features":
        for m, bb, ch, y, x, bits in NAN_FEATURES:
            (f1, f2)[m].view(torch.int32)[bb, ch, y, x] = bits
    return f1.to(device), f2.to(device), levels


def _assert_same_nans(got, want):
    """NaN exactly where the plain version has NaN."""
    assert torch.equal(got.isnan(), want.isnan()), f"{int((got.isnan() != want.isnan()).sum())} cells differ"


INORM_CASES = [(1, 32, 220, 512), (1, 64, 220, 512), (2, 16, 24, 32)]


@pytest.mark.parametrize("case", sorted(VOLUME_CASES))
def test_k3_matches_plain(cuda_device, case):
    from raft_tpu_torch.kernels.corr_pallas import fused_volume_pyramid, volume_pyramid_reference

    f1, f2, levels = _volume_inputs(case, cuda_device)
    before = fused_volume_pyramid.launches
    got = fused_volume_pyramid(f1, f2, levels)
    torch.cuda.synchronize()
    assert fused_volume_pyramid.launches == before + 1
    want = volume_pyramid_reference(f1, f2, levels)
    assert len(got) == len(want) == levels
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        _assert_same_nans(g, w_)
        torch.testing.assert_close(g, w_, rtol=VOLUME_TOL, atol=VOLUME_TOL, equal_nan=True)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(LOWP_EDGE_CASES) + ["wide_radius"])
def test_k4_matches_plain(cuda_device, case):
    from raft_tpu_torch.kernels.lookup_pallas import lookup_pyramid_pallas, lookup_pyramid_reference

    if case == "wide_radius":  # r 20 at 4 levels: a radius K4 takes and K2 does not (3364 taps a query)
        gen = torch.Generator(device="cpu").manual_seed(3)
        pyr = corr.pool_pyramid(corr.correlation_volume(
            torch.randn(1, 16, 9, 14, generator=gen), torch.randn(1, 16, 9, 14, generator=gen)), 4)
        pyr = [v.to(cuda_device) for v in pyr]
        cents, radius = (torch.rand(1, 9, 14, 2, generator=gen) * 40.0 - 13.0).to(cuda_device), 20
    else:
        pyr, cents, radius = _inputs(case, cuda_device)
    before = lookup_pyramid_pallas.launches
    got = lookup_pyramid_pallas(pyr, cents, radius)
    torch.cuda.synchronize()
    assert lookup_pyramid_pallas.launches == before + 1
    torch.testing.assert_close(got, lookup_pyramid_reference(pyr, cents, radius), rtol=LOOKUP_TOL, atol=LOOKUP_TOL,
                               equal_nan=True)


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


# -- reduced-precision forms of K1, K2 and K3 --------------------------------------

LOWP_CASES = ["small", "ragged_kitti", "batch2", "odd_dims", "raft_small_fused", "batch2_ragged_hw",
              *LOWP_EDGE_CASES]
LOWP_VOLUME_CASES = ["raft_small_sintel", "fixture", "kitti_ragged_q", "odd_dims", "five_levels", "six_levels",
                     "nan_features"]


def _bf16_ulps_of_max(want, n=2):
    """``n`` bf16 ulps of the largest magnitude of ``want`` (NaNs aside)."""
    top = want.float().nan_to_num(0.0, 0.0, 0.0).abs().max().item()
    return n * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def _lowp_pyramid(pyr, dtype):
    from raft_tpu_torch.kernels.lookup_xtap import quantize_pyramid

    if dtype == "int8":
        return quantize_pyramid(pyr)
    return [lvl.to(torch.bfloat16) for lvl in pyr]


@pytest.mark.parametrize("case", LOWP_VOLUME_CASES)
def test_k3_bf16_matches_plain(cuda_device, case):
    from raft_tpu_torch.kernels.corr_pallas import fused_volume_pyramid, volume_pyramid_reference

    f1, f2, levels = _volume_inputs(case, cuda_device)
    before = fused_volume_pyramid.launches
    got = fused_volume_pyramid(f1, f2, levels, torch.bfloat16)
    torch.cuda.synchronize()
    assert fused_volume_pyramid.launches == before + 1
    want = volume_pyramid_reference(f1, f2, levels, torch.bfloat16)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype == torch.bfloat16 and g.shape == w_.shape
        g, w_ = g.float(), w_.float()
        _assert_same_nans(g, w_)
        g, w_ = g.nan_to_num(0.0), w_.nan_to_num(0.0)
        # the fp32 cells agree within VOLUME_TOL; rounding each to bf16 adds
        # at most one bf16 ulp of the larger of the two (2^-7 relative)
        assert ((g - w_).abs() <= VOLUME_TOL + 2.0**-7 * torch.maximum(g.abs(), w_.abs())).all()


def test_k3_bf16_runs_wgmma(cuda_device):
    """K3's Hopper form (<= 4 levels) runs its products on wgmma: both
    instantiations of its kernel (bf16 and fp32 levels) hold HGMMA in their
    SASS, TF32, and no mma.sync (HMMA)."""
    import subprocess
    from pathlib import Path

    from raft_tpu_torch.kernels import build

    lib = build.build_all(["corr_pyramid"])["corr_pyramid"]
    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[-1].strip()
            fn = fn if "corr_pyramid_wgmma_kernel" in fn else None
            if fn:
                counts[fn] = {"HGMMA": 0, "TF32": 0, "HMMA": 0}
        elif fn:
            counts[fn]["HGMMA"] += "HGMMA" in line
            counts[fn]["TF32"] += "HGMMA" in line and "TF32" in line
            counts[fn]["HMMA"] += "HMMA" in line
    assert len(counts) == 2, f"expected a bf16 and an fp32 instantiation, found {list(counts)}"
    for fn, n in counts.items():
        assert n["HGMMA"] > 0 and n["TF32"] == n["HGMMA"] and n["HMMA"] == 0, (fn, n)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("case", LOWP_CASES)
def test_k2_lowp_matches_plain(cuda_device, case, dtype):
    pyr, cents, radius = _inputs(case, cuda_device)
    pyr = _lowp_pyramid(pyr, dtype)
    before = lookup_pyramid_fused.launches
    got = lookup_pyramid_fused(pyr, cents, radius)
    torch.cuda.synchronize()
    assert lookup_pyramid_fused.launches == before + 1
    want = lookup_pyramid_reference(pyr, cents, radius)
    assert got.dtype == want.dtype == torch.bfloat16
    tol = _bf16_ulps_of_max(want)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol, equal_nan=True)


def _offset_levels(levels, dtype):
    """Each level a contiguous view one element into a buffer of its own:
    off the 16-byte boundary the kernel's chunked window copies need (fp32 4
    bytes past it, bf16 2, int8 1)."""
    out = []
    for v in levels:
        buf = torch.zeros(v.numel() + 1, dtype=dtype, device=v.device)
        buf[1:] = v.reshape(-1).to(dtype)
        out.append(buf[1:].view(v.shape))
        assert out[-1].data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("case", ["small", "unaligned_w13", "unaligned_w39", "edge_centroids", "raft_small_fused"])
def test_k2_offset_levels(cuda_device, case, dtype):
    """K2 takes levels at any address: levels that start one element into
    a buffer (copied cell by cell) give the taps of the same levels at an
    aligned address (copied in 16-byte chunks), bit for bit, within the
    plain version's tolerance and with its NaNs."""
    from raft_tpu_torch.models.corr import QuantizedPyramid

    pyr, cents, radius = _inputs(case, cuda_device)
    aligned = pyr if dtype == "fp32" else _lowp_pyramid(pyr, dtype)
    if dtype == "int8":
        offset = QuantizedPyramid(_offset_levels(aligned, torch.int8), aligned.scales)
    else:
        offset = _offset_levels(aligned, torch.float32 if dtype == "fp32" else torch.bfloat16)
    before = lookup_pyramid_fused.launches
    got = lookup_pyramid_fused(offset, cents, radius)
    torch.cuda.synchronize()
    assert lookup_pyramid_fused.launches == before + 1
    want = lookup_pyramid_reference(offset, cents, radius)
    tol = LOOKUP_TOL if dtype == "fp32" else _bf16_ulps_of_max(want)
    torch.testing.assert_close(got.float(), want.float(), rtol=0 if dtype != "fp32" else LOOKUP_TOL, atol=tol,
                               equal_nan=True)
    same = lookup_pyramid_fused(aligned, cents, radius)
    torch.cuda.synchronize()
    bits = torch.int32 if dtype == "fp32" else torch.int16
    assert torch.equal(got.view(bits), same.view(bits))


@pytest.mark.parametrize("proj", ["fp32", "bf16"])
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("case", LOWP_CASES)
def test_k1_lowp_matches_plain(cuda_device, case, dtype, proj):
    pyr, cents, radius = _inputs(case, cuda_device)
    pyr = _lowp_pyramid(pyr, dtype)
    proj_dtype = torch.bfloat16 if proj == "bf16" else None
    c_in = len(pyr) * (2 * radius + 1) ** 2
    gen = torch.Generator(device="cpu").manual_seed(1)
    weight = (torch.randn(96, c_in, generator=gen) * 0.1).to(cuda_device)
    bias = torch.randn(96, generator=gen).to(cuda_device)
    before = lookup_project_fused.launches
    got = lookup_project_fused(pyr, cents, weight, bias, radius, proj_dtype)
    torch.cuda.synchronize()
    assert lookup_project_fused.launches == before + 1
    want = lookup_project_reference(pyr, cents, weight, bias, radius, proj_dtype)
    assert got.dtype == want.dtype == (proj_dtype or torch.float32)
    # a NaN centroid gives NaN taps, and the plain version a NaN output: so must the kernel
    if proj == "bf16":
        tol = _bf16_ulps_of_max(want)
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol, equal_nan=True)
    elif dtype == "int8":
        top = want.nan_to_num(0.0, 0.0, 0.0).abs().max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * top, equal_nan=True)
    else:
        torch.testing.assert_close(got, want, rtol=PROJECT_TOL, atol=PROJECT_TOL, equal_nan=True)


def test_int8_lookup_refuses_grad(cuda_device):
    from raft_tpu_torch.kernels.lookup_xtap import quantize_pyramid

    pyr, cents, radius = _inputs("small", cuda_device)
    pyr = quantize_pyramid(pyr)
    weight = torch.zeros(8, len(pyr) * (2 * radius + 1) ** 2, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="int8"):
        lookup_project_fused(pyr, cents, weight, torch.zeros(8, device=cuda_device), radius)


def _tf32_flags():
    return torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision


def test_flow_ignores_global_tf32_flags(cuda_device):
    """F2: with the TF32 flags at whatever torch's defaults are (cuDNN may
    use TF32 for fp32 convs), FlowEstimator's flow on the trained fixture
    equals a run with TF32 switched off globally, to 1e-6 px (cuDNN may
    pick another algorithm), the golden EPE holds, and the caller's flags
    are unchanged after each call."""
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
    model = rt.build_raft(rt.RAFT_SMALL.replace(corr_impl="fused", **arch), device=cuda_device)
    model.load_state_dict(state_dict_from_flax(load_msgpack(str(fixture / "weights.msgpack"))), strict=True)
    ds = Sintel(str(fixture), dstype="clean")
    est = rt.FlowEstimator(model, num_flow_updates=32, device=cuda_device)
    flags = _tf32_flags()
    default = [est(ds[i]["image1"], ds[i]["image2"]) for i in range(len(ds))]
    assert _tf32_flags() == flags
    m = validate(model, ds, num_flow_updates=32, fps_pairs=0)
    assert _tf32_flags() == flags
    assert abs(m["epe"] - expected["reference"]["clean"]) < 1e-3, m

    torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision = "ieee", "ieee"
    try:
        off = [est(ds[i]["image1"], ds[i]["image2"]) for i in range(len(ds))]
    finally:
        torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision = flags
    for a, b in zip(default, off):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# -- CUDA graphs: FlowEstimator and the serving pool's programs ---------------

TINY_SERVE = dict(
    feature_encoder_widths=(8, 8, 12, 16, 24), context_encoder_widths=(8, 8, 12, 16, 40),
    motion_corr_widths=(16,), motion_flow_widths=(16, 8), motion_out_channels=20, gru_hidden=24,
    flow_head_hidden=16, corr_levels=2, corr_radius=3, corr_impl="fused",
)


def _tiny_serving_model(device):
    model = rt.build_raft(rt.RAFT_SMALL.replace(**TINY_SERVE), device=device, seed=3)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.05)
    return model


def _leaves(state):
    return [*state["pyramid"], *(state[k] for k in ("coords1", "hidden", "context", "resid_hist", "converged"))]


def _assert_bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _eager_flow(est, im1, im2, iters):
    """``est``'s request with its model called eagerly, launch by launch:
    the same normalization, padding and input layout as its graph."""
    from raft_tpu_torch.eval.padder import InputPadder

    p1, p2 = est._normalize(im1), est._normalize(im2)
    padder = InputPadder(p1.shape, mode=est.pad_mode)
    p1, p2 = padder.pad(p1, p2)
    with torch.inference_mode():
        flow = est.model(est._to_device(p1), est._to_device(p2), num_flow_updates=iters, emit_all=False)
    return padder.unpad(est._to_host(flow))[0]


def test_flow_estimator_graph_matches_eager_bitwise(cuda_device):
    """FlowEstimator's replayed graph gives the eager flow bit for bit, on
    the first call (capture) and on replays; one graph per (shape, iters);
    K1 ran inside the graph (its per-replay launch count)."""
    from raft_tpu_torch.graphs import capture_events

    model = _tiny_serving_model(cuda_device)
    graphed = rt.FlowEstimator(model, num_flow_updates=3, device=cuda_device)
    rng = np.random.default_rng(11)
    pairs = [tuple(rng.integers(0, 255, (45, 60, 3), dtype=np.uint8) for _ in range(2)) for _ in range(3)]
    for a, b in pairs:
        np.testing.assert_array_equal(graphed(a, b), _eager_flow(graphed, a, b, 3))
    before = capture_events()
    np.testing.assert_array_equal(graphed(*pairs[0]), _eager_flow(graphed, *pairs[0], 3))
    assert capture_events() == before
    (prog,) = graphed.programs().values()
    assert prog.launches == {"lookup_project_fused": 3} and prog.replays == 4
    assert graphed.graph_launches() == {"lookup_project_fused": 12}


def _pool_state(progs, cap, bucket, rng, frozen=()):
    """A pool state holding ``cap`` admitted pairs, slots in ``frozen``
    marked converged."""
    from raft_tpu_torch.serve.pool import zero_state

    bh, bw = bucket
    state = zero_state(progs, cap, bucket)
    x1 = torch.from_numpy(rng.uniform(-1, 1, (cap, 3, bh, bw)).astype(np.float32)).to(progs.device)
    x2 = torch.from_numpy(rng.uniform(-1, 1, (cap, 3, bh, bw)).astype(np.float32)).to(progs.device)
    progs.insert(state, progs.begin_pair(x1, x2), np.arange(cap), np.ones(cap, bool))
    for s in frozen:
        state["converged"][s] = True
    return state, (x1, x2)


def _clone(state):
    from raft_tpu_torch.serve.pool import _map_state

    return _map_state(state, torch.clone)


def test_pool_programs_graph_match_eager_bitwise(cuda_device):
    """begin_pair, step (5 ticks, one slot frozen) and final replayed from
    their graphs equal the eager bodies bit for bit at capacity 3; the
    frozen slot passes through unchanged; K1 launches once per tick."""
    from raft_tpu_torch.serve.pool import PoolPrograms, zero_state

    model = _tiny_serving_model(cuda_device)
    bucket, cap = (48, 64), 3
    with torch.inference_mode():
        progs = PoolPrograms(model, cuda_device, resid_len=8)
        progs.set_knobs(0.0, 2, 1)
        eager_state, (x1, x2) = _pool_state(progs, cap, bucket, np.random.default_rng(5), frozen=(1,))
        _assert_bitwise(progs.run_begin_pair(x1, x2), progs.begin_pair(x1, x2))
        graphed_state = zero_state(progs, cap, bucket)
        progs.capture_step(graphed_state)  # its eager warm-up steps the zero state
        for g, e in zip(_leaves(graphed_state), _leaves(eager_state)):
            g.copy_(e)
        start = _clone(eager_state)
        for _ in range(5):
            want = progs.step(eager_state, progs.thresh, progs.streak, progs.min_iters)
            got = progs.run_step(graphed_state)
            assert torch.equal(got, want)
            _assert_bitwise(graphed_state, eager_state)
        for k in ("coords1", "hidden", "resid_hist"):
            assert torch.equal(graphed_state[k][1], start[k][1])
        c1, hid, _ = progs.gather(graphed_state["coords1"], graphed_state["hidden"], graphed_state["resid_hist"], [2, 0])
        assert torch.equal(progs.run_final(c1, hid), progs.final(c1, hid))
        torch.cuda.synchronize()
    step = progs.graphs()[("pool_step", cap, 6, 8)]
    assert step.launches == {"lookup_project_fused": 1} and step.replays == 5
    assert progs.counts()["pool_step"] == 1


def test_two_thresholds_through_one_step_graph(cuda_device):
    """Refilling ``thresh`` between replays changes which slots freeze,
    with no new capture."""
    from raft_tpu_torch.graphs import capture_events
    from raft_tpu_torch.serve.pool import PoolPrograms, unpack_converged, zero_state

    model = _tiny_serving_model(cuda_device)
    bucket, cap = (48, 64), 3
    with torch.inference_mode():
        progs = PoolPrograms(model, cuda_device, resid_len=8)
        state = zero_state(progs, cap, bucket)
        progs.capture_step(state)
        filled, _ = _pool_state(progs, cap, bucket, np.random.default_rng(7))
        for g, e in zip(_leaves(state), _leaves(filled)):
            g.copy_(e)
        before = capture_events()
        progs.set_knobs(0.0, 1, 1)  # off: nobody freezes
        assert not unpack_converged(progs.run_step(state).cpu(), cap).any()
        progs.set_knobs(1e9, 1, 1)  # every slot's residual is below it
        assert unpack_converged(progs.run_step(state).cpu(), cap).all()
        assert capture_events() == before


def test_failing_capture_raises_and_serves_nothing(cuda_device):
    """A host sync inside a captured program (a hook reading a value on
    the host) makes its capture fail: FlowEstimator raises, an engine
    warming up raises from start() and serves nothing, and an engine
    capturing on its worker fails the request with a ServeError."""
    from raft_tpu_torch.serve import EngineStopped, ServeConfig, ServeEngine, ServeError

    model = _tiny_serving_model(cuda_device)

    def host_sync(mod, inp, out):
        out[1].sum().item()

    handle = model.update_block.register_forward_hook(host_sync)
    try:
        rng = np.random.default_rng(2)
        a, b = (rng.integers(0, 255, (45, 60, 3), dtype=np.uint8) for _ in range(2))
        with pytest.raises(RuntimeError, match="CUDA graph"):
            rt.FlowEstimator(model, num_flow_updates=2, device=cuda_device)(a, b)
        cfg = dict(buckets=((48, 64),), ladder=(2, 1), pool_capacity=2, max_batch=2, default_deadline_ms=60000.0)
        engine = ServeEngine(model, ServeConfig(warmup=True, **cfg), device=cuda_device)
        with pytest.raises(RuntimeError, match="CUDA graph"):
            engine.start()
        with pytest.raises(EngineStopped):
            engine.submit(a, b)
        with ServeEngine(model, ServeConfig(**cfg), device=cuda_device) as lazy:
            with pytest.raises(ServeError, match="CUDA graph"):
                lazy.submit(a, b)
            assert lazy.stats()["completed"] == 0
    finally:
        handle.remove()
    torch.cuda.synchronize()


def test_slow_path_on_the_worker_beside_the_pool(cuda_device):
    """An off-bucket request under unknown_shape='slow_path' is captured
    and served on the worker while pool requests tick (the pool's graphs
    captured at warm-up): every flow matches the model's eager forward at
    its own shape and target, and the slow path's graph is the one capture
    after warm-up. 1e-4 px: the pool runs batch 3 against the reference's
    batch 1, and cuDNN's algorithm choices are the worker thread's, not
    this thread's."""
    from concurrent.futures import ThreadPoolExecutor

    from raft_tpu_torch.graphs import capture_events
    from raft_tpu_torch.serve import ServeConfig, ServeEngine
    from raft_tpu_torch.serve.bucketing import BucketRouter

    model = _tiny_serving_model(cuda_device)
    rng = np.random.default_rng(13)
    pairs = [tuple(rng.integers(0, 255, (45, 60, 3), dtype=np.uint8) for _ in range(2)) for _ in range(6)]
    pairs.append(tuple(rng.integers(0, 255, (60, 80, 3), dtype=np.uint8) for _ in range(2)))
    targets = (3, 3, 3, 2, 2, 2, 2)
    cfg = ServeConfig(buckets=((48, 64),), ladder=(3, 2, 1), pool_capacity=3, max_batch=3, warmup=True,
                      unknown_shape="slow_path", default_deadline_ms=120_000.0)
    with ServeEngine(model, cfg, device=cuda_device) as engine, ThreadPoolExecutor(len(pairs)) as ex:
        before = capture_events()
        results = list(ex.map(lambda i: engine.submit(*pairs[i], num_flow_updates=targets[i]), range(len(pairs))))
        stats = engine.stats()
    assert [r.slow_path for r in results] == [False] * 6 + [True]
    assert stats["slow_path"] == 1 and stats["completed"] == 7 and stats["pool_ticks"] >= 3
    assert capture_events() - before == 1 and stats["programs"]["pairwise"] == 1
    router = BucketRouter(((48, 64),))
    for (a, b), n, r in zip(pairs, targets, results):
        assert r.num_flow_updates == n and r.exit_reason == "target"
        shape = router.natural_shape(*a.shape[:2]) if r.slow_path else (48, 64)
        p1, p2 = (router.pad_to(rt.FlowEstimator._normalize(x), shape) for x in (a, b))
        x1, x2 = (torch.from_numpy(p).to(cuda_device).permute(0, 3, 1, 2) for p in (p1, p2))
        if not r.slow_path:
            x1, x2 = x1.contiguous(), x2.contiguous()
        with torch.inference_mode():
            want = model(x1, x2, num_flow_updates=n, emit_all=False)[0].permute(1, 2, 0).cpu().numpy()
        np.testing.assert_allclose(r.flow, want[: a.shape[0], : a.shape[1]], rtol=0, atol=1e-4)


# -- training on the card ------------------------------------------------------

# tests/test_train.py's tiny_cfg widths (raft_small, and raft_large with its
# BatchNorm context encoder), without importing the JAX package
TINY = dict(feature_encoder_widths=(8, 8, 12, 16, 24), context_encoder_widths=(8, 8, 12, 16, 40),
            motion_corr_widths=(16,), motion_flow_widths=(16, 8), motion_out_channels=20, gru_hidden=24,
            flow_head_hidden=16)
TINY_LARGE = dict(TINY, context_encoder_widths=(8, 8, 12, 16, 48), gru_hidden=32, corr_radius=2,
                  motion_corr_widths=(16, 12))


def _tiny_train_model(device, large=False, **over):
    cfg = (rt.RAFT_LARGE if large else rt.RAFT_SMALL).replace(**(TINY_LARGE if large else TINY), **over)
    model = rt.build_raft(cfg, device=device, seed=3)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(0.05)
    return model


def _train_batch(device, b=2, hw=128, seed=1):
    rng = np.random.default_rng(seed)
    arr = {"image1": rng.uniform(-1, 1, (b, 3, hw, hw)), "image2": rng.uniform(-1, 1, (b, 3, hw, hw)),
           "flow": rng.uniform(-5, 5, (b, 2, hw, hw)), "valid": (rng.random((b, hw, hw)) > 0.1)}
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arr.items()}


# the first step's whole gradient, card against CPU, in relative L2 norm:
# a factor ~4 from either reading on an H100 (IEEE fp32 backward 2.2e-6
# and 3.3e-6, small and large; TF32 backward 5.6e-5 and 8.6e-5)
GRAD_REL = 1.4e-5


def _train_steps(device, large, n, tf32_backward=False):
    """``n`` train steps of the tiny model from seed 3's weights: each
    step's metrics, the first step's gradients (recorded from the step's
    ``torch.autograd.grad`` call) and the parameters' updates, on the host.
    ``tf32_backward`` runs that call under TF32 settings for cuDNN's
    convolutions and cuBLAS's matmuls, inside the step's IEEE pin."""
    from raft_tpu_torch.train import TrainState, make_optimizer, make_train_step_fn, one_cycle_lr

    knobs = (torch.backends.cudnn.conv, torch.backends.cuda.matmul)
    real_grad = torch.autograd.grad
    grads = []

    def grad(*args, **kw):
        saved = [k.fp32_precision for k in knobs]
        if tf32_backward:
            for k in knobs:
                k.fp32_precision = "tf32"
        try:
            out = real_grad(*args, **kw)
        finally:
            for k, v in zip(knobs, saved):
                k.fp32_precision = v
        grads.append([g.detach().cpu().clone() for g in out])
        return out

    model = _tiny_train_model(device, large)
    initial = [p.detach().cpu().clone() for p in model.parameters()]
    tx = make_optimizer(one_cycle_lr(1e-4, 100))
    state = TrainState.create(model, tx)
    step = make_train_step_fn(model, tx, num_flow_updates=2)
    batch = _train_batch(device)
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.autograd, "grad", grad)
        for _ in range(n):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    updates = [p.detach().cpu() - p0 for p, p0 in zip(model.parameters(), initial)]
    return metrics, torch.cat([g.reshape(-1) for g in grads[0]]), updates


def _rel_l2(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("large", [False, True], ids=["small", "large"])
def test_train_step_on_card_matches_cpu(cuda_device, large):
    """Two train steps on the card against the port's own CPU steps from
    the same weights and batch: loss and EPE within 1e-5 relative,
    grad_norm 1e-4, the first step's whole gradient within ``GRAD_REL``
    in relative L2 norm, the parameters' updates 5e-2 in relative L2 norm
    over all parameters (tests/test_torch_train.py's bounds). The control:
    the card's first step again with TF32 allowed in its backward only
    must miss the gradient bound, so the bound tells an IEEE fp32 backward
    from a TF32 one (TF32 keeps 10 bits of an operand's mantissa)."""
    cpu_m, cpu_g, cpu_du = _train_steps(torch.device("cpu"), large, 2)
    card_m, card_g, card_du = _train_steps(cuda_device, large, 2)
    _, tf32_g, _ = _train_steps(cuda_device, large, 1, tf32_backward=True)
    err, tf32_err = _rel_l2(card_g, cpu_g), _rel_l2(tf32_g, cpu_g)
    print(f"gradient relative L2 vs CPU: IEEE fp32 {err:.3e}, TF32 backward {tf32_err:.3e}")
    for want, got in zip(cpu_m, card_m):
        for k in ("loss", "epe"):
            assert math.isclose(got[k], want[k], rel_tol=1e-5), (k, got[k], want[k])
        assert math.isclose(got["grad_norm"], want["grad_norm"], rel_tol=1e-4)
    assert err < GRAD_REL, err
    assert tf32_err > GRAD_REL, tf32_err
    a, b = torch.cat([d.reshape(-1) for d in card_du]), torch.cat([d.reshape(-1) for d in cpu_du])
    assert _rel_l2(a, b) < 5e-2


def test_remat_on_card(cuda_device):
    """remat=True on the card: the loss bit for bit and every gradient
    within 1e-4 relative L2 of remat=False's (cuDNN may pick another
    backward algorithm for a recomputed step), or within 1e-6 of the whole
    gradient's norm for a tensor whose gradient is rounding residue (a
    conv bias before a norm)."""
    from raft_tpu_torch.device import fp32_precision
    from raft_tpu_torch.train import sequence_loss

    batch = _train_batch(cuda_device)
    out = []
    for remat in (False, True):
        model = _tiny_train_model(cuda_device, True, remat=remat).train()
        with fp32_precision():
            preds = model(batch["image1"], batch["image2"], num_flow_updates=2)
            loss, _ = sequence_loss(preds, batch["flow"], batch["valid"])
            out.append((loss.detach(), torch.autograd.grad(loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    total = float(torch.stack([g.norm() for g in out[0][1]]).norm())
    for g0, g1 in zip(out[0][1], out[1][1]):
        assert float((g1 - g0).norm()) <= 1e-4 * float(g0.norm()) + 1e-6 * total


def test_bench_chain_graph_equals_eager(cuda_device):
    """The bench's graphed chain (``inference.flow_program``): a pair copied
    into its static buffers and replayed gives the eager model's flow on
    those buffers bit for bit (raft_small fused, bf16 pyramid and convs:
    the bench's raft_small headline, at a smaller frame)."""
    from raft_tpu_torch.inference import flow_program, run_flow

    model = rt.raft_small(corr_impl="fused", corr_dtype="bfloat16", compute_dtype="bfloat16", device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    pairs = torch.rand((3, 2, 1, 3, 128, 256), generator=gen, device=cuda_device) * 2 - 1
    with torch.inference_mode():
        prog = flow_program(model, pairs[0, 0].clone(), pairs[0, 1].clone(), num_flow_updates=6, name="test chain")
        prog()
        assert prog.captured
        for i in (1, 2):
            graphed = run_flow(prog, pairs[i, 0], pairs[i, 1]).clone()
            eager = model(*prog.inputs, num_flow_updates=6, emit_all=False)
            assert torch.isfinite(graphed).all() and torch.equal(graphed, eager)


def test_train_step_makes_no_host_sync(cuda_device):
    """After a warm-up step, a train step under ``torch.cuda``'s sync debug
    mode 'error' (any synchronizing call raises): the step leaves its
    metrics on the card, and the skip guard chooses there too."""
    from raft_tpu_torch.train import TrainState, make_optimizer, make_train_step_fn, one_cycle_lr

    model = _tiny_train_model(cuda_device, True)
    tx = make_optimizer(one_cycle_lr(1e-4, 100))
    state = TrainState.create(model, tx)
    step = make_train_step_fn(model, tx, num_flow_updates=2, numerics_policy="skip", spike_factor=20.0,
                              check_numerics=True)
    batch = _train_batch(cuda_device)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.is_cuda for v in metrics.values())
    assert float(metrics["skipped"]) == 0.0 and int(state.step) == 2
