"""The port's K3, K4 and K5 wrappers on the CPU (their plain versions)
against the JAX package's Pallas kernels run in interpret mode, plus the
wrappers' argument checks. The kernels themselves are held against their
plain versions on the card in ``tests/test_torch_cuda.py``.

Tolerances: 1e-5 for K3 (a 16-48-term fp32 dot per cell, summed in
another order, then exact-order 2x2 means), 1e-5 for K4 (two 2-term fp32
interpolations per tap) and K5 in fp32 (sums over H*W in another order);
bf16 I/O of K5 may differ by one bf16 rounding step (2^-7 relative).
``TestK3Arithmetic`` emulates K3's 3xTF32 tensor-core arithmetic on the
CPU against a tenth of the card's K3 tolerance.
"""

import math

import numpy as np
import pytest
import torch

# a card machine may lack the JAX package's dependencies (it has jax but no
# flax): these modules then skip as a whole
pytest.importorskip("raft_tpu")

import jax.numpy as jnp  # noqa: E402

from raft_tpu.kernels.corr_pallas import PallasCorrBlock as JaxPallasCorrBlock
from raft_tpu.kernels.corr_pallas import fused_volume_pyramid as jax_fused_volume_pyramid
from raft_tpu.kernels.inorm_pallas import instance_norm_pallas as jax_instance_norm_pallas
from raft_tpu.kernels.lookup_pallas import lookup_pyramid_pallas as jax_lookup_pyramid_pallas
from raft_tpu.models import corr as jcorr

from raft_tpu_torch.kernels import corr_pallas, inorm_pallas, lookup_pallas
from raft_tpu_torch.kernels.corr_pallas import PallasCorrBlock, fused_volume_pyramid, level_dims
from raft_tpu_torch.kernels.inorm_pallas import instance_norm_pallas
from raft_tpu_torch.kernels.lookup_pallas import lookup_pyramid_pallas
from raft_tpu_torch.models import corr

torch.set_num_threads(2)

TOL = 1e-5
BF16_RTOL = 2.0**-7


def _fmaps(rng, b, h, w, c):
    """NHWC numpy feature maps for the JAX side."""
    return (
        rng.normal(size=(b, h, w, c)).astype(np.float32),
        rng.normal(size=(b, h, w, c)).astype(np.float32),
    )


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


class TestVolumePyramidK3:
    @pytest.mark.parametrize(
        "b,h,w,c,levels",
        [
            (1, 8, 12, 16, 1),
            (1, 16, 20, 24, 3),
            (1, 18, 22, 16, 3),  # odd tails: 18x22 -> 9x11 -> 4x5
            (1, 10, 13, 8, 2),  # Q = 130: ragged against the JAX tile of 128
            (2, 12, 16, 16, 3),
        ],
        ids=["l1", "l3", "odd_tails", "ragged_q", "batch2"],
    )
    def test_matches_jax_kernel(self, rng, b, h, w, c, levels):
        f1, f2 = _fmaps(rng, b, h, w, c)
        want = jax_fused_volume_pyramid(jnp.asarray(f1), jnp.asarray(f2), levels, interpret=True)
        got = fused_volume_pyramid(_nchw(f1), _nchw(f2), levels)
        assert len(got) == len(want) == levels
        for g, w_, (hl, wl) in zip(got, want, level_dims(h, w, levels)):
            assert tuple(g.shape) == (b * h * w, hl, wl) == w_.shape[:3]
            np.testing.assert_allclose(g.numpy(), np.asarray(w_)[..., 0], rtol=TOL, atol=TOL)

    def test_block_build_and_index_match_jax_block(self, rng):
        f1, f2 = _fmaps(rng, 2, 16, 20, 16)
        cents = rng.uniform(-4.0, 24.0, (2, 16, 20, 2)).astype(np.float32)
        jblk = JaxPallasCorrBlock(num_levels=3, radius=3, interpret=True)
        want = jblk.index_pyramid(jblk.build_pyramid(jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(cents))
        blk = PallasCorrBlock(3, 3)
        got = blk.index_pyramid(blk.build_pyramid(_nchw(f1), _nchw(f2)), torch.from_numpy(cents))
        assert tuple(got.shape) == want.shape == (2, 16, 20, 3 * 49)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    def test_block_equals_dense_block_and_keeps_size_check(self, rng):
        f1, f2 = (_nchw(f) for f in _fmaps(rng, 1, 16, 16, 8))
        dense, pallas = corr.CorrBlock(4, 3), PallasCorrBlock(4, 3)
        for a, b_ in zip(pallas.build_pyramid(f1, f2), dense.build_pyramid(f1, f2)):
            torch.testing.assert_close(a, b_, rtol=0, atol=0)
        with pytest.raises(ValueError, match="too small"):
            pallas.build_pyramid(f1[:, :, :8], f2[:, :, :8])

    def test_level_dims_drop_odd_tails(self):
        assert level_dims(55, 128, 4) == [(55, 128), (27, 64), (13, 32), (6, 16)]
        assert level_dims(12, 17, 3) == [(12, 17), (6, 8), (3, 4)]
        assert level_dims(45, 99, 4) == [(45, 99), (22, 49), (11, 24), (5, 12)]

    def test_rejects_what_the_kernel_does_not_take(self):
        f = torch.zeros(1, 8, 16, 16)
        with pytest.raises(TypeError, match="float32"):
            fused_volume_pyramid(f.double(), f.double(), 2)
        with pytest.raises(ValueError, match="contiguous"):
            fused_volume_pyramid(f.transpose(2, 3), f.transpose(2, 3), 2)
        with pytest.raises(ValueError, match="levels"):
            fused_volume_pyramid(f, f, corr_pallas.MAX_LEVELS + 1)
        with pytest.raises(ValueError, match="empty level"):
            fused_volume_pyramid(f[:, :, :3], f[:, :, :3], 3)
        with pytest.raises(ValueError, match="one shape"):
            fused_volume_pyramid(f, f[:, :4], 2)

    def test_grad_raises_and_cpu_counts_no_launch(self):
        f = torch.zeros(1, 8, 16, 16, requires_grad=True)
        with pytest.raises(RuntimeError, match="inference-only"):
            fused_volume_pyramid(f, f, 2)
        before = fused_volume_pyramid.launches
        with torch.no_grad():
            out = fused_volume_pyramid(f, f, 2)
        assert [tuple(o.shape) for o in out] == [(256, 16, 16), (256, 8, 8)]
        assert fused_volume_pyramid.launches == before


VOLUME_TOL = 1e-4  # K3 against its plain version on the card (tests/test_torch_cuda.py)


def _tf32(x):
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, by adding half a TF32 ulp (0x1000) to the bits and
    clearing the 13 low mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _volume(a, b):
    """``a^T b / sqrt(C)`` per batch element as ``(B, Q, h, w)``, fp32 sums."""
    n, c, h, w = a.shape
    vol = torch.matmul(a.reshape(n, c, h * w).transpose(1, 2), b.reshape(n, c, h * w))
    return (vol * (1.0 / math.sqrt(c))).reshape(n, h * w, h, w)


def _features(c, gain):
    """Two seeded (1, c, 16, 20) feature maps, normal times ``gain``."""
    rng = np.random.default_rng(c)
    return (torch.from_numpy((rng.normal(size=(1, c, 16, 20)) * gain).astype(np.float32)) for _ in range(2))


def _volume_3xtf32(f1, f2):
    """K3's tensor-core arithmetic: each operand split once into
    hi = tf32(x) and lo = tf32(x - hi); lo*hi + hi*lo, then hi*hi, summed
    in fp32 (the card interleaves the three per 8 channels)."""
    a_hi, b_hi = _tf32(f1), _tf32(f2)
    a_lo, b_lo = _tf32(f1 - a_hi), _tf32(f2 - b_hi)
    return (_volume(a_lo, b_hi) + _volume(a_hi, b_lo)) + _volume(a_hi, b_hi)


class TestK3Arithmetic:
    """Why K3 splits each operand for the tensor cores: 3xTF32 stays within
    a tenth of the card tolerance of the fp32 plain version, one TF32 pass
    does not meet it. The emulation lives here, not in the package.

    VOLUME_TOL is stated for unit-variance features. Features scaled by
    ``gain`` scale the volume, and the fp32 rounding of the plain version
    itself, by ``gain**2``, so the absolute tolerance is taken in that unit.
    """

    def test_tf32_rounding_is_round_to_nearest_ties_away(self):
        ulp = 2.0**-10  # TF32 keeps 10 mantissa bits
        x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2.0**-23, -(1 + ulp / 2), 3 * ulp / 4 + 1, 0.0, -2.5])
        want = torch.tensor([1 + ulp, 1.0, -(1 + ulp), 1 + ulp, 0.0, -2.5])
        assert torch.equal(_tf32(x), want)
        v = torch.from_numpy(np.random.default_rng(3).normal(size=4096).astype(np.float32)) * 100
        hi = _tf32(v)
        lo = _tf32(v - hi)
        assert ((hi + lo - v).abs() <= 2.0**-21 * v.abs()).all()

    @pytest.mark.parametrize("gain", [1.0, 10.0], ids=["unit", "x10"])
    @pytest.mark.parametrize("c", [128, 256])
    def test_3xtf32_matches_fp32_plain_version(self, c, gain):
        f1, f2 = _features(c, gain)
        want = corr_pallas.volume_pyramid_reference(f1, f2, 4)
        got = corr.pool_pyramid(_volume_3xtf32(f1, f2), 4)
        for g, w_ in zip(got, want):
            torch.testing.assert_close(g, w_, rtol=VOLUME_TOL / 10, atol=VOLUME_TOL / 10 * gain**2)

    @pytest.mark.parametrize("gain", [1.0, 10.0], ids=["unit", "x10"])
    @pytest.mark.parametrize("c", [128, 256])
    def test_one_tf32_pass_misses_the_tolerance(self, c, gain):
        f1, f2 = _features(c, gain)
        want = corr_pallas.volume_pyramid_reference(f1, f2, 1)[0]
        got = _volume(_tf32(f1), _tf32(f2)).reshape(want.shape)
        assert not torch.allclose(got, want, rtol=VOLUME_TOL, atol=VOLUME_TOL * gain**2)


class TestLookupK4:
    @pytest.mark.parametrize(
        "radius,levels,lo,hi",
        [(1, 4, -3.0, 27.0), (4, 4, -6.0, 30.0), (4, 3, -500.0, 600.0), (3, 2, -2.0, 26.0)],
        ids=["r1", "r4", "far_out", "r3l2"],
    )
    def test_matches_jax_kernel(self, rng, radius, levels, lo, hi):
        f1, f2 = _fmaps(rng, 1, 16, 24, 8)
        cents = rng.uniform(lo, hi, (1, 16, 24, 2)).astype(np.float32)
        jpyr = jcorr.pool_pyramid(jcorr.correlation_volume(jnp.asarray(f1), jnp.asarray(f2)), levels)
        want = jax_lookup_pyramid_pallas(jpyr, jnp.asarray(cents), radius, interpret=True)
        pyr = corr.pool_pyramid(corr.correlation_volume(_nchw(f1), _nchw(f2)), levels)
        got = lookup_pyramid_pallas(pyr, torch.from_numpy(cents), radius)
        assert tuple(got.shape) == want.shape == (1, 16, 24, levels * (2 * radius + 1) ** 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    def test_checks_and_cpu_counts_no_launch(self):
        pyr = [torch.zeros(20, 4, 5), torch.zeros(20, 2, 2)]
        cents = torch.zeros(1, 4, 5, 2)
        with pytest.raises(TypeError, match="float32"):
            lookup_pyramid_pallas(pyr, cents.double(), 2)
        with pytest.raises(ValueError, match="level 1"):
            lookup_pyramid_pallas([pyr[0], pyr[1][:3]], cents, 2)
        with pytest.raises(ValueError, match="shared memory"):
            lookup_pyramid_pallas(pyr, cents, 60)
        with pytest.raises(RuntimeError, match="inference-only"):
            lookup_pyramid_pallas(pyr, cents.requires_grad_(), 2)
        before = lookup_pyramid_pallas.launches
        assert tuple(lookup_pyramid_pallas(pyr, cents.detach(), 2).shape) == (1, 4, 5, 50)
        assert lookup_pyramid_pallas.launches == before
        # a large radius the K1/K2 tile would refuse still fits K4's warps
        assert lookup_pallas._smem_bytes(4, 12) < 232448


class TestInstanceNormK5:
    @pytest.mark.parametrize(
        "shape,relu",
        [((2, 20, 32, 16), False), ((1, 22, 48, 24), True), ((2, 16, 24, 32), True)],
        ids=["b2", "relu_rows22", "relu_b2"],
    )
    def test_matches_jax_kernel_fp32(self, rng, shape, relu):
        x = (rng.normal(size=shape) * 3.0 + 1.5).astype(np.float32)  # NHWC
        want = jax_instance_norm_pallas(jnp.asarray(x), relu=relu, interpret=True)
        got = instance_norm_pallas(_nchw(x), relu=relu)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=TOL, atol=TOL
        )

    def test_bf16_io_within_one_rounding_step(self, rng):
        x = rng.normal(size=(1, 16, 32, 24)).astype(np.float32)
        want = np.asarray(
            jax_instance_norm_pallas(jnp.asarray(x).astype(jnp.bfloat16), interpret=True), np.float32
        )
        got = instance_norm_pallas(_nchw(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        got = got.float().permute(0, 2, 3, 1).numpy()
        assert np.all(np.abs(got - want) <= BF16_RTOL * np.abs(want) + 1e-6)

    def test_clamps_negative_variance(self):
        """A constant channel has variance 0; rounding may make E[x^2] -
        E[x]^2 negative, which the clamp turns into rsqrt(eps)."""
        x = torch.full((1, 2, 8, 8), 3.3)
        out = instance_norm_pallas(x, relu=True)
        assert torch.isfinite(out).all() and out.abs().max() < 1e-2

    def test_checks_and_cpu_counts_no_launch(self):
        with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
            instance_norm_pallas(torch.zeros(2, 3, 4))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            instance_norm_pallas(torch.zeros(1, 2, 3, 4, dtype=torch.float64))
        with pytest.raises(ValueError, match="contiguous"):
            instance_norm_pallas(torch.zeros(1, 2, 4, 4).transpose(2, 3))
        before = instance_norm_pallas.launches
        instance_norm_pallas(torch.randn(1, 2, 4, 4))
        assert instance_norm_pallas.launches == before

    @pytest.mark.parametrize(
        "rows,hw,split", [(32, 220 * 512, 16), (64, 220 * 512, 8), (32, 768, 1), (1, 4096, 2), (1, 1 << 20, 512)]
    )
    def test_split_keeps_the_card_busy(self, rows, hw, split):
        assert inorm_pallas.split_for(rows, hw) == split
