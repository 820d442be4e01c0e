"""The port's K3, K4 and K5 wrappers on the CPU (their plain versions)
against the JAX package's Pallas kernels run in interpret mode, plus the
wrappers' argument checks. The kernels themselves are held against their
plain versions on the card in ``tests/test_torch_cuda.py``.

Tolerances: 1e-5 for K3 (a 16-48-term fp32 dot per cell, summed in
another order, then exact-order 2x2 means), 1e-5 for K4 (two 2-term fp32
interpolations per tap) and K5 in fp32 (sums over H*W in another order);
bf16 I/O of K5 may differ by one bf16 rounding step (2^-7 relative).
``TestK3Arithmetic`` and ``TestK1Arithmetic`` emulate the 3xTF32
tensor-core arithmetic of K3 and K1 on the CPU against a tenth of the
card's tolerance, and K3's NaN-safe TF32 split; ``TestK3Tile`` and
``TestK1Tile`` check the wrappers' view of K3's and K1's tiles,
``TestK2Tile`` of K2's and K4's plan and tile store.
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

from raft_tpu_torch.kernels import corr_pallas, inorm_pallas, lookup_pallas, lookup_xtap
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


def _split_tf32(x):
    """K3's split (``split_tf32``): hi = tf32(x), or 0x7fc00000 where x is
    NaN, and lo = tf32(x - hi)."""
    hi = torch.where(x.isnan(), torch.tensor(0x7FC00000, dtype=torch.int32).view(torch.float32), _tf32(x))
    return hi, _tf32(x - hi)


def _bits(*words):
    return torch.tensor([w - (1 << 32) if w >= 1 << 31 else w for w in words], dtype=torch.int32).view(torch.float32)


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

    def test_integer_rounding_carries_a_nan_into_the_sign_bit(self):
        """The fault the split repairs (F5): the card's NaN, 0x7fffffff, and
        its negative, 0xffffffff, carry into the sign bit, so the rounding
        makes them -0 and +0; so it does the lo of the split."""
        got = _tf32(_bits(0x7FFFFFFF, 0xFFFFFFFF)).view(torch.int32).tolist()
        assert got == [-(1 << 31), 0]  # 0x80000000 (-0) and 0x00000000 (+0)
        hi = _tf32(_bits(0x7FFFFFFF))
        assert not hi.isnan().any() and not _tf32(_bits(0x7FFFFFFF) - hi).isnan().any()

    def test_split_keeps_nan_and_every_other_value(self):
        """The repaired split: a NaN's hi is 0x7fc00000, a NaN for the tensor
        cores (its 19 high bits), so every product with it is NaN; finite
        values, subnormals, values that round up to +-inf and the infinities
        split bit for bit as before."""
        nans = _bits(0x7FFFFFFF, 0xFFFFFFFF, 0x7FC00000, 0xFFC00000, 0x7F800001)
        hi, _ = _split_tf32(nans)
        assert (hi.view(torch.int32) == 0x7FC00000).all()
        assert _tf32(hi).isnan().all()  # still NaN once the tensor cores drop its 13 low bits
        rng = np.random.default_rng(5)
        finite = np.concatenate([
            rng.normal(size=2048).astype(np.float32) * 10.0 ** rng.integers(-30, 30, 2048),
            rng.integers(1, 1 << 23, 512).astype(np.uint32).view(np.float32),  # positive subnormals
            (rng.integers(1, 1 << 23, 512).astype(np.uint32) | (1 << 31)).view(np.float32),  # negative ones
            np.array([0.0, -0.0, np.finfo(np.float32).max, -np.finfo(np.float32).max], np.float32),
            np.array([0x7F7FF000, 0x7F7FFFFF, 0xFF7FF000], np.uint32).view(np.float32),  # round up to +-inf
            np.array([np.inf, -np.inf], np.float32),
        ])
        x = torch.from_numpy(finite.astype(np.float32))
        hi, lo = _split_tf32(x)
        old_hi = _tf32(x)
        assert torch.equal(hi.view(torch.int32), old_hi.view(torch.int32))
        assert torch.equal(lo.view(torch.int32), _tf32(x - old_hi).view(torch.int32))
        assert _tf32(_bits(0x7F7FF000)).isinf().all()  # the round-up case is in the set

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


class TestK3Tile:
    """The wrapper's view of K3's Hopper-form block (``_hopper_tile``,
    ``_workspace_bytes``; the ``kH*`` constants and ``launch_hopper``'s
    tensor maps in ``csrc/corr_pyramid.cu``): shared memory, TMA boxes, the
    workspace, and which pyramids take the block."""

    # tests/test_torch_cuda.py's VOLUME_CASES, (b, c, h, w, levels), and
    # whether the Hopper form runs them (<= 4 levels) or the mma.sync form
    VOLUME_CASES = {
        "raft_small_sintel": ((1, 128, 55, 128, 4), True),
        "raft_large_sintel": ((1, 256, 55, 128, 4), True),
        "fixture": ((1, 48, 12, 17, 3), True),
        "kitti_ragged_q": ((1, 128, 47, 156, 4), True),
        "batch2": ((2, 128, 55, 128, 4), True),
        "odd_dims": ((1, 128, 45, 99, 4), True),
        "one_level": ((1, 32, 9, 13, 1), True),
        "five_levels": ((1, 32, 40, 48, 5), False),
        "channel_tail": ((1, 36, 23, 37, 3), True),
        "six_levels": ((1, 32, 64, 96, 6), False),
        "nan_features": ((2, 128, 23, 37, 4), True),
    }

    @pytest.mark.parametrize("levels", [1, 2, 3, 4])
    def test_two_blocks_fit_an_sm(self, levels):
        """The ring (or, after the products, the epilogue tile and the
        pooled levels) fits a block, and two blocks an SM with their 48
        bytes of barriers and 1 KB reserved each."""
        t = corr_pallas._hopper_tile(levels)
        assert t.queries == 128 and t.band_rows * t.band_cols == 128 and t.band_rows == 2 ** (levels - 1)
        assert t.smem_bytes <= 232_448
        assert 2 * (t.smem_bytes + 48 + 1024) <= 228 * 1024
        assert t.smem_bytes >= t.stages * 4 * t.queries * t.channels * 4 + 1024

    @pytest.mark.parametrize("levels", [1, 2, 3, 4])
    def test_tma_boxes(self, levels):
        """Every box dimension within TMA's 256, the inner one a multiple of
        16 bytes within the 64-byte swizzle's span; an A or B box is 8 KB,
        a band of R rows by TW columns."""
        t = corr_pallas._hopper_tile(levels)
        for box in (t.box_a, t.box_b):
            assert all(1 <= d <= 256 for d in box)
            assert box[0] * 4 % 16 == 0 and box[0] * 4 <= 64
            assert math.prod(box) * 4 == 8192
        assert t.box_a[:2] == (t.channels, t.queries)
        assert t.box_b[:3] == (t.channels, t.band_cols, t.band_rows)

    def test_workspace_size(self):
        """Both maps' hi and lo halves, [B][Q][Cp] fp32, Cp = C rounded up to 4."""
        assert corr_pallas._workspace_bytes(1, 128, 55, 128, 4) == 14_417_920  # raft_small Sintel: 14.4 MB
        assert corr_pallas._workspace_bytes(1, 256, 55, 128, 4) == 28_835_840
        assert corr_pallas._workspace_bytes(2, 36, 23, 37, 3) == 4 * 2 * 851 * 36 * 4
        assert corr_pallas._workspace_bytes(1, 30, 23, 37, 3) == 4 * 851 * 32 * 4
        assert corr_pallas._workspace_bytes(1, 32, 40, 48, 5) == 0  # the mma.sync form takes none

    @pytest.mark.parametrize("case", sorted(VOLUME_CASES))
    def test_which_pyramids_take_the_hopper_form(self, case):
        (b, c, h, w, levels), hopper = self.VOLUME_CASES[case]
        assert (corr_pallas._hopper_tile(levels) is not None) == hopper
        assert (corr_pallas._workspace_bytes(b, c, h, w, levels) > 0) == hopper


PROJECT_TOL = 1e-4  # K1 against its plain version on the card (tests/test_torch_cuda.py)


def _project_3xtf32(taps, weight, bias):
    """K1's tensor-core arithmetic: taps and weight split once into
    hi = tf32(x) and lo = tf32(x - hi); lo*hi + hi*lo, then hi*hi, summed in
    fp32 (the card interleaves the three per 8 channels), then bias + relu."""
    a_hi, w_hi = _tf32(taps), _tf32(weight)
    a_lo, w_lo = _tf32(taps - a_hi), _tf32(weight - w_hi)
    return torch.relu(((a_lo @ w_hi.t() + a_hi @ w_lo.t()) + a_hi @ w_hi.t()) + bias)


class TestK1Arithmetic:
    """Why K1 splits each operand for the tensor cores, at a reduced K1
    shape (512 queries x C_in 324 x C_out 256, raft_large's widths):
    3xTF32 stays within a tenth of the card tolerance of the fp32 plain
    projection, one TF32 pass misses it. Unit-normal taps (the scale of a
    1/sqrt(C) correlation) and He-scaled weights, seeded."""

    @staticmethod
    def _operands():
        rng = np.random.default_rng(324)
        taps = torch.from_numpy(rng.normal(size=(512, 324)).astype(np.float32))
        weight = torch.from_numpy((rng.normal(size=(256, 324)) * math.sqrt(2.0 / 256)).astype(np.float32))
        bias = torch.from_numpy((rng.normal(size=256) * 0.05).astype(np.float32))
        return taps, weight, bias

    def test_3xtf32_matches_fp32_plain_version(self):
        taps, weight, bias = self._operands()
        want = corr.project_taps(taps, weight, bias)
        got = _project_3xtf32(taps, weight, bias)
        torch.testing.assert_close(got, want, rtol=PROJECT_TOL / 10, atol=PROJECT_TOL / 10)

    def test_one_tf32_pass_misses_the_tolerance(self):
        taps, weight, bias = self._operands()
        want = corr.project_taps(taps, weight, bias)
        got = torch.relu(_tf32(taps) @ _tf32(weight).t() + bias)
        assert not torch.allclose(got, want, rtol=PROJECT_TOL, atol=PROJECT_TOL)


class TestK1Tile:
    """The wrapper's view of K1's block tile (``project_smem`` in
    ``csrc/lookup_xtap.cu``): K padding, shared-memory bytes, levels a pass
    and weight slices in flight during the gather, per level storage and
    product."""

    @pytest.mark.parametrize("c_in,k_pad", [(324, 328), (196, 200), (147, 152), (54, 56), (8, 8), (1, 8)])
    def test_k_pads_to_the_mma_step(self, c_in, k_pad):
        assert lookup_xtap._project_k_pad(c_in) == k_pad

    @pytest.mark.parametrize("c_in,k_pad", [(324, 336), (196, 208), (147, 160), (54, 64), (8, 16), (1, 16)])
    def test_bf16_product_pads_to_the_k16_step(self, c_in, k_pad):
        assert lookup_xtap._project_k_pad(c_in, bf16_product=True) == k_pad

    # (levels, radius) -> storage -> product -> (bytes, levels a pass, slices in flight during the gather)
    LAYOUTS = {
        "raft_large": ((4, 4), {"fp32": ((108032, 4, 0), (108032, 4, 0)), "bf16": ((108032, 4, 1), (108032, 4, 2)),
                                "int8": ((108032, 4, 2), (108032, 4, 3))}),
        "raft_small_fused": ((4, 3), {"fp32": ((91648, 7, 0), (99840, 4, 0)), "bf16": ((91648, 4, 2), (99840, 4, 3)),
                                      "int8": ((91648, 4, 2), (99840, 4, 3))}),
        "fixture": ((3, 3), {"fp32": ((85504, 7, 0), (96768, 3, 0)), "bf16": ((85504, 3, 2), (96768, 3, 3)),
                             "int8": ((85504, 3, 2), (96768, 3, 3))}),
        "r1_l6": ((6, 1), {"fp32": ((73216, 30, 0), (90624, 6, 0)), "bf16": ((73216, 6, 2), (90624, 6, 3)),
                           "int8": ((73216, 6, 2), (90624, 6, 3))}),
    }

    # one case per (shape, storage, product); the fp32 form keeps the shape's own id
    CASES = [(shape, storage, bf16) for shape in LAYOUTS for storage in ("fp32", "bf16", "int8") for bf16 in (0, 1)]

    @pytest.mark.parametrize(
        "shape,storage,bf16_product", CASES,
        ids=[c[0] if c[1:] == ("fp32", 0) else f"{c[0]}-{c[1]}-{'bf16' if c[2] else '3xtf32'}" for c in CASES],
    )
    def test_two_blocks_fit_an_sm_at_the_model_shapes(self, shape, storage, bf16_product):
        """Every form at every model shape keeps two blocks an SM; the fp32
        form's layout is the one it had (windows over the ring, no slice in
        flight), the bf16 / int8 forms keep 1-3 weight slices in flight
        while their taps are formed."""
        (levels, radius), forms = self.LAYOUTS[shape]
        elem = {"fp32": 4, "bf16": 2, "int8": 1}[storage]
        want = forms[storage][int(bf16_product)]
        got = lookup_xtap._project_layout(levels, radius, elem, bf16_product)
        assert got == want
        assert lookup_xtap._project_smem_bytes(levels, radius, elem, bf16_product) == want[0]
        assert 2 * (got[0] + 1024) <= 228 * 1024  # two blocks an SM, 1 KB reserved a block
        assert (got[2] > 0) == (storage != "fp32")

    def test_rows_are_4_mod_8_floats(self):
        for c_in in (324, 196, 147, 54):
            lda = lookup_xtap._project_k_pad(c_in) + 4
            assert lda % 8 == 4  # conflict-free m16n8k8 A fragments
            lda_words = (lookup_xtap._project_k_pad(c_in, True) + 8) // 2
            assert lda_words % 8 == 4  # conflict-free m16n8k16 A fragments (bf16 pairs)
        assert (lookup_xtap.PROJECT_KC + 4) % 8 == 4  # the 3xTF32 weight ring's rows
        assert (lookup_xtap.PROJECT_KC_BF16 // 2 + 4) % 8 == 4  # the bf16 ring's rows, in words
        assert (lookup_xtap.PROJECT_BM + 4) % 16 == 4  # the epilogue tile's rows

    def test_wrapper_refuses_what_the_tile_cannot_hold(self):
        """8 levels at radius 6 (C_in 1352) need more than a block's shared
        memory for K1's 3xTF32 tile, while K2 and K1's bf16
        product on fp32 levels (a bf16 A tile) still take them; radius 5
        (C_in 968) fits both. bf16 / int8 windows wider than 32 columns (r >
        15) are refused at any level count: the earlier layout refused them
        for shared memory too."""
        cents = torch.zeros(1, 2, 3, 2)
        pyr = [torch.zeros(6, 4, 4) for _ in range(8)]
        assert lookup_xtap._project_smem_bytes(8, 6) > lookup_xtap.MAX_SMEM_BYTES
        with pytest.raises(ValueError, match="shared memory"):
            lookup_xtap.lookup_project_fused(pyr, cents, torch.zeros(4, 1352), torch.zeros(4), 6)
        assert tuple(lookup_xtap.lookup_pyramid_fused(pyr, cents, 6).shape) == (1, 2, 3, 1352)
        out = lookup_xtap.lookup_project_fused(pyr, cents, torch.zeros(4, 968), torch.zeros(4), 5)
        assert tuple(out.shape) == (1, 4, 2, 3)
        out = lookup_xtap.lookup_project_fused(pyr, cents, torch.zeros(4, 1352), torch.zeros(4), 6, torch.bfloat16)
        assert out.dtype == torch.bfloat16 and tuple(out.shape) == (1, 4, 2, 3)
        for elem in (2, 1):
            assert lookup_xtap._project_smem_bytes(1, 15, elem, True) <= lookup_xtap.MAX_SMEM_BYTES
            assert lookup_xtap._project_smem_bytes(1, 16, elem, True) > lookup_xtap.MAX_SMEM_BYTES
            assert lookup_xtap._project_smem_bytes(1, 16, 4) > lookup_xtap.MAX_SMEM_BYTES
        bf16 = [torch.zeros(6, 40, 40, dtype=torch.bfloat16)]
        with pytest.raises(ValueError, match="shared memory"):
            lookup_xtap.lookup_project_fused(bf16, cents, torch.zeros(4, 33 * 33), torch.zeros(4), 16)

    @pytest.mark.parametrize("bf16_product", [False, True], ids=["3xtf32", "bf16"])
    @pytest.mark.parametrize("elem", [4, 2, 1], ids=["fp32", "bf16", "int8"])
    def test_takes_every_shape_the_fp32_layout_takes(self, elem, bf16_product):
        """No shape that the fp32 layout (every form's before the bf16 / int8
        windows had their own region) held is refused now."""
        for levels in range(1, 9):
            for radius in range(0, 16):
                if lookup_xtap._project_smem_bytes(levels, radius) <= lookup_xtap.MAX_SMEM_BYTES:
                    got = lookup_xtap._project_smem_bytes(levels, radius, elem, bf16_product)
                    assert got <= lookup_xtap.MAX_SMEM_BYTES, (levels, radius)


class TestK1Bf16Weight:
    """The bf16 product's weight: the zero-padded bf16 copy and the block's
    cache of it."""

    def test_copy_is_rne_and_zero_padded(self):
        w = torch.randn(5, 147, generator=torch.Generator().manual_seed(0))
        got = lookup_xtap.project_weight_bf16(w.reshape(5, 147, 1, 1))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (5, 160) and got.is_contiguous()
        assert torch.equal(got[:, :147], w.to(torch.bfloat16))
        assert not got[:, 147:].any()

    def test_block_keeps_the_copy_until_the_weight_changes(self):
        block = lookup_xtap.FusedLookupCorrBlock(num_levels=2, radius=1)
        w = torch.nn.Parameter(torch.randn(4, 18))
        first = block.weight_bf16(w)
        assert block.weight_bf16(w) is first
        with torch.no_grad():
            w.mul_(2.0)  # a reload writes in place: the version moves
        second = block.weight_bf16(w)
        assert second is not first and torch.equal(second[:, :18], w.detach().to(torch.bfloat16))
        other = torch.nn.Parameter(w.detach().clone())
        assert block.weight_bf16(other) is not second


class TestK1WindowCopy:
    """The byte arithmetic of K1's bf16 / int8 window copies and tap reads
    (``gather_windows_lowp``), emulated on a level's bytes: 4-byte chunks
    aligned down from each row's first window cell, zero-filled wholly
    outside the row's in-range cells or past its last one, the cells before
    x = 0 of a straddling chunk masked, each row read at its own phase. The
    windows read back must equal the level's (S+1)^2 cells around each
    centroid, zero outside, at widths whose rows start unaligned."""

    @staticmethod
    def _read_windows(level, q, xs, ys, s, base):
        """Window cells as the kernel reads them: level (Q, hl, wl) of 1- or
        2-byte elements laid at byte address ``base`` (4-aligned)."""
        e = level.element_size()
        _, hl, wl = level.shape
        mem = np.frombuffer(level.contiguous().view(torch.uint8).numpy().tobytes(), dtype=np.uint8)
        rw = (s * e + 7) // 4
        vol = base + q * hl * wl * e
        vlo = vol & 3
        xa, xb = max(xs, 0), min(xs + s, wl - 1)
        smem = np.full((s + 1, 4 * rw), 0xAB, dtype=np.uint8)  # stale bytes
        for rr in range(s + 1):
            y = ys + rr
            row = vlo + y * wl * e
            for k in range(rw):
                c = ((row + xs * e) & ~3) + 4 * k
                b0, b1 = row + xa * e, row + (xb + 1) * e
                ok = xa <= xb and 0 <= y < hl and c + 4 > b0 and c < b1
                n = min(4, b1 - c) if ok else 0
                src = vol - vlo + c - base  # byte offset in the tensor
                if ok:
                    assert src >= 0 and src + n <= mem.size  # never outside the tensor
                smem[rr, 4 * k:4 * k + 4] = 0
                smem[rr, 4 * k:4 * k + n] = mem[src:src + n] if ok else []
        out = np.zeros((s + 1, s + 1))
        for j in range(s + 1):
            ph = (vol + (ys + j) * wl * e + xs * e) & 3
            for x in range(s + 1):
                if xs + x < 0:
                    continue  # masked
                b = smem[j, ph + x * e:ph + x * e + e]
                out[j, x] = (np.frombuffer(b.tobytes(), np.int8)[0] if e == 1
                             else float(torch.from_numpy(np.frombuffer(b.tobytes(), np.int16).copy())
                                        .view(torch.bfloat16)[0]))
        return out

    @pytest.mark.parametrize("base", [0, 4, 8, 12])
    @pytest.mark.parametrize("dtype,wl", [(torch.int8, 39), (torch.int8, 78), (torch.int8, 13),
                                          (torch.bfloat16, 13), (torch.bfloat16, 39), (torch.bfloat16, 16)])
    def test_windows_read_back_exactly(self, dtype, wl, base):
        rng = np.random.default_rng(wl + base)
        q_n, hl, radius = 3, 7, 2
        s = 2 * radius + 1
        vals = rng.integers(-127, 128, (q_n, hl, wl))
        level = torch.from_numpy(vals).to(dtype)
        starts = [(-radius - 3, 1), (wl + radius, 2), (-radius - 1, -radius - 1), (wl - 2, hl - 2), (0, 0),
                  (wl // 2, -s), (wl // 2, hl), (1, 3)]
        for q in range(q_n):
            for xs, ys in starts:
                got = self._read_windows(level, q, xs, ys, s, base)
                want = np.zeros((s + 1, s + 1))
                for j in range(s + 1):
                    for x in range(s + 1):
                        y, xx = ys + j, xs + x
                        if 0 <= y < hl and 0 <= xx < wl:
                            want[j, x] = float(level[q, y, xx].float())
                np.testing.assert_array_equal(got, want, err_msg=f"q {q} window at ({xs}, {ys})")


class TestK2Tile:
    """The wrappers' view of K2's and K4's block plan (``taps_plan`` in
    ``csrc/lookup_xtap.cu``): residency at the model shapes, the shapes each
    entry point takes, and the 16-byte tile store's split of a span."""

    SHAPES = {"raft_large": (1, 55, 128, 4, 4), "raft_small": (1, 55, 128, 4, 3), "batch8": (8, 55, 128, 4, 4)}

    @staticmethod
    def _resident(plan):
        """Blocks an SM holds: by shared memory (1 KB reserved a block), by
        threads (2048 an SM), at most 32."""
        return min(lookup_xtap.SM_SMEM_BYTES // (plan["smem"] + 1024),
                   2048 // lookup_xtap.TAPS_THREADS, 32)

    @pytest.mark.parametrize("elem", [4, 2, 1], ids=["fp32", "bf16", "int8"])
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_four_blocks_an_sm_fill_the_card(self, shape, elem):
        """At the model shapes a block takes four or more queries and every
        level in one pass, at least four blocks fit an SM, and the grid
        gives each of the 132 SMs at least three."""
        b, h, w, levels, radius = self.SHAPES[shape]
        plan = lookup_xtap._taps_plan(levels, radius, elem)
        assert plan["nq"] >= 4 and plan["levels_per_pass"] == levels
        assert self._resident(plan) >= lookup_xtap.TAPS_BLOCKS_PER_SM
        assert plan["smem"] <= lookup_xtap.TAPS_SMEM_SHARE
        assert -(-(b * h * w) // plan["nq"]) >= 3 * 132
        if elem == 4:  # K4 runs the fp32 form's plan
            assert lookup_xtap._taps_plan(levels, radius, 4, k4=True) == plan

    @pytest.mark.parametrize("entry", ["k2", "k4"])
    def test_takes_the_shapes_the_earlier_forms_took(self, entry):
        """K2 takes every (levels, radius) its 32-query fp32 tap tile held
        (32 x ceil4(L S^2) x 4 bytes), K4 every one its eight S x (S+2) y-pass
        tiles held (8 x S (S+2) x 4 bytes), each in every storage, and
        refuses the rest."""
        k4 = entry == "k4"
        for levels in range(1, 9):
            for radius in range(0, 48):
                s = 2 * radius + 1
                took = (8 * s * (s + 2) * 4 if k4 else 32 * (-(-levels * s * s // 4) * 4) * 4) <= 232448
                for elem in ((4,) if k4 else (4, 2, 1)):
                    got = lookup_xtap._taps_smem_bytes(levels, radius, elem, k4)
                    assert (got <= lookup_xtap.MAX_SMEM_BYTES) == took, (levels, radius, elem)

    @pytest.mark.parametrize("entry", ["k2", "k4"])
    def test_wrappers_refuse_beyond_with_the_same_error(self, entry):
        cents = torch.zeros(1, 2, 3, 2)
        pyr = [torch.zeros(6, 4, 4) for _ in range(8)]
        if entry == "k2":  # 8 levels: r 6 is 1352 taps a query, r 7 1800, r 8 2312
            assert tuple(lookup_xtap.lookup_pyramid_fused(pyr, cents, 7).shape) == (1, 2, 3, 1800)
            with pytest.raises(ValueError, match="shared memory"):
                lookup_xtap.lookup_pyramid_fused(pyr, cents, 8)
        else:  # r 41: S (S+2) = 7055; r 42: 7395
            assert tuple(lookup_pyramid_pallas(pyr[:1], cents, 41).shape) == (1, 2, 3, 83 * 83)
            with pytest.raises(ValueError, match="shared memory"):
                lookup_pyramid_pallas(pyr[:1], cents, 42)

    def test_passes_and_fewer_queries_where_shared_memory_is_short(self):
        # K2's widest: one level at r 20 (S + 1 = 42 columns, over a warp)
        plan = lookup_xtap._taps_plan(1, 20, 4)
        assert plan["nq"] < lookup_xtap.TAPS_QUERIES and plan["smem"] <= lookup_xtap.MAX_SMEM_BYTES
        # K4's widest: 8 levels at r 41, one query a block and the levels in passes
        plan = lookup_xtap._taps_plan(8, 41, 4, k4=True)
        assert plan["nq"] == 1 and plan["levels_per_pass"] < 8 and plan["smem"] <= lookup_xtap.MAX_SMEM_BYTES
        assert plan["pitch"] % 16 == (8 * 83 * 83 * 4) % 16

    @staticmethod
    def _store(dst, n, es, threads=lookup_xtap.TAPS_THREADS):
        """``store_span``'s split of n elements at byte address dst: the
        elements each item writes, and whether each vector item is 16
        bytes at a 16-byte boundary."""
        kv = 16 // es
        head = min(n, ((16 - dst % 16) % 16) // es)
        nv = (n - head) // kv
        items = n - nv * (kv - 1)
        writes = []
        for t in range(threads):
            for k in range(t, items, threads):
                if head <= k < head + nv:
                    e = head + (k - head) * kv
                    assert (dst + e * es) % 16 == 0
                    writes.extend(range(e, e + kv))
                else:
                    writes.append(k if k < head else k + nv * (kv - 1))
        return writes

    @pytest.mark.parametrize("radius", [3, 4])
    @pytest.mark.parametrize("storage", ["fp32", "bf16"])
    def test_tile_store_writes_each_element_once(self, storage, radius):
        """Every span a block stores, at every q0 (each parity, ragged last
        tiles) and output alignment, in one pass or in per-query passes:
        each element written exactly once."""
        es = 4 if storage == "fp32" else 2
        levels = 4
        c = levels * (2 * radius + 1) ** 2
        for base in (0, es, 8, 16 - es):
            for q0 in range(0, 34):
                for nq in (16, 5, 1):
                    start = base + q0 * c * es
                    for n in (nq * c, c, (2 * radius + 1) ** 2):  # one pass; a query; one level of a query
                        writes = self._store(start, n, es)
                        assert sorted(writes) == list(range(n)), (base, q0, nq, n)

    def test_tile_rows_alike_mod_16_with_the_output(self):
        """A pass's tile row t lies at phase + t * pitch: alike mod 16 with
        its place in the output, so the store's vectors line up."""
        for levels, radius, elem, k4 in [(4, 4, 4, False), (4, 3, 2, False), (8, 41, 4, True), (8, 6, 1, False)]:
            plan = lookup_xtap._taps_plan(levels, radius, elem, k4)
            s2 = (2 * radius + 1) ** 2
            es = 4 if elem == 4 else 2
            assert plan["tile_off"] % 16 == 0
            assert plan["pitch"] >= plan["levels_per_pass"] * s2 * es
            assert (plan["pitch"] - levels * s2 * es) % 16 == 0


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
