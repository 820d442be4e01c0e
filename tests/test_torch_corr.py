"""The port's correlation engine and its lookup kernel module against the
JAX package.

The plain functions against ``raft_tpu.models.corr``, and the kernel
wrappers' CPU path (their plain versions) against the JAX package's Pallas
kernels run in interpret mode. The CUDA kernels themselves are held
against their plain versions on the card in ``tests/test_torch_cuda.py``.

Tolerances: 1e-5 for the lookup (each tap is a 4-term fp32 bilinear sum;
the two packages order the sums differently) and 1e-4 for the projection
(a 100-324-term fp32 dot per output).
"""

from functools import partial

import numpy as np
import pytest
import torch

# a card machine may lack the JAX package's dependencies (it has jax but no
# flax): these modules then skip as a whole
pytest.importorskip("raft_tpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raft_tpu.kernels.lookup_xtap import lookup_project_fused as jax_lookup_project_fused
from raft_tpu.kernels.lookup_xtap import lookup_pyramid_fused as jax_lookup_pyramid_fused
from raft_tpu.models import corr as jcorr

from raft_tpu_torch.kernels.lookup_xtap import (
    FusedLookupCorrBlock,
    lookup_project_fused,
    lookup_pyramid_fused,
)
from raft_tpu_torch.models import corr

torch.set_num_threads(2)

LOOKUP_TOL = 1e-5
PROJECT_TOL = 1e-4


def _fmaps(rng, b, h, w, c):
    """NHWC numpy feature maps for the JAX side."""
    return (
        rng.normal(size=(b, h, w, c)).astype(np.float32),
        rng.normal(size=(b, h, w, c)).astype(np.float32),
    )


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@partial(jax.jit, static_argnums=2)
def _jax_pyramid(f1, f2, levels):
    """The JAX pyramid, jitted: one compile a shape, where op by op every
    primitive compiles on its own."""
    return jcorr.pool_pyramid(jcorr.correlation_volume(jnp.asarray(f1), jnp.asarray(f2)), levels)


def _port_pyramid(f1, f2, levels):
    return corr.pool_pyramid(corr.correlation_volume(_nchw(f1), _nchw(f2)), levels)


def _centroids(rng, b, h, w, lo, hi):
    return rng.uniform(lo, hi, (b, h, w, 2)).astype(np.float32)


# the JAX lookups at radius 3, jitted once for every centroid range
_JAX_LOOKUP = {fn: jax.jit(partial(getattr(jcorr, fn), radius=3)) for fn in ("lookup_pyramid", "lookup_pyramid_gather")}


class TestPlainCorr:
    def test_correlation_volume(self, rng):
        f1, f2 = _fmaps(rng, 2, 6, 10, 16)
        want = np.asarray(jcorr.correlation_volume(jnp.asarray(f1), jnp.asarray(f2)))
        got = corr.correlation_volume(_nchw(f1), _nchw(f2)).numpy()
        assert got.shape == want.shape == (2, 60, 6, 10)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("h,w", [(16, 24), (18, 22), (27, 37)], ids=["even", "odd2", "odd3"])
    def test_pool_pyramid_drops_odd_tails(self, rng, h, w):
        f1, f2 = _fmaps(rng, 1, h, w, 8)
        want = _jax_pyramid(f1, f2, 3)
        got = _port_pyramid(f1, f2, 3)
        for a, b_ in zip(got, want):
            assert tuple(a.shape) == b_.shape[:3]
            np.testing.assert_allclose(a.numpy(), np.asarray(b_)[..., 0], rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize(
        "lo,hi", [(2.0, 10.0), (-3.0, 16.0), (-400.0, 500.0)], ids=["inside", "edge", "far"]
    )
    @pytest.mark.parametrize("fn", ["lookup_pyramid", "lookup_pyramid_gather"])
    def test_lookup(self, rng, lo, hi, fn):
        f1, f2 = _fmaps(rng, 2, 12, 14, 8)
        cents = _centroids(rng, 2, 12, 14, lo, hi)
        want = _JAX_LOOKUP[fn](_jax_pyramid(f1, f2, 3), jnp.asarray(cents))
        got = getattr(corr, fn)(_port_pyramid(f1, f2, 3), torch.from_numpy(cents), 3)
        assert tuple(got.shape) == want.shape == (2, 12, 14, 3 * 49)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOOKUP_TOL, atol=LOOKUP_TOL)

    def test_separable_equals_gather(self, rng):
        f1, f2 = _fmaps(rng, 1, 10, 12, 8)
        pyr = _port_pyramid(f1, f2, 2)
        cents = torch.from_numpy(_centroids(rng, 1, 10, 12, -5.0, 15.0))
        torch.testing.assert_close(
            corr.lookup_pyramid(pyr, cents, 4),
            corr.lookup_pyramid_gather(pyr, cents, 4),
            rtol=LOOKUP_TOL,
            atol=LOOKUP_TOL,
        )

    def test_project_taps(self, rng):
        taps = rng.normal(size=(2, 5, 7, 98)).astype(np.float32)
        kernel = (rng.normal(size=(1, 1, 98, 24)) * 0.1).astype(np.float32)
        bias = rng.normal(size=(24,)).astype(np.float32)
        want = jcorr.project_taps(jnp.asarray(taps), jnp.asarray(kernel), jnp.asarray(bias))
        weight = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
        got = corr.project_taps(torch.from_numpy(taps), weight, torch.from_numpy(bias))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PROJECT_TOL, atol=PROJECT_TOL)

    def test_block_contract(self, rng):
        f1, f2 = _fmaps(rng, 1, 16, 16, 8)
        blk = corr.CorrBlock(num_levels=4, radius=3)
        assert blk.out_channels == 4 * 49 and blk.min_fmap_size() == 16
        pyr = blk.build_pyramid(_nchw(f1), _nchw(f2))
        cents = torch.from_numpy(_centroids(rng, 1, 16, 16, 0.0, 16.0))
        lazy = corr.LazyCorrFeatures(blk, pyr, cents)
        weight = torch.randn(12, 196) * 0.1
        bias = torch.randn(12)
        torch.testing.assert_close(
            lazy.project(weight, bias),
            corr.project_taps(lazy.materialize(), weight, bias).permute(0, 3, 1, 2),
        )
        with pytest.raises(ValueError, match="too small"):
            blk.build_pyramid(_nchw(f1)[:, :, :8], _nchw(f2)[:, :, :8])


class TestKernelModulePlainPath:
    """The wrappers on CPU tensors against the JAX fused kernels run in
    interpret mode."""

    @pytest.mark.parametrize(
        "radius,levels,h,w",
        [(4, 4, 16, 24), (3, 3, 12, 20), (4, 2, 10, 36), (3, 4, 16, 44)],
        ids=["r4l4", "r3l3", "r4l2", "r3l4"],
    )
    def test_lookup_pyramid_matches_jax_kernel(self, rng, radius, levels, h, w):
        f1, f2 = _fmaps(rng, 1, h, w, 8)
        cents = _centroids(rng, 1, h, w, -6.0, w + 6.0)
        want = jax_lookup_pyramid_fused(
            _jax_pyramid(f1, f2, levels), jnp.asarray(cents), radius, interpret=True
        )
        got = lookup_pyramid_fused(_port_pyramid(f1, f2, levels), torch.from_numpy(cents), radius)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOOKUP_TOL, atol=LOOKUP_TOL)

    @pytest.mark.parametrize(
        "radius,levels,h,w",
        [(4, 4, 16, 24), (3, 3, 12, 20), (4, 2, 10, 36), (3, 4, 16, 44)],
        ids=["r4l4", "r3l3", "r4l2", "r3l4"],
    )
    def test_lookup_project_matches_jax_kernel(self, rng, radius, levels, h, w):
        f1, f2 = _fmaps(rng, 1, h, w, 8)
        cents = _centroids(rng, 1, h, w, -6.0, w + 6.0)
        c_in = levels * (2 * radius + 1) ** 2
        kernel = (rng.normal(size=(1, 1, c_in, 32)) * 0.1).astype(np.float32)
        bias = rng.normal(size=(32,)).astype(np.float32)
        want = jax_lookup_project_fused(
            _jax_pyramid(f1, f2, levels), jnp.asarray(cents), jnp.asarray(kernel),
            jnp.asarray(bias), radius, interpret=True,
        )
        got = lookup_project_fused(
            _port_pyramid(f1, f2, levels), torch.from_numpy(cents),
            torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias), radius,
        )
        assert tuple(got.shape) == (1, 32, h, w)
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=PROJECT_TOL, atol=PROJECT_TOL
        )

    def test_fused_block_equals_dense_block(self, rng):
        f1, f2 = _fmaps(rng, 2, 16, 20, 8)
        cents = torch.from_numpy(_centroids(rng, 2, 16, 20, -3.0, 23.0))
        dense, fused = corr.CorrBlock(3, 3), FusedLookupCorrBlock(3, 3)
        pd = dense.build_pyramid(_nchw(f1), _nchw(f2))
        pf = fused.build_pyramid(_nchw(f1), _nchw(f2))
        weight, bias = torch.randn(16, 147) * 0.1, torch.randn(16)
        torch.testing.assert_close(fused.index_pyramid(pf, cents), dense.index_pyramid(pd, cents))
        torch.testing.assert_close(
            fused.index_project(pf, cents, weight, bias), dense.index_project(pd, cents, weight, bias)
        )


class TestWrapperChecks:
    def _args(self, q_hw=(1, 4, 5), levels=2):
        b, h, w = q_hw
        pyr = [torch.zeros(b * h * w, 8 >> l, 8 >> l) for l in range(levels)]
        return pyr, torch.zeros(b, h, w, 2)

    def test_rejects_wrong_dtype_shape_and_layout(self):
        pyr, cents = self._args()
        with pytest.raises(TypeError, match="float32"):
            lookup_pyramid_fused(pyr, cents.double(), 2)
        with pytest.raises(ValueError, match="level 1"):
            lookup_pyramid_fused([pyr[0], pyr[1][:3]], cents, 2)
        with pytest.raises(ValueError, match="contiguous"):
            lookup_pyramid_fused(pyr, cents.transpose(1, 2).contiguous().transpose(1, 2), 2)
        with pytest.raises(ValueError, match="levels"):
            lookup_pyramid_fused(pyr * 5, cents, 1)
        with pytest.raises(ValueError, match="shared memory"):
            lookup_pyramid_fused(pyr * 4, cents, 8)
        with pytest.raises(ValueError, match="weight"):
            lookup_project_fused(pyr, cents, torch.zeros(4, 49), torch.zeros(4), 2)

    def test_grad_raises_and_no_grad_runs(self):
        pyr, cents = self._args()
        weight = torch.zeros(4, 50, requires_grad=True)
        bias = torch.zeros(4)
        with pytest.raises(RuntimeError, match="inference-only.*project_fused_diff"):
            lookup_project_fused(pyr, cents, weight, bias, 2)
        with torch.no_grad():
            out = lookup_project_fused(pyr, cents, weight, bias, 2)
        assert tuple(out.shape) == (1, 4, 4, 5)

    def test_cpu_path_launches_nothing(self):
        pyr, cents = self._args()
        before = (lookup_pyramid_fused.launches, lookup_project_fused.launches)
        lookup_pyramid_fused(pyr, cents, 2)
        lookup_project_fused(pyr, cents, torch.zeros(4, 50), torch.zeros(4), 2)
        assert (lookup_pyramid_fused.launches, lookup_project_fused.launches) == before

    def test_build_finds_no_compiler_without_toolkit(self, monkeypatch):
        """Without nvcc the build raises a clear error rather than
        falling back (this machine class has no toolkit)."""
        from raft_tpu_torch.kernels import build

        monkeypatch.setenv("CUDA_HOME", "/nonexistent")
        monkeypatch.setenv("PATH", "/nonexistent")
        monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()
