"""The port's ops, layers, encoders and update-block parts against the JAX
package on the same seeded inputs and weights (fp32 on the CPU; tolerance
1e-5 unless a check says otherwise: the two packages' conv and reduction
kernels order their fp32 sums differently).

Flax weights come from the JAX module's own ``init`` with biases, norm
affines and batch statistics re-drawn from a seeded numpy generator (an
init leaves them 0/1, which would hide a mis-mapped key), and reach the
port through ``state_dict_from_flax``.
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

from raft_tpu.eval.padder import InputPadder as JaxInputPadder
from raft_tpu.models import encoders as jenc
from raft_tpu.models import layers as jlayers
from raft_tpu.models import update as jupdate
from raft_tpu.ops import resize as jresize
from raft_tpu.ops import sampling as jsampling
from raft_tpu.ops import upsample as jupsample

from raft_tpu_torch.checkpoint import state_dict_from_flax
from raft_tpu_torch.eval.padder import InputPadder
from raft_tpu_torch.models import encoders, layers, update
from raft_tpu_torch.ops import resize, sampling, upsample

torch.set_num_threads(2)

TOL = 1e-5


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _redraw(tree, rng):
    out = {}
    for key in sorted(tree):
        leaf = tree[key]
        if hasattr(leaf, "items"):
            out[key] = _redraw(leaf, rng)
            continue
        arr = np.asarray(leaf)
        if key == "bias":
            arr = rng.normal(0.0, 0.1, arr.shape)
        elif key == "scale":
            arr = 1.0 + rng.normal(0.0, 0.1, arr.shape)
        elif key == "mean":
            arr = rng.normal(0.0, 0.1, arr.shape)
        elif key == "var":
            arr = rng.uniform(0.5, 1.5, arr.shape)
        out[key] = np.asarray(arr, np.float32)
    return out


def _flax_and_port(jmodule, port_module, *inputs, seed=0, **apply_kw):
    """Init the Flax module, re-draw its biases/stats, load them into the
    port module; returns (variables, port module)."""
    variables = jax.jit(jmodule.init)(jax.random.PRNGKey(seed), *inputs, **apply_kw)
    variables = _redraw(jax.tree_util.tree_map(np.asarray, dict(variables)), np.random.default_rng(seed))
    port_module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return variables, port_module.eval()


class TestOps:
    def test_coords_grid(self):
        got = sampling.coords_grid(2, 3, 5)
        want = np.asarray(jsampling.coords_grid(2, 3, 5))
        np.testing.assert_array_equal(_nhwc(got), want)

    def test_bilinear_sample_zero_padding(self, rng):
        img = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
        coords = rng.uniform(-3.0, 14.0, (2, 6, 7, 2)).astype(np.float32)
        want = np.asarray(jsampling.bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))
        got = sampling.bilinear_sample(torch.from_numpy(img), torch.from_numpy(coords))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("size", [(20, 28), (5, 3), (1, 9), (10, 14)], ids=["up", "down", "degenerate", "same"])
    def test_resize_align_corners(self, rng, size):
        img = rng.normal(size=(2, 10, 14, 3)).astype(np.float32)
        want = np.asarray(jresize.resize_bilinear_align_corners(jnp.asarray(img), *size))
        got = resize.resize_bilinear_align_corners(_nchw(img), *size)
        np.testing.assert_allclose(_nhwc(got), want, rtol=TOL, atol=TOL)

    def test_upsample_convex(self, rng):
        flow = rng.normal(size=(2, 5, 6, 2)).astype(np.float32)
        mask = rng.normal(size=(2, 5, 6, 576)).astype(np.float32)
        want = np.asarray(jupsample.upsample_flow(jnp.asarray(flow), jnp.asarray(mask)))
        got = upsample.upsample_flow(_nchw(flow), _nchw(mask))
        assert tuple(got.shape) == (2, 2, 40, 48)
        np.testing.assert_allclose(_nhwc(got), want, rtol=TOL, atol=TOL)

    def test_upsample_bilinear(self, rng):
        flow = rng.normal(size=(1, 4, 7, 2)).astype(np.float32)
        want = np.asarray(jupsample.upsample_flow(jnp.asarray(flow)))
        got = upsample.upsample_flow(_nchw(flow))
        np.testing.assert_allclose(_nhwc(got), want, rtol=TOL, atol=TOL)
        with pytest.raises(ValueError, match="up_mask"):
            upsample.upsample_flow(_nchw(flow), torch.zeros(1, 575, 4, 7))


class TestLayers:
    @pytest.mark.parametrize("relu", [False, True])
    def test_instance_norm(self, rng, relu):
        # a large offset exercises the fast-variance formula's cancellation
        x = (rng.normal(size=(2, 6, 7, 5)) * 3.0 + 40.0).astype(np.float32)
        want = np.asarray(jlayers.instance_norm(jnp.asarray(x), relu=relu))
        got = layers.instance_norm(_nchw(x), relu=relu)
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)

    def test_instance_norm_clamps_negative_variance(self):
        x = torch.full((1, 2, 3, 3), 1e4)
        y = layers.instance_norm(x)
        assert torch.isfinite(y).all() and float(y.abs().max()) == 0.0

    @pytest.mark.parametrize(
        "kernel,stride,norm,act",
        [(3, 1, "batch", True), (7, 2, "instance", True), (1, 2, "batch", False), (3, 1, None, True)],
        ids=["bn-relu", "in-stem", "bn-down", "plain"],
    )
    def test_conv_norm_act(self, rng, kernel, stride, norm, act):
        x = rng.normal(size=(2, 12, 14, 4)).astype(np.float32)
        jm = jlayers.ConvNormAct(6, kernel, stride, norm, act=act, use_bias=True)
        variables, pm = _flax_and_port(
            jm, layers.ConvNormAct(4, 6, kernel, stride, norm, act=act, bias=True), jnp.asarray(x)
        )
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = pm(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("block", ["ResidualBlock", "BottleneckBlock"])
    @pytest.mark.parametrize("stride", [1, 2])
    def test_blocks(self, rng, block, stride):
        x = rng.normal(size=(1, 10, 12, 8)).astype(np.float32)
        jm = getattr(jlayers, block)(8, "batch", stride)
        variables, pm = _flax_and_port(jm, getattr(layers, block)(8, 8, "batch", stride), jnp.asarray(x))
        want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
        with torch.no_grad():
            got = pm(_nchw(x))
        np.testing.assert_allclose(_nhwc(got), want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize(
        "block,norm", [("residual", "instance"), ("residual", "batch"), ("bottleneck", None)]
    )
    def test_feature_encoder(self, rng, block, norm):
        x = rng.uniform(-1, 1, (2, 32, 40, 3)).astype(np.float32)
        widths = (8, 8, 12, 16, 24)
        jblock = {"residual": jlayers.ResidualBlock, "bottleneck": jlayers.BottleneckBlock}[block]
        tblock = {"residual": layers.ResidualBlock, "bottleneck": layers.BottleneckBlock}[block]
        jm = jenc.FeatureEncoder(block=jblock, widths=widths, norm=norm)
        variables, pm = _flax_and_port(jm, encoders.FeatureEncoder(tblock, widths, norm), jnp.asarray(x))
        want = np.asarray(jax.jit(partial(jm.apply, train=False))(variables, jnp.asarray(x)))
        with torch.no_grad():
            got = pm(_nchw(x))
        assert tuple(got.shape) == (2, 24, 4, 5)
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


class TestUpdateParts:
    def test_motion_encoder_materialized_taps(self, rng):
        flow = rng.normal(size=(1, 6, 7, 2)).astype(np.float32)
        taps = rng.normal(size=(1, 6, 7, 50)).astype(np.float32)
        jm = jupdate.MotionEncoder(corr_widths=(16, 12), flow_widths=(16, 8), out_channels=24)
        variables, pm = _flax_and_port(
            jm, update.MotionEncoder(50, (16, 12), (16, 8), 24), jnp.asarray(flow), jnp.asarray(taps)
        )
        want = np.asarray(jm.apply(variables, jnp.asarray(flow), jnp.asarray(taps)))
        with torch.no_grad():
            got = pm(_nchw(flow), torch.from_numpy(taps))
        np.testing.assert_allclose(_nhwc(got), want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize(
        "kernels,pads", [(((1, 5), (5, 1)), ((0, 2), (2, 0))), (((3, 3),), ((1, 1),))], ids=["large", "small"]
    )
    def test_recurrent_block(self, rng, kernels, pads):
        h = rng.normal(size=(1, 6, 7, 16)).astype(np.float32)
        x = rng.normal(size=(1, 6, 7, 10)).astype(np.float32)
        jm = jupdate.RecurrentBlock(hidden=16, kernels=kernels, pads=pads)
        variables, pm = _flax_and_port(
            jm, update.RecurrentBlock(16, 10, kernels, pads), jnp.asarray(h), jnp.asarray(x)
        )
        want = np.asarray(jm.apply(variables, jnp.asarray(h), jnp.asarray(x)))
        with torch.no_grad():
            got = pm(_nchw(h), _nchw(x))
        np.testing.assert_allclose(_nhwc(got), want, rtol=TOL, atol=TOL)

    def test_flow_head_and_mask_predictor(self, rng):
        x = rng.normal(size=(1, 6, 7, 16)).astype(np.float32)
        jh = jupdate.FlowHead(hidden=12)
        vh, ph = _flax_and_port(jh, update.FlowHead(16, 12), jnp.asarray(x))
        jp = jupdate.MaskPredictor(hidden=12)
        vp, pp = _flax_and_port(jp, update.MaskPredictor(16, 12), jnp.asarray(x))
        with torch.no_grad():
            got_h, got_p = ph(_nchw(x)), pp(_nchw(x))
        assert got_h.dtype == got_p.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(got_h), np.asarray(jh.apply(vh, jnp.asarray(x))), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(_nhwc(got_p), np.asarray(jp.apply(vp, jnp.asarray(x))), rtol=TOL, atol=TOL)


class TestPadder:
    @pytest.mark.parametrize("mode", ["sintel", "downstream"])
    def test_pads_and_unpads_like_jax(self, rng, mode):
        img = rng.normal(size=(2, 123, 150, 3)).astype(np.float32)
        jp, pp = JaxInputPadder(img.shape, mode=mode), InputPadder(img.shape, mode=mode)
        assert pp.pads == jp.pads
        padded = pp.pad(img)
        np.testing.assert_array_equal(padded, jp.pad(img))
        assert padded.shape[1] % 8 == 0 and padded.shape[2] % 8 == 0
        np.testing.assert_array_equal(pp.unpad(padded), img)

    def test_rejects_unknown_mode(self):
        with pytest.raises(ValueError, match="pad mode"):
            InputPadder((8, 8, 3), mode="kitti-ish")
