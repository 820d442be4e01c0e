"""The port's slice against the JAX package: weight conversion, the whole
model at a narrow raft_large-style config with ``corr_impl='fused'`` on both
sides (the JAX kernel in interpret mode on the CPU), ``FlowEstimator`` and
``FlowStream``, and the zoo's refusals.

Weights: one JAX variable tree, shaped by ``jax.eval_shape`` of
``init_variables`` (no JAX init runs) and filled from a seeded numpy
generator, loaded into both packages. The flow head's last conv is scaled
by 0.05 so a step moves the flow a few pixels, the scale of a trained
model; with undamped random weights each step moves it tens of pixels and
the recurrence amplifies fp32 rounding about tenfold per step (the JAX
package's own dense and fused blocks then disagree beyond this tolerance
after 3 steps), which would test chaos rather than the port.
"""

from functools import partial

import numpy as np
import pytest
import torch

# a card machine may lack the JAX package's dependencies (it has jax but no
# flax): these modules then skip as a whole
pytest.importorskip("raft_tpu")

import jax  # noqa: E402

from raft_tpu.inference import FlowEstimator as JaxFlowEstimator
from raft_tpu.models import RAFT_LARGE as JAX_RAFT_LARGE
from raft_tpu.models import RAFT_SMALL as JAX_RAFT_SMALL
from raft_tpu.models import build_raft as jax_build_raft
from raft_tpu.models.zoo import init_variables

import raft_tpu_torch as rt
from raft_tpu_torch.checkpoint import state_dict_from_flax
from raft_tpu_torch.kernels import lookup_xtap

torch.set_num_threads(2)

NARROW = dict(
    feature_encoder_widths=(8, 8, 12, 16, 32),
    context_encoder_widths=(8, 8, 12, 16, 48),
    corr_levels=4,
    corr_radius=4,
    motion_corr_widths=(16, 12),
    motion_flow_widths=(16, 8),
    motion_out_channels=24,
    gru_hidden=32,
    flow_head_hidden=16,
    corr_impl="fused",
)
# the parity tolerance of the JAX package's own reference-model test
RTOL, ATOL = 1e-4, 2e-4


def _fill(shapes, rng):
    """Seeded values for an eval_shape'd variable tree."""
    out = {}
    for key in sorted(shapes):
        leaf = shapes[key]
        if hasattr(leaf, "items"):
            out[key] = _fill(leaf, rng)
            continue
        shp = leaf.shape
        if key == "kernel":
            arr = rng.normal(0.0, np.sqrt(2.0 / (shp[0] * shp[1] * shp[3])), shp)
        elif key == "bias":
            arr = rng.normal(0.0, 0.05, shp)
        elif key == "scale":
            arr = 1.0 + rng.normal(0.0, 0.1, shp)
        elif key == "mean":
            arr = rng.normal(0.0, 0.1, shp)
        elif key == "var":
            arr = rng.uniform(0.5, 1.5, shp)
        else:
            raise KeyError(key)
        out[key] = arr.astype(np.float32)
    return out


def _variables(jax_model, seed=0):
    shapes = jax.eval_shape(lambda: init_variables(jax_model))
    variables = _fill(shapes, np.random.default_rng(seed))
    variables["params"]["update_block"]["flow_head"]["conv2"]["kernel"] *= 0.05
    return variables


@pytest.fixture(scope="module")
def narrow():
    """(jax model, variables, port model on the CPU) at the narrow config."""
    jm = jax_build_raft(JAX_RAFT_LARGE.replace(**NARROW))
    variables = _variables(jm)
    pm = rt.build_raft(rt.RAFT_LARGE.replace(**NARROW), device="cpu")
    pm.load_state_dict(state_dict_from_flax(variables), strict=True)
    return jm, variables, pm


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


class TestStateDict:
    @pytest.mark.parametrize(
        "arch,expected", [("raft_large", 5_257_536), ("raft_small", 990_162)]
    )
    def test_strict_load_and_param_count(self, arch, expected):
        jax_cfg = {"raft_large": JAX_RAFT_LARGE, "raft_small": JAX_RAFT_SMALL}[arch]
        shapes = jax.eval_shape(lambda: init_variables(jax_build_raft(jax_cfg)))
        variables = _fill(shapes, np.random.default_rng(1))
        model = getattr(rt, arch)(device="cpu")
        state = state_dict_from_flax(variables)
        model.load_state_dict(state, strict=True)
        assert sum(p.numel() for p in model.parameters()) == expected
        # values land where they belong: a conv kernel HWIO -> OIHW, and a
        # batch statistic of the context encoder
        k = variables["params"]["feature_encoder"]["convnormrelu"]["layers_0"]["kernel"]
        np.testing.assert_array_equal(
            model.feature_encoder.convnormrelu[0].weight.detach().numpy(),
            k.transpose(3, 2, 0, 1),
        )
        if arch == "raft_large":
            var = variables["batch_stats"]["context_encoder"]["layer1"]["layers_0"][
                "convnormrelu1"
            ]["layers_1"]["var"]
            np.testing.assert_array_equal(
                model.context_encoder.layer1[0].convnormrelu1[1].running_var.numpy(), var
            )
            w = variables["params"]["update_block"]["motion_encoder"]["convcorr1"][
                "layers_0"
            ]["kernel"]
            np.testing.assert_array_equal(
                model.update_block.motion_encoder.convcorr1[0].weight.detach().numpy(),
                w.transpose(3, 2, 0, 1),
            )


class TestSliceParity:
    def test_every_iteration_matches_jax_fused(self, narrow):
        """The whole model, fused block on both sides, 3 updates, every
        iteration compared (emit_all)."""
        jm, variables, pm = narrow
        rng = np.random.default_rng(2)
        im1 = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
        im2 = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
        want = np.asarray(
            jax.jit(partial(jm.apply, train=False, num_flow_updates=3))(variables, im1, im2)
        )
        with torch.inference_mode():
            got = pm(_nchw(im1), _nchw(im2), num_flow_updates=3, emit_all=True)
        got = got.numpy().transpose(0, 1, 3, 4, 2)
        assert got.shape == want.shape == (3, 1, 128, 128, 2)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_full_width_32_updates(self):
        """raft_large at full width, fused on both sides, the published 32
        updates (flow head scaled to ~1 px per update): the final flows
        agree within the card smoke test's fused-vs-dense limits."""
        jm = jax_build_raft(JAX_RAFT_LARGE.replace(corr_impl="fused"))
        shapes = jax.eval_shape(lambda: init_variables(jm))
        variables = _fill(shapes, np.random.default_rng(7))
        variables["params"]["update_block"]["flow_head"]["conv2"]["kernel"] *= 0.01
        pm = rt.raft_large(device="cpu", corr_impl="fused")
        pm.load_state_dict(state_dict_from_flax(variables), strict=True)
        rng = np.random.default_rng(8)
        im1 = rng.uniform(-1, 1, (1, 128, 160, 3)).astype(np.float32)
        im2 = np.roll(im1, (2, 3), (1, 2))
        want = np.asarray(
            jax.jit(partial(jm.apply, train=False, num_flow_updates=32, emit_all=False))(
                variables, im1, im2
            )
        )
        with torch.inference_mode():
            got = pm(_nchw(im1), _nchw(im2), num_flow_updates=32, emit_all=False)
        diff = np.abs(got.numpy().transpose(0, 2, 3, 1) - want)
        assert diff.mean() <= 1e-3 and diff.max() <= 5e-2, (diff.mean(), diff.max())

    def test_flow_estimator_matches_jax(self, narrow):
        """Raw uint8 123x150 pair (padded to 128x152) through both
        FlowEstimators on the same weights."""
        jm, variables, pm = narrow
        rng = np.random.default_rng(3)
        a = rng.integers(0, 256, (123, 150, 3), dtype=np.uint8)
        b = rng.integers(0, 256, (123, 150, 3), dtype=np.uint8)
        want = JaxFlowEstimator(jm, variables, num_flow_updates=3)(a, b)
        est = rt.FlowEstimator(pm, num_flow_updates=3, device="cpu")
        got = est(a, b)
        assert got.shape == want.shape == (123, 150, 2)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_stream_matches_pairwise(self, narrow):
        """Encode-once streaming equals pairwise calls (fp32 conv rounding)."""
        _, _, pm = narrow
        est = rt.FlowEstimator(pm, num_flow_updates=2, pad_mode="downstream", device="cpu")
        rng = np.random.default_rng(4)
        frames = [rng.integers(0, 256, (130, 140, 3), dtype=np.uint8) for _ in range(3)]
        stream = est.open_stream()
        assert stream(frames[0]) is None
        for prev, cur in zip(frames, frames[1:]):
            np.testing.assert_allclose(stream(cur), est(prev, cur), rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError, match="one resolution"):
            stream(frames[0][:128])

    def test_iteration_entry_points_reproduce_iterate(self, narrow):
        """begin_pair + N x iterate_step + finalize_flow == forward(emit_all=False),
        and a zero init_flow is the cold start."""
        _, _, pm = narrow
        rng = np.random.default_rng(5)
        im1 = _nchw(rng.uniform(-1, 1, (2, 128, 136, 3)).astype(np.float32))
        im2 = _nchw(rng.uniform(-1, 1, (2, 128, 136, 3)).astype(np.float32))
        with torch.inference_mode():
            want = pm(im1, im2, num_flow_updates=3, emit_all=False)
            state = pm.begin_pair(im1, im2, init_flow=torch.zeros(2, 2, 16, 17))
            for _ in range(3):
                state = pm.iterate_step(state)
            got = pm.finalize_flow(state["coords1"], state["hidden"])
            final = pm(im1, im2, num_flow_updates=3, emit_all=True)[-1]
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(final, want, rtol=1e-6, atol=1e-5)

    def test_fused_block_counts_no_launch_on_cpu(self, narrow):
        """On CPU tensors the wrapper takes the plain version: the launch
        counter stays put."""
        _, _, pm = narrow
        before = lookup_xtap.lookup_project_fused.launches
        x = torch.zeros(1, 3, 128, 128)
        with torch.inference_mode():
            pm(x, x, num_flow_updates=1, emit_all=False)
        assert lookup_xtap.lookup_project_fused.launches == before


class TestEstimatorContract:
    def test_rejects_bad_inputs(self, narrow):
        _, _, pm = narrow
        est = rt.FlowEstimator(pm, num_flow_updates=2, device="cpu")
        ok = np.zeros((128, 128, 3), np.uint8)
        with pytest.raises(ValueError, match="nonfinite"):
            est(np.full((128, 128, 3), np.nan, np.float32), ok)
        with pytest.raises(ValueError, match="already normalized"):
            est(np.full((128, 128, 3), -0.5, np.float32), ok)
        with pytest.raises(ValueError, match="num_flow_updates"):
            est(ok, ok, num_flow_updates=3)
        with pytest.raises(ValueError, match="RGB"):
            est(np.zeros((128, 128), np.uint8), ok)
        with pytest.warns(UserWarning, match="near-black"):
            est(np.full((128, 128, 3), 1.0, np.float32), ok, num_flow_updates=1)

    def test_grad_enabled_call_raises(self, narrow):
        """A grad-enabled call of the fused model raises no longer: it runs
        the kernel's forward (here its plain version) and the dense
        formulation's backward (``project_fused_diff``), and its parameter
        gradients, for a loss linear in the flow of 1 update, match
        ``jax.grad`` through the JAX model at fused (its kernel in
        interpret mode) within 1e-4 in relative L2 norm over all
        parameters (measured 1.9e-5; the encoders' first convolutions,
        reached through instance norms' cancelling sums, are the least
        accurate tensors, as in tests/test_torch_train.py)."""
        jm, variables, _ = narrow
        pm = rt.build_raft(rt.RAFT_LARGE.replace(**NARROW), device="cpu")
        pm.load_state_dict(state_dict_from_flax(variables), strict=True)
        rng = np.random.default_rng(6)
        im1 = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
        im2 = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
        cot = rng.normal(size=(1, 1, 128, 128, 2)).astype(np.float32)

        def jloss(params):
            flows = jm.apply({**variables, "params": params}, im1, im2, train=False, num_flow_updates=1)
            return (flows * cot).sum()

        want = state_dict_from_flax({"params": jax.device_get(jax.jit(jax.grad(jloss))(variables["params"]))})
        # contiguous NCHW, as training batches are: torch's CPU backward
        # through the feature encoder corrupts the heap on channels-last
        # (permuted NHWC) images
        flows = pm(_nchw(im1).contiguous(), _nchw(im2).contiguous(), num_flow_updates=1)
        loss = (flows * torch.from_numpy(cot).permute(0, 1, 4, 2, 3)).sum()
        names = [n for n, _ in pm.named_parameters()]
        got = torch.autograd.grad(loss, list(pm.parameters()))
        a = torch.cat([g.reshape(-1) for g in got]).double()
        b = torch.cat([want[n].reshape(-1) for n in names]).double()
        assert float((a - b).norm() / b.norm()) < 1e-4, float((a - b).norm() / b.norm())


class TestZoo:
    @pytest.mark.parametrize("impl,item", [("onthefly", "item 5")])
    def test_unported_corr_impl_raises(self, impl, item):
        with pytest.raises(NotImplementedError, match=item):
            rt.raft_small(device="cpu", corr_impl=impl)

    def test_pallas_builds_the_k3_block(self):
        from raft_tpu_torch.kernels.corr_pallas import PallasCorrBlock

        model = rt.raft_small(device="cpu", corr_impl="pallas")
        assert type(model.corr_block) is PallasCorrBlock
        with pytest.raises(ValueError, match="unknown corr_impl"):
            rt.raft_small(device="cpu", corr_impl="sparse")

    @pytest.mark.parametrize("kw", [{"compute_dtype": "float16"}, {"corr_dtype": "int8"}])
    def test_reduced_precision_raises(self, kw):
        """bf16 and int8 are ported; what the JAX package refuses still
        raises: a dtype it does not know, int8 storage outside the fused
        block."""
        match = "requires corr_impl='fused'" if "corr_dtype" in kw else "compute_dtype"
        with pytest.raises(ValueError, match=match):
            rt.raft_small(device="cpu", **kw)

    def test_pretrained_never_fetches(self):
        with pytest.raises(FileNotFoundError, match="never downloaded"):
            rt.raft_small(device="cpu", pretrained=True)

    def test_checkpoint_round_trip(self, tmp_path):
        src = rt.raft_small(device="cpu", seed=7)
        path = tmp_path / "small.pth"
        torch.save(src.state_dict(), path)
        dst = rt.raft_small(device="cpu", seed=8, checkpoint=str(path))
        for (k, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)

    def test_seed_makes_weights(self):
        a = rt.raft_small(device="cpu", seed=3).state_dict()
        b = rt.raft_small(device="cpu", seed=3).state_dict()
        c = rt.raft_small(device="cpu", seed=4).state_dict()
        key = "feature_encoder.convnormrelu.0.weight"
        assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
