"""The port's deployment precision path against the JAX package, on the
CPU: weight files by content (``checkpoint=``), the pinned fp32 precision,
the serving presets, bf16 convs, the bf16 dense correlation block, the
plain versions of K3's bf16 storage and of K1/K2 on bf16 and int8 levels,
the golden EPE at the deployment knobs, and the bench's output schema.

Inputs come from seeded numpy generators; the JAX Pallas kernels run in
interpret mode, at small shapes, one call each. Tolerances, each stated
where it is used:
  * bf16 convs (ConvNormAct, encoders) against the JAX ``dtype=bf16``
    modules: 2e-2 of the largest magnitude (single roundings land the
    other way, and instance norms amplify them); the fixture's feature
    encoder also no further from fp32 than 1.5x the JAX bf16 output is
    (``TestBf16Convs.test_fixture_encoders``);
  * the dense bf16 lookup: 1e-5 of the largest tap (the same bf16
    roundings, fp32 sums in another order);
  * K3's bf16 levels: 1e-5 (the fp32 cells, summed in another order) plus
    one bf16 ulp of each element (so a cell may round the other way);
  * K1/K2 on bf16 and int8 levels: 2e-2 of the largest magnitude, the JAX
    package's own bound (``tests/test_pallas.py``); measured on these
    inputs: exact or within one bf16 ulp of one element;
  * golden EPE: 5e-3 px at fused + bf16 corr, 3e-2 px at ``throughput``
    and ``edge`` (``tests/test_epe_golden.py``).
"""

import ast
import json
import math
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

# a card machine may lack the JAX package's dependencies (it has jax but no
# flax): these modules then skip as a whole
pytest.importorskip("raft_tpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raft_tpu.kernels.corr_pallas import fused_volume_pyramid as jax_fused_volume_pyramid
from raft_tpu.kernels.lookup_xtap import FusedLookupCorrBlock as JaxFusedLookupCorrBlock
from raft_tpu.models.corr import CorrBlock as JaxCorrBlock
from raft_tpu.models.encoders import FeatureEncoder as JaxFeatureEncoder
from raft_tpu.models.layers import BottleneckBlock as JaxBottleneckBlock
from raft_tpu.models.layers import ConvNormAct as JaxConvNormAct
from raft_tpu.models.layers import ResidualBlock as JaxResidualBlock

import raft_tpu_torch as rt
from raft_tpu_torch import bench
from raft_tpu_torch.checkpoint import load_msgpack, state_dict_from_flax
from raft_tpu_torch.data import Sintel
from raft_tpu_torch.device import fp32_precision
from raft_tpu_torch.eval import validate
from raft_tpu_torch.kernels import corr_pallas, lookup_xtap
from raft_tpu_torch.models import corr
from raft_tpu_torch.models.encoders import FeatureEncoder
from raft_tpu_torch.models.layers import BottleneckBlock, Conv2d, ConvNormAct, ResidualBlock
from raft_tpu_torch.serve import PRESETS, ServeConfig

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "epe_golden"
EXPECTED = json.loads((FIXTURE / "expected.json").read_text())
# the fixture architecture (scripts/make_epe_fixture.py fixture_arch)
FIXTURE_ARCH = dict(
    feature_encoder_widths=(16, 16, 24, 32, 48),
    context_encoder_widths=(16, 16, 24, 32, 80),
    motion_corr_widths=(48,),
    motion_flow_widths=(32, 16),
    motion_out_channels=40,
    gru_hidden=48,
    flow_head_hidden=64,
    corr_levels=3,
    corr_radius=3,
)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def trained():
    return load_msgpack(str(FIXTURE / "weights.msgpack"))


def _golden_epe(model):
    ds = Sintel(str(FIXTURE), split="training", dstype="clean")
    return validate(model, ds, num_flow_updates=EXPECTED["protocol"]["iters"], fps_pairs=0)["epe"]


# -- F1: checkpoint= reads both weight formats -------------------------------------


class TestCheckpointFormats:
    def test_msgpack_loads_strict_and_equals_manual_route(self, trained):
        model = rt.raft_small(checkpoint=str(FIXTURE / "weights.msgpack"), device="cpu", **FIXTURE_ARCH)
        manual = rt.build_raft(rt.RAFT_SMALL.replace(**FIXTURE_ARCH), device="cpu")
        manual.load_state_dict(state_dict_from_flax(trained), strict=True)
        got, want = model.state_dict(), manual.state_dict()
        assert got.keys() == want.keys()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        # the same weights through the same protocol: the same EPE, bit for bit
        assert _golden_epe(model) == _golden_epe(manual)

    def test_pth_round_trip(self, tmp_path, trained):
        state = state_dict_from_flax(trained)
        path = tmp_path / "fixture.pth"
        torch.save(state, path)
        model = rt.raft_small(checkpoint=str(path), device="cpu", **FIXTURE_ARCH)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(v, state[k], rtol=0, atol=0)

    @pytest.mark.parametrize("content", [b"", b"\x80", b"not weights", b"\x93NUMPY"], ids=["empty", "empty_map", "text", "npy"])
    def test_other_files_raise_naming_both_formats(self, tmp_path, content):
        path = tmp_path / "weights.bin"
        path.write_bytes(content)
        with pytest.raises(ValueError, match=r"\.pth.*\.msgpack"):
            rt.raft_small(checkpoint=str(path), device="cpu")

    def test_pretrained_without_checkpoint_never_fetches(self):
        with pytest.raises(FileNotFoundError, match="never"):
            rt.raft_large(pretrained=True, device="cpu")
        with pytest.raises(FileNotFoundError, match="never"):
            rt.FlowEstimator.from_preset("edge", device="cpu")


# -- F2: the port pins its own precision --------------------------------------------


def _flags():
    return torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision


class TestPrecisionPin:
    @pytest.mark.parametrize("caller", ["default", "legacy_tf32", "new_api_tf32"])
    def test_flags_are_ieee_inside_and_restored_after(self, caller):
        saved = _flags()
        saved_legacy = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        try:
            if caller == "legacy_tf32":
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
            elif caller == "new_api_tf32":
                torch.backends.cuda.matmul.fp32_precision = "tf32"
                torch.backends.cudnn.conv.fp32_precision = "tf32"
            before = _flags()
            model = rt.build_raft(rt.RAFT_SMALL.replace(**FIXTURE_ARCH), device="cpu")
            seen = []
            model.feature_encoder.register_forward_hook(lambda *a: seen.append(_flags()))
            x = torch.zeros(1, 3, 128, 128)
            with torch.inference_mode():
                model(x, x, num_flow_updates=1, emit_all=False)
                state = model.begin_pair(x, x)
                model.iterate_step(state)
            assert seen and all(s == ("ieee", "ieee") for s in seen)
            assert _flags() == before
        finally:
            # the legacy setters last: they leave the two APIs consistent,
            # so later legacy reads in this process do not raise
            torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision = saved
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved_legacy

    def test_two_threads_keep_the_pin_and_restore_the_callers_flags(self):
        """Blocks that overlap in two threads: the pin holds until the last
        one closes, whichever thread opened first, and the caller's flags
        come back after both."""
        saved = _flags()
        a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
        seen = {}

        def a():
            with fp32_precision():
                a_in.set()
                b_in.wait(10)
            a_out.set()

        def b():
            a_in.wait(10)
            with fp32_precision():
                b_in.set()
                a_out.wait(10)
                seen["b_after_a_closed"] = _flags()

        try:
            torch.backends.cudnn.conv.fp32_precision = "tf32"
            torch.backends.cuda.matmul.fp32_precision = "tf32"
            before = _flags()
            threads = [threading.Thread(target=f) for f in (a, b)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(20)
            assert a_out.is_set() and seen["b_after_a_closed"] == ("ieee", "ieee")
            assert _flags() == before == ("tf32", "tf32")
        finally:
            torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision = saved

    def test_context_restores_on_error(self):
        before = _flags()
        with pytest.raises(KeyError):
            with fp32_precision():
                raise KeyError("x")
        assert _flags() == before


# -- the serving presets -------------------------------------------------------------


def _jax_presets():
    """``PRESETS`` of raft_tpu/serve/config.py, read as a literal."""
    tree = ast.parse((ROOT / "raft_tpu" / "serve" / "config.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == "PRESETS":
            value = node.value
            return {
                ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value) for kw in v.keywords}
                for k, v in zip(value.keys, value.values)
            }
    raise AssertionError("PRESETS not found")


class TestPresets:
    def test_presets_equal_the_jax_package(self):
        assert PRESETS == _jax_presets()

    @pytest.mark.parametrize("name", ["quality", "throughput", "edge"])
    def test_preset_and_overrides_equal_the_jax_package(self, name):
        from raft_tpu.serve.config import ServeConfig as JaxServeConfig

        got, want = ServeConfig.preset(name), JaxServeConfig.preset(name)
        assert (got.compute_dtype, got.corr_dtype, got.corr_impl, got.precision) == (
            want.compute_dtype, want.corr_dtype, want.corr_impl, want.precision)
        assert got.model_overrides() == want.model_overrides()

    def test_unknown_preset_raises(self):
        with pytest.raises(ValueError, match="unknown precision preset"):
            ServeConfig.preset("fastest")

    @pytest.mark.parametrize("name", ["quality", "throughput", "edge"])
    def test_presets_build_the_fp32_parameter_tree(self, name, trained):
        """Precision never touches the parameters: each preset's model has
        the fp32 model's keys and fp32 tensors, loads the same converted
        weights strictly, and stays fp32 after the load."""
        model = rt.raft_for_serving(ServeConfig.preset(name), arch="raft_small", device="cpu", **FIXTURE_ARCH)
        base = rt.build_raft(rt.RAFT_SMALL.replace(**FIXTURE_ARCH), device="cpu")
        assert model.state_dict().keys() == base.state_dict().keys()
        model.load_state_dict(state_dict_from_flax(trained), strict=True)
        assert all(v.dtype in (torch.float32, torch.int64) for v in model.state_dict().values())
        want_impl = PRESETS[name]["corr_impl"] or "dense"
        assert type(model.corr_block).__name__ == {
            "dense": "CorrBlock", "fused": "FusedLookupCorrBlock"}[want_impl]

    def test_int8_needs_fused_and_bf16_builds_everywhere(self):
        for impl in ("dense", "pallas"):
            with pytest.raises(ValueError, match="requires corr_impl='fused'"):
                rt.raft_small(corr_impl=impl, corr_dtype="int8", device="cpu")
        for impl in ("dense", "pallas", "fused"):
            m = rt.raft_small(corr_impl=impl, compute_dtype="bfloat16", device="cpu")
            assert m.corr_block.dtype == torch.bfloat16  # corr_dtype None follows compute_dtype
            assert m.update_block.flow_head.conv2.compute_dtype is None
        assert rt.raft_small(corr_impl="fused", corr_dtype="int8", device="cpu").corr_block.quantize


# -- bf16 convs ----------------------------------------------------------------------


def _fill(tree, rng):
    """Seeded values for a variable tree of shapes."""
    out = {}
    for key in sorted(tree):
        leaf = tree[key]
        if hasattr(leaf, "items"):
            out[key] = _fill(leaf, rng)
            continue
        shp = leaf.shape
        arr = {
            "kernel": lambda: rng.normal(0.0, np.sqrt(2.0 / (np.prod(shp[:-1]))), shp),
            "bias": lambda: rng.normal(0.0, 0.05, shp),
            "scale": lambda: 1.0 + rng.normal(0.0, 0.1, shp),
            "mean": lambda: rng.normal(0.0, 0.1, shp),
            "var": lambda: rng.uniform(0.5, 1.5, shp),
        }[key]()
        out[key] = arr.astype(np.float32)
    return out


def _set_bf16(module):
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.compute_dtype = torch.bfloat16


class TestBf16Convs:
    @pytest.mark.parametrize("norm", ["instance", "batch", None])
    def test_conv_norm_act(self, norm):
        rng = np.random.default_rng(3)
        x = rng.normal(size=(2, 20, 24, 8)).astype(np.float32)
        jm = JaxConvNormAct(16, 3, 2, norm, dtype=jnp.bfloat16)
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        variables = _fill(shapes, rng)
        want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)).astype(jnp.float32))
        pm = ConvNormAct(8, 16, 3, 2, norm).eval()
        sd = state_dict_from_flax({"params": {"m": variables["params"]},
                                   **({"batch_stats": {"m": variables["batch_stats"]}} if norm == "batch" else {})})
        pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
        _set_bf16(pm)
        with torch.no_grad():
            got = pm(_nchw(x))
        # the dtype Flax gives: bf16 out of a bf16 conv and instance norm, fp32 out of batch norm
        assert got.dtype == (torch.float32 if norm == "batch" else torch.bfloat16)
        assert _max_rel(got.float().permute(0, 2, 3, 1).numpy(), want) <= 2e-2

    def test_encoder_residual_batch(self):
        """raft_large's context encoder: residual blocks, batch norm."""
        rng = np.random.default_rng(4)
        widths = (8, 8, 12, 16, 24)
        x = rng.uniform(-1, 1, (1, 32, 40, 3)).astype(np.float32)
        jm = JaxFeatureEncoder(block=JaxResidualBlock, widths=widths, norm="batch", dtype=jnp.bfloat16)
        variables = _fill(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
        want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)).astype(jnp.float32))
        pm = FeatureEncoder(ResidualBlock, widths, "batch").eval()
        sd = state_dict_from_flax({c: {"e": v} for c, v in variables.items()})
        pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
        _set_bf16(pm)
        with torch.no_grad():
            got = pm(_nchw(x))
        assert got.dtype == torch.bfloat16
        assert _max_rel(got.float().permute(0, 2, 3, 1).numpy(), want) <= 2e-2

    def test_fixture_encoders(self, trained):
        """raft_small's encoders with the fixture's trained weights on a
        fixture frame, each held to 2e-2 of the JAX bf16 output (measured:
        the context encoder, no norm, equal; the feature encoder 1.2e-2, the
        instance norms amplifying single roundings that land the other
        way). The feature encoder's bf16 output is also no further from the
        fp32 output than 1.5x the JAX package's own bf16 output is (each
        ~4% of the largest magnitude from it: JAX 4.1%, the port 4.3%)."""
        from raft_tpu_torch.data import io

        frame = sorted(FIXTURE.glob("training/clean/*/*.png"))[0]
        x = (io.read_image(str(frame))[:88, :128].astype(np.float32) / 255.0 * 2.0 - 1.0)[None]
        for name, widths, norm in (("context_encoder", (16, 16, 24, 32, 80), None),
                                   ("feature_encoder", (16, 16, 24, 32, 48), "instance")):
            variables = {"params": trained["params"][name]}
            outs = {}
            for dt in (jnp.bfloat16,) if norm is None else (None, jnp.bfloat16):
                jm = JaxFeatureEncoder(block=JaxBottleneckBlock, widths=widths, norm=norm, dtype=dt)
                outs[dt] = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)).astype(jnp.float32))
            pm = FeatureEncoder(BottleneckBlock, widths, norm).eval()
            sd = state_dict_from_flax({"params": {"e": variables["params"]}})
            pm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
            _set_bf16(pm)
            with torch.no_grad():
                got = pm(_nchw(x)).float().permute(0, 2, 3, 1).numpy()
            assert _max_rel(got, outs[jnp.bfloat16]) <= 2e-2, name
            if norm is not None:
                assert _max_rel(got, outs[None]) <= 1.5 * _max_rel(outs[jnp.bfloat16], outs[None]), name


# -- correlation: dense bf16, K3 bf16, K1/K2 bf16 and int8 ------------------------------


def _corr_inputs(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    grid = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None].astype(np.float32)
    cents = (grid + rng.normal(0.0, 3.0, (b, h, w, 2))).astype(np.float32)
    return f1, f2, cents


def test_dense_bf16_lookup_matches_jax_corr_block():
    f1, f2, cents = _corr_inputs(5, 1, 8, 12, 16)
    # op by op, as the module's own methods run: under jit XLA may skip a
    # bf16 rounding of the fused x-tap products (its excess-precision rule)
    jb = JaxCorrBlock(3, 3, dtype=jnp.bfloat16)
    want = np.asarray(jb.index_pyramid(jb.build_pyramid(jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(cents)))
    pb = corr.CorrBlock(3, 3, torch.bfloat16)
    pyr = pb.build_pyramid(_nchw(f1), _nchw(f2))
    assert all(lvl.dtype == torch.bfloat16 for lvl in pyr)
    got = pb.index_pyramid(pyr, torch.from_numpy(cents)).numpy()
    assert _max_rel(got, want) <= 1e-5


def test_k3_bf16_plain_matches_jax_kernel():
    f1, f2, _ = _corr_inputs(6, 1, 12, 17, 16)
    want = jax.jit(lambda a, b: jax_fused_volume_pyramid(a, b, 3, out_dtype=jnp.bfloat16, interpret=True))(
        jnp.asarray(f1), jnp.asarray(f2))
    got = corr_pallas.fused_volume_pyramid(_nchw(f1), _nchw(f2), 3, torch.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))[..., 0]
        assert g.shape == w.shape
        # the fp32 cells agree within 1e-5 (sums in another order); rounding
        # each to bf16 adds at most one bf16 ulp of the larger of the two
        assert (np.abs(g - w) <= 1e-5 + 2.0**-7 * np.maximum(np.abs(g), np.abs(w))).all()


# raft_small's radius (S = 7) and raft_large's (S = 9), whose flat levels
# sum their corners in other orders; 3 levels keep the grid at 8 x 12
@pytest.mark.parametrize("radius,levels", [(3, 3), (4, 3)], ids=["raft_small_S7", "raft_large_S9"])
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_k1_k2_plain_match_jax_block(dtype, radius, levels):
    """The port's fused block on the CPU (the plain versions) against the
    JAX fused block with its Pallas kernels in interpret mode, at the
    deployment's product dtype: bf16 for bf16 levels (throughput), fp32
    for int8 levels (edge)."""
    f1, f2, cents = _corr_inputs(7, 1, 8, 12, 16)
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8, torch.int8)}[dtype]
    proj = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (None, None)
    s = 2 * radius + 1
    rng = np.random.default_rng(8)
    kernel = rng.normal(0.0, 0.1, (1, 1, levels * s * s, 24)).astype(np.float32)
    bias = rng.normal(0.0, 0.05, (24,)).astype(np.float32)

    jb = JaxFusedLookupCorrBlock(levels, radius, dtype=jdt, interpret=True)
    jp = jb.build_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    assert isinstance(jp, dict)  # the JAX kernel path engages at this shape

    @jax.jit
    def jax_lookup(p, c, k, b):
        return (jb.index_pyramid(p, c).astype(jnp.float32),
                jb.index_project(p, c, k, b, dtype=proj[0]).astype(jnp.float32))

    want_taps, want_proj = (np.asarray(a) for a in jax_lookup(
        jp, jnp.asarray(cents), jnp.asarray(kernel), jnp.asarray(bias)))

    pb = lookup_xtap.FusedLookupCorrBlock(levels, radius, tdt)
    pyr = pb.build_pyramid(_nchw(f1), _nchw(f2))
    assert lookup_xtap.flat_levels(pyr, radius) == (False,) + (True,) * (levels - 1)
    if dtype == "int8":
        np.testing.assert_allclose(pyr.scales.numpy(), np.asarray(jp["scales"]).ravel(), rtol=1e-6)
    taps = pb.index_pyramid(pyr, torch.from_numpy(cents))
    assert taps.dtype == torch.bfloat16  # K2's output dtype is the JAX weight_dtype
    w = torch.from_numpy(kernel.reshape(-1, 24).T.copy())
    out = pb.index_project(pyr, torch.from_numpy(cents), w, torch.from_numpy(bias), dtype=proj[1])
    assert out.dtype == (proj[1] or torch.float32)
    got_taps, got_proj = taps.float().numpy(), out.float().permute(0, 2, 3, 1).numpy()
    assert _max_rel(got_taps, want_taps) <= 2e-2
    assert _max_rel(got_proj, want_proj) <= 2e-2
    # the same arithmetic: fp32 sums in another order (1e-5 of the largest
    # value), then at most one bf16 ulp of each element where the two round
    # a row or an output the other way
    for g, w in ((got_taps, want_taps), (got_proj, want_proj)):
        assert (np.abs(g - w) <= 1e-5 * np.abs(w).max() + 2.0**-7 * np.maximum(np.abs(g), np.abs(w))).all()


def test_flat_rule_mirrors_the_jax_split():
    from raft_tpu.kernels.lookup_xtap import _split_levels

    for radius in (1, 3, 4, 5):
        for dims in [(55, 128), (47, 156), (12, 17), (46, 62), (3, 130)]:
            levels = corr_pallas.level_dims(*dims, 4)
            jax_like = [np.zeros((1,) + (hl, -(-wl // 128) * 128 if wl > 128 else wl)) for hl, wl in levels]
            want = set(_split_levels(jax_like, 2 * radius + 1)[1])
            got = lookup_xtap.flat_levels([torch.zeros(1, hl, wl) for hl, wl in levels], radius)
            assert {i for i, f in enumerate(got) if f} == want, (radius, dims)


def test_int8_quantizes_at_every_width():
    """A deliberate difference: where the JAX block cannot run its kernel (a
    y-dot level narrower than S+1) it leaves the pyramid fp32; the port's
    kernels take every width, so it quantizes."""
    f1, f2, _ = _corr_inputs(9, 1, 16, 8, 8)  # level 0 is 8 wide < S+1 = 10
    jp = JaxFusedLookupCorrBlock(2, 4, dtype=jnp.int8, interpret=True).build_pyramid(jnp.asarray(f1), jnp.asarray(f2))
    assert not isinstance(jp, dict) and jp[0].dtype == jnp.float32
    pyr = lookup_xtap.FusedLookupCorrBlock(2, 4, torch.int8).build_pyramid(_nchw(f1), _nchw(f2))
    assert isinstance(pyr, corr.QuantizedPyramid) and pyr[0].dtype == torch.int8


def test_int8_refuses_autograd():
    f1, f2, cents = _corr_inputs(10, 1, 8, 12, 8)
    pb = lookup_xtap.FusedLookupCorrBlock(3, 3, torch.int8)
    pyr = pb.build_pyramid(_nchw(f1), _nchw(f2))
    w = torch.zeros(8, 3 * 49, requires_grad=True)
    with pytest.raises(RuntimeError, match="int8.*inference-only"):
        pb.index_project(pyr, torch.from_numpy(cents), w, torch.zeros(8))
    model = rt.raft_small(corr_impl="fused", corr_dtype="int8", device="cpu", **FIXTURE_ARCH)
    x = torch.zeros(1, 3, 128, 128)
    with pytest.raises(RuntimeError, match="int8.*inference-only"):
        model(x, x, num_flow_updates=1, emit_all=False)


# -- the deployment knobs end to end -----------------------------------------------


@pytest.mark.parametrize(
    "knobs,tol",
    [
        (dict(corr_impl="fused", corr_dtype="bfloat16"), 5e-3),
        (ServeConfig.preset("throughput").model_overrides(), 3e-2),
        (ServeConfig.preset("edge").model_overrides(), 3e-2),
    ],
    ids=["fused_bf16_corr", "throughput", "edge"],
)
def test_golden_epe_at_deployment_knobs(trained, knobs, tol):
    model = rt.raft_small(device="cpu", **FIXTURE_ARCH, **knobs)
    model.load_state_dict(state_dict_from_flax(trained), strict=True)
    epe = _golden_epe(model)
    assert abs(epe - EXPECTED["reference"]["clean"]) < tol, (knobs, epe)


class _HostEvent:
    """``torch.cuda.Event`` on the host clock, for a CPU run of the bench."""

    def __init__(self, **_):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_bench_schema(capsys, monkeypatch):
    """The bench's output lines on the CPU, its shape and updates shrunk and
    the card's calls stood in for: an info line, then one metric line per
    configuration in the protocol's order."""
    monkeypatch.setattr(bench, "H", 128)
    monkeypatch.setattr(bench, "W", 128)
    monkeypatch.setattr(bench, "UPDATES", 1)
    monkeypatch.setattr(bench, "resolve_device", lambda: torch.device("cpu"))
    monkeypatch.setattr(bench, "card_line", lambda: "host, no card")
    for name, fake in [("Event", _HostEvent), ("synchronize", lambda dev=None: None),
                       ("reset_peak_memory_stats", lambda dev=None: None),
                       ("max_memory_allocated", lambda dev=None: 0),
                       ("get_device_name", lambda dev=None: "cpu")]:
        monkeypatch.setattr(torch.cuda, name, fake)
    assert bench.main(["--models", "raft_small", "--pairs", "1"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    info, metrics = lines[0], lines[1:]
    assert set(info) >= {"card", "device", "peak_memory_bytes"}
    assert [m["metric"] for m in metrics] == [
        "raft_small_sintel_fps_exact", "raft_small_sintel_fps_native", "raft_small_sintel_fps_b8",
        "raft_small_sintel_fps"]
    for m in metrics:
        assert {"metric", "value", "unit", "vs_baseline", "config"} <= set(m)
        assert m["unit"] == "pairs/s" and m["value"] > 0 and "tf32=off" in m["config"]
        assert math.isclose(m["vs_baseline"], m["value"] / 36.6, rel_tol=1e-2, abs_tol=1e-3)
        assert ("protocol" in m) == m["metric"].endswith("_b8")
    assert metrics[-1]["config"] == ("corr_impl=fused, corr_dtype=bf16, compute_dtype=bf16, "
                                     "batch=1, tf32=off")
    # raft_large's headline comes last: fused + bf16 storage, fp32 convs
    assert bench.plan("raft_large")[-1] == ("fused", "bfloat16", "float32", "", 1)
