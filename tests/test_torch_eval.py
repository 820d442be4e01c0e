"""The port's evaluation slice against the JAX package: the PNG/.flo/.pfm
readers, the msgpack weight reader, ``Sintel``, ``prefetch``, ``validate``
with the golden-EPE fixture, and whole-model flow gates for raft_small and
the fixture architecture at ``corr_impl='pallas'`` on both sides (the JAX
K3 in interpret mode).

Tolerances: readers and the weight file byte for byte; golden EPE and the
1/3/5 px shares within 1e-3 of ``expected.json`` (the JAX package's own
gate, ``tests/test_epe_golden.py``); the port's ``validate`` against the
JAX ``validate`` on the same weights within 1e-4 (a pixel crossing a
threshold moves a share by 2.7e-5 on the fixture); flows rtol 1e-4 /
atol 2e-4, as the model gates of tests/test_torch_model.py.
"""

import dataclasses
import importlib.util
import json
import os
import struct
import threading
import time
import zlib
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

# a card machine may lack the JAX package's dependencies (it has jax but no
# flax): these modules then skip as a whole
pytest.importorskip("raft_tpu")

import jax  # noqa: E402

from raft_tpu.data import io as jio
from raft_tpu.data.datasets import Sintel as JaxSintel
from raft_tpu.eval.validate import validate as jax_validate
from raft_tpu.kernels.corr_pallas import PallasCorrBlock as JaxPallasCorrBlock
from raft_tpu.models import RAFT_SMALL as JAX_RAFT_SMALL
from raft_tpu.models import build_raft as jax_build_raft
from raft_tpu.models.zoo import init_variables

import raft_tpu_torch as rt
from raft_tpu_torch.checkpoint import load_msgpack, state_dict_from_flax
from raft_tpu_torch.checkpoint.convert import unpack_msgpack
from raft_tpu_torch.data import FlowDataset, Sintel, io
from raft_tpu_torch.eval import chained_pairs_per_s, validate, validate_sintel
from raft_tpu_torch.utils import prefetch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "epe_golden"
FRAMES = sorted(str(p.relative_to(FIXTURE)) for p in FIXTURE.glob("training/*/*/*.png"))
FLOS = sorted(str(p.relative_to(FIXTURE)) for p in FIXTURE.glob("training/flow/*/*.flo"))
EXPECTED = json.loads((FIXTURE / "expected.json").read_text())
RTOL, ATOL = 1e-4, 2e-4


def _load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixture_arch():
    """The fixture architecture as the JAX package defines it."""
    return _load_module("make_epe_fixture", ROOT / "scripts" / "make_epe_fixture.py").fixture_arch()


@pytest.fixture(scope="module")
def trained():
    """The fixture's trained variable tree, read by the port's reader."""
    return load_msgpack(str(FIXTURE / "weights.msgpack"))


def _port_fixture_model(trained, corr_impl):
    chip_smoke = _load_module("chip_smoke", ROOT / "chip_smoke.py")
    model = rt.build_raft(rt.RAFT_SMALL.replace(corr_impl=corr_impl, **chip_smoke.FIXTURE_ARCH), device="cpu")
    model.load_state_dict(state_dict_from_flax(trained), strict=True)
    return model


# -- PNG ---------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _png(pixels, ctype, filt, depth=8, interlace=0):
    """A PNG of ``pixels`` (H, W, C) uint8 with every row under filter
    ``filt``; the image data split over two IDAT chunks."""
    h, w, bpp = pixels.shape
    rows, prev = [], [0] * (w * bpp)
    for y in range(h):
        cur = [int(v) for v in pixels[y].reshape(-1)]
        out = []
        for i, x in enumerate(cur):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][filt]
            out.append((x - pred) & 0xFF)
        rows.append(bytes([filt] + out))
        prev = cur
    data = zlib.compress(b"".join(rows))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    half = len(data) // 2
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", data[:half])
            + chunk(b"IDAT", data[half:]) + chunk(b"IEND", b""))


class TestPng:
    @pytest.mark.parametrize("path", FRAMES)
    def test_fixture_frames_equal_jax_reader(self, path):
        got = io.read_image(str(FIXTURE / path))
        want = jio.read_image(str(FIXTURE / path))
        assert got.dtype == np.uint8 and got.shape == want.shape == (92, 132, 3)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
    @pytest.mark.parametrize("ctype,bpp", [(0, 1), (2, 3), (6, 4)], ids=["gray", "rgb", "rgba"])
    def test_every_row_filter(self, rng, filt, ctype, bpp):
        pixels = rng.integers(0, 256, (7, 9, bpp), dtype=np.uint8)
        np.testing.assert_array_equal(io.decode_png(_png(pixels, ctype, filt)), pixels)

    @pytest.mark.parametrize("mode", ["L", "RGBA", "RGB"])
    def test_pil_written_files_equal_jax_reader(self, rng, tmp_path, mode):
        from PIL import Image

        channels = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
        arr = rng.integers(0, 256, (23, 31, channels), dtype=np.uint8)
        path = str(tmp_path / f"img_{mode}.png")
        Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(path)
        got = io.read_image(path)
        assert got.shape == (23, 31, 3)
        np.testing.assert_array_equal(got, jio.read_image(path))

    @pytest.mark.parametrize(
        "kwargs,match",
        # 16-bit samples are two bytes each: a 16-bit header over one byte
        # a sample is a truncated file
        [(dict(ctype=3), "palette"), (dict(interlace=1), "interlaced"), (dict(depth=16), "truncated"),
         (dict(ctype=4), "8- and 16-bit gray, RGB and RGBA")],
        ids=["palette", "interlaced", "16bit", "gray_alpha"],
    )
    def test_refuses_what_it_does_not_decode(self, kwargs, match):
        data = _png(np.zeros((2, 2, 1), np.uint8), kwargs.pop("ctype", 0), 0, **kwargs)
        with pytest.raises(ValueError, match=match):
            io.decode_png(data)

    def test_refuses_a_non_png(self):
        with pytest.raises(ValueError, match="signature"):
            io.decode_png(b"GIF89a" + bytes(20))


# -- flow files ----------------------------------------------------------------


class TestFlowFiles:
    @pytest.mark.parametrize("path", FLOS)
    def test_flo_equals_jax_reader(self, path):
        got = io.read_flo(str(FIXTURE / path))
        want = jio.read_flo(str(FIXTURE / path))
        assert got.dtype == np.float32 and got.shape == (92, 132, 2)
        np.testing.assert_array_equal(got, want)

    def test_flo_round_trip_and_corrupt_header(self, rng, tmp_path):
        flow = rng.normal(size=(5, 7, 2)).astype(np.float32)
        io.write_flo(str(tmp_path / "a.flo"), flow)
        np.testing.assert_array_equal(io.read_flo(str(tmp_path / "a.flo")), flow)
        np.testing.assert_array_equal(jio.read_flo(str(tmp_path / "a.flo")), flow)
        (tmp_path / "b.flo").write_bytes(b"abcd" + bytes(8))
        with pytest.raises(ValueError, match="magic"):
            io.read_flo(str(tmp_path / "b.flo"))

    @pytest.mark.parametrize("shape", [(6, 4, 2), (6, 4, 3), (6, 4)], ids=["flow", "color", "gray"])
    def test_pfm_round_trip_equals_jax_reader(self, rng, tmp_path, shape):
        data = rng.normal(size=shape).astype(np.float32)
        io.write_pfm(str(tmp_path / "a.pfm"), data)
        got = io.read_pfm(str(tmp_path / "a.pfm"))
        np.testing.assert_array_equal(got, jio.read_pfm(str(tmp_path / "a.pfm")))
        np.testing.assert_array_equal(got[..., :2] if shape == (6, 4, 2) else got, data)
        flow, valid = io.read_flow(str(tmp_path / "a.pfm"))
        assert valid is None and flow.shape[:2] == (6, 4)

    def test_read_flow_dispatch(self, tmp_path):
        flow, valid = io.read_flow(str(FIXTURE / FLOS[0]))
        assert valid is None and flow.shape == (92, 132, 2)
        # .png is KITTI's 16-bit flow with its validity channel
        rng = np.random.default_rng(0)
        jio.write_flow_png(str(tmp_path / "x.png"), rng.uniform(-9, 9, (5, 7, 2)), rng.random((5, 7)) > 0.5)
        for got, want in zip(io.read_flow(str(tmp_path / "x.png")), jio.read_flow(str(tmp_path / "x.png"))):
            np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="unsupported"):
            io.read_flow(str(tmp_path / "x.jpg"))


# -- msgpack -------------------------------------------------------------------


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class TestMsgpack:
    def test_weights_equal_flax_restore(self, trained):
        import flax.serialization

        want = dict(_leaves(flax.serialization.msgpack_restore((FIXTURE / "weights.msgpack").read_bytes())))
        got = dict(_leaves(trained))
        assert len(got) == len(want) == 106
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])

    def test_every_msgpack_type(self):
        msgpack = pytest.importorskip("msgpack")
        doc = {
            "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32, -33,
                     -128, -129, -32768, -32769, -(2**31) - 1, -(2**63)],
            "floats": [1.5, -2.25e300],
            "misc": [None, True, False],
            "strs": ["a" * 31, "b" * 32, "c" * 300, "d" * 70000],
            "bins": [b"x" * 3, b"y" * 300, b"z" * 70000],
            "long_list": list(range(20)),
            "big_map": {f"k{i}": i for i in range(20)},
        }
        assert unpack_msgpack(msgpack.packb(doc, use_bin_type=True)) == doc
        assert unpack_msgpack(msgpack.packb(1.5, use_single_float=True)) == 1.5

    def test_flax_ndarrays(self):
        import flax.serialization

        tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "i": np.array([3, -4], np.int32)}
        got = unpack_msgpack(flax.serialization.msgpack_serialize(tree))
        for k in tree:
            assert got[k].dtype == tree[k].dtype
            np.testing.assert_array_equal(got[k], tree[k])

    def test_refuses_unknown_ext_and_trailing_bytes(self):
        msgpack = pytest.importorskip("msgpack")
        with pytest.raises(ValueError, match="ext type 5"):
            unpack_msgpack(msgpack.packb(msgpack.ExtType(5, b"abc")))
        with pytest.raises(ValueError, match="trailing"):
            unpack_msgpack(msgpack.packb(1) + b"\x00")
        with pytest.raises(ValueError, match="truncated"):
            unpack_msgpack(msgpack.packb("abcdef")[:-2])


# -- datasets and prefetch -----------------------------------------------------


class TestSintel:
    @pytest.mark.parametrize("dstype", ["clean", "final"])
    def test_same_pairs_and_samples_as_jax(self, dstype):
        got = Sintel(str(FIXTURE), split="training", dstype=dstype)
        want = JaxSintel(str(FIXTURE), split="training", dstype=dstype)
        assert len(got) == len(want) == 3
        for i in range(len(want)):
            assert got.paths(i) == want.paths(i)
            a, b = got[i], want[i]
            assert sorted(a) == sorted(b) == ["flow", "image1", "image2", "valid"]
            for key in b:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key])

    def test_validity_rule_and_test_split(self, tmp_path):
        for sub in ("training/clean/s", "training/flow/s", "test/clean/s"):
            (tmp_path / sub).mkdir(parents=True)
        for split in ("training", "test"):
            for n in (1, 2):
                (tmp_path / split / "clean" / "s" / f"frame_{n:04d}.png").write_bytes(
                    _png(np.full((4, 5, 3), 7 * n, np.uint8), 2, 0))
        flow = np.zeros((4, 5, 2), np.float32)
        flow[1, 2] = (1e4, 0.0)
        io.write_flo(str(tmp_path / "training/flow/s/frame_0001.flo"), flow)
        sample = Sintel(str(tmp_path))[0]
        assert sample["valid"].sum() == 19 and not sample["valid"][1, 2]
        assert sorted(Sintel(str(tmp_path), split="test")[0]) == ["image1", "image2"]


class TestPrefetch:
    def test_order_and_exception(self):
        assert list(prefetch(iter(range(50)), depth=3)) == list(range(50))

        def boom():
            yield 1
            raise KeyError("producer failed")

        it = prefetch(boom())
        assert next(it) == 1
        with pytest.raises(KeyError, match="producer failed"):
            next(it)

    def test_abandoned_consumer_stops_the_producer(self):
        produced = []

        def slow():
            for i in range(10_000):
                produced.append(i)
                yield i

        before = threading.active_count()
        it = prefetch(slow(), depth=2)
        assert next(it) == 0
        it.close()
        deadline = time.monotonic() + 5.0
        while threading.active_count() > before and time.monotonic() < deadline:
            time.sleep(0.02)
        assert threading.active_count() == before
        assert len(produced) < 100


# -- validate and the golden EPE -------------------------------------------------


class TestValidate:
    @pytest.mark.parametrize("dstype", ["clean", "final"])
    @pytest.mark.parametrize("corr_impl", ["pallas", "dense"])
    def test_golden_epe(self, trained, corr_impl, dstype):
        """The trained fixture through the port's protocol reproduces the
        reference's EPE, as tests/test_epe_golden.py gates the JAX package."""
        model = _port_fixture_model(trained, corr_impl)
        m = validate(model, Sintel(str(FIXTURE), dstype=dstype),
                     num_flow_updates=EXPECTED["protocol"]["iters"], fps_pairs=0)
        assert abs(m["epe"] - EXPECTED["reference"][dstype]) < 1e-3, m
        gen = EXPECTED["ours_at_generation"][dstype]
        for k in ("1px", "3px", "5px"):
            assert abs(m[k] - gen[k]) < 1e-3, (k, m[k], gen[k])
        assert np.isnan(m["fps"])

    def test_equals_jax_validate_on_the_same_weights(self, trained, fixture_arch):
        jm = jax_build_raft(fixture_arch)
        want = jax_validate(jm, {"params": trained["params"]}, JaxSintel(str(FIXTURE)),
                            num_flow_updates=4, fps_pairs=0, progress=False)
        got = validate(_port_fixture_model(trained, "pallas"), Sintel(str(FIXTURE)),
                       num_flow_updates=4, fps_pairs=0)
        for k in ("epe", "1px", "3px", "5px", "f1"):
            assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])

    def test_no_ground_truth_gives_nan_not_a_score(self, trained):
        class NoTruth(FlowDataset):
            def __len__(self):
                return 2

            def __getitem__(self, idx):
                img = np.full((64, 64, 3), 40 * idx, np.uint8)
                return {"image1": img, "image2": img}

        m = validate(_port_fixture_model(trained, "dense"), NoTruth(), num_flow_updates=1, fps_pairs=2)
        assert all(np.isnan(m[k]) for k in ("epe", "1px", "3px", "5px", "f1"))
        assert m["fps"] > 0

    def test_valid_mask_off_for_sintel_on_otherwise(self, trained):
        sample = Sintel(str(FIXTURE))[0]
        flow = sample["flow"].copy()
        flow[:10] = 5e3  # marked invalid by the Sintel rule, counted only without the mask

        class One(FlowDataset):
            def __len__(self):
                return 1

            def __getitem__(self, idx):
                return dict(sample, flow=flow, valid=(np.abs(flow) < 1000).all(axis=-1))

        model = _port_fixture_model(trained, "dense")
        all_px = validate(model, One(), num_flow_updates=2, fps_pairs=0)
        masked = validate(model, One(), num_flow_updates=2, fps_pairs=0, mode="downstream")
        assert all_px["epe"] > 500 > 10 > masked["epe"]

    def test_chained_pairs_per_s_and_validate_sintel(self, trained):
        model = _port_fixture_model(trained, "pallas")
        rng = np.random.default_rng(1)
        ims = [rng.uniform(-1, 1, (96, 136, 3)).astype(np.float32) for _ in range(3)]
        assert 0 < chained_pairs_per_s(model, ims, ims[::-1], num_flow_updates=2) < float("inf")
        res = validate_sintel(model, str(FIXTURE), num_flow_updates=2, fps_pairs=3)
        assert sorted(res) == ["clean", "final"]
        assert all(np.isfinite(r["epe"]) and r["fps"] > 0 for r in res.values())


# -- whole-model flow gates -------------------------------------------------------


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
        else:
            raise KeyError(key)
        out[key] = arr.astype(np.float32)
    return out


NARROW_SMALL = dict(
    feature_encoder_widths=(8, 8, 12, 16, 32),
    context_encoder_widths=(8, 8, 12, 16, 40),
    motion_corr_widths=(16,),
    motion_flow_widths=(16, 8),
    motion_out_channels=20,
    gru_hidden=24,
    flow_head_hidden=16,
    corr_impl="pallas",
)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


class TestFlowGates:
    def _compare(self, jax_cfg, port_cfg, variables, im1, im2, iters):
        jm = jax_build_raft(
            jax_cfg, corr_block=JaxPallasCorrBlock(jax_cfg.corr_levels, jax_cfg.corr_radius, interpret=True)
        )
        want = np.asarray(
            jax.jit(partial(jm.apply, train=False, num_flow_updates=iters))(variables, im1, im2)
        )
        pm = rt.build_raft(port_cfg, device="cpu")
        pm.load_state_dict(state_dict_from_flax(variables), strict=True)
        with torch.inference_mode():
            got = pm(_nchw(im1), _nchw(im2), num_flow_updates=iters, emit_all=True)
        got = got.numpy().transpose(0, 1, 3, 4, 2)
        assert got.shape == want.shape == (iters,) + im1.shape[:3] + (2,)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    def test_raft_small_every_iteration(self):
        """Narrow raft_small (bottleneck blocks, no context norm, one 3x3
        GRU, bilinear upsample), seeded weights with the flow head scaled
        by 0.05, 3 updates."""
        jax_cfg = JAX_RAFT_SMALL.replace(**NARROW_SMALL)
        shapes = jax.eval_shape(lambda: init_variables(jax_build_raft(jax_cfg)))
        variables = _fill(shapes, np.random.default_rng(11))
        variables["params"]["update_block"]["flow_head"]["conv2"]["kernel"] *= 0.05
        rng = np.random.default_rng(12)
        im1 = rng.uniform(-1, 1, (1, 128, 136, 3)).astype(np.float32)
        im2 = np.roll(im1, (3, -2), (1, 2))
        self._compare(jax_cfg, rt.RAFT_SMALL.replace(**NARROW_SMALL), variables, im1, im2, 3)

    def test_fixture_arch_every_iteration_trained(self, trained, fixture_arch):
        """The fixture architecture with its trained weights on a real
        fixture pair (normalized, padded to 96x136), 8 updates."""
        sample = Sintel(str(FIXTURE), dstype="final")[1]
        ims = [np.pad(sample[k].astype(np.float32) / 255.0 * 2.0 - 1.0, ((2, 2), (2, 2), (0, 0)), mode="edge")[None]
               for k in ("image1", "image2")]
        chip_smoke = _load_module("chip_smoke", ROOT / "chip_smoke.py")
        port_cfg = rt.RAFT_SMALL.replace(corr_impl="pallas", **chip_smoke.FIXTURE_ARCH)
        self._compare(fixture_arch.replace(corr_impl="pallas"), port_cfg, {"params": trained["params"]},
                      ims[0], ims[1], 8)

    def test_chip_smoke_fixture_arch_equals_the_fixture_script(self, fixture_arch):
        chip_smoke = _load_module("chip_smoke", ROOT / "chip_smoke.py")
        port_cfg = rt.RAFT_SMALL.replace(**chip_smoke.FIXTURE_ARCH)
        for field in dataclasses.fields(port_cfg):
            assert getattr(port_cfg, field.name) == getattr(fixture_arch, field.name), field.name
        assert os.path.isfile(FIXTURE / "weights.msgpack")
