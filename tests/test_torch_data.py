"""The port's training data layer against the JAX package: 16-bit flow
PNGs and PPM images, the FlyingChairs / FlyingThings3D / KITTI / HD1K /
Concat / Repeat datasets, the augmentor, the training pipeline with its
fault policy, and ``validate(mode='downstream')`` on a KITTI tree.

Trees are synthetic, written from seeds in each dataset's layout (images
by PIL or as raw PPM, flows by the JAX package's writers, cv2 for KITTI's
16-bit PNGs).

Tolerances: readers, datasets and the pipeline exactly (the pipeline test
gives both pipelines the port's augmentor, so only the pipelines differ);
the augmentor's images 5e-3 on their 0-255 scale and flows 1e-4 of their
largest magnitude, valid masks exactly: its resize and RGB<->HSV are numpy
where the JAX one calls OpenCV, which rounds its bilinear blend otherwise
(measured on these cases: images 1.08e-3, flows equal);
``validate`` EPE and F1 1e-4 relative, the px shares 1e-4 (a pixel
crossing a threshold), as tests/test_torch_eval.py.
"""

import os

import numpy as np
import pytest
import torch

# a card machine may lack the JAX package's dependencies (it has jax but no
# flax): these modules then skip as a whole
pytest.importorskip("raft_tpu")

from PIL import Image  # noqa: E402

from raft_tpu.data import datasets as jds  # noqa: E402
from raft_tpu.data import io as jio  # noqa: E402
from raft_tpu.data.augment import AugmentConfig as JaxAugmentConfig  # noqa: E402
from raft_tpu.data.augment import FlowAugmentor as JaxFlowAugmentor  # noqa: E402
from raft_tpu.data.pipeline import TrainPipeline as JaxTrainPipeline  # noqa: E402
from raft_tpu.eval.validate import validate as jax_validate  # noqa: E402
from raft_tpu.models import build_raft as jax_build_raft  # noqa: E402
from raft_tpu.utils.faults import DataFaultPolicy as JaxDataFaultPolicy  # noqa: E402
from tests.test_torch_train import _port_cfg, _variables  # noqa: E402
from tests.test_train import tiny_cfg  # noqa: E402

import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.checkpoint import state_dict_from_flax  # noqa: E402
from raft_tpu_torch.data import datasets as pds  # noqa: E402
from raft_tpu_torch.data import io as pio  # noqa: E402
from raft_tpu_torch.data.augment import AugmentConfig, FlowAugmentor  # noqa: E402
from raft_tpu_torch.data.pipeline import TrainPipeline  # noqa: E402
from raft_tpu_torch.eval import validate  # noqa: E402
from raft_tpu_torch.utils.faults import BadSampleBudgetError, DataFaultPolicy  # noqa: E402

torch.set_num_threads(2)

IMAGE_TOL, FLOW_TOL, SHARE_TOL = 5e-3, 1e-4, 1e-4


def _png(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def _flow(rng, h, w):
    return rng.uniform(-20, 20, (h, w, 2)).astype(np.float32)


# -- readers -------------------------------------------------------------------


def test_flow_png_both_ways(tmp_path):
    """KITTI flow PNGs: written by the JAX package (cv2) and read alike by
    both; written by the port and read by the JAX reader; a corrupt file
    is a ValueError, a missing one FileNotFoundError."""
    rng = np.random.default_rng(0)
    flow, valid = _flow(rng, 37, 53), rng.random((37, 53)) > 0.4
    jio.write_flow_png(str(tmp_path / "j.png"), flow, valid)
    for got, want in zip(pio.read_flow_png(str(tmp_path / "j.png")), jio.read_flow_png(str(tmp_path / "j.png"))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    pio.write_flow_png(str(tmp_path / "p.png"), flow, valid)
    jf, jv = jio.read_flow_png(str(tmp_path / "p.png"))
    pf, pv = pio.read_flow(str(tmp_path / "p.png"))
    assert np.array_equal(pf, jf) and np.array_equal(pv, jv) and np.array_equal(pv, valid)
    assert np.abs(pf - flow).max() <= 1 / 64
    data = (tmp_path / "p.png").read_bytes()
    (tmp_path / "bad.png").write_bytes(data[:60] + bytes(40) + data[100:])
    with pytest.raises(ValueError):
        pio.read_flow_png(str(tmp_path / "bad.png"))
    with pytest.raises(FileNotFoundError):
        pio.read_flow_png(str(tmp_path / "missing.png"))


def test_ppm_reads_like_pil(tmp_path):
    """P6 (PIL-written, and with a header comment) and P5 read as PIL
    reads them (the JAX package's ``read_image``)."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (31, 45, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "a.ppm")
    (tmp_path / "b.ppm").write_bytes(b"P6\n# a comment\n45 31\n255\n" + img.tobytes())
    gray = rng.integers(0, 256, (31, 45), dtype=np.uint8)
    Image.fromarray(gray).save(tmp_path / "c.pgm")
    for name in ("a.ppm", "b.ppm", "c.pgm"):
        got, want = pio.read_image(str(tmp_path / name)), jio.read_image(str(tmp_path / name))
        assert got.shape == want.shape == (31, 45, 3) and np.array_equal(got, want)


# -- datasets -------------------------------------------------------------------


def _chairs(root, rng, n=4, h=24, w=32):
    os.makedirs(root / "data")
    for i in range(n):
        for k in (1, 2):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / "data" / f"{i:05d}_img{k}.ppm")
        jio.write_flo(str(root / "data" / f"{i:05d}_flow.flo"), _flow(rng, h, w))
    np.savetxt(root / "FlyingChairs_train_val.txt", [1, 2, 1, 1][:n], fmt="%d")


def _things(root, rng, frames=3, h=24, w=32):
    for seq in ("A/0000", "B/0001"):
        for cam, tag in (("left", "L"), ("right", "R")):
            for i in range(frames):
                _png(str(root / "frames_cleanpass/TRAIN" / seq / cam / f"{i + 6:04d}.png"),
                     rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
                for direction, word in (("into_future", "Future"), ("into_past", "Past")):
                    d = root / "optical_flow/TRAIN" / seq / direction / cam
                    os.makedirs(d, exist_ok=True)
                    jio.write_pfm(str(d / f"OpticalFlowInto{word}_{i + 6:04d}_{tag}.pfm"), _flow(rng, h, w))


def _kitti(root, rng, n=3, h=24, w=40):
    for i in range(n):
        for k in (10, 11):
            _png(str(root / "training/image_2" / f"{i:06d}_{k}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        os.makedirs(root / "training/flow_occ", exist_ok=True)
        jio.write_flow_png(str(root / "training/flow_occ" / f"{i:06d}_10.png"), _flow(rng, h, w),
                           rng.random((h, w)) > 0.6)


def _hd1k(root, rng, h=24, w=40):
    for seq, frames in (("000000", 3), ("000001", 2)):
        for i in range(frames):
            name = f"{seq}_{i:04d}.png"
            _png(str(root / "hd1k_input/image_2" / name), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            os.makedirs(root / "hd1k_flow_gt/flow_occ", exist_ok=True)
            jio.write_flow_png(str(root / "hd1k_flow_gt/flow_occ" / name), _flow(rng, h, w), rng.random((h, w)) > 0.5)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    rng = np.random.default_rng(2)
    roots = {name: tmp_path_factory.mktemp(name) for name in ("chairs", "things", "kitti", "hd1k")}
    _chairs(roots["chairs"], rng)
    _things(roots["things"], rng)
    _kitti(roots["kitti"], rng)
    _hd1k(roots["hd1k"], rng)
    return roots


def _same_samples(port, jax_ds):
    assert len(port) == len(jax_ds) > 0
    assert port.sparse == getattr(jax_ds, "sparse", False)
    for i in range(len(port)):
        assert port.paths(i) == jax_ds.paths(i)
        got, want = port[i], jax_ds[i]
        assert set(got) == set(want)
        for key in want:
            assert np.array_equal(np.asarray(got[key]), np.asarray(want[key])), (i, key)


@pytest.mark.parametrize("name", ["chairs_train", "chairs_val", "things", "kitti", "hd1k", "concat_repeat"])
def test_datasets_match_jax(trees, name):
    """Same pairs, in the same order, and the same samples."""
    if name.startswith("chairs"):
        split = name.split("_")[1]
        ports = pds.FlyingChairs(str(trees["chairs"]), split=split)
        _same_samples(ports, jds.FlyingChairs(str(trees["chairs"]), split=split))
        assert len(ports) == (3 if split == "train" else 1)
    elif name == "things":
        ports = pds.FlyingThings3D(str(trees["things"]))
        assert len(ports) == 2 * 2 * 2 * 2  # cameras x directions x sequences x pairs
        _same_samples(ports, jds.FlyingThings3D(str(trees["things"])))
    elif name == "kitti":
        _same_samples(pds.Kitti(str(trees["kitti"])), jds.Kitti(str(trees["kitti"])))
        assert pds.Kitti(str(trees["kitti"]))[0]["sparse"] is True
    elif name == "hd1k":
        ports = pds.HD1K(str(trees["hd1k"]))
        assert len(ports) == 3
        _same_samples(ports, jds.HD1K(str(trees["hd1k"])))
    else:
        port = pds.ConcatDataset([pds.RepeatDataset(pds.Kitti(str(trees["kitti"])), 2),
                                  pds.FlyingChairs(str(trees["chairs"]))])
        want = jds.ConcatDataset([jds.RepeatDataset(jds.Kitti(str(trees["kitti"])), 2),
                                  jds.FlyingChairs(str(trees["chairs"]))])
        assert len(port) == len(want) == 9
        for i in range(len(want)):
            assert port.paths(i) == want.paths(i)
        got, ref = port[7], want[7]
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
        with pytest.raises(ValueError):
            pds.RepeatDataset(pds.Kitti(str(trees["kitti"])), 0)


# -- augmentation -------------------------------------------------------------


def _sample(rng, sparse, h=60, w=84):
    sample = {
        "image1": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "image2": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
        "flow": _flow(rng, h, w),
        "valid": rng.random((h, w)) > (0.6 if sparse else -1.0),
    }
    if sparse:
        sample["sparse"] = True
    return sample


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_augmentor_matches_jax(sparse):
    """20 seeds per mode, one of them with a frame smaller than the crop
    (the forced resize): the same crops, flips and masks; images and flows
    within the resize's float gap."""
    cfg = dict(crop_size=(48, 64), min_scale=-0.2, max_scale=0.5)
    port, ref = FlowAugmentor(AugmentConfig(**cfg)), JaxFlowAugmentor(JaxAugmentConfig(**cfg))
    gap = {"image": 0.0, "flow": 0.0}
    for seed in range(20):
        sample = _sample(np.random.default_rng(100 + seed), sparse, *((40, 56) if seed == 0 else (60, 84)))
        got = port(np.random.default_rng(seed), dict(sample))
        want = ref(np.random.default_rng(seed), dict(sample))
        assert set(got) == set(want)
        assert np.array_equal(got["valid"], want["valid"]), seed
        for key, tol, what in (("image1", IMAGE_TOL, "image"), ("image2", IMAGE_TOL, "image"),
                               ("flow", FLOW_TOL, "flow")):
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype
            err = float(np.abs(got[key] - want[key]).max())
            scale = 1.0 if what == "image" else max(float(np.abs(want[key]).max()), 1.0)
            assert err <= tol * scale, (seed, key, err)
            gap[what] = max(gap[what], err)
    assert gap["image"] > 0.0 or sparse  # the numpy blend is not OpenCV's, bit for bit


# -- the pipeline ---------------------------------------------------------------


class _ListDataset:
    """In-memory samples; ``faults`` maps an index to the exceptions its
    reads raise, in order (then it reads fine)."""

    def __init__(self, samples, faults=None):
        self.samples = samples
        self.faults = {k: list(v) for k, v in (faults or {}).items()}

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        if self.faults.get(i):
            raise self.faults[i].pop(0)
        return self.samples[i]


def _samples(n=7):
    rng = np.random.default_rng(4)
    return [_sample(rng, False, 56, 72) for _ in range(n)]


def _batches(pipe, n):
    it = iter(pipe)
    out = [next(it) for _ in range(n)]
    it.close()
    return out


def _host_batches(pipe, n):
    gen = pipe._make_batches()
    out = [next(gen) for _ in range(n)]
    gen.close()
    return out


def _nhwc(batch):
    return {k: (v.permute(0, 2, 3, 1) if v.ndim == 4 else v).numpy() for k, v in batch.items()}


def test_pipeline_matches_jax():
    """Three batches through both pipelines (one augmentor, the port's),
    then a pipeline started at step 2: the same batches exactly."""
    samples = _samples()
    aug = FlowAugmentor(AugmentConfig(crop_size=(48, 64)))
    port = _batches(TrainPipeline(_ListDataset(samples), 3, augmentor=aug, seed=5, device="cpu"), 3)
    ref = _batches(JaxTrainPipeline(_ListDataset(samples), 3, augmentor=aug, seed=5), 3)
    for got, want in zip(port, ref):
        got = _nhwc(got)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == np.float32 and np.array_equal(got[key], np.asarray(want[key])), key
    assert port[0]["image1"].shape == (3, 3, 48, 64) and port[0]["flow"].shape == (3, 2, 48, 64)
    resumed = _batches(TrainPipeline(_ListDataset(samples), 3, augmentor=aug, seed=5, device="cpu", start_step=2), 1)
    assert all(torch.equal(resumed[0][k], port[2][k]) for k in port[2])
    with pytest.raises(NotImplementedError, match="queue 1 item 2d"):
        TrainPipeline(_ListDataset(samples), 3, device="cpu", window_size=2)


def test_pipeline_fault_policy_matches_jax():
    """A corrupt sample (a ValueError at every read) is quarantined and its
    slot refilled each time it is drawn, an OSError is retried and then
    read; the counters and batches match the JAX pipeline's; a second
    distinct bad sample past a budget of one raises. The counters are
    compared over exactly 3 host batches (each pipeline's batch generator,
    without the prefetch thread, which may have built more by the time
    they are read)."""
    samples = _samples()
    faults = {2: [ValueError("corrupt")] * 9, 4: [OSError("flaky")]}
    policy = dict(max_bad_samples=4, max_retries=2, base_delay=0.001)
    port = TrainPipeline(_ListDataset(samples, faults), 3, seed=1, device="cpu", fault_policy=DataFaultPolicy(**policy))
    ref = JaxTrainPipeline(_ListDataset(samples, faults), 3, seed=1, fault_policy=JaxDataFaultPolicy(**policy))
    got, want = _host_batches(port, 3), _host_batches(ref, 3)
    for g, w in zip(got, want):
        assert set(g) == set(w) and all(np.array_equal(g[k], w[k]) for k in w)
    assert port.counters == ref.counters and port.counters["data/retries"] == 1
    assert port.quarantined == ref.quarantined == {2}
    bad = {2: [ValueError("corrupt")] * 9, 5: [ValueError("corrupt")] * 9}
    pipe = TrainPipeline(_ListDataset(samples, bad), 7, seed=1, device="cpu",
                         fault_policy=DataFaultPolicy(max_bad_samples=1, base_delay=0.001))
    with pytest.raises(BadSampleBudgetError):
        _batches(pipe, 1)


# -- KITTI validation -----------------------------------------------------------


def test_validate_downstream_matches_jax(tmp_path):
    """The port's ``validate(mode='downstream')`` and the JAX one on a
    synthetic KITTI tree (sparse ground truth, frames padded at the
    bottom), the same tiny raft_small weights, 2 updates: EPE, F1 and the
    px shares."""
    rng = np.random.default_rng(6)
    for i in range(2):
        for k in (10, 11):
            _png(str(tmp_path / "training/image_2" / f"{i:06d}_{k}.png"),
                 rng.integers(0, 256, (122, 132, 3), dtype=np.uint8))
        os.makedirs(tmp_path / "training/flow_occ", exist_ok=True)
        jio.write_flow_png(str(tmp_path / "training/flow_occ" / f"{i:06d}_10.png"),
                           rng.uniform(-3, 3, (122, 132, 2)).astype(np.float32), rng.random((122, 132)) > 0.5)
    jcfg = tiny_cfg(False)
    jm = jax_build_raft(jcfg)
    variables = _variables(jm)
    model = rt.build_raft(_port_cfg(jcfg), device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    want = jax_validate(jm, variables, jds.Kitti(str(tmp_path)), num_flow_updates=2, mode="downstream", fps_pairs=0)
    got = validate(model, pds.Kitti(str(tmp_path)), num_flow_updates=2, mode="downstream", fps_pairs=0)
    for key in ("epe", "f1"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    for key in ("1px", "3px", "5px"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=SHARE_TOL, err_msg=key)
    assert 0.0 < got["f1"] < 1.0
