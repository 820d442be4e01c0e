"""Package rules of the PyTorch port: no JAX anywhere in it, and the card
by default."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import raft_tpu_torch as rt

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "raft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the JAX package and what it leans on that the card machine lacks (or
# that the port replaces with its own code)
FORBIDDEN = ("jax", "flax", "optax", "orbax", "raft_tpu", "cv2", "PIL", "msgpack", "tensorboardX")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    """No module of the port (nor the card smoke script) imports the JAX
    package (``raft_tpu``, not followed by ``_torch``) or any of
    ``FORBIDDEN``."""
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


SLICE_MODULES = (
    "raft_tpu_torch/bench.py",
    "raft_tpu_torch/device.py",
    "raft_tpu_torch/serve/__init__.py",
    "raft_tpu_torch/serve/config.py",
    "raft_tpu_torch/checkpoint/convert.py",
    "raft_tpu_torch/data/datasets.py",
    "raft_tpu_torch/data/io.py",
    "raft_tpu_torch/eval/validate.py",
    "raft_tpu_torch/kernels/corr_pallas.py",
    "raft_tpu_torch/kernels/inorm_pallas.py",
    "raft_tpu_torch/kernels/lookup_pallas.py",
    "raft_tpu_torch/utils/prefetch.py",
    "raft_tpu_torch/checkpoint/manager.py",
    "raft_tpu_torch/data/augment.py",
    "raft_tpu_torch/data/pipeline.py",
    "raft_tpu_torch/train/__init__.py",
    "raft_tpu_torch/train/__main__.py",
    "raft_tpu_torch/train/loss.py",
    "raft_tpu_torch/train/optim.py",
    "raft_tpu_torch/train/stability.py",
    "raft_tpu_torch/train/state.py",
    "raft_tpu_torch/train/step.py",
    "raft_tpu_torch/train/trainer.py",
    "raft_tpu_torch/utils/debug.py",
    "raft_tpu_torch/utils/faults.py",
    "raft_tpu_torch/utils/logging.py",
)


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_are_checked(module):
    """The evaluation, precision and training slices' modules exist and
    are among those the two no-JAX checks cover."""
    assert ROOT / module in PORT_FILES


def test_import_leaves_jax_unloaded():
    """Importing every module of the port in a fresh interpreter loads
    nothing of ``FORBIDDEN``: neither jax nor the JAX package, nor the
    image and serialization libraries it uses."""
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "raft_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(bad)); print(bad[:5])\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout


def test_default_device_is_the_card():
    """Without ``device=`` every entry point targets CUDA: with no card it
    raises rather than running on the CPU."""
    model = rt.raft_small(device="cpu")
    if torch.cuda.is_available():
        assert rt.FlowEstimator(model).device.type == "cuda"
        assert next(rt.raft_small().parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.FlowEstimator(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.raft_small()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rt.build_raft(rt.RAFT_LARGE)
