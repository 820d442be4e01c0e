"""Parameter-free instance norm (+ optional ReLU) as a hand-written Triton
kernel for Hopper (K5), at the JAX package's ``instance_norm_pallas``
entry point.

Replaces the Pallas TPU kernel of ``raft_tpu/kernels/inorm_pallas.py``
(``_kernel``, line 47, called at line 98). That kernel runs two phases per
image over a sequential grid: phase 0 accumulates the per-channel sum and
sum of squares in scratch, phase 1 normalizes. A GPU grid runs in no
order, so the phases become two launches here:

  * ``_inorm_stats``: grid (B*C rows, SPLIT chunks); each program sums its
    chunk of the row's H*W values and their squares in fp32 and writes
    the two partials;
  * ``_inorm_apply``: the same grid; each program adds the row's SPLIT
    partials (SPLIT is small), forms ``mean`` and
    ``var = max(E[x^2] - mean^2, 0)``, and writes
    ``(x - mean) * rsqrt(var + eps)`` (+ ReLU) for its chunk in the input
    dtype.

SPLIT is chosen so that about 512 programs run: one program per row would
leave most of the card's 132 SMs idle at the encoder's 32-64 channels.
The partials are summed in a fixed order, so the result does not change
from run to run.

What bounds it on an H100: the bytes. At the encoder stem's
``(1, 32, 220, 512)`` fp32 it must read 14.4 MB and write 14.4 MB,
8.6 us at 3.35 TB/s; the second read of each chunk mostly hits the 50 MB
L2. The arithmetic is a few operations per value.

The variance is clamped at 0, as in ``layers.instance_norm`` (the oracle;
the JAX package's ``layers.instance_norm`` clamps too). The Pallas kernel
does not clamp; the two differ only where rounding makes ``E[x^2] -
mean^2`` negative, which the clamp turns into ``rsqrt(eps)`` instead of a
NaN or a huge scale.

The plain version is :func:`instance_norm_reference`. The wrapper takes
it only for tensors on the CPU, launches the kernels or raises for CUDA
tensors, and counts one launch per call (the pair of kernels) in
``instance_norm_pallas.launches``. It is not wired into the encoders: the
JAX package does not route its model through its kernel either.
"""

from __future__ import annotations

import functools
import os

import torch

from raft_tpu_torch.graphs import count_launch
from raft_tpu_torch.kernels import build
from raft_tpu_torch.models.layers import instance_norm

__all__ = ["instance_norm_pallas", "instance_norm_reference"]

STEP = 1024  # values per program step (the kernels' BLOCK)
TARGET_PROGRAMS = 512  # about 4 per SM of an H100
NUM_WARPS = 4

# triton.language, bound by _kernels() on the first launch: this module is
# imported on machines without Triton, and the kernels below are compiled
# only where one is launched.
tl = None


def instance_norm_reference(x: torch.Tensor, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """Plain version of K5 (``layers.instance_norm`` on NCHW)."""
    return instance_norm(x, eps=eps, relu=relu)


def _inorm_stats(x_ptr, part_ptr, hw, chunk, SPLIT: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    part = tl.program_id(1)
    base = x_ptr + row.to(tl.int64) * hw
    start = part * chunk
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    acc2 = tl.zeros([BLOCK], dtype=tl.float32)
    for off in range(start, start + chunk, BLOCK):
        idx = off + tl.arange(0, BLOCK)
        v = tl.load(base + idx, mask=idx < hw, other=0.0).to(tl.float32)
        acc += v
        acc2 += v * v
    dst = part_ptr + (row * SPLIT + part) * 2
    tl.store(dst, tl.sum(acc, axis=0))
    tl.store(dst + 1, tl.sum(acc2, axis=0))


def _inorm_apply(
    x_ptr, y_ptr, part_ptr, hw, chunk, inv_n, eps,
    SPLIT: tl.constexpr, BLOCK: tl.constexpr, RELU: tl.constexpr,
):
    row = tl.program_id(0)
    part = tl.program_id(1)
    parts = part_ptr + (row * SPLIT + tl.arange(0, SPLIT)) * 2
    mean = tl.sum(tl.load(parts), axis=0) * inv_n
    var = tl.maximum(tl.sum(tl.load(parts + 1), axis=0) * inv_n - mean * mean, 0.0)
    rstd = 1.0 / tl.sqrt(var + eps)
    base = row.to(tl.int64) * hw
    start = part * chunk
    for off in range(start, start + chunk, BLOCK):
        idx = off + tl.arange(0, BLOCK)
        mask = idx < hw
        v = tl.load(x_ptr + base + idx, mask=mask, other=0.0).to(tl.float32)
        y = (v - mean) * rstd
        if RELU:
            y = tl.maximum(y, 0.0)
        tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Import Triton and JIT-wrap the two kernels (compiled per
    specialization on their first launch, cached in the git-ignored
    ``_build/triton`` unless ``TRITON_CACHE_DIR`` names another place)."""
    global tl
    os.environ.setdefault("TRITON_CACHE_DIR", str(build.BUILD_DIR / "triton"))
    import triton
    import triton.language as tl_module

    tl = tl_module
    return triton.jit(_inorm_stats), triton.jit(_inorm_apply)


def split_for(rows: int, hw: int) -> int:
    """Chunks per row: a power of two, doubled while fewer than
    TARGET_PROGRAMS programs run and a chunk keeps >= 2 steps of values."""
    split = 1
    while rows * split < TARGET_PROGRAMS and split * 2 * STEP * 2 <= hw:
        split *= 2
    return split


def instance_norm_pallas(x: torch.Tensor, eps: float = 1e-5, relu: bool = False) -> torch.Tensor:
    """K5: instance norm over H and W of NCHW ``x`` (fp32 statistics,
    optional fused ReLU); fp32 or bf16 in, the same dtype out."""
    who = "instance_norm_pallas"
    if x.dim() != 4:
        raise ValueError(f"{who}: x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{who}: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: x must be contiguous")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(f"{who} is inference-only: its input requires grad")
    if x.device.type == "cpu":
        return instance_norm_reference(x, eps=eps, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {x.device}")
    b, c, h, w = x.shape
    rows, hw = b * c, h * w
    y = torch.empty_like(x)
    if rows == 0 or hw == 0:
        return y
    split = split_for(rows, hw)
    chunk = -(-hw // (split * STEP)) * STEP
    partials = torch.empty((rows, split, 2), device=x.device, dtype=torch.float32)
    stats, apply = _kernels()
    grid = (rows, split)
    with torch.cuda.device(x.device):
        stats[grid](x, partials, hw, chunk, SPLIT=split, BLOCK=STEP, num_warps=NUM_WARPS)
        apply[grid](
            x, y, partials, hw, chunk, 1.0 / hw, float(eps),
            SPLIT=split, BLOCK=STEP, RELU=bool(relu), num_warps=NUM_WARPS,
        )
    count_launch(instance_norm_pallas)
    return y


instance_norm_pallas.launches = 0
