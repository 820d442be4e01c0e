#!/usr/bin/env python3
"""Card smoke test of the PyTorch port (``raft_tpu_torch``).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  1. card: name and power limit from nvidia-smi; the TF32 flags are left
     at torch's defaults (the plain versions' matmuls are IEEE fp32 by
     default, and the model pins its own precision), and logged;
  2. build: every CUDA kernel of the package from this checkout's sources,
     one nvcc per source, all started together (the Triton kernel compiles
     on its first launch, into the same git-ignored ``_build/``), the
     count of tensor-core instructions in K1's and K3's SASS
     (``cuobjdump``; each bf16-product instantiation of K1 must hold bf16
     HMMA and no TF32 one, each instantiation of K3's Hopper form TF32
     HGMMA (wgmma) and no HMMA), and K1's and K3's registers and spills
     from ptxas;
  3. kernels: each kernel (K1-K5) against its plain PyTorch version on the
     card, at the main paths' shapes and edge cases, with times per launch,
     the card's bound for the same work and, where one PyTorch call or a
     chain of them computes the same function (K1: grid_sample + addmm +
     relu; K2, K4: grid_sample per level; K3: the plain matmul +
     avg_pool2d chain; K5: F.instance_norm), its time; then the
     reduced-precision forms: K1 and K2 on bf16 and int8 levels (K1 with
     an fp32 and a bf16 product) and K3 storing bf16 levels, each against
     its plain version, timed, bounded (2x and 4x fewer level bytes) and
     beside its library chain; and K1's fp32 and bf16/bf16 forms timed at
     batch 8 (Q = 56320), the launch of the serving pool's tick and the
     bench's ``_b8`` lines, and K2's bf16 and int8 forms at raft_small and
     batch 8; NaN cases: K1's fp32 form, K2's fp32 form and K4 on NaN
     centroids and K3's two forms on NaN features (both NaN bit patterns)
     give NaN exactly where their plain versions do;
  4. main path: raft_large (full widths, seeded random weights) with
     ``corr_impl='fused'`` answering 3 raw uint8 436x1024 requests at 32
     updates, first with ``FlowEstimator``'s model called eagerly on its
     prepared inputs (the launch counts show K1 ran once per update; the
     same weights through ``corr_impl='dense'`` give the same flow; one
     more request runs under torch.profiler), then through
     ``FlowEstimator`` itself, by CUDA-graph replay: bit for bit the eager
     flow, K1 once per update inside the graph, latency and a profile;
  5. materialize path: the block's raw correlation features
     (``LazyCorrFeatures.materialize``) through K2, on fp32 levels here and
     on bf16 and int8 levels below;
  6. throughput path: raft_large through
     ``FlowEstimator.from_preset("throughput", pretrained=False)`` (bf16
     convs and pyramid, K1's bf16 product), 3 requests eagerly after a
     warm-up, K1 once per update on bf16 levels, latency, peak memory, a
     profile, and the same graphed; the TF32 flags are checked unchanged
     after the model calls;
  7. golden EPE: the trained fixture weights read by
     ``raft_small(checkpoint=<the fixture's .msgpack>)``, Sintel through
     ``validate`` at 32 updates at 'pallas', 'fused' and 'quality' (clean
     and final, 1e-3 px), fused + bf16 corr and 'pallas' + bf16 corr (5e-3
     px), and the 'throughput' and 'edge' presets (3e-2 px);
  8. full-width Sintel path: raft_small (full widths, seeded, flow head
     scaled) with ``corr_impl='pallas'``: 3 synthetic 436x1024 pairs
     through ``validate`` (K3 once per pair), fps from
     ``chained_pairs_per_s``, latency and peak memory, the same weights at
     ``'dense'`` giving the same flow, one request under torch.profiler;
     then the same weights with ``corr_dtype='bfloat16'`` through
     ``validate`` over the same pairs (K3's bf16 form once per pair);
  9. bench: ``python -m raft_tpu_torch.bench`` at 2 pairs a configuration
     (each configuration's call captured once as a CUDA graph and
     replayed), then ``--train`` at 2 steps a model, the lines checked
     against the protocol's schema;
 10. serving: ``ServeEngine`` over raft_large (the main path's weights) at
     'quality' (fused) and 'throughput', bucket 440x1024, pool capacity 8,
     warmed (every program captured as a CUDA graph), 24 requests of
     436x1024 from 8 threads at targets 32/20/12: each at its own target,
     the flow against the graphed ``FlowEstimator`` at the same target
     (quality 1e-3 / 5e-2 px mean / max; throughput 0.1 / 2), no capture
     after warm-up, boot, requests/s, p50/p99, K1 launches a tick and in
     the run, the idle share of a profiled burst (the device-time ledger
     off for both), then the device time per program family from the
     ledger in a burst of its own, peak memory; then the golden fixture
     through the engine at 'quality' (1e-3 px);
 11. training: ``Trainer`` at raft_large's chairs stage, full width (batch
     8, crop 368x496, 12 updates, dense fp32), on a synthetic FlyingChairs
     tree of 24 pairs at 384x512: 8 steps, a checkpoint every 4, a
     boundary every 2 (finite losses), preempted after step 4 and resumed
     by a second Trainer (its state the saved one bit for bit, its
     pipeline continuing the index stream), step times, pairs/s, peak
     memory, checkpoint save/restore seconds, no kernel of the port
     launched; then the loss must fall over 8 steps on one fixed batch,
     one step profiled (idle share); the TF32 flags are checked unchanged;
 12. entry-point paths: ``lookup_pyramid_pallas`` (K4) and
     ``instance_norm_pallas`` (K5), each called once at the shapes above.

The last line is a JSON object ``{"ok": true, "device": {...}}``; the line
before it the card's name and power limit; before that a ``{"kernels":
[...]}`` JSON line. Without a card, or outside the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "epe_golden"

# NVIDIA H100 SXM published peaks (dense): fp32 outside the tensor cores,
# TF32 and bf16 on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SINTEL = (1, 55, 128)  # the /8 feature grid at 440x1024
RADIUS, LEVELS, C_OUT, FEAT = 4, 4, 256, 256
LOOKUP_TOL = 1e-5  # a 4-term fp32 bilinear sum per tap, summed in another order
PROJECT_TOL = 1e-4  # a 324-term fp32 dot per output, summed in another order
VOLUME_TOL = 1e-4  # K3: a 128- or 256-term fp32 dot per cell, summed in another order
INORM_TOL = 1e-5  # K5 fp32: sums over H*W in another order
BF16_RTOL = 2.0**-7  # K5 bf16 I/O: one bf16 rounding step
FLOW_MEAN_TOL, FLOW_MAX_TOL = 1e-3, 5e-2  # px after 32 updates, kernel vs dense
EPE_TOL = 1e-3  # px, golden EPE vs the reference (tests/test_epe_golden.py)
REQUESTS, UPDATES, IMAGE = 3, 32, (436, 1024)
# Seeded random weights move the flow tens of pixels per update and the
# recurrence then amplifies fp32 rounding without bound; scaling the flow
# head's last conv makes an update move it about a pixel, as a trained
# model's late updates do.
FLOW_HEAD_SCALE = 0.01
# The golden fixture's architecture: raft_small with these overrides
# (scripts/make_epe_fixture.py fixture_arch, which imports the JAX package)
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


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time per call, from CUDA events around ``reps`` calls.

    A sleep kernel holds the card while the host enqueues the calls, so
    the events time the card's work back to back: for a kernel shorter
    than its wrapper's host cost they would otherwise time the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(400_000_000)  # ~0.2 s of the card's clock
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms > slept.elapsed_time(start):
        log(f"cuda_ms: the host took {host_ms:.3f} ms to enqueue {reps} calls, longer than the "
            "sleep: the card may have idled inside the timed window")
    return start.elapsed_time(end) / reps


def window_bytes(pyramid, cents, radius) -> int:
    """Bytes of pyramid the lookup needs for these centroids: per query and
    level, the in-range part of the (S+1)x(S+1) window its taps' corners
    touch."""
    s = 2 * radius + 1
    c = cents.reshape(-1, 2).double()
    total = 0
    for level, vol in enumerate(pyramid):
        hl, wl = vol.shape[1], vol.shape[2]
        start = torch.floor(c / 2.0**level) - radius  # first corner, (x, y)
        lo = start.clamp(min=0)
        hi = torch.minimum(start + s, torch.tensor([wl - 1.0, hl - 1.0], device=c.device, dtype=c.dtype))
        n = (hi - lo + 1).clamp(min=0)
        total += int((n[:, 0] * n[:, 1]).sum().item()) * vol.element_size()
    return total


def bound(nbytes: float, ops: float, tf32_ops: float = 0.0, bf16_ops: float = 0.0):
    """The least time in ms for this work: bytes at the HBM rate against
    ``ops`` at the fp32 FMA rate plus ``tf32_ops`` at the TF32 and
    ``bf16_ops`` at the bf16 tensor-core rate, whichever is longer."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = (ops / PEAK_FP32_FLOPS + tf32_ops / PEAK_TF32_FLOPS + bf16_ops / PEAK_BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hmma_counts(lib_path, kernel: str):
    """Tensor-core instructions by kind, mma.sync's (``HMMA.1688.F32.TF32``,
    ``HMMA.16816.F32.BF16``, ...) and wgmma's (``HGMMA.64x128x8.F32.TF32``,
    ...), in the SASS of each function of a built library whose (mangled)
    name contains ``kernel``, from ``cuobjdump``."""
    from raft_tpu_torch.kernels import build

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[-1].strip()
            fn = fn if kernel in fn else None
            if fn:
                counts[fn] = {}
        elif fn and ("HMMA" in line or "HGMMA" in line):
            kind = next(t for t in line.split() if t.startswith(("HMMA", "HGMMA")))
            counts[fn][kind] = counts[fn].get(kind, 0) + 1
    return counts


def hmma_count(lib_path, kernel: str) -> int:
    """All tensor-core instructions of :func:`hmma_counts`."""
    return sum(sum(kinds.values()) for kinds in hmma_counts(lib_path, kernel).values())


def check_k3_wgmma(lib_path) -> str:
    """K3's Hopper form (corr_pyramid_wgmma_kernel, bf16 and fp32 levels):
    each instantiation must run its products on wgmma, TF32 HGMMA and no
    HMMA. Returns a summary; raises otherwise."""
    counts = hmma_counts(lib_path, "corr_pyramid_wgmma_kernel")
    parts = []
    for fn, kinds in counts.items():
        n_hgmma = sum(n for k, n in kinds.items() if k.startswith("HGMMA") and "TF32" in k)
        if n_hgmma == 0 or any(k.startswith("HMMA") for k in kinds):
            raise AssertionError(f"K3 {fn}: tensor-core instructions {kinds}, expected TF32 HGMMA only")
        parts.append(f"{'bf16' if 'nv_bfloat16' in fn else 'fp32'} {kinds}")
    if len(parts) != 2:
        raise AssertionError(f"K3's Hopper form has {len(parts)} instantiations in its SASS, expected 2")
    return "; ".join(parts)


def check_k1_products(lib_path) -> str:
    """K1's instantiations by product (template argument kBf16, ``Lb1E`` in
    the mangled name): the bf16 ones must hold bf16 HMMA and no TF32 one,
    the 3xTF32 ones TF32 HMMA. Returns a summary; raises otherwise."""
    parts = []
    for fn, kinds in hmma_counts(lib_path, "xtap_project_kernel").items():
        bf16 = "Lb1E" in fn
        n_bf16 = sum(n for k, n in kinds.items() if "BF16" in k)
        n_tf32 = sum(n for k, n in kinds.items() if "TF32" in k)
        if (bf16 and (n_bf16 == 0 or n_tf32)) or (not bf16 and n_tf32 == 0):
            raise AssertionError(f"K1 {fn}: HMMA {kinds} does not match its {'bf16' if bf16 else '3xTF32'} product")
        parts.append(f"{'bf16' if bf16 else '3xTF32'} {kinds}")
    if len(parts) != 6:
        raise AssertionError(f"K1 has {len(parts)} instantiations in its SASS, expected 6")
    return "; ".join(parts)


def ptxas_usage(log_text: str, kernel: str) -> str:
    """The ptxas report (registers, spills, shared memory) of the entry
    functions whose name contains ``kernel``, from an ``-Xptxas -v`` log."""
    lines, inside = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
        elif inside and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines) or "not in the log (library built earlier)"


def counters():
    """The launch-counting wrapper of every kernel, by kernel (K1-K5)."""
    from raft_tpu_torch.kernels import corr_pallas, inorm_pallas, lookup_pallas, lookup_xtap

    return {
        "k1": lookup_xtap.lookup_project_fused,
        "k2": lookup_xtap.lookup_pyramid_fused,
        "k3": corr_pallas.fused_volume_pyramid,
        "k4": lookup_pallas.lookup_pyramid_pallas,
        "k5": inorm_pallas.instance_norm_pallas,
    }


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def by_kernel(graph_launches):
    """Graph launches keyed by wrapper name (``GraphProgram.launches``,
    ``graph_launches()``), keyed by kernel instead."""
    return {k: graph_launches.get(fn.__name__, 0) for k, fn in counters().items()}


def kernel_inputs(device, b, h, w, cent_lo=None, cent_hi=None, seed=0, radius=RADIUS, c_out=C_OUT):
    """Pyramid of a random-feature correlation volume, centroids, and
    convcorr1-shaped weights. Centroids are the grid plus a smooth random
    flow unless a uniform range is given."""
    from raft_tpu_torch.models.corr import correlation_volume, pool_pyramid
    from raft_tpu_torch.ops.sampling import coords_grid

    gen = torch.Generator(device=device).manual_seed(seed)
    f1 = torch.randn(b, FEAT, h, w, device=device, generator=gen)
    f2 = torch.randn(b, FEAT, h, w, device=device, generator=gen)
    pyramid = pool_pyramid(correlation_volume(f1, f2), LEVELS)
    if cent_lo is None:
        flow = torch.randn(b, 2, h, w, device=device, generator=gen) * 6.0
        cents = (coords_grid(b, h, w, device=device) + flow).permute(0, 2, 3, 1).contiguous()
    else:
        cents = torch.rand(b, h, w, 2, device=device, generator=gen) * (cent_hi - cent_lo) + cent_lo
    c_in = LEVELS * (2 * radius + 1) ** 2
    weight = torch.randn(c_out, c_in, device=device, generator=gen) * math.sqrt(2.0 / c_out)
    bias = torch.randn(c_out, device=device, generator=gen) * 0.05
    return pyramid, cents, weight, bias


LOOKUP_CASES = {
    "sintel": dict(b=1, h=55, w=128),
    "kitti_ragged_q": dict(b=1, h=47, w=156),
    "batch2": dict(b=2, h=55, w=128),
    "odd_levels": dict(b=1, h=45, w=99),
    "far_out_of_range": dict(b=1, h=55, w=128, cent_lo=-600.0, cent_hi=700.0),
    # raft_small fused: r 3, C_in 196, convcorr1 to 96 channels
    "raft_small_fused": dict(b=1, h=55, w=128, radius=3, c_out=96),
    # h*w = 7285 is odd: K1's 32-query tiles cross the batch boundary mid-tile
    "batch2_ragged_hw": dict(b=2, h=47, w=155),
    # the serving pool's tick at capacity 8: Q = 56320, levels of ~1.6 GB
    "serving_batch8": dict(b=8, h=55, w=128),
}


def k2_library_chain(pyramid, cents, radius, scales=None):
    """K2's (and K4's) function as a chain of PyTorch calls (the torchvision
    formulation): per level ``F.grid_sample`` of the (S, S) offsets around
    the centroid (align_corners=True, zero padding), concatenated in the
    reference channel order, ``(Q, L*S*S)`` fp32 (bf16 levels widened and
    int8 levels dequantized by ``scales`` first, grid_sample taking one
    dtype for values and coordinates). Levels need 2 px a side (the
    align_corners normalisation divides by size - 1). A yardstick only: the
    port never calls it."""
    b, h, w, _ = cents.shape
    q, s = b * h * w, 2 * radius + 1
    d = torch.arange(-radius, radius + 1, device=cents.device, dtype=torch.float32)
    off = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # [i, j] = (d_i, d_j): x, y
    taps = []
    for level, vol in enumerate(pyramid):
        hl, wl = vol.shape[1], vol.shape[2]
        if min(hl, wl) < 2:
            raise ValueError(f"k2_library_chain: level {level} is {hl}x{wl}, under 2 px a side")
        vol = vol.float() * scales[level] if scales is not None else vol.float()
        xy = cents.reshape(q, 1, 1, 2) / 2.0**level + off
        grid = torch.stack((xy[..., 0] * (2.0 / (wl - 1)) - 1.0, xy[..., 1] * (2.0 / (hl - 1)) - 1.0), dim=-1)
        sampled = torch.nn.functional.grid_sample(vol.view(q, 1, hl, wl), grid, mode="bilinear",
                                                  padding_mode="zeros", align_corners=True)
        taps.append(sampled.view(q, s * s))  # channel i*S + j
    return torch.cat(taps, dim=1)


def k1_library_chain(pyramid, cents, weight, bias, radius, scales=None, dtype=torch.float32):
    """K1's function as a chain of PyTorch calls: :func:`k2_library_chain`,
    then the 1x1 projection as ``torch.addmm`` + relu at ``dtype``, laid out
    NCHW. A yardstick only: the port never calls it."""
    b, h, w, _ = cents.shape
    taps = k2_library_chain(pyramid, cents, radius, scales).to(dtype)
    proj = torch.relu(torch.addmm(bias.to(dtype), taps, weight.t().to(dtype)))
    return proj.view(b, h, w, -1).permute(0, 3, 1, 2).contiguous()


def lookup_phase(device):
    """K1, K2 and K4 against their plain versions, and their times."""
    from raft_tpu_torch.kernels import lookup_pallas as lp
    from raft_tpu_torch.kernels import lookup_xtap as lx

    err = {"k1": 0.0, "k2": 0.0, "k4": 0.0}
    for name, kw in LOOKUP_CASES.items():
        r = kw.get("radius", RADIUS)
        pyr, cents, weight, bias = kernel_inputs(device, **kw)
        got1 = lx.lookup_project_fused(pyr, cents, weight, bias, r)
        got2 = lx.lookup_pyramid_fused(pyr, cents, r)
        got4 = lp.lookup_pyramid_pallas(pyr, cents, r)
        torch.cuda.synchronize()
        taps = lx.lookup_pyramid_reference(pyr, cents, r)
        e1 = (got1 - lx.lookup_project_reference(pyr, cents, weight, bias, r)).abs().max().item()
        e2 = (got2 - taps).abs().max().item()
        e4 = (got4 - lp.lookup_pyramid_reference(pyr, cents, r)).abs().max().item()
        levels = [tuple(v.shape[1:]) for v in pyr]
        log(f"kernels {name}: Q={cents.shape[0] * cents.shape[1] * cents.shape[2]} levels={levels} "
            f"r={r} C_out={weight.shape[0]} K1 max_abs_err={e1:.3e} (tol {PROJECT_TOL:g}) "
            f"K2 max_abs_err={e2:.3e} K4 max_abs_err={e4:.3e} (tol {LOOKUP_TOL:g})")
        if not (got1.shape == (cents.shape[0], weight.shape[0]) + cents.shape[1:3]
                and e1 <= PROJECT_TOL and e2 <= LOOKUP_TOL and e4 <= LOOKUP_TOL):
            raise AssertionError(f"a lookup kernel disagrees with its plain version on {name}")
        err = {"k1": max(err["k1"], e1), "k2": max(err["k2"], e2), "k4": max(err["k4"], e4)}

    # NaN centroids (F4): K1's fp32 form gives NaN exactly where its plain version does
    pyr, cents, weight, bias = kernel_inputs(device, *SINTEL)
    cents[0, 0, :8] = float("nan")
    cents[0, -1, -1, 1] = float("nan")
    got1 = lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS)
    torch.cuda.synchronize()
    want1 = lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS)
    same = torch.equal(got1.isnan(), want1.isnan())
    e1 = (got1.nan_to_num(0.0) - want1.nan_to_num(0.0)).abs().max().item()
    log(f"kernels nan_centroids: K1 fp32 {int(got1.isnan().sum())} NaN outputs, plain {int(want1.isnan().sum())}, "
        f"same cells {same}; max_abs_err elsewhere {e1:.3e} (tol {PROJECT_TOL:g})")
    if not (same and e1 <= PROJECT_TOL):
        raise AssertionError("K1 disagrees with its plain version on NaN centroids")
    err["k1"] = max(err["k1"], e1)
    # the same centroids through K2's fp32 form and K4: NaN taps exactly where the plain version has them
    want2 = lx.lookup_pyramid_reference(pyr, cents, RADIUS)
    for key, got in (("k2", lx.lookup_pyramid_fused(pyr, cents, RADIUS)), ("k4", lp.lookup_pyramid_pallas(pyr, cents,
                                                                                                          RADIUS))):
        torch.cuda.synchronize()
        same = torch.equal(got.isnan(), want2.isnan())
        e = (got.nan_to_num(0.0) - want2.nan_to_num(0.0)).abs().max().item()
        log(f"kernels nan_centroids: {key.upper()} fp32 {int(got.isnan().sum())} NaN taps, plain "
            f"{int(want2.isnan().sum())}, same cells {same}; max_abs_err elsewhere {e:.3e} (tol {LOOKUP_TOL:g})")
        if not (same and e <= LOOKUP_TOL):
            raise AssertionError(f"{key.upper()} disagrees with its plain version on NaN centroids")
        err[key] = max(err[key], e)

    pyr, cents, weight, bias = kernel_inputs(device, *SINTEL)
    q = cents.shape[0] * cents.shape[1] * cents.shape[2]
    c_in = weight.shape[1]
    plain1 = lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS)
    e_lib = (k1_library_chain(pyr, cents, weight, bias, RADIUS) - plain1).abs().max().item()
    log(f"kernels K1 library chain (grid_sample + addmm + relu) vs plain: max_abs_err={e_lib:.3e} "
        f"(tol {PROJECT_TOL:g})")
    if not e_lib <= PROJECT_TOL:
        raise AssertionError("K1's library chain does not compute K1's function")
    taps = lx.lookup_pyramid_reference(pyr, cents, RADIUS)
    e_lib2 = (k2_library_chain(pyr, cents, RADIUS) - taps.reshape(q, -1)).abs().max().item()
    log(f"kernels K2/K4 library chain (grid_sample per level) vs plain: max_abs_err={e_lib2:.3e} "
        f"(tol {PROJECT_TOL:g})")
    if not e_lib2 <= PROJECT_TOL:
        raise AssertionError("K2's library chain does not compute K2's function")
    times = {
        "k1": cuda_ms(lambda: lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS)),
        "k1_plain": cuda_ms(lambda: lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS)),
        "k1_library": cuda_ms(lambda: k1_library_chain(pyr, cents, weight, bias, RADIUS)),
        "k2_library": cuda_ms(lambda: k2_library_chain(pyr, cents, RADIUS)),
        "k2": cuda_ms(lambda: lx.lookup_pyramid_fused(pyr, cents, RADIUS)),
        "k2_plain": cuda_ms(lambda: lx.lookup_pyramid_reference(pyr, cents, RADIUS)),
        "k4": cuda_ms(lambda: lp.lookup_pyramid_pallas(pyr, cents, RADIUS)),
        "k4_plain": cuda_ms(lambda: lp.lookup_pyramid_reference(pyr, cents, RADIUS)),
    }
    # 11 operations per tap for the 4-corner interpolation
    interp_ops = 11.0 * q * c_in
    windows = window_bytes(pyr, cents, RADIUS)
    in_bytes = windows + cents.numel() * 4
    k1_bytes = in_bytes + (weight.numel() + bias.numel() + q * C_OUT) * 4
    gemm = 2.0 * q * c_in * C_OUT
    # K1 runs its product as 3xTF32 on the tensor cores; on the fp32 FMA
    # units it would be bound by the second
    b1 = bound(k1_bytes, 2.0 * q * C_OUT + interp_ops, tf32_ops=3.0 * gemm)
    b1_fma = bound(k1_bytes, gemm + 2.0 * q * C_OUT + interp_ops)
    b2 = bound(in_bytes + q * c_in * 4, interp_ops)
    log(f"kernels sintel timing: window bytes {windows}, "
        f"K1 {times['k1']:.4f} ms (plain {times['k1_plain']:.4f}, library chain {times['k1_library']:.4f}, "
        f"{times['k1_library'] / times['k1']:.2f}x K1; bound {b1[0]:.4f} by {b1[1]} as 3xTF32, K1 at "
        f"{b1[0] / times['k1']:.3f} of it; {b1_fma[0]:.4f} by {b1_fma[1]} on fp32 FMA units), "
        f"K2 {times['k2']:.4f} ms (plain {times['k2_plain']:.4f}, bound {b2[0]:.4f} by {b2[1]}), "
        f"K4 {times['k4']:.4f} ms (plain {times['k4_plain']:.4f}, bound {b2[0]:.4f} by {b2[1]}); "
        f"K2/K4 library chain (grid_sample x{LEVELS}) {times['k2_library']:.4f} ms")

    reset_counts()  # K4's own entry point, once at the Sintel shapes
    lp.lookup_pyramid_pallas(pyr, cents, RADIUS)
    torch.cuda.synchronize()
    k4_launches = read_counts()["k4"]
    if k4_launches != 1:
        raise AssertionError(f"lookup_pyramid_pallas launched K4 {k4_launches} times, expected 1")
    return err, times, {"k1": b1, "k1_fma": b1_fma, "k2": b2, "k4": b2}, k4_launches


VOLUME_CASES = {
    # (batch, channels, h, w, levels)
    "raft_small_sintel": (1, 128, 55, 128, 4),
    "raft_large_sintel": (1, 256, 55, 128, 4),
    "fixture": (1, 48, 12, 17, 3),
    "kitti_ragged_q": (1, 128, 47, 156, 4),
    "batch2": (2, 128, 55, 128, 4),
    "odd_dims": (1, 128, 45, 99, 4),
    "channel_tail": (1, 36, 23, 37, 3),  # C not a multiple of 8
    "one_level": (1, 32, 9, 13, 1),
    "five_levels": (1, 32, 40, 48, 5),
    "six_levels": (1, 32, 64, 96, 6),
    "nan_features": (2, 128, 23, 37, 4),  # NaN bit patterns in both maps (volume_inputs)
}
# (map, batch, channel, y, x, bits) of each NaN of the nan_features case (F5): the
# card's own NaN (0x7fffffff), a host NaN (0x7fc00000), a negative one (0xffffffff)
NAN_FEATURES = [(0, 0, 5, 2, 3, 0x7FFFFFFF), (1, 0, 17, 10, 20, 0x7FC00000), (1, 1, 64, 22, 36, -1),
                (0, 1, 127, 22, 36, 0x7FC00000), (1, 1, 3, 0, 0, 0x7FFFFFFF)]


def volume_inputs(device, name):
    """Seeded features of a volume case, NaNs put in for nan_features."""
    b, c, h, w, levels = VOLUME_CASES[name]
    gen = torch.Generator(device=device).manual_seed(3)
    f1 = torch.randn(b, c, h, w, device=device, generator=gen)
    f2 = torch.randn(b, c, h, w, device=device, generator=gen)
    if name == "nan_features":
        for m, bb, ch, y, x, bits in NAN_FEATURES:
            (f1, f2)[m].view(torch.int32)[bb, ch, y, x] = bits
    return f1, f2, levels


def same_nans(got, want) -> bool:
    return all(torch.equal(g.isnan(), w_.isnan()) for g, w_ in zip(got, want))


def volume_phase(device):
    """K3 against its plain version on every case, timed at raft_small
    (the main path's shapes) and raft_large. The plain version is the
    library chain K3 replaces (one cuBLAS matmul, L-1 avg_pool2d), so its
    time is also the library time. Two bounds: the product on the fp32
    FMA units, and as 3xTF32 on the tensor cores (three TF32 products per
    fp32 product, what K3 runs) against the bytes; K3's time is held to the
    second."""
    from raft_tpu_torch.kernels import corr_pallas as cp

    err, times = 0.0, {}
    for name in VOLUME_CASES:
        f1, f2, levels = volume_inputs(device, name)
        b, c, h, w = f1.shape
        got = cp.fused_volume_pyramid(f1, f2, levels)
        torch.cuda.synchronize()
        want = cp.volume_pyramid_reference(f1, f2, levels)
        nans = same_nans(got, want)  # NaN exactly where the plain version has NaN
        e = max((g.nan_to_num(0.0) - w_.nan_to_num(0.0)).abs().max().item() for g, w_ in zip(got, want))
        shapes_ok = all(g.shape == w_.shape for g, w_ in zip(got, want))
        log(f"kernels K3 {name}: levels {[tuple(g.shape[1:]) for g in got]} max_abs_err={e:.3e} "
            f"(tol {VOLUME_TOL:g}); NaN cells {sum(int(g.isnan().sum()) for g in got)}, as the plain version: {nans}")
        if not (shapes_ok and nans and e <= VOLUME_TOL):
            raise AssertionError(f"K3 disagrees with its plain version on {name}")
        err = max(err, e)
        if name in ("raft_small_sintel", "raft_large_sintel"):
            q = h * w
            nbytes = 2 * b * c * q * 4 + sum(b * q * g.shape[1] * g.shape[2] * 4 for g in got)
            gemm = 2.0 * b * q * q * c
            pool_ops = sum(4.0 * b * q * g.shape[1] * g.shape[2] for g in got[1:])
            t = {
                "ms": cuda_ms(lambda: cp.fused_volume_pyramid(f1, f2, levels)),
                "plain_ms": cuda_ms(lambda: cp.volume_pyramid_reference(f1, f2, levels)),
                "fp32_bound": bound(nbytes, gemm + pool_ops),
                "bound": bound(nbytes, pool_ops, tf32_ops=3.0 * gemm),
            }
            times[name] = t
            log(f"kernels K3 {name} timing: {t['ms']:.4f} ms (plain = matmul+avg_pool2d chain "
                f"{t['plain_ms']:.4f}, {t['plain_ms'] / t['ms']:.2f}x K3); bound {t['bound'][0]:.4f} by "
                f"{t['bound'][1]} as 3xTF32 (K3 at {t['bound'][0] / t['ms']:.3f} of it), "
                f"{t['fp32_bound'][0]:.4f} by {t['fp32_bound'][1]} on fp32 FMA units; "
                f"{nbytes} bytes, {gemm:.4g} GEMM + {pool_ops:.4g} pool operations")
    return err, times


# -- the reduced-precision forms of K1, K2 (bf16 / int8 levels) and K3 (bf16) --

INT8_PROJECT_RTOL = 1e-4  # K1, fp32 out from int8 levels: exact integer rows, fp32 sums in another order
# (storage, product) of each K1 form; K2 has one form per storage
K1_FORMS = {"k1_bf16": ("bf16", None), "k1_bf16_bf16": ("bf16", torch.bfloat16),
            "k1_int8": ("int8", None), "k1_int8_bf16": ("int8", torch.bfloat16)}
K2_FORMS = {"k2_bf16": "bf16", "k2_int8": "int8"}


def bf16_ulps(want, n: int = 2) -> float:
    """``n`` bf16 ulps of the largest magnitude of ``want``: a bf16 output
    may round the other way when its fp32 value is summed in another order."""
    top = want.float().abs().max().item()
    return n * 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


def lowp_pyramid(pyr, storage: str):
    from raft_tpu_torch.kernels.lookup_xtap import quantize_pyramid

    return quantize_pyramid(pyr) if storage == "int8" else [lvl.to(torch.bfloat16) for lvl in pyr]


def k1_bound(pyr, cents, weight, bias, radius, proj):
    """K1's bound for these inputs: the windows its taps touch, centroids,
    scales, weight and bias read once, the output written once, against
    the interpolation and bias + relu at the fp32 rate and the product at
    the bf16 rate (bf16 product) or as K1 runs it, 3xTF32."""
    q = cents.shape[0] * cents.shape[1] * cents.shape[2]
    c_out, c_in = weight.shape[0], weight[0].numel()
    scales = getattr(pyr, "scales", None)
    nbytes = (window_bytes(pyr, cents, radius) + cents.numel() * 4 + (scales.numel() * 4 if scales is not None else 0)
              + (weight.numel() + bias.numel()) * 4 + q * c_out * (2 if proj is not None else 4))
    gemm = 2.0 * q * c_in * c_out
    other = 2.0 * q * c_out + 11.0 * q * c_in
    return bound(nbytes, other, bf16_ops=gemm) if proj is not None else bound(nbytes, other, tf32_ops=3.0 * gemm)


def k1_tolerance(want, storage, proj) -> float:
    if proj is not None:
        return bf16_ulps(want)
    return INT8_PROJECT_RTOL * want.abs().max().item() if storage == "int8" else PROJECT_TOL


def lowp_lookup_phase(device):
    """K1 and K2 on bf16 and int8 levels against their plain versions on
    every lookup case, and their times, bounds and library chains at
    raft_large Sintel."""
    from raft_tpu_torch.kernels import lookup_xtap as lx

    err = {k: 0.0 for k in (*K1_FORMS, *K2_FORMS)}
    for name, kw in LOOKUP_CASES.items():
        r = kw.get("radius", RADIUS)
        pyr32, cents, weight, bias = kernel_inputs(device, **kw)
        parts = []
        for key2, storage in K2_FORMS.items():
            pyr = lowp_pyramid(pyr32, storage)
            got, want = lx.lookup_pyramid_fused(pyr, cents, r), lx.lookup_pyramid_reference(pyr, cents, r)
            torch.cuda.synchronize()
            e, tol = (got.float() - want.float()).abs().max().item(), bf16_ulps(want)
            parts.append(f"{key2} {e:.3e} (tol {tol:.3e})")
            if not (got.dtype == want.dtype == torch.bfloat16 and e <= tol):
                raise AssertionError(f"{key2} disagrees with its plain version on {name}")
            err[key2] = max(err[key2], e)
            for key1, (st, proj) in K1_FORMS.items():
                if st != storage:
                    continue
                got = lx.lookup_project_fused(pyr, cents, weight, bias, r, proj)
                want = lx.lookup_project_reference(pyr, cents, weight, bias, r, proj)
                torch.cuda.synchronize()
                e, tol = (got.float() - want.float()).abs().max().item(), k1_tolerance(want, st, proj)
                parts.append(f"{key1} {e:.3e} (tol {tol:.3e})")
                if not (got.dtype == want.dtype and e <= tol):
                    raise AssertionError(f"{key1} disagrees with its plain version on {name}")
                err[key1] = max(err[key1], e)
        log(f"kernels low-precision {name}: r={r} C_out={weight.shape[0]} max_abs_err " + ", ".join(parts))

    pyr32, cents, weight, bias = kernel_inputs(device, *SINTEL)
    q = cents.shape[0] * cents.shape[1] * cents.shape[2]
    c_in = weight.shape[1]
    interp_ops = 11.0 * q * c_in
    weight_bf16 = lx.project_weight_bf16(weight)  # as FusedLookupCorrBlock keeps it
    times, bounds = {}, {}
    for storage in ("bf16", "int8"):
        pyr = lowp_pyramid(pyr32, storage)
        scales = getattr(pyr, "scales", None)
        windows = window_bytes(pyr, cents, RADIUS)
        in_bytes = windows + cents.numel() * 4 + (scales.numel() * 4 if scales is not None else 0)
        key2 = f"k2_{storage}"
        times[key2] = {
            "ms": cuda_ms(lambda: lx.lookup_pyramid_fused(pyr, cents, RADIUS)),
            "plain_ms": cuda_ms(lambda: lx.lookup_pyramid_reference(pyr, cents, RADIUS)),
            "library_ms": cuda_ms(lambda: k2_library_chain(pyr, cents, RADIUS, scales)),
        }
        bounds[key2] = bound(in_bytes + q * c_in * 2, interp_ops)
        for key1, (st, proj) in K1_FORMS.items():
            if st != storage:
                continue
            bounds[key1] = k1_bound(pyr, cents, weight, bias, RADIUS, proj)
            dt = proj or torch.float32
            wb = weight_bf16 if proj is not None else None
            times[key1] = {
                "ms": cuda_ms(lambda: lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS, proj, wb)),
                "plain_ms": cuda_ms(lambda: lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS, proj)),
                "library_ms": cuda_ms(lambda: k1_library_chain(pyr, cents, weight, bias, RADIUS, scales, dt)),
            }
        log(f"kernels low-precision sintel timing, {storage} levels (window bytes {windows}): " + "; ".join(
            f"{k} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, library chain {t['library_ms']:.4f}, "
            f"bound {bounds[k][0]:.4f} by {bounds[k][1]})" for k, t in times.items() if storage in k))

    # K2's reduced-precision forms at raft_small (r 3, C_in 196) and at batch 8 (Q = 56320)
    k2_shapes = {key: {} for key in K2_FORMS}
    for label, case in (("raft_small", "raft_small_fused"), ("batch8", "serving_batch8")):
        kw = LOOKUP_CASES[case]
        r = kw.get("radius", RADIUS)
        pyr32, cents, _, _ = kernel_inputs(device, **kw)
        q = cents.shape[0] * cents.shape[1] * cents.shape[2]
        c_in = LEVELS * (2 * r + 1) ** 2
        reps = 5 if label == "batch8" else 20
        for key2, storage in K2_FORMS.items():
            pyr = lowp_pyramid(pyr32, storage)
            scales = getattr(pyr, "scales", None)
            nbytes = (window_bytes(pyr, cents, r) + cents.numel() * 4 + (scales.numel() * 4 if scales is not None else 0)
                      + q * c_in * 2)
            b2 = bound(nbytes, 11.0 * q * c_in)
            k2_shapes[key2].update({
                f"{label}_ms": cuda_ms(lambda: lx.lookup_pyramid_fused(pyr, cents, r)),
                f"{label}_plain_ms": cuda_ms(lambda: lx.lookup_pyramid_reference(pyr, cents, r), reps=reps),
                f"{label}_library_ms": cuda_ms(lambda: k2_library_chain(pyr, cents, r, scales), reps=reps),
                f"{label}_bound_ms": b2[0], f"{label}_bound_by": b2[1],
            })
        log(f"kernels K2 at {label} (Q={q}, r={r}): " + "; ".join(
            f"{key2} " + ", ".join(f"{k[len(label) + 1:]} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                   for k, v in k2_shapes[key2].items() if k.startswith(label))
            for key2 in K2_FORMS))

    # the launch of the serving pool's tick and the bench's _b8 lines: batch 8, Q = 56320
    pyr32, cents, weight, bias = kernel_inputs(device, **LOOKUP_CASES["serving_batch8"])
    weight_bf16 = lx.project_weight_bf16(weight)
    batch8 = {}
    for key, storage, proj in (("k1", "fp32", None), ("k1_bf16_bf16", "bf16", torch.bfloat16)):
        pyr = pyr32 if storage == "fp32" else lowp_pyramid(pyr32, storage)
        wb = weight_bf16 if proj is not None else None
        b8 = k1_bound(pyr, cents, weight, bias, RADIUS, proj)
        batch8[key] = {
            "batch8_ms": cuda_ms(lambda: lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS, proj, wb)),
            "batch8_plain_ms": cuda_ms(lambda: lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS, proj),
                                       reps=5),
            "batch8_library_ms": cuda_ms(
                lambda: k1_library_chain(pyr, cents, weight, bias, RADIUS, None, proj or torch.float32), reps=5),
            "batch8_bound_ms": b8[0], "batch8_bound_by": b8[1],
        }
        log(f"kernels K1 {key} at batch 8 (Q={cents.shape[0] * cents.shape[1] * cents.shape[2]}): "
            + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in batch8[key].items()))
    return err, times, bounds, batch8, k2_shapes


def volume_bf16_phase(device):
    """K3 storing bf16 levels against its plain version on every volume
    case (the fp32 tolerance plus one bf16 ulp of each cell), timed at
    raft_small and raft_large Sintel; the plain version is the library
    chain (matmul, avg_pool2d, a cast)."""
    from raft_tpu_torch.kernels import corr_pallas as cp

    worst, times = 0.0, {}
    for name in VOLUME_CASES:
        f1, f2, levels = volume_inputs(device, name)
        b, c, h, w = f1.shape
        got = cp.fused_volume_pyramid(f1, f2, levels, torch.bfloat16)
        torch.cuda.synchronize()
        want = cp.volume_pyramid_reference(f1, f2, levels, torch.bfloat16)
        nans = same_nans(got, want)  # NaN exactly where the plain version has NaN
        pairs = [(g.float().nan_to_num(0.0), w_.float().nan_to_num(0.0)) for g, w_ in zip(got, want)]
        # the fp32 cells agree within VOLUME_TOL; rounding each to bf16 adds at
        # most one bf16 ulp of the larger of the two (2^-7 relative)
        ulps = max(((g - w_).abs() - VOLUME_TOL).clamp(min=0).div(
            (torch.maximum(g.abs(), w_.abs()) * 2.0**-7).clamp(min=1e-30)).max().item() for g, w_ in pairs)
        e = max((g - w_).abs().max().item() for g, w_ in pairs)
        log(f"kernels K3 bf16 {name}: max_abs_err={e:.3e}, worst cell {ulps:.3f} bf16 ulp beyond the fp32 "
            f"tolerance {VOLUME_TOL:g} (tol 1); NaN cells as the plain version: {nans}")
        if not (all(g.dtype == torch.bfloat16 and g.shape == w_.shape for g, w_ in zip(got, want))
                and nans and ulps <= 1.0):
            raise AssertionError(f"K3 bf16 disagrees with its plain version on {name}")
        worst = max(worst, e)
        if name in ("raft_small_sintel", "raft_large_sintel"):
            q = h * w
            nbytes = 2 * b * c * q * 4 + sum(b * q * g.shape[1] * g.shape[2] * 2 for g in got)
            gemm = 2.0 * b * q * q * c
            pool_ops = sum(4.0 * b * q * g.shape[1] * g.shape[2] for g in got[1:])
            t = {
                "ms": cuda_ms(lambda: cp.fused_volume_pyramid(f1, f2, levels, torch.bfloat16)),
                "plain_ms": cuda_ms(lambda: cp.volume_pyramid_reference(f1, f2, levels, torch.bfloat16)),
                "bound": bound(nbytes, pool_ops, tf32_ops=3.0 * gemm),
            }
            times[name] = t
            log(f"kernels K3 bf16 {name} timing: {t['ms']:.4f} ms (plain = library chain {t['plain_ms']:.4f}); "
                f"bound {t['bound'][0]:.4f} by {t['bound'][1]} ({nbytes} bytes)")
    small, large = times["raft_small_sintel"], times["raft_large_sintel"]
    log(f"kernels K3 bf16 timing, raft_small / raft_large Sintel: {small['ms']:.4f} / {large['ms']:.4f} ms, "
        f"bound {small['bound'][0]:.4f} / {large['bound'][0]:.4f} ms, share of bound "
        f"{small['bound'][0] / small['ms']:.3f} / {large['bound'][0] / large['ms']:.3f}")
    return worst, times


INORM_SHAPES = [(1, 32, 220, 512), (1, 64, 220, 512), (2, 16, 24, 32)]


def inorm_phase(device):
    """K5 against its plain version in fp32 and bf16, with and without
    ReLU, and its time at the encoder stem's size."""
    from raft_tpu_torch.kernels import inorm_pallas as ip

    err32, err16 = 0.0, 0.0
    for shape in INORM_SHAPES:
        gen = torch.Generator(device=device).manual_seed(5)
        x = torch.randn(shape, device=device, generator=gen) * 3.0 + 1.5
        xb = x.to(torch.bfloat16)
        for relu in (False, True):
            got = ip.instance_norm_pallas(x, relu=relu)
            gotb = ip.instance_norm_pallas(xb, relu=relu)
            torch.cuda.synchronize()
            e32 = (got - ip.instance_norm_reference(x, relu=relu)).abs().max().item()
            wantb = ip.instance_norm_reference(xb, relu=relu).float()
            # one bf16 rounding step of the result, relative to its size
            e16 = ((gotb.float() - wantb).abs() / (wantb.abs() + 1e-3)).max().item()
            log(f"kernels K5 {shape} relu={relu}: fp32 max_abs_err={e32:.3e} (tol {INORM_TOL:g}), "
                f"bf16 max rel err={e16:.3e} (tol {BF16_RTOL:g}), dtype {gotb.dtype}")
            if not (e32 <= INORM_TOL and e16 <= BF16_RTOL and gotb.dtype == torch.bfloat16):
                raise AssertionError(f"K5 disagrees with its plain version at {shape} relu={relu}")
            err32, err16 = max(err32, e32), max(err16, e16)

    x = torch.randn(INORM_SHAPES[0], device=device) * 3.0 + 1.5
    nbytes = 2 * x.numel() * 4
    t = {
        "ms": cuda_ms(lambda: ip.instance_norm_pallas(x)),
        "plain_ms": cuda_ms(lambda: ip.instance_norm_reference(x)),
        "library_ms": cuda_ms(lambda: torch.nn.functional.instance_norm(x, eps=1e-5)),
        "relu_ms": cuda_ms(lambda: ip.instance_norm_pallas(x, relu=True)),
        "relu_library_ms": cuda_ms(lambda: torch.relu(torch.nn.functional.instance_norm(x, eps=1e-5))),
        "bound": bound(nbytes, 6.0 * x.numel()),
    }
    log(f"kernels K5 {INORM_SHAPES[0]} fp32 timing: {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, "
        f"F.instance_norm {t['library_ms']:.4f}, bound {t['bound'][0]:.4f} by {t['bound'][1]}); "
        f"with ReLU {t['relu_ms']:.4f} ms (F.instance_norm + relu {t['relu_library_ms']:.4f})")

    reset_counts()  # K5's own entry point, once at the stem's size
    ip.instance_norm_pallas(x)
    torch.cuda.synchronize()
    launches = read_counts()["k5"]
    if launches != 1:
        raise AssertionError(f"instance_norm_pallas counted {launches} launches, expected 1")
    return {"fp32": err32, "bf16_rel": err16}, t, launches


def request_pair(seed: int):
    """A raw uint8 IMAGE-sized pair, smooth random texture and its shifted
    copy, and the shift's flow (u, v) from the first image to the second."""
    rng = np.random.default_rng(seed)
    h, w = IMAGE
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, h // 8 + 2, w // 8 + 2)).astype(np.float32))
    tex = torch.nn.functional.interpolate(coarse, size=(h + 16, w + 16), mode="bicubic", align_corners=False)
    tex = tex[0].permute(1, 2, 0).clamp(0, 255).numpy().astype(np.uint8)
    dy, dx = rng.integers(-4, 5, size=2)
    im1 = tex[8 : 8 + h, 8 : 8 + w]
    im2 = tex[8 + dy : 8 + dy + h, 8 + dx : 8 + dx + w]
    return im1, im2, (-float(dx), -float(dy))


def eager_flow(est, im1, im2, iters=UPDATES):
    """``est``'s request with its model called eagerly, launch by launch:
    the same normalization, padding and input layout as the graph ``est``
    replays."""
    from raft_tpu_torch.eval.padder import InputPadder

    p1, p2 = est._normalize(im1), est._normalize(im2)
    padder = InputPadder(p1.shape, mode=est.pad_mode)
    p1, p2 = padder.pad(p1, p2)
    with torch.inference_mode():
        flow = est.model(est._to_device(p1), est._to_device(p2), num_flow_updates=iters, emit_all=False)
    return padder.unpad(est._to_host(flow))[0]


def timed_requests(run, pairs):
    """Each pair through ``run``, synchronized: (flows, latencies in ms)."""
    flows, latencies = [], []
    for pair in pairs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows.append(run(*pair))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    return flows, latencies


def main_path(device, card):
    import raft_tpu_torch as rt

    model = rt.raft_large(corr_impl="fused", device=device, seed=0)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(FLOW_HEAD_SCALE)
    est = rt.FlowEstimator(model, num_flow_updates=UPDATES, device=device)
    eager = lambda a, b: eager_flow(est, a, b)  # noqa: E731
    pairs = [request_pair(seed)[:2] for seed in range(REQUESTS)]
    eager(*pairs[0])  # warm-up: cuDNN algorithm choice, allocator growth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    reset_counts()
    flows, latencies = timed_requests(eager, pairs)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)

    log(f"main path eager: launches {launches} over {REQUESTS} requests x {UPDATES} updates")
    if launches["k1"] != REQUESTS * UPDATES:
        raise AssertionError(f"K1 launched {launches['k1']} times, expected {REQUESTS * UPDATES}")
    for f in flows:
        if f.shape != IMAGE + (2,) or not np.isfinite(f).all():
            raise AssertionError(f"bad flow: shape {f.shape}, finite {np.isfinite(f).all()}")
    log(f"main path eager: per-request latency ms {[round(t, 3) for t in latencies]} "
        f"(mean {np.mean(latencies):.3f}), peak device memory {peak} B "
        f"({peak / 2**30:.3f} GiB), card {card}")

    log_shares("main path eager", profile_request(eager, pairs[0]))
    graphed = graphed_path("main path", card, est, pairs, flows)

    dense = rt.raft_large(corr_impl="dense", device=device)
    dense.load_state_dict(model.state_dict())
    dense_est = rt.FlowEstimator(dense, num_flow_updates=UPDATES, device=device)
    compare_flows("main path: fused", flows, lambda a, b: eager_flow(dense_est, a, b), pairs)
    return model, pairs, flows, graphed


def throughput_path(device, card, pairs, quality_flows):
    """raft_large at the 'throughput' preset (bf16 convs, bf16 pyramid, K1
    with a bf16 product) through ``FlowEstimator.from_preset`` on seeded
    weights, the flow head scaled as on the fp32 main path: 3 requests
    eagerly after a warm-up, K1 once per update on bf16 levels, latency,
    peak memory, one request under torch.profiler (device time and its
    conv share), and the flow's distance from the fp32 path's (reported,
    not gated: random weights); then the same requests graphed."""
    import raft_tpu_torch as rt

    est = rt.FlowEstimator.from_preset("throughput", pretrained=False, device=device, num_flow_updates=UPDATES)
    eager = lambda a, b: eager_flow(est, a, b)  # noqa: E731
    model = est.model
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(FLOW_HEAD_SCALE)
    eager(*pairs[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    flows, latencies = timed_requests(eager, pairs)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    with torch.inference_mode():
        x = torch.zeros((1, 3) + tuple(-(-d // 8) * 8 for d in IMAGE), device=device)
        level_dtype = model.begin_pair(x, x)["pyramid"][0].dtype
    log(f"throughput path eager: launches {launches} over {len(pairs)} requests x {UPDATES} updates; pyramid "
        f"levels {level_dtype}; corr block {type(model.corr_block).__name__} dtype {model.corr_block.dtype}")
    if launches["k1"] != len(pairs) * UPDATES or level_dtype != torch.bfloat16:
        raise AssertionError(f"throughput path: K1 launched {launches['k1']} times on {level_dtype} levels")
    for f in flows:
        if f.shape != IMAGE + (2,) or not np.isfinite(f).all():
            raise AssertionError(f"bad flow: shape {f.shape}, finite {np.isfinite(f).all()}")
    d = [np.abs(a - b) for a, b in zip(flows, quality_flows)]
    log(f"throughput path eager: per-request latency ms {[round(t, 3) for t in latencies]} (mean "
        f"{np.mean(latencies):.3f}), peak device memory {peak} B ({peak / 2**30:.3f} GiB), card {card}; "
        f"|dflow| vs the fp32 main path mean {np.mean([x.mean() for x in d]):.3e} px, max "
        f"{max(x.max() for x in d):.3e} px (same seed, bf16: not gated)")
    log_shares("throughput path eager", profile_request(eager, pairs[0]))
    graphed = graphed_path("throughput path", card, est, pairs, flows)
    return model, graphed["k1"]


def log_shares(what, prof):
    """The convolutions' and K1's share of one profiled request's device
    busy time (cuDNN's kernels carry 'conv' or 'fprop' in their names)."""
    if prof is None:
        return
    by_name, busy_us = prof
    conv_us = sum(us for name, us in by_name.items() if "conv" in name.lower() or "fprop" in name.lower())
    k1_us = sum(us for name, us in by_name.items() if "xtap_project_kernel" in name)
    log(f"{what} profile: convolutions {conv_us / 1e3:.3f} ms = {conv_us / busy_us:.4f} of device busy time "
        f"({busy_us / 1e3:.3f} ms), K1 {k1_us / 1e3:.3f} ms = {k1_us / busy_us:.4f}")


def compare_flows(what, flows, run_dense, pairs):
    diffs = [np.abs(f - run_dense(*pair[:2])) for f, pair in zip(flows, pairs)]
    mean_d = float(np.mean([d.mean() for d in diffs]))
    max_d = float(max(d.max() for d in diffs))
    log(f"{what} vs dense |dflow| mean {mean_d:.3e} px (tol {FLOW_MEAN_TOL:g}), "
        f"max {max_d:.3e} px (tol {FLOW_MAX_TOL:g}); flow |max| {max(np.abs(f).max() for f in flows):.3f} px")
    if not (mean_d <= FLOW_MEAN_TOL and max_d <= FLOW_MAX_TOL):
        raise AssertionError(f"{what} and dense flows disagree")


def device_busy(prof):
    """({kernel name: (launches, device us)}, device busy us, device ops)
    of a torch.profiler run: busy time is the union of the device
    activities' intervals. None when the profiler recorded no device
    activity."""
    from torch.autograd import DeviceType

    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not spans:
        return None
    busy_us, end = 0.0, -math.inf
    for s, e in sorted(spans):  # union of kernel intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return by_name, busy_us, len(spans)


def profile_request(run, pair, top: int = 12):
    """Where one request's time goes (``run(*pair)``): device time by
    kernel from torch.profiler, against the request's wall time. Returns
    ({kernel name: device us}, device busy us), or None when the profiler
    recorded no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*pair)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy(prof)
    if busy is None:
        log("profile: the profiler recorded no device activity; device busy share not measured")
        return None
    by_name, busy_us, ops = busy
    log(f"profile: one request, wall {wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f}), {ops} device ops")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"profile:   {us / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")
    return {name: us for name, (_, us) in by_name.items()}, busy_us


def graphed_path(what, card, est, pairs, eager_flows):
    """The same requests through ``est`` itself, by CUDA-graph replay (one
    capture, then a replay a request): the flow equals the eager flow bit
    for bit, K1 is in the graph once per update and the wrappers count no
    eager launch; latency and one profiled request beside the eager
    numbers above. Returns the launches the timed replays made, by
    kernel."""
    from raft_tpu_torch.graphs import capture_events

    ev0 = capture_events()
    t0 = time.perf_counter()
    est(*pairs[0])  # captures
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    before = by_kernel(est.graph_launches())
    reset_counts()
    flows, latencies = timed_requests(est, pairs)
    eager = read_counts()
    replayed = {k: n - before[k] for k, n in by_kernel(est.graph_launches()).items()}
    (prog,) = est.programs().values()
    per_replay = by_kernel(prog.launches)
    same = all(np.array_equal(a, b) for a, b in zip(flows, eager_flows))
    log(f"{what} graphed: first call (warm-up + capture) {capture_s:.3f} s, {capture_events() - ev0} capture; "
        f"per-request latency ms {[round(t, 3) for t in latencies]} (mean {np.mean(latencies):.3f}); launches "
        f"per replay {per_replay}, by the {len(pairs)} replays {replayed}, eager launches in the run {eager}; "
        f"flows equal to the eager flows bit for bit: {same}; card {card}")
    if not same:
        d = max(float(np.abs(a - b).max()) for a, b in zip(flows, eager_flows))
        raise AssertionError(f"{what}: graphed flow differs from eager flow by up to {d:.3e} px")
    if per_replay["k1"] != UPDATES or replayed["k1"] != UPDATES * len(pairs) or any(eager.values()):
        raise AssertionError(f"{what}: K1 not in the graph once per update ({per_replay}, eager {eager})")
    log_shares(f"{what} graphed", profile_request(est, pairs[0]))
    return replayed


def materialize_path(device, model, pair):
    """The block's raw correlation features at the refined coordinates of
    one request, through K2, against the dense block (fp32 levels) or K2's
    plain version (bf16 and int8 levels, whose lookup the dense block does
    not compute). Returns (K2 launches, max abs error)."""
    from raft_tpu_torch import FlowEstimator
    from raft_tpu_torch.eval.padder import InputPadder
    from raft_tpu_torch.kernels import lookup_xtap as lx
    from raft_tpu_torch.models.corr import CorrBlock, LazyCorrFeatures, map_levels

    im1, im2 = (FlowEstimator._normalize(im) for im in pair)
    p1, p2 = (
        torch.from_numpy(p).to(device).permute(0, 3, 1, 2) for p in InputPadder(im1.shape).pad(im1, im2)
    )
    with torch.inference_mode():
        state = model.begin_pair(p1, p2)
        for _ in range(4):
            state = model.iterate_step(state)
        pyramid = map_levels(state["pyramid"], lambda lvl: lvl.reshape((-1,) + tuple(lvl.shape[2:])))
        cents = state["coords1"].permute(0, 2, 3, 1).contiguous()
        reset_counts()
        taps = LazyCorrFeatures(model.corr_block, pyramid, cents).materialize()
        torch.cuda.synchronize()
        launches = read_counts()["k2"]
        storage = pyramid[0].dtype
        if storage == torch.float32:
            want, tol = LazyCorrFeatures(CorrBlock(LEVELS, RADIUS), pyramid, cents).materialize(), LOOKUP_TOL
        else:
            want = lx.lookup_pyramid_reference(pyramid, cents, RADIUS)
            tol = bf16_ulps(want)
    err = (taps.float() - want.float()).abs().max().item()
    log(f"materialize path ({storage} levels): K2 launches {launches}, taps {tuple(taps.shape)} {taps.dtype}, "
        f"max_abs_err vs {'dense block' if storage == torch.float32 else 'plain version'} {err:.3e} (tol {tol:.3e})")
    if launches != 1 or not err <= tol:
        raise AssertionError("materialize path did not go through K2 or disagrees")
    return launches, err


# The golden gate's configurations: (label, model knobs or a preset's name,
# passes, EPE bound, the kernel each pair launches and how often: None for
# once per update). The bounds are the JAX package's
# (tests/test_epe_golden.py): 1e-3 px at fp32, 5e-3 at bf16 correlation
# storage, 3e-2 with bf16 convs (throughput) or int8 storage (edge). The
# quality preset is fp32 at the architecture's own corr_impl, 'dense'.
GOLDEN_CONFIGS = [
    ("pallas", dict(corr_impl="pallas"), ("clean", "final"), EPE_TOL, "k3", 1),
    ("fused", dict(corr_impl="fused"), ("clean", "final"), EPE_TOL, "k1", None),
    ("quality", "quality", ("clean", "final"), EPE_TOL, "k3", 0),
    ("fused + bf16 corr", dict(corr_impl="fused", corr_dtype="bfloat16"), ("clean",), 5e-3, "k1", None),
    ("throughput", "throughput", ("clean",), 3e-2, "k1", None),
    ("edge", "edge", ("clean",), 3e-2, "k1", None),
    ("pallas + bf16 corr", dict(corr_impl="pallas", corr_dtype="bfloat16"), ("clean",), 5e-3, "k3", 1),
]


def golden_phase(device):
    """The trained-weight gate: the fixture's Sintel passes through
    ``validate`` at each configuration, the weights read by
    ``raft_small(checkpoint=<the fixture's .msgpack>)``, held to the
    reference EPE. Returns ({label/pass: EPE}, {label: launches of its
    kernel})."""
    import raft_tpu_torch as rt
    from raft_tpu_torch.data import Sintel
    from raft_tpu_torch.eval import validate

    expected = json.loads((FIXTURE / "expected.json").read_text())
    iters = expected["protocol"]["iters"]
    epes, launched = {}, {}
    for label, knobs, passes, tol, kernel, per_pair in GOLDEN_CONFIGS:
        if isinstance(knobs, str):
            knobs = rt.ServeConfig.preset(knobs).model_overrides()
        model = rt.raft_small(checkpoint=str(FIXTURE / "weights.msgpack"), device=device, **FIXTURE_ARCH, **knobs)
        for dstype in passes:
            ds = Sintel(str(FIXTURE), split="training", dstype=dstype)
            reset_counts()
            m = validate(model, ds, num_flow_updates=iters, mode="sintel", fps_pairs=0)
            torch.cuda.synchronize()
            launches = read_counts()
            ref = expected["reference"][dstype]
            gen = expected["ours_at_generation"][dstype]
            worst = max(abs(m[k] - gen[k]) for k in ("1px", "3px", "5px"))
            log(f"golden EPE {label} {dstype}: epe {m['epe']:.7f} (reference {ref:.7f}, "
                f"|d| {abs(m['epe'] - ref):.3e}, tol {tol:g}); 1px {m['1px']:.6f} 3px {m['3px']:.6f} "
                f"5px {m['5px']:.6f} (max |d| vs generation {worst:.3e}); launches {launches}")
            want = len(ds) * (iters if per_pair is None else per_pair)
            if launches[kernel] != want:
                raise AssertionError(f"golden {label} {dstype}: {kernel} launched {launches[kernel]}, expected {want}")
            # the 1/3/5 px shares are pinned at fp32 only, as the JAX gate pins them
            if not (abs(m["epe"] - ref) < tol and (tol != EPE_TOL or worst < EPE_TOL)):
                raise AssertionError(f"golden EPE {label} {dstype} misses the reference")
            epes[f"{label}/{dstype}"] = m["epe"]
            launched[label] = launched.get(label, 0) + launches[kernel]
    log(f"golden EPE: {json.dumps(epes)}")
    return epes, launched


def shift_pairs(seeds):
    """An in-memory FlowDataset of ``request_pair`` samples: the flow is
    the known shift, valid everywhere."""
    from raft_tpu_torch.data import FlowDataset

    class ShiftPairs(FlowDataset):
        def __init__(self):
            super().__init__()
            self.samples = []
            for seed in seeds:
                im1, im2, (u, v) = request_pair(seed)
                flow = np.empty(im1.shape[:2] + (2,), np.float32)
                flow[..., 0], flow[..., 1] = u, v
                self.samples.append({"image1": im1, "image2": im2, "flow": flow,
                                     "valid": np.ones(im1.shape[:2], bool)})

        def __len__(self):
            return len(self.samples)

        def __getitem__(self, idx):
            return self.samples[idx]

    return ShiftPairs()


def sintel_path(device, card):
    """raft_small at full width, corr_impl='pallas', through validate; then
    the same weights with a bf16 pyramid (K3's bf16 form) over the same
    pairs. Returns K3's launches in the two runs."""
    import raft_tpu_torch as rt
    from raft_tpu_torch.eval import chained_pairs_per_s, validate
    from raft_tpu_torch.eval.validate import _prepare

    model = rt.raft_small(corr_impl="pallas", device=device, seed=1)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(FLOW_HEAD_SCALE)
    params = sum(p.numel() for p in model.parameters())
    if params != 990_162:
        raise AssertionError(f"raft_small has {params} parameters, expected 990162")
    data = shift_pairs(range(10, 10 + REQUESTS))
    validate(model, shift_pairs([9]), num_flow_updates=UPDATES, fps_pairs=0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    metrics = validate(model, data, num_flow_updates=UPDATES, fps_pairs=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    log(f"sintel path: validate raft_small pallas, {len(data)} pairs 436x1024, {UPDATES} updates: "
        f"{json.dumps(metrics)}; launches {launches}; wall {wall * 1e3:.3f} ms; "
        f"peak device memory {peak} B ({peak / 2**30:.3f} GiB), card {card}")
    if launches["k3"] != len(data):
        raise AssertionError(f"K3 launched {launches['k3']} times for {len(data)} pairs")
    if not math.isfinite(metrics["epe"]):
        raise AssertionError("validate returned a non-finite EPE")

    prepared = [_prepare(data[i], "sintel")[0] for i in range(len(data))]
    fps = chained_pairs_per_s(model, [p["image1"] for p in prepared], [p["image2"] for p in prepared],
                              num_flow_updates=UPDATES)
    est = rt.FlowEstimator(model, num_flow_updates=UPDATES, device=device)
    eager = lambda a, b: eager_flow(est, a, b)  # noqa: E731
    flows, latencies = timed_requests(eager, [(s["image1"], s["image2"]) for s in data.samples])
    log(f"sintel path: chained_pairs_per_s {fps:.3f} pairs/s over {len(data)} pairs; FlowEstimator's model "
        f"eagerly, per-request latency ms {[round(t, 3) for t in latencies]} (mean {np.mean(latencies):.3f}), "
        f"card {card}")
    for f in flows:
        if f.shape != IMAGE + (2,) or not np.isfinite(f).all():
            raise AssertionError(f"bad flow: shape {f.shape}")

    dense = rt.raft_small(corr_impl="dense", device=device)
    dense.load_state_dict(model.state_dict())
    dense_est = rt.FlowEstimator(dense, num_flow_updates=UPDATES, device=device)
    compare_flows("sintel path: pallas", flows, lambda a, b: eager_flow(dense_est, a, b),
                  [(s["image1"], s["image2"]) for s in data.samples])

    prof = profile_request(eager, (data.samples[0]["image1"], data.samples[0]["image2"]))
    if prof is not None:
        by_name, busy_us = prof
        # K3 is its split pre-pass and its main kernel
        k3_us = sum(us for name, us in by_name.items() if "corr_pyramid" in name or "split_kmajor" in name)
        conv_us = sum(us for name, us in by_name.items()
                      if any(t in name.lower() for t in ("conv", "fprop", "implicit_gemm")))
        log(f"sintel path profile: K3 {k3_us / 1e3:.3f} ms = {k3_us / busy_us:.4f} of device busy time, "
            f"fp32 convolutions {conv_us / 1e3:.3f} ms = {conv_us / busy_us:.4f}")

    # K3's bf16 form on the model path: the same weights, a bf16 pyramid
    model_bf16 = rt.raft_small(corr_impl="pallas", corr_dtype="bfloat16", device=device)
    model_bf16.load_state_dict(model.state_dict())
    reset_counts()
    t0 = time.perf_counter()
    metrics_bf16 = validate(model_bf16, data, num_flow_updates=UPDATES, fps_pairs=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_bf16 = read_counts()
    log(f"sintel path, bf16 pyramid: validate raft_small pallas + corr_dtype bfloat16, {len(data)} pairs: "
        f"{json.dumps(metrics_bf16)} (fp32 pyramid: epe {metrics['epe']:.6f}); launches {launches_bf16}; "
        f"wall {wall * 1e3:.3f} ms, card {card}")
    if launches_bf16["k3"] != len(data):
        raise AssertionError(f"K3 (bf16) launched {launches_bf16['k3']} times for {len(data)} pairs")
    if not math.isfinite(metrics_bf16["epe"]):
        raise AssertionError("validate at a bf16 pyramid returned a non-finite EPE")
    return launches["k3"], launches_bf16["k3"]


# The serving phase: raft_large at 440x1024, pool capacity 8, 24 requests
# of 436x1024 from 8 threads, targets cycling through the ladder. Flow
# gates against the graphed FlowEstimator at the same preset and target
# (batch 8 in the pool against batch 1), mean / max px: quality as the
# kernel-vs-dense gate; throughput's bf16 convs and pyramid may round the
# other way at another batch's algorithms, its bound stated in PERF.md
# before the first run.
SERVE_BUCKET, SERVE_CAPACITY, SERVE_LADDER = (440, 1024), 8, (32, 20, 12)
SERVE_REQUESTS, SERVE_THREADS = 24, 8
SERVE_TOL = {"quality": (1e-3, 5e-2), "throughput": (0.1, 2.0)}


def serve_requests(engine, pairs, targets, threads):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(lambda i: engine.submit(*pairs[i], num_flow_updates=targets[i]), range(len(pairs))))


def serving_phase(device, card, preset, weights):
    """``ServeEngine`` over raft_large at ``preset`` (fused, K1 in every
    pool tick) with the main path's weights: boot, 24 requests, the flow
    gates, the capture counter, speed, K1 launches, the idle share of a
    profiled burst of 8 requests at 20 updates (the ledger off for both:
    its timed dispatches drain the pipeline), then the ledger's device
    time per program family over one more such burst with every dispatch
    timed, peak memory. Returns the K1 launches of the 24-request run and
    the phase's numbers."""
    import raft_tpu_torch as rt
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.graphs import capture_events
    from raft_tpu_torch.serve import ServeConfig, ServeEngine

    model = rt.raft_for_serving(ServeConfig.preset(preset), corr_impl="fused", device=device)
    model.load_state_dict(weights)
    # a generous deadline: every request runs to its own target here
    cfg = ServeConfig(buckets=(SERVE_BUCKET,), pool_capacity=SERVE_CAPACITY, ladder=SERVE_LADDER, warmup=True,
                      default_deadline_ms=120_000.0, ledger_sample_every=0)
    pairs = [request_pair(100 + i)[:2] for i in range(SERVE_REQUESTS)]
    targets = [SERVE_LADDER[i % len(SERVE_LADDER)] for i in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    engine = ServeEngine(model, cfg, device=device)
    t0 = time.perf_counter()
    engine.start()
    boot_s = time.perf_counter() - t0
    state = engine._pools[SERVE_BUCKET].state
    leaves = [*state["pyramid"], *(state[k] for k in ("coords1", "hidden", "context", "resid_hist", "converged"))]
    state_bytes = sum(t.numel() * t.element_size() for t in leaves)
    counts = engine.program_counts()
    boot = engine.stats()["boot"]
    log(f"serving {preset}: boot to ready {boot_s:.3f} s ({json.dumps(boot)}), graphs per program family "
        f"{counts}; pool state {state_bytes} B ({state_bytes / 2**30:.3f} GiB, {state_bytes // SERVE_CAPACITY} B a "
        f"slot), card {card}")
    ev0, k1_0 = capture_events(), by_kernel(engine.graph_launches())["k1"]
    reset_counts()
    t0 = time.perf_counter()
    results = serve_requests(engine, pairs, targets, SERVE_THREADS)
    wall = time.perf_counter() - t0
    stats = engine.stats()
    captures, eager = capture_events() - ev0, read_counts()
    k1_run = by_kernel(engine.graph_launches())["k1"] - k1_0
    step = engine._pool_progs.graphs()[("pool_step", SERVE_CAPACITY) + tuple(d // 8 for d in SERVE_BUCKET)]
    k1_tick = by_kernel(step.launches)["k1"]
    lat = [r.latency_ms for r in results]
    log(f"serving {preset}: {SERVE_REQUESTS} requests from {SERVE_THREADS} threads in {wall:.3f} s = "
        f"{SERVE_REQUESTS / wall:.3f} requests/s; latency p50 {np.percentile(lat, 50):.3f} ms p99 "
        f"{np.percentile(lat, 99):.3f} ms; ticks {stats['pool_ticks']}, occupancy "
        f"{stats['pool']['occupancy']:.4f}; K1 {k1_tick} a tick, {k1_run} in the run (graph "
        f"replays x launches per graph), eager launches {eager}; captures during the run {captures}, program "
        f"counts {engine.program_counts()}; card {card}")

    burst = [pairs[i] for i in range(SERVE_THREADS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_requests(engine, burst, [20] * len(burst), SERVE_THREADS)
        torch.cuda.synchronize()
        burst_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy(prof)
    if busy is None:
        idle = None
        log(f"serving {preset}: profiled burst recorded no device activity; idle share not measured")
    else:
        by_name, busy_us, ops = busy
        idle = 1 - busy_us / 1e3 / burst_ms
        log(f"serving {preset}: profiled burst of {len(burst)} requests at 20 updates (one admission, 20 ticks, one "
            f"retirement): wall {burst_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms, idle share {idle:.3f}, "
            f"{ops} device ops; card {card}")
        for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
            log(f"serving {preset} profile:   {us / 1e3:9.3f} ms  {n:6d}x  {name[:110]}")
    engine.ledger.sample_every = 1
    serve_requests(engine, burst, [20] * len(burst), SERVE_THREADS)
    log(f"serving {preset}: device time by program family (ledger, every dispatch of a burst of {len(burst)} "
        f"requests at 20 updates timed; card {card}): {json.dumps(engine.device_time_breakdown()['by_family'])}")
    engine.stop()
    peak = torch.cuda.max_memory_allocated(device)

    est = rt.FlowEstimator(model, num_flow_updates=SERVE_LADDER[0], pad_mode="downstream", device=device)
    want = [est(*pairs[i], num_flow_updates=targets[i]) for i in range(SERVE_REQUESTS)]
    d = [np.abs(r.flow - w) for r, w in zip(results, want)]
    mean_d, max_d = float(np.mean([x.mean() for x in d])), float(max(x.max() for x in d))
    tol_mean, tol_max = SERVE_TOL[preset]
    log(f"serving {preset}: |dflow| vs the graphed FlowEstimator (batch 1) mean {mean_d:.3e} px (tol {tol_mean:g}), "
        f"max {max_d:.3e} px (tol {tol_max:g}); peak device memory {peak} B ({peak / 2**30:.3f} GiB), card {card}")
    bad = [(r.rid, r.num_flow_updates, r.exit_reason) for r, n in zip(results, targets)
           if r.num_flow_updates != n or r.exit_reason != "target" or r.flow.shape != IMAGE + (2,)]
    if bad:
        raise AssertionError(f"serving {preset}: requests off their own target: {bad}")
    if captures or eager["k1"] or k1_tick != 1:
        raise AssertionError(f"serving {preset}: {captures} captures after warm-up, K1 {k1_tick} a tick, "
                             f"eager {eager}")
    if not (mean_d <= tol_mean and max_d <= tol_max):
        raise AssertionError(f"serving {preset}: pool flows disagree with FlowEstimator")
    return k1_run, {"requests_per_s": SERVE_REQUESTS / wall, "idle_share": idle, "peak": peak}


def golden_serving_phase(device):
    """The golden fixture through ``ServeEngine`` at 'quality': each
    frame pair padded as the Sintel protocol pads it (split, to the
    96x136 bucket), submitted from its own thread, its flow unpadded; the
    pixel-weighted EPE against the reference."""
    from concurrent.futures import ThreadPoolExecutor

    import raft_tpu_torch as rt
    from raft_tpu_torch.data import Sintel
    from raft_tpu_torch.eval.padder import InputPadder
    from raft_tpu_torch.serve import ServeConfig, ServeEngine

    expected = json.loads((FIXTURE / "expected.json").read_text())
    model = rt.raft_for_serving(ServeConfig.preset("quality"), arch="raft_small",
                                checkpoint=str(FIXTURE / "weights.msgpack"), device=device, **FIXTURE_ARCH)
    ds = Sintel(str(FIXTURE), split="training", dstype="clean")
    samples = [ds[i] for i in range(len(ds))]
    padders = [InputPadder(s["image1"].shape, mode="sintel") for s in samples]
    cfg = ServeConfig(buckets=((96, 136),), pool_capacity=SERVE_CAPACITY, ladder=SERVE_LADDER, warmup=True,
                      default_deadline_ms=120_000.0)
    with ServeEngine(model, cfg, device=device) as engine, ThreadPoolExecutor(len(samples)) as ex:
        results = list(ex.map(lambda i: engine.submit(*padders[i].pad(samples[i]["image1"], samples[i]["image2"])),
                              range(len(samples))))
    epe = np.concatenate([
        np.linalg.norm(p.unpad(r.flow[None])[0] - s["flow"], axis=-1).reshape(-1)
        for p, r, s in zip(padders, results, samples)
    ]).mean()
    ref = expected["reference"]["clean"]
    log(f"golden EPE through ServeEngine (quality, {len(samples)} pairs, 32 updates): epe {epe:.7f} (reference "
        f"{ref:.7f}, |d| {abs(epe - ref):.3e}, tol {EPE_TOL:g})")
    if not abs(epe - ref) < EPE_TOL or any(r.num_flow_updates != 32 for r in results):
        raise AssertionError("golden EPE through ServeEngine misses the reference")


# The training phase: the chairs stage of raft_large at full width (batch 8,
# crop 368x496, 12 updates, dense fp32, no remat), on a synthetic
# FlyingChairs tree written from a seed
TRAIN_PAIRS, TRAIN_FRAME, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_LOG_EVERY = 24, (384, 512), 8, 4, 2


def write_chairs(root: Path, n: int = TRAIN_PAIRS, hw=TRAIN_FRAME, seed: int = 0) -> Path:
    """A FlyingChairs tree: ``data/NNNNN_img{1,2}.ppm`` and ``_flow.flo``,
    and a split file with every pair in the training split. Frame 2 is
    frame 1 shifted by the flow's integer mean, so there is motion to
    learn."""
    from raft_tpu_torch.data.io import write_flo

    rng = np.random.default_rng(seed)
    (root / "data").mkdir(parents=True, exist_ok=True)
    h, w = hw
    for i in range(n):
        shift = rng.integers(-6, 7, 2)
        img1 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img2 = np.roll(img1, (int(shift[1]), int(shift[0])), axis=(0, 1))
        flow = np.broadcast_to(shift.astype(np.float32), (h, w, 2)) + rng.normal(0, 0.1, (h, w, 2))
        for k, img in ((1, img1), (2, img2)):
            (root / "data" / f"{i:05d}_img{k}.ppm").write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
        write_flo(str(root / "data" / f"{i:05d}_flow.flo"), flow.astype(np.float32))
    np.savetxt(root / "FlyingChairs_train_val.txt", np.ones(n), fmt="%d")
    return root


def states_equal(a: dict, b: dict) -> bool:
    """Two ``TrainState.state_dict()``s bit for bit."""
    if a["model"].keys() != b["model"].keys():
        return False
    tensors = lambda sd: ([sd["model"][k] for k in sorted(sd["model"])] + sd["opt_state"]["mu"]  # noqa: E731
                          + sd["opt_state"]["nu"] + [sd["opt_state"]["count"]]
                          + [sd[k] for k in ("step", "skipped_steps", "good_steps", "grad_ema")])
    ta, tb = tensors(a), tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


def train_phase(device, card, overrides=None):
    """``Trainer`` at the chairs stage of raft_large, full width: 8 steps
    on a synthetic FlyingChairs tree, checkpoints every 4, a boundary every
    2 (each loss finite), preempted after step 4 and resumed by a second
    Trainer whose restored state equals the saved one bit for bit and whose
    pipeline continues the index stream at step 4; step times (CUDA events
    around each step), pairs/s, peak memory, checkpoint save and restore
    seconds; 8 steps on one fixed batch must lower the loss, and one of
    them runs under torch.profiler (idle share). No CUDA kernel of the
    port's runs on this path (dense fp32): the launch counts stay 0.
    ``overrides`` (TrainConfig fields) shrink the phase for a CPU rehearsal;
    without them it is the chairs stage itself."""
    import tempfile

    from raft_tpu_torch.checkpoint import CheckpointManager
    from raft_tpu_torch.data import FlyingChairs
    from raft_tpu_torch.data.pipeline import TrainPipeline
    from raft_tpu_torch.models.zoo import CONFIGS, build_raft
    from raft_tpu_torch.train import TrainConfig, Trainer, TrainState, make_optimizer, make_train_step_fn

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="raft_train_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        ds = FlyingChairs(str(write_chairs(tmp / "chairs")))
        log(f"train: synthetic FlyingChairs tree, {len(ds)} pairs at {TRAIN_FRAME[0]}x{TRAIN_FRAME[1]} "
            f"(PPM + .flo) in {time.perf_counter() - t0:.2f} s")
        cfg = TrainConfig(arch="raft_large", stage="chairs", num_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY,
                          log_every=TRAIN_LOG_EVERY, checkpoint_dir=str(tmp / "ckpt"), **(overrides or {}))
        if overrides is None and (cfg.global_batch_size, cfg.crop_size, cfg.num_flow_updates) != (8, (368, 496), 12):
            raise AssertionError("TrainConfig's defaults are not the chairs stage")
        first = Trainer(cfg, ds)
        events = []
        step_fn = first.step_fn

        def timed_step(state, batch):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step_fn(state, batch)
            end.record()
            events.append((start, end))
            return out

        first.step_fn = timed_step
        logs, saved = [], {}

        def on_log(step, m):
            logs.append((step, m))
            if step == TRAIN_CKPT_EVERY:
                saved["state"] = first.state.state_dict()
                first._preempted = True  # as SIGTERM's handler does: checkpoint at the boundary, return

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        first.run(log_fn=on_log)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        if first.manager.all_steps() != [TRAIN_CKPT_EVERY]:
            raise AssertionError(f"checkpoints after the preempted run: {first.manager.all_steps()}")

        t0 = time.perf_counter()
        second = Trainer(cfg, ds)
        resume_s = time.perf_counter() - t0
        restored = second.state.state_dict()
        if int(second.state.step) != TRAIN_CKPT_EVERY or not states_equal(restored, saved["state"]):
            raise AssertionError("the resumed state is not the saved one bit for bit")
        fresh = TrainPipeline(ds, cfg.global_batch_size, seed=cfg.seed, device="cpu")
        stream = fresh._index_stream()
        want = [next(stream) for _ in range(TRAIN_STEPS * cfg.global_batch_size)][TRAIN_CKPT_EVERY * cfg.global_batch_size:]
        stream = second.pipeline._index_stream()
        got = [next(stream) for _ in range(len(want))]
        if second.pipeline.step != TRAIN_CKPT_EVERY or got != want:
            raise AssertionError("the resumed pipeline does not continue the index stream")
        step_fn = second.step_fn
        second.step_fn = timed_step
        t0 = time.perf_counter()
        second.run(log_fn=lambda step, m: logs.append((step, m)))
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        launches = read_counts()
        if int(second.state.step) != TRAIN_STEPS or second.manager.latest_step() != TRAIN_STEPS:
            raise AssertionError("the resumed run did not reach its last step")
        for step, m in logs:
            log(f"train: step {step}: loss {m['loss']:.6f} epe {m['epe']:.4f} grad_norm {m['grad_norm']:.4f} "
                f"lr {m['lr']:.3e} pairs/s {m['pairs_per_s']:.3f}")
        if [s for s, _ in logs] != list(range(TRAIN_LOG_EVERY, TRAIN_STEPS + 1, TRAIN_LOG_EVERY)) or not all(
                math.isfinite(m["loss"]) for _, m in logs):
            raise AssertionError("a boundary is missing or its loss is not finite")
        ms = [s.elapsed_time(e) for s, e in events]
        steady = ms[1:TRAIN_CKPT_EVERY] + ms[TRAIN_CKPT_EVERY + 1:]  # each run's first step warms up
        log(f"train: {cfg.arch} {cfg.stage} stage (b={cfg.global_batch_size}, {cfg.crop_size[0]}x{cfg.crop_size[1]}, "
            f"{cfg.num_flow_updates} updates, dense fp32, no remat), {TRAIN_STEPS} "
            f"steps in two runs: step ms (CUDA events) {[round(t, 3) for t in ms]}, median after warm-up "
            f"{float(np.median(steady)):.3f} ms = {cfg.global_batch_size * 1e3 / float(np.median(steady)):.3f} "
            f"pairs/s; wall "
            f"{wall1:.3f} + {wall2:.3f} s; peak device memory {peak} B ({peak / 2**30:.3f} GiB); "
            f"launches {launches}; card {card}")
        if any(launches.values()):
            raise AssertionError(f"the dense training path launched a CUDA kernel of the port: {launches}")

        mgr = CheckpointManager(str(tmp / "timing"), max_to_keep=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(1, second.state, force=True)
        save_s = time.perf_counter() - t0
        probe = TrainState.create(build_raft(CONFIGS[cfg.arch], device=device, seed=5), second.tx)
        t0 = time.perf_counter()
        mgr.restore(probe)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        size = (tmp / "timing" / "1" / "state.pt").stat().st_size
        log(f"train: checkpoint save {save_s:.3f} s, restore {restore_s:.3f} s ({size} B; a Trainer's resume, "
            f"model build included, {resume_s:.3f} s)")
        if not states_equal(probe.state_dict(), second.state.state_dict()):
            raise AssertionError("a restored checkpoint differs from the saved state")

        # the loss falls on one fixed batch (the JAX package's
        # test_loss_decreases_on_fixed_batch, at full width)
        batch = next(iter(TrainPipeline(ds, cfg.global_batch_size, augmentor=second._augmentor, seed=1,
                                        device=device)))
        model = build_raft(CONFIGS[cfg.arch], device=device, seed=0)
        tx = make_optimizer(1e-4, weight_decay=1e-5)
        state = TrainState.create(model, tx)
        step = make_train_step_fn(model, tx, num_flow_updates=cfg.num_flow_updates)
        losses = []
        for _ in range(TRAIN_STEPS - 1):
            state, m = step(state, batch)
            losses.append(m["loss"])
        prof = profile_request(lambda: step(state, batch), ())
        if prof is not None:
            by_name, busy_us = prof
            conv_us = sum(us for name, us in by_name.items() if "conv" in name.lower() or "gemm" in name.lower()
                          or "fprop" in name.lower() or "dgrad" in name.lower() or "wgrad" in name.lower())
            log(f"train profile: convolutions and GEMMs {conv_us / 1e3:.3f} ms = {conv_us / busy_us:.4f} of one "
                f"step's device busy time")
        state, m = step(state, batch)
        losses = [float(x) for x in losses + [m["loss"]]]
        log(f"train: {len(losses) + 1} steps on one fixed batch, lr 1e-4: loss {[round(x, 5) for x in losses]}")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError("the loss did not fall on a fixed batch")
    log(f"train phase: {time.perf_counter() - t_phase:.1f} s")


def bench_phase():
    """``python -m raft_tpu_torch.bench`` at 2 pairs a configuration, in
    this process (its kernels are built): the lines and their schema. The
    full protocol is 128 pairs, the command logged here."""
    import contextlib
    import io

    from raft_tpu_torch import bench

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--pairs", "2"])
    lines = [json.loads(s) for s in out.getvalue().strip().splitlines()]
    for line in lines:
        log(f"bench: {json.dumps(line)}")
    want = ["raft_small_sintel_fps_exact", "raft_small_sintel_fps_native", "raft_small_sintel_fps_b8",
            "raft_small_sintel_fps", "raft_large_sintel_fps_exact", "raft_large_sintel_fps_b8",
            "raft_large_sintel_fps"]
    metrics = lines[1:]
    ok = rc == 0 and [m["metric"] for m in metrics] == want and all(
        {"metric", "value", "unit", "vs_baseline", "config"} <= set(m) and m["value"] > 0
        and "tf32=off" in m["config"] for m in metrics) and lines[0].get("card")
    log(f"bench: schema {'ok' if ok else 'WRONG'}, {time.perf_counter() - t0:.1f} s at --pairs 2; the full "
        "protocol is `python -m raft_tpu_torch.bench` (128 pairs a configuration)")
    if not ok:
        raise AssertionError("the bench's lines do not follow its protocol")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--train", "--steps", "2"])
    lines = [json.loads(s) for s in out.getvalue().strip().splitlines()]
    for line in lines:
        log(f"bench --train: {json.dumps(line)}")
    metrics = lines[1:]
    ok = rc == 0 and [m["metric"] for m in metrics] == ["raft_small_train_pairs_s", "raft_large_train_pairs_s"] and all(
        {"metric", "value", "unit", "protocol", "config"} <= set(m) and m["value"] > 0 and m["unit"] == "pairs/s"
        and "eager" in m["protocol"] and "tf32=off" in m["config"] for m in metrics) and lines[0].get("card")
    log(f"bench --train: schema {'ok' if ok else 'WRONG'}, {time.perf_counter() - t0:.1f} s at --steps 2; the "
        "full protocol is `python -m raft_tpu_torch.bench --train` (20 steps a model)")
    if not ok:
        raise AssertionError("the bench's training lines do not follow its protocol")


def tf32_flags():
    """The TF32 settings of cuDNN convolutions and cuBLAS matmuls as the
    per-operator API reads them (it reads legacy settings too)."""
    return torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to test", file=sys.stderr)
        return 1
    from raft_tpu_torch.kernels import build

    device = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # No global TF32 switch: the plain versions' matmuls are IEEE fp32 by
    # PyTorch's default, and the model pins fp32 itself (F2).
    flags = tf32_flags()
    log(f"tf32 flags left at torch's defaults: cudnn.conv {flags[0]!r}, cuda.matmul {flags[1]!r}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel sources in {time.perf_counter() - t0:.2f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
                log(f"build {name}: {line.strip()}")
    hmma = hmma_count(libs["corr_pyramid"], "corr_pyramid_kernel")
    log(f"build corr_pyramid: {hmma} HMMA (tensor-core) instructions in corr_pyramid_kernel's SASS (5-6 levels)")
    if hmma == 0:
        raise AssertionError("K3's mma.sync form has no tensor-core instructions")
    log(f"build corr_pyramid: the Hopper form's products by instantiation: {check_k3_wgmma(libs['corr_pyramid'])}; "
        f"ptxas: {ptxas_usage(build.build_logs.get('corr_pyramid', ''), 'corr_pyramid_wgmma_kernel')}")
    hgmma = hmma_count(libs["corr_pyramid"], "corr_pyramid_wgmma_kernel")
    hmma1 = hmma_count(libs["lookup_xtap"], "xtap_project_kernel")
    log(f"build lookup_xtap: {hmma1} HMMA (tensor-core) instructions in xtap_project_kernel's SASS "
        f"(its six forms); ptxas: {ptxas_usage(build.build_logs.get('lookup_xtap', ''), 'xtap_project_kernel')}")
    if hmma1 == 0:
        raise AssertionError("K1 has no tensor-core instructions")
    log(f"build lookup_xtap: K1's products by instantiation: {check_k1_products(libs['lookup_xtap'])}")

    lookup_err, lookup_times, lookup_bounds, k4_launches = lookup_phase(device)
    lowp_err, lowp_times, lowp_bounds, k1_batch8, k2_shapes = lowp_lookup_phase(device)
    k3_err, k3_times = volume_phase(device)
    k3b_err, k3b_times = volume_bf16_phase(device)
    t0 = time.perf_counter()
    k5_err, k5_times, k5_launches = inorm_phase(device)
    log(f"kernels K5 phase (Triton compiles included) {time.perf_counter() - t0:.2f} s")

    model, pairs, quality_flows, launches = main_path(device, card)  # the graphed requests' launches
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    k2_launches, _ = materialize_path(device, model, pairs[0])
    throughput_model, k1_throughput = throughput_path(device, card, pairs, quality_flows)
    k2b_launches, _ = materialize_path(device, throughput_model, pairs[0])
    del throughput_model
    import raft_tpu_torch as rt

    edge_model = rt.raft_large(corr_impl="fused", corr_dtype="int8", device=device)
    edge_model.load_state_dict(model.state_dict())
    k2q_launches, _ = materialize_path(device, edge_model, pairs[0])
    del model, edge_model
    if tf32_flags() != flags:
        raise AssertionError(f"the model left the tf32 flags changed: {tf32_flags()} after {flags}")
    log(f"tf32 flags after the main paths: unchanged, {tf32_flags()}")
    _, golden_launches = golden_phase(device)
    k3_launches, k3b_launches = sintel_path(device, card)
    bench_phase()
    k1_serve_q, _ = serving_phase(device, card, "quality", weights)
    k1_serve_t, _ = serving_phase(device, card, "throughput", weights)
    golden_serving_phase(device)
    train_phase(device, card)
    if tf32_flags() != flags:
        raise AssertionError(f"training left the tf32 flags changed: {tf32_flags()} after {flags}")
    log(f"tf32 flags after the training phase: unchanged, {tf32_flags()}")

    k3, k3_large = k3_times["raft_small_sintel"], k3_times["raft_large_sintel"]
    k3b, k3b_large = k3b_times["raft_small_sintel"], k3b_times["raft_large_sintel"]
    lookup_src = "raft_tpu_torch/kernels/csrc/lookup_xtap.cu"

    def entry(name, source, replaces, launches_, path, err, t, b, route="cuda", **extra):
        return {"name": name, "route": route, "source": source, "replaces": replaces, "launches": launches_,
                "path": path, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": b[0],
                "bound_by": b[1], "library_ms": t.get("library_ms"), **extra}

    k1_src, k2_src = "raft_tpu/kernels/lookup_xtap.py:412", "raft_tpu/kernels/lookup_xtap.py:385"
    k1 = {"ms": lookup_times["k1"], "plain_ms": lookup_times["k1_plain"], "library_ms": lookup_times["k1_library"]}
    k2 = {"ms": lookup_times["k2"], "plain_ms": lookup_times["k2_plain"], "library_ms": lookup_times["k2_library"]}
    k4 = {"ms": lookup_times["k4"], "plain_ms": lookup_times["k4_plain"], "library_ms": lookup_times["k2_library"]}
    k3_lib = "raft_tpu_torch/kernels/csrc/corr_pyramid.cu"
    kernels = [
        entry("xtap_project (K1: lookup + convcorr1), fp32 levels, 3xTF32 product", lookup_src, k1_src,
              launches["k1"], "FlowEstimator, raft_large fused fp32 (main path, graph replays)", lookup_err["k1"], k1,
              lookup_bounds["k1"], fp32_fma_bound_ms=lookup_bounds["k1_fma"][0], hmma=hmma1, **k1_batch8["k1"],
              serving_path=f"ServeEngine 'quality' at fused, raft_large, {SERVE_REQUESTS} requests (graph replays)",
              serving_launches=k1_serve_q),
        entry("xtap_project (K1), bf16 levels, 3xTF32 product", lookup_src, k1_src,
              golden_launches["fused + bf16 corr"], "validate, golden fixture at fused + bf16 corr (clean)",
              lowp_err["k1_bf16"], lowp_times["k1_bf16"], lowp_bounds["k1_bf16"]),
        entry("xtap_project (K1), bf16 levels, bf16 product", lookup_src, k1_src, k1_throughput,
              "FlowEstimator.from_preset('throughput'), raft_large (main path, graph replays)",
              lowp_err["k1_bf16_bf16"],
              lowp_times["k1_bf16_bf16"], lowp_bounds["k1_bf16_bf16"], **k1_batch8["k1_bf16_bf16"],
              serving_path=f"ServeEngine 'throughput', raft_large, {SERVE_REQUESTS} requests (graph replays)",
              serving_launches=k1_serve_t),
        entry("xtap_project (K1), int8 levels, 3xTF32 product", lookup_src, k1_src, golden_launches["edge"],
              "validate, golden fixture at 'edge' (clean)", lowp_err["k1_int8"], lowp_times["k1_int8"],
              lowp_bounds["k1_int8"]),
        entry("xtap_project (K1), int8 levels, bf16 product", lookup_src, k1_src, 0,
              "no preset runs it (int8 storage with bf16 convs); kernels phase only", lowp_err["k1_int8_bf16"],
              lowp_times["k1_int8_bf16"], lowp_bounds["k1_int8_bf16"]),
        entry("xtap (K2: lookup), fp32 levels", lookup_src, k2_src, k2_launches,
              "LazyCorrFeatures.materialize, raft_large fused fp32 (FlowEstimator launches it 0 times)",
              lookup_err["k2"], k2, lookup_bounds["k2"]),
        entry("xtap (K2), bf16 levels, bf16 taps", lookup_src, k2_src, k2b_launches,
              "LazyCorrFeatures.materialize, raft_large 'throughput'", lowp_err["k2_bf16"], lowp_times["k2_bf16"],
              lowp_bounds["k2_bf16"], **k2_shapes["k2_bf16"]),
        entry("xtap (K2), int8 levels, bf16 taps", lookup_src, k2_src, k2q_launches,
              "LazyCorrFeatures.materialize, raft_large 'edge'", lowp_err["k2_int8"], lowp_times["k2_int8"],
              lowp_bounds["k2_int8"], **k2_shapes["k2_int8"]),
        entry("corr_pyramid (K3: volume + pooled pyramid), fp32 levels", k3_lib,
              "raft_tpu/kernels/corr_pallas.py:64", k3_launches,
              f"validate, raft_small pallas, {REQUESTS} pairs 436x1024", k3_err,
              dict(k3, library_ms=k3["plain_ms"]), k3["bound"], fp32_fma_bound_ms=k3["fp32_bound"][0], hgmma=hgmma,
              hmma_5_6_levels=hmma, raft_large_ms=k3_large["ms"], raft_large_plain_ms=k3_large["plain_ms"],
              raft_large_bound_ms=k3_large["bound"][0]),
        entry("corr_pyramid (K3), bf16 levels", k3_lib, "raft_tpu/kernels/corr_pallas.py:64", k3b_launches,
              f"validate, raft_small pallas + bf16 pyramid, {REQUESTS} pairs 436x1024", k3b_err,
              dict(k3b, library_ms=k3b["plain_ms"]), k3b["bound"], hgmma=hgmma,
              raft_large_ms=k3b_large["ms"], raft_large_plain_ms=k3b_large["plain_ms"],
              raft_large_bound_ms=k3b_large["bound"][0],
              golden_path="validate, golden fixture at pallas + bf16 corr (clean)",
              golden_launches=golden_launches["pallas + bf16 corr"]),
        entry("xtap_lookup (K4: the lookup, K2's fp32 form at K4's radii)", lookup_src,
              "raft_tpu/kernels/lookup_pallas.py:50", k4_launches, "lookup_pyramid_pallas (own entry point)",
              lookup_err["k4"], k4, lookup_bounds["k4"]),
        entry("instance_norm (K5: stats + normalize)", "raft_tpu_torch/kernels/inorm_pallas.py",
              "raft_tpu/kernels/inorm_pallas.py:47", k5_launches, "instance_norm_pallas (own entry point)",
              k5_err["fp32"], k5_times, k5_times["bound"], route="triton"),
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
