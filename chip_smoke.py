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
     give NaN exactly where their plain versions do; K1 at the training
     shapes (raft_large's chairs stage, Q = 22816, and the train bench,
     Q = 26496), fp32/3xTF32 and bf16/bf16, against its plain version,
     timed beside it, its library chain and its bound, and one training
     lookup + projection, forward and backward, through the fused
     block (K1, then the dense formulation's autograd) against the dense
     block's: the gradients bit for bit, both timed;
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
     replayed), then ``--train`` at 2 steps a model, at dense fp32, at
     ``--corr fused`` and at ``--corr fused --corr-dtype bfloat16 --dtype
     bfloat16``, the lines checked against the protocol's schema and K1
     launched 24 times a fused step (12 updates, remat);
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
 11. whole-request serving: ``ServeEngine`` with ``pool_capacity=0``
     (max_batch 8, batch ladder 1/2/4/8, depth 2, every program captured
     at ``start()``) over the same weights at 'edge' (K1's int8 form) and
     at 'quality', 24 requests from 8 threads: boot and its peak memory,
     no capture after ``start()``, requests/s, p50/p99, padding waste,
     in-flight peak, the run's peak memory, K1 launches, every dispatched
     batch bit for bit the eager forward of its staged inputs, the idle
     share of a profiled burst of 8; at 'quality' the flows against the
     graphed FlowEstimator (1e-3 / 5e-2 px), a stream of 8 moving frames
     against pairwise submits (the encoder cache hit rate) and a
     ``submit_many`` burst of 16 with two invalid items; the golden
     fixture through it at 'quality' and 'edge' (1e-3, 3e-2 px; the pairs
     one at a time, and in one burst, which 'edge' logs: ROADMAP R3); streams
     in the pool at 'quality' against pairwise, then with
     ``stream_warm_start`` and a residual threshold (updates to converge,
     warm against cold); ``FlowStream`` graphed bit for bit eager;
 12. tiling and QoS: ``unknown_shape='tiled'`` at 'quality' in the pool
     and the whole-request engine (bucket 440x1024, warmed), 9 requests
     of 375x1242, 720x1280 and 1080x1920 (2, 4 and 6 tiles) from 4
     threads, then one of each alone: each tiled with the planner's
     count, finite, at its own shape; one ``put_many`` acquisition a
     request; no capture after ``start()``; the flows against the port's
     blend of the graphed FlowEstimator's flows on the same padded tiles
     (1e-3 / 5e-2 px); requests/s, p50/p99, blend ms, K1 launches. The
     golden tiled gate (the fixture through 96x128 in 2 tiles against
     96x136 whole, ``pool_capacity=0``: tiled - whole EPE <= 0.05 px on
     every sample at 'quality', logged at 'edge'). A QoS flood (queue 8,
     a rate-limited, a concurrency-capped and an unlimited tenant, 48
     requests from 12 threads: 12 interactive, 24 standard, 12 batch) in
     the pool at 'quality' and the whole-request engine at 'edge': every
     request served or refused typed or expired, every preemption of a
     strictly lower class, no batch-class request over an interactive
     one's updates at a level above 0, no capture after ``start()``;
 13. observability and the watchdogs: raft_large at 'quality' (fused),
     bucket 440x1024, warmed, in the pool and at ``pool_capacity=0``:
     the serving phase's 24 requests from 8 threads at
     ``trace_sample_rate`` 1.0 and 0 (ABBA, one engine) under
     ``apply_timeout_s`` 5 s: every result with a ``trace_id``, every
     span inside its trace, the trace's end within 1 ms of the result's
     latency (the admission aside), ``prometheus()`` parsed with the QoS
     series, no trip, no capture; a profiled pool burst with
     ``obs.profile`` on (one ``serve/pool_step`` range a tick); a ~2 s
     device stall (``torch.cuda._sleep`` ahead of one replay, through
     ``FaultInjector.patch_engine``) at ``apply_timeout_s`` 0.5 s in
     each engine: its 8 requests fail ``DeadlineExceeded`` within the
     timeout plus one poll of the stalled dispatch, one trip, the
     ``watchdog_trips`` page alert, valid bundles, a ``pool_reset`` in
     the pool, the next 8 requests within 1e-3 / 5e-2 px of the graphed
     FlowEstimator; the chairs-stage ``Trainer`` with a stalled data
     fetch (``StallError`` at ``data/next``, a stack dump, a bundle) and
     two fused windows of 2 steps between boundaries under an armed
     ``HostSyncTripwire`` (0 hits) and ``set_sync_debug_mode('warn')``;
 14. the serving tier, with the collector off: raft_large at 'throughput'
     (fused, bf16 levels, K1's bf16 product), bucket 440x1024, warmed, a
     one-rung ladder: one engine serves the 24 requests and is dropped
     (the card's memory comes back); ``ServeRouter`` over two thread
     replicas serves them (each flow within 'throughput''s bounds of the
     single engine's, both replicas served, no capture); under a burst
     ``replica_dead`` (``FaultInjector.patch_router``) declares r1 dead
     while it holds work (one eviction, a valid bundle, its work
     re-routed, every request a flow, readmission through a fresh engine
     that captures its own set, the evicted engine's memory back as the
     rebuild begins); a draining restart of a stream's home under load
     (nothing dropped, the stream keeps its home or re-primes); an
     ``Autoscaler`` (1..2): idle 2 -> 1, a flood of 24 clients 1 -> 2, a
     trickle 2 -> 1 (every request a flow or a typed shed, the memory
     back); ``prometheus()`` parsed; every engine gone after ``close()``;
     then the guarded rollouts over that fleet (an identical candidate
     promoted, a perturbed one rolled back on the flow gate, a crashed one
     rolled back); then the process fleet: the same requests through one
     in-process engine, then ``ServeRouter.from_factory(..., 2,
     backend='process')`` over ``ProcessFactory`` (a spawned worker each,
     its own CUDA context, the weights from a checkpoint the phase
     writes; the shared-memory rings sized to what a request moves and
     checked against ``/dev/shm``): distinct live PIDs, each boot's
     seconds and captures, the card's free memory and nvidia-smi's
     per-process list, no nvcc run in a worker, the 24 requests (within
     'throughput''s bounds of the in-process engine, both served, no
     capture after ``start()``, requests/s and p50/p99 beside the thread
     replicas), a worker SIGKILLed holding work (its work re-served, its
     PID gone and its memory back before a new PID is readmitted), a
     draining restart under load, a process candidate promoted, and after
     ``close()`` no worker PID and the card's memory back;
 15. training: ``Trainer`` at raft_large's chairs stage, full width (batch
     8, crop 368x496, 12 updates, dense fp32), on a synthetic FlyingChairs
     tree of 24 pairs at 384x512: 8 steps, a checkpoint every 4, a
     boundary every 2 (finite losses), preempted after step 4 and resumed
     by a second Trainer (its state the saved one bit for bit, its
     pipeline continuing the index stream), step times, pairs/s, peak
     memory, checkpoint save/restore seconds, no kernel of the port
     launched; then the loss must fall over 8 steps on one fixed batch,
     one step profiled (idle share); the same at ``corr_impl='fused'``
     with 2 steps a window, K1 once an update of each step's forward and
     no other kernel; the fused step's first gradient against the dense
     step's (2 updates, within ``TRAIN_GRAD_REL``) and a window of 2
     fused steps bit for bit against two per-step calls (with a per-step
     control); each remat policy at the train bench's shape (fused fp32:
     pairs/s, peak memory, K1 24 launches a step, 12 under 'corr'); the
     TF32 flags are checked unchanged;
 16. entry-point paths: ``lookup_pyramid_pallas`` (K4) and
     ``instance_norm_pallas`` (K5), each called once at the shapes above.

The last line is a JSON object ``{"ok": true, "device": {...}}``; the line
before it the card's name and power limit; before that a ``{"kernels":
[...]}`` JSON line. Without a card, or outside the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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

    # the launch of the serving pool's tick, the bench's _b8 lines and the
    # whole-request engine's batches of 8 ('edge': int8 levels): batch 8,
    # Q = 56320, each form held against its plain version there too
    pyr32, cents, weight, bias = kernel_inputs(device, **LOOKUP_CASES["serving_batch8"])
    weight_bf16 = lx.project_weight_bf16(weight)
    batch8 = {}
    for key, storage, proj in (("k1", "fp32", None), ("k1_bf16_bf16", "bf16", torch.bfloat16),
                               ("k1_int8", "int8", None)):
        pyr = pyr32 if storage == "fp32" else lowp_pyramid(pyr32, storage)
        wb = weight_bf16 if proj is not None else None
        scales = getattr(pyr, "scales", None)
        b8 = k1_bound(pyr, cents, weight, bias, RADIUS, proj)
        want = lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS, proj).float()
        err8 = (lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS, proj, wb).float() - want).abs().max().item()
        if not err8 <= k1_tolerance(want, storage, proj):
            raise AssertionError(f"K1 {key} at batch 8 disagrees with its plain version: {err8:.3e}")
        batch8[key] = {
            "batch8_ms": cuda_ms(lambda: lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS, proj, wb)),
            "batch8_plain_ms": cuda_ms(lambda: lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS, proj),
                                       reps=5),
            "batch8_library_ms": cuda_ms(
                lambda: k1_library_chain(pyr, cents, weight, bias, RADIUS, scales, proj or torch.float32), reps=5),
            "batch8_bound_ms": b8[0], "batch8_bound_by": b8[1], "batch8_max_abs_err": err8,
        }
        log(f"kernels K1 {key} at batch 8 (Q={cents.shape[0] * cents.shape[1] * cents.shape[2]}): "
            + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in batch8[key].items()))
    return err, times, bounds, batch8, k2_shapes


# K1 on the training path: raft_large's chairs stage (b=8, 368x496: a 46x62
# grid, Q = 22816) and the train bench (b=6, 368x768: 46x96, Q = 26496), at
# fp32 levels with the 3xTF32 product and at bf16 levels with the bf16 one
TRAIN_SHAPES = {"chairs": (8, 46, 62), "bench": (6, 46, 96)}
TRAIN_FORMS = (("k1", "fp32", None), ("k1_bf16_bf16", "bf16", torch.bfloat16))


def k1_training_phase(device):
    """K1 at the training shapes, each form against its plain version,
    timed beside its plain version, its library chain and its bound; and
    at fp32 one training lookup + projection, forward and backward, through
    ``project_fused_diff`` (K1, then the dense formulation's autograd)
    against the dense block's own forward and backward."""
    from raft_tpu_torch.kernels import lookup_xtap as lx
    from raft_tpu_torch.models.corr import CorrBlock

    rows = {key: {} for key, _, _ in TRAIN_FORMS}
    for label, (b, h, w) in TRAIN_SHAPES.items():
        pyr32, cents, weight, bias = kernel_inputs(device, b, h, w)
        weight_bf16 = lx.project_weight_bf16(weight)
        for key, storage, proj in TRAIN_FORMS:
            pyr = pyr32 if storage == "fp32" else lowp_pyramid(pyr32, storage)
            wb = weight_bf16 if proj is not None else None
            got = lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS, proj, wb)
            want = lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS, proj)
            torch.cuda.synchronize()
            e, tol = (got.float() - want.float()).abs().max().item(), k1_tolerance(want, storage, proj)
            if not (got.dtype == want.dtype and e <= tol):
                raise AssertionError(f"K1 {key} disagrees with its plain version at the {label} training shape")
            b1 = k1_bound(pyr, cents, weight, bias, RADIUS, proj)
            rows[key].update({
                f"train_{label}_ms": cuda_ms(
                    lambda: lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS, proj, wb)),
                f"train_{label}_plain_ms": cuda_ms(
                    lambda: lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS, proj), reps=5),
                f"train_{label}_library_ms": cuda_ms(
                    lambda: k1_library_chain(pyr, cents, weight, bias, RADIUS, None, proj or torch.float32), reps=5),
                f"train_{label}_bound_ms": b1[0], f"train_{label}_bound_by": b1[1], f"train_{label}_max_abs_err": e,
            })
        # one training lookup + projection at fp32: forward and backward
        # (levels, weight and bias require grad; the centroids are detached)
        dense = CorrBlock(LEVELS, RADIUS)
        fused = lx.FusedLookupCorrBlock(LEVELS, RADIUS)
        leaves = [lvl.detach().requires_grad_() for lvl in pyr32]
        wt, bs = weight.view(*weight.shape, 1, 1).detach().requires_grad_(), bias.detach().requires_grad_()
        cot = torch.randn((b, C_OUT, h, w), device=device, generator=torch.Generator(device=device).manual_seed(3))

        def fwd_bwd(block):
            out = block.index_project(leaves, cents, wt, bs)
            return torch.autograd.grad(out, leaves + [wt, bs], cot)

        gf, gd = fwd_bwd(fused), fwd_bwd(dense)
        same = all(torch.equal(a, c) for a, c in zip(gf, gd))
        rows["k1"].update({
            f"train_{label}_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(fused), reps=5),
            f"train_{label}_dense_fwd_bwd_ms": cuda_ms(lambda: fwd_bwd(dense), reps=5),
        })
        log(f"kernels K1 at the {label} training shape (Q={b * h * w}): " + "; ".join(
            f"{key} " + ", ".join(f"{k[len(label) + 7:]} {v:.4g}" if isinstance(v, float)
                                  else f"{k[len(label) + 7:]} {v}"
                                  for k, v in rows[key].items() if k.startswith(f"train_{label}_"))
            for key, _, _ in TRAIN_FORMS) + f"; fused block's gradients the dense block's bit for bit: {same}")
        if not same:
            raise AssertionError(f"the fused block's gradients are not the dense block's at the {label} shape")
        del pyr32, leaves, gf, gd
    return rows


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


def request_pair(seed: int, hw=IMAGE):
    """A raw uint8 ``hw``-sized pair, smooth random texture and its shifted
    copy, and the shift's flow (u, v) from the first image to the second."""
    rng = np.random.default_rng(seed)
    h, w = hw
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
    # streams off: the stream phases run on engines of their own
    cfg = ServeConfig(buckets=(SERVE_BUCKET,), pool_capacity=SERVE_CAPACITY, ladder=SERVE_LADDER, warmup=True,
                      default_deadline_ms=120_000.0, ledger_sample_every=0, stream_cache_size=0)
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


# The whole-request engine (pool_capacity=0) at raft_large full width: the
# serving phase's bucket, ladder, requests and threads, max_batch 8 (batch
# ladder 1, 2, 4, 8), pipeline depth 2, every program captured at start().
# Every dispatched batch is held bit for bit against the model's eager
# forward on its staged inputs (the batch-wide int8 scale makes a batch-1
# reference the wrong one at 'edge'); at 'quality' each request's flow also
# against the graphed FlowEstimator, the pool's bounds.
WR_MAX_BATCH, WR_DEPTH = 8, 2
STREAM_FRAMES, STREAM_STEP = 8, (3, -2)  # frames of a stream, its motion a frame (dx, dy px)
SUBMIT_MANY_ITEMS, SUBMIT_MANY_BAD = 16, (3, 11)


def stream_frames(seed: int, n: int = STREAM_FRAMES, step=STREAM_STEP):
    """``n`` raw uint8 IMAGE-sized frames of one smooth random texture
    moving ``step`` pixels a frame (``request_pair``'s texture): a video
    whose flow is the same every pair."""
    rng = np.random.default_rng(seed)
    h, w = IMAGE
    m = 8 + n * max(abs(s) for s in step)
    hh, ww = h + 2 * m, w + 2 * m
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, hh // 8 + 2, ww // 8 + 2)).astype(np.float32))
    tex = torch.nn.functional.interpolate(coarse, size=(hh, ww), mode="bicubic", align_corners=False)
    tex = tex[0].permute(1, 2, 0).clamp(0, 255).numpy().astype(np.uint8)
    dx, dy = step
    return [np.ascontiguousarray(tex[m - t * dy: m - t * dy + h, m - t * dx: m - t * dx + w]) for t in range(n)]


def flow_gap(results, wants):
    """(mean, max) |flow - want| px over paired flows."""
    d = [np.abs(r - w) for r, w in zip(results, wants)]
    return float(np.mean([x.mean() for x in d])), float(max(x.max() for x in d))


def record_batches(engine):
    """Wrap ``engine._run_batch`` (the dispatch seam) so each dispatched
    batch's staged inputs, iterations and flow are kept for a reference
    run; returns the list they go to."""
    orig, seen = engine._run_batch, []

    def run(p1, p2, iters):
        flow = orig(p1, p2, iters)
        seen.append((torch.as_tensor(p1).clone(), torch.as_tensor(p2).clone(), int(iters), flow.clone()))
        return flow

    engine._run_batch = run
    return seen


def whole_request_phase(device, card, preset, weights):
    """``ServeEngine`` with ``pool_capacity=0`` over raft_large at
    ``preset``: boot and captures, 24 requests from 8 threads (targets
    32/20/12; a batch runs at the largest of its members'), no capture
    after ``start()``, speed, padding, the window, a profiled burst,
    peak memory, K1 launches; every dispatched batch bit for bit the eager
    forward of its staged inputs; at 'quality' each flow against the
    graphed FlowEstimator, then streams and ``submit_many`` on the same
    engine. Returns the phase's K1 launches (graph replays x launches a
    graph) by part and its numbers."""
    import raft_tpu_torch as rt
    from raft_tpu_torch.graphs import capture_events
    from raft_tpu_torch.serve import ServeConfig, ServeEngine

    streams = preset == "quality"
    model = rt.raft_for_serving(ServeConfig.preset(preset), corr_impl="fused", device=device)
    model.load_state_dict(weights)
    cfg = ServeConfig.preset(preset, buckets=(SERVE_BUCKET,), pool_capacity=0, max_batch=WR_MAX_BATCH,
                             ladder=SERVE_LADDER, pipeline_depth=WR_DEPTH, warmup=True,
                             stream_cache_size=16 if streams else 0, default_deadline_ms=120_000.0,
                             ledger_sample_every=0)
    pairs = [request_pair(100 + i)[:2] for i in range(SERVE_REQUESTS)]
    targets = [SERVE_LADDER[i % len(SERVE_LADDER)] for i in range(SERVE_REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    engine = ServeEngine(model, cfg, device=device)
    t0 = time.perf_counter()
    engine.start()
    boot_s = time.perf_counter() - t0
    boot, counts = engine.stats()["boot"], engine.program_counts()
    torch.cuda.synchronize()
    boot_peak, held = torch.cuda.max_memory_allocated(device), torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    log(f"whole-request {preset}: boot to ready {boot_s:.3f} s ({json.dumps(boot)}), graphs per program family "
        f"{counts}; peak device memory over the boot {boot_peak} B ({boot_peak / 2**30:.3f} GiB), held after it "
        f"{held} B ({held / 2**30:.3f} GiB); card {card}")
    seen = record_batches(engine)
    ev0, k1_0 = capture_events(), by_kernel(engine.graph_launches())["k1"]
    reset_counts()
    t0 = time.perf_counter()
    results = serve_requests(engine, pairs, targets, SERVE_THREADS)
    wall = time.perf_counter() - t0
    stats = engine.stats()
    captures, eager = capture_events() - ev0, read_counts()
    k1_run = by_kernel(engine.graph_launches())["k1"] - k1_0
    peak = torch.cuda.max_memory_allocated(device)  # over the run alone
    lat = [r.latency_ms for r in results]
    log(f"whole-request {preset}: {SERVE_REQUESTS} requests from {SERVE_THREADS} threads in {wall:.3f} s = "
        f"{SERVE_REQUESTS / wall:.3f} requests/s; latency p50 {np.percentile(lat, 50):.3f} ms p99 "
        f"{np.percentile(lat, 99):.3f} ms; {stats['batches']} batches, rungs "
        f"{sorted(int(s[0].shape[0]) for s in seen)}, padding_waste {stats['padding_waste']:.4f}, inflight_peak "
        f"{stats['inflight_peak']}, nonfinite_batches {stats['nonfinite_batches']}, retried_singles "
        f"{stats['retried_singles']}; K1 {k1_run} in the run (graph replays x launches per graph), eager launches "
        f"{eager}; captures during the run {captures}; peak device memory over the run {peak} B "
        f"({peak / 2**30:.3f} GiB); card {card}")
    # a batch runs at the largest of its members' targets (ladder rungs)
    bad = [(r.rid, n, r.num_flow_updates) for r, n in zip(results, targets)
           if r.num_flow_updates < n or r.flow.shape != IMAGE + (2,) or not np.isfinite(r.flow).all()]
    if bad or captures or eager["k1"] or k1_run != sum(s[2] for s in seen):
        raise AssertionError(f"whole-request {preset}: off target {bad}, {captures} captures after start(), "
                             f"eager {eager}, K1 {k1_run} against {sum(s[2] for s in seen)} updates dispatched")
    # each dispatched batch against the eager forward of its staged
    # inputs, on this thread (which captured the graphs: cuDNN's choices
    # are kept per thread)
    with torch.inference_mode():
        for p1, p2, iters, flow in seen:
            want = model(p1.to(device).permute(0, 3, 1, 2), p2.to(device).permute(0, 3, 1, 2),
                         num_flow_updates=iters, emit_all=False)
            if not torch.equal(flow, want):
                raise AssertionError(f"whole-request {preset}: a batch of {p1.shape[0]} at {iters} updates differs "
                                     f"from its eager forward by {(flow - want).abs().max().item():.3e} px")
    log(f"whole-request {preset}: all {len(seen)} dispatched batches bit for bit their eager forward")
    del engine._run_batch  # the recording wrapper
    idle = profiled_burst(engine, f"whole-request {preset}", pairs[:WR_MAX_BATCH], card)
    out = {"requests_per_s": SERVE_REQUESTS / wall, "peak": peak, "boot_peak": boot_peak, "boot_s": boot_s, "idle": idle,
           "k1": {"run": k1_run, "batches": len(seen), "rungs": sorted(int(s[0].shape[0]) for s in seen)}}
    if streams:
        est = rt.FlowEstimator(model, num_flow_updates=SERVE_LADDER[0], pad_mode="downstream", device=device)
        mean_d, max_d = flow_gap([r.flow for r in results],
                                 [est(*p, num_flow_updates=r.num_flow_updates) for p, r in zip(pairs, results)])
        tol_mean, tol_max = SERVE_TOL[preset]
        log(f"whole-request {preset}: |dflow| vs the graphed FlowEstimator (batch 1) mean {mean_d:.3e} px (tol "
            f"{tol_mean:g}), max {max_d:.3e} px (tol {tol_max:g})")
        if not (mean_d <= tol_mean and max_d <= tol_max):
            raise AssertionError(f"whole-request {preset}: flows disagree with FlowEstimator")
        out["k1"]["stream"] = engine_stream_check(engine, "whole-request", card)
        submit_many_check(engine)
    engine.stop()
    return out


def profiled_burst(engine, what, burst, card):
    """A burst of requests at the ladder's top under torch.profiler: wall,
    device busy, idle share and the top device ops (None when the profiler
    records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_requests(engine, burst, [SERVE_LADDER[0]] * len(burst), len(burst))
        torch.cuda.synchronize()
        burst_ms = (time.perf_counter() - t0) * 1e3
    busy = device_busy(prof)
    if busy is None:
        log(f"{what}: profiled burst recorded no device activity; idle share not measured")
        return None
    by_name, busy_us, ops = busy
    idle = 1 - busy_us / 1e3 / burst_ms
    log(f"{what}: profiled burst of {len(burst)} requests at {SERVE_LADDER[0]} updates: wall {burst_ms:.3f} ms, "
        f"device busy {busy_us / 1e3:.3f} ms, idle share {idle:.3f}, {ops} device ops; card {card}")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        log(f"{what} profile:   {us / 1e3:9.3f} ms  {n:6d}x  {name[:110]}")
    return idle


def engine_stream_check(engine, what, card, frames=None):
    """A stream of ``STREAM_FRAMES`` moving frames through
    ``engine.open_stream`` against pairwise ``submit`` of the same pairs on
    the same engine (1e-3 / 5e-2 px mean / max), the encoder cache hit
    rate, no capture; returns the stream's K1 launches."""
    from raft_tpu_torch.graphs import capture_events

    frames = frames or stream_frames(7)
    ev0, k1_0 = capture_events(), by_kernel(engine.graph_launches())["k1"]
    s0 = engine.stats()
    reset_counts()
    t0 = time.perf_counter()
    with engine.open_stream() as stream:
        streamed = [stream.submit(f) for f in frames]
    wall = time.perf_counter() - t0
    k1 = by_kernel(engine.graph_launches())["k1"] - k1_0
    eager, captures, s1 = read_counts(), capture_events() - ev0, engine.stats()
    hits = s1["encode_cache_hits"] - s0["encode_cache_hits"]
    misses = s1["encode_cache_misses"] - s0["encode_cache_misses"]
    pairwise = [engine.submit(frames[t], frames[t + 1]).flow for t in range(len(frames) - 1)]
    mean_d, max_d = flow_gap([r.flow for r in streamed[1:]], pairwise)
    log(f"{what} stream: {len(frames)} frames in {wall:.3f} s ({[round(r.latency_ms, 3) for r in streamed]} ms), "
        f"encoder cache hit rate {hits}/{hits + misses}; |dflow| vs pairwise submit mean {mean_d:.3e} px, max "
        f"{max_d:.3e} px (tol {FLOW_MEAN_TOL:g} / {FLOW_MAX_TOL:g}); K1 {k1} (graph replays), eager {eager}; "
        f"captures {captures}; card {card}")
    if not (streamed[0].primed and all(not r.primed for r in streamed[1:]) and hits == len(frames) - 1
            and misses == 1 and captures == 0 and not eager["k1"]
            and mean_d <= FLOW_MEAN_TOL and max_d <= FLOW_MAX_TOL):
        raise AssertionError(f"{what} stream: primes {[r.primed for r in streamed]}, hits {hits}, misses {misses}, "
                             f"captures {captures}, eager {eager}, |dflow| {mean_d:.3e} / {max_d:.3e}")
    return k1


def submit_many_check(engine):
    """One burst of ``SUBMIT_MANY_ITEMS`` items, two invalid (a batched
    image, a NaN pixel): one handle per item, in order; the invalid ones
    finished with InvalidInput, the rest served at their own target."""
    pairs = [request_pair(200 + i)[:2] for i in range(SUBMIT_MANY_ITEMS)]
    items = [dict(image1=a, image2=b, num_flow_updates=SERVE_LADDER[-1]) for a, b in pairs]
    items[SUBMIT_MANY_BAD[0]]["image1"] = pairs[SUBMIT_MANY_BAD[0]][0][None]
    nan = pairs[SUBMIT_MANY_BAD[1]][1].astype(np.float32)
    nan[5, 7, 1] = np.nan
    items[SUBMIT_MANY_BAD[1]]["image2"] = nan
    t0 = time.perf_counter()
    handles = engine.submit_many(items)
    ok = all(h.wait(120) for h in handles)
    wall = time.perf_counter() - t0
    kinds = [type(h.error).__name__ if h.error is not None else "ok" for h in handles]
    log(f"submit_many: {len(items)} items in one call, served in {wall:.3f} s; outcomes {kinds}")
    want = ["InvalidInput" if i in SUBMIT_MANY_BAD else "ok" for i in range(len(items))]
    if not ok or kinds != want or any(
            h.result.num_flow_updates != SERVE_LADDER[-1] or not np.isfinite(h.result.flow).all()
            for h in handles if h.error is None):
        raise AssertionError(f"submit_many: outcomes {kinds}, expected {want}")


def pool_stream_phase(device, card, weights):
    """Streams in the iteration pool at 'quality' (capacity 8): stream
    against pairwise; then a second pool with ``stream_warm_start`` and a
    residual threshold from the first pool's mean residual at update 17
    (the middle of the ladder's top, 32):
    the mean updates to converge, cold (pairwise submits) against warm
    (stream pairs seeded with the previous pair's forward-warped flow).
    Returns the K1 launches of both pools' streams."""
    import raft_tpu_torch as rt
    from raft_tpu_torch.serve import ServeConfig, ServeEngine

    model = rt.raft_for_serving(ServeConfig.preset("quality"), corr_impl="fused", device=device)
    model.load_state_dict(weights)
    base = dict(buckets=(SERVE_BUCKET,), pool_capacity=SERVE_CAPACITY, ladder=SERVE_LADDER, warmup=True,
                default_deadline_ms=120_000.0, ledger_sample_every=0)
    frames = stream_frames(7)
    with ServeEngine(model, ServeConfig(**base), device=device) as engine:
        log(f"pool stream: boot {engine.stats()['boot']}, graphs {engine.program_counts()}")
        k1 = engine_stream_check(engine, "pool", card, frames)
        resid = engine.stats()["convergence"]["resid_by_iter"]
    thresh = float(resid[len(resid) // 2])
    cfg = ServeConfig(stream_warm_start=True, pool_converge_thresh=thresh, pool_converge_streak=2, **base)
    with ServeEngine(model, cfg, device=device) as engine:
        cold = [engine.submit(frames[t], frames[t + 1]) for t in range(len(frames) - 1)]
        k1_0 = by_kernel(engine.graph_launches())["k1"]
        with engine.open_stream() as stream:
            warm = [stream.submit(f) for f in frames]
        k1_warm = by_kernel(engine.graph_launches())["k1"] - k1_0
        stats = engine.stats()
    seeded = [r for r in warm[2:]]
    it_cold = [r.num_flow_updates for r in cold]
    it_warm = [r.num_flow_updates for r in seeded]
    mean_d, max_d = flow_gap([r.flow for r in seeded], [r.flow for r in cold[1:]])
    log(f"pool warm start: threshold {thresh:.4e} px (mean residual at update {len(resid) // 2 + 1}, streak 2); "
        f"updates to converge "
        f"cold {it_cold} (mean {np.mean(it_cold):.3f}, exits {[r.exit_reason for r in cold]}), warm {it_warm} "
        f"(mean {np.mean(it_warm):.3f}, exits {[r.exit_reason for r in seeded]}); the first stream pair cold "
        f"{warm[1].num_flow_updates}; warm vs cold |dflow| mean {mean_d:.3e} px max {max_d:.3e} px; "
        f"stream_warm_starts {stats['stream_warm_starts']}; K1 {k1_warm}; card {card}")
    if not (all(r.warm_started for r in seeded) and not warm[1].warm_started
            and stats["stream_warm_starts"] == len(seeded)):
        raise AssertionError("pool warm start: the stream's pairs were not seeded as expected")
    return k1 + k1_warm


def flow_stream_phase(device, card, weights):
    """``FlowStream`` over raft_large 'quality' at 32 updates: 4 frames by
    graph replay, bit for bit the eager encode + iterate on the same
    inputs; the graphs' K1 launches."""
    import raft_tpu_torch as rt
    from raft_tpu_torch.eval.padder import InputPadder

    model = rt.raft_large(corr_impl="fused", device=device)
    model.load_state_dict(weights)
    est = rt.FlowEstimator(model, num_flow_updates=UPDATES, device=device)
    frames = stream_frames(8, n=4)
    stream = est.open_stream()
    t0 = time.perf_counter()
    got = [stream(f) for f in frames]
    wall = time.perf_counter() - t0
    padder = InputPadder(est._normalize(frames[0]).shape, mode=est.pad_mode)
    with torch.inference_mode():
        enc = [model.encode_frame(est._to_device(padder.pad(est._normalize(f)))) for f in frames]
        for t in range(1, len(frames)):
            flow = model.iterate(enc[t - 1][0], enc[t][0], enc[t - 1][1], num_flow_updates=UPDATES, emit_all=False)
            if not np.array_equal(got[t], padder.unpad(est._to_host(flow))[0]):
                raise AssertionError(f"FlowStream: graphed pair {t} differs from the eager encode + iterate")
    k1 = by_kernel(est.graph_launches())["k1"]
    log(f"FlowStream: {len(frames)} frames (captures included) in {wall:.3f} s, graphs "
        f"{sorted(k[0] for k in est.stream_programs())}; bit for bit the eager encode + iterate; K1 {k1}; card {card}")
    if k1 != UPDATES * (len(frames) - 1):
        raise AssertionError(f"FlowStream: K1 {k1} launches, expected {UPDATES * (len(frames) - 1)}")
    return k1


def golden_whole_request_phase(device):
    """The golden fixture through the whole-request engine at 'quality'
    and at 'edge', each pair padded as the Sintel protocol pads it: the
    pairs one at a time (each its own batch, rung 1), then in one
    ``submit_many`` burst (one batch of 3 at rung 4, its composition
    fixed). Held to ``tests/test_epe_golden.py``'s bounds (1e-3, 3e-2 px):
    both ways at 'quality'; at 'edge' one at a time. At 'edge' the burst
    is logged, not held: the int8 scale is one a level over the batch,
    and the zero pad row (a constant frame correlated with itself) sets
    it for the real rows (ROADMAP R3, the reference's semantics), which
    puts the burst within a few percent of the bound."""
    import raft_tpu_torch as rt
    from raft_tpu_torch.data import Sintel
    from raft_tpu_torch.eval.padder import InputPadder
    from raft_tpu_torch.serve import ServeConfig, ServeEngine

    expected = json.loads((FIXTURE / "expected.json").read_text())
    ref = expected["reference"]["clean"]
    ds = Sintel(str(FIXTURE), split="training", dstype="clean")
    samples = [ds[i] for i in range(len(ds))]
    padders = [InputPadder(s["image1"].shape, mode="sintel") for s in samples]
    items = [dict(zip(("image1", "image2"), p.pad(s["image1"], s["image2"]))) for p, s in zip(padders, samples)]

    def epe_of(results):
        return np.concatenate([
            np.linalg.norm(p.unpad(r.flow[None])[0] - s["flow"], axis=-1).reshape(-1)
            for p, r, s in zip(padders, results, samples)
        ]).mean()

    launches = {}
    for preset, tol in (("quality", EPE_TOL), ("edge", 3e-2)):
        model = rt.raft_for_serving(ServeConfig.preset(preset), arch="raft_small",
                                    checkpoint=str(FIXTURE / "weights.msgpack"), device=device, **FIXTURE_ARCH)
        cfg = ServeConfig.preset(preset, buckets=((96, 136),), pool_capacity=0, max_batch=WR_MAX_BATCH,
                                 ladder=(32,), default_deadline_ms=120_000.0)
        with ServeEngine(model, cfg, device=device) as engine:
            alone = [engine.submit(it["image1"], it["image2"]) for it in items]
            handles = engine.submit_many(items)
            if not all(h.wait(120) and h.error is None for h in handles):
                raise AssertionError(f"golden through the whole-request engine: {[h.error for h in handles]}")
            burst = [h.result for h in handles]
            launches[preset] = by_kernel(engine.graph_launches())["k1"]
            batches = engine.stats()["batches"]
        d_alone, d_burst = abs(epe_of(alone) - ref), abs(epe_of(burst) - ref)
        log(f"golden EPE through the whole-request engine ({preset}, 32 updates, reference {ref:.7f}, tol {tol:g}): "
            f"{len(samples)} pairs one at a time |d| {d_alone:.3e}; in one burst (one batch of {len(samples)} at rung "
            f"{engine._rung(len(samples))}) |d| {d_burst:.3e}{'' if preset == 'quality' else ' (not held: R3)'}; "
            f"{batches} batches; K1 {launches[preset]}")
        held = [d_alone] + ([d_burst] if preset == "quality" else [])
        if not all(d < tol for d in held) or any(r.num_flow_updates != 32 for r in alone + burst):
            raise AssertionError(f"golden EPE through the whole-request engine at {preset} misses the reference")
    return launches


# Tiled serving: off-bucket frames (KITTI, 720p, 1080p) through the
# 440x1024 bucket's captured programs as blended tiles, in both engines at
# 'quality'; QoS under a flood in the pool at 'quality' and the
# whole-request engine at 'edge'.
TILED_SHAPES = ((375, 1242), (720, 1280), (1080, 1920))
TILED_PER_SHAPE, TILED_THREADS = 3, 4
QOS_QUOTAS = (("tenant-a", 20.0, 4.0, 0), ("tenant-b", 0.0, 0.0, 2))
QOS_TENANTS = ("tenant-a", "tenant-b", "tenant-c")  # tenant-c has no quota
QOS_CLASSES = ("interactive",) * 3 + ("standard",) * 6 + ("batch",) * 3  # one a thread: 12 threads
QOS_ROUNDS, QOS_QUEUE = 4, 8


def tiled_phase(device, card, weights):
    """``ServeEngine`` at 'quality' with ``unknown_shape='tiled'``, in the
    pool (capacity 8) and the whole-request engine (max_batch 8), warmed:
    9 requests of 375x1242, 720x1280 and 1080x1920 from 4 threads, then
    one of each shape alone. Each
    result finite, at its own shape, tiled with the planner's tile count;
    no capture after ``start()``; one ``put_many`` acquisition a request;
    each flow against the port's blend of the graphed FlowEstimator's
    flows on the same padded tiles (the pool's bounds). Returns each
    engine's K1 launches (graph replays x launches a graph), one request
    of each shape alone included."""
    from concurrent.futures import ThreadPoolExecutor

    import raft_tpu_torch as rt
    from raft_tpu_torch.graphs import capture_events
    from raft_tpu_torch.serve import ServeConfig, ServeEngine, blend_tiles
    from raft_tpu_torch.serve.bucketing import BucketRouter

    model = rt.raft_for_serving(ServeConfig.preset("quality"), corr_impl="fused", device=device)
    model.load_state_dict(weights)
    shapes = [TILED_SHAPES[i % len(TILED_SHAPES)] for i in range(TILED_PER_SHAPE * len(TILED_SHAPES))]
    pairs = [request_pair(300 + i, hw)[:2] for i, hw in enumerate(shapes)]
    est = rt.FlowEstimator(model, num_flow_updates=SERVE_LADDER[0], pad_mode="downstream", device=device)
    wants, launches = {}, {}
    for kind, extra in (("pool", dict(pool_capacity=SERVE_CAPACITY)),
                        ("whole-request", dict(pool_capacity=0, pipeline_depth=WR_DEPTH))):
        cfg = ServeConfig.preset("quality", buckets=(SERVE_BUCKET,), max_batch=WR_MAX_BATCH, ladder=SERVE_LADDER,
                                 unknown_shape="tiled", warmup=True, stream_cache_size=0,
                                 default_deadline_ms=120_000.0, ledger_sample_every=0, **extra)
        engine = ServeEngine(model, cfg, device=device)
        t0 = time.perf_counter()
        engine.start()
        boot_s = time.perf_counter() - t0
        counts = engine.program_counts()
        ev0, k1_0 = capture_events(), by_kernel(engine.graph_launches())["k1"]
        calls0 = engine._queue.put_many_calls
        reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(TILED_THREADS) as ex:
            results = list(ex.map(lambda p: engine.submit(*p), pairs))
        wall = time.perf_counter() - t0
        # then one request of each shape alone: its latency and its blend
        alone = {}
        for hw in TILED_SHAPES:
            r = engine.submit(*pairs[shapes.index(hw)])
            if not (r.tiled and r.flow.shape == hw + (2,) and np.isfinite(r.flow).all()):
                raise AssertionError(f"tiled {kind}: a {hw} request alone came back {r.tiled}, {r.flow.shape}")
            alone[f"{hw[0]}x{hw[1]}"] = (round(r.latency_ms, 3), round(engine._tiler_blend_ms[-1], 3))
        n_req = len(pairs) + len(TILED_SHAPES)
        captures, eager = capture_events() - ev0, read_counts()
        k1_run = by_kernel(engine.graph_launches())["k1"] - k1_0
        calls = engine._queue.put_many_calls - calls0
        stats = engine.stats()
        tiler = stats["tiler"]
        plans = [engine._tiler.plan(hw) for hw in shapes]
        engine.stop()
        lat = [r.latency_ms for r in results]
        by_shape = {f"{h}x{w}": round(float(np.median([r.latency_ms for r, s in zip(results, shapes) if s == (h, w)])),
                                      3) for h, w in TILED_SHAPES}
        log(f"tiled {kind} quality: boot {boot_s:.3f} s, graphs {counts}; {len(pairs)} requests "
            f"({', '.join(f'{h}x{w}: {engine._tiler.plan((h, w)).n_tiles} tiles' for h, w in TILED_SHAPES)}) from "
            f"{TILED_THREADS} threads in {wall:.3f} s = {len(pairs) / wall:.3f} requests/s; latency p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms, median by shape {by_shape}; then "
            f"one of each alone (latency ms, of it blend ms) {alone}; over all {n_req} requests blend ms p50 {tiler['blend_ms']['p50_ms']:.3f} p99 {tiler['blend_ms']['p99_ms']:.3f}; waste "
            f"{tiler['waste_frac']:.4f}; tiles {tiler['tiles_submitted']}, retried {tiler['tiles_retried']}, "
            f"put_many acquisitions {calls} (admission_acquisitions {tiler['admission_acquisitions']}); "
            f"batches {stats['batches']}; K1 {k1_run} in the run (graph replays x launches per graph), eager "
            f"{eager}; captures after start() {captures}, program counts {engine.program_counts()}; card {card}")
        bad = [(r.rid, hw, r.tiled, r.tiles, p.n_tiles, r.num_flow_updates) for r, hw, p in zip(results, shapes, plans)
               if not (r.tiled and r.tiles == p.n_tiles and r.flow.shape == hw + (2,) and np.isfinite(r.flow).all()
                       and r.num_flow_updates == SERVE_LADDER[0])]
        if bad or captures or engine.program_counts() != counts or eager["k1"] or not k1_run:
            raise AssertionError(f"tiled {kind}: bad results {bad}, {captures} captures after start(), eager "
                                 f"{eager}, K1 {k1_run}")
        if calls != n_req + tiler["tiles_retried"] or tiler["admission_acquisitions"] != n_req:
            raise AssertionError(f"tiled {kind}: {calls} put_many acquisitions for {n_req} requests and "
                                 f"{tiler['tiles_retried']} retried tiles")
        # the reference: the graphed FlowEstimator on each padded tile
        # (batch 1), cropped back and blended by the port's blend
        for i, ((im1, im2), plan) in enumerate(zip(pairs, plans)):
            if i not in wants:
                flows = []
                for t in plan.tiles:
                    a, b = (BucketRouter.pad_to(im[t.y0:t.y0 + t.h, t.x0:t.x0 + t.w], SERVE_BUCKET)
                            for im in (im1, im2))
                    flows.append(est(a, b)[:t.h, :t.w])
                wants[i] = blend_tiles(plan, engine._tiler.weights(plan), flows)
        mean_d, max_d = flow_gap([r.flow for r in results], [wants[i] for i in range(len(pairs))])
        tol_mean, tol_max = SERVE_TOL["quality"]
        log(f"tiled {kind} quality: |dflow| vs the blend of the graphed FlowEstimator's tiles (batch 1) mean "
            f"{mean_d:.3e} px (tol {tol_mean:g}), max {max_d:.3e} px (tol {tol_max:g})")
        if not (mean_d <= tol_mean and max_d <= tol_max):
            raise AssertionError(f"tiled {kind}: flows disagree with the blended FlowEstimator tiles")
        launches[kind] = {"k1": k1_run, "requests": n_req, "tiles": tiler["tiles_submitted"],
                          "requests_per_s": len(pairs) / wall}
    return launches


def golden_tiled_phase(device):
    """The JAX package's tiled golden gate (``tests/test_serve_zzzzz_tiler.py``
    ``TestGoldenParity``) on the card: the fixture's trained weights, each
    92x132 pair served whole in bucket 96x136 and tiled in bucket 96x128
    (two column tiles), whole-request engine, max_batch 1, 32 updates.
    At 'quality' the tiled EPE may exceed the whole frame's by at most
    0.05 px on every sample, and differ by at most 1 px either way; at
    'edge' the deltas are logged, not held (ROADMAP R3). Returns K1's
    launches by preset."""
    import raft_tpu_torch as rt
    from raft_tpu_torch.data import Sintel
    from raft_tpu_torch.serve import ServeConfig, ServeEngine

    ds = Sintel(str(FIXTURE), split="training", dstype="clean")
    samples = [ds[i] for i in range(len(ds))]

    def epe(res, s):
        return float(np.linalg.norm(res.flow - s["flow"], axis=-1)[s["valid"]].mean())

    launches = {}
    for preset in ("quality", "edge"):
        model = rt.raft_for_serving(ServeConfig.preset(preset), arch="raft_small",
                                    checkpoint=str(FIXTURE / "weights.msgpack"), device=device, **FIXTURE_ARCH)
        base = dict(ladder=(32,), max_batch=1, pool_capacity=0, queue_capacity=4, max_wait_ms=2.0,
                    default_deadline_ms=300_000.0, stream_cache_size=0)
        full_cfg = ServeConfig.preset(preset, buckets=((96, 136),), **base)
        tiled_cfg = ServeConfig.preset(preset, buckets=((96, 128),), unknown_shape="tiled", **base)
        reset_counts()
        with ServeEngine(model, full_cfg, device=device) as full, ServeEngine(model, tiled_cfg, device=device) as tiled:
            pairs = [(full.submit(s["image1"], s["image2"]), tiled.submit(s["image1"], s["image2"])) for s in samples]
            launches[preset] = sum(by_kernel(e.graph_launches())["k1"] for e in (full, tiled))
        eager = read_counts()
        deltas = [epe(rt_, s) - epe(rf, s) for (rf, rt_), s in zip(pairs, samples)]
        shape_ok = all(not rf.tiled and rt_.tiled and rt_.tiles == 2 and np.isfinite(rt_.flow).all()
                       and rt_.num_flow_updates == 32 for rf, rt_ in pairs)
        log(f"golden tiled parity ({preset}, {len(samples)} pairs of 92x132, 96x136 whole vs 96x128 tiled in 2 tiles, "
            f"32 updates): EPE whole {[round(epe(rf, s), 5) for (rf, _), s in zip(pairs, samples)]}, tiled - whole "
            f"{[round(d, 5) for d in deltas]} (gate <= 0.05 each, |d| <= 1.0{'' if preset == 'quality' else '; not held: R3'}); "
            f"K1 {launches[preset]} (graph replays x launches per graph), eager {eager}")
        if not shape_ok:
            raise AssertionError(f"golden tiled parity {preset}: results not tiled in 2 or not finite")
        if preset == "quality" and not (max(deltas) <= 0.05 and max(abs(d) for d in deltas) <= 1.0):
            raise AssertionError(f"golden tiled parity: tiled EPE - whole EPE {deltas} misses the gate")
    return launches


def qos_flood_phase(device, card, preset, weights):
    """A QoS flood: ``qos_enabled``, queue capacity 8, tenant quotas
    (tenant-a 20 requests/s with a burst of 4, tenant-b 2 in flight,
    tenant-c unlimited), warmed; 48 requests of 436x1024 from 12 threads
    (12 interactive, 24 standard, 12 batch), in the pool at 'quality' or
    the whole-request engine at 'edge'. Holds: every request served, or
    refused typed (``Overloaded``, ``QuotaExceeded``) or expired, and
    nothing else; every preemption displaced a strictly lower class; at a
    degradation level above 0 a batch-class request never ran more
    updates than an interactive one at the same level; no capture after
    ``start()``. Returns the run's K1 launches."""
    import threading

    import raft_tpu_torch as rt
    from raft_tpu_torch.graphs import capture_events
    from raft_tpu_torch.serve import DeadlineExceeded, Overloaded, QuotaExceeded, ServeConfig, ServeEngine

    pool = preset == "quality"
    model = rt.raft_for_serving(ServeConfig.preset(preset), corr_impl="fused", device=device)
    model.load_state_dict(weights)
    cfg = ServeConfig.preset(preset, buckets=(SERVE_BUCKET,), pool_capacity=SERVE_CAPACITY if pool else 0,
                             max_batch=WR_MAX_BATCH, ladder=SERVE_LADDER, pipeline_depth=WR_DEPTH, warmup=True,
                             stream_cache_size=0, ledger_sample_every=0, qos_enabled=True, queue_capacity=QOS_QUEUE,
                             qos_tenant_quotas=QOS_QUOTAS, default_deadline_ms=5000.0)
    kind = f"{'pool' if pool else 'whole-request'} {preset}"
    engine = ServeEngine(model, cfg, device=device)
    t0 = time.perf_counter()
    engine.start()
    boot_s = time.perf_counter() - t0
    counts = engine.program_counts()
    ladder = engine._controller.ladder
    # what the engine decided, recorded at its seams: (level, class rank,
    # updates) per admitted request, and (victim rank, arrival rank) per
    # preemption
    decisions, preemptions, lock = [], [], threading.Lock()
    if pool:
        insert = engine._pool_insert_live

        def pool_insert_live(p, rows, live, ctrl_iters, level):
            insert(p, rows, live, ctrl_iters, level)
            metas = {id(m.req): m for _, m in p.occupied()}
            with lock:
                decisions.extend((level, r.rank, metas[id(r)].target) for r in live)

        engine._pool_insert_live = pool_insert_live
    else:
        levels = engine._qos_levels

        def qos_levels(live, iters, level):
            out = levels(live, iters, level)
            with lock:
                decisions.extend((level, r.rank, out[0]) for r in live)
            return out

        engine._qos_levels = qos_levels
    preempted = engine._qos_preempted

    def qos_preempted(victims, by):
        with lock:
            preemptions.extend((v.rank, by.rank) for v in victims)
        preempted(victims, by)

    engine._qos_preempted = qos_preempted
    pairs = [request_pair(400 + i)[:2] for i in range(len(QOS_CLASSES))]
    tally = {c: {"completed": 0, "overloaded": 0, "quota": 0, "expired": 0, "latency": []} for c in set(QOS_CLASSES)}
    failures = []

    def client(i):
        cls = QOS_CLASSES[i]
        for k in range(QOS_ROUNDS):
            tenant = QOS_TENANTS[(i + k) % len(QOS_TENANTS)]
            t = time.perf_counter()
            try:
                engine.submit(*pairs[i], priority=cls, tenant=tenant)
                key = "completed"
            except QuotaExceeded:
                key = "quota"
            except Overloaded:
                key = "overloaded"
            except DeadlineExceeded:
                key = "expired"
            except Exception as e:  # noqa: BLE001 - any other outcome is a loss
                with lock:
                    failures.append((cls, repr(e)))
                continue
            with lock:
                tally[cls][key] += 1
                if key == "completed":
                    tally[cls]["latency"].append((time.perf_counter() - t) * 1e3)

    ev0, k1_0 = capture_events(), by_kernel(engine.graph_launches())["k1"]
    reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(QOS_CLASSES))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300.0)
    wall = time.perf_counter() - t0
    hung = any(t.is_alive() for t in threads)
    captures, eager = capture_events() - ev0, read_counts()
    k1_run = by_kernel(engine.graph_launches())["k1"] - k1_0
    stats = engine.stats()
    for name in ("_pool_insert_live", "_qos_levels", "_qos_preempted"):  # the recording wrappers
        vars(engine).pop(name, None)
    engine.stop()
    n = len(QOS_CLASSES) * QOS_ROUNDS
    answered = sum(v[k] for v in tally.values() for k in ("completed", "overloaded", "quota", "expired"))
    summary = {}
    for c in ("interactive", "standard", "batch"):
        lat = tally[c].pop("latency")
        summary[c] = dict(tally[c], p50_ms=float(np.percentile(lat, 50)) if lat else None,
                          p99_ms=float(np.percentile(lat, 99)) if lat else None)
    under = [d for d in decisions if d[0] > 0]
    inversions = []
    for lvl in sorted({d[0] for d in under}):
        inter = [u for l, r, u in under if l == lvl and r == 0]
        low = [u for l, r, u in under if l == lvl and r == 2]
        if inter and low and max(low) > min(inter):
            inversions.append((lvl, max(low), min(inter)))
    bad_preempt = [p for p in preemptions if p[0] <= p[1]]
    log(f"qos flood {kind}: boot {boot_s:.3f} s, graphs {counts}; {n} requests from {len(QOS_CLASSES)} threads in "
        f"{wall:.3f} s ({sum(v['completed'] for v in tally.values())} served, "
        f"{n / wall:.3f} submits/s); by class {json.dumps(summary)}; engine qos "
        f"{json.dumps(stats['qos'])}; preemptions {len(preemptions)} (victim, arrival ranks "
        f"{sorted(set(preemptions))}); admissions {len(decisions)}, {len(under)} at a level above 0 "
        f"(levels {sorted({d[0] for d in under})}; by class {[sum(1 for d in under if d[1] == r) for r in range(3)]}); "
        f"degradation {json.dumps(stats['degradation'])}; K1 {k1_run} in the run, eager {eager}; captures after "
        f"start() {captures}; card {card}")
    if hung or failures or answered != n:
        raise AssertionError(f"qos flood {kind}: {answered} of {n} answered, hung {hung}, failures {failures}")
    if bad_preempt or inversions:
        raise AssertionError(f"qos flood {kind}: preemptions of a class not below the arrival's {bad_preempt}; "
                             f"batch over interactive at a level {inversions}")
    if captures or engine.program_counts() != counts or eager["k1"] or not k1_run:
        raise AssertionError(f"qos flood {kind}: {captures} captures after start(), eager {eager}, K1 {k1_run}")
    if any(u not in ladder for _, _, u in decisions):
        raise AssertionError(f"qos flood {kind}: an update count off the ladder {ladder}")
    return k1_run


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


def train_phase(device, card, overrides=None, corr_impl="dense", window_size=1):
    """``Trainer`` at the chairs stage of raft_large, full width, at
    ``corr_impl`` with ``window_size`` steps a dispatch: 8 steps on a
    synthetic FlyingChairs tree, checkpoints every 4, a boundary every 2
    (each loss finite), preempted after step 4 and resumed by a second
    Trainer whose restored state equals the saved one bit for bit and whose
    pipeline continues the index stream at step 4; step times (CUDA events
    around each dispatch), pairs/s, peak memory, checkpoint save and
    restore seconds; 8 steps on one fixed batch must lower the loss, and
    one of them runs under torch.profiler (idle share). At ``dense`` no
    CUDA kernel of the port's runs (the launch counts stay 0); at
    ``fused`` K1 runs once an update of every step's forward (no remat)
    and no other kernel runs. ``overrides`` (TrainConfig fields) shrink the
    phase for a CPU rehearsal; without them it is the chairs stage itself.
    Returns the launch counts of the Trainer's 8 steps."""
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
                          log_every=TRAIN_LOG_EVERY, checkpoint_dir=str(tmp / "ckpt"), corr_impl=corr_impl,
                          window_size=window_size, **(overrides or {}))
        if overrides is None and (cfg.global_batch_size, cfg.crop_size, cfg.num_flow_updates) != (8, (368, 496), 12):
            raise AssertionError("TrainConfig's defaults are not the chairs stage")
        first = Trainer(cfg, ds)
        events = []

        def timed(trainer):
            """Time each of the trainer's dispatches (a step or a window)."""
            attr = "window_fn" if trainer.window_fn is not None else "step_fn"
            fn = getattr(trainer, attr)

            def timed_fn(state, batch):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(state, batch)
                end.record()
                events.append((start, end))
                return out

            setattr(trainer, attr, timed_fn)

        timed(first)
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
        timed(second)
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
        # a step's time: each dispatch's over its steps; each run's first
        # dispatch warms up
        ms = [s.elapsed_time(e) / window_size for s, e in events]
        half = TRAIN_CKPT_EVERY // window_size
        steady = ms[1:half] + ms[half + 1:]
        what = f"{corr_impl} fp32, no remat, window {window_size}"
        log(f"train: {cfg.arch} {cfg.stage} stage (b={cfg.global_batch_size}, {cfg.crop_size[0]}x{cfg.crop_size[1]}, "
            f"{cfg.num_flow_updates} updates, {what}), {TRAIN_STEPS} "
            f"steps in two runs: step ms (CUDA events, a dispatch's over its steps) {[round(t, 3) for t in ms]}, "
            f"median after warm-up "
            f"{float(np.median(steady)):.3f} ms = {cfg.global_batch_size * 1e3 / float(np.median(steady)):.3f} "
            f"pairs/s; wall "
            f"{wall1:.3f} + {wall2:.3f} s; peak device memory {peak} B ({peak / 2**30:.3f} GiB); "
            f"launches {launches}; card {card}")
        want_k1 = cfg.num_flow_updates * TRAIN_STEPS if corr_impl == "fused" else 0
        if launches != dict.fromkeys(launches, 0) | {"k1": want_k1}:
            raise AssertionError(f"the {corr_impl} training path launched {launches}, expected K1 {want_k1} times "
                                 "and no other kernel")

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
        model = build_raft(CONFIGS[cfg.arch].replace(corr_impl=corr_impl), device=device, seed=0)
        tx = make_optimizer(1e-4, weight_decay=1e-5)
        state = TrainState.create(model, tx)
        step = make_train_step_fn(model, tx, num_flow_updates=cfg.num_flow_updates)
        losses = []
        for i in range(TRAIN_STEPS - 1):
            state, m = step(state, batch)
            losses.append(m["loss"])
            if i == 0:  # the first step's cuDNN trials stay out of the warm steps' peak
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(device)
        warm_peak = torch.cuda.max_memory_allocated(device)
        prof = profile_request(lambda: step(state, batch), ())
        if prof is not None:
            by_name, busy_us = prof
            conv_us = sum(us for name, us in by_name.items() if "conv" in name.lower() or "gemm" in name.lower()
                          or "fprop" in name.lower() or "dgrad" in name.lower() or "wgrad" in name.lower())
            log(f"train profile: convolutions and GEMMs {conv_us / 1e3:.3f} ms = {conv_us / busy_us:.4f} of one "
                f"step's device busy time")
        state, m = step(state, batch)
        losses = [float(x) for x in losses + [m["loss"]]]
        log(f"train: {len(losses) + 1} steps on one fixed batch at {corr_impl}, lr 1e-4: loss "
            f"{[round(x, 5) for x in losses]}; peak device memory of the warm steps {warm_peak} B "
            f"({warm_peak / 2**30:.3f} GiB)")
        if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
            raise AssertionError("the loss did not fall on a fixed batch")
    log(f"train phase ({corr_impl}, window {window_size}): {time.perf_counter() - t_phase:.1f} s")
    return launches


# the fused step's first gradient against the dense step's, on the card,
# in relative L2 norm over all parameters, both under cuDNN's
# deterministic algorithms: the forwards differ by K1's 3xTF32 sums
# (within 1e-4 of the plain version an output), which the backward, the
# same dense formulation, carries into the gradient
TRAIN_GRAD_REL = 1e-3
TRAIN_GRAD_UPDATES = 2  # few updates: the recurrence amplifies rounding (ROADMAP's chaos trap)


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to its deterministic algorithms while the block is
    open (``cudnn.benchmark`` then times only those). With the fastest
    algorithms the card's backward is not bit-reproducible: some weight
    gradients sum by atomics."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def fused_training_checks(device, card, overrides=None):
    """At raft_large's chairs stage on one augmented batch, full width:
    (1) the first gradient of a fused step against a dense step's from the
    same weights at ``TRAIN_GRAD_UPDATES`` updates, in relative L2 over all
    parameters: under cuDNN's deterministic algorithms within
    ``TRAIN_GRAD_REL``, and, for scale, with the fastest ones, beside a
    second dense run (the run-to-run spread of the atomics); (2) under the
    deterministic algorithms, a window of 2 steps against two per-step
    calls from the same weights at 12 updates, fused, the state
    (parameters, buffers, Adam, counters) bit for bit, with a second
    per-step run as the control that the step repeats itself bit for bit.
    ``overrides`` (TrainConfig fields) shrink it for a CPU rehearsal."""
    import tempfile

    from raft_tpu_torch.data import FlyingChairs
    from raft_tpu_torch.data.augment import AugmentConfig, FlowAugmentor
    from raft_tpu_torch.data.pipeline import TrainPipeline
    from raft_tpu_torch.device import cudnn_benchmark, fp32_precision
    from raft_tpu_torch.models.zoo import CONFIGS, build_raft
    from raft_tpu_torch.train import (TrainConfig, TrainState, make_optimizer, make_train_step_fn, make_window_step,
                                      sequence_loss)

    t_phase = time.perf_counter()
    cfg = TrainConfig(arch="raft_large", stage="chairs", **(overrides or {}))
    with tempfile.TemporaryDirectory(prefix="raft_train_") as tmp:
        ds = FlyingChairs(str(write_chairs(Path(tmp) / "chairs")))
        aug = FlowAugmentor(AugmentConfig(crop_size=cfg.crop_size, min_scale=-0.1, max_scale=1.0))
        it = iter(TrainPipeline(ds, cfg.global_batch_size, augmentor=aug, seed=2, device=device))
        batches = [next(it) for _ in range(2)]
        it.close()

    def first_gradient(impl):
        model = build_raft(CONFIGS[cfg.arch].replace(corr_impl=impl), device=device, seed=0).train()
        with cudnn_benchmark(), fp32_precision():
            preds = model(batches[0]["image1"], batches[0]["image2"], num_flow_updates=TRAIN_GRAD_UPDATES)
            loss, _ = sequence_loss(preds, batches[0]["flow"], batches[0].get("valid"))
            return torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, list(model.parameters()))])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    fast = {run: first_gradient(impl) for run, impl in (("dense", "dense"), ("dense again", "dense"),
                                                         ("fused", "fused"))}
    with cudnn_deterministic():
        det = {impl: first_gradient(impl) for impl in ("dense", "fused")}
    grad_rel = rel(det["fused"], det["dense"])
    log(f"train check: first gradient at {TRAIN_GRAD_UPDATES} updates (b={cfg.global_batch_size}, "
        f"{cfg.crop_size[0]}x{cfg.crop_size[1]}), relative L2 over all parameters: fused vs dense {grad_rel:.3e} "
        f"under cuDNN's deterministic algorithms (bound {TRAIN_GRAD_REL:g}); with the fastest ones fused vs dense "
        f"{rel(fast['fused'], fast['dense']):.3e}, dense vs dense again {rel(fast['dense again'], fast['dense']):.3e}; "
        f"card {card}")
    if not grad_rel <= TRAIN_GRAD_REL:
        raise AssertionError("the fused step's gradient misses the dense step's")
    del fast, det

    def state_tensors(state):
        sd = state.state_dict()
        return ([sd["model"][k] for k in sorted(sd["model"])] + sd["opt_state"]["mu"] + sd["opt_state"]["nu"]
                + [sd["opt_state"]["count"]] + [sd[k] for k in ("step", "skipped_steps", "good_steps", "grad_ema")])

    kw = dict(num_flow_updates=cfg.num_flow_updates, numerics_policy="skip", spike_factor=20.0)
    runs = {}
    with cudnn_deterministic():
        for run in ("per_step", "control", "window"):
            model = build_raft(CONFIGS[cfg.arch].replace(corr_impl="fused"), device=device, seed=0)
            tx = make_optimizer(1e-4, weight_decay=1e-4, clip_norm=1.0)
            state = TrainState.create(model, tx)
            reset_counts()
            if run == "window":
                window = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
                state, metrics = make_window_step(model, tx, window_size=2, **kw)(state, window)
                losses = metrics["loss"].tolist()
            else:
                step = make_train_step_fn(model, tx, **kw)
                losses = []
                for b in batches:
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            runs[run] = ([t.detach().clone() for t in state_tensors(state)], losses, read_counts()["k1"])
            del model, state
    same = {run: all(torch.equal(a, b) for a, b in zip(runs[run][0], runs["per_step"][0]))
            for run in ("control", "window")}
    log(f"train check: under cuDNN's deterministic algorithms, a window of 2 fused steps ({cfg.num_flow_updates} "
        f"updates) against 2 per-step calls: state bit for bit {same['window']} (per-step control "
        f"{same['control']}); losses {runs['window'][1]} vs {runs['per_step'][1]}; K1 launches {runs['window'][2]} "
        f"vs {runs['per_step'][2]}")
    if not (same["control"] and same["window"] and runs["window"][2] == runs["per_step"][2] > 0):
        raise AssertionError("the window step is not the per-step loop bit for bit")
    log(f"train checks: {time.perf_counter() - t_phase:.1f} s")
    return grad_rel


# the remat policies at the train bench's shape (raft_large, b=6, 368x768,
# 12 updates, fused fp32): K1 twice a refinement step a training step (the
# forward, then the recompute) except under 'corr', which keeps its output
REMAT_STEPS = 3
REMAT_K1 = {None: 24, "dots": 24, "dots_no_batch": 24, "corr": 12}


def remat_phase(device, card):
    """Each remat policy through the train bench (``bench_train``, its
    warm-up step then ``REMAT_STEPS`` timed steps): pairs/s, step ms, peak
    memory and K1's launches a step."""
    from raft_tpu_torch import bench

    rows = {}
    for policy, want in REMAT_K1.items():
        r = bench.bench_train("raft_large", steps=REMAT_STEPS, corr="fused", remat_policy=policy, device=device)
        rows[policy or "none"] = r
        log(f"remat: raft_large fused fp32 b={bench.TRAIN_BATCH} {bench.TRAIN_CROP[0]}x{bench.TRAIN_CROP[1]}, "
            f"remat_policy={policy}: {r['pairs_per_s']:.3f} pairs/s = {bench.TRAIN_BATCH * 1e3 / r['pairs_per_s']:.1f} "
            f"ms a step, peak {r['peak_memory_bytes']} B ({r['peak_memory_bytes'] / 2**30:.3f} GiB), K1 "
            f"{r['k1_launches_per_step']:g} launches a step; card {card}")
        if r["k1_launches_per_step"] != want:
            raise AssertionError(f"remat_policy={policy}: K1 ran {r['k1_launches_per_step']} times a step, not {want}")
    return rows


def bench_phase():
    """``python -m raft_tpu_torch.bench`` at 2 pairs a configuration, in
    this process (its kernels are built): the lines and their schema. The
    full protocol is 128 pairs, the command logged here."""
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
    # training through K1: fused fp32, then fused with bf16 pyramid and convs
    # (K1's bf16 product), 24 launches a step (12 updates, remat)
    k1_train = {}
    for args, label in ((["--corr", "fused"], "corr_impl=fused, corr_dtype=fp32, compute_dtype=fp32"),
                        (["--corr", "fused", "--corr-dtype", "bfloat16", "--dtype", "bfloat16"],
                         "corr_impl=fused, corr_dtype=bf16, compute_dtype=bf16")):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench.main(["--train", "--steps", "2", *args])
        lines = [json.loads(s) for s in out.getvalue().strip().splitlines()]
        for line in lines:
            log(f"bench --train {' '.join(args)}: {json.dumps(line)}")
        metrics = lines[1:]
        launches = lines[0].get("k1_launches_per_step", {})
        ok = rc == 0 and [m["metric"] for m in metrics] == ["raft_small_train_pairs_s", "raft_large_train_pairs_s"] \
            and all({"metric", "value", "unit", "protocol", "config"} <= set(m) and m["value"] > 0
                    and m["unit"] == "pairs/s" and m["config"].startswith(label) and "tf32=off" in m["config"]
                    and launches.get(m["metric"]) == 24 for m in metrics) and lines[0].get("card")
        log(f"bench --train {' '.join(args)}: schema and K1 launches {'ok' if ok else 'WRONG'}, "
            f"{time.perf_counter() - t0:.1f} s at --steps 2")
        if not ok:
            raise AssertionError("the bench's fused training lines do not follow its protocol")
        k1_train[label] = {"pairs_per_s": {m["metric"]: m["value"] for m in metrics},
                           "peak_memory_bytes": lines[0]["peak_memory_bytes"], "k1_launches_per_step": launches}
    return k1_train


# the observability phase: tracing at apply_timeout_s 5 s, a device stall
# of ~2 s against apply_timeout_s 0.5 s, the trainer's data-fetch stall
# at watchdog_timeout 2 s
OBS_TRACE_TIMEOUT_S, OBS_STALL_TIMEOUT_S, OBS_STALL_MS, OBS_TRAIN_TIMEOUT_S = 5.0, 0.5, 2000.0, 2.0
OBS_STALL_ITERS = 12  # the stall engines' requests: a batch of 8 at 12 updates stays well under 0.5 s


def sleep_cycles(ms: float) -> int:
    """``torch.cuda._sleep`` cycles for about ``ms`` of the card's time,
    calibrated here against CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(100_000_000)
    end.record()
    end.synchronize()
    return int(100_000_000 / start.elapsed_time(end) * ms)


QOS_SERIES = 'serve_qos_class{class="interactive",key="submitted"}'


def prometheus_ok(text: str, *series: str) -> bool:
    """Every line of a Prometheus exposition a comment or ``name value``
    with a numeric value, and each of ``series`` present."""
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        float(value)
        if not name or " " in name:
            return False
    return all(s in text for s in series)


def traced_runs(engine, what, card, pairs, targets):
    """``SERVE_REQUESTS`` requests from ``SERVE_THREADS`` threads at
    trace_sample_rate 1.0, 0, 0, 1.0 (ABBA), on one engine in
    this process (the tracer's rate is the only difference). At 1.0 every
    result carries a trace_id, ``tracer.finished`` counts every request,
    each span lies inside its trace, and the trace's end agrees with the
    result's: ``dur_ms`` less the admission (the queue_wait span's start,
    where the result's clock starts) is within 1 ms of ``latency_ms``; at
    0 nothing is traced. The collector is off over the runs: a full
    collection's pause between a result's stamp and its trace's end is
    the runtime's, not the tracer's. Returns {rate: [(requests/s, p50,
    p99), ...]}."""
    import gc

    gc.disable()
    try:
        return _traced_runs(engine, what, card, pairs, targets)
    finally:
        gc.enable()


def _traced_runs(engine, what, card, pairs, targets):
    out, worst = {}, 0.0
    for rate in (1.0, 0.0, 0.0, 1.0):  # ABBA: a drift over the four runs cancels
        engine.tracer.sample_rate = rate
        started0, finished0 = engine.tracer.started, engine.tracer.finished
        batches0 = engine.stats()["batches"]
        t0 = time.perf_counter()
        results = serve_requests(engine, pairs, targets, SERVE_THREADS)
        wall = time.perf_counter() - t0
        lat = [r.latency_ms for r in results]
        out.setdefault(rate, []).append((len(results) / wall, float(np.percentile(lat, 50)),
                                         float(np.percentile(lat, 99)), engine.stats()["batches"] - batches0))
        if not rate:
            if any(r.trace_id for r in results) or engine.tracer.started != started0:
                raise AssertionError(f"{what}: requests traced at trace_sample_rate 0")
            continue
        if engine.tracer.finished - finished0 != len(results) or not all(r.trace_id for r in results):
            raise AssertionError(f"{what}: {engine.tracer.finished - finished0} traces finished for "
                                 f"{len(results)} requests")
        for r in results:
            rec = engine.tracer.find(r.trace_id)
            if rec is None or not rec["ok"]:
                raise AssertionError(f"{what}: no finished trace for {r.trace_id}")
            spans = {sp["name"]: sp for sp in rec["spans"]}
            if any(sp["t0_ms"] < 0 or sp["t0_ms"] + sp["dur_ms"] > rec["dur_ms"] for sp in rec["spans"]):
                raise AssertionError(f"{what}: a span outside its trace: {rec}")
            gap = rec["dur_ms"] - spans["queue_wait"]["t0_ms"] - r.latency_ms
            worst = max(worst, abs(gap))
    log(f"{what}: traced requests: every span inside its trace; |dur_ms - admission - latency_ms| at most "
        f"{worst:.4f} ms; card {card}")
    if worst >= 1.0:
        raise AssertionError(f"{what}: a trace's end is {worst:.3f} ms off its result's latency")
    return out


def stall_check(engine, what, card, stage, pairs, est):
    """One device stall of ~``OBS_STALL_MS`` (``torch.cuda._sleep`` on the
    engine's stream ahead of one ``stage`` replay, through
    ``FaultInjector.patch_engine``) under ``apply_timeout_s`` 0.5 s: the
    8 requests of that dispatch fail with DeadlineExceeded within the
    timeout plus one poll of their dispatch, one trip is counted, the
    ``watchdog_trips`` page alert fires, every bundle validates (a
    ``pool_reset`` event in the pool), the next 8 requests are served
    within 1e-3 / 5e-2 px of the graphed FlowEstimator, no capture after
    ``start()``. Returns the K1 launches and the numbers."""
    from raft_tpu_torch.graphs import capture_events
    from raft_tpu_torch.obs import validate_bundle
    from raft_tpu_torch.serve import DeadlineExceeded
    from raft_tpu_torch.utils.faults import FaultInjector

    cycles = sleep_cycles(OBS_STALL_MS)
    inj, armed, t_stall = FaultInjector(), [False], []

    def stall(ctx):
        t_stall.append(time.monotonic())
        torch.cuda._sleep(cycles)

    inj.on("infer.slow_apply", when=lambda i, ctx: armed[0] and ctx["stage"] == stage and not inj.fired[
        "infer.slow_apply"], action=stall)
    burst = pairs[:SERVE_THREADS]
    ev0, k1_0 = capture_events(), by_kernel(engine.graph_launches())["k1"]
    with inj.patch_engine(engine):
        before = serve_requests(engine, burst, [OBS_STALL_ITERS] * len(burst), SERVE_THREADS)
        time.sleep(1.5)  # the alert engine observes the healthy engine first
        armed[0] = True
        # one submit_many: the 8 requests reach the queue together, so they
        # are one admission (one batch) and the stalled dispatch is theirs
        done_t = {}
        t0 = time.monotonic()
        handles = engine.submit_many([dict(image1=a, image2=b, num_flow_updates=OBS_STALL_ITERS,
                                           on_done=lambda h: done_t.setdefault(id(h), time.monotonic()))
                                      for a, b in burst])
        for h in handles:
            h.wait(60.0)
        failed = [(done_t.get(id(h), math.inf), str(h.error) if isinstance(h.error, DeadlineExceeded) else None)
                  for h in handles]
        after = serve_requests(engine, burst, [OBS_STALL_ITERS] * len(burst), SERVE_THREADS)
        deadline = time.monotonic() + 10.0
        while not engine.recorder.events("alert_fire") and time.monotonic() < deadline:
            time.sleep(0.1)
    captures = capture_events() - ev0
    k1 = by_kernel(engine.graph_launches())["k1"] - k1_0
    poll = engine._watchdog.poll
    health, stats = engine.health(), engine.stats()
    bundles = engine.recorder.bundles()
    problems = [p for b in bundles for p in validate_bundle(b)]
    fires = [e["rule"] for e in engine.recorder.events("alert_fire")]
    resets = engine.recorder.events("pool_reset")
    # from the stalled replay's dispatch (the host's wait on it starts a
    # tick or two later) and from the submit (admission included)
    to_error = [t - t_stall[0] for t, _ in failed]
    from_submit = [t - t0 for t, _ in failed]
    log(f"{what}: a {OBS_STALL_MS:g} ms device stall (torch.cuda._sleep, {cycles} cycles) ahead of one {stage} "
        f"replay at apply_timeout_s {OBS_STALL_TIMEOUT_S} (watchdog poll {poll:g} s): its {len(failed)} requests "
        f"failed DeadlineExceeded {sum(err is not None for _, err in failed)}x, "
        f"{min(to_error):.4f}-{max(to_error):.4f} s after the stalled dispatch "
        f"({min(from_submit):.4f}-{max(from_submit):.4f} s after their submit); watchdog_trips "
        f"{health['watchdog_trips']}; alerts fired "
        f"{fires}; bundles {[b['reason'] for b in bundles]} ({len(problems)} schema problems); pool_reset events "
        f"{len(resets)}, pool_resets {stats['pool_resets']}; card {card}")
    wants = [est(*p, num_flow_updates=OBS_STALL_ITERS) for p in burst]
    mean_d, max_d = flow_gap([r.flow for r in after], wants)
    mean_b, max_b = flow_gap([r.flow for r in after], [r.flow for r in before])
    tol_mean, tol_max = SERVE_TOL["quality"]
    log(f"{what}: the next {len(after)} requests: |dflow| vs the graphed FlowEstimator mean {mean_d:.3e} px, max "
        f"{max_d:.3e} px, vs the same requests served before the stall mean {mean_b:.3e} px, max {max_b:.3e} px "
        f"(tol {tol_mean:g} / {tol_max:g}); captures after start() {captures}")
    if any(err is None or "device execution exceeded" not in err for _, err in failed):
        raise AssertionError(f"{what}: the stalled dispatch's requests did not fail typed: {failed}")
    if max(to_error) > OBS_STALL_TIMEOUT_S + poll + 0.05:
        raise AssertionError(f"{what}: a stalled request failed {max(to_error):.3f} s after the stalled dispatch")
    if health["watchdog_trips"] != 1 or "watchdog_trips" not in fires or problems or not any(
            b["reason"] == "watchdog_trip:serve/apply" for b in bundles):
        raise AssertionError(f"{what}: trips {health['watchdog_trips']}, alerts {fires}, bundle problems {problems}")
    if stage == "pool_step" and not resets:
        raise AssertionError(f"{what}: no pool_reset event after the trip")
    if captures or not (max(mean_d, mean_b) <= tol_mean and max(max_d, max_b) <= tol_max):
        raise AssertionError(f"{what}: {captures} captures after start(), or the next requests' flows disagree")
    return k1, {"to_error_s": max(to_error), "from_submit_s": max(from_submit), "poll_s": poll}


def free_card() -> None:
    """Return the cached blocks, so the next model has the card. No
    collection: a stopped engine sits in no reference cycle, so its graph
    pools are freed when its last reference goes."""
    torch.cuda.empty_cache()


def observability_phase(device, card, weights):
    """The observability spine and the watchdogs on the card: raft_large
    at 'quality' (fused, K1 in every pool tick), bucket 440x1024, warmed,
    the serving phase's weights.

    Tracing (pool, then ``pool_capacity=0``), at apply_timeout_s 5 s: the
    serving phase's 24 requests from 8 threads at trace_sample_rate 1.0
    and 0, alternating (:func:`traced_runs`), ``prometheus()`` parsed line
    by line with the QoS series, no trip, no capture after ``start()``;
    in the pool one profiled burst with ``obs.profile`` on must show one
    ``serve/pool_step`` range a tick. A device stall in each engine at
    apply_timeout_s 0.5 s (:func:`stall_check`). The Trainer at the
    chairs stage: a stall injected into its data fetch (``patch_batches``)
    raises StallError at ``data/next`` with a stack dump and a bundle; two
    fused windows of 2 steps between boundaries under an armed
    HostSyncTripwire (0 hits), with ``torch.cuda.set_sync_debug_mode
    ('warn')`` over the same region (its warnings counted). Returns the
    K1 launches by part and the numbers."""
    import tempfile
    import warnings

    import raft_tpu_torch as rt
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.data import FlyingChairs
    from raft_tpu_torch.graphs import capture_events
    from raft_tpu_torch.obs import profile as obs_profile
    from raft_tpu_torch.obs import validate_bundle
    from raft_tpu_torch.serve import ServeConfig, ServeEngine
    from raft_tpu_torch.train import TrainConfig, Trainer
    from raft_tpu_torch.utils.faults import FaultInjector, StallError
    from raft_tpu_torch.utils.tripwire import HostSyncTripwire

    t_phase = time.perf_counter()
    free_card()
    log(f"observability: {torch.cuda.memory_allocated(device)} B allocated on the card at the phase's start")
    model = rt.raft_for_serving(ServeConfig.preset("quality"), corr_impl="fused", device=device)
    model.load_state_dict(weights)
    pairs = [request_pair(100 + i)[:2] for i in range(SERVE_REQUESTS)]
    targets = [SERVE_LADDER[i % len(SERVE_LADDER)] for i in range(SERVE_REQUESTS)]
    modes = {"pool": dict(pool_capacity=SERVE_CAPACITY),
             "whole-request": dict(pool_capacity=0, max_batch=WR_MAX_BATCH, pipeline_depth=WR_DEPTH)}
    k1, out = {}, {}
    for mode, kw in modes.items():
        what = f"observability {mode}"
        cfg = ServeConfig(buckets=(SERVE_BUCKET,), ladder=SERVE_LADDER, warmup=True, default_deadline_ms=120_000.0,
                          stream_cache_size=0, trace_sample_rate=1.0, apply_timeout_s=OBS_TRACE_TIMEOUT_S, **kw)
        engine = ServeEngine(model, cfg, device=device).start()
        ev0, k1_0 = capture_events(), by_kernel(engine.graph_launches())["k1"]
        reset_counts()
        runs = traced_runs(engine, what, card, pairs, targets)
        prom = engine.prometheus()
        ticks = None
        if mode == "pool":
            obs_profile.enable()
            try:
                ticks0 = engine.stats()["pool_ticks"]
                with profile(activities=[ProfilerActivity.CPU],
                             experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
                    serve_requests(engine, pairs[:SERVE_THREADS], [20] * SERVE_THREADS, SERVE_THREADS)
                ticks = engine.stats()["pool_ticks"] - ticks0
            finally:
                obs_profile.disable()
            ranges = [e.name for e in prof.events()].count("serve/pool_step")
            log(f"{what}: a profiled burst of {SERVE_THREADS} requests at 20 updates with obs.profile on: "
                f"{ranges} serve/pool_step ranges, {ticks} ticks")
            if ranges != ticks:
                raise AssertionError(f"{what}: {ranges} serve/pool_step ranges for {ticks} ticks")
        captures, eager = capture_events() - ev0, read_counts()
        k1[f"{mode} traced"] = by_kernel(engine.graph_launches())["k1"] - k1_0
        health, stats = engine.health(), engine.stats()
        on, off = runs[1.0], runs[0.0]
        log(f"{what}: {SERVE_REQUESTS} requests from {SERVE_THREADS} threads, alternating: trace_sample_rate 1.0 "
            f"{[round(x[0], 3) for x in on]} requests/s, p50 {[round(x[1], 3) for x in on]} ms, p99 "
            f"{[round(x[2], 3) for x in on]} ms; trace_sample_rate 0 {[round(x[0], 3) for x in off]} requests/s, p50 "
            f"{[round(x[1], 3) for x in off]} ms, p99 {[round(x[2], 3) for x in off]} ms; batches (the pool: ticks "
            f"and retirements) on {[x[3] for x in on]}, off {[x[3] for x in off]}; traces "
            f"{stats['obs']}; watchdog_trips {health['watchdog_trips']}; captures after start() {captures}; "
            f"eager launches {eager}; K1 {k1[f'{mode} traced']} (graph replays); prometheus {len(prom.splitlines())} "
            f"lines; card {card}")
        if health["watchdog_trips"] or captures or eager["k1"] or not prometheus_ok(prom, QOS_SERIES):
            raise AssertionError(f"{what}: trips {health['watchdog_trips']}, captures {captures}, eager {eager}, "
                                 f"or the Prometheus text did not parse")
        out[mode] = {"on": on, "off": off, "ticks": ticks}
        engine.stop()
        del engine
        free_card()

    est = rt.FlowEstimator(model, num_flow_updates=SERVE_LADDER[0], pad_mode="downstream", device=device)
    for mode, kw in modes.items():
        cfg = ServeConfig(buckets=(SERVE_BUCKET,), ladder=SERVE_LADDER, warmup=True, default_deadline_ms=120_000.0,
                          stream_cache_size=0, apply_timeout_s=OBS_STALL_TIMEOUT_S, **kw)
        engine = ServeEngine(model, cfg, device=device).start()
        k1[f"{mode} stall"], out[f"{mode} stall"] = stall_check(
            engine, f"observability {mode} stall", card, "pool_step" if mode == "pool" else "pair", pairs, est)
        engine.stop()
        del engine
        free_card()
    del est, model
    free_card()
    log(f"observability: {torch.cuda.memory_allocated(device)} B allocated after the serving engines are gone")

    with tempfile.TemporaryDirectory(prefix="raft_obs_") as tmp:
        tmp = Path(tmp)
        ds = FlyingChairs(str(write_chairs(tmp / "chairs")))
        cfg = TrainConfig(arch="raft_large", stage="chairs", num_steps=TRAIN_STEPS, log_every=TRAIN_LOG_EVERY,
                          log_dir=str(tmp / "logs"), watchdog_timeout=OBS_TRAIN_TIMEOUT_S)
        trainer = Trainer(cfg, ds)
        inj = FaultInjector().on("data.next", when=1, action=30.0)
        t0 = time.monotonic()
        try:
            with inj.patch_batches(trainer):
                trainer.run(log_fn=lambda *_: None)
            raise AssertionError("observability train: the stalled data fetch did not raise")
        except StallError as e:
            stall_s, err = time.monotonic() - t0, str(e)
        dump = tmp / "logs" / "stall_stacks.log"
        size = dump.stat().st_size if dump.exists() else 0
        bundle = trainer.recorder.last_bundle
        log(f"observability train: a 30 s stall in the second data fetch at watchdog_timeout "
            f"{OBS_TRAIN_TIMEOUT_S:g} s: StallError after {stall_s:.3f} s of the run ({err!r}); stall_stacks.log "
            f"{size} B; bundle {bundle and bundle['reason']!r} ({len(validate_bundle(bundle)) if bundle else '-'} "
            f"schema problems); card {card}")
        if "'data/next'" not in err or not size or bundle is None or bundle["reason"] != "watchdog_trip:data/next" \
                or validate_bundle(bundle):
            raise AssertionError("observability train: the data-fetch stall was not caught as specified")
        del trainer
        free_card()

        cfg = TrainConfig(arch="raft_large", stage="chairs", num_steps=6, log_every=6, corr_impl="fused",
                          window_size=2)
        trainer = Trainer(cfg, ds)
        tw = HostSyncTripwire(armed=False)
        window_fn, host_window = trainer.window_fn, trainer._host_window
        armed_windows = []

        def arming(state, batch):
            armed_windows.append(tw.armed)  # was this window dispatched armed?
            out_ = window_fn(state, batch)
            if len(armed_windows) == 1:
                torch.cuda.set_sync_debug_mode("warn")
                tw.arm()  # from the first window's return ...
            return out_

        def disarming(window):
            tw.disarm()  # ... to the boundary's one fetch
            torch.cuda.set_sync_debug_mode(0)
            return host_window(window)

        trainer.window_fn, trainer._host_window = arming, disarming
        reset_counts()
        with warnings.catch_warnings(record=True) as caught, tw:
            warnings.simplefilter("always")
            try:
                trainer.run(log_fn=lambda *_: None)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        k1["train fused windows"] = read_counts()["k1"]
        syncs = [str(w.message) for w in caught if "called a synchronizing" in str(w.message)]
        log(f"observability train: fused, windows of 2, 3 windows, the last two between boundaries under an armed "
            f"HostSyncTripwire: {tw.total} hits {tw.snapshot()}; torch.cuda.set_sync_debug_mode('warn') over the "
            f"same region: {len(syncs)} warnings {sorted(set(syncs))[:3]}; window staging took "
            f"{trainer.pipeline._staging.fresh} fresh buffers while the card still read a slot's; K1 "
            f"{k1['train fused windows']} eager launches; card {card}")
        if tw.total or armed_windows.count(True) != 2:
            raise AssertionError(f"observability train: {tw.total} host syncs between boundaries ({tw.snapshot()}), "
                                 f"armed windows {armed_windows}")
        out["train"] = {"stall_s": stall_s, "tripwire": tw.total, "sync_warnings": len(syncs),
                        "fresh_staging_buffers": trainer.pipeline._staging.fresh}
        del trainer
    free_card()  # before the training phases measure memory
    log(f"observability phase: {time.perf_counter() - t_phase:.1f} s")
    return k1, out


ROUTER_QUEUE = 16  # a closed-loop flood of ROUTER_FLOOD clients fills one replica's queue
ROUTER_FLOOD = 24
ROUTER_BEAT_S, ROUTER_COOLDOWN_S = 0.05, 1.0
ROUTER_MEM_TOL_GIB = 1.0


def reserved_gib(device) -> float:
    """The card's reserved memory after the cached blocks are returned."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device) / 2**30


def settle(cond, timeout_s: float, what: str) -> float:
    """Poll ``cond`` every 20 ms; the seconds it took, or raise."""
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"router: {what} did not happen within {timeout_s:g} s")
        time.sleep(0.02)
    return time.monotonic() - t0


class ClosedLoop:
    """``threads`` clients submitting pairs through ``router`` back to back
    (a shed backs off for its ``retry_after_ms``) until :meth:`stop`; every
    outcome is counted by kind ('flow', a typed error's class name, or
    'untyped'), so an accepted request that ends with neither a flow nor a
    typed error shows, and a hung one keeps its thread alive past the
    join. As a context manager it stops the clients on the way out."""

    def __init__(self, router, pairs, threads: int):
        import collections
        import threading

        self.outcomes, self._lock, self._stop = collections.Counter(), threading.Lock(), threading.Event()
        self._threads = [threading.Thread(target=self._client, args=(router, pairs, i, threads), daemon=True)
                         for i in range(threads)]
        for t in self._threads:
            t.start()

    def _client(self, router, pairs, i, step):
        from raft_tpu_torch.serve import Overloaded, ServeError

        while not self._stop.is_set():
            try:
                r = router.submit(*pairs[i % len(pairs)])
                kind = "flow" if r.flow is not None and np.isfinite(r.flow).all() else "bad flow"
            except Overloaded as e:
                kind = type(e).__name__
                time.sleep(min(e.retry_after_ms, 100.0) / 1e3)
            except ServeError as e:
                kind = type(e).__name__
            except Exception:  # noqa: BLE001 -- counted: a loss
                kind = "untyped"
            with self._lock:
                self.outcomes[kind] += 1
            i += step

    def stop(self, timeout_s: float = 120.0):
        self._stop.set()
        for t in self._threads:
            t.join(timeout_s)
        hung = sum(t.is_alive() for t in self._threads)
        if hung or self.outcomes["untyped"] or self.outcomes["bad flow"]:
            raise AssertionError(f"router: {hung} clients hung, outcomes {dict(self.outcomes)}")
        return dict(self.outcomes)

    def __enter__(self) -> "ClosedLoop":
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(120.0)


def router_single_engine(model, cfg, device, card, pairs, targets, base, what="router"):
    """One engine at ``cfg``: the requests' flows (the router's reference),
    its requests/s and K1 replays; then stop and drop it: the reserved
    memory must come back to ``base`` (F7). ``what`` prefixes its log."""
    import weakref

    from raft_tpu_torch.serve import ServeEngine

    engine = ServeEngine(model, cfg, device=device).start()
    booted = reserved_gib(device)
    t0 = time.perf_counter()
    want = serve_requests(engine, pairs, targets, SERVE_THREADS)
    rps = SERVE_REQUESTS / (time.perf_counter() - t0)
    k1 = by_kernel(engine.graph_launches())["k1"]
    engine.stop()
    ref = weakref.ref(engine)
    del engine
    after = reserved_gib(device)
    log(f"{what}: one engine: {SERVE_REQUESTS} requests from {SERVE_THREADS} threads at {rps:.3f} requests/s; "
        f"reserved {base:.3f} GiB before it, {booted:.3f} with it booted, {after:.3f} after its stop() and del (no "
        f"collection; gone: {ref() is None}); K1 {k1}; card {card}")
    if ref() is not None or after > base + ROUTER_MEM_TOL_GIB:
        raise AssertionError(f"{what}: a stopped, dropped engine still holds the card (F7)")
    return want, rps, k1, booted - base


def router_phase(device, card, weights):
    """The in-process serving tier on the card, with the collector off (a
    stopped engine's memory must come back by F7's repair, not by a
    collection): raft_large at 'throughput' (fused, bf16 levels, K1's
    bf16 product), bucket 440x1024, warmed, the serving phase's weights,
    a one-rung ladder (32 updates: no degradation, so the autoscaler's
    calm reads the queues and sheds, and an idle replica reads calm; a
    degraded replica recovers only through admissions, which the router's
    score steers away from it).

    One engine serves the serving phase's 24 requests from 8 threads (the
    reference flows and its requests/s), is stopped and dropped, and the
    card's reserved memory comes back. Then ``ServeRouter`` over two
    thread replicas (one nn.Module, each engine with its own graph set):
    the same 24 requests (each flow within the serving phase's
    'throughput' bounds of the single engine's, both replicas served, no
    capture); a closed-loop burst during which ``replica_dead`` (through
    ``FaultInjector.patch_router``) declares r1 dead while it holds work:
    one eviction, a valid postmortem bundle, its work re-routed, every
    request a flow, readmission through a fresh engine (its boot and
    captures printed), and after the evicted engine's stop and drop the
    reserved memory within ``ROUTER_MEM_TOL_GIB`` of the two-replica
    level; a draining restart of a stream's home under load (no request
    dropped, the stream keeps its home or re-primes, the old engine's
    memory comes back); an ``Autoscaler`` (1..2 replicas): idle 2 -> 1, a
    flood of 24 clients 1 -> 2, a trickle 2 -> 1 (nothing lost), memory
    after the scale-down within the tolerance of the one-replica level,
    ``explain()`` printed; ``prometheus()`` parsed line by line. Captures
    after ``start()`` only in the rebuilt engines' boots; every engine
    gone after ``close()``. Returns K1's launches (graph replays) and the
    numbers."""
    import dataclasses
    import gc
    import weakref

    import raft_tpu_torch as rt
    from raft_tpu_torch.graphs import capture_events, replayed_launches
    from raft_tpu_torch.obs import validate_bundle
    from raft_tpu_torch.serve import AutoscaleConfig, Autoscaler, RouterConfig, ServeConfig, ServeEngine, ServeRouter
    from raft_tpu_torch.utils.faults import FaultInjector

    t_phase = time.perf_counter()
    gc.disable()
    try:
        base = reserved_gib(device)
        model = rt.raft_for_serving(ServeConfig.preset("throughput"), corr_impl="fused", device=device)
        model.load_state_dict(weights)
        cfg = ServeConfig(buckets=(SERVE_BUCKET,), pool_capacity=SERVE_CAPACITY, ladder=SERVE_LADDER[:1],
                          warmup=True, default_deadline_ms=120_000.0, ledger_sample_every=0,
                          queue_capacity=ROUTER_QUEUE)
        pairs = [request_pair(100 + i)[:2] for i in range(SERVE_REQUESTS)]
        targets = [SERVE_LADDER[i % len(SERVE_LADDER)] for i in range(SERVE_REQUESTS)]
        reset_counts()
        k1_graphs0 = by_kernel(replayed_launches())["k1"]
        want, single_rps, k1_single, footprint = router_single_engine(model, cfg, device, card, pairs, targets,
                                                                      base)
        built = []  # weakrefs to every engine the router's factory builds
        # (a weakref to the engine the next rebuild replaces, reserved GiB with it)
        replaced: list = []
        at_rebuild = []  # (reserved GiB, s for the memory to come back) as each rebuild begins

        def factory(**overrides):
            if replaced:
                # F7: its replica has let go of it, the callers still in its
                # frames finish, and its memory comes back, no collection
                gone, level = replaced.pop()
                t0 = time.monotonic()
                settle(lambda: gone() is None, 10.0, "the release of the replaced engine")
                settle(lambda: reserved_gib(device) <= level - footprint + ROUTER_MEM_TOL_GIB, 10.0,
                       "the return of the replaced engine's memory")
                at_rebuild.append((reserved_gib(device), time.monotonic() - t0))
            eng = ServeEngine(model, dataclasses.replace(cfg, **overrides), device=device)
            built.append(weakref.ref(eng))
            return eng

        def alive():
            return sum(r() is not None for r in built)

        router = ServeRouter.from_factory(factory, 2, RouterConfig(
            heartbeat_interval_s=ROUTER_BEAT_S, cooldown_s=ROUTER_COOLDOWN_S, drain_timeout_s=60.0))
        try:
            t0 = time.perf_counter()
            router.start()
            boot_s = time.perf_counter() - t0
            two_level = reserved_gib(device)
            two_alloc = torch.cuda.memory_allocated(device) / 2**30
            ev0, eager0 = capture_events(), read_counts()["k1"]
            # the programs one boot captures (the two first boots overlap, so
            # their capture counters count each other's)
            boot_captures = sum(max(n, 0) for n in router._by_id["r0"].engine.program_counts().values())

            # 1. routed traffic
            t0 = time.perf_counter()
            routed = serve_requests(router, pairs, targets, SERVE_THREADS)
            router_rps = SERVE_REQUESTS / (time.perf_counter() - t0)
            st = router.stats()
            served = {rid: e["completed"] for rid, e in st["engines"].items()}
            captures1, eager1 = capture_events() - ev0, read_counts()["k1"] - eager0
            mean_d, max_d = flow_gap([r.flow for r in routed], [w.flow for w in want])
            tol_mean, tol_max = SERVE_TOL["throughput"]
            log(f"router: 2 thread replicas booted in {boot_s:.3f} s (reserved {two_level:.3f} GiB); "
                f"{SERVE_REQUESTS} requests from {SERVE_THREADS} threads at {router_rps:.3f} requests/s (one engine "
                f"{single_rps:.3f}), served {served}; |dflow| vs the single engine mean {mean_d:.3e} px (tol "
                f"{tol_mean:g}), max {max_d:.3e} (tol {tol_max:g}); captures after start() {captures1}, eager K1 "
                f"launches {eager1}; card {card}")
            off = [(r.rid, r.num_flow_updates) for r, n in zip(routed, targets) if r.num_flow_updates != n]
            if off or captures1 or eager1 or len(served) != 2 or min(served.values()) == 0 or not (
                    mean_d <= tol_mean and max_d <= tol_max):
                raise AssertionError(f"router: routed traffic off target {off}, {captures1} captures, {eager1} eager "
                                     f"K1 launches, served {served}, or flows off the single engine's")

            # 2. a replica dies under a burst; the phase holds the evicted
            # engine weakly: the replica drops it when it rebuilds
            rep1, fired = router._by_id["r1"], []
            ref = weakref.ref(rep1.engine)
            replaced.append((ref, two_level))
            inj = FaultInjector()  # once, on a probe that finds r1 holding work
            inj.on("router.heartbeat", when=lambda i, c: (c["replica"] == "r1" and rep1.inflight >= 2 and not fired
                                                          and not fired.append(i)),
                   action=FaultInjector.replica_dead)
            with inj.patch_router(router), ClosedLoop(router, pairs, SERVE_THREADS) as loop:
                evict_s = settle(lambda: router.stats()["router"]["evictions"] >= 1, 60.0, "the eviction of r1")
                loop_out = loop.stop()
                held = reserved_gib(device)  # in the cooldown: the evicted engine stopped, not yet replaced
                readmit_s = settle(lambda: router.stats()["router"]["readmissions"] >= 1, 120.0,
                                   "the readmission of r1")
            del rep1, inj
            st = router.stats()
            new_boot = router._by_id["r1"].engine.stats()["boot"]
            bundles = [b for b in router.recorder.bundles() if b["reason"] == "evict:r1"]
            after_evict = reserved_gib(device)
            alloc_evict = torch.cuda.memory_allocated(device) / 2**30
            log(f"router: replica_dead on r1 after {evict_s:.3f} s of a closed-loop burst from {SERVE_THREADS} "
                f"threads: outcomes {loop_out}, rerouted {st['router']['rerouted']}, evictions "
                f"{st['router']['evictions']}, bundles {len(bundles)} ({[validate_bundle(b) for b in bundles]}); "
                f"readmitted {readmit_s:.3f} s later through a fresh engine: boot to ready "
                f"{new_boot['boot_to_ready_ms']:.1f} ms, {new_boot['captures']} captures; reserved {held:.3f} GiB in the "
                f"cooldown (the evicted engine stopped, still held by its replica), {at_rebuild[0][0]:.3f} as the "
                f"rebuild began (the evicted engine dropped, no collection: {held - at_rebuild[0][0]:.3f} GiB back "
                f"of an engine's {footprint:.3f}, {at_rebuild[0][1]:.3f} s after the rebuild was called), "
                f"{after_evict:.3f} after it (two-replica level {two_level:.3f}; "
                f"allocated {alloc_evict:.3f}, at the two-replica level {two_alloc:.3f}; gone: {ref() is None}); "
                f"card {card}")
            if set(loop_out) != {"flow"} or st["router"]["evictions"] != 1 or st["router"]["rerouted"] < 1 \
                    or len(bundles) != 1 or validate_bundle(bundles[0]) or st["replicas"]["r1"]["generation"] != 2:
                raise AssertionError("router: the replica death was not handled as specified")
            # F7 (held by the factory's waits): the evicted engine's memory
            # is back before its successor boots; after the boot, what the
            # card holds is the successor's (its reserve moves with cuDNN's
            # algorithm choices on the rebuilding thread, the live tensors match)
            if ref() is not None or abs(alloc_evict - two_alloc) > 0.25:
                raise AssertionError(f"router: the evicted engine alive, or allocated {alloc_evict:.3f} GiB against "
                                     f"{two_alloc:.3f} at the two-replica level")

            # 3. a draining restart under load
            frames = stream_frames(9)
            stream = router.open_stream()
            primed = [stream.submit(frames[0]), stream.submit(frames[1])]
            home = router._stream_homes[stream.stream_id]
            ref = weakref.ref(router._by_id[home].engine)
            before_restart = reserved_gib(device)
            replaced.append((ref, before_restart))
            with ClosedLoop(router, pairs, SERVE_THREADS) as loop:
                time.sleep(0.3)
                t0 = time.perf_counter()
                router.restart_replica(home)
                restart_s = time.perf_counter() - t0
                time.sleep(0.3)
                loop_out = loop.stop()
            after = [stream.submit(frames[2]), stream.submit(frames[3])]
            homes = dict(router._stream_homes)
            stream.close()
            st = router.stats()
            del stream
            after_restart = reserved_gib(device)
            log(f"router: draining restart of {home} (the stream's home) under a closed loop of {SERVE_THREADS} "
                f"clients in {restart_s:.3f} s: outcomes {loop_out}, restarts {st['router']['restarts']}, drains "
                f"{st['router']['drains']}; stream frames before primed={[r.primed for r in primed]}, after "
                f"primed={[r.primed for r in after]}, homes {homes}; reserved {before_restart:.3f} GiB before the "
                f"restart, {at_rebuild[1][0]:.3f} as its rebuild began (the drained engine dropped, no collection; "
                f"{at_rebuild[1][1]:.3f} s after the rebuild was called), {after_restart:.3f} after it (the old "
                f"engine gone: {ref() is None}); card {card}")
            if set(loop_out) != {"flow"} or st["router"]["restarts"] != 1 or not primed[0].primed \
                    or primed[1].flow is None or after[1].flow is None:
                raise AssertionError("router: the draining restart dropped a request or broke the stream")
            if ref() is not None:
                raise AssertionError("router: the drained engine outlived its restart")

            # 4. the autoscaler: idle 2 -> 1, a flood 1 -> 2, a trickle 2 -> 1
            scaler = Autoscaler(router, AutoscaleConfig(min_replicas=1, max_replicas=2, eval_interval_s=0.2,
                                                        up_after=2, down_after=3, cooldown_s=ROUTER_COOLDOWN_S))
            down1_s = settle(lambda: len(router.replicas) == 1 and alive() == 1, 60.0,
                             "the idle scale-down 2 -> 1 and the release of the removed engine")
            # the last of the removed engine's memory may trail its object by
            # a moment: wait (and say how long) for the card to hold one engine
            back1_s = settle(lambda: reserved_gib(device) <= after_restart - footprint + ROUTER_MEM_TOL_GIB, 10.0,
                             "the return of the removed engine's memory")
            one_level = reserved_gib(device)
            with ClosedLoop(router, pairs, ROUTER_FLOOD) as loop:
                up_s = settle(lambda: len(router.replicas) == 2 and all(r.state == "healthy" for r in router.replicas),
                              120.0, "the flood's scale-up 1 -> 2")
                time.sleep(1.0)  # the new replica takes traffic
                flood_out = loop.stop()
            with ClosedLoop(router, pairs, 1) as loop:
                down2_s = settle(lambda: len(router.replicas) == 1 and alive() == 1, 60.0,
                                 "the calm scale-down 2 -> 1 and the release of the removed engine")
                trickle_out = loop.stop()
            back2_s = settle(lambda: reserved_gib(device) <= one_level + ROUTER_MEM_TOL_GIB, 10.0,
                             "the return of the scaled-down engine's memory")
            after_down = reserved_gib(device)
            snap = scaler.snapshot()
            log(f"router: autoscaler 1..2: idle 2 -> 1 in {down1_s:.3f} s (reserved {one_level:.3f} GiB, the memory "
                f"back {back1_s:.3f} s after the engine's release), a flood of {ROUTER_FLOOD} clients 1 -> 2 in "
                f"{up_s:.3f} s (outcomes {flood_out}), a trickle of one client 2 -> 1 in {down2_s:.3f} s (outcomes "
                f"{trickle_out}; reserved {after_down:.3f} GiB, back {back2_s:.3f} s after the release); actions "
                f"{[(a['action'], a['reason']) for a in snap['actions']]}; card {card}")
            for d in scaler.explain(64):
                if d["action"] != "hold" or d is scaler.history[-1]:
                    sig = d["signals"]
                    log(f"router explain: {d['action']} ({d['reason']}) occupancy {sig['occupancy']:.3f} degraded "
                        f"{sig['degraded_level']:.3f} shed {sig['shed_rate']:.3f} slo_miss "
                        f"{sig['slo_miss_rate']:.3f} arrival {sig['arrival_rps']:.2f}/s replicas "
                        f"{sig['replica_count']} streaks {d['up_streak']}/{d['down_streak']}")
            if [a["action"] for a in snap["actions"]] != ["down", "up", "down"] \
                    or set(flood_out) - {"flow", "Overloaded"} or set(trickle_out) != {"flow"}:
                raise AssertionError(f"router: the autoscaler's actions {snap['actions']}, outcomes {flood_out} / "
                                     f"{trickle_out}")

            # 5. metrics and launches
            prom = router.prometheus()
            prom_ok = prometheus_ok(prom, 'router_counters{key="routed"}',
                                    *(f'replica="{rep.replica_id}"' for rep in router.replicas))
            captures = capture_events() - ev0
            rebuilds = [e for e in router.recorder.events()
                        if (e["kind"] == "readmit" and e["rebuilt"]) or e["kind"] in ("restart_done", "scale_up")]
        finally:
            router.close()
        # graph replays and the eager warm-ups before each capture
        k1_graphs, eager = by_kernel(replayed_launches())["k1"] - k1_graphs0, read_counts()["k1"]
        k1 = k1_graphs + eager
        del router, scaler
        after_close = reserved_gib(device)
        log(f"router: prometheus {len(prom.splitlines())} lines, parsed: {prom_ok}; "
            f"captures after start() {captures}: {len(rebuilds)} rebuilt engines' boots ({[e['kind'] for e in rebuilds]}) "
            f"at {boot_captures} a boot; engines built {len(built)}, alive after close() and del {alive()}; reserved "
            f"{after_close:.3f} GiB; K1 {k1} launches in the phase (graph replays {k1_graphs}, boots included, of "
            f"which the single engine {k1_single}; eager, in the boots' warm-ups, {eager}); phase {time.perf_counter() - t_phase:.1f} s; card {card}")
        if not prom_ok or captures != len(rebuilds) * boot_captures or len(rebuilds) != 3 \
                or alive():
            raise AssertionError("router: Prometheus text, captures outside the rebuilt boots, or an engine alive "
                                 "after close()")
        del model
        return k1, {"single_rps": single_rps, "router_rps": router_rps, "readmit_s": readmit_s,
                    "boot_ms": new_boot["boot_to_ready_ms"], "two_level_gib": two_level,
                    "after_evict_gib": after_evict}
    finally:
        gc.enable()


ROLLOUT_CLIENTS = 8
# the perturbed candidate: added to both channels of the flow head's last
# bias; each update adds it to the 1/8-grid flow and the upsampling scales
# it by 8, so over 32 updates the flow moves ~256 x ROLLOUT_BIAS px a
# component (before the recurrence's own response)
ROLLOUT_BIAS = 0.01
ROLLOUT_WAIT_S = 120.0


def rollout_config(**kw):
    """The ladders' knobs: 2 s holds, short windows, a floor of 8 samples,
    the gate's thresholds at their defaults (a 1 px mean flow gap, 4 px
    p99). A mirror runs alone on the candidate while its live twin ran in a
    batch, so at bf16 an identical candidate's gap is batch rounding: a
    long window's mean reads up to ~0.09 px on an H100 (PERF.md §6), too
    near the 'throughput' bound of 0.1 to gate on without false breaches;
    the phase holds the mean over every mirrored pair of the ladder to
    that bound instead."""
    from raft_tpu_torch.serve import RolloutConfig

    knobs = dict(mirror_fraction=0.5, canary_fraction=0.25, min_samples=8, shadow_hold_s=2.0, canary_hold_s=2.0,
                 short_window_s=1.0, long_window_s=3.0)
    return RolloutConfig(**dict(knobs, **kw))


def rollout_phase(device, card, weights):
    """The guarded rollout on the card, with the collector off: raft_large at
    'throughput' (fused, bf16 levels, K1's bf16 product), bucket 440x1024,
    warmed, the serving phase's weights, a one-rung ladder (R5: a degraded
    replica is starved of the admissions that would let it recover), two
    thread replicas behind ``ServeRouter``, then three candidates, each
    under a closed loop of ``ROLLOUT_CLIENTS`` clients:

    1. identical weights: shadow -> canary -> promoted (the flow gap over
       every mirrored pair is batch rounding only, within the 'throughput'
       bounds: 0.1 px mean, the per-request p99 within the 2 px max bound);
       every request a flow, every replica rebuilt onto the candidate's
       hash;
    2. the flow head's last bias offset by ``ROLLOUT_BIAS``: a ``flow_mean``
       breach in shadow rolls it back, ``wait()`` raises
       ``RolloutAborted``, no replica on its hash, a valid postmortem
       bundle with the ``rollout_*`` events;
    3. identical weights parked in canary, then declared dead on its
       heartbeat (``FaultInjector.replica_dead`` through ``patch_router``):
       rolled back with ``candidate_crash``, the canary requests it held
       re-served by the replicas.

    No request is lost in any ladder. The reserved memory is printed during
    shadow and after each terminal stage: the candidate's engine is freed
    without a collection, the card back within ``ROUTER_MEM_TOL_GIB`` of
    the two-replica level. Captures
    after ``start()`` happen only in the candidates' boots and promotion's
    rebuilds; every engine is gone after ``close()``. Returns K1's
    launches (graph replays, boots included, and the boots' eager
    warm-ups) and the numbers."""
    import copy
    import dataclasses
    import functools
    import gc
    import weakref

    import raft_tpu_torch as rt
    from raft_tpu_torch.graphs import capture_events, replayed_launches
    from raft_tpu_torch.obs import validate_bundle
    from raft_tpu_torch.serve import RolloutAborted, RolloutStage, RouterConfig, ServeConfig, ServeEngine, ServeRouter
    from raft_tpu_torch.utils.faults import FaultInjector

    t_phase = time.perf_counter()
    gc.disable()
    try:
        model = rt.raft_for_serving(ServeConfig.preset("throughput"), corr_impl="fused", device=device)
        model.load_state_dict(weights)
        perturbed = copy.deepcopy(model)
        with torch.no_grad():
            perturbed.update_block.flow_head.conv2.bias.add_(ROLLOUT_BIAS)
        cfg = ServeConfig(buckets=(SERVE_BUCKET,), pool_capacity=SERVE_CAPACITY, ladder=SERVE_LADDER[:1],
                          warmup=True, default_deadline_ms=120_000.0, ledger_sample_every=0,
                          queue_capacity=ROUTER_QUEUE)
        pairs = [request_pair(200 + i)[:2] for i in range(SERVE_REQUESTS)]
        built = []  # weakrefs to every engine a factory builds

        def factory(net=model, **overrides):
            eng = ServeEngine(net, dataclasses.replace(cfg, **overrides), device=device)
            built.append(weakref.ref(eng))
            return eng

        def alive():
            return sum(r() is not None for r in built)

        reset_counts()
        k1_graphs0 = by_kernel(replayed_launches())["k1"]
        router = ServeRouter.from_factory(factory, 2, RouterConfig(
            heartbeat_interval_s=ROUTER_BEAT_S, cooldown_s=ROUTER_COOLDOWN_S, drain_timeout_s=60.0))
        try:
            t0 = time.perf_counter()
            router.start()
            boot_s = time.perf_counter() - t0
            two_level = reserved_gib(device)
            two_alloc = torch.cuda.memory_allocated(device) / 2**30
            fleet_hash = router.variables_hash
            boot_captures = sum(max(n, 0) for n in router._by_id["r0"].engine.program_counts().values())
            ev0 = capture_events()
            log(f"rollout: 2 thread replicas booted in {boot_s:.3f} s, reserved {two_level:.3f} GiB (allocated "
                f"{two_alloc:.3f}), {boot_captures} captures a boot; card {card}")

            def ladder(name, cand_factory, rcfg, during=None):
                """One ladder under a closed loop: boot the candidate, wait
                for the end, stop the clients, wait for the candidate's
                engine to be released; its numbers."""
                st0 = router.stats()["router"]
                t0 = time.perf_counter()
                ctrl = router.add_candidate(cand_factory, rollout_config=rcfg)
                cand_boot_s = time.perf_counter() - t0
                gone = weakref.ref(ctrl.candidate.engine)
                cand_hash = ctrl.candidate.variables_hash
                shadow_gib = reserved_gib(device)
                extra = None
                gate = None  # the gate's last long-window reading at its sample floor, in shadow or canary
                with ClosedLoop(router, pairs, ROLLOUT_CLIENTS) as loop:
                    t1 = time.perf_counter()
                    if during is not None:
                        extra = during(ctrl)
                    while ctrl.stage not in RolloutStage.TERMINAL and time.perf_counter() - t1 < ROLLOUT_WAIT_S:
                        if ctrl.stage in (RolloutStage.SHADOW, RolloutStage.CANARY):
                            reading = ctrl.gate.evaluate()["long"]
                            if reading["samples"] >= ctrl.config.min_samples:
                                gate = reading
                        time.sleep(0.05)
                    try:
                        ctrl.wait(timeout=ROLLOUT_WAIT_S)
                        end = RolloutStage.PROMOTED
                    except RolloutAborted as e:
                        end = (e.stage, e.reason)
                    ladder_s = time.perf_counter() - t1
                    loop_out = loop.stop()
                release_s = settle(lambda: gone() is None, 10.0, f"the release of the {name} candidate's engine")
                after_gib = reserved_gib(device)
                after_alloc = torch.cuda.memory_allocated(device) / 2**30
                snap, st = ctrl.snapshot(), router.stats()
                # the gap over every sample of the ladder, not a window's
                samples = [sample for _, sample in list(ctrl.gate._ring)]
                whole = ctrl.gate._metrics(samples)
                gaps = [x["flow_mean"] for x in samples if x["flow_mean"] is not None]
                whole["flow_mean_std_px"] = float(np.std(gaps)) if gaps else None
                d = {k: st["router"][k] - st0[k] for k in ("routed", "rerouted", "evictions", "mirrored",
                                                          "mirror_shed", "canary_routed")}
                stages = [(h["stage"], h["t_s"]) for h in snap["stage_history"]]
                gate = gate or snap["gate"]["long"]
                log(f"rollout {name}: candidate booted in {cand_boot_s:.3f} s (reserved {shadow_gib:.3f} GiB in "
                    f"shadow); ended {end} {ladder_s:.3f} s later, stages {stages}; clients' outcomes {loop_out}; "
                    f"router {d}; gate (long window) samples {gate['samples']} flow_mean_px {gate['flow_mean_px']} "
                    f"flow_p99_px {gate['flow_p99_px']} latency_ratio {gate['latency_ratio']} iters_delta "
                    f"{gate['iters_delta']} error_rate {gate['error_rate']}; over the whole ladder samples "
                    f"{whole['samples']} flow_mean_px {whole['flow_mean_px']} (std {whole['flow_mean_std_px']}) "
                    f"flow_p99_px {whole['flow_p99_px']}; "
                    f"mirror errors {snap['mirror_errors']}, "
                    f"canary errors {snap['canary_errors']}; candidate engine released {release_s:.3f} s after, "
                    f"reserved {after_gib:.3f} GiB (allocated {after_alloc:.3f}; two-replica level {two_level:.3f} / "
                    f"{two_alloc:.3f}); replicas {[(r.replica_id, r.generation, r.variables_hash == cand_hash) for r in router.replicas]}; "
                    f"card {card}")
                if set(loop_out) != {"flow"}:
                    raise AssertionError(f"rollout {name}: a request was lost: {loop_out}")
                return dict(end=end, snap=snap, d=d, cand_hash=cand_hash, after_gib=after_gib, extra=extra, whole=whole)

            # 1. an identical candidate, promoted
            one = ladder("identical", None, rollout_config())
            tol_mean, tol_max = SERVE_TOL["throughput"]
            hashes = {r.variables_hash for r in router.replicas}
            stages = [h["stage"] for h in one["snap"]["stage_history"]]
            if one["end"] != RolloutStage.PROMOTED or stages != ["shadow", "canary", "promoting", "promoted"] \
                    or hashes != {one["cand_hash"]} or one["cand_hash"] != fleet_hash \
                    or any(r.generation != 2 for r in router.replicas) or not one["d"]["canary_routed"] \
                    or one["d"]["evictions"] or one["whole"]["flow_mean_px"] is None \
                    or not (one["whole"]["flow_mean_px"] <= tol_mean and one["whole"]["flow_p99_px"] <= tol_max):
                raise AssertionError(f"rollout: the identical candidate's ladder {stages}, hashes {hashes}, flow gap "
                                     f"{one['whole']}")
            if one["after_gib"] > two_level + ROUTER_MEM_TOL_GIB:
                raise AssertionError("rollout: the promoted candidate's memory did not come back")

            # 2. a perturbed candidate, rolled back on the flow gate
            two = ladder("perturbed", functools.partial(factory, net=perturbed), rollout_config())
            bundles = [b for b in router.recorder.bundles() if b["reason"] == "rollout_rollback:flow_mean"]
            kinds = set() if not bundles else {e["kind"] for e in bundles[-1]["events"]}
            hashes = {r.variables_hash for r in router.replicas}
            log(f"rollout perturbed: predicted gap ~{256 * ROLLOUT_BIAS * 2**0.5:.2f} px (32 updates x 8 x "
                f"{ROLLOUT_BIAS} a component), measured flow_mean_px {two['whole']['flow_mean_px']} over its ladder; bundle "
                f"{[validate_bundle(b) for b in bundles]}, rollout events "
                f"{sorted(k for k in kinds if k.startswith('rollout'))}")
            if two["end"] != ("shadow", "flow_mean") or two["cand_hash"] in hashes or hashes != {fleet_hash} \
                    or len(bundles) != 1 or validate_bundle(bundles[0]) \
                    or not {"rollout_candidate", "rollout_stage", "rollout_breach", "rollout_rollback"} <= kinds \
                    or two["after_gib"] > two_level + ROUTER_MEM_TOL_GIB:
                raise AssertionError(f"rollout: the perturbed candidate ended {two['end']}, replicas {hashes}")

            # 3. a candidate declared dead in canary
            def crash(ctrl):
                settle(lambda: ctrl.stage in RolloutStage.TERMINAL or (ctrl.stage == RolloutStage.CANARY
                                                                       and ctrl.canary_routed >= 4), 60.0,
                       "the third candidate's canary stage")
                if ctrl.stage != RolloutStage.CANARY:
                    raise AssertionError(f"rollout: the third candidate ended {ctrl.stage} ({ctrl.abort_reason}) "
                                         f"before its crash")
                inj = FaultInjector()
                inj.on("router.heartbeat", when=lambda i, c: c["replica"] == "candidate",
                       action=FaultInjector.replica_dead)
                with inj.patch_router(router):
                    settle(lambda: ctrl.stage in RolloutStage.TERMINAL, 30.0, "the crashed candidate's rollback")
                return inj.fired["router.heartbeat"]

            three = ladder("crashed", None, rollout_config(auto_promote=False), during=crash)
            if three["end"] != ("canary", "candidate_crash") or not three["extra"] or three["d"]["evictions"] != 1 \
                    or {r.variables_hash for r in router.replicas} != {fleet_hash} \
                    or three["after_gib"] > two_level + ROUTER_MEM_TOL_GIB:
                raise AssertionError(f"rollout: the crashed candidate ended {three['end']}")
            captures = capture_events() - ev0
        finally:
            router.close()
        k1_graphs, eager = by_kernel(replayed_launches())["k1"] - k1_graphs0, read_counts()["k1"]
        k1 = k1_graphs + eager
        del router, one, two, three
        after_close = reserved_gib(device)
        log(f"rollout: captures after start() {captures} (3 candidates' boots and 2 promotion rebuilds at "
            f"{boot_captures} a boot); engines built {len(built)}, alive after close() and del {alive()}; reserved "
            f"{after_close:.3f} GiB; K1 {k1} launches in the phase (graph replays {k1_graphs}, boots included; eager, "
            f"in the boots' warm-ups, {eager}); phase {time.perf_counter() - t_phase:.1f} s; card {card}")
        if captures != 5 * boot_captures or len(built) != 7 or alive():
            raise AssertionError("rollout: captures outside the candidates' boots and promotion's rebuilds, or an "
                                 "engine alive after close()")
        del model, perturbed
        return k1
    finally:
        gc.enable()


PROCESS_SLOTS = 2 * SERVE_THREADS  # request slots a worker's ring holds: every client's pair in flight
PROCESS_COOLDOWN_S = 3.0  # the killed worker's memory is read back before its readmission begins
PROCESS_MEM_TOL_GIB = 0.5


class ProcessFactory:
    """The process phase's engine factory, picklable: a spawned worker
    imports this script as ``__mp_main__`` (its top level does no work) and
    calls this in its own CUDA context, rebuilding raft_large at
    'throughput' (fused, K1's bf16 product) from the checkpoint the phase
    wrote, so every worker serves the phase's weights."""

    def __init__(self, checkpoint: str, config):
        self.checkpoint, self.config = checkpoint, config

    def __call__(self, **overrides):
        import dataclasses

        import raft_tpu_torch as rt
        from raft_tpu_torch.serve import ServeConfig, ServeEngine

        model = rt.raft_for_serving(ServeConfig.preset("throughput"), corr_impl="fused", checkpoint=self.checkpoint,
                                    device="cuda")
        return ServeEngine(model, dataclasses.replace(self.config, **overrides), device="cuda")


def card_free_gib(device) -> float:
    """The card's free memory, every process's use included."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info(device)[0] / 2**30


def compute_apps() -> str:
    """Per-process card memory as nvidia-smi reports it (PID, MiB)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip()) or "none listed"
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e!r})"


def pid_gone(pid: int) -> bool:
    """True once ``pid`` is no live process (a reaped child: no /proc entry;
    an unreaped zombie still counts as there)."""
    return not Path(f"/proc/{pid}").exists()


def process_phase(device, card, weights, thread_rps):
    """The process fleet on the card, with the collector off: raft_large at
    'throughput' (fused, bf16 levels, K1's bf16 product), bucket 440x1024,
    warmed, a one-rung ladder (R5), the router phase's weights written to
    a temporary checkpoint that every worker loads (``ProcessFactory``).

    One in-process engine serves the 24 requests (the reference flows) and
    is dropped. Then ``ServeRouter.from_factory(..., 2,
    backend='process')``: two spawned workers booting together, each in its
    own CUDA context (distinct live PIDs, each boot's seconds and captures,
    the card's free memory and nvidia-smi's per-process list, no nvcc run:
    the kernel libraries' files unchanged); the 24 requests from 8 threads
    (each flow within 'throughput''s bounds of the in-process engine's,
    both replicas served, no capture after ``start()``, requests/s and
    p50/p99 beside the router phase's two thread replicas); one worker
    SIGKILLed while it holds work under a closed loop (one eviction, every
    request a flow, the PID gone and its memory back on the card before
    its readmission under a new PID); a draining restart under load
    (nothing dropped, a new PID); an identical-weights process candidate
    through ``add_candidate(backend='process')``, promoted (both
    incumbents rebuilt onto it, its worker gone after); ``close()``: no
    worker PID left and the card's free memory back. The rings are sized
    from what the phase sends (a pair of 436x1024x3 uint8 images and a
    436x1024x2 fp32 flow a request) and checked against ``/dev/shm``.
    Returns K1's launches (the in-process engine's replays and every
    worker's, read from its ``stats()['launches']`` before it ends) and
    the numbers."""
    import dataclasses
    import gc
    import os
    import signal
    import tempfile

    import raft_tpu_torch as rt
    from raft_tpu_torch.kernels import build
    from raft_tpu_torch.serve import RolloutStage, RouterConfig, ServeConfig, ServeRouter

    t_phase = time.perf_counter()
    gc.disable()
    tmp = tempfile.TemporaryDirectory(prefix="raft-process-phase-")
    try:
        # the rings: one slot a tensor, sized to the largest a request moves
        h, w = IMAGE
        slot_bytes = 1 << math.ceil(math.log2(max(h * w * 3, h * w * 2 * 4)))
        opts = dict(ring_slots=PROCESS_SLOTS, slot_bytes=slot_bytes, dump_dir=os.path.join(tmp.name, "dumps"))
        shm = os.statvfs("/dev/shm")
        shm_free, need = shm.f_bavail * shm.f_frsize, 3 * 2 * PROCESS_SLOTS * slot_bytes  # 3 workers at most
        log(f"process: /dev/shm {shm.f_blocks * shm.f_frsize / 2**20:.0f} MiB, {shm_free / 2**20:.0f} MiB free; "
            f"rings {PROCESS_SLOTS} slots x {slot_bytes} bytes a direction, {need / 2**20:.0f} MiB for three "
            f"workers")
        if shm_free < need:
            raise AssertionError(f"process: /dev/shm has {shm_free} bytes free, the rings need {need}")

        base = reserved_gib(device)
        model = rt.raft_for_serving(ServeConfig.preset("throughput"), corr_impl="fused", device=device)
        model.load_state_dict(weights)
        cfg = ServeConfig(buckets=(SERVE_BUCKET,), pool_capacity=SERVE_CAPACITY, ladder=SERVE_LADDER[:1],
                          warmup=True, default_deadline_ms=120_000.0, ledger_sample_every=0,
                          queue_capacity=ROUTER_QUEUE)
        pairs = [request_pair(300 + i)[:2] for i in range(SERVE_REQUESTS)]
        targets = [SERVE_LADDER[i % len(SERVE_LADDER)] for i in range(SERVE_REQUESTS)]
        want, single_rps, k1_single, _ = router_single_engine(model, cfg, device, card, pairs, targets, base,
                                                              what="process")
        checkpoint = os.path.join(tmp.name, "raft_large_throughput.pt")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, checkpoint)
        del model
        libs0 = {p.name: p.stat().st_mtime_ns for p in build.BUILD_DIR.glob("*.so")}
        free0 = card_free_gib(device)
        apps0 = compute_apps()
        k1_workers = 0  # replays read from each worker's stats() before it ends

        def k1_of(client) -> int:
            return by_kernel(client.stats()["launches"])["k1"]

        router = ServeRouter.from_factory(
            ProcessFactory(checkpoint, cfg), 2,
            RouterConfig(heartbeat_interval_s=ROUTER_BEAT_S, cooldown_s=PROCESS_COOLDOWN_S, drain_timeout_s=60.0),
            backend="process", worker_options=opts)
        pids_seen = []
        try:
            # 1. two workers booting together, each in its own context
            t0 = time.perf_counter()
            router.start()
            boot_s = time.perf_counter() - t0
            if any(r.state != "healthy" for r in router.replicas):
                raise AssertionError(f"process: a worker failed to boot: "
                                     f"{[(r.replica_id, r.last_evict_reason) for r in router.replicas]}")
            clients = {r.replica_id: r.engine for r in router.replicas}
            pids = {rid: c.pid for rid, c in clients.items()}
            pids_seen += pids.values()
            boots = {rid: c.boot for rid, c in clients.items()}
            free2 = card_free_gib(device)
            per_worker = (free0 - free2) / 2
            progs0 = {rid: sum(max(n, 0) for n in c.stats()["programs"].values()) for rid, c in clients.items()}
            libs1 = {p.name: p.stat().st_mtime_ns for p in build.BUILD_DIR.glob("*.so")}
            log(f"process: 2 workers booted together in {boot_s:.3f} s, PIDs {pids} (this process {os.getpid()}); "
                f"boots {[(rid, round(b['boot_to_ready_ms'] / 1e3, 3), b['captures']) for rid, b in boots.items()]} "
                f"(s to ready, captures); card free {free0:.3f} GiB before, {free2:.3f} with the fleet "
                f"({per_worker:.3f} a worker); nvidia-smi compute apps before: {apps0}; with the fleet: "
                f"{compute_apps()}; kernel libraries unchanged by the workers: {libs1 == libs0}; card {card}")
            if len(set(pids.values())) != 2 or os.getpid() in pids.values() or any(pid_gone(p) for p in pids.values()) \
                    or libs1 != libs0 or (device.type == "cuda" and any(b["captures"] <= 0 for b in boots.values())):
                raise AssertionError("process: the workers' PIDs, captures or kernel libraries are not as specified")

            # 2. routed traffic through the workers
            lat = []

            def timed(i):
                t = time.perf_counter()
                r = router.submit(*pairs[i], num_flow_updates=targets[i])
                lat.append((time.perf_counter() - t) * 1e3)
                return r

            from concurrent.futures import ThreadPoolExecutor

            t0 = time.perf_counter()
            with ThreadPoolExecutor(SERVE_THREADS) as ex:
                routed = list(ex.map(timed, range(SERVE_REQUESTS)))
            rps = SERVE_REQUESTS / (time.perf_counter() - t0)
            st = router.stats()
            served = {rid: e["completed"] for rid, e in st["engines"].items()}
            progs1 = {rid: sum(max(n, 0) for n in c.stats()["programs"].values()) for rid, c in clients.items()}
            mean_d, max_d = flow_gap([r.flow for r in routed], [x.flow for x in want])
            tol_mean, tol_max = SERVE_TOL["throughput"]
            k1_run = {rid: k1_of(c) for rid, c in clients.items()}
            worker_lat = [r.latency_ms for r in routed]
            log(f"process: {SERVE_REQUESTS} requests from {SERVE_THREADS} threads through 2 workers at {rps:.3f} "
                f"requests/s (2 thread replicas in the router phase {thread_rps:.3f}, one in-process engine "
                f"{single_rps:.3f}); caller's latency p50 {np.percentile(lat, 50):.3f} p99 {np.percentile(lat, 99):.3f} "
                f"ms, the workers' own p50 {np.percentile(worker_lat, 50):.3f} p99 {np.percentile(worker_lat, 99):.3f} "
                f"ms; served {served}; |dflow| vs the in-process engine mean {mean_d:.3e} px (tol {tol_mean:g}), max "
                f"{max_d:.3e} (tol {tol_max:g}); programs at boot {progs0}, after {progs1}; K1 replays {k1_run}; "
                f"card {card}")
            off = [(r.rid, r.num_flow_updates) for r, n in zip(routed, targets) if r.num_flow_updates != n]
            if off or progs1 != progs0 or len(served) != 2 or min(served.values()) == 0 or not (
                    mean_d <= tol_mean and max_d <= tol_max) or (device.type == "cuda" and min(k1_run.values()) <= 0):
                raise AssertionError(f"process: routed traffic off target {off}, captures after start(), served "
                                     f"{served}, or flows off the in-process engine's")

            # 3. SIGKILL a worker while it holds work
            victim = router._by_id["r0"]
            pid0 = victim.engine.pid
            with ClosedLoop(router, pairs, SERVE_THREADS) as loop:
                settle(lambda: victim.inflight >= 2, 30.0, "work on the victim")
                k1_workers += k1_of(victim.engine)
                os.kill(pid0, signal.SIGKILL)
                t_kill = time.monotonic()
                evict_s = settle(lambda: router.stats()["router"]["evictions"] >= 1, 30.0, "the eviction of r0")
                settle(lambda: pid_gone(pid0), 10.0, "the killed worker's exit")
                gone_s = time.monotonic() - t_kill
                back = free2 + 0.75 * per_worker
                settle(lambda: card_free_gib(device) >= back, PROCESS_COOLDOWN_S - 0.2,
                       "the return of the killed worker's memory before its readmission")
                back_s = time.monotonic() - t_kill
                free_killed = card_free_gib(device)
                apps_killed = compute_apps()
                readmit_s = settle(lambda: router.stats()["router"]["readmissions"] >= 1, 180.0,
                                   "the readmission of r0")
                time.sleep(0.5)  # the healed fleet serves
                loop_out = loop.stop()
            st = router.stats()
            new_pid = victim.engine.pid
            pids_seen.append(new_pid)
            new_boot = victim.engine.boot
            log(f"process: SIGKILL of r0 (PID {pid0}) holding work under {SERVE_THREADS} clients: evicted "
                f"{evict_s:.3f} s after the kill, PID reaped {gone_s:.3f} s after it, the card's free memory at "
                f"{back:.3f} GiB or more {back_s:.3f} s after it ({free_killed:.3f} then; fleet level {free2:.3f}, a "
                f"worker {per_worker:.3f}); nvidia-smi then: {apps_killed}; readmitted {readmit_s:.3f} s after that "
                f"as PID {new_pid} (boot to ready {new_boot['boot_to_ready_ms']:.1f} ms, {new_boot['captures']} "
                f"captures); outcomes {loop_out}; rerouted {st['router']['rerouted']}, evictions "
                f"{st['router']['evictions']}; card {card}")
            if set(loop_out) != {"flow"} or st["router"]["evictions"] != 1 or new_pid in (pid0, None) \
                    or pid_gone(new_pid) or victim.state != "healthy":
                raise AssertionError("process: the killed worker was not handled as specified")

            # 4. a draining restart under load
            rep1 = router._by_id["r1"]
            old_pid = rep1.engine.pid
            with ClosedLoop(router, pairs, SERVE_THREADS) as loop:
                time.sleep(0.3)
                k1_workers += k1_of(rep1.engine)
                t0 = time.perf_counter()
                router.restart_replica("r1")
                restart_s = time.perf_counter() - t0
                time.sleep(0.3)
                loop_out = loop.stop()
            pids_seen.append(rep1.engine.pid)
            log(f"process: draining restart of r1 (PID {old_pid} -> {rep1.engine.pid}) under {SERVE_THREADS} "
                f"clients in {restart_s:.3f} s: outcomes {loop_out}, old PID gone {pid_gone(old_pid)}; card {card}")
            if set(loop_out) != {"flow"} or not pid_gone(old_pid) or rep1.engine.pid == old_pid:
                raise AssertionError("process: the draining restart dropped a request or kept its worker")

            # 5. an identical-weights process candidate, promoted (its
            # rebuilds replace both workers: their replays are read first)
            for r in router.replicas:
                k1_workers += k1_of(r.engine)
            t0 = time.perf_counter()
            ctrl = router.add_candidate(backend="process", rollout_config=rollout_config())
            cand_boot_s = time.perf_counter() - t0
            cand_pid = ctrl.candidate.engine.pid
            pids_seen.append(cand_pid)
            cand_free = card_free_gib(device)
            with ClosedLoop(router, pairs, SERVE_THREADS) as loop:
                t1 = time.perf_counter()
                cand_k1 = 0
                while ctrl.stage not in RolloutStage.TERMINAL and time.perf_counter() - t1 < ROLLOUT_WAIT_S:
                    eng = ctrl.candidate.engine
                    if ctrl.stage == RolloutStage.CANARY and eng is not None:
                        try:
                            cand_k1 = k1_of(eng)
                        except Exception:  # noqa: BLE001 -- the candidate retired under the read
                            pass
                    del eng
                    time.sleep(0.05)
                snap = ctrl.wait(timeout=ROLLOUT_WAIT_S)
                ladder_s = time.perf_counter() - t1
                loop_out = loop.stop()
            k1_workers += cand_k1
            settle(lambda: pid_gone(cand_pid), 30.0, "the promoted candidate's worker exit")
            stages = [(h["stage"], h["t_s"]) for h in snap["stage_history"]]
            hashes = {r.variables_hash for r in router.replicas}
            for r in router.replicas:
                pids_seen.append(r.engine.pid)
            log(f"process: a process candidate (PID {cand_pid}) booted in {cand_boot_s:.3f} s (card free "
                f"{cand_free:.3f} GiB with it), promoted {ladder_s:.3f} s later, stages {stages}; mirrored "
                f"{snap['mirrored']}, canary routed {snap['canary_routed']}; outcomes {loop_out}; replicas' hashes "
                f"{hashes} (candidate {ctrl.candidate.variables_hash}); candidate worker gone "
                f"{pid_gone(cand_pid)}; card {card}")
            if snap["stage"] != RolloutStage.PROMOTED or set(loop_out) != {"flow"} \
                    or hashes != {ctrl.candidate.variables_hash}:
                raise AssertionError(f"process: the process candidate ended {snap['stage']}, outcomes {loop_out}")
            for r in router.replicas:
                k1_workers += k1_of(r.engine)
        finally:
            router.close()
        del router
        close_gone = settle(lambda: all(pid_gone(p) for p in pids_seen if p is not None), 30.0,
                            "the exit of every worker after close()")
        free_end = card_free_gib(device)
        log(f"process: close(): every worker PID gone ({sorted(pids_seen)}, {close_gone:.3f} s), card free "
            f"{free_end:.3f} GiB (before the fleet {free0:.3f}); nvidia-smi: {compute_apps()}; K1 {k1_single + k1_workers} "
            f"launches in the phase (the in-process engine's replays {k1_single}, the workers' replays "
            f"{k1_workers}); phase {time.perf_counter() - t_phase:.1f} s; card {card}")
        if abs(free_end - free0) > PROCESS_MEM_TOL_GIB:
            raise AssertionError("process: the card's memory did not come back after close()")
        return k1_single + k1_workers, {"rps": rps, "boot_s": boot_s, "per_worker_gib": per_worker}
    finally:
        tmp.cleanup()
        gc.enable()


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
    k1_train = k1_training_phase(device)
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
    bench_train_k1 = bench_phase()
    k1_serve_q, _ = serving_phase(device, card, "quality", weights)
    k1_serve_t, _ = serving_phase(device, card, "throughput", weights)
    golden_serving_phase(device)
    wr_edge = whole_request_phase(device, card, "edge", weights)
    wr_quality = whole_request_phase(device, card, "quality", weights)
    k1_golden_wr = golden_whole_request_phase(device)
    k1_pool_stream = pool_stream_phase(device, card, weights)
    k1_flow_stream = flow_stream_phase(device, card, weights)
    k1_tiled = tiled_phase(device, card, weights)
    k1_golden_tiled = golden_tiled_phase(device)
    k1_qos_quality = qos_flood_phase(device, card, "quality", weights)
    k1_qos_edge = qos_flood_phase(device, card, "edge", weights)
    k1_obs, _ = observability_phase(device, card, weights)
    k1_router, router_numbers = router_phase(device, card, weights)
    k1_rollout = rollout_phase(device, card, weights)
    k1_process, _ = process_phase(device, card, weights, router_numbers["router_rps"])
    train_phase(device, card)
    fused_launches = train_phase(device, card, corr_impl="fused", window_size=2)
    fused_training_checks(device, card)
    remat_phase(device, card)
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
              serving_launches=k1_serve_q,
              whole_request_path=f"ServeEngine 'quality', pool_capacity=0, raft_large, {SERVE_REQUESTS} requests in "
                                 f"{wr_quality['k1']['batches']} batches of {wr_quality['k1']['rungs']} "
                                 f"(graph replays)",
              whole_request_launches=wr_quality["k1"]["run"],
              stream_path=f"open_stream, {STREAM_FRAMES} frames, in the whole-request engine and the pool (cold, then "
                          f"warm-started), and FlowStream, 4 frames (graph replays)",
              stream_launches=wr_quality["k1"]["stream"] + k1_pool_stream + k1_flow_stream,
              tiled_path=f"ServeEngine 'quality', unknown_shape='tiled', {k1_tiled['pool']['requests']} requests of "
                         f"375x1242, 720x1280 and 1080x1920 as {k1_tiled['pool']['tiles']} 440x1024 tiles, in the "
                         f"pool and at pool_capacity=0 (graph replays)",
              tiled_launches=k1_tiled["pool"]["k1"] + k1_tiled["whole-request"]["k1"],
              qos_path=f"ServeEngine 'quality', qos_enabled, pool capacity 8, queue 8, a flood of "
                       f"{len(QOS_CLASSES) * QOS_ROUNDS} requests from {len(QOS_CLASSES)} threads (graph replays)",
              qos_launches=k1_qos_quality,
              observability_path=f"ServeEngine 'quality', traced (trace_sample_rate 1.0 and 0) and under "
                                 f"apply_timeout_s, pool and pool_capacity=0, {SERVE_REQUESTS} requests x 4 runs, "
                                 f"then a device stall and 16 requests each; Trainer fused windows of 2 under the "
                                 f"tripwire (graph replays; eager in training)",
              observability_launches=k1_obs,
              training_path=f"Trainer, raft_large chairs stage at fused fp32 (b=8, 368x496, 12 updates, window 2), "
                            f"{TRAIN_STEPS} steps", training_launches=fused_launches["k1"],
              bench_train_k1_launches_per_step=bench_train_k1[
                  "corr_impl=fused, corr_dtype=fp32, compute_dtype=fp32"]["k1_launches_per_step"], **k1_train["k1"]),
        entry("xtap_project (K1), bf16 levels, 3xTF32 product", lookup_src, k1_src,
              golden_launches["fused + bf16 corr"], "validate, golden fixture at fused + bf16 corr (clean)",
              lowp_err["k1_bf16"], lowp_times["k1_bf16"], lowp_bounds["k1_bf16"]),
        entry("xtap_project (K1), bf16 levels, bf16 product", lookup_src, k1_src, k1_throughput,
              "FlowEstimator.from_preset('throughput'), raft_large (main path, graph replays)",
              lowp_err["k1_bf16_bf16"],
              lowp_times["k1_bf16_bf16"], lowp_bounds["k1_bf16_bf16"], **k1_batch8["k1_bf16_bf16"],
              serving_path=f"ServeEngine 'throughput', raft_large, {SERVE_REQUESTS} requests (graph replays)",
              serving_launches=k1_serve_t,
              router_path=f"ServeRouter over 2 thread replicas at 'throughput' (one engine first): {SERVE_REQUESTS} "
                          f"requests, a replica death, a draining restart, autoscaling 2 -> 1 -> 2 -> 1 "
                          f"(graph replays, boots included)",
              router_launches=k1_router,
              rollout_path=f"ServeRouter.add_candidate over 2 thread replicas at 'throughput', {ROLLOUT_CLIENTS} "
                           f"closed-loop clients: an identical candidate promoted, a perturbed one rolled back, a "
                           f"crashed one rolled back (graph replays, boots included)",
              rollout_launches=k1_rollout,
              process_path=f"ServeRouter over 2 worker processes (backend='process') at 'throughput' (one "
                           f"in-process engine first): {SERVE_REQUESTS} requests, a SIGKILLed worker, a draining "
                           f"restart, a process candidate promoted (graph replays read from each worker's stats() "
                           f"before it ended: at least this many)",
              process_launches=k1_process,
              training_path="bench --train --corr fused --corr-dtype bfloat16 --dtype bfloat16 (b=6, 368x768, "
                            "12 updates, remat)", bench_train_k1_launches_per_step=bench_train_k1[
                  "corr_impl=fused, corr_dtype=bf16, compute_dtype=bf16"]["k1_launches_per_step"],
              **k1_train["k1_bf16_bf16"]),
        entry("xtap_project (K1), int8 levels, 3xTF32 product", lookup_src, k1_src, golden_launches["edge"],
              "validate, golden fixture at 'edge' (clean)", lowp_err["k1_int8"], lowp_times["k1_int8"],
              lowp_bounds["k1_int8"], **k1_batch8["k1_int8"],
              whole_request_path=f"ServeEngine.preset('edge', pool_capacity=0), raft_large, {SERVE_REQUESTS} requests "
                                 f"in {wr_edge['k1']['batches']} batches of {wr_edge['k1']['rungs']} (graph replays); "
                                 f"the golden fixture through it",
              whole_request_launches=wr_edge["k1"]["run"] + k1_golden_wr["edge"],
              qos_path=f"ServeEngine.preset('edge', pool_capacity=0), qos_enabled, queue 8, a flood of "
                       f"{len(QOS_CLASSES) * QOS_ROUNDS} requests from {len(QOS_CLASSES)} threads (graph replays)",
              qos_launches=k1_qos_edge,
              golden_tiled_path="the golden fixture at 'edge', 96x136 whole and 96x128 tiled, pool_capacity=0",
              golden_tiled_launches=k1_golden_tiled["edge"]),
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
