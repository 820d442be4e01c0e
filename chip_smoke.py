#!/usr/bin/env python3
"""Card smoke test of the PyTorch port (``raft_tpu_torch``).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  1. card: name and power limit from nvidia-smi; TF32 off for matmuls and
     cuDNN, so fp32 means fp32 in every comparison below;
  2. build: every CUDA kernel of the package from this checkout's sources,
     one nvcc per source, all started together (the Triton kernel compiles
     on its first launch, into the same git-ignored ``_build/``), the
     count of tensor-core (HMMA) instructions in K1's and K3's SASS
     (``cuobjdump``), and K1's registers and spills from ptxas;
  3. kernels: each kernel (K1-K5) against its plain PyTorch version on the
     card, at the main paths' shapes and edge cases, with times per launch,
     the card's bound for the same work and, where one PyTorch call or a
     chain of them computes the same function (K1: grid_sample + addmm +
     relu; K3: the plain matmul + avg_pool2d chain; K5: F.instance_norm),
     its time; K1 and K3 with two bounds, the product on the fp32 FMA units
     and as 3xTF32 on the tensor cores against the bytes;
  4. main path: raft_large (full widths, seeded random weights) with
     ``corr_impl='fused'`` answering 3 raw uint8 436x1024 requests through
     ``FlowEstimator`` at 32 updates; the launch counts show K1 ran once
     per update, and the same weights through ``corr_impl='dense'`` give
     the same flow; one more request runs under torch.profiler;
  5. materialize path: the block's raw correlation features
     (``LazyCorrFeatures.materialize``) through K2;
  6. golden EPE: the trained fixture weights (``tests/fixtures/epe_golden``)
     read with ``load_msgpack``, Sintel clean and final through
     ``validate`` at 32 updates with ``corr_impl`` 'pallas' (K3 once per
     pair), 'fused' (K1 once per update) and 'dense', each held to the
     reference EPE within 1e-3 px;
  7. full-width Sintel path: raft_small (full widths, seeded, flow head
     scaled) with ``corr_impl='pallas'``: 3 synthetic 436x1024 pairs
     through ``validate`` (K3 once per pair), fps from
     ``chained_pairs_per_s``, latency and peak memory, the same weights at
     ``'dense'`` giving the same flow, one request under torch.profiler;
  8. entry-point paths: ``lookup_pyramid_pallas`` (K4) and
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
# TF32 on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
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
        total += int((n[:, 0] * n[:, 1]).sum().item()) * 4
    return total


def bound(nbytes: float, ops: float, tf32_ops: float = 0.0):
    """The least time in ms for this work: bytes at the HBM rate against
    ``ops`` at the fp32 FMA rate plus ``tf32_ops`` at the TF32 tensor-core
    rate, whichever is longer."""
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = (ops / PEAK_FP32_FLOPS + tf32_ops / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hmma_count(lib_path, kernel: str) -> int:
    """Tensor-core (HMMA) instructions in the SASS of every function of a
    built library whose name contains ``kernel``, from ``cuobjdump``."""
    from raft_tpu_torch.kernels import build

    cuobjdump = Path(build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and "HMMA" in line:
            count += 1
    return count


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
    """The launch counter of every kernel wrapper, by kernel."""
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
}


def k1_library_chain(pyramid, cents, weight, bias, radius):
    """K1's function as a chain of PyTorch calls (the torchvision
    formulation): per level ``F.grid_sample`` of the (S, S) offsets around
    the centroid (align_corners=True, zero padding), the levels
    concatenated in the reference channel order, the 1x1 projection as
    ``torch.addmm`` + relu, laid out NCHW. Levels need 2 px a side (the
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
            raise ValueError(f"k1_library_chain: level {level} is {hl}x{wl}, under 2 px a side")
        xy = cents.reshape(q, 1, 1, 2) / 2.0**level + off
        grid = torch.stack((xy[..., 0] * (2.0 / (wl - 1)) - 1.0, xy[..., 1] * (2.0 / (hl - 1)) - 1.0), dim=-1)
        sampled = torch.nn.functional.grid_sample(vol.view(q, 1, hl, wl), grid, mode="bilinear",
                                                  padding_mode="zeros", align_corners=True)
        taps.append(sampled.view(q, s * s))  # channel i*S + j
    proj = torch.relu(torch.addmm(bias, torch.cat(taps, dim=1), weight.t()))
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

    pyr, cents, weight, bias = kernel_inputs(device, *SINTEL)
    q = cents.shape[0] * cents.shape[1] * cents.shape[2]
    c_in = weight.shape[1]
    plain1 = lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS)
    e_lib = (k1_library_chain(pyr, cents, weight, bias, RADIUS) - plain1).abs().max().item()
    log(f"kernels K1 library chain (grid_sample + addmm + relu) vs plain: max_abs_err={e_lib:.3e} "
        f"(tol {PROJECT_TOL:g})")
    if not e_lib <= PROJECT_TOL:
        raise AssertionError("K1's library chain does not compute K1's function")
    times = {
        "k1": cuda_ms(lambda: lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS)),
        "k1_plain": cuda_ms(lambda: lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS)),
        "k1_library": cuda_ms(lambda: k1_library_chain(pyr, cents, weight, bias, RADIUS)),
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
        f"K4 {times['k4']:.4f} ms (plain {times['k4_plain']:.4f}, bound {b2[0]:.4f} by {b2[1]})")

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
}


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
    for name, (b, c, h, w, levels) in VOLUME_CASES.items():
        gen = torch.Generator(device=device).manual_seed(3)
        f1 = torch.randn(b, c, h, w, device=device, generator=gen)
        f2 = torch.randn(b, c, h, w, device=device, generator=gen)
        got = cp.fused_volume_pyramid(f1, f2, levels)
        torch.cuda.synchronize()
        want = cp.volume_pyramid_reference(f1, f2, levels)
        e = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
        shapes_ok = all(g.shape == w_.shape for g, w_ in zip(got, want))
        log(f"kernels K3 {name}: levels {[tuple(g.shape[1:]) for g in got]} max_abs_err={e:.3e} "
            f"(tol {VOLUME_TOL:g})")
        if not (shapes_ok and e <= VOLUME_TOL):
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


def main_path(device, card):
    import raft_tpu_torch as rt

    model = rt.raft_large(corr_impl="fused", device=device, seed=0)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(FLOW_HEAD_SCALE)
    est = rt.FlowEstimator(model, num_flow_updates=UPDATES)
    pairs = [request_pair(seed)[:2] for seed in range(REQUESTS)]
    est(*pairs[0])  # warm-up: cuDNN algorithm choice, allocator growth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    reset_counts()
    flows, latencies = [], []
    for pair in pairs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows.append(est(*pair))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device)

    log(f"main path: launches {launches} over {REQUESTS} requests x {UPDATES} updates")
    if launches["k1"] != REQUESTS * UPDATES:
        raise AssertionError(f"K1 launched {launches['k1']} times, expected {REQUESTS * UPDATES}")
    for f in flows:
        if f.shape != IMAGE + (2,) or not np.isfinite(f).all():
            raise AssertionError(f"bad flow: shape {f.shape}, finite {np.isfinite(f).all()}")
    log(f"main path: per-request latency ms {[round(t, 3) for t in latencies]} "
        f"(mean {np.mean(latencies):.3f}), peak device memory {peak} B "
        f"({peak / 2**30:.3f} GiB), card {card}")

    profile_request(est, pairs[0])

    dense = rt.raft_large(corr_impl="dense", device=device)
    dense.load_state_dict(model.state_dict())
    compare_flows("main path: fused", flows, rt.FlowEstimator(dense, num_flow_updates=UPDATES), pairs)
    return model, pairs[0], launches


def compare_flows(what, flows, est_dense, pairs):
    diffs = [np.abs(f - est_dense(*pair[:2])) for f, pair in zip(flows, pairs)]
    mean_d = float(np.mean([d.mean() for d in diffs]))
    max_d = float(max(d.max() for d in diffs))
    log(f"{what} vs dense |dflow| mean {mean_d:.3e} px (tol {FLOW_MEAN_TOL:g}), "
        f"max {max_d:.3e} px (tol {FLOW_MAX_TOL:g}); flow |max| {max(np.abs(f).max() for f in flows):.3f} px")
    if not (mean_d <= FLOW_MEAN_TOL and max_d <= FLOW_MAX_TOL):
        raise AssertionError(f"{what} and dense flows disagree")


def profile_request(est, pair, top: int = 12):
    """Where one request's time goes: device time by kernel from
    torch.profiler, against the request's wall time. Returns
    ({kernel name: device us}, device busy us), or None when the profiler
    recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        est(*pair)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    if not spans:
        log("profile: the profiler recorded no device activity; device busy share not measured")
        return None
    busy_us, end = 0.0, -math.inf
    for s, e in sorted(spans):  # union of kernel intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    log(f"profile: one request, wall {wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f}), {len(spans)} device ops")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"profile:   {us / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")
    return {name: us for name, (_, us) in by_name.items()}, busy_us


def materialize_path(device, model, pair):
    """The block's raw correlation features at the refined coordinates of
    one request, through K2, against the dense block."""
    from raft_tpu_torch import FlowEstimator
    from raft_tpu_torch.eval.padder import InputPadder
    from raft_tpu_torch.models.corr import CorrBlock, LazyCorrFeatures

    im1, im2 = (FlowEstimator._normalize(im) for im in pair)
    p1, p2 = (
        torch.from_numpy(p).to(device).permute(0, 3, 1, 2) for p in InputPadder(im1.shape).pad(im1, im2)
    )
    with torch.inference_mode():
        state = model.begin_pair(p1, p2)
        for _ in range(4):
            state = model.iterate_step(state)
        pyramid = [lvl.reshape((-1,) + tuple(lvl.shape[2:])) for lvl in state["pyramid"]]
        cents = state["coords1"].permute(0, 2, 3, 1).contiguous()
        reset_counts()
        taps = LazyCorrFeatures(model.corr_block, pyramid, cents).materialize()
        torch.cuda.synchronize()
        launches = read_counts()["k2"]
        want = LazyCorrFeatures(CorrBlock(LEVELS, RADIUS), pyramid, cents).materialize()
    err = (taps - want).abs().max().item()
    log(f"materialize path: K2 launches {launches}, taps {tuple(taps.shape)}, "
        f"max_abs_err vs dense block {err:.3e} (tol {LOOKUP_TOL:g})")
    if launches != 1 or not err <= LOOKUP_TOL:
        raise AssertionError("materialize path did not go through K2 or disagrees")
    return launches


def golden_phase(device):
    """The trained-weight gate: the fixture's Sintel passes through
    ``validate`` at each corr_impl, held to the reference EPE."""
    import raft_tpu_torch as rt
    from raft_tpu_torch.checkpoint import load_msgpack, state_dict_from_flax
    from raft_tpu_torch.data import Sintel
    from raft_tpu_torch.eval import validate

    expected = json.loads((FIXTURE / "expected.json").read_text())
    iters = expected["protocol"]["iters"]
    state = state_dict_from_flax(load_msgpack(str(FIXTURE / "weights.msgpack")))
    epes, k3_launches = {}, {}
    for impl in ("pallas", "fused", "dense"):
        model = rt.build_raft(rt.RAFT_SMALL.replace(corr_impl=impl, **FIXTURE_ARCH), device=device)
        model.load_state_dict(state, strict=True)
        for dstype in ("clean", "final"):
            ds = Sintel(str(FIXTURE), split="training", dstype=dstype)
            reset_counts()
            m = validate(model, ds, num_flow_updates=iters, mode="sintel", fps_pairs=0)
            torch.cuda.synchronize()
            launches = read_counts()
            ref = expected["reference"][dstype]
            gen = expected["ours_at_generation"][dstype]
            worst = max(abs(m[k] - gen[k]) for k in ("1px", "3px", "5px"))
            log(f"golden EPE {impl} {dstype}: epe {m['epe']:.7f} (reference {ref:.7f}, "
                f"|d| {abs(m['epe'] - ref):.3e}, tol {EPE_TOL:g}); 1px {m['1px']:.6f} 3px {m['3px']:.6f} "
                f"5px {m['5px']:.6f} (max |d| vs generation {worst:.3e}); launches {launches}")
            want = {"pallas": ("k3", len(ds)), "fused": ("k1", len(ds) * iters), "dense": ("k3", 0)}[impl]
            if launches[want[0]] != want[1]:
                raise AssertionError(f"golden {impl} {dstype}: {want[0]} launched {launches[want[0]]}, "
                                     f"expected {want[1]}")
            if not (abs(m["epe"] - ref) < EPE_TOL and worst < EPE_TOL):
                raise AssertionError(f"golden EPE {impl} {dstype} misses the reference")
            epes[f"{impl}/{dstype}"] = m["epe"]
            if impl == "pallas":
                k3_launches[dstype] = launches["k3"]
    log(f"golden EPE: {json.dumps(epes)}")
    return epes, k3_launches


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
    """raft_small at full width, corr_impl='pallas', through validate."""
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
    est = rt.FlowEstimator(model, num_flow_updates=UPDATES)
    flows, latencies = [], []
    for s in data.samples:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows.append(est(s["image1"], s["image2"]))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    log(f"sintel path: chained_pairs_per_s {fps:.3f} pairs/s over {len(data)} pairs; FlowEstimator "
        f"per-request latency ms {[round(t, 3) for t in latencies]} (mean {np.mean(latencies):.3f}), card {card}")
    for f in flows:
        if f.shape != IMAGE + (2,) or not np.isfinite(f).all():
            raise AssertionError(f"bad flow: shape {f.shape}")

    dense = rt.raft_small(corr_impl="dense", device=device)
    dense.load_state_dict(model.state_dict())
    compare_flows("sintel path: pallas", flows, rt.FlowEstimator(dense, num_flow_updates=UPDATES),
                  [(s["image1"], s["image2"]) for s in data.samples])

    prof = profile_request(est, (data.samples[0]["image1"], data.samples[0]["image2"]))
    if prof is not None:
        by_name, busy_us = prof
        k3_us = sum(us for name, us in by_name.items() if "corr_pyramid_kernel" in name)
        conv_us = sum(us for name, us in by_name.items()
                      if any(t in name.lower() for t in ("conv", "fprop", "implicit_gemm")))
        log(f"sintel path profile: K3 {k3_us / 1e3:.3f} ms = {k3_us / busy_us:.4f} of device busy time, "
            f"fp32 convolutions {conv_us / 1e3:.3f} ms = {conv_us / busy_us:.4f}")
    return launches["k3"]


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for cuBLAS matmuls and cuDNN convolutions (fp32 comparisons)")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernel sources in {time.perf_counter() - t0:.2f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "Compiling entry" in line:
                log(f"build {name}: {line.strip()}")
    hmma = hmma_count(libs["corr_pyramid"], "corr_pyramid_kernel")
    log(f"build corr_pyramid: {hmma} HMMA (tensor-core) instructions in corr_pyramid_kernel's SASS")
    if hmma == 0:
        raise AssertionError("K3 has no tensor-core instructions")
    hmma1 = hmma_count(libs["lookup_xtap"], "xtap_project_kernel")
    log(f"build lookup_xtap: {hmma1} HMMA (tensor-core) instructions in xtap_project_kernel's SASS; "
        f"ptxas: {ptxas_usage(build.build_logs.get('lookup_xtap', ''), 'xtap_project_kernel')}")
    if hmma1 == 0:
        raise AssertionError("K1 has no tensor-core instructions")

    lookup_err, lookup_times, lookup_bounds, k4_launches = lookup_phase(device)
    k3_err, k3_times = volume_phase(device)
    t0 = time.perf_counter()
    k5_err, k5_times, k5_launches = inorm_phase(device)
    log(f"kernels K5 phase (Triton compiles included) {time.perf_counter() - t0:.2f} s")
    model, pair, launches = main_path(device, card)
    k2_launches = materialize_path(device, model, pair)
    del model
    golden_phase(device)
    k3_launches = sintel_path(device, card)

    k3 = k3_times["raft_small_sintel"]
    lookup_src = "raft_tpu_torch/kernels/csrc/lookup_xtap.cu"
    kernels = [
        {"name": "xtap_project (K1: lookup + convcorr1)", "route": "cuda", "source": lookup_src,
         "replaces": "raft_tpu/kernels/lookup_xtap.py:412", "launches": launches["k1"],
         "path": "FlowEstimator, raft_large fused (main path)", "max_abs_err": lookup_err["k1"],
         "ms": lookup_times["k1"], "plain_ms": lookup_times["k1_plain"], "bound_ms": lookup_bounds["k1"][0],
         "bound_by": lookup_bounds["k1"][1], "library_ms": lookup_times["k1_library"],
         "fp32_fma_bound_ms": lookup_bounds["k1_fma"][0], "hmma": hmma1},
        {"name": "xtap (K2: lookup)", "route": "cuda", "source": lookup_src,
         "replaces": "raft_tpu/kernels/lookup_xtap.py:385", "launches": k2_launches,
         "path": "LazyCorrFeatures.materialize (FlowEstimator launches it 0 times)",
         "max_abs_err": lookup_err["k2"], "ms": lookup_times["k2"], "plain_ms": lookup_times["k2_plain"],
         "bound_ms": lookup_bounds["k2"][0], "bound_by": lookup_bounds["k2"][1], "library_ms": None},
        {"name": "corr_pyramid (K3: volume + pooled pyramid)", "route": "cuda",
         "source": "raft_tpu_torch/kernels/csrc/corr_pyramid.cu",
         "replaces": "raft_tpu/kernels/corr_pallas.py:64", "launches": k3_launches,
         "path": f"validate, raft_small pallas, {REQUESTS} pairs 436x1024", "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound"][0], "bound_by": k3["bound"][1],
         "library_ms": k3["plain_ms"], "fp32_fma_bound_ms": k3["fp32_bound"][0], "hmma": hmma},
        {"name": "lookup_dense (K4: separable lookup)", "route": "cuda",
         "source": "raft_tpu_torch/kernels/csrc/lookup_dense.cu",
         "replaces": "raft_tpu/kernels/lookup_pallas.py:50", "launches": k4_launches,
         "path": "lookup_pyramid_pallas (own entry point)", "max_abs_err": lookup_err["k4"],
         "ms": lookup_times["k4"], "plain_ms": lookup_times["k4_plain"], "bound_ms": lookup_bounds["k4"][0],
         "bound_by": lookup_bounds["k4"][1], "library_ms": None},
        {"name": "instance_norm (K5: stats + normalize)", "route": "triton",
         "source": "raft_tpu_torch/kernels/inorm_pallas.py",
         "replaces": "raft_tpu/kernels/inorm_pallas.py:47", "launches": k5_launches,
         "path": "instance_norm_pallas (own entry point)", "max_abs_err": k5_err["fp32"],
         "ms": k5_times["ms"], "plain_ms": k5_times["plain_ms"], "bound_ms": k5_times["bound"][0],
         "bound_by": k5_times["bound"][1], "library_ms": k5_times["library_ms"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
