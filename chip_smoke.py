#!/usr/bin/env python3
"""Card smoke test of the PyTorch port (``raft_tpu_torch``).

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):
  1. card: name and power limit from nvidia-smi; TF32 off for matmuls and
     cuDNN, so fp32 means fp32 in every comparison below;
  2. build: every CUDA kernel of the package from this checkout's sources;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes (raft_large at Sintel, 440x1024) and edge
     cases, with times per launch and the card's bound for the same work;
  4. main path: raft_large (full widths, seeded random weights) with
     ``corr_impl='fused'`` answering 3 raw uint8 436x1024 requests through
     ``FlowEstimator`` at 32 updates; the launch counts show the kernel ran
     once per update, and the same weights through ``corr_impl='dense'``
     (plain lookup) give the same flow; one more request runs under
     torch.profiler to show where its time goes;
  5. materialize path: the block's raw correlation features
     (``LazyCorrFeatures.materialize``) through the lookup-only kernel.

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

import numpy as np
import torch

# NVIDIA H100 SXM published peaks (dense): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SINTEL = (1, 55, 128)  # raft_large at 440x1024: the /8 feature grid
RADIUS, LEVELS, C_OUT, FEAT = 4, 4, 256, 256
LOOKUP_TOL = 1e-5  # a 4-term fp32 bilinear sum per tap, summed in another order
PROJECT_TOL = 1e-4  # a 324-term fp32 dot per output, summed in another order
FLOW_MEAN_TOL, FLOW_MAX_TOL = 1e-3, 5e-2  # px after 32 updates, fused vs dense
REQUESTS, UPDATES, IMAGE = 3, 32, (436, 1024)
# Seeded random weights move the flow tens of pixels per update and the
# recurrence then amplifies fp32 rounding without bound; scaling the flow
# head's last conv makes an update move it about a pixel, as a trained
# model's late updates do.
FLOW_HEAD_SCALE = 0.01


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time per call, from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
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


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(device, b, h, w, cent_lo=None, cent_hi=None, seed=0):
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
    c_in = LEVELS * (2 * RADIUS + 1) ** 2
    weight = torch.randn(C_OUT, c_in, device=device, generator=gen) * math.sqrt(2.0 / C_OUT)
    bias = torch.randn(C_OUT, device=device, generator=gen) * 0.05
    return pyramid, cents, weight, bias


def kernel_phase(device):
    from raft_tpu_torch.kernels import lookup_xtap as lx

    cases = {
        "sintel": dict(b=1, h=55, w=128),
        "kitti_ragged_q": dict(b=1, h=47, w=156),
        "batch2": dict(b=2, h=55, w=128),
        "odd_levels": dict(b=1, h=45, w=99),
        "far_out_of_range": dict(b=1, h=55, w=128, cent_lo=-600.0, cent_hi=700.0),
    }
    err = {"k1": 0.0, "k2": 0.0}
    for name, kw in cases.items():
        pyr, cents, weight, bias = kernel_inputs(device, **kw)
        got1 = lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS)
        got2 = lx.lookup_pyramid_fused(pyr, cents, RADIUS)
        torch.cuda.synchronize()
        e1 = (got1 - lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS)).abs().max().item()
        e2 = (got2 - lx.lookup_pyramid_reference(pyr, cents, RADIUS)).abs().max().item()
        levels = [tuple(v.shape[1:]) for v in pyr]
        log(f"kernels {name}: Q={cents.shape[0] * cents.shape[1] * cents.shape[2]} levels={levels} "
            f"K1 max_abs_err={e1:.3e} (tol {PROJECT_TOL:g}) K2 max_abs_err={e2:.3e} (tol {LOOKUP_TOL:g})")
        if not (e1 <= PROJECT_TOL and e2 <= LOOKUP_TOL):
            raise AssertionError(f"kernel disagrees with its plain version on {name}")
        err["k1"], err["k2"] = max(err["k1"], e1), max(err["k2"], e2)

    pyr, cents, weight, bias = kernel_inputs(device, *SINTEL)
    q = cents.shape[0] * cents.shape[1] * cents.shape[2]
    c_in = weight.shape[1]
    times = {
        "k1": cuda_ms(lambda: lx.lookup_project_fused(pyr, cents, weight, bias, RADIUS)),
        "k1_plain": cuda_ms(lambda: lx.lookup_project_reference(pyr, cents, weight, bias, RADIUS)),
        "k2": cuda_ms(lambda: lx.lookup_pyramid_fused(pyr, cents, RADIUS)),
        "k2_plain": cuda_ms(lambda: lx.lookup_pyramid_reference(pyr, cents, RADIUS)),
    }
    # 11 operations per tap for the 4-corner interpolation
    interp_ops = 11.0 * q * c_in
    windows = window_bytes(pyr, cents, RADIUS)
    in_bytes = windows + cents.numel() * 4
    b1 = bound(in_bytes + (weight.numel() + bias.numel() + q * C_OUT) * 4,
               2.0 * q * c_in * C_OUT + 2.0 * q * C_OUT + interp_ops)
    b2 = bound(in_bytes + q * c_in * 4, interp_ops)
    log(f"kernels sintel timing: window bytes {windows}, "
        f"K1 {times['k1']:.4f} ms (plain {times['k1_plain']:.4f}, bound {b1[0]:.4f} by {b1[1]}), "
        f"K2 {times['k2']:.4f} ms (plain {times['k2_plain']:.4f}, bound {b2[0]:.4f} by {b2[1]})")
    return err, times, {"k1": b1, "k2": b2}


def request_images(seed: int):
    """A raw uint8 pair: smooth random texture and its shifted copy."""
    rng = np.random.default_rng(seed)
    h, w = IMAGE
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, h // 8 + 2, w // 8 + 2)).astype(np.float32))
    tex = torch.nn.functional.interpolate(coarse, size=(h + 16, w + 16), mode="bicubic", align_corners=False)
    tex = tex[0].permute(1, 2, 0).clamp(0, 255).numpy().astype(np.uint8)
    dy, dx = rng.integers(-4, 5, size=2)
    return tex[8 : 8 + h, 8 : 8 + w], tex[8 + dy : 8 + dy + h, 8 + dx : 8 + dx + w]


def main_path(device, card):
    import raft_tpu_torch as rt
    from raft_tpu_torch.kernels import lookup_xtap as lx

    model = rt.raft_large(corr_impl="fused", device=device, seed=0)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(FLOW_HEAD_SCALE)
    est = rt.FlowEstimator(model, num_flow_updates=UPDATES)
    pairs = [request_images(seed) for seed in range(REQUESTS)]
    est(*pairs[0])  # warm-up: cuDNN algorithm choice, allocator growth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    lx.lookup_project_fused.launches = 0
    lx.lookup_pyramid_fused.launches = 0
    flows, latencies = [], []
    for pair in pairs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flows.append(est(*pair))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = {"k1": lx.lookup_project_fused.launches, "k2": lx.lookup_pyramid_fused.launches}
    peak = torch.cuda.max_memory_allocated(device)

    log(f"main path: launches K1={launches['k1']} K2={launches['k2']} over {REQUESTS} requests "
        f"x {UPDATES} updates")
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
    est_dense = rt.FlowEstimator(dense, num_flow_updates=UPDATES)
    diffs = [np.abs(f - est_dense(*pair)) for f, pair in zip(flows, pairs)]
    mean_d = float(np.mean([d.mean() for d in diffs]))
    max_d = float(max(d.max() for d in diffs))
    log(f"main path: fused vs dense |dflow| mean {mean_d:.3e} px (tol {FLOW_MEAN_TOL:g}), "
        f"max {max_d:.3e} px (tol {FLOW_MAX_TOL:g}); flow |max| {max(np.abs(f).max() for f in flows):.3f} px")
    if not (mean_d <= FLOW_MEAN_TOL and max_d <= FLOW_MAX_TOL):
        raise AssertionError("fused and dense flows disagree")
    return model, pairs[0], launches, latencies, peak


def profile_request(est, pair, top: int = 12):
    """Where one request's time goes: device time by kernel from
    torch.profiler, against the request's wall time."""
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
        return
    busy_us, end = 0.0, -math.inf
    for s, e in sorted(spans):  # union of kernel intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    log(f"profile: one request, wall {wall_ms:.3f} ms, device busy {busy_us / 1e3:.3f} ms "
        f"(idle share {1 - busy_us / 1e3 / wall_ms:.3f}), {len(spans)} device ops")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"profile:   {us / 1e3:9.3f} ms  {n:5d}x  {name[:110]}")


def materialize_path(device, model, pair):
    """The block's raw correlation features at the refined coordinates of
    one request, through K2, against the dense block."""
    from raft_tpu_torch import FlowEstimator
    from raft_tpu_torch.eval.padder import InputPadder
    from raft_tpu_torch.kernels import lookup_xtap as lx
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
        lx.lookup_project_fused.launches = 0
        lx.lookup_pyramid_fused.launches = 0
        taps = LazyCorrFeatures(model.corr_block, pyramid, cents).materialize()
        torch.cuda.synchronize()
        launches = lx.lookup_pyramid_fused.launches
        want = LazyCorrFeatures(CorrBlock(LEVELS, RADIUS), pyramid, cents).materialize()
    err = (taps - want).abs().max().item()
    log(f"materialize path: K2 launches {launches}, taps {tuple(taps.shape)}, "
        f"max_abs_err vs dense block {err:.3e} (tol {LOOKUP_TOL:g})")
    if launches != 1 or not err <= LOOKUP_TOL:
        raise AssertionError("materialize path did not go through K2 or disagrees")
    return launches


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
    log(f"build: {len(libs)} kernel source(s) in {time.perf_counter() - t0:.2f} s")
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"build {name}: {line.strip()}")

    err, times, bounds = kernel_phase(device)
    model, pair, launches, _, _ = main_path(device, card)
    k2_launches = materialize_path(device, model, pair)

    src = "raft_tpu_torch/kernels/csrc/lookup_xtap.cu"
    kernels = [
        {"name": "xtap_project (K1: lookup + convcorr1)", "route": "cuda", "source": src,
         "replaces": "raft_tpu/kernels/lookup_xtap.py:412", "launches": launches["k1"],
         "path": "FlowEstimator (main path)", "max_abs_err": err["k1"], "ms": times["k1"],
         "plain_ms": times["k1_plain"], "bound_ms": bounds["k1"][0], "bound_by": bounds["k1"][1],
         "library_ms": None},
        {"name": "xtap (K2: lookup)", "route": "cuda", "source": src,
         "replaces": "raft_tpu/kernels/lookup_xtap.py:385", "launches": k2_launches,
         "path": "LazyCorrFeatures.materialize (FlowEstimator launches it 0 times)",
         "max_abs_err": err["k2"], "ms": times["k2"], "plain_ms": times["k2_plain"],
         "bound_ms": bounds["k2"][0], "bound_by": bounds["k2"][1], "library_ms": None},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
