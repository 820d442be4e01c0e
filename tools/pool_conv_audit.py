#!/usr/bin/env python3
"""Time each convolution of raft_large's update block on the card at batch
1 and at the serving pool's batch 8, under the port's fp32 pin
(``device.fp32_precision``: IEEE fp32, no TF32), NCHW and channels-last,
and profile one pool step of each batch by kernel.

cuDNN picks its algorithm by heuristics per shape; this shows which layers
of the pool's capacity-wide step it sends to slow algorithms. With
``--benchmark`` cuDNN times its candidates instead and keeps the fastest
(``torch.backends.cudnn.benchmark``, as the port's graph warm-up does;
the first call at a shape fixes the choice for the process, so compare
the two modes in two processes). Run from the repository root on a
machine with a card:

    python3 tools/pool_conv_audit.py && python3 tools/pool_conv_audit.py --benchmark

Prints one line per (batch, layer, layout) with milliseconds per call (host
clock around 3 synchronized calls after a warm-up), then the step's top
kernels, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import raft_tpu_torch as rt  # noqa: E402
from raft_tpu_torch.device import fp32_precision  # noqa: E402
from raft_tpu_torch.serve.pool import PoolPrograms, zero_state  # noqa: E402

BUCKET = (440, 1024)


def ms_per_call(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def step_profile(model, device, cap: int, top: int = 6) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    progs = PoolPrograms(model, device)
    state = zero_state(progs, cap, BUCKET)
    x = torch.rand(cap, 3, *BUCKET, device=device) * 2 - 1
    progs.insert(state, progs.begin_pair(x, x.flip(-1)), list(range(cap)), [True] * cap)
    step = lambda: progs.step(state, progs.thresh, progs.streak, progs.min_iters)  # noqa: E731
    print(f"step, batch {cap}: {ms_per_call(step):.3f} ms a call (eager)", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    print(f"step, batch {cap}: {sum(n for n, _ in by_name.values())} device ops", flush=True)
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:9.3f} ms {n:6d}x {name[:120]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--benchmark", action="store_true", help="cuDNN times its algorithms (cudnn.benchmark)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pool_conv_audit: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.benchmark = args.benchmark
    print(f"cudnn.benchmark={args.benchmark}", flush=True)
    device = torch.device("cuda")
    model = rt.raft_large(corr_impl="fused", device=device)
    convs = [(n, m) for n, m in model.update_block.named_modules() if isinstance(m, torch.nn.Conv2d)]
    h8, w8 = BUCKET[0] // 8, BUCKET[1] // 8
    with torch.inference_mode(), fp32_precision():
        for b in (1, 8):
            for name, conv in convs:
                x = torch.randn(b, conv.in_channels, h8, w8, device=device)
                for layout, xx in (("nchw", x), ("channels_last", x.contiguous(memory_format=torch.channels_last))):
                    t = ms_per_call(lambda: conv(xx))
                    print(f"batch {b} {name} {tuple(conv.weight.shape)} {layout}: {t:.3f} ms", flush=True)
        for cap in (1, 8):
            step_profile(model, device, cap)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
