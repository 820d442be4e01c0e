#!/usr/bin/env python3
"""Where a training step's time goes on the card.

    python3 tools/train_profile.py [--arch raft_large] [--steps 3] [--heuristic]

The step runs as the port runs it, under ``cudnn.benchmark`` (cuDNN times
its algorithms at each shape's first call); ``--heuristic`` runs it with
cuDNN's heuristic choice instead: the tool swaps the step's
``cudnn_benchmark`` block for one that turns the flag off. PyTorch keeps
the first choice at a shape for the process, so compare the two in
separate processes.

The bench's training protocol (``python -m raft_tpu_torch.bench
--train``): b=6, 368x768, 12 updates, remat, dense fp32, one synthetic
batch. A warm-up step, ``--steps`` steps timed by CUDA events, then
one step under torch.profiler: its wall time, device busy time (the union
of kernel intervals), idle share, the kernels that take the most device
time and the operators (with their input shapes) that launched them.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def profile_step(step, state, batch, top):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    print(f"  profiled step: wall {wall_ms:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / 1e3 / wall_ms:.3f}, {len(spans)} device ops")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:10.3f} ms {n:6d}x  {name[:110]}")
    print("  by launching operator and input shapes (device time of its kernels):")
    by_op = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.kernels:
            key = (e.name, str(e.input_shapes)[:150])
            n, us = by_op.get(key, (0, 0.0))
            by_op[key] = (n + len(e.kernels), us + sum(k.duration for k in e.kernels))
    for (name, shapes), (n, us) in sorted(by_op.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:10.3f} ms {n:6d}x  {name} {shapes}")
    return state


@contextlib.contextmanager
def _heuristic():
    """The train step's ``cudnn_benchmark`` block, with the flag off."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="raft_large")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--heuristic", action="store_true", help="cuDNN's heuristic algorithms, not benchmark mode")
    args = ap.parse_args()
    from raft_tpu_torch import bench
    from raft_tpu_torch.train import step as step_module
    from raft_tpu_torch.models.zoo import CONFIGS, build_raft
    from raft_tpu_torch.train import TrainState, make_optimizer, make_train_step

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    h, w = bench.TRAIN_CROP
    b = bench.TRAIN_BATCH
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"image1": torch.rand((b, 3, h, w), generator=gen, device=dev) * 2 - 1,
             "image2": torch.rand((b, 3, h, w), generator=gen, device=dev) * 2 - 1,
             "flow": torch.rand((b, 2, h, w), generator=gen, device=dev) * 10 - 5,
             "valid": torch.ones((b, h, w), device=dev)}
    benchmark = not args.heuristic
    if args.heuristic:
        step_module.cudnn_benchmark = _heuristic
    model = build_raft(CONFIGS[args.arch].replace(remat=True), device=dev)
    tx = make_optimizer(1e-4)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, num_flow_updates=bench.TRAIN_UPDATES)
    state, m = step(state, batch)
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.steps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        state, m = step(state, batch)
        e.record()
        ms.append((s, e))
    torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in ms]
    print(f"{args.arch} b={b} {h}x{w} {bench.TRAIN_UPDATES} updates remat dense fp32, cudnn.benchmark="
          f"{benchmark}: step ms {[round(t, 3) for t in times]} = {b * 1e3 / min(times):.3f} pairs/s at the "
          f"fastest; loss {float(m['loss']):.4f}", flush=True)
    profile_step(step, state, batch, args.top)


if __name__ == "__main__":
    main()
