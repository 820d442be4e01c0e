"""Sintel-resolution inference throughput of the port on the card.

Run from the repository root on a machine with a CUDA card:

    python -m raft_tpu_torch.bench            # both models, 128 pairs each
    python -m raft_tpu_torch.bench --pairs 8  # a quick look

The protocol is the JAX package's ``bench.py`` (the reference's published
benchmark): batch 1, 440x1024 (Sintel 436x1024 replicate-padded), 32 flow
updates, final flow only. Each configuration builds its model with seeded
random weights and captures its call once as a CUDA graph over two static
input buffers (``inference.flow_program``: the port's counterpart of the JAX
bench's one compiled program; the capture's warm-up runs under
``cudnn.benchmark``), replays it once, then times ``--pairs`` distinct
seeded pairs (made on the card before the clock starts) back to back, each
two device-to-device copies into the buffers and one replay, with CUDA
events around the whole chain and one synchronize at the end. Baselines
are the reference's RTX 3090 Ti figures, 11.8 pairs/s for raft_large and
36.6 for raft_small.

Configurations, per model, as the JAX ``bench.py`` defaults them:
``corr_impl='fused'`` with bf16 pyramid storage; raft_small runs its convs
in bf16 too, raft_large keeps fp32 convs. Beside that headline: ``_exact``
(fused, fp32 storage and convs), raft_small's ``_native`` (bf16 storage
only) and ``_b8`` (batch 8, bf16 storage and convs). fp32 means IEEE fp32
throughout (``device.fp32_precision``: no TF32).

Output: a JSON line with the card's name and power limit (``nvidia-smi``)
and the peak device memory of every configuration, over its capture and
its timed chain (the pairs' inputs, ``input_bytes``, stay resident on the
device and are part of it; cuDNN's algorithm trials are not), then one
JSON line per configuration, ``{"metric", "value", "unit", "vs_baseline",
"config"}``, raft_large's headline last.

``--train`` benches the training step instead (the JAX ``bench.py
--train``): per model, ``{arch}_train_pairs_s`` at b=6, 368x768, 12
updates, ``remat=True``, ``corr_impl='dense'`` in IEEE fp32, on one
synthetic seeded batch made on the card: one warm-up step, then
``--steps`` steps (default 20) back to back with CUDA events around them
and one synchronize. The step runs eagerly (capturing it as a CUDA graph
is ROADMAP work), which its ``protocol`` string says.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from typing import List, Optional, Sequence

import torch

from raft_tpu_torch.device import cudnn_benchmark, resolve_device
from raft_tpu_torch.inference import flow_program, run_flow

__all__ = ["BASELINES", "describe_config", "plan", "bench_config", "bench_train", "main"]

# jax-raft reference on an RTX 3090 Ti (the JAX package's bench.py)
BASELINES = {"raft_large": 11.8, "raft_small": 36.6}
N_PAIRS = 128
H, W = 440, 1024
UPDATES = 32
_SHORT = {"float32": "fp32", "bfloat16": "bf16", "int8": "int8"}


def describe_config(impl: str, corr_dtype: str, compute_dtype: str, batch: int = 1) -> str:
    """The label every metric line carries: corr impl and storage, conv
    dtype, batch, and TF32 off."""
    return (f"corr_impl={impl}, corr_dtype={_SHORT.get(corr_dtype, corr_dtype)}, "
            f"compute_dtype={_SHORT.get(compute_dtype, compute_dtype)}, batch={batch}, tf32=off")


def plan(arch: str, corr: Optional[str] = None, corr_dtype: Optional[str] = None,
         dtype: Optional[str] = None, batch: int = 1, exact: bool = True,
         batched: bool = True) -> List[tuple]:
    """The configurations of one model, as ``(impl, corr_dtype,
    compute_dtype, suffix, batch)``, headline last (the JAX ``bench.py``
    ``resolve_bench_config`` and companion lines)."""
    impl = corr or "fused"
    cdt = corr_dtype or ("bfloat16" if impl == "fused" else "float32")
    default = corr is None and corr_dtype is None and dtype is None
    dt = dtype or ("bfloat16" if arch == "raft_small" and corr is None and impl == "fused" else "float32")
    runs = []
    if cdt in ("int8", "bfloat16") and corr_dtype is None and exact:
        runs.append((impl, "float32", "float32", "_exact", batch))
    if arch == "raft_small" and batch == 1 and default and exact:
        runs.append((impl, "bfloat16", "float32", "_native", 1))
    if batch == 1 and batched and default:
        runs.append((impl, cdt, "bfloat16", "", 8))
    runs.append((impl, cdt, dt, "", batch))
    return runs


def _pairs(n: int, batch: int, h: int, w: int, device, seed: int):
    """``n`` batches of two seeded ``(batch, 3, h, w)`` images in [-1, 1],
    made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (n, 2, batch, 3, h, w)
    return torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0


def bench_config(arch: str, impl: str, corr_dtype: str, compute_dtype: str, batch: int, *,
                 n_pairs: int = N_PAIRS, device="cuda", seed: int = 0) -> dict:
    """Pairs per second of one configuration, its peak device memory and
    the bytes of its inputs. The peak is taken over the capture (its eager
    run and the capture itself) and the timed chain, with the inputs, the
    graph's two input buffers and the weights resident: the
    configuration's working set. One eager call before it lets cuDNN time
    its algorithms at this shape (benchmark mode), so their trial
    workspaces, freed once the choice is made, stay out of the peak."""
    from raft_tpu_torch.models.zoo import CONFIGS, build_raft

    dev = torch.device(device)
    model = build_raft(CONFIGS[arch].replace(corr_impl=impl, corr_dtype=corr_dtype,
                                             compute_dtype=compute_dtype), device=dev, seed=seed)
    steps = max(n_pairs // batch, 1)
    with torch.inference_mode():
        pairs = _pairs(steps, batch, H, W, dev, seed + 1)
        # the warm-up pair becomes the graph's input buffers
        warm = _pairs(1, batch, H, W, dev, seed)
        # the warm-up: one eager call, in which cuDNN chooses its
        # algorithms; the capture's eager run and the capture; one replay
        with cudnn_benchmark():
            model(warm[0, 0], warm[0, 1], num_flow_updates=UPDATES, emit_all=False)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        prog = flow_program(model, warm[0, 0], warm[0, 1], num_flow_updates=UPDATES, name=f"bench {arch}")
        prog()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(steps):
            run_flow(prog, pairs[i, 0], pairs[i, 1])
        end.record()
        torch.cuda.synchronize(dev)
        seconds = start.elapsed_time(end) / 1e3
    return {"pairs_per_s": steps * batch / seconds, "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "input_bytes": pairs.numel() * pairs.element_size()}


TRAIN_BATCH, TRAIN_CROP, TRAIN_UPDATES, TRAIN_STEPS = 6, (368, 768), 12, 20


def bench_train(arch: str, *, steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH, crop=TRAIN_CROP,
                iters: int = TRAIN_UPDATES, device="cuda", seed: int = 0) -> dict:
    """Training pairs per second of ``arch`` at dense fp32 with remat: the
    full train step (forward, sequence loss, backward, clip + AdamW) on one
    synthetic batch, and the peak device memory."""
    from raft_tpu_torch.models.zoo import CONFIGS, build_raft
    from raft_tpu_torch.train import TrainState, make_optimizer, make_train_step

    dev = torch.device(device)
    model = build_raft(CONFIGS[arch].replace(remat=True, corr_impl="dense"), device=dev, seed=seed)
    tx = make_optimizer(1e-4, weight_decay=1e-4, clip_norm=1.0)
    state = TrainState.create(model, tx)
    step_fn = make_train_step(model, tx, num_flow_updates=iters)
    h, w = crop
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = {
        "image1": torch.rand((batch, 3, h, w), generator=gen, device=dev) * 2 - 1,
        "image2": torch.rand((batch, 3, h, w), generator=gen, device=dev) * 2 - 1,
        "flow": torch.rand((batch, 2, h, w), generator=gen, device=dev) * 10 - 5,
        "valid": torch.ones((batch, h, w), device=dev),
    }
    state, metrics = step_fn(state, data)  # warm-up
    float(metrics["loss"])
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, metrics = step_fn(state, data)
    end.record()
    torch.cuda.synchronize(dev)
    seconds = start.elapsed_time(end) / 1e3
    if not math.isfinite(float(metrics["loss"])):
        raise RuntimeError(f"{arch} training bench: nonfinite loss")
    return {"pairs_per_s": steps * batch / seconds, "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
            "protocol": f"b={batch} {h}x{w} {iters} iters, fwd+bwd+AdamW, remat, eager"}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="*", default=["raft_small", "raft_large"])
    ap.add_argument("--pairs", type=int, default=N_PAIRS)
    ap.add_argument("--dtype", default=None, choices=["float32", "bfloat16"])
    ap.add_argument("--corr", default=None, choices=["dense", "pallas", "fused"])
    ap.add_argument("--corr-dtype", default=None, choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--no-batched", action="store_true", help="skip the batch-8 lines")
    ap.add_argument("--no-exact", action="store_true", help="skip the _exact and _native lines")
    ap.add_argument("--train", action="store_true", help="bench the training step instead")
    ap.add_argument("--steps", type=int, default=TRAIN_STEPS, help="timed train steps (--train)")
    args = ap.parse_args(argv)
    dev = resolve_device()
    lines, memory, inputs = [], {}, {}
    if args.train:
        for arch in args.models:
            r = bench_train(arch, steps=args.steps, device=dev)
            metric = f"{arch}_train_pairs_s"
            lines.append({"metric": metric, "value": round(r["pairs_per_s"], 3), "unit": "pairs/s",
                          "protocol": r["protocol"],
                          "config": describe_config("dense", "float32", "float32", TRAIN_BATCH)})
            memory[metric] = r["peak_memory_bytes"]
        print(json.dumps({"card": card_line(), "device": torch.cuda.get_device_name(dev), "steps": args.steps,
                          "peak_memory_bytes": memory}), flush=True)
        for line in lines:
            print(json.dumps(line), flush=True)
        return 0
    for arch in args.models:  # the headline of raft_large last
        for impl, cdt, dt, suffix, batch in plan(arch, args.corr, args.corr_dtype, args.dtype,
                                                 args.batch, not args.no_exact, not args.no_batched):
            r = bench_config(arch, impl, cdt, dt, batch, n_pairs=args.pairs, device=dev)
            metric = f"{arch}_sintel_fps{suffix}" + (f"_b{batch}" if batch != 1 else "")
            line = {
                "metric": metric,
                "value": round(r["pairs_per_s"], 3),
                "unit": "pairs/s",
                "vs_baseline": round(r["pairs_per_s"] / BASELINES[arch], 3),
                "config": describe_config(impl, cdt, dt, batch),
            }
            if batch != 1:
                line["protocol"] = f"batch {batch} (published protocol is b=1)"
            lines.append(line)
            memory[metric] = r["peak_memory_bytes"]
            inputs[metric] = r["input_bytes"]
    print(json.dumps({"card": card_line(), "device": torch.cuda.get_device_name(dev),
                      "pairs": args.pairs, "peak_memory_bytes": memory, "input_bytes": inputs}), flush=True)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
