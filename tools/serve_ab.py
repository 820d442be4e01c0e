#!/usr/bin/env python3
"""The serving pool's phase of ``chip_smoke.py`` on two trees in one call:
parent, this tree, this tree, parent, each in a process of its own, so
drift across the call shows as the spread between a tree's two runs.

    python3 tools/serve_ab.py chip_tree/parent

The parent is a ``git archive`` of another commit unpacked under
``chip_tree/`` (git-ignored). Each process builds its tree's kernels,
makes the main path's weights (raft_large, seed 0, flow head scaled) and
runs ``serving_phase`` at 'throughput', 'quality' and 'throughput' again
(the first engine of a process meets cuDNN's timed search of every conv
shape; the second does not), then ``whole_request_phase`` at 'quality'
(the engine at ``pool_capacity=0``). One JSON line per phase:
``{"tree", "run", "preset", "requests_per_s", "idle_share", "peak"}``,
also appended to ``chiprun_out/serve_ab.jsonl``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PRESETS = ("throughput", "quality", "throughput")


def run_tree(tree: Path, label: str, run: int) -> None:
    """One process's phases on ``tree`` (this script, re-entered)."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    import raft_tpu_torch as rt
    from raft_tpu_torch.kernels import build

    if not rt.__file__.startswith(str(tree)):
        raise RuntimeError(f"imported {rt.__file__}, not the tree {tree}")
    build.build_all()
    device = torch.device("cuda")
    card = cs.card_line()
    model = rt.raft_large(corr_impl="fused", device=device, seed=0)
    with torch.no_grad():
        model.update_block.flow_head.conv2.weight.mul_(cs.FLOW_HEAD_SCALE)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    for preset in PRESETS:
        _, nums = cs.serving_phase(device, card, preset, weights)
        print("AB " + json.dumps({"tree": label, "run": run, "preset": preset, "card": card, **nums}), flush=True)
    nums = cs.whole_request_phase(device, card, "quality", weights)
    print("AB " + json.dumps({"tree": label, "run": run, "preset": "whole-request quality", "card": card,
                              "requests_per_s": nums["requests_per_s"], "idle_share": nums["idle"],
                              "peak": nums["peak"]}), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--tree":
        label, run = sys.argv[3].split(":")
        run_tree(Path(sys.argv[2]).resolve(), label, int(run))
        return 0
    parent = Path(sys.argv[1]).resolve()
    out = ROOT / "chiprun_out" / "serve_ab.jsonl"
    out.parent.mkdir(exist_ok=True)
    with out.open("a") as sink:
        for label, run in (("parent", 1), ("tree", 1), ("tree", 2), ("parent", 2)):
            tree = parent if label == "parent" else ROOT
            proc = subprocess.run([sys.executable, __file__, "--tree", str(tree), f"{label}:{run}"],
                                  capture_output=True, text=True, check=True)
            for line in proc.stdout.splitlines():
                if line.startswith("AB "):
                    print(line[3:], flush=True)
                    sink.write(line[3:] + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
