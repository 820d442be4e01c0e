#!/usr/bin/env python3
"""K1's fp32 form (fp32 levels, 3xTF32 product) against another checkout's,
on the card, in one process.

Run from the repository root on a machine with an NVIDIA Hopper card, with
an earlier tree unpacked beside it (``git archive <commit>`` into a
git-ignored directory):

    python3 tools/k1_parent_check.py --parent chip_tree/parent

Builds the other tree's ``raft_tpu_torch/kernels/csrc/lookup_xtap.cu`` with
the package's nvcc flags (into the git-ignored ``_build/parent/``) and runs
both through this tree's wrapper (``lookup_xtap.lookup_project_fused``; the
C interface is the same). Fails unless the outputs are bit-equal on every
``chip_smoke.LOOKUP_CASES`` case (finite centroids). On NaN centroids it
reports where each form gives NaN against the plain version. Then times
both at raft_large Sintel, in turns (other, this, this, other).

The last line is a JSON object of the results.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from raft_tpu_torch.kernels import build  # noqa: E402
from raft_tpu_torch.kernels import lookup_xtap as lx  # noqa: E402


def build_other(parent: Path):
    src = parent / "raft_tpu_torch" / "kernels" / "csrc" / "lookup_xtap.cu"
    out_dir = build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "lookup_xtap.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(src)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return so


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True, help="root of the other tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_parent_check: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    this_lib = lx._lib()
    other_lib = ctypes.CDLL(str(build_other(args.parent)))
    for fn in ("xtap_project_launch", "xtap_lookup_launch"):
        getattr(other_lib, fn).argtypes = getattr(this_lib, fn).argtypes
        getattr(other_lib, fn).restype = getattr(this_lib, fn).restype
    libs = {"other": other_lib, "this": this_lib}
    wrapper_lib = lx._lib

    def run(which, *a):
        lx._lib = lambda: libs[which]  # the wrapper's library, for this call
        try:
            return lx.lookup_project_fused(*a)
        finally:
            lx._lib = wrapper_lib

    dev = torch.device("cuda")
    result = {"card": card, "bit_equal": {}}
    for name, kw in chip_smoke.LOOKUP_CASES.items():
        r = kw.get("radius", chip_smoke.RADIUS)
        pyr, cents, weight, bias = chip_smoke.kernel_inputs(dev, **kw)
        outs = {which: run(which, pyr, cents, weight, bias, r) for which in libs}
        torch.cuda.synchronize()
        same = torch.equal(outs["other"], outs["this"])
        result["bit_equal"][name] = same
        print(f"{name}: bit-equal {same}", flush=True)
        if not same:
            raise AssertionError(f"K1's fp32 form differs from the other tree's on {name}")

    # NaN centroids: where each form gives NaN, against the plain version
    pyr, cents, weight, bias = chip_smoke.kernel_inputs(dev, *chip_smoke.SINTEL)
    cents[0, 0, :4] = float("nan")
    want = lx.lookup_project_reference(pyr, cents, weight, bias, chip_smoke.RADIUS).isnan()
    for which in libs:
        got = run(which, pyr, cents, weight, bias, chip_smoke.RADIUS).isnan()
        result[f"nan_cells_{which}"] = [int(got.sum()), int(want.sum()), bool(torch.equal(got, want))]
        print(f"NaN centroids, {which}: {int(got.sum())} NaN outputs, plain version {int(want.sum())}, "
              f"same cells {torch.equal(got, want)}", flush=True)

    pyr, cents, weight, bias = chip_smoke.kernel_inputs(dev, *chip_smoke.SINTEL)
    times = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        times[which].append(chip_smoke.cuda_ms(lambda: run(which, pyr, cents, weight, bias, chip_smoke.RADIUS)))
    print(f"raft_large Sintel fp32 form: other {times['other']} ms, this {times['this']} ms ({card})", flush=True)
    result["ms"] = times
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
