#!/usr/bin/env python3
"""Where K3's time goes: ablations of ``raft_tpu_torch/kernels/csrc/corr_pyramid.cu``
timed on the card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 tools/k3_ablation.py

Each ablation is a text edit of the kernel's source that takes away one part
of its work; most of them give a wrong answer on purpose. All are built with
the package's nvcc flags (one nvcc each, started together, into the
git-ignored ``_build/ablation/``) and timed in one process against the
shipped kernel and the plain matmul + avg_pool2d chain, at the raft_small
and raft_large Sintel shapes, each twice in turns:

  shipped       the kernel as it ships
  cvt_rna       TF32 rounding by PTX cvt.rna.tf32.f32 instead of two integer
                instructions: the same answer
  no_split      operands go to the tensor cores unsplit: the three products
                stay, the split arithmetic goes (wrong answer)
  no_stores     no level is written to device memory
  no_mma        fragments are loaded and split, no tensor-core product
  staging_only  no product and no stores: the cp.async staging, the fragment
                loads and splits, and the shared-memory epilogue

The last line is a JSON object of the times in ms.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from raft_tpu_torch.kernels import build  # noqa: E402
from raft_tpu_torch.kernels.corr_pallas import level_dims, volume_pyramid_reference  # noqa: E402

SHAPES = {"raft_small_sintel": (1, 128, 55, 128, 4), "raft_large_sintel": (1, 256, 55, 128, 4)}

_RNA = "{ return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }"
_CVT = '{ uint32_t r; asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x)); return r; }'
_SPLIT = "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));"
_MMA3 = "  mma_tf32(d, alo, bhi);\n  mma_tf32(d, ahi, blo);\n  mma_tf32(d, ahi, bhi);"
_KEEP = "  d[0] += __uint_as_float(ahi[0] ^ alo[1] ^ bhi[0] ^ blo[1]) * 0.f;"  # fragments stay live
_STORE0 = "        if (t < nq && y < g.h && x < g.w)\n          store4("
_STORE_L = "if (t < nq && yl < hl && xl < wl) store_val(out"
_NO_STORES = [(_STORE0, _STORE0.replace("t < nq", "t < 0")), (_STORE_L, _STORE_L.replace("t < nq", "t < 0"))]

ABLATIONS = {
    "shipped": [],
    "cvt_rna": [(_RNA, _CVT)],
    "no_split": [(_SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;")],
    "no_stores": _NO_STORES,
    "no_mma": [(_MMA3, _KEEP)],
    "staging_only": [(_MMA3, _KEEP)] + _NO_STORES,
}


def build_ablations(out_dir: Path):
    """One shared library per ablation; raises if an edit no longer
    matches the source or nvcc fails."""
    source = (build.CSRC / "corr_pyramid.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"ablation {name}: the source no longer has {old!r} once")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.corr_pyramid_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.corr_pyramid_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, f1, f2, levels, outs):
    b, c, h, w = f1.shape
    ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in outs])
    rc = lib.corr_pyramid_launch(f1.data_ptr(), f2.data_ptr(), ptrs, b, c, h, w, levels,
                                 1.0 / math.sqrt(c), 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError_t {rc}")


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_ablation: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build_ablations(build.BUILD_DIR / "ablation")
    dev = torch.device("cuda")
    result = {"card": card}
    for shape_name, (b, c, h, w, levels) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(3)
        f1 = torch.randn(b, c, h, w, device=dev, generator=gen)
        f2 = torch.randn(b, c, h, w, device=dev, generator=gen)
        want = volume_pyramid_reference(f1, f2, levels)
        outs = [torch.empty((b * h * w, hl, wl), device=dev) for hl, wl in level_dims(h, w, levels)]
        errs = {}
        for name, lib in libs.items():
            launch(lib, f1, f2, levels, outs)
            torch.cuda.synchronize()
            errs[name] = max((o - w_).abs().max().item() for o, w_ in zip(outs, want))
        times = {name: [] for name in ["chain", *libs]}
        for _ in range(2):
            times["chain"].append(chip_smoke.cuda_ms(lambda: volume_pyramid_reference(f1, f2, levels)))
            for name, lib in libs.items():
                times[name].append(chip_smoke.cuda_ms(lambda: launch(lib, f1, f2, levels, outs)))
        print(f"{shape_name} {(b, c, h, w, levels)}:", flush=True)
        for name, ts in times.items():
            err = "" if name == "chain" else f"  max_abs_err vs plain {errs[name]:.3e}"
            print(f"  {name:13s} {ts[0]:.4f} {ts[1]:.4f} ms{err}", flush=True)
        result[shape_name] = {name: ts for name, ts in times.items()}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
