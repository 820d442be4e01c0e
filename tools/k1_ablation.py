#!/usr/bin/env python3
"""Where K1's time goes: ablations of ``raft_tpu_torch/kernels/csrc/lookup_xtap.cu``
timed on the card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 tools/k1_ablation.py

Each ablation is a text edit of the kernel's source that takes away one part
of its work; most of them give a wrong answer on purpose. All are built with
the package's nvcc flags (one nvcc each, started together, into the
git-ignored ``_build/ablation_k1/``) and timed in one process against the
plain version and the grid_sample + addmm chain, at the raft_large and
raft_small fused Sintel shapes, each twice in turns:

  shipped       the kernel as it ships
  fp32_fma      the fp32-FMA form it replaced (tools/k1_fma_lookup_xtap.cu)
  no_split      operands go to the tensor cores unsplit: the three products
                stay, the split arithmetic goes (wrong answer)
  no_mma        fragments are loaded and split, no tensor-core product
  no_stores     nothing is written to device memory
  const_taps    the A tile is filled with a constant: no window copies, no
                interpolation
  product_only  const_taps and no_stores: the weight ring, the fragment
                loads and splits and the products
  gather_only   no_mma and no_stores: the window gather, the taps, the
                weight ring and the fragment loads
  no_window_copy  the windows are not copied (the taps read whatever the
                shared memory holds)
  no_taps       the windows are copied, the taps are not interpolated
  no_w_copy     the weight slices are not copied into the ring
  floor         const_taps, no_w_copy and no_mma: the fragment loads and
                splits, the barriers, the epilogue and the stores
  bm64          a 64-query tile of 16 warps (2 x 8 warps of 32 x 32), one
                block an SM: half the weight traffic
  bm64_kc32     bm64 with 32-column weight slices (199 KB of shared memory
                at raft_large; it would refuse C_in above 440)

The last line is a JSON object of the times in ms.
"""

from __future__ import annotations

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

SHAPES = {
    "raft_large_sintel": dict(b=1, h=55, w=128),
    "raft_small_fused_sintel": dict(b=1, h=55, w=128, radius=3, c_out=96),
}

_MMA3 = "  mma_tf32(d, alo, bhi);\n  mma_tf32(d, ahi, blo);\n  mma_tf32(d, ahi, bhi);"
_KEEP = "  d[0] += __uint_as_float(ahi[0] ^ alo[1] ^ bhi[0] ^ blo[1]) * 0.f;"  # fragments stay live
_SPLIT = "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));"
_SKIP = "      if (m >= nq) continue;\n"  # both store loops of the epilogue
_GATHER = "  gather_windows(pyr, cents, q0, nq, g, a, region, at);\n"
_CONST = "  for (int idx = tid; idx < kBM * g.lda; idx += kProjThreads) a[idx] = 0.5f;\n"
_WINDOW = "          cp_async4(dst + yy * s1 + xx, ok ? vol + y * wl + x : pyr.level[l], ok);\n"
_TAP = ("        dst[ij] = (1.f - fy) * ((1.f - fx) * c[0] + fx * c[1]) + "
        "fy * ((1.f - fx) * c[s1] + fx * c[s1 + 1]);\n")
_W = "      cp_async16(ws + n * kLdw + kk, ok ? weight + int64_t(n0 + n) * g.c_in + k0 + kk : weight, ok);\n"
_BM64 = ("constexpr int kBM = 32;", "constexpr int kBM = 64;", 1)
_KC32 = ("constexpr int kKC = 16;", "constexpr int kKC = 32;", 1)

# name -> [(old, new, occurrences)]
ABLATIONS = {
    "shipped": [],
    "no_split": [(_SPLIT, "  hi = __float_as_uint(x);\n  lo = hi;", 1)],
    "no_mma": [(_MMA3, _KEEP, 1)],
    "no_stores": [(_SKIP, _SKIP.replace("m >= nq", "m >= 0"), 2)],
    "const_taps": [(_GATHER, _CONST, 1)],
    "product_only": [(_GATHER, _CONST, 1), (_SKIP, _SKIP.replace("m >= nq", "m >= 0"), 2)],
    "gather_only": [(_MMA3, _KEEP, 1), (_SKIP, _SKIP.replace("m >= nq", "m >= 0"), 2)],
    "no_window_copy": [(_WINDOW, "          (void)ok;\n", 1)],
    "no_taps": [(_TAP, "        dst[ij] = fx + c[0] * 0.f;\n", 1)],
    "no_w_copy": [(_W, "      (void)ok;\n", 1)],
    "floor": [(_GATHER, _CONST, 1), (_W, "      (void)ok;\n", 1), (_MMA3, _KEEP, 1)],
    "bm64": [_BM64],
    "bm64_kc32": [_BM64, _KC32],
}
FMA_SOURCE = ROOT / "tools" / "k1_fma_lookup_xtap.cu"


def build_ablations(out_dir: Path):
    """One shared library per ablation and one of the fp32-FMA form; raises
    if an edit no longer matches the source or nvcc fails."""
    source = (build.CSRC / "lookup_xtap.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    texts = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"ablation {name}: the source no longer has {old!r} {count} times")
            text = text.replace(old, new)
        texts[name] = text
    texts["fp32_fma"] = FMA_SOURCE.read_text()
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        print(f"{name}: {chip_smoke.ptxas_usage(log, 'xtap_project_kernel')}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.xtap_project_launch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.xtap_project_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, pyr, cents, weight, bias, radius, out):
    b, c_out, h, w = out.shape
    rc = lib.xtap_project_launch(
        *lx._pyramid_args(pyr), cents.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b * h * w, h * w, radius, c_out, torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError_t {rc}")


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build_ablations(build.BUILD_DIR / "ablation_k1")
    dev = torch.device("cuda")
    result = {"card": card}
    for shape_name, kw in SHAPES.items():
        r = kw.get("radius", chip_smoke.RADIUS)
        pyr, cents, weight, bias = chip_smoke.kernel_inputs(dev, **kw)
        want = lx.lookup_project_reference(pyr, cents, weight, bias, r)
        out = torch.empty(want.shape, device=dev)  # NCHW; the plain version's result is a permuted view
        errs = {}
        for name, lib in libs.items():
            launch(lib, pyr, cents, weight, bias, r, out)
            torch.cuda.synchronize()
            errs[name] = (out - want).abs().max().item()
        times = {name: [] for name in ["plain", "library_chain", *libs]}
        for _ in range(2):
            times["plain"].append(chip_smoke.cuda_ms(
                lambda: lx.lookup_project_reference(pyr, cents, weight, bias, r)))
            times["library_chain"].append(chip_smoke.cuda_ms(
                lambda: chip_smoke.k1_library_chain(pyr, cents, weight, bias, r)))
            for name, lib in libs.items():
                times[name].append(chip_smoke.cuda_ms(lambda: launch(lib, pyr, cents, weight, bias, r, out)))
        print(f"{shape_name} {kw}:", flush=True)
        for name, ts in times.items():
            err = f"  max_abs_err vs plain {errs[name]:.3e}" if name in errs else ""
            print(f"  {name:13s} {ts[0]:.4f} {ts[1]:.4f} ms{err}", flush=True)
        result[shape_name] = times
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
