#!/usr/bin/env python3
"""Where K1's time goes: ablations of ``raft_tpu_torch/kernels/csrc/lookup_xtap.cu``
timed on the card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 tools/k1_ablation.py

Each ablation is a text edit of the kernel's source that takes away one part
of its work; most of them give a wrong answer on purpose. All are built with
the package's nvcc flags (one nvcc each, started together, into the
git-ignored ``_build/ablation_k1/``) and timed in one process.

The fp32 form (fp32 levels, 3xTF32 product) is timed against the plain
version and the grid_sample + addmm chain, at the raft_large and raft_small
fused Sintel shapes, each twice in turns:

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

The four reduced-precision forms (bf16 or int8 levels, 3xTF32 or bf16
product) are timed at raft_large Sintel (Q = 7040, C_in 324, C_out 256),
raft_small fused Sintel (C_in 196, C_out 96) and batch 8 (Q = 56320, the
serving pool's tick and the bench's ``_b8`` lines), each form twice in turns
against the earlier form (tools/k1_lowp_pr6_lookup_xtap.cu: widening loads,
the ring after the gather, a TF32 pass for the bf16 product), with the
plain version, the library chain and the card's bound (``chip_smoke.bound``)
beside the shipped form; the 3xTF32 forms must give output bit-equal to the
earlier form's (the script fails otherwise). Ablations of the shipped form:

  lowp_no_window_copy  the bf16 / int8 windows are not copied
  lowp_no_taps         the windows are copied, the taps are not formed
  lowp_no_w_copy       the weight slices are not copied into the ring
  lowp_no_mma          no tensor-core product (fragments still loaded)
  lowp_no_prefetch     no weight slice issued before the gather

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
LOWP_SHAPES = {**SHAPES, "raft_large_batch8": dict(b=8, h=55, w=128)}
# (storage, bf16 product) of each reduced-precision form
LOWP_FORMS = {"bf16_3xtf32": ("bf16", False), "bf16_bf16": ("bf16", True),
              "int8_3xtf32": ("int8", False), "int8_bf16": ("int8", True)}

_MMA3 = "  mma_tf32(d, alo, bhi);\n  mma_tf32(d, ahi, blo);\n  mma_tf32(d, ahi, bhi);"
_KEEP = "  d[0] += __uint_as_float(ahi[0] ^ alo[1] ^ bhi[0] ^ blo[1]) * 0.f;"  # fragments stay live
_SPLIT = "  hi = tf32_rna(x);\n  lo = tf32_rna(x - __uint_as_float(hi));"
_SKIP = "      if (m >= nq) continue;\n"  # both store loops of the epilogue
_GATHER = "    gather_windows(pyr, cents, q0, nq, g, a, reinterpret_cast<float*>(region), at);\n"
_CONST = "    for (int idx = tid; idx < kBM * g.lda; idx += kProjThreads) a[idx] = 0.5f;\n"
_WINDOW = "  cp_async4(dst, ok ? vol + off : vol, ok);\n"
_TAP = ("          store_tap(dst + ij,\n"
        "                    (1.f - fy) * ((1.f - fx) * c[0] + fx * c[1]) + fy * ((1.f - fx) * c[s1] + fx * c[s1 + 1]));\n")
_W = "      cp_async16(ws + n * kLdw + kk, ok ? weight + int64_t(n0 + n) * g.c_in + k0 + kk : weight, ok);\n"
_W_BF16 = ("    cp_async16(ws + (n * kLdwB + kk / 2) * 4, ok ? weight + int64_t(n0 + n) * g.k_pad + k0 + kk : weight, "
           "ok);\n")
_LOWP_WINDOW = "        cp_async4n(dst + rr * rb + 4 * k, ok ? vbase + c : vbase, ok ? min(4, b1 - c) : 0);\n"
_LOWP_TAPS = "    if (live && x < s && j > 0) store_tap(dst + j - 1, valid ? tap : 0.f);\n"
_MMA_BF16 = "          for (int i = 0; i < kMf; ++i) mma_bf16(acc[i][j], af[i], bf);\n"
_KEEP_BF16 = "          acc[0][j][0] += __uint_as_float(af[0][0] ^ af[1][3] ^ bf[0] ^ bf[1]) * 0.f;\n"
_PREFETCH = "      for (int st = 0; st < g.prefetch; ++st) {"
_PREFETCH_N = "      return g.prefetch;\n"
_FIRST = "  const int first = kWide ? 0 : g.prefetch;\n"
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
    "no_window_copy": [(_WINDOW, "  (void)dst;\n  (void)off;\n  (void)ok;\n", 1)],
    "no_taps": [(_TAP, "          store_tap(dst + ij, fx + c[0] * 0.f);\n", 1)],
    "no_w_copy": [(_W, "      (void)ok;\n", 1)],
    "floor": [(_GATHER, _CONST, 1), (_W, "      (void)ok;\n", 1), (_MMA3, _KEEP, 1)],
    "bm64": [_BM64],
    "bm64_kc32": [_BM64, _KC32],
    "lowp_no_window_copy": [(_LOWP_WINDOW, "        (void)ok;\n", 1)],
    # the taps are the fraction: the windows are copied and waited for, nothing is read from them
    "lowp_no_taps": [(_LOWP_TAPS, "    if (live && x < s && j > 0) store_tap(dst + j - 1, fx);\n", 1)],
    "lowp_no_w_copy": [(_W, "      (void)ok;\n", 1), (_W_BF16, "    (void)ok;\n", 1)],
    "lowp_no_mma": [(_MMA3, _KEEP, 1), (_MMA_BF16, _KEEP_BF16, 1)],
    "lowp_no_prefetch": [(_PREFETCH, "      for (int st = 0; st < 0; ++st) {", 1),
                         (_PREFETCH_N, "      return 0;\n", 1), (_FIRST, "  const int first = 0;\n", 1)],
}
FP32_ABLATIONS = [n for n in ABLATIONS if not n.startswith("lowp_")]
LOWP_ABLATIONS = [n for n in ABLATIONS if n.startswith("lowp_")]
FMA_SOURCE = ROOT / "tools" / "k1_fma_lookup_xtap.cu"
EARLIER_LOWP_SOURCE = ROOT / "tools" / "k1_lowp_pr6_lookup_xtap.cu"


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
    texts["lowp_earlier"] = EARLIER_LOWP_SOURCE.read_text()
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
        ints = ctypes.POINTER(ctypes.c_int)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        if name == "fp32_fma":  # the old fp32-only interface
            lib.xtap_project_launch.argtypes = [
                ctypes.POINTER(ptr), ints, ints, i32, ptr, ptr, ptr, ptr, i64, i64, i32, i32, ptr]
        elif name == "lowp_earlier":  # no bf16 weight argument
            lib.xtap_project_launch.argtypes = [
                ctypes.POINTER(ptr), ints, ints, ints, i32, i32, ptr,
                ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr]
        else:
            lib.xtap_project_launch.argtypes = [
                ctypes.POINTER(ptr), ints, ints, ints, i32, i32, ptr,
                ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, ptr, ptr]
        lib.xtap_project_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launch(lib, name, pyr, cents, weight, bias, radius, out, weight_bf16=None):
    """One launch: the product at bf16 when ``weight_bf16`` is given (the
    earlier form rounds ``weight`` itself), else 3xTF32."""
    b, c_out, h, w = out.shape
    pyr_args = lx._pyramid_args(pyr, radius)
    if name == "fp32_fma":
        pyr_args = pyr_args[:3] + (pyr_args[4],)
    rest = (cents.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), b * h * w, h * w, radius, c_out)
    if name != "fp32_fma":
        rest += (int(weight_bf16 is not None),)
    if name not in ("fp32_fma", "lowp_earlier"):
        rest += (weight_bf16.data_ptr() if weight_bf16 is not None else None,)
    rc = lib.xtap_project_launch(*pyr_args, *rest, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError_t {rc}")


def lowp_rows(libs, dev):
    """The reduced-precision forms: shipped and earlier in turns, the
    ablations, and the shipped form's plain, library and bound; raises if a
    3xTF32 form is not bit-equal to the earlier one or a form misses its
    plain version's tolerance."""
    rows = {}
    for shape_name, kw in LOWP_SHAPES.items():
        r = kw.get("radius", chip_smoke.RADIUS)
        pyr32, cents, weight, bias = chip_smoke.kernel_inputs(dev, **kw)
        q = cents.shape[0] * cents.shape[1] * cents.shape[2]
        c_out, c_in = weight.shape
        for form, (storage, bf16) in LOWP_FORMS.items():
            pyr = chip_smoke.lowp_pyramid(pyr32, storage)
            scales = getattr(pyr, "scales", None)
            proj = torch.bfloat16 if bf16 else None
            wb = lx.project_weight_bf16(weight) if bf16 else None
            want = lx.lookup_project_reference(pyr, cents, weight, bias, r, proj)
            outs = {}
            for name in ("shipped", "lowp_earlier", *LOWP_ABLATIONS):
                outs[name] = torch.empty(want.shape, device=dev, dtype=want.dtype)
                launch(libs[name], name, pyr, cents, weight, bias, r, outs[name], wb)
            torch.cuda.synchronize()
            err = (outs["shipped"].float() - want.float()).abs().max().item()
            tol = chip_smoke.k1_tolerance(want, storage, proj)
            if not err <= tol:
                raise AssertionError(f"{form} at {shape_name}: max_abs_err {err:.3e} over {tol:.3e}")
            bit_equal = torch.equal(outs["shipped"], outs["lowp_earlier"])
            if not bf16 and not bit_equal:
                raise AssertionError(f"{form} at {shape_name}: not bit-equal to the earlier form")
            times = {name: [] for name in ("shipped", "lowp_earlier")}
            for _ in range(2):
                for name in ("shipped", "lowp_earlier"):
                    times[name].append(chip_smoke.cuda_ms(
                        lambda: launch(libs[name], name, pyr, cents, weight, bias, r, outs[name], wb)))
            for name in LOWP_ABLATIONS:
                times[name] = [chip_smoke.cuda_ms(
                    lambda: launch(libs[name], name, pyr, cents, weight, bias, r, outs[name], wb))]
            times["plain"] = [chip_smoke.cuda_ms(
                lambda: lx.lookup_project_reference(pyr, cents, weight, bias, r, proj))]
            times["library_chain"] = [chip_smoke.cuda_ms(
                lambda: chip_smoke.k1_library_chain(pyr, cents, weight, bias, r, scales, proj or torch.float32))]
            windows = chip_smoke.window_bytes(pyr, cents, r)
            nbytes = (windows + cents.numel() * 4 + (scales.numel() * 4 if scales is not None else 0)
                      + (weight.numel() + bias.numel()) * 4 + q * c_out * (2 if bf16 else 4))
            gemm = 2.0 * q * c_in * c_out
            other = 2.0 * q * c_out + 11.0 * q * c_in
            bnd = (chip_smoke.bound(nbytes, other, bf16_ops=gemm) if bf16
                   else chip_smoke.bound(nbytes, other, tf32_ops=3.0 * gemm))
            print(f"{shape_name} {form}: Q={q} C_in={c_in} C_out={c_out} max_abs_err {err:.3e} (tol {tol:.3e}), "
                  f"bit-equal to the earlier form: {bit_equal}; bound {bnd[0]:.4f} ms by {bnd[1]}", flush=True)
            for name, ts in times.items():
                print(f"    {name:20s} " + " ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)
            rows[f"{shape_name}/{form}"] = dict(times, bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err,
                                                bit_equal_earlier=bit_equal)
    return rows


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
    fp32_libs = {n: lib for n, lib in libs.items() if n in FP32_ABLATIONS or n in ("fp32_fma", "lowp_earlier")}
    for shape_name, kw in SHAPES.items():
        r = kw.get("radius", chip_smoke.RADIUS)
        pyr, cents, weight, bias = chip_smoke.kernel_inputs(dev, **kw)
        want = lx.lookup_project_reference(pyr, cents, weight, bias, r)
        out = torch.empty(want.shape, device=dev)  # NCHW; the plain version's result is a permuted view
        errs = {}
        for name, lib in fp32_libs.items():
            launch(lib, name, pyr, cents, weight, bias, r, out)
            torch.cuda.synchronize()
            errs[name] = (out - want).abs().max().item()
        times = {name: [] for name in ["plain", "library_chain", *fp32_libs]}
        for _ in range(2):
            times["plain"].append(chip_smoke.cuda_ms(
                lambda: lx.lookup_project_reference(pyr, cents, weight, bias, r)))
            times["library_chain"].append(chip_smoke.cuda_ms(
                lambda: chip_smoke.k1_library_chain(pyr, cents, weight, bias, r)))
            for name, lib in fp32_libs.items():
                times[name].append(chip_smoke.cuda_ms(lambda: launch(lib, name, pyr, cents, weight, bias, r, out)))
        print(f"{shape_name} {kw}:", flush=True)
        for name, ts in times.items():
            err = f"  max_abs_err vs plain {errs[name]:.3e}" if name in errs else ""
            print(f"  {name:13s} {ts[0]:.4f} {ts[1]:.4f} ms{err}", flush=True)
        result[shape_name] = times
    result["reduced_precision"] = lowp_rows(libs, dev)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
