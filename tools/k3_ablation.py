#!/usr/bin/env python3
"""Where K3's time goes: its two forms, the earlier form and ablations of
``raft_tpu_torch/kernels/csrc/corr_pyramid.cu`` timed on the card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 tools/k3_ablation.py

Each ablation is a text edit of the kernel's source that takes away one part
of its work; most of them give a wrong answer on purpose. All are built with
the package's nvcc flags (one nvcc each, started together, into the
git-ignored ``_build/ablation/``) and timed in one process at the raft_small
and raft_large Sintel shapes, each twice in turns, beside the plain matmul +
avg_pool2d chain and the card's bound (``chip_smoke.bound``).

Both storage types at 4 levels (the Hopper form: split pre-pass, TMA ring,
wgmma, shared-memory epilogue):

  shipped            the kernel as it ships
  earlier            the mma.sync form that ran 4-level pyramids before
                     (tools/k3_pr4_corr_pyramid.cu)
  prepass            the split pre-pass alone
  hopper_main_only   the main kernel alone, over the workspace as it stands
  mainloop_only      the TMA ring and the products, no epilogue
  loads_only         the TMA ring alone
  no_stores          the epilogue's shared-memory passes, no level written
  no_level0_stores   level 0 not written
  no_pooled_stores   levels 1..L-1 not written
  hopper_no_wgmma    the TMA ring and the epilogue, no tensor-core product

First, at 5 and 6 levels (the mma.sync form), the shipped and the earlier
form must give bit-equal outputs (finite inputs, both storage types): the
split's NaN repair leaves every other value as it was; both are timed, in
turns.

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
from raft_tpu_torch.kernels.corr_pallas import _workspace_bytes, level_dims, volume_pyramid_reference  # noqa: E402

SHAPES = {"raft_small_sintel": (1, 128, 55, 128, 4), "raft_large_sintel": (1, 256, 55, 128, 4)}
MMA_SYNC_SHAPES = [(1, 32, 40, 48, 5), (1, 32, 64, 96, 6)]  # tests/test_torch_cuda.py five_levels, six_levels
EARLIER_SOURCE = ROOT / "tools" / "k3_pr4_corr_pyramid.cu"

_STORE0 = "        if (t < nq && y < g.h && x < g.w)\n          store4("
_STORE_L = "if (t < nq && yl < hl && xl < wl) store_val(out"
# the Hopper form
_WGMMA3 = ("      wgmma_tf32(acc, a_lo + 2 * kk, b_hi + 2 * kk);\n"
           "      wgmma_tf32(acc, a_hi + 2 * kk, b_lo + 2 * kk);\n"
           "      wgmma_tf32(acc, a_hi + 2 * kk, b_hi + 2 * kk);\n")
_HSPLIT = "  int err = launch_split(f1, f2, ws, g, b, stream);"
_HEPI = "  // the ring becomes the epilogue tile once both warpgroups are done with it\n"
_HEPI_END = "  store_levels<kHBM, kHBN, kHLdt, OutT>(tile, lv, g, b, q0, min(kHBM, g.q - q0), y0, x0, tid, sync);\n"
# never true at run time, unknown to the compiler: the products stay, the epilogue goes
_NO_EPILOGUE = [(_HEPI, "  if (acc[0] == 1234.5f && acc[63] == 1.f) {\n"), (_HEPI_END, _HEPI_END + "  }\n")]

_NO_L0 = [(_STORE0, _STORE0.replace("t < nq", "t < 0"))]
_NO_POOLED = [(_STORE_L, _STORE_L.replace("t < nq", "t < 0"))]
ABLATIONS = {
    "shipped": [],
    "prepass": [(_HSPLIT + "\n  if (err != 0) return err;", _HSPLIT + "\n  return err;")],
    "hopper_main_only": [(_HSPLIT, "  int err = 0;")],
    "mainloop_only": _NO_EPILOGUE,
    "loads_only": _NO_EPILOGUE + [(_WGMMA3, "")],
    "no_stores": _NO_L0 + _NO_POOLED,
    "no_level0_stores": _NO_L0,
    "no_pooled_stores": _NO_POOLED,
    "hopper_no_wgmma": [(_WGMMA3, "")],
}
RUNS = ["shipped", "earlier", *[n for n in ABLATIONS if n != "shipped"]]


def build_ablations(out_dir: Path):
    """One shared library per ablation and one of the earlier form; raises
    if an edit no longer matches the source or nvcc fails."""
    source = (build.CSRC / "corr_pyramid.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    texts = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"ablation {name}: the source no longer has {old!r} once")
            text = text.replace(old, new)
        texts[name] = text
    texts["earlier"] = EARLIER_SOURCE.read_text()
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for ablation {name}:\n{log}")
        print(f"{name}: {chip_smoke.ptxas_usage(log, 'corr_pyramid')}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        args = [ptr, ptr, ctypes.POINTER(ptr), i32, i32, i32, i32, i32, f32, i32]
        if name != "earlier":  # the earlier form takes no workspace
            args += [ptr, ctypes.c_longlong]
        lib.corr_pyramid_launch.argtypes = args + [ptr]
        lib.corr_pyramid_launch.restype = i32
        libs[name] = lib
    return libs


def launch(lib, name, f1, f2, levels, outs, ws):
    b, c, h, w = f1.shape
    ptrs = (ctypes.c_void_p * levels)(*[o.data_ptr() for o in outs])
    args = [f1.data_ptr(), f2.data_ptr(), ptrs, b, c, h, w, levels, 1.0 / math.sqrt(c),
            int(outs[0].dtype == torch.bfloat16)]
    if name != "earlier":
        args += [ws.data_ptr(), ws.numel() * 4] if ws is not None else [None, 0]
    rc = lib.corr_pyramid_launch(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {rc}")


def bf16_ulps(got, want) -> float:
    """The worst cell's distance beyond the fp32 tolerance, in bf16 ulps of
    the larger of the two (chip_smoke.volume_bf16_phase's measure)."""
    return max(((g.float() - w.float()).abs() - chip_smoke.VOLUME_TOL).clamp(min=0).div(
        (torch.maximum(g.float().abs(), w.float().abs()) * 2.0**-7).clamp(min=1e-30)).max().item()
        for g, w in zip(got, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_ablation: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build_ablations(build.BUILD_DIR / "ablation")
    dev = torch.device("cuda")
    result = {"card": card}
    # 5-6 levels still run the mma.sync form: its split now keeps NaN, and
    # leaves finite outputs bit-equal to the earlier form's
    for b, c, h, w, levels in MMA_SYNC_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(3)
        f1 = torch.randn(b, c, h, w, device=dev, generator=gen)
        f2 = torch.randn(b, c, h, w, device=dev, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            dims = level_dims(h, w, levels)
            outs = {name: [torch.empty((b * h * w, hl, wl), device=dev, dtype=dtype) for hl, wl in dims]
                    for name in ("shipped", "earlier")}
            for name, o in outs.items():
                launch(libs[name], name, f1, f2, levels, o, None)
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(outs["shipped"], outs["earlier"]))
            ms = {name: [] for name in outs}
            for name in ("earlier", "shipped", "shipped", "earlier"):
                ms[name].append(chip_smoke.cuda_ms(lambda: launch(libs[name], name, f1, f2, levels, outs[name], None)))
            print(f"mma.sync form, {(b, c, h, w, levels)} {dtype}: bit-equal to the earlier form: {same}; "
                  f"ms shipped {ms['shipped']}, earlier {ms['earlier']}", flush=True)
            if not same:
                raise AssertionError("the mma.sync form's finite outputs changed")
            result[f"mma_sync_{levels}_levels_{'bf16' if dtype == torch.bfloat16 else 'fp32'}"] = ms
    for shape_name, (b, c, h, w, levels) in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(3)
        f1 = torch.randn(b, c, h, w, device=dev, generator=gen)
        f2 = torch.randn(b, c, h, w, device=dev, generator=gen)
        ws = torch.empty(_workspace_bytes(b, c, h, w, levels) // 4, device=dev)
        q = h * w
        gemm = 2.0 * b * q * q * c
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "fp32"
            want = volume_pyramid_reference(f1, f2, levels, dtype)
            outs = {name: [torch.empty((b * q, hl, wl), device=dev, dtype=dtype) for hl, wl in level_dims(h, w, levels)]
                    for name in RUNS}
            errs = {}
            for name in RUNS:
                launch(libs[name], name, f1, f2, levels, outs[name], ws)
                torch.cuda.synchronize()
                if name != "prepass":
                    errs[name] = (bf16_ulps(outs[name], want) if tag == "bf16"
                                  else max((o - w_).abs().max().item() for o, w_ in zip(outs[name], want)))
            times = {name: [] for name in ["chain", *RUNS]}
            order = [*RUNS, *reversed(RUNS)]
            for i in range(2):
                times["chain"].append(chip_smoke.cuda_ms(lambda: volume_pyramid_reference(f1, f2, levels, dtype)))
                for name in order[i * len(RUNS):(i + 1) * len(RUNS)]:
                    times[name].append(chip_smoke.cuda_ms(
                        lambda: launch(libs[name], name, f1, f2, levels, outs[name], ws)))
            nbytes = 2 * b * c * q * 4 + sum(b * q * o.shape[1] * o.shape[2] * o.element_size() for o in want)
            pool_ops = sum(4.0 * b * q * o.shape[1] * o.shape[2] for o in want[1:])
            bnd = chip_smoke.bound(nbytes, pool_ops, tf32_ops=3.0 * gemm)
            print(f"{shape_name} {(b, c, h, w, levels)} {tag} levels: bound {bnd[0]:.4f} ms by {bnd[1]}", flush=True)
            for name, ts in times.items():
                if name in ("chain", "prepass"):
                    err = ""
                elif tag == "bf16":
                    err = f"  worst cell {errs[name]:.3f} bf16 ulp beyond the fp32 tolerance"
                else:
                    err = f"  max_abs_err vs plain {errs[name]:.3e}"
                print(f"  {name:17s} {ts[0]:.4f} {ts[1]:.4f} ms{err}", flush=True)
            result[f"{shape_name}_{tag}"] = dict(times, bound_ms=bnd[0], bound_by=bnd[1])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
