#!/usr/bin/env python3
"""Where K2's and K4's time goes: their shipped form against the earlier
ones, and ablations of ``raft_tpu_torch/kernels/csrc/lookup_xtap.cu``, timed
on the card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 tools/k2_ablation.py

K2 (``xtap_lookup_launch``) in its three forms (fp32, bf16 and int8 levels)
and K4 (``lookup_dense_launch``, K2's fp32 form at K4's radii) are timed at
raft_large Sintel (Q = 7040, r 4, 4 levels), raft_small (r 3) and batch 8
(Q = 56320), each in turns with its earlier form in one process (earlier,
shipped, shipped, earlier): K2's ``tools/k2_pr6_lookup_xtap.cu`` (32-query
tiles, four scalar loads a tap, element stores) and K4's
``tools/k4_pr2_lookup_dense.cu`` (a warp a (query, level), y-pass then
x-pass). Beside them the plain version, the ``grid_sample`` chain and the
card's bound (``chip_smoke.bound``: the window cells the taps touch, the
centroids and scales read once, the taps written once).

The script raises, after every row is printed, unless the shipped bf16
and int8 forms are bit-equal to the earlier K2 on every finite output with
NaN in the same cells (also on NaN centroids), and unless every form is
within its tolerance of the plain version; for the fp32 forms it reports
whether they are bit-equal to the earlier K2 and the largest difference
from it and from the earlier K4.

Ablations of the shipped form, each a text edit of the source (most give a
wrong answer on purpose), built with the package's nvcc flags into the
git-ignored ``_build/ablation_k2/``:

  no_window_copy  the windows are not copied (the taps read whatever the
                  shared memory holds)
  no_taps         the windows are copied and waited for, the taps are not
                  formed (each tap is the centroid's x)
  no_stores       nothing is written to device memory
  copies_only     no_taps and no_stores: the table and the window copies
  empty           every block returns at once: the launch and the blocks'
                  start and end alone
  queries16       blocks of 16 queries and 256 threads, four an SM (the
                  plan's first choice: 8 queries, 128 threads, eight an SM)

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
    "raft_small_sintel": dict(b=1, h=55, w=128, radius=3, c_out=96),
    "raft_large_batch8": dict(b=8, h=55, w=128),
}
FORMS = ("fp32", "bf16", "int8", "k4")

_COPY = ("        copy_window<T>(win + ((li << g.nq_log2) + t) * wbytes, pyr, l, q0 + t, __float_as_int(wd.x),\n"
         "                       __float_as_int(wd.y), s1, rb, row_chunks, packed, cl);\n")
_WALK = "      walk_row<kS, T>(w, rb, ph, wle, x0, xs, ys, wd.z, wd.w, kind, mul, radius, j, dst, s);\n"
_NO_WALK = "      for (int x = 0; x < s; ++x) store_val(dst + x * s + j, wd.z);\n"
_STORES = """    if (nl == n_levels) {
      store_span(span, rows, nq * c_all);  // the block's queries: one span
    } else {
      for (int t = 0; t < nq; ++t) store_span(span + t * c_all, rows + t * g.pitch, nl * ss);
    }
"""
_BLOCK = ("constexpr int kTapsThreads = 128;\nconstexpr int kTapsWarps = kTapsThreads / 32;\n"
          "constexpr int kTapsQueries = 8;  // a power of two, as every plan's\nconstexpr int kTapsBlocksPerSm = 8;")
_TABLE = "  taps_table(pyr, cents, q0, nq, g.nq_log2, radius, at);\n"


# name -> [(old, new, occurrences)]
ABLATIONS = {
    "shipped": [],
    "no_window_copy": [(_COPY, "        (void)wd;\n        (void)packed;\n", 1)],
    "no_taps": [(_WALK, _NO_WALK, 1)],
    "no_stores": [(_STORES, "    (void)rows;\n", 1)],
    "copies_only": [(_WALK, _NO_WALK, 1), (_STORES, "    (void)rows;\n", 1)],
    "empty": [(_TABLE, "  if (nq > 0) return;\n" + _TABLE, 1)],
    "queries16": [(_BLOCK, _BLOCK.replace("= 128;", "= 256;").replace("= 8;  //", "= 16;  //")
                   .replace("PerSm = 8;", "PerSm = 4;"), 1)],
}
EARLIER = {"k2_earlier": ROOT / "tools" / "k2_pr6_lookup_xtap.cu", "k4_earlier": ROOT / "tools" / "k4_pr2_lookup_dense.cu"}


def build_libs(out_dir: Path):
    """One shared library per ablation and one per earlier source; raises
    if an edit no longer matches the source or nvcc fails."""
    source = (build.CSRC / "lookup_xtap.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, edits in ABLATIONS.items():
        text = source
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"ablation {name}: the source no longer has {old!r} {count} times")
            text = text.replace(old, new)
        texts[name] = text
    for name, path in EARLIER.items():
        texts[name] = path.read_text()
    nvcc = build.find_nvcc()
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [nvcc, *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    levels_t, ints_t = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernel = "lookup_dense_kernel" if name == "k4_earlier" else "xtap_lookup_kernel"
        print(f"{name}: {chip_smoke.ptxas_usage(log, kernel)}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        if name != "k4_earlier":
            lib.xtap_lookup_launch.argtypes = [levels_t, ints_t, ints_t, ints_t, i32, i32, ptr, ptr, ptr, i64, i32, ptr]
            lib.xtap_lookup_launch.restype = i32
        if name != "k2_earlier":
            lib.lookup_dense_launch.argtypes = [levels_t, ints_t, ints_t, i32, ptr, ptr, i64, i32, ptr]
            lib.lookup_dense_launch.restype = i32
        libs[name] = lib
    return libs


def launch(lib, k4, pyr, cents, radius, out):
    q = cents.shape[0] * cents.shape[1] * cents.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    args = lx._pyramid_args(pyr, radius)
    if k4:
        rc = lib.lookup_dense_launch(*args[:3], args[4], cents.data_ptr(), out.data_ptr(), q, radius, stream)
    else:
        rc = lib.xtap_lookup_launch(*args, cents.data_ptr(), out.data_ptr(), q, radius, stream)
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError_t {rc}")


def same_bits(a, b) -> bool:
    """Equal bit for bit on every cell finite in both, NaN in the same cells."""
    fin = a.isfinite() & b.isfinite()
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a[fin], b[fin])


def form_inputs(pyr32, form):
    return pyr32 if form in ("fp32", "k4") else chip_smoke.lowp_pyramid(pyr32, form)


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ablation: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = build_libs(build.BUILD_DIR / "ablation_k2")
    dev = torch.device("cuda")
    result = {"card": card}
    failures = []
    for shape_name, kw in SHAPES.items():
        r = kw.get("radius", chip_smoke.RADIUS)
        pyr32, cents, _, _ = chip_smoke.kernel_inputs(dev, **kw)
        nan_cents = cents.clone()
        nan_cents[0, 0, :8] = float("nan")
        nan_cents[0, -1, -1, 1] = float("nan")
        q = cents.shape[0] * cents.shape[1] * cents.shape[2]
        c_in = len(pyr32) * (2 * r + 1) ** 2
        reps = 5 if q > 10000 else 20
        for form in FORMS:
            k4 = form == "k4"
            pyr = form_inputs(pyr32, form)
            scales = getattr(pyr, "scales", None)
            dtype = torch.float32 if form in ("fp32", "k4") else torch.bfloat16
            earlier = "k4_earlier" if k4 else "k2_earlier"
            outs = {}
            for name in ("shipped", earlier, *[a for a in ABLATIONS if a != "shipped"]):
                outs[name] = torch.empty(q, c_in, device=dev, dtype=dtype)
                launch(libs[name], k4, pyr, cents, r, outs[name])
            torch.cuda.synchronize()
            want = lx.lookup_pyramid_reference(pyr, cents, r).reshape(q, c_in)
            err = (outs["shipped"].float() - want.float()).abs().max().item()
            tol = chip_smoke.LOOKUP_TOL if dtype == torch.float32 else chip_smoke.bf16_ulps(want)
            if not err <= tol:
                failures.append(f"{form} at {shape_name}: max_abs_err {err:.3e} over {tol:.3e}")
            for name in ("queries16",):
                if not same_bits(outs[name], outs["shipped"]):
                    failures.append(f"{name} at {shape_name} {form}: not the shipped form's taps")
            bit_equal = same_bits(outs["shipped"], outs[earlier])
            diff = (outs["shipped"].float() - outs[earlier].float()).abs().max().item()
            # the same on NaN centroids, against the earlier K2 (K4's earlier form gives NaN alike)
            nan_out = {n: torch.empty(q, c_in, device=dev, dtype=dtype) for n in ("shipped", earlier)}
            for n in nan_out:
                launch(libs[n], k4, pyr, nan_cents, r, nan_out[n])
            torch.cuda.synchronize()
            nan_equal = same_bits(nan_out["shipped"], nan_out[earlier])
            nan_plain = torch.equal(nan_out["shipped"].isnan(),
                                    lx.lookup_pyramid_reference(pyr, nan_cents, r).reshape(q, c_in).isnan())
            if not nan_plain:
                failures.append(f"{form} at {shape_name}: NaN taps not where the plain version has them")
            if form in ("bf16", "int8") and not (bit_equal and nan_equal):
                failures.append(f"{form} at {shape_name}: not bit-equal to the earlier K2 "
                                f"(max diff {diff:.3e}, NaN centroids {nan_equal})")
            times = {name: [] for name in ("shipped", earlier)}
            for order in ((earlier, "shipped"), ("shipped", earlier)):
                for name in order:
                    times[name].append(chip_smoke.cuda_ms(
                        lambda: launch(libs[name], k4, pyr, cents, r, outs[name])))
            for name in ABLATIONS:
                if name != "shipped":
                    times[name] = [chip_smoke.cuda_ms(lambda: launch(libs[name], k4, pyr, cents, r, outs[name]))]
            times["plain"] = [chip_smoke.cuda_ms(lambda: lx.lookup_pyramid_reference(pyr, cents, r), reps=reps)]
            times["library_chain"] = [chip_smoke.cuda_ms(
                lambda: chip_smoke.k2_library_chain(pyr, cents, r, scales), reps=reps)]
            nbytes = (chip_smoke.window_bytes(pyr, cents, r) + cents.numel() * 4
                      + (scales.numel() * 4 if scales is not None else 0) + q * c_in * outs["shipped"].element_size())
            bnd = chip_smoke.bound(nbytes, 11.0 * q * c_in)
            plan = lx._taps_plan(len(pyr), r, pyr[0].element_size(), k4)
            print(f"{shape_name} {form}: Q={q} C={c_in} plan nq={plan['nq']} smem={plan['smem']} B; "
                  f"max_abs_err vs plain {err:.3e} (tol {tol:.3e}); vs {earlier}: bit-equal {bit_equal}, "
                  f"max diff {diff:.3e}, NaN centroids bit-equal {nan_equal}; bound {bnd[0]:.4f} ms by {bnd[1]}",
                  flush=True)
            for name, ts in times.items():
                print(f"    {name:15s} " + " ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)
            shipped = sum(times["shipped"]) / 2
            print(f"    share of bound {bnd[0] / shipped:.3f}; earlier {bnd[0] / (sum(times[earlier]) / 2):.3f}",
                  flush=True)
            result[f"{shape_name}/{form}"] = dict(times, bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err,
                                                  bit_equal_earlier=bit_equal, max_diff_earlier=diff,
                                                  nan_bit_equal_earlier=nan_equal)
    print(json.dumps(result))
    if failures:
        raise AssertionError("; ".join(failures))
    return 0


if __name__ == "__main__":
    sys.exit(main())
