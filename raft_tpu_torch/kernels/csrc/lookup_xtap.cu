// Multi-scale correlation lookup, with and without the fused convcorr1
// projection, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of raft_tpu/kernels/lookup_xtap.py:
//   xtap_project_kernel <- _xtap_project_kernel (K1, line 412): lookup +
//       relu(taps @ W^T + b), one launch per refinement step;
//   xtap_lookup_kernel  <- _xtap_kernel (K2, line 385): the taps alone;
// and, by the same xtap_lookup_kernel on fp32 levels behind a launcher of
// its own (lookup_dense_launch), that of raft_tpu/kernels/lookup_pallas.py:
//   _kernel (K4, line 50), the separable lookup of lookup_pyramid_pallas,
//       the same taps as K2's fp32 form at K4's wider radii.
//
// What it computes, for query q (Q = B*h*w), level l, x-offset i and
// y-offset j (S = 2r+1):
//   taps[q, l*S*S + i*S + j] = bilinear sample of level l (q, hl, wl) at
//       (cx/2^l + i - r, cy/2^l + j - r), each corner zero outside the grid.
// This equals the separable relu(1-|pos-k|) weights of the plain version
// (raft_tpu_torch/models/corr.py lookup_pyramid).
//
// What bounds it on an H100 (raft_large at Sintel 440x1024: Q = 7040,
// L = 4, r = 4, C_in = 324, C_out = 256, fp32):
//   K1: the product, 2*Q*C_in*C_out = 1.17 GFLOP, runs on the tensor cores
//       as 3xTF32 (three TF32 products per fp32 product, below): 3.50 GFLOP,
//       7.1 us at 495 TFLOP/s. The interpolation (11 operations a tap) and
//       bias + relu are 0.03 GFLOP of fp32, 0.4 us at 67 TFLOP/s. The bytes
//       are the (S+1)^2 windows the taps touch (~11 MB), W, bias and
//       centroids (0.4 MB) and the 7.2 MB output: 19 MB, 5.6 us at
//       3.35 TB/s. So operations bound it, at ~7.5 us; on the fp32 FMA
//       units the product alone would take 17.9 us.
//   K2 (and K4): the same 11 MB of windows plus a 9 MB tap output, 6 us:
//       bytes bound it; the interpolation arithmetic is negligible. Its
//       windows' rows are 40-byte runs (fp32) scattered over the levels,
//       two or three 32-byte sectors each.
//
// K1's design (xtap_project_kernel), against the faults of the fp32-FMA
// form it replaces (a thread per output channel paced by shared-memory
// broadcasts, a gather of 4 scattered corners a tap with nothing in flight,
// the whole weight re-read by scalar loads in every block, and NCHW stores
// 32 rows apart in a warp):
//   * a block owns BM = 32 queries x BN = 256 output channels (grid.y walks
//     larger C_out), 8 warps of 32 x 32; 106 KB of shared memory and 87
//     registers a thread at raft_large, so two blocks share an SM. At
//     Sintel the grid is 220 blocks: one wave on 132 SMs. (The two blocks
//     of an SM start together, so their phases mostly line up rather than
//     overlap: tools/k1_ablation.py.)
//   * the gather reads each window once: the offsets are integers, so the
//     S^2 taps of one (query, level) share the fraction (fx, fy) of the
//     centroid and are the bilinear samples of one (S+1) x (S+1) window.
//     Every (query, level)'s window origin and fraction is worked out
//     first, one thread each (one centroid load latency a block); then
//     the windows' rows are copied into shared memory by cp.async, 4
//     bytes a lane, neighbouring lanes on neighbouring columns,
//     zero-filled (src-size 0) outside the level: every copy of the block
//     is in flight at once, no load waits on another. The taps are then formed from the window with
//     sample_zero_pad's corner sum order and written to the A tile
//     [query][k] (k = l*S*S + i*S + j), whose row pitch, K padded to a
//     multiple of 8 plus 4 floats, is 4 (mod 8) floats, so the mma.sync
//     fragment loads (lane -> m = lane / 4, k = lane % 4) hit 32 distinct
//     banks. K's padding columns are zeroed in shared memory; nothing is
//     padded in device memory. Levels are gathered in passes of as many
//     windows as the region holds (all four at raft_large).
//   * the product as 3xTF32 on the tensor cores, K3's arithmetic
//     (csrc/corr_pyramid.cu): each operand split once per fragment load into
//     hi = tf32(x) and lo = tf32(x - hi), lo*hi + hi*lo then hi*hi into fp32
//     accumulators by mma.sync m16n8k8. A single TF32 pass would miss
//     PROJECT_TOL = 1e-4 by ~20x at these shapes.
//   * W (C_out, C_in) is row-major [n][k], the "col" layout mma.sync wants
//     for B; its K slices of 16 columns are staged by cp.async in a 3-stage
//     ring over the window region (16-byte copies when C_in % 4 == 0, else
//     4-byte, zero-filled past C_in and C_out), rows padded to 20 floats,
//     4 (mod 8): conflict-free B fragments. One __syncthreads a slice.
//   * the epilogue adds the bias, applies relu and stages the block's
//     result channel-major in the ring's memory (rows of 36 floats, so the
//     fragment-layout stores hit 32 banks), then writes NCHW rows: a warp
//     writes contiguous p of one channel, float4 stores when h*w % 4 == 0.
//     Ragged Q and C_out are masked, and a tile that crosses a batch
//     boundary splits at it.
//   * NaN centroids give NaN taps (their fraction is NaN), stored in the A
//     tile as 0x7fc00000 (store_tap) so the TF32 split keeps them NaN, and
//     a NaN output stays NaN through the relu (relu_nan), as torch.relu and
//     the JAX kernel keep it; far-off centroids are clamped just outside
//     the level, as K2 clamps them.
//
// K2's design (xtap_lookup_kernel, also K4's), against the faults of the
// form it replaces (tools/k2_pr6_lookup_xtap.cu: 32-query tiles, 1.7 blocks
// an SM at Sintel, each tap four scalar loads straight from the level, 3.2x
// the loads the windows need, a floor and clamp a tap, the tile stored
// element by element):
//   * a block of 128 threads takes 8 consecutive queries, eight blocks an
//     SM (21 KB of shared memory at raft_large bf16 / int8; 4 queries and
//     18 KB at fp32, whose window rows take 80 bytes): 880-1760 blocks at
//     raft_large Sintel, all resident at once. The kernel is instantiated
//     for S = 7 and 9 (and any S), so its index arithmetic folds to
//     constants and shifts (queries a block are a power of two): at these
//     shapes the block's own arithmetic, not the memory, set the pace of the
//     first designs (tools/k2_ablation.py). taps_plan (mirrored by
//     _taps_plan in kernels/lookup_xtap.py) takes fewer queries, or the
//     levels in passes, where a shape needs more shared memory; every shape
//     the entry points take fits one query and one level a pass.
//   * each (query, level)'s window of (S+1)^2 cells is copied once into
//     shared memory at storage width, every copy of the block in flight at
//     once, one cp.async group a level: 16-byte cp.async.cg chunks aligned
//     down from each row's first cell (K1's chunked copy,
//     gather_windows_lowp, at 16 bytes: per-row phase, the cells before
//     x = 0 masked, no read past the tensor), rows an odd number of chunks
//     apart; a level that does not start 16-byte aligned cell by cell (fp32
//     by 4-byte cp.async, bf16 / int8 through registers), so any address is
//     taken.
//   * taps by a row walk, in rounds as the levels land: a lane a tap row of
//     a window, walking its columns over window rows j and j+1, so each
//     row's fraction and y-weights are worked out once and each y-dot row
//     value once a column, without shuffles; the taps go to a tile laid out
//     as the output, at output width (fp32, or bf16 rounded once). Each tap
//     is the earlier form's bit for bit: its fractions are the tap's own
//     ((cx + i - r) - its floor, not the window's), the flat form is
//     flat_tap (form_tap's expression with the contraction nvcc gave it),
//     the y-dot forms form_tap's roundings (tools/k2_ablation.py checks all
//     three storages).
//   * a block's queries are one contiguous span of the output: stored by
//     16-byte vectors, the head and tail up to the 16-byte boundaries
//     element by element, the tile placed alike mod 16 with its span.
// NaN centroids give NaN taps (the table's centre is NaN, so is every
// fraction); far-off centroids are clamped just outside the level.
//
// Reduced-precision forms (the has_scales / weight_dtype / mxu_dtype paths
// of raft_tpu/kernels/lookup_xtap.py, l.263-283, 380-381, 438-447), both
// kernels, chosen per launch:
//   * levels stored as fp32, bf16, or int8 with one fp32 dequantization
//     factor per level (scales, read on the card: no host sync). A value is
//     widened to fp32 exactly (bf16 -> fp32, int8 -> fp32) where a tap is
//     formed.
//   * each level's taps are formed by its kind, which the wrapper picks with
//     the JAX package's level split (_split_levels: level 0 and the larger
//     levels take the y-dot, the small ones the flat 4-corner path):
//       flat: the bilinear sum with fp32 weights on the widened values,
//         times the level's scale for int8;
//       y-dot bf16: the y-weights relu(1 - |(cy + j - r) - y|) rounded to
//         bf16, each tap row sum_y wy * v summed in fp32 and rounded to bf16
//         (RNE), then the fp32 x-combine (1 - fx) row[x0] + fx row[x0 + 1];
//       y-dot int8: the y-weights quantized as round(127 wy), the row an
//         exact integer dot, times scale * (1/127) in fp32 (no bf16
//         rounding), then the same x-combine.
//     fp32 levels take the flat form at every level (the two are the same
//     function up to fp32 rounding).
//   * K2 writes bf16 taps (RNE) when the levels are bf16 or int8 (the JAX
//     kernel's weight_dtype output), else fp32.
//   * K1's product at bf16 (proj_dtype): taps rounded to bf16 (RNE) once,
//     as they are formed, times the wrapper's bf16 copy of W, fp32 sums;
//     the bias is added in fp32, relu, and the result stored as bf16. At
//     fp32 the product stays 3xTF32 whatever the levels' storage.
//
// K1's reduced-precision design, against the faults of the form it replaces
// (each window cell a blocking load widened to fp32, the weight ring loaded
// only after the gather, the bf16 product one TF32 pass over fp32 operands
// rounded at every fragment load; tools/k1_lowp_pr6_lookup_xtap.cu):
//   * bf16 / int8 windows go to shared memory at their storage width by
//     4-byte cp.async: a window row of S+1 cells is covered by row_words
//     words aligned down from its first cell's address, so at most
//     ceil((S*elem + 4) / 4) (6 for bf16, 4 for int8 at r 4). A level's row
//     starts q*hl*wl + y*wl elements in, so its phase (address mod 4)
//     changes from row to row when wl*elem % 4 != 0 (int8 widths 39, 78,
//     bf16 width 13): each row keeps its own phase, worked out again where
//     the taps read it. A chunk wholly outside the row's in-range cells is
//     zero-filled (src-size 0); one that runs past the row's last in-range
//     cell copies only up to it (the hardware zero-fills the rest), so no
//     copy reads past the tensor; one that straddles the row's first
//     in-range cell copies from its aligned start, in the tensor because
//     the level starts 4-byte aligned, and the cells it brings from before
//     x = 0 (the neighbouring row's) are masked to zero where the taps are
//     formed. The taps are formed from the widened cells exactly as before.
//   * those windows take a region of their own past the first `prefetch`
//     stages of the weight ring. They are copied one cp.async group a level;
//     the ring's first slices are issued after the first pass's windows, so
//     they are in flight while the taps are formed and the gather never
//     waits for them; taps are formed in rounds, each waiting only for the
//     levels it reads. Shared memory decides how many slices: two blocks an
//     SM hold at most 113 KB each, so at raft_large the 3xTF32 forms, whose
//     A tile and ring stay fp32, keep one slice in flight on bf16 levels
//     (30 KB of windows over the ring's last two stages) and two on int8
//     levels (20 KB over its last); the bf16 product, with a bf16 A tile
//     (22 KB) and a bf16 ring of 4 stages of 20 KB, keeps two and three.
//     project_smem takes all levels in one pass first, then the most
//     slices, two blocks an SM before one.
//   * taps are formed by a column walk: S+1 lanes a window, lane x reading
//     window column x row by row and taking column x+1's value from the
//     next lane by shuffle, so each y-dot row value is formed once (not
//     once a tap), and each tap row's y-weights once, by one lane, then
//     shuffled; the loop is unrolled for S = 7 and 9.
//   * the bf16 product: the A tile holds bf16 taps (rows of k_pad + 8
//     halves, k_pad a multiple of 16: 4 (mod 8) words, conflict-free
//     fragment loads), the ring bf16 slices of 32 columns (rows of 20
//     words) copied 16 bytes at a time from the wrapper's zero-padded
//     (C_out, k_pad) bf16 copy of W, and mma.sync m16n8k16 bf16 with fp32
//     accumulators, at twice the TF32 rate and without a conversion at a
//     fragment load. The epilogue is the fp32 form's.
//   * NaN taps and outputs as in the fp32 form.
// What bounds them: the same operations as the fp32 forms (the bf16
// product at the bf16 rate), and fewer bytes of windows (2x fewer for bf16,
// 4x for int8) and, for bf16 outputs, half the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kMaxLevels = 8;
constexpr size_t kMaxSmem = 232448;  // bytes one block may use on sm_90

// K1: block tile BM queries x BN channels of warp tiles WM x WN, weight
// slices of KC columns in a ring of kStages
constexpr int kBM = 32;
constexpr int kBN = 256;
constexpr int kWM = 32;
constexpr int kWN = 32;
constexpr int kWarpsM = kBM / kWM;
constexpr int kProjWarps = kWarpsM * (kBN / kWN);
constexpr int kProjThreads = 32 * kProjWarps;
constexpr int kProjBlocksPerSm = kProjWarps <= 8 ? 2 : 1;
constexpr int kMf = kWM / 16;  // m16 fragments a warp
constexpr int kNf = kWN / 8;   // n8 fragments a warp
constexpr int kKC = 16;
constexpr int kStages = 3;
constexpr int kLdw = kKC + 4;  // 20 = 4 (mod 8) floats: conflict-free B fragments
constexpr int kStageFloats = kBN * kLdw;
constexpr int kLdt = kBM + 4;  // epilogue row, 36 = 4 (mod 16): conflict-free stores
constexpr int kTileFloats = kBN * kLdt;
// the bf16 product's ring: slices of KCB columns as bf16 pairs, rows of 20
// words (4 mod 8: conflict-free B fragments), 4 stages
constexpr int kKCB = 32;
constexpr int kStagesB = 4;
constexpr int kLdwB = kKCB / 2 + 4;
constexpr int kStageWordsB = kBN * kLdwB;
constexpr size_t kTwoBlockSmem = 115712;  // bytes a block may use for two an SM: (228 KB - 2 x 1 KB) / 2
static_assert(kBM % kWM == 0 && kWM % 16 == 0 && kWN % 8 == 0 && kKC % 8 == 0 && kKCB % 16 == 0,
              "m16n8k8 / m16n8k16 fragments");

// K2 and K4: a block of kTapsThreads threads takes kTapsQueries queries
// where eight blocks an SM hold them (kTapsSmemShare bytes each: 228 KB / 8
// less 1 KB reserved), fewer where the shape needs more shared memory
constexpr int kTapsThreads = 128;
constexpr int kTapsWarps = kTapsThreads / 32;
constexpr int kTapsQueries = 8;  // a power of two, as every plan's
constexpr int kTapsBlocksPerSm = 8;
// bytes a K2 window chunk copies: a window row of a level that starts
// kTapsChunk-aligned goes to shared memory in chunks aligned down from its
// first cell (cp.async.cg); other levels' rows cell by cell
constexpr int kTapsChunk = 16;
constexpr size_t kTapsSmemShare = 233472 / kTapsBlocksPerSm - 1024;
// the shapes each entry point takes, those its earlier form took: K2 at
// most kK2MaxTaps taps a query (L S^2), K4 S (S + 2) at most kK4MaxSpan
constexpr int kK2MaxTaps = 1816;
constexpr int kK4MaxSpan = 7264;

// level storage (Pyramid::elem) and how a level's taps are formed (kind)
enum : int { kElemF32 = 0, kElemBf16 = 1, kElemInt8 = 2 };
enum : int { kFlat = 0, kYdotBf16 = 1, kYdotInt8 = 2 };
constexpr float kInv127 = float(1.0 / 127.0);  // the JAX package's fp32 1/127

struct Pyramid {
  const void* level[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int kind[kMaxLevels];
  const float* scales;  // int8: (num_levels,) dequantization factors; else null
  int elem;
  int num_levels;
};

// K1's shapes, worked out once on the host
struct ProjectArgs {
  int64_t q, hw;
  int radius, c_in, c_out;
  int k_pad;            // c_in rounded up to a multiple of 8 (3xTF32) or 16 (bf16 product)
  int lda;              // A tile row in elements: k_pad + 4 floats or k_pad + 8 bf16, 4 (mod 8) words
  int levels_per_pass;  // windows of this many levels fit their region
  int region;           // bytes of the ring / epilogue region (fp32 windows overlay it)
  int win_off;          // bf16 / int8 windows: bytes from the region's start, past the prefetched stages
  int row_words;        // bf16 / int8 windows: 4-byte words a window row
  int prefetch;         // weight slices issued before the gather
  int vec_w;            // 16-byte weight copies: c_in % 4 == 0, weight aligned
  int vec_out;          // float4 stores: hw % 4 == 0, out aligned
};

// ---- shared: values, taps ----------------------------------------------

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <typename T>
__device__ __forceinline__ void store_val(T* p, float v);
template <>
__device__ __forceinline__ void store_val<float>(float* p, float v) { *p = v; }
template <>
__device__ __forceinline__ void store_val<__nv_bfloat16>(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The factor a level's formed taps are scaled by: its dequantization factor
// (flat int8), that over 127 (y-dot int8, whose y-weights carry 127), else 1.
__device__ __forceinline__ float level_mul(const Pyramid& pyr, int l) {
  if (pyr.elem != kElemInt8) return 1.f;
  const float sc = __ldg(pyr.scales + l);
  return pyr.kind[l] == kYdotInt8 ? __fmul_rn(sc, kInv127) : sc;
}

// Tap (i, j) of one (query, level) from its corners (rows y0, y0+1 by
// columns x0, x0+1, zero outside the level), fx = x - x0, fy = y - y0, and
// p = the tap row's centre cy + (j - r) (y-dot kinds; y0 = floor(p)).
__device__ __forceinline__ float form_tap(int kind, float v00, float v01, float v10, float v11, float fx,
                                          float fy, float p, int y0, float mul) {
  if (kind == kFlat) {
    const float t = (1.f - fy) * ((1.f - fx) * v00 + fx * v01) + fy * ((1.f - fx) * v10 + fx * v11);
    return mul == 1.f ? t : __fmul_rn(t, mul);
  }
  // the JAX y-weights of the two rows: relu(1 - |p - y|)
  const float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(p, float(y0)))));
  const float w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(p, float(y0 + 1)))));
  float ra, rb;
  if (kind == kYdotBf16) {
    // bf16 weights times bf16 values are exact in fp32; one rounding per row
    const float b0 = bf16_round(w0);
    const float b1 = bf16_round(w1);
    ra = bf16_round(__fadd_rn(__fmul_rn(b0, v00), __fmul_rn(b1, v10)));
    rb = bf16_round(__fadd_rn(__fmul_rn(b0, v01), __fmul_rn(b1, v11)));
  } else {
    // int8 weights round(127 wy) times int8 values: an exact integer row
    const float q0 = rintf(__fmul_rn(w0, 127.f));
    const float q1 = rintf(__fmul_rn(w1, 127.f));
    ra = __fmul_rn(__fadd_rn(__fmul_rn(q0, v00), __fmul_rn(q1, v10)), mul);
    rb = __fmul_rn(__fadd_rn(__fmul_rn(q0, v01), __fmul_rn(q1, v11)), mul);
  }
  return __fadd_rn(__fmul_rn(ra, 1.f - fx), __fmul_rn(rb, fx));
}

// ---- K1: window gather, 3xTF32 product, NCHW epilogue -------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero-fill: src_bytes of 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// 4-byte cp.async of the first src_bytes (0-4) of an aligned word; the rest
// is zero-filled, and src_bytes 0 reads nothing.
__device__ __forceinline__ void cp_async4n(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

// 16-byte cp.async (L2 only) of the first src_bytes (0-16) of an aligned
// chunk; the rest is zero-filled, and src_bytes 0 reads nothing.
__device__ __forceinline__ void cp_async16n(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async.wait_group n for a count known at run time (over 10: all)
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    default: cp_async_wait<0>(); break;
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), in two integer instructions: half a TF32 ulp added to the
// bits, the 13 low mantissa bits cleared. A NaN whose high mantissa bits
// are all set (the card's 0x7fffffff) carries into the sign bit and comes
// out -0, so the A tile never holds one (store_tap).
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo + O(2^-22 x), hi and lo TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a * b, m16n8k8, TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b, m16n8k16, bf16 operands (two to a register), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: lo*hi + hi*lo, then hi*hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// Window cell of an fp32 level into shared memory by cp.async; zero outside.
__device__ __forceinline__ void copy_cell(float* dst, const float* vol, int64_t off, bool ok) {
  cp_async4(dst, ok ? vol + off : vol, ok);
}

// Each (query, level)'s window, one thread each: at[t * kMaxLevels + l]
// holds its first cell (xs, ys) as int bits, the fraction fx and the
// clamped centre y. Every centroid load of the block is in flight at once.
__device__ __forceinline__ void window_table(const Pyramid& pyr, const float* __restrict__ cents, int64_t q0,
                                             int nq, const ProjectArgs& g, float4* at) {
  for (int e = threadIdx.x; e < kBM * pyr.num_levels; e += kProjThreads) {
    const int t = e / pyr.num_levels;
    const int l = e - t * pyr.num_levels;
    int xs = 0;
    int ys = 0;
    float fx = 0.f;
    float y = 0.f;
    if (t < nq) {
      const float inv = 1.f / float(1 << l);  // exact: a power of two
      float x = __ldg(cents + 2 * (q0 + t)) * inv;
      y = __ldg(cents + 2 * (q0 + t) + 1) * inv;
      const bool nan_in = isnan(x) || isnan(y);
      // Beyond r + 1 cells outside the level every window cell is out of
      // range; the clamp keeps the float -> int conversion defined for
      // far-off centroids and changes no result.
      x = fminf(fmaxf(x, -float(g.radius + 2)), float(pyr.w[l] + g.radius + 1));
      y = fminf(fmaxf(y, -float(g.radius + 2)), float(pyr.h[l] + g.radius + 1));
      const float xf = floorf(x);
      const float yf = floorf(y);
      fx = nan_in ? nanf("") : x - xf;  // a NaN fraction makes every tap NaN
      xs = int(xf) - g.radius;
      ys = int(yf) - g.radius;
    }
    at[t * kMaxLevels + l] = make_float4(__int_as_float(xs), __int_as_float(ys), fx, y);
  }
}

// A tap into the A tile. fp32: a NaN is stored as 0x7fc00000, which
// tf32_rna keeps a NaN (the card's 0x7fffffff would carry into the sign bit
// and be split into -0s); bf16: rounded RNE.
__device__ __forceinline__ void store_tap(float* p, float v) { *p = isnan(v) ? __int_as_float(0x7fc00000) : v; }
__device__ __forceinline__ void store_tap(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Taps of the block's queries from fp32 levels into the A tile a[t * lda +
// k] (AT: fp32, or bf16 rounded RNE for the bf16 product); rows past nq and
// K's padding columns are zero. win is the window region (over the ring),
// at the table of windows (window_table).
template <typename AT>
__device__ __forceinline__ void gather_windows(const Pyramid& pyr, const float* __restrict__ cents,
                                               int64_t q0, int nq, const ProjectArgs& g, AT* a,
                                               float* win, float4* at) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = 2 * g.radius + 1;
  const int s1 = s + 1;
  const int ss = s * s;
  const int ww = s1 * s1;
  window_table(pyr, cents, q0, nq, g, at);
  __syncthreads();

  // a warp's lanes over one window: lpr lanes a row, rps rows a step
  const int lpr = min(s1, 32);
  const int rps = 32 / lpr;
  const int ry = lane / lpr;
  const int rx = lane - ry * lpr;
  const float inv_s = 1.f / float(s);
  for (int l0 = 0; l0 < pyr.num_levels; l0 += g.levels_per_pass) {
    const int nl = min(g.levels_per_pass, pyr.num_levels - l0);
    if (l0 > 0) __syncthreads();  // the last pass's windows are read
    for (int pair = warp; pair < kBM * nl; pair += kProjWarps) {
      const int t = pair / nl;
      const int l = l0 + pair - t * nl;
      if (t >= nq || ry >= rps) continue;  // a row past nq reads nothing: zero-filled below
      const float4 wd = at[t * kMaxLevels + l];
      const int xs = __float_as_int(wd.x);
      const int ys = __float_as_int(wd.y);
      const int hl = pyr.h[l];
      const int wl = pyr.w[l];
      const float* vol = static_cast<const float*>(pyr.level[l]) + (q0 + t) * int64_t(hl) * wl;
      float* dst = win + pair * ww;
      for (int yy = ry; yy < s1; yy += rps) {
        const int y = ys + yy;
        const bool row_ok = y >= 0 && y < hl;
        for (int xx = rx; xx < s1; xx += lpr) {
          const int x = xs + xx;
          const bool ok = row_ok && x >= 0 && x < wl;
          copy_cell(dst + yy * s1 + xx, vol, int64_t(y) * wl + x, ok);
        }
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // tap (i, j) is formed from window cells (x = i, i+1; y = j, j+1) by
    // the level's kind (form_tap; the flat form in form_tap's order)
    for (int pair = warp; pair < kBM * nl; pair += kProjWarps) {
      const int t = pair / nl;
      const int l = l0 + pair - t * nl;
      AT* dst = a + t * g.lda + l * ss;
      if (t >= nq) {
        for (int ij = lane; ij < ss; ij += 32) store_val(dst + ij, 0.f);
        continue;
      }
      const float4 wd = at[t * kMaxLevels + l];
      const int ys = __float_as_int(wd.y);
      const float fx = wd.z;
      const float fy = __fsub_rn(wd.w, float(ys + g.radius));  // y - floor(y)
      const int kind = pyr.kind[l];
      const float mul = level_mul(pyr, l);
      const float* w = win + pair * ww;
      for (int ij = lane; ij < ss; ij += 32) {
        const int i = int(__fmul_rn(__fadd_rn(float(ij), 0.5f), inv_s));  // ij / s, exact here
        const int j = ij - i * s;
        const float* c = w + j * s1 + i;
        if (kind == kFlat && mul == 1.f) {
          store_tap(dst + ij,
                    (1.f - fy) * ((1.f - fx) * c[0] + fx * c[1]) + fy * ((1.f - fx) * c[s1] + fx * c[s1 + 1]));
        } else {
          store_tap(dst + ij, form_tap(kind, c[0], c[1], c[s1], c[s1 + 1], fx, fy,
                                       __fadd_rn(wd.w, float(j - g.radius)), ys + j, mul));
        }
      }
    }
  }
  const int pad = g.k_pad - g.c_in;
  for (int idx = threadIdx.x; idx < kBM * pad; idx += kProjThreads) {
    const int t = idx / pad;
    store_val(a + t * g.lda + g.c_in + idx - t * pad, 0.f);
  }
}

// A window cell of a bf16 / int8 level in shared memory, widened to fp32.
template <typename T>
__device__ __forceinline__ float smem_val(const unsigned char* p);
template <>
__device__ __forceinline__ float smem_val<__nv_bfloat16>(const unsigned char* p) {
  return __uint_as_float(uint32_t(*reinterpret_cast<const unsigned short*>(p)) << 16);
}
template <>
__device__ __forceinline__ float smem_val<int8_t>(const unsigned char* p) {
  return float(*reinterpret_cast<const signed char*>(p));
}

// One window column of the column walk (gather_windows_lowp): lane x of a
// window's S+1 (the window's lanes start at lane0) reads column x of each
// row (rows of rb bytes, row j's phase (ph + (ys + j) * wle) & 3), takes
// column x+1's value from the next lane, and stores taps (x, 0 .. S-1) at
// dst[0 .. S-1]. The y-dot weights of tap row j are worked out by lane j
// and shuffled to the window's lanes. kS: S known at compile time (the
// loop unrolls), or 0 and S = s_rt.
template <int kS, typename T, typename AT>
__device__ __forceinline__ void walk_column(const unsigned char* w, int rb, uint32_t ph, uint32_t wle, int ys,
                                            float yc, float fx, float fy, int kind, float mul, int radius, int x,
                                            int lane0, bool live, bool valid, bool mx, AT* dst, int s_rt = 0) {
  const int s = kS > 0 ? kS : s_rt;
  // tap row x's y-weights relu(1 - |p - y|) at rows y0 = ys + x and y0 + 1,
  // p = yc + x - r: rounded to bf16 (y-dot bf16) or quantized as round(127 w)
  float yw0 = 0.f;
  float yw1 = 0.f;
  if (kind != kFlat) {
    const float p = __fadd_rn(yc, float(x - radius));
    const int y0 = ys + x;
    const float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(p, float(y0)))));
    const float w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(p, float(y0 + 1)))));
    yw0 = kind == kYdotBf16 ? bf16_round(w0) : rintf(__fmul_rn(w0, 127.f));
    yw1 = kind == kYdotBf16 ? bf16_round(w1) : rintf(__fmul_rn(w1, 127.f));
  }
  float v = 0.f;   // this column's cell of the last row
  float xr = 0.f;  // flat: the last row's x-combine (1 - fx) v[x] + fx v[x+1]
  auto row = [&](int j) {
    const uint32_t pj = (ph + uint32_t(ys + j) * wle) & 3u;
    const float vn = mx ? smem_val<T>(w + j * rb + pj) : 0.f;
    // the value tap (x, j-1) needs from column x+1: flat, this row's cell;
    // y-dot, the last row's y-contraction
    float mine = vn;
    const float b0 = __shfl_sync(0xffffffffu, yw0, lane0 + (j > 0 ? j - 1 : 0));
    const float b1 = __shfl_sync(0xffffffffu, yw1, lane0 + (j > 0 ? j - 1 : 0));
    if (kind == kYdotBf16 && j > 0) {
      mine = bf16_round(__fadd_rn(__fmul_rn(b0, v), __fmul_rn(b1, vn)));
    } else if (kind == kYdotInt8 && j > 0) {
      mine = __fmul_rn(__fadd_rn(__fmul_rn(b0, v), __fmul_rn(b1, vn)), mul);
    }
    const float right = __shfl_down_sync(0xffffffffu, mine, 1);
    float tap;
    if (kind == kFlat) {
      const float xn = (1.f - fx) * vn + fx * right;
      tap = (1.f - fy) * xr + fy * xn;
      if (mul != 1.f) tap = __fmul_rn(tap, mul);
      xr = xn;
    } else {
      tap = __fadd_rn(__fmul_rn(mine, 1.f - fx), __fmul_rn(right, fx));
    }
    if (live && x < s && j > 0) store_tap(dst + j - 1, valid ? tap : 0.f);
    v = vn;
  };
  if constexpr (kS > 0) {
#pragma unroll
    for (int j = 0; j <= kS; ++j) row(j);
  } else {
    for (int j = 0; j <= s; ++j) row(j);
  }
}

// Taps of the block's queries from bf16 / int8 levels (T) into the A tile,
// as gather_windows; the windows are copied at their storage width into
// their own region win (see the note above: rows of row_words words from
// each row's first cell aligned down to 4 bytes, the cells before x = 0 of
// a straddling chunk masked where the taps are formed), one cp.async group
// a level, then (first pass) the ring's first `prefetch` weight slices
// (issue_w), so the weights stay in flight while taps are formed. Taps are
// formed in rounds as soon as the levels a round reads have landed, by a
// column walk: S+1 lanes a window (32 / (S+1) windows a warp), lane x
// reading window column x row by row; the value a tap needs from column x+1
// comes from the next lane by shuffle, so each y-dot row value and each
// row's y-weights are worked out once, not once a tap. The arithmetic, and
// so each tap's bits, is form_tap's.
template <typename T, typename AT, typename IssueW>
__device__ __forceinline__ void gather_windows_lowp(const Pyramid& pyr, const float* __restrict__ cents,
                                                    int64_t q0, int nq, const ProjectArgs& g, AT* a,
                                                    unsigned char* win, float4* at, IssueW issue_w) {
  constexpr int kE = sizeof(T);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = 2 * g.radius + 1;
  const int s1 = s + 1;
  const int ss = s * s;
  const int rw = g.row_words;
  const int rb = 4 * rw;        // bytes a window row
  const int wbytes = s1 * rb;   // bytes a window; window (t, level l0 + li) at (li * kBM + t) * wbytes
  const int chunks = s1 * rw;   // 4-byte copies a window
  window_table(pyr, cents, q0, nq, g, at);
  __syncthreads();

  // copies: lane's first chunk (row rr0, word k0) and its step of 32 chunks
  const int rr0 = lane / rw;
  const int k0 = lane - rr0 * rw;
  const int drr = 32 / rw;
  const int dk = 32 - drr * rw;
  // taps: window seg of the warp's nseg, column x
  const int nseg = 32 / s1;
  const int seg = lane / s1;
  const int x = lane - seg * s1;
  const int per_round = kProjWarps * nseg;
  for (int l0 = 0; l0 < pyr.num_levels; l0 += g.levels_per_pass) {
    const int nl = min(g.levels_per_pass, pyr.num_levels - l0);
    if (l0 > 0) __syncthreads();  // the last pass's windows are read
    for (int li = 0; li < nl; ++li) {
      const int l = l0 + li;
      const int hl = pyr.h[l];
      const int wl = pyr.w[l];
      for (int t = warp; t < nq; t += kProjWarps) {
        const float4 wd = at[t * kMaxLevels + l];
        const int xs = __float_as_int(wd.x);
        const int ys = __float_as_int(wd.y);
        // byte offsets from the 4-aligned address vbase: a row's first
        // window cell and its in-range cells [xa, xb]
        const uintptr_t vol =
            reinterpret_cast<uintptr_t>(pyr.level[l]) + uintptr_t((q0 + t) * int64_t(hl) * wl * kE);
        const int vlo = int(vol & 3);
        const unsigned char* vbase = reinterpret_cast<const unsigned char*>(vol - vlo);
        const int xa = max(xs, 0);
        const int xb = min(xs + s, wl - 1);
        const bool cols_ok = xa <= xb;
        unsigned char* dst = win + (li * kBM + t) * wbytes;
        int rr = rr0;
        int k = k0;
        for (int idx = lane; idx < chunks; idx += 32) {
          const int y = ys + rr;
          const int row = vlo + y * wl * kE;
          const int c = ((row + xs * kE) & ~3) + 4 * k;
          const int b0 = row + xa * kE;
          const int b1 = row + (xb + 1) * kE;
          const bool ok = cols_ok && y >= 0 && y < hl && c + 4 > b0 && c < b1;
          cp_async4n(dst + rr * rb + 4 * k, ok ? vbase + c : vbase, ok ? min(4, b1 - c) : 0);
          rr += drr;
          k += dk;
          if (k >= rw) {
            k -= rw;
            ++rr;
          }
        }
      }
      cp_async_commit();  // one group a level
    }
    const int pending_w = l0 == 0 ? issue_w() : 0;  // weight groups committed after the windows
    // rounds of per_round windows, level-major: wait for the levels a round reads
    int landed = -1;
    for (int r0 = 0; r0 < kBM * nl; r0 += per_round) {
      const int last_level = (min(r0 + per_round, kBM * nl) - 1) / kBM;
      if (last_level > landed) {
        cp_async_wait_n(nl - 1 - last_level + pending_w);
        __syncthreads();
        landed = last_level;
      }
      const int idx = r0 + warp * nseg + seg;
      const bool live = seg < nseg && idx < kBM * nl;
      const int li = live ? idx / kBM : 0;
      const int t = live ? idx - li * kBM : 0;
      const int l = l0 + li;
      const bool valid = live && t < nq;
      const float4 wd = at[t * kMaxLevels + l];
      const int xs = __float_as_int(wd.x);
      const int ys = __float_as_int(wd.y);
      const float fx = wd.z;
      const float fy = __fsub_rn(wd.w, float(ys + g.radius));  // y - floor(y)
      const int kind = pyr.kind[l];
      const float mul = level_mul(pyr, l);
      // a row's phase: its first window cell's address mod 4, as the copy had it
      const uint32_t wle = uint32_t(pyr.w[l] * kE);
      const uint32_t ph = uint32_t(reinterpret_cast<uintptr_t>(pyr.level[l])) +
                          uint32_t((q0 + t) * int64_t(pyr.h[l]) * pyr.w[l] * kE) + uint32_t(xs * kE);
      const unsigned char* w = win + (li * kBM + t) * wbytes + x * kE;
      // cells before x = 0 are another row's bytes or zero-filled: zero
      const bool mx = valid && xs + x >= 0;
      AT* dst = a + t * g.lda + l * ss + x * s;
      const int lane0 = lane - x;
      if (s == 9) {
        walk_column<9, T>(w, rb, ph, wle, ys, wd.w, fx, fy, kind, mul, g.radius, x, lane0, live, valid, mx, dst);
      } else if (s == 7) {
        walk_column<7, T>(w, rb, ph, wle, ys, wd.w, fx, fy, kind, mul, g.radius, x, lane0, live, valid, mx, dst);
      } else {
        walk_column<0, T>(w, rb, ph, wle, ys, wd.w, fx, fy, kind, mul, g.radius, x, lane0, live, valid, mx, dst,
                          s);
      }
    }
  }
  const int pad = g.k_pad - g.c_in;
  for (int idx = threadIdx.x; idx < kBM * pad; idx += kProjThreads) {
    const int t = idx / pad;
    store_val(a + t * g.lda + g.c_in + idx - t * pad, 0.f);
  }
}

// Weight columns k0 .. k0+KC-1 of channels n0 .. n0+BN-1 into one stage
// ws[n][k]; zero past c_in and c_out.
__device__ __forceinline__ void load_w_stage(float* ws, const float* __restrict__ weight, int k0, int n0,
                                             const ProjectArgs& g) {
  if (g.vec_w) {
    constexpr int kRow = kKC / 4;
    for (int i = threadIdx.x; i < kBN * kRow; i += kProjThreads) {
      const int n = i / kRow;
      const int kk = (i - n * kRow) * 4;
      const bool ok = n0 + n < g.c_out && k0 + kk < g.c_in;
      cp_async16(ws + n * kLdw + kk, ok ? weight + int64_t(n0 + n) * g.c_in + k0 + kk : weight, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBN * kKC; i += kProjThreads) {
      const int n = i / kKC;
      const int kk = i - n * kKC;
      const bool ok = n0 + n < g.c_out && k0 + kk < g.c_in;
      cp_async4(ws + n * kLdw + kk, ok ? weight + int64_t(n0 + n) * g.c_in + k0 + kk : weight, ok);
    }
  }
}

// bf16 weight columns k0 .. k0+KCB-1 of channels n0 .. n0+BN-1 into one
// stage ws[n][k] of kLdwB-word rows, 16 bytes a copy, from the (c_out,
// k_pad) zero-padded bf16 copy of W; zero past k_pad and c_out.
__device__ __forceinline__ void load_w_stage_bf16(unsigned char* ws, const __nv_bfloat16* __restrict__ weight,
                                                  int k0, int n0, const ProjectArgs& g) {
  constexpr int kRow = kKCB / 8;
  for (int i = threadIdx.x; i < kBN * kRow; i += kProjThreads) {
    const int n = i / kRow;
    const int kk = (i - n * kRow) * 8;
    const bool ok = n0 + n < g.c_out && k0 + kk < g.k_pad;
    cp_async16(ws + (n * kLdwB + kk / 2) * 4, ok ? weight + int64_t(n0 + n) * g.k_pad + k0 + kk : weight, ok);
  }
}

template <bool kBf16>
__device__ __forceinline__ void load_stage(unsigned char* stage, const void* weight, int k0, int n0,
                                           const ProjectArgs& g) {
  if constexpr (kBf16) {
    load_w_stage_bf16(stage, static_cast<const __nv_bfloat16*>(weight), k0, n0, g);
  } else {
    load_w_stage(reinterpret_cast<float*>(stage), static_cast<const float*>(weight), k0, n0, g);
  }
}

// relu that keeps a NaN (torch.relu's and the JAX kernel's semantics)
__device__ __forceinline__ float relu_nan(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// T: the levels' storage; kBf16: the product at bf16 (bf16 taps and W,
// m16n8k16, bf16 output), else 3xTF32 with fp32 output. weight is the fp32
// (c_out, c_in) W for 3xTF32, the zero-padded bf16 (c_out, k_pad) copy for
// the bf16 product.
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kProjThreads, kProjBlocksPerSm)
xtap_project_kernel(Pyramid pyr, const float* __restrict__ cents, const void* __restrict__ weight,
                    const float* __restrict__ bias, void* __restrict__ out_ptr, ProjectArgs g) {
  using OutT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  using AT = OutT;  // the A tile: fp32 taps for 3xTF32, bf16 for the bf16 product
  // fp32 levels: windows at fp32 over the ring (the fp32 form's layout);
  // bf16 / int8: at storage width past the stages issued before the gather
  constexpr bool kWide = std::is_same<T, float>::value;
  constexpr int kSt = kBf16 ? kStagesB : kStages;
  constexpr int kKc = kBf16 ? kKCB : kKC;  // columns a weight slice
  constexpr int kStageBytes = kBf16 ? 4 * kStageWordsB : 4 * kStageFloats;
  OutT* out = static_cast<OutT*>(out_ptr);
  extern __shared__ float4 smem4[];
  AT* a = reinterpret_cast<AT*>(smem4);  // [query][k] taps
  // ring, then tile (addressed from the A tile's end: the fp32 form is 1 % slower
  // when its region comes from a byte offset)
  unsigned char* region = reinterpret_cast<unsigned char*>(a + kBM * g.lda);
  float4* at = reinterpret_cast<float4*>(region + g.region);  // each (query, level)'s window

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int64_t q0 = int64_t(blockIdx.x) * kBM;
  const int nq = int(g.q - q0 < kBM ? g.q - q0 : kBM);
  const int n0 = blockIdx.y * kBN;
  const int wm0 = (warp % kWarpsM) * kWM;
  const int wn0 = (warp / kWarpsM) * kWN;
  const bool warp_live = n0 + wn0 < g.c_out;
  const int k_tiles = (g.k_pad + kKc - 1) / kKc;

  if constexpr (kWide) {
    gather_windows(pyr, cents, q0, nq, g, a, reinterpret_cast<float*>(region), at);
  } else {
    // the ring's first slices, issued after the first pass's windows: in
    // flight while its taps are formed
    gather_windows_lowp<T>(pyr, cents, q0, nq, g, a, region + g.win_off, at, [&]() {
      for (int st = 0; st < g.prefetch; ++st) {
        if (st < k_tiles) load_stage<kBf16>(region + st * kStageBytes, weight, st * kKc, n0, g);
        cp_async_commit();
      }
      return g.prefetch;
    });
  }
  __syncthreads();  // A is complete; the windows are dead

  float acc[kMf][kNf][4];
#pragma unroll
  for (int i = 0; i < kMf; ++i)
#pragma unroll
    for (int j = 0; j < kNf; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int first = kWide ? 0 : g.prefetch;
#pragma unroll
  for (int st = 0; st < kSt - 1; ++st) {
    if (st < first) continue;
    if (st < k_tiles) load_stage<kBf16>(region + st * kStageBytes, weight, st * kKc, n0, g);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kSt - 2>();
    __syncthreads();  // slice kt landed for all; slice kt-1 is free
    const int next = kt + kSt - 1;
    if (next < k_tiles) load_stage<kBf16>(region + (next % kSt) * kStageBytes, weight, next * kKc, n0, g);
    cp_async_commit();
    if (!warp_live) continue;
    const int k0 = kt * kKc;
    if constexpr (kBf16) {
      // bf16 pairs as 32-bit words: A rows of lda / 2 words, ring rows of kLdwB
      const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
      const uint32_t* ws = reinterpret_cast<const uint32_t*>(region + (kt % kSt) * kStageBytes);
      const int ldw = g.lda / 2;
#pragma unroll
      for (int k16 = 0; k16 < kKCB; k16 += 16) {
        if (k0 + k16 >= g.k_pad) break;
        uint32_t af[kMf][4];
#pragma unroll
        for (int i = 0; i < kMf; ++i) {
          const uint32_t* ap = a32 + (wm0 + i * 16 + gid) * ldw + (k0 + k16) / 2 + tig;
          af[i][0] = ap[0];
          af[i][1] = ap[8 * ldw];
          af[i][2] = ap[4];
          af[i][3] = ap[8 * ldw + 4];
        }
#pragma unroll
        for (int j = 0; j < kNf; ++j) {
          const uint32_t* bp = ws + (wn0 + j * 8 + gid) * kLdwB + k16 / 2 + tig;
          const uint32_t bf[2] = {bp[0], bp[4]};
#pragma unroll
          for (int i = 0; i < kMf; ++i) mma_bf16(acc[i][j], af[i], bf);
        }
      }
    } else {
      const float* ws = reinterpret_cast<const float*>(region + (kt % kSt) * kStageBytes);
#pragma unroll
      for (int k8 = 0; k8 < kKC; k8 += 8) {
        if (k0 + k8 >= g.k_pad) break;
        uint32_t ahi[kMf][4], alo[kMf][4];
#pragma unroll
        for (int i = 0; i < kMf; ++i) {
          const float* ap = a + (wm0 + i * 16 + gid) * g.lda + k0 + k8 + tig;
          split_tf32(ap[0], ahi[i][0], alo[i][0]);
          split_tf32(ap[8 * g.lda], ahi[i][1], alo[i][1]);
          split_tf32(ap[4], ahi[i][2], alo[i][2]);
          split_tf32(ap[8 * g.lda + 4], ahi[i][3], alo[i][3]);
        }
#pragma unroll
        for (int j = 0; j < kNf; ++j) {
          const float* bp = ws + (wn0 + j * 8 + gid) * kLdw + k8 + tig;
          uint32_t bhi[2], blo[2];
          split_tf32(bp[0], bhi[0], blo[0]);
          split_tf32(bp[4], bhi[1], blo[1]);
#pragma unroll
          for (int i = 0; i < kMf; ++i) mma_3xtf32(acc[i][j], ahi[i], alo[i], bhi, blo);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue tile reuses it

  // relu(acc + bias) -> tile[channel][query], from the fragment layout
  float* tile = reinterpret_cast<float*>(region);
  if (warp_live) {
#pragma unroll
    for (int j = 0; j < kNf; ++j) {
      const int n = wn0 + j * 8 + 2 * tig;
      const float b0 = n0 + n < g.c_out ? __ldg(bias + n0 + n) : 0.f;
      const float b1 = n0 + n + 1 < g.c_out ? __ldg(bias + n0 + n + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < kMf; ++i) {
        float* p = tile + n * kLdt + wm0 + i * 16 + gid;
        p[0] = relu_nan(acc[i][j][0] + b0);
        p[kLdt] = relu_nan(acc[i][j][1] + b1);
        p[8] = relu_nan(acc[i][j][2] + b0);
        p[kLdt + 8] = relu_nan(acc[i][j][3] + b1);
      }
    }
  }
  __syncthreads();

  // NCHW rows: a warp writes contiguous p of one channel
  const int n_rows = min(kBN, g.c_out - n0);
  const int64_t b0 = q0 / g.hw;
  const int64_t p0 = q0 - b0 * g.hw;
  if (g.vec_out) {
    // hw % 4 == 0: q0 and nq are multiples of 4, no float4 crosses a batch
    constexpr int kRow = kBM / 4;
    for (int idx = tid; idx < n_rows * kRow; idx += kProjThreads) {
      const int n = idx / kRow;
      const int m = (idx - n * kRow) * 4;
      if (m >= nq) continue;
      int64_t b = b0;
      int64_t p = p0 + m;
      while (p >= g.hw) {
        p -= g.hw;
        ++b;
      }
      const float4 v = *reinterpret_cast<const float4*>(tile + n * kLdt + m);
      OutT* o = out + (b * g.c_out + n0 + n) * g.hw + p;
      if constexpr (kBf16) {
        __nv_bfloat162 lo2 = __floats2bfloat162_rn(v.x, v.y);
        __nv_bfloat162 hi2 = __floats2bfloat162_rn(v.z, v.w);
        uint2 packed;
        packed.x = *reinterpret_cast<uint32_t*>(&lo2);
        packed.y = *reinterpret_cast<uint32_t*>(&hi2);
        *reinterpret_cast<uint2*>(o) = packed;
      } else {
        *reinterpret_cast<float4*>(o) = v;
      }
    }
  } else {
    for (int idx = tid; idx < n_rows * kBM; idx += kProjThreads) {
      const int n = idx / kBM;
      const int m = idx - n * kBM;
      if (m >= nq) continue;
      int64_t b = b0;
      int64_t p = p0 + m;
      while (p >= g.hw) {
        p -= g.hw;
        ++b;
      }
      store_val(out + (b * g.c_out + n0 + n) * g.hw + p, tile[n * kLdt + m]);
    }
  }
}

// ---- K2 and K4: the taps alone -------------------------------------------

// A window cell of an fp32 level in shared memory.
template <>
__device__ __forceinline__ float smem_val<float>(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

// Bytes from one window row to the next: the chunks that cover S+1 cells
// from any phase (taps_row_chunks), at most kTapsChunk - ke + (S+1) ke
// bytes, the rows an odd number of 16-byte chunks apart, so the walk's
// lanes (a row each) spread over the banks.
__host__ __device__ constexpr int taps_row_chunks(int s1, int ke) {
  return (kTapsChunk - ke + s1 * ke + kTapsChunk - 1) / kTapsChunk;
}

__host__ __device__ constexpr int taps_row_bytes(int s1, int ke) {
  return kTapsChunk * (taps_row_chunks(s1, ke) | 1);
}

// K2's and K4's block plan (taps_plan), worked out once on the host. Shared
// memory: the table of windows (nq x L entries), then the windows of one
// pass ((level, query)-major, S+1 rows of rb bytes each), then the tap
// tile, 16-byte aligned.
struct TapsArgs {
  int64_t q;
  int radius;
  int nq;               // queries a block, a power of two
  int nq_log2;
  int levels_per_pass;  // levels whose windows and taps one pass holds
  int pitch;            // bytes from one query's taps to the next in the tile, = C * out bytes (mod 16)
  int win_off;          // byte offset of the windows
  int tile_off;         // byte offset of the tap tile
};

// Each (query, level)'s window, one thread each: at[(l << nq_log2) + t]
// holds its first cell (xs, ys) as int bits and the clamped centre (x, y),
// both NaN for a NaN centroid. As window_table, but the centre rather than the
// fraction: K2 forms each tap's fractions from its own position, as
// sample_zero_pad did.
__device__ __forceinline__ void taps_table(const Pyramid& pyr, const float* __restrict__ cents, int64_t q0, int nq,
                                           int nq_log2, int radius, float4* at) {
  for (int e = threadIdx.x; e < (pyr.num_levels << nq_log2); e += kTapsThreads) {
    const int l = e >> nq_log2;
    const int t = e & ((1 << nq_log2) - 1);
    if (t >= nq) continue;
    const float inv = 1.f / float(1 << l);  // exact: a power of two
    float x = __ldg(cents + 2 * (q0 + t)) * inv;
    float y = __ldg(cents + 2 * (q0 + t) + 1) * inv;
    const bool nan_in = isnan(x) || isnan(y);
    // beyond r + 1 cells outside the level every window cell is out of
    // range: the clamp keeps the float -> int conversion defined
    x = fminf(fmaxf(x, -float(radius + 2)), float(pyr.w[l] + radius + 1));
    y = fminf(fmaxf(y, -float(radius + 2)), float(pyr.h[l] + radius + 1));
    const int xs = int(floorf(x)) - radius;
    const int ys = int(floorf(y)) - radius;
    at[e] = make_float4(__int_as_float(xs), __int_as_float(ys), nan_in ? nanf("") : x, nan_in ? nanf("") : y);
  }
}

// The lanes' share of one window's copies: cells lpr lanes a row and rps
// rows a step; chunks from (rr0, k0) in steps of 32 chunks.
struct CopyLanes {
  int lpr, rps, ry, rx;
  int rr0, k0, drr, dk;
};

// Window (xs, ys) of query qg at level l into dst (rows rb bytes apart),
// zero outside the level, by one warp, at storage width. A level that
// starts kTapsChunk-aligned (packed): K1's chunked copy
// (gather_windows_lowp) at kTapsChunk = 16 bytes by cp.async.cg:
// row_chunks chunks a row,
// aligned down from its first cell, each row at its own phase; wholly
// out-of-range chunks zero-filled, the last one cut at the row's last
// in-range cell, so no copy reads past the tensor; the cells before x = 0
// of a chunk that straddles the row's start are another row's bytes,
// masked where the taps read them. Otherwise cell by cell at phase 0: fp32
// by 4-byte cp.async, bf16 / int8 through registers.
template <typename T>
__device__ __forceinline__ void copy_window(unsigned char* dst, const Pyramid& pyr, int l, int64_t qg, int xs,
                                            int ys, int s1, int rb, int row_chunks, bool packed,
                                            const CopyLanes& cl) {
  constexpr int kE = sizeof(T);
  const int hl = pyr.h[l];
  const int wl = pyr.w[l];
  if (!packed) {
    if (cl.ry >= cl.rps) return;
    using Raw = typename std::conditional<kE == 4, float, typename std::conditional<kE == 2, unsigned short,
                                                                                    unsigned char>::type>::type;
    const Raw* vol = static_cast<const Raw*>(pyr.level[l]) + qg * int64_t(hl) * wl;
    for (int yy = cl.ry; yy < s1; yy += cl.rps) {
      const int y = ys + yy;
      const bool row_ok = y >= 0 && y < hl;
      for (int xx = cl.rx; xx < s1; xx += cl.lpr) {
        const int x = xs + xx;
        const bool ok = row_ok && x >= 0 && x < wl;
        if constexpr (kE == 4) {
          copy_cell(reinterpret_cast<float*>(dst + yy * rb) + xx, vol, int64_t(y) * wl + x, ok);
        } else {
          *reinterpret_cast<Raw*>(dst + yy * rb + xx * kE) = ok ? __ldg(vol + int64_t(y) * wl + x) : Raw(0);
        }
      }
    }
    return;
  }
  // byte offsets from the chunk-aligned address vbase: a row's first
  // window cell and its in-range cells [xa, xb]
  constexpr int kC = kTapsChunk;
  static_assert(kC == 16, "cp_async16n copies the chunks");
  const int s = s1 - 1;
  const uintptr_t vol = reinterpret_cast<uintptr_t>(pyr.level[l]) + uintptr_t(qg * int64_t(hl) * wl * kE);
  const int vlo = int(vol & (kC - 1));
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(vol - vlo);
  const int xa = max(xs, 0);
  const int xb = min(xs + s, wl - 1);
  int rr = cl.rr0;
  int k = cl.k0;
  for (int idx = threadIdx.x & 31; idx < s1 * row_chunks; idx += 32) {
    const int y = ys + rr;
    const int row = vlo + y * wl * kE;
    const int c = ((row + xs * kE) & ~(kC - 1)) + kC * k;
    const int b1 = row + (xb + 1) * kE;
    const bool in = xa <= xb && y >= 0 && y < hl && c + kC > row + xa * kE && c < b1;
    cp_async16n(dst + rr * rb + kC * k, in ? vbase + c : vbase, in ? min(kC, b1 - c) : 0);
    rr += cl.drr;
    k += cl.dk;
    if (k >= row_chunks) {
      k -= row_chunks;
      ++rr;
    }
  }
}

// Tap row j's fraction fy (flat: a) or its two y-weights (y-dot: a, b), as
// form_tap works them out from the row's centre p = cy + j - r and first
// window row y0 = ys + j.
__device__ __forceinline__ void tap_row(int kind, float cy, int ys, int j, int radius, float& a, float& b) {
  const float p = __fadd_rn(cy, float(j - radius));
  const int y0 = ys + j;
  if (kind == kFlat) {
    a = __fsub_rn(p, float(y0));
    return;
  }
  const float w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(p, float(y0)))));
  const float w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(p, float(y0 + 1)))));
  a = kind == kYdotBf16 ? bf16_round(w0) : rintf(__fmul_rn(w0, 127.f));
  b = kind == kYdotBf16 ? bf16_round(w1) : rintf(__fmul_rn(w1, 127.f));
}

// form_tap's flat tap with the contraction nvcc gave its expression in the
// earlier K2 (tools/k2_pr6_lookup_xtap.cu), written out so that the taps
// keep those bits wherever the compiler schedules them: each row's
// x-combine fma(1 - fx, v0, fx * v1), then fma(1 - fy, top, fy * bottom).
__device__ __forceinline__ float flat_tap(float v00, float v01, float v10, float v11, float fx, float fy,
                                          float mul) {
  const float gx = 1.f - fx;
  const float top = __fmaf_rn(gx, v00, __fmul_rn(fx, v01));
  const float bottom = __fmaf_rn(gx, v10, __fmul_rn(fx, v11));
  const float t = __fmaf_rn(1.f - fy, top, __fmul_rn(fy, bottom));
  return mul == 1.f ? t : __fmul_rn(t, mul);
}

// One tap row of K2's row walk: the lane holds tap row j of a window and
// walks its columns, reading window rows j and j+1 (rows rb bytes apart,
// row y's first cell (ph + y * wle) & (kTapsChunk - 1) bytes into it), and
// writes taps (0 .. S-1, j) to dst[x * S + j]. Every tap is
// sample_zero_pad's: x-fractions the tap's own ((cx + x - r) - its floor),
// the row's fy and y-weights worked out once (tap_row), the flat form
// flat_tap, the y-dot forms form_tap's roundings, each row pair's
// y-contraction once a column; so the taps are the 4-corner form's bit for
// bit (the window's cells are the corners it loaded). Columns before x0
// hold another row's bytes (a chunked row that starts before x = 0) and
// read as zero. kS: S known at compile time (the loop unrolls), or 0 and
// S = s_rt.
template <int kS, typename T, typename OutT>
__device__ __forceinline__ void walk_row(const unsigned char* w, int rb, uint32_t ph, uint32_t wle, int x0, int xs,
                                         int ys, float cx, float cy, int kind, float mul, int radius, int j,
                                         OutT* dst, int s_rt = 0) {
  constexpr int kE = sizeof(T);
  constexpr bool kWide = std::is_same<T, float>::value;  // fp32 levels: every level flat
  const int s = kS > 0 ? kS : s_rt;
  const int r = kS > 0 ? (kS - 1) / 2 : radius;
  constexpr uint32_t kPh = kTapsChunk - 1;
  const unsigned char* row0 = w + j * rb + ((ph + uint32_t(ys + j) * wle) & kPh);
  const unsigned char* row1 = w + (j + 1) * rb + ((ph + uint32_t(ys + j + 1) * wle) & kPh);
  float a = 0.f;
  float b = 0.f;
  tap_row(kind, cy, ys, j, r, a, b);
  const float xsf = float(xs);
  auto cell = [&](const unsigned char* row, int x) {
    return x >= x0 ? smem_val<T>(row + x * kE) : 0.f;
  };
  // the row pair's y-contraction at a column (y-dot forms)
  auto contract = [&](float v0, float v1) {
    if (kind == kYdotBf16) return bf16_round(__fadd_rn(__fmul_rn(a, v0), __fmul_rn(b, v1)));
    return __fmul_rn(__fadd_rn(__fmul_rn(a, v0), __fmul_rn(b, v1)), mul);
  };
  float v0 = cell(row0, 0);
  float v1 = cell(row1, 0);
  float left = kWide || kind == kFlat ? 0.f : contract(v0, v1);
  auto column = [&](int x) {
    const float u0 = cell(row0, x + 1);
    const float u1 = cell(row1, x + 1);
    const float fx = __fsub_rn(__fadd_rn(cx, float(x - r)), __fadd_rn(xsf, float(x)));
    float tap;
    if (kWide || kind == kFlat) {
      tap = flat_tap(v0, u0, v1, u1, fx, a, mul);
    } else {
      const float right = contract(u0, u1);
      tap = __fadd_rn(__fmul_rn(left, 1.f - fx), __fmul_rn(right, fx));
      left = right;
    }
    store_val(dst + x * s + j, tap);
    v0 = u0;
    v1 = u1;
  };
  if constexpr (kS > 0) {
#pragma unroll
    for (int x = 0; x < kS; ++x) column(x);
  } else {
    for (int x = 0; x < s; ++x) column(x);
  }
}

// n elements from shared memory (src) to device memory (dst), the two
// alike mod 16 bytes: the head up to dst's first 16-byte boundary and the
// tail element by element, the body by 16-byte vectors; the block's threads
// take the head's elements, the vectors and the tail's elements in turn
// (TestK2Tile in tests/test_torch_kernels.py emulates the split).
template <typename OutT>
__device__ __forceinline__ void store_span(OutT* dst, const unsigned char* src, int n) {
  constexpr int kV = 16 / int(sizeof(OutT));
  const int head = min(n, int((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / int(sizeof(OutT)));
  const int nv = (n - head) / kV;
  const int items = n - nv * (kV - 1);  // head + nv vectors + tail
  for (int k = threadIdx.x; k < items; k += kTapsThreads) {
    if (k >= head && k < head + nv) {
      const int e = head + (k - head) * kV;
      *reinterpret_cast<uint4*>(dst + e) = *reinterpret_cast<const uint4*>(src + e * sizeof(OutT));
    } else {
      const int e = k < head ? k : k + nv * (kV - 1);
      dst[e] = *reinterpret_cast<const OutT*>(src + e * sizeof(OutT));
    }
  }
}

// K2 (T: the levels' storage, OutT: fp32 taps for fp32 levels, bf16 for
// bf16 and int8) and K4 (<float, float>): out (Q, L*S*S). A block takes
// g.nq consecutive queries, one contiguous span of out. kS: S known at
// compile time (7, 9: the index arithmetic folds, the loops unroll), or 0
// and S = 2 g.radius + 1.
template <typename T, typename OutT, int kS>
__global__ void __launch_bounds__(kTapsThreads, kTapsBlocksPerSm)
xtap_lookup_kernel(Pyramid pyr, const float* __restrict__ cents, OutT* __restrict__ out, TapsArgs g) {
  constexpr int kE = sizeof(T);
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  float4* at = smem4;
  unsigned char* win = base + g.win_off;
  unsigned char* tile = base + g.tile_off;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_levels = pyr.num_levels;
  const int radius = kS > 0 ? (kS - 1) / 2 : g.radius;
  const int s = 2 * radius + 1;
  const int s1 = s + 1;
  const int ss = s * s;
  const int c_all = n_levels * ss;
  const int rb = taps_row_bytes(s1, kE);
  const int row_chunks = taps_row_chunks(s1, kE);
  const int wbytes = s1 * rb;
  const int64_t q0 = int64_t(blockIdx.x) * g.nq;
  const int nq = int(g.q - q0 < g.nq ? g.q - q0 : g.nq);
  taps_table(pyr, cents, q0, nq, g.nq_log2, radius, at);
  __syncthreads();

  CopyLanes cl;
  cl.lpr = min(s1, 32);
  cl.rps = 32 / cl.lpr;
  cl.ry = lane / cl.lpr;
  cl.rx = lane - cl.ry * cl.lpr;
  cl.rr0 = lane / row_chunks;
  cl.k0 = lane - cl.rr0 * row_chunks;
  cl.drr = 32 / row_chunks;
  cl.dk = 32 - cl.drr * row_chunks;
  // the walk: segments of seg lanes, a lane a tap row of a window (chunks
  // of 32 rows where a window has more); items (level, query, chunk),
  // level-major, g.nq (a power of two) queries a level
  const int seg = min(s, 32);
  const int chunks = (s + seg - 1) / seg;
  const int nseg = 32 / seg;
  const int sg = lane / seg;
  const int jl = lane - sg * seg;
  const int per_round = kTapsWarps * nseg;
  const int per_level = g.nq * chunks;

  for (int l0 = 0; l0 < n_levels; l0 += g.levels_per_pass) {
    const int nl = min(g.levels_per_pass, n_levels - l0);
    if (l0 > 0) __syncthreads();  // the last pass's windows and tile are read
    for (int li = 0; li < nl; ++li) {
      const int l = l0 + li;
      const bool packed = (reinterpret_cast<uintptr_t>(pyr.level[l]) & (kTapsChunk - 1)) == 0;
      for (int t = warp; t < nq; t += kTapsWarps) {
        const float4 wd = at[(l << g.nq_log2) + t];
        copy_window<T>(win + ((li << g.nq_log2) + t) * wbytes, pyr, l, q0 + t, __float_as_int(wd.x),
                       __float_as_int(wd.y), s1, rb, row_chunks, packed, cl);
      }
      cp_async_commit();  // one group a level
    }
    // the pass's taps, tile row t at tile + ph0 + t * pitch: alike mod 16
    // bytes with their place in out
    OutT* span = out + (q0 * c_all + l0 * ss);
    unsigned char* rows = tile + (reinterpret_cast<uintptr_t>(span) & 15);
    const int items = nl * per_level;
    int landed = -1;
    for (int r0 = 0; r0 < items; r0 += per_round) {
      const int last_level = chunks == 1 ? (min(r0 + per_round, items) - 1) >> g.nq_log2
                                         : (min(r0 + per_round, items) - 1) / per_level;
      if (last_level > landed) {
        cp_async_wait_n(nl - 1 - last_level);
        __syncthreads();
        landed = last_level;
      }
      const int idx = r0 + warp * nseg + sg;
      int li, t, j;
      if (chunks == 1) {
        li = idx >> g.nq_log2;
        t = idx & (g.nq - 1);
        j = jl;
      } else {
        li = idx / per_level;
        const int rest = idx - li * per_level;
        t = rest / chunks;
        j = (rest - t * chunks) * seg + jl;
      }
      if (sg >= nseg || idx >= items || t >= nq || j >= s) continue;  // no shuffles below: lanes drop out
      const int l = l0 + li;
      const float4 wd = at[(l << g.nq_log2) + t];
      const int xs = __float_as_int(wd.x);
      const int ys = __float_as_int(wd.y);
      const int kind = pyr.kind[l];
      const float mul = level_mul(pyr, l);
      // where row y's first window cell lies in its row of the window:
      // (ph + y * wle) & (kTapsChunk - 1) bytes on. A chunked row starts at
      // the chunk boundary before its first cell, and its cells before
      // x = 0 are another row's (masked before column x0); cells copied one
      // by one lie at phase 0
      uint32_t ph = 0;
      uint32_t wle = 0;
      int x0 = INT_MIN;
      if ((reinterpret_cast<uintptr_t>(pyr.level[l]) & (kTapsChunk - 1)) == 0) {
        wle = uint32_t(pyr.w[l] * kE);
        ph = uint32_t(reinterpret_cast<uintptr_t>(pyr.level[l])) +
             uint32_t((q0 + t) * int64_t(pyr.h[l]) * pyr.w[l] * kE) + uint32_t(xs * kE);
        x0 = -xs;
      }
      const unsigned char* w = win + ((li << g.nq_log2) + t) * wbytes;
      OutT* dst = reinterpret_cast<OutT*>(rows + t * g.pitch) + li * ss;
      walk_row<kS, T>(w, rb, ph, wle, x0, xs, ys, wd.z, wd.w, kind, mul, radius, j, dst, s);
    }
    __syncthreads();  // the pass's taps are in the tile
    if (nl == n_levels) {
      store_span(span, rows, nq * c_all);  // the block's queries: one span
    } else {
      for (int t = 0; t < nq; ++t) store_span(span + t * c_all, rows + t * g.pitch, nl * ss);
    }
  }
}

// ---- host side ----------------------------------------------------------

// Fills the pyramid descriptor; false when the arguments are invalid: a
// kind other than flat must match the storage (y-dot bf16 on bf16 levels,
// y-dot int8 on int8 ones), and int8 levels need their scales.
bool fill_pyramid(const void* const* levels, const int* heights, const int* widths, const int* kinds,
                  int num_levels, int elem, const void* scales, int radius, Pyramid* pyr) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0) return false;
  if (elem != kElemF32 && elem != kElemBf16 && elem != kElemInt8) return false;
  if ((elem == kElemInt8) != (scales != nullptr)) return false;
  for (int l = 0; l < num_levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1 || levels[l] == nullptr) return false;
    const int k = kinds[l];
    if (!(k == kFlat || (k == kYdotBf16 && elem == kElemBf16) || (k == kYdotInt8 && elem == kElemInt8)))
      return false;
    pyr->level[l] = levels[l];
    pyr->h[l] = heights[l];
    pyr->w[l] = widths[l];
    pyr->kind[l] = k;
  }
  for (int l = num_levels; l < kMaxLevels; ++l) {
    pyr->level[l] = nullptr;
    pyr->h[l] = 0;
    pyr->w[l] = 0;
    pyr->kind[l] = kFlat;
  }
  pyr->scales = static_cast<const float*>(scales);
  pyr->elem = elem;
  pyr->num_levels = num_levels;
  return true;
}

// K1's shared memory by level storage (elem) and product: the A tile, the
// ring / epilogue region and the table of windows; fills g's layout fields
// and returns the bytes a block needs (more than kMaxSmem: refused).
//   * fp32 levels, 3xTF32 (the fp32 form): the windows overlay the region,
//     as many levels a pass as max(ring, epilogue tile, one level) holds.
//   * otherwise all levels in one pass if shared memory allows, else the
//     most it allows; bf16 / int8 windows (rows of row_words words) lie past
//     the first `prefetch` ring stages, as many as fit; within two blocks an
//     SM (kTwoBlockSmem) if any such layout does, else one.
size_t project_smem(ProjectArgs* g, int elem, bool bf16) {
  const int s = 2 * g->radius + 1;
  const int s1 = s + 1;
  const int num_levels = g->c_in / (s * s);
  const size_t table = sizeof(float4) * kBM * kMaxLevels;
  const size_t tile = sizeof(float) * kTileFloats;
  size_t stage, a_bytes;
  int stages;
  if (bf16) {
    g->k_pad = (g->c_in + 15) & ~15;
    g->lda = g->k_pad + 8;
    a_bytes = size_t(kBM) * g->lda * 2;
    stage = 4 * size_t(kStageWordsB);
    stages = kStagesB;
  } else {
    g->k_pad = (g->c_in + 7) & ~7;
    g->lda = g->k_pad + 4;
    a_bytes = size_t(kBM) * g->lda * 4;
    stage = 4 * size_t(kStageFloats);
    stages = kStages;
  }
  const size_t ring = stages * stage;
  g->win_off = 0;
  g->prefetch = 0;
  g->row_words = 0;
  size_t win_level = sizeof(float) * kBM * s1 * s1;  // one level's fp32 windows
  if (elem == kElemF32 && !bf16) {
    size_t region = ring > tile ? ring : tile;
    if (win_level > region) region = win_level;
    g->levels_per_pass = int(region / win_level);
    g->region = int(region);
    return a_bytes + region + table;
  }
  int max_prefetch = 0;
  if (elem != kElemF32) {
    if (s1 > 32) return kMaxSmem + 1;  // the column walk takes a window's S+1 columns in one warp
    g->row_words = (s * (elem == kElemBf16 ? 2 : 1) + 7) / 4;
    win_level = 4 * size_t(kBM) * s1 * g->row_words;
    max_prefetch = stages - 1;
  }
  for (const size_t budget : {kTwoBlockSmem, kMaxSmem}) {
    for (int nl = num_levels; nl >= 1; --nl) {
      for (int p = max_prefetch; p >= 0; --p) {
        size_t region = ring > tile ? ring : tile;
        if (p * stage + nl * win_level > region) region = p * stage + nl * win_level;
        if (a_bytes + region + table <= budget) {
          g->levels_per_pass = nl;
          g->prefetch = p;
          g->win_off = int(p * stage);
          g->region = int(region);
          return a_bytes + region + table;
        }
      }
    }
  }
  return kMaxSmem + 1;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kBf16>
int project_launch(const Pyramid& pyr, const float* cents, const void* weight, const float* bias,
                   void* out, const ProjectArgs& g, size_t smem, dim3 grid, cudaStream_t stream) {
  auto kernel = xtap_project_kernel<T, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, kProjThreads, smem, stream>>>(pyr, cents, weight, bias, out, g);
  return int(cudaGetLastError());
}

// K2's and K4's plan: the queries a block (kTapsQueries where eight blocks
// an SM fit, else fewer), the levels a pass (all where shared memory
// allows) and the shared-memory layout; fills g and returns the bytes a
// block needs, or 0 for a shape the entry point does not take (K2 over
// kK2MaxTaps taps a query, K4 S (S + 2) over kK4MaxSpan), each of which
// fits one query and one level a pass. Mirrored by _taps_plan in
// kernels/lookup_xtap.py.
size_t taps_plan(TapsArgs* g, int num_levels, int elem, bool k4) {
  const int s = 2 * g->radius + 1;
  const int s1 = s + 1;
  const int ss = s * s;
  const int c = num_levels * ss;
  if (k4 ? s * (s + 2) > kK4MaxSpan : c > kK2MaxTaps) return 0;
  const int ke = elem == kElemF32 ? 4 : (elem == kElemBf16 ? 2 : 1);
  const int es = elem == kElemF32 ? 4 : 2;  // the taps: fp32, or bf16
  const int rb = taps_row_bytes(s1, ke);
  for (const size_t budget : {kTapsSmemShare, kMaxSmem}) {
    for (int nl = num_levels; nl >= 1; --nl) {
      for (int nq = kTapsQueries; nq >= 1; nq /= 2) {
        const size_t win_off = sizeof(float4) * nq * num_levels;
        const size_t tile_off = (win_off + size_t(nl) * nq * s1 * rb + 15) & ~size_t(15);
        const int pitch = nl * ss * es + ((c - nl * ss) * es) % 16;  // = c * es (mod 16)
        const size_t total = tile_off + size_t(nq) * pitch + 16;    // + the span's phase
        if (total <= budget) {
          g->nq = nq;
          g->nq_log2 = __builtin_ctz(unsigned(nq));
          g->levels_per_pass = nl;
          g->pitch = pitch;
          g->win_off = int(win_off);
          g->tile_off = int(tile_off);
          return total;
        }
      }
    }
  }
  return 0;
}

template <typename T, typename OutT>
int taps_launch(const Pyramid& pyr, const float* cents, void* out, const TapsArgs& g, size_t smem,
                cudaStream_t stream) {
  const int s = 2 * g.radius + 1;
  auto kernel = s == 9 ? xtap_lookup_kernel<T, OutT, 9> : s == 7 ? xtap_lookup_kernel<T, OutT, 7>
                                                                 : xtap_lookup_kernel<T, OutT, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  const int64_t grid = (g.q + g.nq - 1) / g.nq;
  if (grid > 0x7fffffff) return int(cudaErrorInvalidValue);
  kernel<<<unsigned(grid), kTapsThreads, smem, stream>>>(pyr, cents, static_cast<OutT*>(out), g);
  return int(cudaGetLastError());
}

// K2 and K4 on a filled pyramid: the plan, then the launch.
int taps_run(const Pyramid& pyr, const void* cents, void* out, int64_t q, int radius, bool k4, void* stream) {
  TapsArgs g;
  g.q = q;
  g.radius = radius;
  const size_t smem = taps_plan(&g, pyr.num_levels, pyr.elem, k4);
  if (smem == 0) return int(cudaErrorInvalidValue);
  if (q == 0) return int(cudaSuccess);
  const float* c = static_cast<const float*>(cents);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pyr.elem == kElemF32) return taps_launch<float, float>(pyr, c, out, g, smem, st);
  if (pyr.elem == kElemBf16) return taps_launch<__nv_bfloat16, __nv_bfloat16>(pyr, c, out, g, smem, st);
  return taps_launch<int8_t, __nv_bfloat16>(pyr, c, out, g, smem, st);
}

}  // namespace

extern "C" {

// K1: out (B, c_out, h, w) = relu(taps @ weight^T + bias); weight is
// (c_out, L*S*S) fp32, bias (c_out,) fp32, cents (Q, 2) fp32 with Q = B*hw;
// levels stored as elem (0 fp32, 1 bf16, 2 int8 with scales (L,) fp32),
// bf16 and int8 levels starting 4-byte aligned; kinds[l] as the kFlat /
// kYdot* enum; out fp32, or bf16 when bf16_product, whose product reads
// weight_bf16: W rounded to bf16, (c_out, k_pad) with k_pad = L*S*S rounded
// up to a multiple of 16, zero past L*S*S, 16-byte aligned (null otherwise).
// Returns a cudaError_t.
int xtap_project_launch(const void* const* levels, const int* heights, const int* widths,
                        const int* kinds, int num_levels, int elem, const void* scales, const void* cents,
                        const void* weight, const void* bias, void* out, int64_t q, int64_t hw, int radius,
                        int c_out, int bf16_product, const void* weight_bf16, void* stream) {
  Pyramid pyr;
  if (!fill_pyramid(levels, heights, widths, kinds, num_levels, elem, scales, radius, &pyr) || q < 0 ||
      hw < 1 || c_out < 1)
    return int(cudaErrorInvalidValue);
  ProjectArgs g;
  g.q = q;
  g.hw = hw;
  g.radius = radius;
  g.c_in = num_levels * (2 * radius + 1) * (2 * radius + 1);
  g.c_out = c_out;
  const size_t smem = project_smem(&g, elem, bf16_product != 0);
  g.vec_w = g.c_in % 4 == 0 && aligned16(weight);
  g.vec_out = hw % 4 == 0 && aligned16(out);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (bf16_product && (weight_bf16 == nullptr || !aligned16(weight_bf16))) return int(cudaErrorInvalidValue);
  for (int l = 0; l < num_levels; ++l)  // the 4-byte window copies align down from in-range cells
    if (elem != kElemF32 && (reinterpret_cast<uintptr_t>(levels[l]) & 3) != 0) return int(cudaErrorInvalidValue);
  const int64_t n_tiles = (int64_t(c_out) + kBN - 1) / kBN;
  const int64_t q_tiles = (q + kBM - 1) / kBM;
  if (n_tiles > 65535 || q_tiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  if (q == 0) return int(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(n_tiles));
  const float* c = static_cast<const float*>(cents);
  const void* w = bf16_product ? weight_bf16 : weight;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem * 2 + (bf16_product ? 1 : 0)) {
    case 0: return project_launch<float, false>(pyr, c, w, b, out, g, smem, grid, st);
    case 1: return project_launch<float, true>(pyr, c, w, b, out, g, smem, grid, st);
    case 2: return project_launch<__nv_bfloat16, false>(pyr, c, w, b, out, g, smem, grid, st);
    case 3: return project_launch<__nv_bfloat16, true>(pyr, c, w, b, out, g, smem, grid, st);
    case 4: return project_launch<int8_t, false>(pyr, c, w, b, out, g, smem, grid, st);
    default: return project_launch<int8_t, true>(pyr, c, w, b, out, g, smem, grid, st);
  }
}

// K2: out (Q, L*S*S) taps in the reference channel order; fp32 for fp32
// levels, bf16 for bf16 and int8 levels, which may start at any address
// (arguments as K1's).
int xtap_lookup_launch(const void* const* levels, const int* heights, const int* widths, const int* kinds,
                       int num_levels, int elem, const void* scales, const void* cents, void* out, int64_t q,
                       int radius, void* stream) {
  Pyramid pyr;
  if (!fill_pyramid(levels, heights, widths, kinds, num_levels, elem, scales, radius, &pyr) || q < 0)
    return int(cudaErrorInvalidValue);
  return taps_run(pyr, cents, out, q, radius, false, stream);
}

// K4: the same taps from fp32 levels, every level flat (K2's fp32 form), at
// the radii K4 takes; levels[l] is (Q, heights[l], widths[l]) fp32, cents
// (Q, 2) level-0 (x, y). Returns a cudaError_t.
int lookup_dense_launch(const void* const* levels, const int* heights, const int* widths, int num_levels,
                        const void* cents, void* out, int64_t q, int radius, void* stream) {
  const int kinds[kMaxLevels] = {kFlat, kFlat, kFlat, kFlat, kFlat, kFlat, kFlat, kFlat};
  Pyramid pyr;
  if (!fill_pyramid(levels, heights, widths, kinds, num_levels, kElemF32, nullptr, radius, &pyr) || q < 0)
    return int(cudaErrorInvalidValue);
  return taps_run(pyr, cents, out, q, radius, true, stream);
}

}  // extern "C"
