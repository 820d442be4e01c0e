// Multi-scale correlation lookup, with and without the fused convcorr1
// projection, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of raft_tpu/kernels/lookup_xtap.py:
//   xtap_project_kernel <- _xtap_project_kernel (K1, line 412): lookup +
//       relu(taps @ W^T + b), one launch per refinement step;
//   xtap_lookup_kernel  <- _xtap_kernel (K2, line 385): the taps alone.
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
//   K2: the same 11 MB of windows plus a 9 MB tap output, 6 us: bytes bound
//       it; the interpolation arithmetic is negligible.
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
//   * NaN centroids give NaN taps (their fraction is NaN); far-off
//     centroids are clamped just outside the level, as K2 clamps them.
//
// K2's design (xtap_lookup_kernel; off the model path, unchanged):
//   * one block of 256 threads per tile of 32 queries;
//   * each warp takes (query, level) pairs and its lanes the S*S taps, x
//     offset fastest so neighbouring lanes read neighbouring addresses;
//     every tap is a 4-corner gather straight from the level, no TPU-style
//     packing, padding or row permutation, so any level size works;
//   * the tile's taps live in shared memory (32 x 324 fp32 = 41 KB, rows
//     padded to a multiple of 4 floats) and are copied out coalesced as
//     (Q, L*S*S).
// Ragged tiles (Q not a multiple of 32) are masked; batch > 1 is handled
// by computing (b, p) from q.
//
// Reduced-precision forms (the has_scales / weight_dtype / mxu_dtype paths
// of raft_tpu/kernels/lookup_xtap.py, l.263-283, 380-381, 438-447), both
// kernels, chosen per launch:
//   * levels stored as fp32, bf16, or int8 with one fp32 dequantization
//     factor per level (scales, read on the card: no host sync). A value is
//     loaded and widened to fp32 exactly (bf16 -> fp32, int8 -> fp32); K1's
//     windows then go to shared memory as fp32 by plain loads, not cp.async
//     (a 2- or 1-byte element has no 4-byte copy), so its shared memory
//     layout is the fp32 one.
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
//   * K1's product at bf16 (proj_dtype): the A and B operands are rounded
//     to bf16 (RNE) where the fp32 ones are split; a bf16 value is exact in
//     TF32 (8 against 10 mantissa bits), so one m16n8k8 TF32 pass of them,
//     accumulated in fp32, is the exact bf16 product; the bias is added in
//     fp32, relu, and the result stored as bf16. At fp32 the product stays
//     3xTF32 whatever the levels' storage.
// What bounds them: the same operations as the fp32 forms (one TF32 pass
// instead of three for K1's bf16 product), and fewer bytes of windows (2x
// fewer for bf16, 4x for int8) and, for bf16 outputs, half the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // bytes one block may use on sm_90

// K2: queries per block
constexpr int kTile = 32;

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
constexpr int kRingFloats = kStages * kStageFloats;
constexpr int kLdt = kBM + 4;  // epilogue row, 36 = 4 (mod 16): conflict-free stores
constexpr int kTileFloats = kBN * kLdt;
static_assert(kBM % kWM == 0 && kWM % 16 == 0 && kWN % 8 == 0 && kKC % 8 == 0, "m16n8k8 fragments");

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
  int k_pad;            // c_in rounded up to a multiple of 8
  int lda;              // A tile row: k_pad + 4 = 4 (mod 8) floats
  int levels_per_pass;  // windows of this many levels fit the region
  int region;           // floats of the window / ring / epilogue region
  int vec_w;            // 16-byte weight copies: c_in % 4 == 0, weight aligned
  int vec_out;          // float4 stores: hw % 4 == 0, out aligned
};

// ---- shared: values, taps ----------------------------------------------

// One stored value widened to fp32, exactly.
template <typename T>
__device__ __forceinline__ float load_val(const T* p);
template <>
__device__ __forceinline__ float load_val<float>(const float* p) { return __ldg(p); }
template <>
__device__ __forceinline__ float load_val<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __uint_as_float(uint32_t(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16);
}
template <>
__device__ __forceinline__ float load_val<int8_t>(const int8_t* p) {
  return float(__ldg(reinterpret_cast<const signed char*>(p)));
}

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

// ---- K2: 4-corner gather ------------------------------------------------

// Tap of the (h, w) grid at (x, y) with zero padding, formed by kind.
template <typename T>
__device__ __forceinline__ float sample_zero_pad(const T* __restrict__ vol, int h, int w, float x, float y,
                                                 int kind, float mul) {
  if (isnan(x) || isnan(y)) return nanf("");
  // Beyond one cell outside the grid every corner is out of range; the
  // clamp keeps the float -> int conversion defined for far-off centroids
  // and changes no result.
  x = fminf(fmaxf(x, -2.f), float(w) + 1.f);
  y = fminf(fmaxf(y, -2.f), float(h) + 1.f);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int x0 = int(x0f);
  const int y0 = int(y0f);
  const bool xa = x0 >= 0 && x0 < w;
  const bool xb = x0 + 1 >= 0 && x0 + 1 < w;
  const bool ya = y0 >= 0 && y0 < h;
  const bool yb = y0 + 1 >= 0 && y0 + 1 < h;
  const float v00 = (ya && xa) ? load_val(vol + y0 * w + x0) : 0.f;
  const float v01 = (ya && xb) ? load_val(vol + y0 * w + x0 + 1) : 0.f;
  const float v10 = (yb && xa) ? load_val(vol + (y0 + 1) * w + x0) : 0.f;
  const float v11 = (yb && xb) ? load_val(vol + (y0 + 1) * w + x0 + 1) : 0.f;
  return form_tap(kind, v00, v01, v10, v11, fx, fy, y, y0, mul);
}

// Fill taps[t * row + c] (c = l*S*S + i*S + j) for the nq queries of the
// tile starting at q0; padding columns and rows past nq are zero.
template <typename T>
__device__ void gather_taps(const Pyramid& pyr, const float* __restrict__ cents, int64_t q0, int nq,
                            int radius, int row, float* taps) {
  const int s = 2 * radius + 1;
  const int ss = s * s;
  const int c_in = pyr.num_levels * ss;
  for (int idx = threadIdx.x; idx < kTile * row; idx += blockDim.x) {
    const int t = idx / row;
    if (t >= nq || idx - t * row >= c_in) taps[idx] = 0.f;
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int pair = warp; pair < nq * pyr.num_levels; pair += nwarps) {
    const int t = pair / pyr.num_levels;
    const int l = pair - t * pyr.num_levels;
    const int64_t q = q0 + t;
    const float inv = 1.f / float(1 << l);  // exact: a power of two
    const float cx = cents[2 * q] * inv;
    const float cy = cents[2 * q + 1] * inv;
    const int hl = pyr.h[l];
    const int wl = pyr.w[l];
    const T* vol = static_cast<const T*>(pyr.level[l]) + q * int64_t(hl) * wl;
    const int kind = pyr.kind[l];
    const float mul = level_mul(pyr, l);
    float* dst = taps + t * row + l * ss;
    for (int ij = lane; ij < ss; ij += 32) {
      const int j = ij / s;
      const int i = ij - j * s;
      dst[i * s + j] =
          sample_zero_pad(vol, hl, wl, cx + float(i - radius), cy + float(j - radius), kind, mul);
    }
  }
}

// OutT: fp32 taps for fp32 levels, bf16 for bf16 and int8 levels.
template <typename T, typename OutT>
__global__ void __launch_bounds__(kThreads)
xtap_lookup_kernel(Pyramid pyr, const float* __restrict__ cents, OutT* __restrict__ out, int64_t q,
                   int radius, int row) {
  extern __shared__ float4 smem[];
  float* taps = reinterpret_cast<float*>(smem);
  const int64_t q0 = int64_t(blockIdx.x) * kTile;
  const int nq = int(q - q0 < kTile ? q - q0 : kTile);
  gather_taps<T>(pyr, cents, q0, nq, radius, row, taps);
  __syncthreads();

  const int s = 2 * radius + 1;
  const int c_in = pyr.num_levels * s * s;
  OutT* dst = out + q0 * c_in;
  for (int idx = threadIdx.x; idx < nq * c_in; idx += blockDim.x) {
    const int t = idx / c_in;
    store_val(dst + idx, taps[t * row + (idx - t * c_in)]);
  }
}

// ---- K1: window gather, 3xTF32 product, NCHW epilogue -------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero-fill: src_bytes of 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), in two integer instructions: half a TF32 ulp added to the
// bits, the 13 low mantissa bits cleared (K3's helper).
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

// 3xTF32: lo*hi + hi*lo, then hi*hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2], const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// Window cell (y, x) of a level into shared memory as fp32: cp.async for
// fp32 levels, a widening load for bf16 and int8 ones; zero outside.
template <typename T>
__device__ __forceinline__ void copy_cell(float* dst, const T* vol, int64_t off, bool ok) {
  *dst = ok ? load_val(vol + off) : 0.f;
}
template <>
__device__ __forceinline__ void copy_cell<float>(float* dst, const float* vol, int64_t off, bool ok) {
  cp_async4(dst, ok ? vol + off : vol, ok);
}

// Taps of the block's queries into the A tile a[t * lda + k]; rows past nq
// and K's padding columns are zero. win is the window region; at[t *
// kMaxLevels + l] holds the window of (query t, level l): its first cell
// (xs, ys) as int bits, the fraction fx and the clamped centre y.
template <typename T>
__device__ __forceinline__ void gather_windows(const Pyramid& pyr, const float* __restrict__ cents,
                                               int64_t q0, int nq, const ProjectArgs& g, float* a,
                                               float* win, float4* at) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = 2 * g.radius + 1;
  const int s1 = s + 1;
  const int ss = s * s;
  const int ww = s1 * s1;
  // every (query, level) window at once: one centroid latency a block
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
      const T* vol = static_cast<const T*>(pyr.level[l]) + (q0 + t) * int64_t(hl) * wl;
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
    // the level's kind (form_tap; the flat form in sample_zero_pad's order)
    for (int pair = warp; pair < kBM * nl; pair += kProjWarps) {
      const int t = pair / nl;
      const int l = l0 + pair - t * nl;
      float* dst = a + t * g.lda + l * ss;
      if (t >= nq) {
        for (int ij = lane; ij < ss; ij += 32) dst[ij] = 0.f;
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
          dst[ij] = (1.f - fy) * ((1.f - fx) * c[0] + fx * c[1]) + fy * ((1.f - fx) * c[s1] + fx * c[s1 + 1]);
        } else {
          dst[ij] = form_tap(kind, c[0], c[1], c[s1], c[s1 + 1], fx, fy,
                             __fadd_rn(wd.w, float(j - g.radius)), ys + j, mul);
        }
      }
    }
  }
  const int pad = g.k_pad - g.c_in;
  for (int idx = threadIdx.x; idx < kBM * pad; idx += kProjThreads) {
    const int t = idx / pad;
    a[t * g.lda + g.c_in + idx - t * pad] = 0.f;
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

// x rounded to bf16 (RNE), as TF32 operand bits: exact in TF32.
__device__ __forceinline__ uint32_t bf16_bits(float x) { return __float_as_uint(bf16_round(x)); }

// T: the levels' storage; kBf16: the product at bf16 (operands rounded to
// bf16, one TF32 pass, bf16 output), else 3xTF32 with fp32 output.
template <typename T, bool kBf16>
__global__ void __launch_bounds__(kProjThreads, kProjBlocksPerSm)
xtap_project_kernel(Pyramid pyr, const float* __restrict__ cents, const float* __restrict__ weight,
                    const float* __restrict__ bias, void* __restrict__ out_ptr, ProjectArgs g) {
  using OutT = typename std::conditional<kBf16, __nv_bfloat16, float>::type;
  OutT* out = static_cast<OutT*>(out_ptr);
  extern __shared__ float4 smem4[];
  float* a = reinterpret_cast<float*>(smem4);                  // [query][k] taps
  float* region = a + kBM * g.lda;                             // windows, then ring, then tile
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

  gather_windows<T>(pyr, cents, q0, nq, g, a, region, at);
  __syncthreads();  // A is complete; the windows are dead

  float acc[kMf][kNf][4];
#pragma unroll
  for (int i = 0; i < kMf; ++i)
#pragma unroll
    for (int j = 0; j < kNf; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_tiles = (g.k_pad + kKC - 1) / kKC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_w_stage(region + s * kStageFloats, weight, s * kKC, n0, g);
    cp_async_commit();
  }
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice kt landed for all; slice kt-1 is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_w_stage(region + (next % kStages) * kStageFloats, weight, next * kKC, n0, g);
    cp_async_commit();
    if (!warp_live) continue;
    const float* ws = region + (kt % kStages) * kStageFloats;
    const int k0 = kt * kKC;
#pragma unroll
    for (int k8 = 0; k8 < kKC; k8 += 8) {
      if (k0 + k8 >= g.k_pad) break;
      if constexpr (kBf16) {
        uint32_t af[kMf][4];
#pragma unroll
        for (int i = 0; i < kMf; ++i) {
          const float* ap = a + (wm0 + i * 16 + gid) * g.lda + k0 + k8 + tig;
          af[i][0] = bf16_bits(ap[0]);
          af[i][1] = bf16_bits(ap[8 * g.lda]);
          af[i][2] = bf16_bits(ap[4]);
          af[i][3] = bf16_bits(ap[8 * g.lda + 4]);
        }
#pragma unroll
        for (int j = 0; j < kNf; ++j) {
          const float* bp = ws + (wn0 + j * 8 + gid) * kLdw + k8 + tig;
          const uint32_t bf[2] = {bf16_bits(bp[0]), bf16_bits(bp[4])};
#pragma unroll
          for (int i = 0; i < kMf; ++i) mma_tf32(acc[i][j], af[i], bf);
        }
      } else {
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
  float* tile = region;
  if (warp_live) {
#pragma unroll
    for (int j = 0; j < kNf; ++j) {
      const int n = wn0 + j * 8 + 2 * tig;
      const float b0 = n0 + n < g.c_out ? __ldg(bias + n0 + n) : 0.f;
      const float b1 = n0 + n + 1 < g.c_out ? __ldg(bias + n0 + n + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < kMf; ++i) {
        float* p = tile + n * kLdt + wm0 + i * 16 + gid;
        p[0] = fmaxf(acc[i][j][0] + b0, 0.f);
        p[kLdt] = fmaxf(acc[i][j][1] + b1, 0.f);
        p[8] = fmaxf(acc[i][j][2] + b0, 0.f);
        p[kLdt + 8] = fmaxf(acc[i][j][3] + b1, 0.f);
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

// K1's shared memory: the A tile, the window / ring / epilogue region
// (at least one level's windows) and the table of windows.
size_t project_smem(ProjectArgs* g) {
  const int s1 = 2 * g->radius + 2;
  const int win_level = kBM * s1 * s1;  // floats of one level's windows
  g->k_pad = (g->c_in + 7) & ~7;
  g->lda = g->k_pad + 4;
  g->region = kRingFloats > kTileFloats ? kRingFloats : kTileFloats;
  if (win_level > g->region) g->region = win_level;
  g->levels_per_pass = g->region / win_level;
  return (size_t(kBM) * g->lda + size_t(g->region) + 4 * size_t(kBM) * kMaxLevels) * sizeof(float);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T, bool kBf16>
int project_launch(const Pyramid& pyr, const float* cents, const float* weight, const float* bias,
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

template <typename T, typename OutT>
int lookup_launch(const Pyramid& pyr, const float* cents, void* out, int64_t q, int radius, int row,
                  size_t smem, cudaStream_t stream) {
  auto kernel = xtap_lookup_kernel<T, OutT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const unsigned grid = unsigned((q + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(pyr, cents, static_cast<OutT*>(out), q, radius, row);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1: out (B, c_out, h, w) = relu(taps @ weight^T + bias); weight is
// (c_out, L*S*S) fp32, bias (c_out,) fp32, cents (Q, 2) fp32 with Q = B*hw;
// levels stored as elem (0 fp32, 1 bf16, 2 int8 with scales (L,) fp32),
// kinds[l] as the kFlat / kYdot* enum; out fp32, or bf16 when bf16_product.
// Returns a cudaError_t.
int xtap_project_launch(const void* const* levels, const int* heights, const int* widths,
                        const int* kinds, int num_levels, int elem, const void* scales, const void* cents,
                        const void* weight, const void* bias, void* out, int64_t q, int64_t hw, int radius,
                        int c_out, int bf16_product, void* stream) {
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
  const size_t smem = project_smem(&g);
  g.vec_w = g.c_in % 4 == 0 && aligned16(weight);
  g.vec_out = hw % 4 == 0 && aligned16(out);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  const int64_t n_tiles = (int64_t(c_out) + kBN - 1) / kBN;
  const int64_t q_tiles = (q + kBM - 1) / kBM;
  if (n_tiles > 65535 || q_tiles > 0x7fffffff) return int(cudaErrorInvalidValue);
  if (q == 0) return int(cudaSuccess);
  const dim3 grid(static_cast<unsigned>(q_tiles), static_cast<unsigned>(n_tiles));
  const float* c = static_cast<const float*>(cents);
  const float* w = static_cast<const float*>(weight);
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
// levels, bf16 for bf16 and int8 levels (arguments as K1's).
int xtap_lookup_launch(const void* const* levels, const int* heights, const int* widths, const int* kinds,
                       int num_levels, int elem, const void* scales, const void* cents, void* out, int64_t q,
                       int radius, void* stream) {
  Pyramid pyr;
  if (!fill_pyramid(levels, heights, widths, kinds, num_levels, elem, scales, radius, &pyr) || q < 0)
    return int(cudaErrorInvalidValue);
  const int s = 2 * radius + 1;
  const int row = (num_levels * s * s + 3) & ~3;  // tap rows padded to a multiple of 4 floats
  const size_t smem = size_t(kTile) * size_t(row) * sizeof(float);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (q == 0) return int(cudaSuccess);
  const float* c = static_cast<const float*>(cents);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem == kElemF32) return lookup_launch<float, float>(pyr, c, out, q, radius, row, smem, st);
  if (elem == kElemBf16) return lookup_launch<__nv_bfloat16, __nv_bfloat16>(pyr, c, out, q, radius, row, smem, st);
  return lookup_launch<int8_t, __nv_bfloat16>(pyr, c, out, q, radius, row, smem, st);
}

}  // extern "C"
