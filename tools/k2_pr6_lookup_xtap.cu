// K2 (the lookup alone) as it stood from PR 6 to PR 9: the earlier form that
// tools/k2_ablation.py times the shipped raft_tpu_torch/kernels/csrc/lookup_xtap.cu
// against, and whose bf16 and int8 taps the shipped form must match bit for
// bit. Cut from that source: K2's kernel, what it calls and its launcher
// (xtap_lookup_launch, the same C interface); K1 is left out.
//
// Its design: one block of 256 threads per tile of 32 queries; each warp
// takes (query, level) pairs and its lanes the S*S taps, each tap four
// scalar loads straight from the level (sample_zero_pad), formed by the
// level's kind (form_tap); the tile's taps in shared memory, then copied
// out element by element as (Q, L*S*S).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // bytes one block may use on sm_90

// K2: queries per block
constexpr int kTile = 32;

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
