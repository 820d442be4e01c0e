// The fp32-FMA form of K1 that raft_tpu_torch/kernels/csrc/lookup_xtap.cu
// replaced: a thread per output channel, the 4-corner gather of every tap,
// the product on the FMA units. Not part of the package: tools/k1_ablation.py
// builds it beside the shipped kernel for a before/after in one process.
// It has the shipped source's C entry points.
//
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
//   K1: 2*Q*C_in*C_out = 1.17 GFLOP of fp32 FMA, 17 us at 67 TFLOP/s,
//       against ~19 MB of bytes (the (S+1)^2 windows the taps touch, 11 MB,
//       plus the 7 MB output), 6 us at 3.35 TB/s: operations bound it.
//   K2: the same 11 MB of windows plus a 9 MB tap output, 6 us: bytes bound
//       it; the interpolation arithmetic is negligible.
//
// Design (simple and correct first; the fast form is later work):
//   * one block of 256 threads per tile of 32 queries;
//   * each warp takes (query, level) pairs and its lanes the S*S taps, x
//     offset fastest so neighbouring lanes read neighbouring addresses;
//     every tap is a 4-corner gather straight from the level, no TPU-style
//     packing, padding or row permutation, so any level size works;
//   * the tile's taps live in shared memory (32 x 324 fp32 = 41 KB, rows
//     padded to a multiple of 4 floats);
//   * K1: each thread owns an output channel and accumulates the 32
//     queries' dot products in fp32 registers, reading the taps as float4
//     broadcasts from shared memory and W (C_out, C_in) in the reference
//     row order; bias + relu, written straight to NCHW (B, C_out, h, w);
//   * K2: the taps are copied out coalesced as (Q, L*S*S).
// Ragged tiles (Q not a multiple of 32) are masked; batch > 1 is handled
// by computing (b, p) from q.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTile = 32;
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // bytes one block may use on sm_90

struct Pyramid {
  const float* level[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int num_levels;
};

// Bilinear sample of the (h, w) grid at (x, y) with zero padding.
__device__ __forceinline__ float sample_zero_pad(const float* __restrict__ vol, int h, int w,
                                                 float x, float y) {
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
  const float v00 = (ya && xa) ? __ldg(vol + y0 * w + x0) : 0.f;
  const float v01 = (ya && xb) ? __ldg(vol + y0 * w + x0 + 1) : 0.f;
  const float v10 = (yb && xa) ? __ldg(vol + (y0 + 1) * w + x0) : 0.f;
  const float v11 = (yb && xb) ? __ldg(vol + (y0 + 1) * w + x0 + 1) : 0.f;
  return (1.f - fy) * ((1.f - fx) * v00 + fx * v01) + fy * ((1.f - fx) * v10 + fx * v11);
}

// Fill taps[t * row + c] (c = l*S*S + i*S + j) for the nq queries of the
// tile starting at q0; padding columns and rows past nq are zero.
__device__ void gather_taps(const Pyramid& pyr, const float* __restrict__ cents, int64_t q0,
                            int nq, int radius, int row, float* taps) {
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
    const float* vol = pyr.level[l] + q * int64_t(hl) * wl;
    float* dst = taps + t * row + l * ss;
    for (int ij = lane; ij < ss; ij += 32) {
      const int j = ij / s;
      const int i = ij - j * s;
      dst[i * s + j] = sample_zero_pad(vol, hl, wl, cx + float(i - radius), cy + float(j - radius));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
xtap_project_kernel(Pyramid pyr, const float* __restrict__ cents, const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ out, int64_t q, int64_t hw,
                    int radius, int c_out, int row) {
  extern __shared__ float4 smem[];
  float* taps = reinterpret_cast<float*>(smem);
  const int64_t q0 = int64_t(blockIdx.x) * kTile;
  const int nq = int(q - q0 < kTile ? q - q0 : kTile);
  gather_taps(pyr, cents, q0, nq, radius, row, taps);
  __syncthreads();

  const int s = 2 * radius + 1;
  const int c_in = pyr.num_levels * s * s;
  for (int c = threadIdx.x; c < c_out; c += blockDim.x) {
    float acc[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) acc[t] = 0.f;
    const float* wrow = weight + int64_t(c) * c_in;
    int k = 0;
    for (; k + 4 <= c_in; k += 4) {
      const float w0 = __ldg(wrow + k);
      const float w1 = __ldg(wrow + k + 1);
      const float w2 = __ldg(wrow + k + 2);
      const float w3 = __ldg(wrow + k + 3);
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(taps + t * row + k);
        acc[t] = fmaf(a.x, w0, acc[t]);
        acc[t] = fmaf(a.y, w1, acc[t]);
        acc[t] = fmaf(a.z, w2, acc[t]);
        acc[t] = fmaf(a.w, w3, acc[t]);
      }
    }
    for (; k < c_in; ++k) {
      const float wk = __ldg(wrow + k);
#pragma unroll
      for (int t = 0; t < kTile; ++t) acc[t] = fmaf(taps[t * row + k], wk, acc[t]);
    }
    const float bc = __ldg(bias + c);
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      if (t < nq) {
        const int64_t qi = q0 + t;
        const int64_t b = qi / hw;
        const int64_t p = qi - b * hw;
        out[(b * c_out + c) * hw + p] = fmaxf(acc[t] + bc, 0.f);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
xtap_lookup_kernel(Pyramid pyr, const float* __restrict__ cents, float* __restrict__ out,
                   int64_t q, int radius, int row) {
  extern __shared__ float4 smem[];
  float* taps = reinterpret_cast<float*>(smem);
  const int64_t q0 = int64_t(blockIdx.x) * kTile;
  const int nq = int(q - q0 < kTile ? q - q0 : kTile);
  gather_taps(pyr, cents, q0, nq, radius, row, taps);
  __syncthreads();

  const int s = 2 * radius + 1;
  const int c_in = pyr.num_levels * s * s;
  float* dst = out + q0 * c_in;
  for (int idx = threadIdx.x; idx < nq * c_in; idx += blockDim.x) {
    const int t = idx / c_in;
    dst[idx] = taps[t * row + (idx - t * c_in)];
  }
}

// Validates the launch and fills the pyramid descriptor; returns the
// dynamic shared-memory bytes, or 0 when the arguments are invalid.
size_t prepare(const void* const* levels, const int* heights, const int* widths, int num_levels,
               int radius, Pyramid* pyr, int* row) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0) return 0;
  for (int l = 0; l < num_levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1 || levels[l] == nullptr) return 0;
    pyr->level[l] = static_cast<const float*>(levels[l]);
    pyr->h[l] = heights[l];
    pyr->w[l] = widths[l];
  }
  for (int l = num_levels; l < kMaxLevels; ++l) {
    pyr->level[l] = nullptr;
    pyr->h[l] = 0;
    pyr->w[l] = 0;
  }
  pyr->num_levels = num_levels;
  const int s = 2 * radius + 1;
  const int c_in = num_levels * s * s;
  *row = (c_in + 3) & ~3;
  const size_t smem = size_t(kTile) * size_t(*row) * sizeof(float);
  return smem <= kMaxSmem ? smem : 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

}  // namespace

extern "C" {

// K1: out (B, c_out, h, w) = relu(taps @ weight^T + bias); weight is
// (c_out, L*S*S), cents (Q, 2) with Q = B*hw. Returns a cudaError_t.
int xtap_project_launch(const void* const* levels, const int* heights, const int* widths,
                        int num_levels, const void* cents, const void* weight, const void* bias,
                        void* out, int64_t q, int64_t hw, int radius, int c_out, void* stream) {
  Pyramid pyr;
  int row = 0;
  const size_t smem = prepare(levels, heights, widths, num_levels, radius, &pyr, &row);
  if (smem == 0 || q < 0 || hw < 1 || c_out < 1) return int(cudaErrorInvalidValue);
  if (q == 0) return int(cudaSuccess);
  cudaError_t err = allow_smem(xtap_project_kernel, smem);
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned((q + kTile - 1) / kTile);
  xtap_project_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pyr, static_cast<const float*>(cents), static_cast<const float*>(weight),
      static_cast<const float*>(bias), static_cast<float*>(out), q, hw, radius, c_out, row);
  return int(cudaGetLastError());
}

// K2: out (Q, L*S*S) taps in the reference channel order.
int xtap_lookup_launch(const void* const* levels, const int* heights, const int* widths,
                       int num_levels, const void* cents, void* out, int64_t q, int radius,
                       void* stream) {
  Pyramid pyr;
  int row = 0;
  const size_t smem = prepare(levels, heights, widths, num_levels, radius, &pyr, &row);
  if (smem == 0 || q < 0) return int(cudaErrorInvalidValue);
  if (q == 0) return int(cudaSuccess);
  cudaError_t err = allow_smem(xtap_lookup_kernel, smem);
  if (err != cudaSuccess) return int(err);
  const unsigned grid = unsigned((q + kTile - 1) / kTile);
  xtap_lookup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pyr, static_cast<const float*>(cents), static_cast<float*>(out), q, radius, row);
  return int(cudaGetLastError());
}

}  // extern "C"
