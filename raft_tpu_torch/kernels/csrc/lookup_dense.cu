// Multi-scale correlation lookup in separable form (y-pass, then x-pass),
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of raft_tpu/kernels/lookup_pallas.py:
//   lookup_dense_kernel <- _kernel (K4, line 50, called at line 136), the
//       kernel behind lookup_pyramid_pallas. It computes the same taps as
//       K2 (lookup_xtap.cu), here in the separable order of the plain
//       version (models/corr.py separable_taps): first the y-weights
//       against the level, then the x-weights against that result.
//
// What it computes, for query q (Q = B*h*w), level l, x-offset i and
// y-offset j (S = 2r+1), with (cx, cy) = centroid / 2^l:
//   t[j, x]  = sum_y relu(1 - |cy + j - r - y|) * vol[q, y, x]
//   taps[q, l*S*S + i*S + j] = sum_x relu(1 - |cx + i - r - x|) * t[j, x]
// over the level's grid, so taps outside it are zero. Each weight row has
// at most two nonzero entries (floor(p) and floor(p) + 1), and the kernel
// evaluates only those: the TPU kernel's dense iota-built weight matrices
// and its matmuls are a layout for the MXU, not part of the function.
//
// What bounds it on an H100 (raft_large at Sintel: Q = 7040, L = 4,
// r = 4): the bytes. Each query reads at most a (S+1) x (S+2) window per
// level (the (S+1)^2 the taps touch, counted in the bound) and writes
// L*S*S fp32 taps, ~20 MB in all, 6 us at 3.35 TB/s; the arithmetic is
// a few FMA per tap.
//
// Design (simple and correct first):
//   * one warp per (query, level) pair, 8 warps per 256-thread block;
//   * y-pass: the lanes fill a warp-private S x (S+2) tile in shared
//     memory, t[j][xx] for the columns x = floor(cx) - r + xx (S+2 of
//     them cover every tap's two x-corners even where cx + i - r rounds up
//     to the next integer), zero outside the level;
//   * x-pass: each lane takes taps (i, j) and combines the two t entries
//     of its x-corners; the L*S*S taps of a query are contiguous, so the
//     stores are coalesced;
//   * centroids far outside the level are clamped to r + 3 cells outside
//     it, which keeps every corner out of range (the taps stay zero) and
//     the float -> int conversion defined; NaN centroids give NaN taps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;

struct Pyramid {
  const float* level[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int num_levels;
};

__global__ void __launch_bounds__(kThreads)
lookup_dense_kernel(Pyramid pyr, const float* __restrict__ cents, float* __restrict__ out,
                    int64_t q, int radius) {
  extern __shared__ float smem[];
  const int s = 2 * radius + 1;
  const int ss = s * s;
  const int span = s + 2;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* t = smem + warp * s * span;
  const int num_levels = pyr.num_levels;
  const int64_t pair = int64_t(blockIdx.x) * kWarps + warp;
  if (pair >= q * num_levels) return;  // warp-uniform: no block barrier below
  const int64_t qi = pair / num_levels;
  const int l = int(pair - qi * num_levels);
  const float inv = 1.f / float(1 << l);  // exact: a power of two
  float cx = cents[2 * qi] * inv;
  float cy = cents[2 * qi + 1] * inv;
  float* dst = out + qi * (int64_t(num_levels) * ss) + l * ss;
  if (isnan(cx) || isnan(cy)) {
    for (int ij = lane; ij < ss; ij += 32) dst[ij] = nanf("");
    return;
  }
  const int hl = pyr.h[l];
  const int wl = pyr.w[l];
  const float* vol = pyr.level[l] + qi * int64_t(hl) * wl;
  cx = fminf(fmaxf(cx, -float(radius + 3)), float(wl + radius + 2));
  cy = fminf(fmaxf(cy, -float(radius + 3)), float(hl + radius + 2));
  const int xbase = int(floorf(cx)) - radius;

  for (int idx = lane; idx < s * span; idx += 32) {
    const int j = idx / span;
    const int x = xbase + (idx - j * span);
    const float py = cy + float(j - radius);
    const float y0f = floorf(py);
    const float fy = py - y0f;
    const int y0 = int(y0f);
    float v = 0.f;
    if (x >= 0 && x < wl) {
      const float a = (y0 >= 0 && y0 < hl) ? __ldg(vol + y0 * wl + x) : 0.f;
      const float b = (y0 + 1 >= 0 && y0 + 1 < hl) ? __ldg(vol + (y0 + 1) * wl + x) : 0.f;
      v = (1.f - fy) * a + fy * b;
    }
    t[idx] = v;
  }
  __syncwarp();

  for (int ij = lane; ij < ss; ij += 32) {
    const int i = ij / s;
    const int j = ij - i * s;
    const float px = cx + float(i - radius);
    const float x0f = floorf(px);
    const float fx = px - x0f;
    const int k = int(x0f) - xbase;  // i or i + 1
    const float* row = t + j * span;
    dst[ij] = (1.f - fx) * row[k] + fx * row[k + 1];
  }
}

}  // namespace

extern "C" {

// K4: out (Q, L*S*S) taps in the reference channel order; levels[l] is
// (Q, heights[l], widths[l]) fp32, cents (Q, 2) level-0 (x, y). Returns a
// cudaError_t.
int lookup_dense_launch(const void* const* levels, const int* heights, const int* widths,
                        int num_levels, const void* cents, void* out, int64_t q, int radius,
                        void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 0 || q < 0)
    return int(cudaErrorInvalidValue);
  Pyramid pyr;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < num_levels;
    if (used && (heights[l] < 1 || widths[l] < 1 || levels[l] == nullptr))
      return int(cudaErrorInvalidValue);
    pyr.level[l] = used ? static_cast<const float*>(levels[l]) : nullptr;
    pyr.h[l] = used ? heights[l] : 0;
    pyr.w[l] = used ? widths[l] : 0;
  }
  pyr.num_levels = num_levels;
  const int s = 2 * radius + 1;
  const size_t smem = size_t(kWarps) * s * (s + 2) * sizeof(float);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (q == 0) return int(cudaSuccess);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lookup_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const int64_t pairs = q * num_levels;
  const unsigned grid = unsigned((pairs + kWarps - 1) / kWarps);
  lookup_dense_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pyr, static_cast<const float*>(cents), static_cast<float*>(out), q, radius);
  return int(cudaGetLastError());
}

}  // extern "C"
