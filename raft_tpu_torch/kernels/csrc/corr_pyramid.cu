// All-pairs correlation volume and its pooled pyramid in one pass, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of raft_tpu/kernels/corr_pallas.py:
//   corr_pyramid_kernel <- _kernel (K3, line 64, called at line 160): the
//       corr_impl='pallas' pyramid build, once per frame pair.
//
// What it computes, per batch element b, for query q and key k of the
// (h, w) feature grid (Q = h*w, C channels, f1/f2 NCHW):
//   level 0:  v0[b*Q + q, ky, kx] = (sum_c f1[b, c, q] * f2[b, c, k]) * scale,
//             scale = 1/sqrt(C), the sum in fp32;
//   level l:  v_l = VALID 2x2 average pool of v_{l-1} over the key axes, odd
//             tails dropped (h_l = h_{l-1} / 2, w_l = w_{l-1} / 2), each
//             cell summed as ((a + b) + c) + d and divided by 4, the order
//             of PyTorch's avg_pool2d; every level written once, fp32.
// The plain version is models/corr.py correlation_volume + pool_pyramid.
//
// What bounds it on an H100 (raft_small at Sintel 440x1024: Q = 7040,
// C = 128, 4 levels): 2*Q*Q*C = 12.7 GFLOP of fp32 FMA, 0.189 ms at
// 67 TFLOP/s (no tensor cores: TF32 would change the answer), against
// 7.2 MB of features in and 261 MB of levels out, 0.080 ms at 3.35 TB/s:
// operations bound it. raft_large (C = 256) doubles the operations.
//
// Design (simple and correct first; wgmma/TMA are later work):
//   * a block owns TQ queries of one batch element and a band of
//     R = 2^(L-1) whole level-0 key rows by TW key columns (TW a multiple
//     of R), N = R*TW keys; TQ*N = 8192 level-0 values per block (for
//     L <= 4: TQ = 64, N = 128, e.g. 8 rows x 16 columns at L = 4);
//   * the TQ x N tile is a shared-memory fp32 GEMM with a K-loop over C in
//     steps of 16: both operands are read coalesced straight from NCHW
//     (queries, resp. key columns, are the contiguous axis), each of the
//     256 threads accumulates a 4-query x 8-key register tile;
//   * the scaled tile is staged in shared memory (32 KB), written out as
//     level 0, and pooled level by level in shared memory (ping-pong with
//     the GEMM staging buffers): the band is aligned to 2^(L-1) rows and
//     the column tile to R columns, so every pooled cell's four parents
//     are in the block and the level-0 volume is never read back;
//   * a cell is written only if it exists (index below that level's
//     h_l / w_l), so odd tails drop exactly as the plain version drops
//     them; ragged Q and partial bands/column tiles are masked by bounds
//     checks, with no padding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileValues = 8192;  // TQ * N level-0 values per block
constexpr int kKc = 16;            // channels per K step
constexpr int kMaxLevels = 6;      // TQ = 8192 / N stays >= 4 up to here
constexpr size_t kMaxSmem = 232448;

struct Levels {
  float* out[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int num;
};

struct Geometry {
  int c, h, w, q;  // channels, level-0 grid, q = h*w
  int band;        // R = 2^(L-1) key rows per block
  int tw;          // key columns per block
  int n;           // R * tw keys per block
  int tq;          // queries per block
  int col_tiles;
  float scale;
};

__global__ void __launch_bounds__(kThreads)
corr_pyramid_kernel(const float* __restrict__ f1, const float* __restrict__ f2, Levels lv,
                    Geometry g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tq = g.tq;
  const int n = g.n;
  float* tile = smem;               // tq x n level-0 values
  float* a_s = smem + kTileValues;  // kKc x tq, later a pooled level
  float* b_s = a_s + kKc * tq;      // kKc x n

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * tq;
  const int nq = min(tq, g.q - q0);
  const int band = blockIdx.y / g.col_tiles;
  const int y0 = band * g.band;
  const int x0 = (blockIdx.y - band * g.col_tiles) * g.tw;
  const float* f1b = f1 + int64_t(b) * g.c * g.q;
  const float* f2b = f2 + int64_t(b) * g.c * g.q;

  const int tid = threadIdx.x;
  const int tm = tid % (tq / 4);  // 4 queries: tm*4 .. tm*4+3
  const int tn = tid / (tq / 4);  // 8 keys: tn*8 .. tn*8+7
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.c; k0 += kKc) {
    for (int idx = tid; idx < kKc * tq; idx += kThreads) {
      const int kk = idx / tq;
      const int t = idx - kk * tq;
      const int k = k0 + kk;
      a_s[idx] = (k < g.c && t < nq) ? __ldg(f1b + int64_t(k) * g.q + q0 + t) : 0.f;
    }
    for (int idx = tid; idx < kKc * n; idx += kThreads) {
      const int kk = idx / n;
      const int j = idx - kk * n;
      const int r = j / g.tw;
      const int y = y0 + r;
      const int x = x0 + (j - r * g.tw);
      const int k = k0 + kk;
      b_s[idx] = (k < g.c && y < g.h && x < g.w) ? __ldg(f2b + int64_t(k) * g.q + y * g.w + x) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKc; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(a_s + kk * tq + tm * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * n + tn * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + kk * n + tn * 8 + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) tile[(tm * 4 + i) * n + tn * 8 + j] = acc[i][j] * g.scale;
  __syncthreads();

  // level 0: each existing cell of the tile once
  {
    float* out = lv.out[0];
    for (int idx = tid; idx < tq * n; idx += kThreads) {
      const int t = idx / n;
      const int j = idx - t * n;
      const int r = j / g.tw;
      const int y = y0 + r;
      const int x = x0 + (j - r * g.tw);
      if (t < nq && y < g.h && x < g.w)
        out[(int64_t(b) * g.q + q0 + t) * g.q + y * g.w + x] = tile[idx];
    }
  }

  // levels 1..L-1, each from the one above it, in shared memory
  const float* src = tile;
  float* dst = a_s;
  int rs = g.band;
  int ws = g.tw;
  for (int l = 1; l < lv.num; ++l) {
    const int rd = rs / 2;
    const int wd = ws / 2;
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const int yl0 = y0 >> l;
    const int xl0 = x0 >> l;
    float* out = lv.out[l];
    for (int idx = tid; idx < tq * rd * wd; idx += kThreads) {
      const int t = idx / (rd * wd);
      const int rem = idx - t * (rd * wd);
      const int rr = rem / wd;
      const int cc = rem - rr * wd;
      const float* s = src + t * rs * ws + (2 * rr) * ws + 2 * cc;
      const float v = (((s[0] + s[1]) + s[ws]) + s[ws + 1]) / 4.f;
      dst[idx] = v;
      const int yl = yl0 + rr;
      const int xl = xl0 + cc;
      if (t < nq && yl < hl && xl < wl)
        out[((int64_t(b) * g.q + q0 + t) * hl + yl) * wl + xl] = v;
    }
    __syncthreads();
    float* next = const_cast<float*>(src);
    src = dst;
    dst = next;
    rs = rd;
    ws = wd;
  }
}

}  // namespace

extern "C" {

// K3: f1, f2 (B, C, h, w) fp32 contiguous; outs[l] (B*h*w, h_l, w_l) fp32
// with h_l = h_{l-1} / 2, w_l = w_{l-1} / 2, every level at least 1x1.
// Returns a cudaError_t.
int corr_pyramid_launch(const void* f1, const void* f2, void* const* outs, int b, int c, int h,
                        int w, int num_levels, float scale, void* stream) {
  if (b < 1 || c < 1 || h < 1 || w < 1 || num_levels < 1 || num_levels > kMaxLevels)
    return int(cudaErrorInvalidValue);
  Levels lv;
  int hl = h;
  int wl = w;
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < num_levels) {
      if (hl < 1 || wl < 1 || outs[l] == nullptr) return int(cudaErrorInvalidValue);
      lv.out[l] = static_cast<float*>(outs[l]);
      lv.h[l] = hl;
      lv.w[l] = wl;
      hl /= 2;
      wl /= 2;
    } else {
      lv.out[l] = nullptr;
      lv.h[l] = 0;
      lv.w[l] = 0;
    }
  }
  lv.num = num_levels;

  Geometry g;
  g.c = c;
  g.h = h;
  g.w = w;
  g.q = h * w;
  g.band = 1 << (num_levels - 1);
  g.tw = g.band * g.band >= 128 ? g.band : 128 / g.band;
  g.n = g.band * g.tw;
  g.tq = kTileValues / g.n;
  g.col_tiles = (w + g.tw - 1) / g.tw;
  g.scale = scale;
  const int bands = (h + g.band - 1) / g.band;
  const int64_t y_blocks = int64_t(bands) * g.col_tiles;
  if (y_blocks > 65535 || b > 65535 || int64_t(h) * w > (int64_t(1) << 30))
    return int(cudaErrorInvalidValue);

  const size_t smem = (size_t(kTileValues) + size_t(kKc) * (g.tq + g.n)) * sizeof(float);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corr_pyramid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  const dim3 grid(unsigned((g.q + g.tq - 1) / g.tq), unsigned(y_blocks), unsigned(b));
  corr_pyramid_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), lv, g);
  return int(cudaGetLastError());
}

}  // extern "C"
