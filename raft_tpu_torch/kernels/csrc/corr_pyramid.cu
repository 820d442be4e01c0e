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
//             scale = 1/sqrt(C), at fp32 accuracy;
//   level l:  v_l = VALID 2x2 average pool of v_{l-1} over the key axes, odd
//             tails dropped (h_l = h_{l-1} / 2, w_l = w_{l-1} / 2), each
//             cell summed as ((a + b) + c) + d and divided by 4, the order
//             of PyTorch's avg_pool2d; every level written once, fp32.
// The plain version is models/corr.py correlation_volume + pool_pyramid.
//
// What bounds it on an H100 (raft_small at Sintel 440x1024: Q = 7040,
// C = 128, 4 levels): 2*Q*Q*C = 12.7 GFLOP, which on the fp32 FMA units is
// 0.189 ms at 67 TFLOP/s. This kernel runs the product on the tensor cores
// as 3xTF32 (three TF32 products per fp32 product, below): 38.1 GFLOP,
// 0.077 ms at 495 TFLOP/s. Against that, 7.2 MB of features in and 261 MB
// of levels out take 0.080 ms at 3.35 TB/s, so on the tensor cores the
// bytes it writes bound it. raft_large (C = 256) doubles the operations:
// 0.380 ms on FMA units, 0.154 ms as 3xTF32.
//
// Design, against the four faults of the shared-memory fp32-FMA SGEMM it
// replaces (no tensor cores; a 64 x 128 block tile with a 4 x 8 register
// tile, 12 shared-memory loads for 32 FMAs; scalar staging with no overlap
// of copy and compute; a 16-way bank conflict in the epilogue's tile store):
//   * tensor cores at fp32 accuracy (3xTF32): each operand x is split
//     once, when its fragment is loaded from shared memory, into
//     hi = tf32(x) and lo = tf32(x - hi), both rounded as cvt.rna rounds
//     (to nearest, ties away; tf32_rna below), and every m16n8k8 product
//     accumulates lo*hi + hi*lo first and then hi*hi into fp32 registers
//     (mma.sync). Only lo*lo, about 2^-22 of the product, is dropped, so
//     the answer stays within fp32 rounding of the plain version. A single
//     TF32 pass would not: its 2^-11 operand rounding moves a cell by ~1e-3.
//   * mma.sync, not wgmma: wgmma reads tf32 operands from shared memory
//     only K-major, and both NCHW feature maps are channel-major
//     (M/N-major), so it would need a transpose in shared memory.
//   * a larger tile: a block owns BM queries of one batch element and a
//     band of R = 2^(L-1) whole level-0 key rows by TW key columns (TW a
//     multiple of R), BN = R*TW keys. For L <= 4 it is 128 queries x 128
//     keys (at L = 4 a band of 8 rows x 16 columns), 8 warps of 64 x 32;
//     for L = 5, 64 x 256 (16 x 16); for L = 6, 16 x 1024 (32 x 32). Every
//     thread holds 64 fp32 accumulators; a warp's 8 channels take 24
//     shared-memory loads for 48 tensor-core products (16 fp32 FMA each).
//   * copy overlapped with compute: operands are staged by cp.async in a
//     3-stage ring over K steps of KC channels (32 for L <= 4), read
//     straight from NCHW: queries, resp. key columns, are the contiguous
//     axis. 16-byte copies where Q (resp. w) and the pointer allow it, else
//     4-byte copies; zero-fill (cp.async's src-size) covers ragged Q,
//     partial bands and column tiles and a channel tail that is not a
//     multiple of KC. One __syncthreads per K step; the copies of step k+2
//     fly while step k computes. Each stage's leading dimension is padded
//     to 8 (mod 32) floats, so the fragment loads (lane -> (k = lane % 4,
//     m = lane / 4)) hit 32 distinct banks.
//   * a conflict-free epilogue, in the ring's memory: the scaled
//     accumulators go to a BM x BN tile as float2 in the fragment layout,
//     its rows padded to 8 (mod 32) floats; level 0 goes out with float4
//     stores, neighbouring threads on neighbouring columns (scalar where w
//     is not a multiple of 4); then each level is pooled from the one
//     above it in shared memory. The band is aligned to 2^(L-1) rows and
//     the column tile to R columns, so every pooled cell's four parents
//     are in the block and level 0 is never read back from device memory.
//     Every extent in a block is a power of two, so its index arithmetic is
//     shifts and masks, not divisions.
//   * a cell is written only if it exists (index below that level's
//     h_l / w_l), so odd tails drop exactly as the plain version drops
//     them; nothing is padded in device memory.
//   * about 102 KB of shared memory and <= 128 registers a thread for
//     L <= 4: two blocks an SM.
//
// bf16 storage (corr_pallas.py out_dtype, l.77, 97, 106, 227; the
// corr_impl='pallas' block at corr_dtype bf16): the volume accumulates and
// pools in fp32 exactly as above, and each cell is rounded to bf16
// (round to nearest even, __float2bfloat16_rn) only where it is stored, so
// level l is bf16(fp32 level l). This is the JAX kernel's semantics, and
// differs from the dense block's bf16 pyramid, which casts the volume to
// bf16 before pooling. It halves the 261 MB of levels written at raft_small
// Sintel: the byte bound falls from 0.080 to 0.041 ms, below the 3xTF32
// product's 0.077 ms, which then bounds the kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kMaxLevels = 6;
constexpr size_t kMaxSmem = 232448;

struct Levels {
  void* out[kMaxLevels];  // OutT: float or __nv_bfloat16
  int h[kMaxLevels];
  int w[kMaxLevels];
  int num;
};

struct Geometry {
  int c, h, w, q;  // channels, level-0 grid, q = h*w
  int band;        // R = 2^(L-1) key rows per block
  int tw;          // key columns per block, a power of two
  int tw_log2;
  int col_tiles;
  float scale;
  int vec_a;       // 16-byte copies of f1: Q % 4 == 0 and f1 16-byte aligned
  int vec_b;       // 16-byte copies of f2: w % 4 == 0 and f2 16-byte aligned
  int vec_out;     // float4 level-0 stores: w % 4 == 0 and level 0 aligned
};

// Block tile BM queries x BN keys, warp tile WM x WN, KC channels a stage.
template <int BM, int BN, int WM, int WN, int KC>
struct Tile {
  static constexpr int kWarpsM = BM / WM;
  static constexpr int kMf = WM / 16;  // m16 fragments a warp
  static constexpr int kNf = WN / 8;   // n8 fragments a warp
  static constexpr int kLda = (BM + 31) / 32 * 32 + 8;  // = 8 (mod 32)
  static constexpr int kLdb = (BN + 31) / 32 * 32 + 8;
  static constexpr int kLdt = kLdb;  // epilogue tile row
  static constexpr int kStage = KC * (kLda + kLdb);
  static constexpr int kRing = kStages * kStage;
  static_assert(kWarpsM * (BN / WN) == kWarps, "8 warps a block");
  static_assert(WM % 16 == 0 && WN % 8 == 0 && KC % 8 == 0, "m16n8k8 fragments");
  static_assert(BM % 4 == 0 && BN % 4 == 0, "16-byte chunks");
};

__device__ __forceinline__ void store_val(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Four consecutive cells, 16-byte (fp32) or 8-byte (bf16) aligned.
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = packed;
}

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
// from zero; infinities and NaNs stay what they are): half a TF32 ulp added
// to the bits, the 13 low mantissa bits cleared. Two integer instructions,
// where cvt.rna compiles to four on sm_90 (an infinity test, an add, a
// select and the same mask).
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

// The A fragment (queries m0 + gid (+8), channels tig (+4)) from the
// channel-major stage as[k][m].
__device__ __forceinline__ void load_a(const float* ap, int lda, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(ap[0], hi[0], lo[0]);
  split_tf32(ap[8], hi[1], lo[1]);
  split_tf32(ap[4 * lda], hi[2], lo[2]);
  split_tf32(ap[4 * lda + 8], hi[3], lo[3]);
}

// The B fragment (channels tig (+4), column n0 + gid) from bs[k][n].
__device__ __forceinline__ void load_b(const float* bp, int ldb, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(bp[0], hi[0], lo[0]);
  split_tf32(bp[4 * ldb], hi[1], lo[1]);
}

// Channels k0 .. k0+KC-1 of the block's queries and keys into one stage.
template <class T, int BM, int BN, int KC>
__device__ __forceinline__ void load_stage(float* as, float* bs, const float* f1b, const float* f2b, int k0,
                                           int q0, int y0, int x0, const Geometry& g) {
  constexpr int kRowA = BM / 4;
  for (int i = threadIdx.x; i < KC * kRowA; i += kThreads) {
    const int kk = i / kRowA;
    const int m = (i - kk * kRowA) * 4;
    const int k = k0 + kk;
    const int q = q0 + m;
    float* dst = as + kk * T::kLda + m;
    const float* src = f1b + int64_t(k) * g.q + q;
    if (g.vec_a) {
      const bool ok = k < g.c && q < g.q;
      cp_async16(dst, ok ? src : f1b, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k < g.c && q + e < g.q;
        cp_async4(dst + e, ok ? src + e : f1b, ok);
      }
    }
  }
  constexpr int kRowB = BN / 4;
  for (int i = threadIdx.x; i < KC * kRowB; i += kThreads) {
    const int kk = i / kRowB;
    const int j = (i - kk * kRowB) * 4;
    const int y = y0 + (j >> g.tw_log2);
    const int x = x0 + (j & (g.tw - 1));
    const int k = k0 + kk;
    float* dst = bs + kk * T::kLdb + j;
    const float* src = f2b + int64_t(k) * g.q + y * g.w + x;
    if (g.vec_b) {
      const bool ok = k < g.c && y < g.h && x < g.w;
      cp_async16(dst, ok ? src : f2b, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k < g.c && y < g.h && x + e < g.w;
        cp_async4(dst + e, ok ? src + e : f2b, ok);
      }
    }
  }
}

template <int BM, int BN, int WM, int WN, int KC, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
corr_pyramid_kernel(const float* __restrict__ f1, const float* __restrict__ f2, Levels lv, Geometry g) {
  using T = Tile<BM, BN, WM, WN, KC>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int b = blockIdx.z;
  const int q0 = blockIdx.x * BM;
  const int nq = min(BM, g.q - q0);
  const int band = blockIdx.y / g.col_tiles;
  const int y0 = band * g.band;
  const int x0 = (blockIdx.y - band * g.col_tiles) * g.tw;
  const float* f1b = f1 + int64_t(b) * g.c * g.q;
  const float* f2b = f2 + int64_t(b) * g.c * g.q;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // fragment row group
  const int tig = lane & 3;   // thread in group
  const int wm0 = (warp % T::kWarpsM) * WM;
  const int wn0 = (warp / T::kWarpsM) * WN;

  float acc[T::kMf][T::kNf][4];
#pragma unroll
  for (int i = 0; i < T::kMf; ++i)
#pragma unroll
    for (int j = 0; j < T::kNf; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int k_tiles = (g.c + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) {
      float* as = smem + s * T::kStage;
      load_stage<T, BM, BN, KC>(as, as + KC * T::kLda, f1b, f2b, s * KC, q0, y0, x0, g);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for all; stage kt-1 is free
    const int next = kt + kStages - 1;
    if (next < k_tiles) {
      float* as = smem + (next % kStages) * T::kStage;
      load_stage<T, BM, BN, KC>(as, as + KC * T::kLda, f1b, f2b, next * KC, q0, y0, x0, g);
    }
    cp_async_commit();

    const float* as = smem + (kt % kStages) * T::kStage;
    const float* bs = as + KC * T::kLda;
    const float* ap0 = as + tig * T::kLda + wm0 + gid;
    const float* bp0 = bs + tig * T::kLdb + wn0 + gid;
#pragma unroll
    for (int k8 = 0; k8 < KC; k8 += 8) {
      if constexpr (T::kMf <= T::kNf / 2) {
        // few query fragments: hold A, stream B
        uint32_t ahi[T::kMf][4], alo[T::kMf][4];
#pragma unroll
        for (int i = 0; i < T::kMf; ++i) load_a(ap0 + k8 * T::kLda + i * 16, T::kLda, ahi[i], alo[i]);
#pragma unroll
        for (int j = 0; j < T::kNf; ++j) {
          uint32_t bhi[2], blo[2];
          load_b(bp0 + k8 * T::kLdb + j * 8, T::kLdb, bhi, blo);
#pragma unroll
          for (int i = 0; i < T::kMf; ++i) mma_3xtf32(acc[i][j], ahi[i], alo[i], bhi, blo);
        }
      } else {
        // hold B, stream A
        uint32_t bhi[T::kNf][2], blo[T::kNf][2];
#pragma unroll
        for (int j = 0; j < T::kNf; ++j) load_b(bp0 + k8 * T::kLdb + j * 8, T::kLdb, bhi[j], blo[j]);
#pragma unroll
        for (int i = 0; i < T::kMf; ++i) {
          uint32_t ahi[4], alo[4];
          load_a(ap0 + k8 * T::kLda + i * 16, T::kLda, ahi, alo);
#pragma unroll
          for (int j = 0; j < T::kNf; ++j) mma_3xtf32(acc[i][j], ahi, alo, bhi[j], blo[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the tile and the pooled levels reuse it

  // scaled accumulators -> tile[query][key], float2 in the fragment layout
  float* tile = smem;
#pragma unroll
  for (int i = 0; i < T::kMf; ++i)
#pragma unroll
    for (int j = 0; j < T::kNf; ++j) {
      float* p = tile + (wm0 + i * 16 + gid) * T::kLdt + wn0 + j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(p) = make_float2(acc[i][j][0] * g.scale, acc[i][j][1] * g.scale);
      *reinterpret_cast<float2*>(p + 8 * T::kLdt) =
          make_float2(acc[i][j][2] * g.scale, acc[i][j][3] * g.scale);
    }
  __syncthreads();

  // level 0: each existing cell of the tile once
  {
    OutT* out = static_cast<OutT*>(lv.out[0]);
    const int64_t row0 = int64_t(b) * g.q + q0;
    if (g.vec_out) {
      constexpr int kRow = BN / 4;
      for (int i = tid; i < BM * kRow; i += kThreads) {
        const int t = i / kRow;
        const int j = (i - t * kRow) * 4;
        const int y = y0 + (j >> g.tw_log2);
        const int x = x0 + (j & (g.tw - 1));
        if (t < nq && y < g.h && x < g.w)
          store4(out + (row0 + t) * g.q + y * g.w + x, *reinterpret_cast<const float4*>(tile + t * T::kLdt + j));
      }
    } else {
      for (int i = tid; i < BM * BN; i += kThreads) {
        const int t = i / BN;
        const int j = i - t * BN;
        const int y = y0 + (j >> g.tw_log2);
        const int x = x0 + (j & (g.tw - 1));
        if (t < nq && y < g.h && x < g.w) store_val(out + (row0 + t) * g.q + y * g.w + x, tile[t * T::kLdt + j]);
      }
    }
  }

  // levels 1..L-1, each from the one above it, in shared memory after the
  // tile; every extent is a power of two (a band of 2^(L-1-l) rows by
  // TW / 2^l columns a query at level l)
  const float* src = tile;
  int src_stride = T::kLdt;  // floats a query in src
  float* dst = tile + BM * T::kLdt;
  int ws_log2 = g.tw_log2;   // columns a query in src
  int rs_log2 = lv.num - 1;  // rows a query in src
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l) {
    if (l >= lv.num) break;
    const int wd_log2 = ws_log2 - 1;
    const int rd_log2 = rs_log2 - 1;
    const int pq_log2 = rd_log2 + wd_log2;
    const int ws = 1 << ws_log2;
    const int hl = lv.h[l];
    const int wl = lv.w[l];
    const int yl0 = y0 >> l;
    const int xl0 = x0 >> l;
    OutT* out = static_cast<OutT*>(lv.out[l]);
    for (int idx = tid; idx < (BM << pq_log2); idx += kThreads) {
      const int t = idx >> pq_log2;
      const int rr = (idx >> wd_log2) & ((1 << rd_log2) - 1);
      const int cc = idx & ((1 << wd_log2) - 1);
      const float* s = src + t * src_stride + (2 * rr << ws_log2) + 2 * cc;
      const float2 top = *reinterpret_cast<const float2*>(s);
      const float2 bot = *reinterpret_cast<const float2*>(s + ws);
      const float v = (((top.x + top.y) + bot.x) + bot.y) / 4.f;
      dst[idx] = v;
      const int yl = yl0 + rr;
      const int xl = xl0 + cc;
      if (t < nq && yl < hl && xl < wl) store_val(out + ((int64_t(b) * g.q + q0 + t) * hl + yl) * wl + xl, v);
    }
    __syncthreads();
    src = dst;
    src_stride = 1 << pq_log2;
    dst += BM << pq_log2;
    ws_log2 = wd_log2;
    rs_log2 = rd_log2;
  }
}

template <int BM, int BN, int WM, int WN, int KC, typename OutT>
int launch(const float* f1, const float* f2, const Levels& lv, Geometry g, int b, cudaStream_t stream) {
  using T = Tile<BM, BN, WM, WN, KC>;
  g.tw = BN / g.band;
  g.tw_log2 = __builtin_ctz(unsigned(g.tw));
  g.col_tiles = (g.w + g.tw - 1) / g.tw;
  const int bands = (g.h + g.band - 1) / g.band;
  const int64_t y_blocks = int64_t(bands) * g.col_tiles;
  if (y_blocks > 65535 || b > 65535) return int(cudaErrorInvalidValue);

  size_t pooled = 0;  // floats a query of levels 1..L-1 take in shared memory
  for (int l = 1; l < lv.num; ++l) pooled += size_t(g.band >> l) * size_t(g.tw >> l);
  const size_t smem = std::max(size_t(T::kRing), size_t(BM) * (T::kLdt + pooled)) * sizeof(float);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  auto kernel = corr_pyramid_kernel<BM, BN, WM, WN, KC, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((g.q + BM - 1) / BM), unsigned(y_blocks), unsigned(b));
  kernel<<<grid, kThreads, smem, stream>>>(f1, f2, lv, g);
  return int(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// K3: f1, f2 (B, C, h, w) fp32 contiguous; outs[l] (B*h*w, h_l, w_l), fp32
// or bf16 when out_bf16, with h_l = h_{l-1} / 2, w_l = w_{l-1} / 2, every
// level at least 1x1. Returns a cudaError_t.
int corr_pyramid_launch(const void* f1, const void* f2, void* const* outs, int b, int c, int h,
                        int w, int num_levels, float scale, int out_bf16, void* stream) {
  if (b < 1 || c < 1 || h < 1 || w < 1 || num_levels < 1 || num_levels > kMaxLevels)
    return int(cudaErrorInvalidValue);
  if (int64_t(h) * w > (int64_t(1) << 30)) return int(cudaErrorInvalidValue);
  Levels lv;
  int hl = h;
  int wl = w;
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < num_levels) {
      if (hl < 1 || wl < 1 || outs[l] == nullptr) return int(cudaErrorInvalidValue);
      lv.out[l] = outs[l];
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
  g.scale = scale;
  g.vec_a = g.q % 4 == 0 && aligned16(f1);
  g.vec_b = w % 4 == 0 && aligned16(f2);
  g.vec_out = w % 4 == 0 && aligned16(outs[0]);
  const float* a = static_cast<const float*>(f1);
  const float* k = static_cast<const float*>(f2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // BM x BN = R rows x TW columns of keys; warp tiles hold 64 accumulators
  if (out_bf16) {
    using B16 = __nv_bfloat16;
    if (num_levels <= 4) return launch<128, 128, 64, 32, 32, B16>(a, k, lv, g, b, s);
    if (num_levels == 5) return launch<64, 256, 64, 32, 16, B16>(a, k, lv, g, b, s);
    return launch<16, 1024, 16, 128, 8, B16>(a, k, lv, g, b, s);
  }
  if (num_levels <= 4) return launch<128, 128, 64, 32, 32, float>(a, k, lv, g, b, s);
  if (num_levels == 5) return launch<64, 256, 64, 32, 16, float>(a, k, lv, g, b, s);
  return launch<16, 1024, 16, 128, 8, float>(a, k, lv, g, b, s);
}

}  // extern "C"
