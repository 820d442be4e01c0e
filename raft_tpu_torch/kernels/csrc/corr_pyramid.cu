// All-pairs correlation volume and its pooled pyramid, for Hopper (sm_90a).
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
// Two designs. Pyramids of up to 4 levels (the model's), fp32 or bf16, run
// the Hopper form: a split pre-pass, then corr_pyramid_wgmma_kernel (TMA,
// mbarriers, wgmma). 5-6 levels run the mma.sync form, corr_pyramid_kernel:
// a 64-row wgmma tile cannot hold its 5-6-level bands (16 or 32 key rows,
// up to 16 queries x 1024 keys a block) in registers, so the launcher
// dispatches those shapes to it.
//
// The Hopper form (L <= 4). The mma.sync form, which ran these shapes
// before, timed the same at bf16 as at fp32: its main loop set the pace,
// with a floor of cp.async staging, 24 fragment loads and 120 split
// instructions a warp per 8 channels (every operand split again by every
// warp that loads it) and a shared-memory epilogue, under products that
// mma.sync cannot issue at the TF32 rate. Instead:
//   * split once, K-major: a pre-pass (split_kmajor_kernel) reads each NCHW
//     map once and writes its TF32 halves channel-contiguous into the
//     wrapper's workspace, [map][hi, lo][B][Q][Cp] fp32 (Cp: C rounded up to
//     4, so every row is a multiple of 16 bytes), split by split_tf32, so
//     the operands are the values the mma.sync form's warps form. At
//     raft_small Sintel it reads 7.2 MB and writes 14.4 MB, which stay in
//     the 50 MB L2 for the main kernel.
//   * TMA and an mbarrier ring: one producer lane keeps a 3-stage ring of
//     32 KB stages in flight, a stage being KC = 16 channels of the block's
//     128 queries (a box over [B][Q][C]) and of its band of R key rows x TW
//     columns (a box over [B][h][w][C]), hi and lo, with the 64-byte swizzle
//     wgmma reads. TMA zero-fills ragged Q, partial bands and column tiles
//     and the channel tail; nothing is padded in device memory.
//   * 3xTF32 on wgmma: two consumer warpgroups each own 64 queries x 128
//     keys (m64n128k8, 64 fp32 accumulators a thread) and chain lo*hi,
//     hi*lo, then hi*hi per k8 step, the mma.sync form's order, both
//     operands read from shared memory: no fragment load or split is left in
//     the loop. One wgmma group stays in flight; a stage goes back to the
//     producer when the group that read it has completed.
//   * the mma.sync form's epilogue (store_levels), in the ring's memory once
//     both warpgroups are done with it: the scaled accumulators go to a
//     128 x 136-float tile in the fragment layout (conflict-free float2
//     stores), level 0 goes out 4 cells a thread, neighbouring threads on
//     neighbouring columns (a warp's store covers whole 32-byte sectors),
//     and each pooled level is formed in shared memory from the one above.
//     Storing from the fragment layout instead (levels pooled in registers,
//     4- and 2-byte stores to 8 queries 14 KB apart a warp instruction) was
//     slower than the whole shared-memory epilogue.
//   * at most 111.6 KB of shared memory (L = 3), 288 threads and <= 112
//     registers a block: two blocks an SM.
// What bounds it as built: its main loop is held by the operands' reads
// from L2 (each 128 x 128 tile reads 2 KB of split operands a channel:
// 0.8 GB at raft_small, 8 KB boxes of 64-byte rows), with the products
// hidden under them; then the epilogue's smem passes and stores, which run
// after the main loop rather than beside it (tools/k3_ablation.py times
// each part). Three variants timed slower in one process: a 2 x 2 cluster
// sharing A and B by TMA multicast (half the L2 reads); a persistent
// ping-pong form, one block an SM, its two warpgroups taking turns at the
// products while the other stages and stores its tile; wider stores (8
// cells a thread).
// NaN: split_tf32 makes a NaN's hi 0x7fc00000 (the integer rounding alone
// carries the card's 0x7fffffff into the sign bit, giving -0), so a NaN
// feature gives NaN cells in both forms, as the plain version does.
//
// The mma.sync form (L = 5, 6).
// Design, against the four faults of the shared-memory fp32-FMA SGEMM it
// replaced (no tensor cores; a 64 x 128 block tile with a 4 x 8 register
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
//   * mma.sync reads the NCHW maps' channel-major (M/N-major) stages as
//     they are, where wgmma takes tf32 operands from shared memory only
//     K-major.
//   * a larger tile: a block owns BM queries of one batch element and a
//     band of R = 2^(L-1) whole level-0 key rows by TW key columns (TW a
//     multiple of R), BN = R*TW keys: for L = 5, 64 x 256 (16 x 16); for
//     L = 6, 16 x 1024 (32 x 32). Every thread holds 64 fp32 accumulators.
//   * copy overlapped with compute: operands are staged by cp.async in a
//     3-stage ring over K steps of KC channels, read straight from NCHW:
//     queries, resp. key columns, are the contiguous axis. 16-byte copies
//     where Q (resp. w) and the pointer allow it, else 4-byte copies;
//     zero-fill (cp.async's src-size) covers ragged Q, partial bands and
//     column tiles and a channel tail that is not a multiple of KC. One
//     __syncthreads per K step; the copies of step k+2 fly while step k
//     computes. Each stage's leading dimension is padded to 8 (mod 32)
//     floats, so the fragment loads (lane -> (k = lane % 4, m = lane / 4))
//     hit 32 distinct banks.
//   * a conflict-free epilogue (store_levels), in the ring's memory: the
//     scaled accumulators go to a BM x BN tile as float2 in the fragment
//     layout, its rows padded to 8 (mod 32) floats; level 0 goes out with
//     float4 (fp32) or packed bf16 stores, neighbouring threads on
//     neighbouring columns (scalar where w is not a multiple of 4); then
//     each level is pooled from the one above it in shared memory. The band
//     is aligned to 2^(L-1) rows and the column tile to R columns, so every
//     pooled cell's four parents are in the block and level 0 is never read
//     back from device memory. Every extent in a block is a power of two,
//     so its index arithmetic is shifts and masks, not divisions.
//
// Both forms write a cell only if it exists (index below that level's
// h_l / w_l), so odd tails drop exactly as the plain version drops them.
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

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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
// from zero; infinities stay infinite): half a TF32 ulp added to the bits,
// the 13 low mantissa bits cleared. Two integer instructions, where cvt.rna
// compiles to four on sm_90 (an infinity test, an add, a select and the same
// mask). Not a NaN: one whose 10 high mantissa bits are set (the card's
// 0x7fffffff) carries into the sign bit and comes out -0 or +0.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo + O(2^-22 x), hi and lo TF32. A NaN x gives hi = 0x7fc00000,
// a NaN for the tensor cores, and lo = -0, so every product with it is NaN;
// every other x splits as before.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = isnan(x) ? 0x7fc00000u : tf32_rna(x);
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

// The block's barrier, or the consumer warpgroups' (named barrier 1) where
// a producer warp has left.
struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};
struct ConsumerSync {
  __device__ __forceinline__ void operator()() const { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
};

// The block's levels from its tile of scaled level-0 cells, tile[t * kLdt +
// j] for query q0 + t and key j (band row j / TW, column j % TW), by
// threads tid = 0 .. kThreads-1, sync() their barrier: level 0 written
// once, each pooled level formed from the one above in shared memory after
// the tile and written once.
template <int BM, int BN, int kLdt, typename OutT, typename Sync>
__device__ __forceinline__ void store_levels(float* tile, const Levels& lv, const Geometry& g, int b, int q0, int nq,
                                             int y0, int x0, int tid, Sync sync) {
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
          store4(out + (row0 + t) * g.q + y * g.w + x, *reinterpret_cast<const float4*>(tile + t * kLdt + j));
      }
    } else {
      for (int i = tid; i < BM * BN; i += kThreads) {
        const int t = i / BN;
        const int j = i - t * BN;
        const int y = y0 + (j >> g.tw_log2);
        const int x = x0 + (j & (g.tw - 1));
        if (t < nq && y < g.h && x < g.w) store_val(out + (row0 + t) * g.q + y * g.w + x, tile[t * kLdt + j]);
      }
    }
  }

  // levels 1..L-1, each from the one above it, in shared memory after the
  // tile; every extent is a power of two (a band of 2^(L-1-l) rows by
  // TW / 2^l columns a query at level l)
  const float* src = tile;
  int src_stride = kLdt;  // floats a query in src
  float* dst = tile + BM * kLdt;
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
    sync();
    src = dst;
    src_stride = 1 << pq_log2;
    dst += BM << pq_log2;
    ws_log2 = wd_log2;
    rs_log2 = rd_log2;
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

  store_levels<BM, BN, T::kLdt, OutT>(tile, lv, g, b, q0, nq, y0, x0, tid, BlockSync{});
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

// ---------------------------------------------------------------------------
// The Hopper form: L <= 4.

constexpr int kHBM = 128;                  // queries a block: two warpgroups of 64
constexpr int kHBN = 128;                  // keys a block: R band rows x 128 / R columns
constexpr int kHKC = 16;                   // channels a stage: 64-byte rows, the 64-byte swizzle's span
constexpr int kHStages = 3;
constexpr int kHConsumers = 256;           // two consumer warpgroups
constexpr int kHThreads = kHConsumers + 32;  // and one producer warp
constexpr int kOpBytes = kHBM * kHKC * 4;  // 8 KB: one half (hi or lo) of one operand of a stage
constexpr int kHStageBytes = 4 * kOpBytes;  // A hi, A lo, B hi, B lo
constexpr int kHRing = kHStages * kHStageBytes;
constexpr int kHLdt = kHBN + 8;  // epilogue tile rows, 8 (mod 32) floats: conflict-free float2 stores
constexpr int kHMaxLevels = 4;
static_assert(kHBN == kHBM, "the key band and the query tile hold 128 rows each: one box size");

// The pre-pass: map m's NCHW features [b][c][q] -> ws[m][part][b][q][cp],
// split by split_tf32 (part 0 hi, 1 lo), 32 x 32 tiles transposed through
// shared memory so both the reads and the writes are coalesced. Channels
// c..cp-1 are never written: the tensor maps end at c.
__global__ void __launch_bounds__(256) split_kmajor_kernel(const float* __restrict__ f1,
                                                           const float* __restrict__ f2, float* __restrict__ ws,
                                                           int c, int q, int cp, int batch) {
  __shared__ float tile[32][33];
  const int m = blockIdx.z & 1;
  const int b = blockIdx.z >> 1;
  const float* f = (m ? f2 : f1) + int64_t(b) * c * q;
  const int q0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    const int cc = c0 + i;
    const int qq = q0 + tx;
    tile[i][tx] = cc < c && qq < q ? f[int64_t(cc) * q + qq] : 0.f;
  }
  __syncthreads();
  const int64_t plane = int64_t(batch) * q * cp;  // floats of one map's hi (or lo)
  float* hi = ws + 2 * m * plane + int64_t(b) * q * cp;
  for (int i = ty; i < 32; i += 8) {
    const int qq = q0 + i;
    const int cc = c0 + tx;
    if (qq < q && cc < c) {
      uint32_t h, l;
      split_tf32(tile[tx][i], h, l);
      hi[int64_t(qq) * cp + cc] = __uint_as_float(h);
      hi[plane + int64_t(qq) * cp + cc] = __uint_as_float(l);
    }
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// A box of a 4-D (A) or 5-D (B) tensor map into shared memory, completing
// on bar's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                         int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, "
      "%7}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand in 64-byte-swizzled
// rows of 64 bytes (KC = 16 fp32): start address, leading offset 1 (unused
// when the K extent of one wgmma, 32 bytes, lies within a swizzled row),
// 512 bytes from one 8-row group to the next, layout 2 (64-byte swizzle).
// The k8 step kk starts 32 * kk bytes on: + 2 * kk on the descriptor.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return uint64_t((addr & 0x3ffffu) >> 4) | (uint64_t(1) << 16) | (uint64_t(512 >> 4) << 32) | (uint64_t(2) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// wgmma region.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a * b: 64 queries x 128 keys x 8 channels, TF32 operands from shared
// memory, fp32 accumulators (thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+8) and key pairs 8 j + 2 (t % 4) (+1) in
// d[4 j .. 4 j + 3]).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// One block: queries q0 .. q0+127 of batch element b against the band of
// R = 2^(L-1) key rows from y0 by TW = 128 / R columns from x0. Warps 0-7
// consume (two warpgroups of 64 queries), warp 8's first lane produces.
template <typename OutT>
__global__ void __launch_bounds__(kHThreads, 2)
corr_pyramid_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                          Levels lv, Geometry g) {
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[kHStages];
  __shared__ uint64_t empty[kHStages];
  const uint32_t raw = smem_addr(smem4);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // the swizzle repeats every 512 bytes
  unsigned char* ring_ptr = reinterpret_cast<unsigned char*>(smem4) + (ring - raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kHBM;
  const int band = blockIdx.y / g.col_tiles;
  const int y0 = band * g.band;
  const int x0 = (blockIdx.y - band * g.col_tiles) * g.tw;
  const int k_tiles = (g.c + kHKC - 1) / kHKC;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kHStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  if (warp == kHConsumers / 32) {
    if (lane == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kHStages;
        if (kt >= kHStages) mbar_wait(&empty[s], ((kt / kHStages) - 1) & 1);
        mbar_expect_tx(&full[s], kHStageBytes);
        unsigned char* st = ring_ptr + s * kHStageBytes;
        const int k0 = kt * kHKC;
        tma_load(st, &map_a, &full[s], k0, q0, b, 0);
        tma_load(st + kOpBytes, &map_a, &full[s], k0, q0, b, 1);
        tma_load(st + 2 * kOpBytes, &map_b, &full[s], k0, x0, y0, b, 0);
        tma_load(st + 3 * kOpBytes, &map_b, &full[s], k0, x0, y0, b, 1);
      }
    }
    return;
  }

  const int wg = warp >> 2;  // 64 queries each
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kHStages;
    mbar_wait(&full[s], (kt / kHStages) & 1);
    const uint32_t st = ring + s * kHStageBytes;
    const uint64_t a_hi = sw64_desc(st + wg * (kOpBytes / 2));
    const uint64_t a_lo = sw64_desc(st + kOpBytes + wg * (kOpBytes / 2));
    const uint64_t b_hi = sw64_desc(st + 2 * kOpBytes);
    const uint64_t b_lo = sw64_desc(st + 3 * kOpBytes);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHKC / 8; ++kk) {
      wgmma_tf32(acc, a_lo + 2 * kk, b_hi + 2 * kk);
      wgmma_tf32(acc, a_hi + 2 * kk, b_lo + 2 * kk);
      wgmma_tf32(acc, a_hi + 2 * kk, b_hi + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group of step kt - 1 is done: its stage is free
    fence_acc(acc);
    if (kt > 0 && (tid & 127) == 0) mbar_arrive(&empty[(kt - 1) % kHStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // the ring becomes the epilogue tile once both warpgroups are done with it
  const ConsumerSync sync;
  sync();
  float* tile = reinterpret_cast<float*>(ring_ptr);
  const int m = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int tig = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {  // scaled accumulators -> tile[query][key], float2 in the fragment layout
    float* p = tile + m * kHLdt + j * 8 + 2 * tig;
    *reinterpret_cast<float2*>(p) = make_float2(acc[4 * j] * g.scale, acc[4 * j + 1] * g.scale);
    *reinterpret_cast<float2*>(p + 8 * kHLdt) = make_float2(acc[4 * j + 2] * g.scale, acc[4 * j + 3] * g.scale);
  }
  sync();
  store_levels<kHBM, kHBN, kHLdt, OutT>(tile, lv, g, b, q0, min(kHBM, g.q - q0), y0, x0, tid, sync);
}

// cuTensorMapEncodeTiled from the driver, fetched once through the runtime
// (the library links no libcuda); null where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A tensor map of fp32 boxes, 64-byte swizzled, zero-filled out of bounds.
bool encode_map(CUtensorMap* map, void* base, cuuint32_t rank, const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const EncodeTiled encode = tensor_map_encoder();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, base, dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int64_t padded_channels(int c) { return (int64_t(c) + 3) & ~int64_t(3); }

// Bytes of the workspace the Hopper form needs: both maps' hi and lo halves.
int64_t workspace_bytes(int b, int c, int q) { return 4 * int64_t(b) * q * padded_channels(c) * 4; }

int launch_split(const float* f1, const float* f2, float* ws, const Geometry& g, int b, cudaStream_t stream) {
  const dim3 grid(unsigned((g.q + 31) / 32), unsigned((g.c + 31) / 32), unsigned(2 * b));
  if (grid.y > 65535 || grid.z > 65535) return int(cudaErrorInvalidValue);
  split_kmajor_kernel<<<grid, 256, 0, stream>>>(f1, f2, ws, g.c, g.q, int(padded_channels(g.c)), b);
  return int(cudaGetLastError());
}

template <typename OutT>
int launch_hopper(const float* f1, const float* f2, float* ws, const Levels& lv, Geometry g, int b,
                  cudaStream_t stream) {
  g.tw = kHBN / g.band;
  g.tw_log2 = __builtin_ctz(unsigned(g.tw));
  g.col_tiles = (g.w + g.tw - 1) / g.tw;
  const int bands = (g.h + g.band - 1) / g.band;
  const int64_t y_blocks = int64_t(bands) * g.col_tiles;
  if (y_blocks > 65535 || b > 65535) return int(cudaErrorInvalidValue);
  for (int l = 0; l < lv.num; ++l)
    if (reinterpret_cast<uintptr_t>(lv.out[l]) % (2 * sizeof(OutT)) != 0) return int(cudaErrorInvalidValue);

  int err = launch_split(f1, f2, ws, g, b, stream);
  if (err != 0) return err;

  const int64_t cp = padded_channels(g.c);
  const int64_t plane = int64_t(b) * g.q * cp;  // floats of one map's hi (or lo)
  const cuuint64_t row = cuuint64_t(cp) * sizeof(float);
  const cuuint64_t dims_a[4] = {cuuint64_t(g.c), cuuint64_t(g.q), cuuint64_t(b), 2};
  const cuuint64_t strides_a[3] = {row, row * g.q, row * g.q * b};
  const cuuint32_t box_a[4] = {kHKC, kHBM, 1, 1};
  const cuuint64_t dims_b[5] = {cuuint64_t(g.c), cuuint64_t(g.w), cuuint64_t(g.h), cuuint64_t(b), 2};
  const cuuint64_t strides_b[4] = {row, row * g.w, row * g.q, row * g.q * b};
  const cuuint32_t box_b[5] = {kHKC, cuuint32_t(g.tw), cuuint32_t(g.band), 1, 1};
  CUtensorMap map_a, map_b;
  if (!encode_map(&map_a, ws, 4, dims_a, strides_a, box_a) ||
      !encode_map(&map_b, ws + 2 * plane, 5, dims_b, strides_b, box_b))
    return int(cudaErrorNotSupported);

  // the ring, or the epilogue tile and the pooled levels after it, + 1 KB to align the ring
  size_t pooled = 0;  // floats a query of levels 1..L-1 take in shared memory
  for (int l = 1; l < lv.num; ++l) pooled += size_t(g.band >> l) * size_t(g.tw >> l);
  const int smem = int(std::max(size_t(kHRing), size_t(kHBM) * (kHLdt + pooled) * sizeof(float))) + 1024;
  auto kernel = corr_pyramid_wgmma_kernel<OutT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           int(cudaSharedmemCarveoutMaxShared));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(unsigned((g.q + kHBM - 1) / kHBM), unsigned(y_blocks), unsigned(b));
  kernel<<<grid, kHThreads, smem, stream>>>(map_a, map_b, lv, g);
  return int(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// K3: f1, f2 (B, C, h, w) fp32 contiguous; outs[l] (B*h*w, h_l, w_l), fp32
// or bf16 when out_bf16, with h_l = h_{l-1} / 2, w_l = w_{l-1} / 2, every
// level at least 1x1. Up to 4 levels run the Hopper form, which needs a
// 16-byte aligned workspace of 16 * b * h * w * Cp bytes (Cp: c rounded up
// to 4; corr_pallas.workspace_bytes); 5-6 levels take none (workspace may
// be null). Returns a cudaError_t.
int corr_pyramid_launch(const void* f1, const void* f2, void* const* outs, int b, int c, int h, int w,
                        int num_levels, float scale, int out_bf16, void* workspace, long long workspace_size,
                        void* stream) {
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
  using B16 = __nv_bfloat16;
  if (num_levels <= kHMaxLevels) {
    if (workspace == nullptr || !aligned16(workspace) || workspace_size < workspace_bytes(b, c, g.q))
      return int(cudaErrorInvalidValue);
    float* ws = static_cast<float*>(workspace);
    return out_bf16 ? launch_hopper<B16>(a, k, ws, lv, g, b, s) : launch_hopper<float>(a, k, ws, lv, g, b, s);
  }
  // the mma.sync form: BM x BN = R rows x TW columns of keys; warp tiles hold 64 accumulators
  if (out_bf16) {
    if (num_levels == 5) return launch<64, 256, 64, 32, 16, B16>(a, k, lv, g, b, s);
    return launch<16, 1024, 16, 128, 8, B16>(a, k, lv, g, b, s);
  }
  if (num_levels == 5) return launch<64, 256, 64, 32, 16, float>(a, k, lv, g, b, s);
  return launch<16, 1024, 16, 128, 8, float>(a, k, lv, g, b, s);
}

}  // extern "C"
