// Blocked matrix product with a fused epilogue for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/matmul_dma/matmul_dma.py, matmul_pallas /
//   _matmul_kernel (the pl.pallas_call at :87).
//
// What it computes: out[m, n] = epi(Σ_k x[m, k]·w[k, n]), the sum in fp32,
// the epilogue applied to the fp32 sum, then one rounding to the output
// type, as the Pallas kernel's `_retire` does.  x (M, K) and w (K, N) are
// float32 or bfloat16 (mixed types too) and each is read through its two
// strides; out (M, N) is float32 or bfloat16, row-major.  M, N and K are
// arbitrary: every edge is masked, K's included, and offsets are 64-bit.
// Epilogues: 0 none, 1 relu, 2 silu, 3 tanh-gelu, 4 scale by `factor`.
//
// What bounds it on an H100: at the served models' prefill shapes (M
// 18,432, N and K 2,048-9,216) a product does 2·K operations per output
// against 2·(M + N)·K input bytes, far above the card's 295 operations a
// byte, so it is bound by operations: 989 TFLOP/s on the bf16 tensor
// cores, 67 TFLOP/s for fp32 on the CUDA cores.  A decode-shaped product
// (M 4) is bound by the bytes of w.
//
// Design.  The TPU kernel walks an (m, n, k) grid, carrying an fp32 VMEM
// accumulator across the sequential k axis.  Here a block owns an output
// tile and loops over k, its accumulators in registers.  The route is
// chosen on the host from the operands' types, shapes, strides and base
// alignment (`matmul_dma.py:route`), before the launch; none falls back to
// another.
//  * wgmma (bf16 x bf16 that 2-D tensor maps describe: one stride 1, the
//    other a multiple of 16 bytes, 16-byte-aligned bases; M > 64 or x
//    M-major).  128 x 256 output tiles, walked grouped as below.  One
//    producer warpgroup (its registers cut to 40 by setmaxnreg) has one
//    thread keep a ring of 4 stages of 64-deep k tiles full by TMA with the
//    128-byte swizzle, out-of-bounds reads filled with zeros, so ragged M,
//    N and K need no masks; full / empty mbarriers a stage.  Two consumer
//    warpgroups (registers raised to 232) each own 64 rows and run wgmma
//    m64n256k16 from shared memory, 128 fp32 accumulators a thread, stage
//    i's products in flight while stage i − 1 is released.  x is K-major
//    or, transposed by wgmma's tnspA bit, M-major (x.t()); w is N-major
//    (the models' row-major (K, N) weights, tnspB) or K-major (`table.t()`).
//    The epilogue runs on the fp32 fragment, stages the tile in the output
//    type in the ring and stores it 16 bytes a thread.
//  * wgmma_small_m (the same operands, M ≤ 64, x K-major): bound by the
//    bytes of w, so the roles are swapped to keep w's tiles streaming:
//    yᵀ (N x M) = wᵀ · xᵀ, with wᵀ the 64-row A operand (K-major for
//    `table.t()`, M-major for a row-major w) and x the K-major B operand
//    of an m64nMPk16 product, MP = 8, 16, 32 or 64 (rows past M are TMA
//    zeros).  One consumer warpgroup and one producer warp a block, 64
//    columns of y each, a ring of 4-6 stages, several blocks an SM, so many
//    TMA tiles of w are in flight on every SM.  A CUDA-core streaming kernel
//    would reach the same bytes, but this one shares the wgmma route's
//    pieces and keeps the products off the CUDA cores.
//  * mma_sync (bf16 x bf16 that no tensor map describes: an unaligned
//    base, a pitch not a multiple of 16 bytes, a stepped inner axis): 128 x
//    128 tiles, 8 warps, each a 64 x 32 sub-tile of 4 x 4 mma.sync
//    m16n8k16 bf16 → fp32 products, two blocks an SM.  k tiles of 32 fill
//    a ring of 4 in shared memory by cp.async.  Each operand's tile is kept
//    along its contiguous axis, rows padded by 16 B so ldmatrix reads hit
//    distinct banks; ldmatrix, with .trans for the m- or n-major layouts,
//    gives the mma fragments.  Aligned chunks inside the operand are
//    16-byte cp.async copies; edges and odd views are element loads with
//    zeros outside.
//  * fp32 (any fp32 operand): a true-fp32 product on the CUDA cores (TF32
//    would miss the 1e-4 tolerance): 256 threads, 8 x 8 outputs each, k
//    tiles of 8 staged through registers into two shared-memory buffers; a
//    bf16 operand is widened on load (its products are exact in fp32).
// Persistent blocks (one tile's epilogue under the next one's loads) and
// clusters with multicast TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128;  // output tile of a block (both kernels)
constexpr int BK = 32;             // k tile of the tensor-core kernel
constexpr int STAGES = 4;          // k tiles in its shared-memory ring
constexpr int SBK = 8;             // k tile of the fp32 kernel
constexpr int GROUP_M = 8;         // row tiles walked together, for L2 reuse
constexpr int SMALL_M = 64;        // most rows of the small-M wgmma route

enum { ROUTE_FP32 = 0, ROUTE_MMA_SYNC, ROUTE_WGMMA, ROUTE_WGMMA_SMALL_M };

enum { EPI_NONE = 0, EPI_RELU, EPI_SILU, EPI_GELU_TANH, EPI_SCALE };

struct Params {
  const void* x;
  const void* w;
  void* y;
  int64_t M, N, K;
  int64_t sxm, sxk, swk, swn;  // element strides of x (m, k) and w (k, n)
  int y_bf16;                  // output type: 0 float32, 1 bfloat16
  int a_vec, b_vec;            // 16-byte loads allowed (bf16 kernel)
  int epi;
  float factor;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// The epilogue on the fp32 sum, in torch's fp32 formulas, with tanh and
// the logistic from ex2 and rcp (relative error about 1e-7, far inside
// both tolerances).  EPI is fixed at compile time where a kernel's stores
// are unrolled, so that their code stays small (the wgmma route's 128
// outputs a thread); `epilogue` picks it at run time.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int EPI>
__device__ __forceinline__ float epilogue_of(float v, float factor) {
  constexpr float LOG2E = 1.4426950408889634f;
  if (EPI == EPI_RELU) return v <= 0.f ? 0.f : v;  // NaN stays NaN
  if (EPI == EPI_SILU) return v * rcp_approx(1.f + ex2_approx(-v * LOG2E));
  if (EPI == EPI_GELU_TANH) {
    const float beta = 0.7978845608028654f, kappa = 0.044715f;
    const float u = beta * (v + kappa * v * v * v);
    const float t = 1.f - 2.f * rcp_approx(1.f + ex2_approx(2.f * LOG2E * u));
    return 0.5f * v * (1.f + t);
  }
  if (EPI == EPI_SCALE) return v * factor;
  return v;
}

__device__ __forceinline__ float epilogue(float v, int code, float factor) {
  switch (code) {
    case EPI_RELU: return epilogue_of<EPI_RELU>(v, factor);
    case EPI_SILU: return epilogue_of<EPI_SILU>(v, factor);
    case EPI_GELU_TANH: return epilogue_of<EPI_GELU_TANH>(v, factor);
    case EPI_SCALE: return epilogue_of<EPI_SCALE>(v, factor);
    default: return v;
  }
}

// Store out[m, n] and out[m, n + 1] (n even; m, n inside), the output
// bf16 (Y_BF16) or float32.
template <int Y_BF16>
__device__ __forceinline__ void put_pair(const Params& p, int64_t m,
                                         int64_t n, float v0, float v1) {
  const int64_t off = m * p.N + n;
  const bool pair = n + 1 < p.N && (p.N & 1) == 0;  // aligned to 2 elements
  if (Y_BF16) {
    bf16* y = static_cast<bf16*>(p.y);
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(y + off) =
          __floats2bfloat162_rn(v0, v1);
    } else {
      y[off] = __float2bfloat16_rn(v0);
      if (n + 1 < p.N) y[off + 1] = __float2bfloat16_rn(v1);
    }
  } else {
    float* y = static_cast<float*>(p.y);
    if (pair) {
      *reinterpret_cast<float2*>(y + off) = make_float2(v0, v1);
    } else {
      y[off] = v0;
      if (n + 1 < p.N) y[off + 1] = v1;
    }
  }
}

// The epilogue, then put_pair, where (m, n) lies inside.
__device__ __forceinline__ void store_pair(const Params& p, int64_t m,
                                           int64_t n, float v0, float v1) {
  if (m >= p.M || n >= p.N) return;
  v0 = epilogue(v0, p.epi, p.factor);
  v1 = epilogue(v1, p.epi, p.factor);
  if (p.y_bf16)
    put_pair<1>(p, m, n, v0, v1);
  else
    put_pair<0>(p, m, n, v0, v1);
}

// Output tile `pid`, TM x TN: GROUP_M row tiles are walked column by
// column, so blocks running together share x rows and w columns in L2.
template <int TM, int TN>
__device__ __forceinline__ void tile_of_block(const Params& p, int64_t pid,
                                              int64_t& m0, int64_t& n0) {
  const int64_t tiles_m = (p.M + TM - 1) / TM, tiles_n = (p.N + TN - 1) / TN;
  const int64_t width = GROUP_M * tiles_n;
  const int64_t first = pid / width * GROUP_M;
  const int64_t rows =
      tiles_m - first < GROUP_M ? tiles_m - first : (int64_t)GROUP_M;
  m0 = (first + pid % width % rows) * TM;
  n0 = pid % width / rows * TN;
}

// ---------------------------------------------------------------------------
// bf16 x bf16 on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Eight elements of one operand row, zeros outside, into one 16-byte word
// of shared memory: the slow path of `Tile::copy` (edges, odd views), out
// of line so the main loop keeps its registers.
__device__ __noinline__ void gather8(bf16* dst, const bf16* base, int64_t o,
                                     int64_t i, int64_t O, int64_t I,
                                     int64_t so, int64_t si) {
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    h[e] = (o < O && i + e < I)
               ? __bfloat16_as_ushort(base[o * so + (i + e) * si])
               : 0u;
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                 h[4] | h[5] << 16, h[6] | h[7] << 16);
}

// Copy an OUTER x INNER bf16 tile of one operand into shared memory, INNER
// contiguous and each row padded by 8 elements; global element (o, i)
// lies at base + o·so + i·si.  Each thread moves two chunks of 8 elements:
// an aligned chunk inside the operand as one 16-byte cp.async, any other
// through `gather8`.
template <int OUTER, int INNER>
struct Tile {
  static constexpr int LD = INNER + 8;
  static constexpr int ELEMS = OUTER * LD;
  static constexpr int CHUNKS_PER_ROW = INNER / 8;
  static constexpr int PER_THREAD = OUTER * INNER / 8 / THREADS;
  static_assert(PER_THREAD * THREADS * 8 == OUTER * INNER, "tile split");

  static __device__ __forceinline__ void copy(bf16* smem, const bf16* base,
                                              int64_t o0, int64_t i0,
                                              int64_t O, int64_t I,
                                              int64_t so, int64_t si,
                                              bool vec) {
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int c = threadIdx.x + j * THREADS;
      const int ro = c / CHUNKS_PER_ROW, ri = (c % CHUNKS_PER_ROW) * 8;
      const int64_t o = o0 + ro, i = i0 + ri;
      bf16* dst = smem + ro * LD + ri;
      if (vec && o < O && i + 8 <= I) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(dst)),
                     "l"(base + o * so + i));
      } else {
        gather8(dst, base, o, i, O, I, so, si);
      }
    }
  }
};

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  if (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A_K: x's tile is k-major ([BM][BK]), else m-major ([BK][BM]); B_K: w's
// tile is k-major ([BN][BK]), else n-major ([BK][BN]).
template <bool A_K, bool B_K>
struct Bf16Tiles {
  typedef Tile<A_K ? BM : BK, A_K ? BK : BM> A;
  typedef Tile<B_K ? BN : BK, B_K ? BK : BN> B;
  static constexpr int SMEM = STAGES * (A::ELEMS + B::ELEMS) * 2;
};

template <bool A_K, bool B_K>
__global__ void __launch_bounds__(THREADS, 2) matmul_bf16_kernel(Params p) {
  typedef typename Bf16Tiles<A_K, B_K>::A TA;
  typedef typename Bf16Tiles<A_K, B_K>::B TB;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);   // STAGES tiles of x
  bf16* Bs = As + STAGES * TA::ELEMS;         // STAGES tiles of w

  int64_t m0, n0;
  tile_of_block<BM, BN>(p, blockIdx.x, m0, n0);
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* w = static_cast<const bf16*>(p.w);
  auto load = [&](int stage, int64_t k0) {
    bf16* as = As + stage * TA::ELEMS;
    bf16* bs = Bs + stage * TB::ELEMS;
    if (A_K)
      TA::copy(as, x, m0, k0, p.M, p.K, p.sxm, p.sxk, p.a_vec);
    else
      TA::copy(as, x, k0, m0, p.K, p.M, p.sxk, p.sxm, p.a_vec);
    if (B_K)
      TB::copy(bs, w, n0, k0, p.N, p.K, p.swn, p.swk, p.b_vec);
    else
      TB::copy(bs, w, k0, n0, p.K, p.N, p.swk, p.swn, p.b_vec);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // A ring of STAGES k tiles: tile kt + STAGES - 1 is in flight while
  // tile kt is multiplied.  One commit group per tile (empty past the end)
  // keeps the wait count fixed.
  const int64_t nk = (p.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s * BK);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // ldmatrix row of this lane: matrix j = lane / 8, row lane % 8
  const int r8 = lane & 7, j0 = (lane >> 3) & 1, j1 = lane >> 4;
  for (int64_t kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + STAGES - 1 < nk)
      load((kt + STAGES - 1) % STAGES, (kt + STAGES - 1) * BK);
    asm volatile("cp.async.commit_group;\n" ::);
    const bf16* as = As + (kt % STAGES) * TA::ELEMS;
    const bf16* bs = Bs + (kt % STAGES) * TB::ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = wm + mi * 16;
        if (A_K)
          ldmatrix_x4<false>(a[mi], as + (m + r8 + j0 * 8) * TA::LD + kk +
                                        j1 * 8);
        else
          ldmatrix_x4<true>(a[mi], as + (kk + j1 * 8 + r8) * TA::LD + m +
                                       j0 * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int n = wn + np * 16;
        uint32_t r[4];
        if (B_K)
          ldmatrix_x4<false>(r, bs + (n + j1 * 8 + r8) * TB::LD + kk +
                                    j0 * 8);
        else
          ldmatrix_x4<true>(r, bs + (kk + j0 * 8 + r8) * TB::LD + n +
                                   j1 * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // accumulator e of an m16n8 tile: row g (+8 for e >= 2), column 2·t + e%2
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_pair(p, m0 + wm + mi * 16 + g + h * 8, n0 + wn + ni * 8 + 2 * t,
                   acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
}

template <bool A_K, bool B_K>
cudaError_t launch_bf16(const Params& p, dim3 grid, cudaStream_t s) {
  constexpr int bytes = Bf16Tiles<A_K, B_K>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_bf16_kernel<A_K, B_K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  matmul_bf16_kernel<A_K, B_K><<<grid, THREADS, bytes, s>>>(p);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// bf16 x bf16 on wgmma, fed by TMA (operands that a tensor map describes)
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int BK = 64;                // k a TMA box row holds (128 bytes)
constexpr uint32_t ROW = 128;         // bytes of a swizzled box row
constexpr uint32_t BOX = 64 * ROW;    // a 64 x 64 box

// Rows of the output tile staged in shared memory as `elt`-byte values,
// stored 16 bytes at a time (element by element at a ragged edge, or when
// a row of y is not a multiple of 16 bytes).  Row r of the staged tile,
// `cols` values at `pitch` bytes, is y[m0 + r, n0 .. n0 + cols).
__device__ __forceinline__ void store_rows(const Params& p,
                                           const uint8_t* st, int rows,
                                           int cols, int pitch, int64_t m0,
                                           int64_t n0, int t, int nthreads) {
  const int elt = p.y_bf16 ? 2 : 4, per = 16 / elt;
  const int pieces = cols / per;
  const bool vec = (p.N * elt) % 16 == 0;
  for (int idx = t; idx < rows * pieces; idx += nthreads) {
    const int r = idx / pieces, c = idx % pieces;
    const int64_t m = m0 + r, n = n0 + (int64_t)c * per;
    if (m >= p.M || n >= p.N) continue;
    const uint8_t* src = st + r * pitch + c * 16;
    uint8_t* dst = static_cast<uint8_t*>(p.y) + (m * p.N + n) * elt;
    if (vec && n + per <= p.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < per && n + e < p.N; ++e)
        for (int b = 0; b < elt; ++b) dst[e * elt + b] = src[e * elt + b];
    }
  }
}

// A consumer warpgroup's 64 x LM_BN fragment (rows row, row + 8 of each
// 16-row slab, columns col + 8·n) through the epilogue EPI into y; the
// epilogue and the output type are fixed at compile time so the unrolled
// code of the 128 outputs a thread stays small.
template <int EPI, int Y_BF16, int N>
__device__ __forceinline__ void store_frag(const Params& p,
                                           const float (&acc)[N],
                                           int64_t row, int64_t col) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < p.M && col + 8 * n < p.N)
        put_pair<Y_BF16>(p, row + 8 * h, col + 8 * n,
                         epilogue_of<EPI>(acc[4 * n + 2 * h], p.factor),
                         epilogue_of<EPI>(acc[4 * n + 2 * h + 1], p.factor));
}

template <int EPI, int N>
__device__ __forceinline__ void store_tile(const Params& p,
                                           const float (&acc)[N],
                                           int64_t row, int64_t col) {
  if (p.y_bf16)
    store_frag<EPI, 1>(p, acc, row, col);
  else
    store_frag<EPI, 0>(p, acc, row, col);
}

// ---- large M: 128 x 256 output tiles, persistent blocks ----

constexpr int LM_BM = 128, LM_BN = 256, LM_ST = 4;
constexpr int LM_THREADS = 384;       // a producer and two consumer warpgroups
constexpr uint32_t LM_A = LM_BM * ROW;          // x's tile: 16 KB
constexpr uint32_t LM_STAGE = LM_A + LM_BN * ROW;  // + w's tile: 48 KB
constexpr size_t LM_SMEM = LM_ST * LM_STAGE + 2 * LM_ST * 8 + 1024;

// One block an SM walks tiles blockIdx.x, + gridDim.x, ...; the ring's
// stage and phase run on across tiles, so the producer loads the next
// tile's first stages while the consumers store this one.  TA: x is
// M-major (a transposed view), its tile two 64 x 64 boxes (m inner); else
// K-major, one 64 x 128 box.  TB: w is N-major (row-major (K, N), the
// models' weights), its tile four 64 x 64 boxes (n inner); else K-major
// (`table.t()`), one 64 x 256 box.
template <int TA, int TB>
__global__ void __launch_bounds__(LM_THREADS, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w, Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + LM_ST * LM_STAGE);
  uint64_t* empty = full + LM_ST;
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int64_t tiles =
      ((p.M + LM_BM - 1) / LM_BM) * ((p.N + LM_BN - 1) / LM_BN);
  const int nk = static_cast<int>((p.K + BK - 1) / BK);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < LM_ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival a consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (t != 0) return;
    uint32_t it = 0;   // k steps loaded so far, over all tiles
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int64_t m0, n0;
      tile_of_block<LM_BM, LM_BN>(p, tile, m0, n0);
      const int m = static_cast<int>(m0), n = static_cast<int>(n0);
      for (int i = 0; i < nk; ++i, ++it) {
        const int s = it % LM_ST, k = i * BK;
        mbar_wait(&empty[s], ((it / LM_ST) & 1) ^ 1);
        uint8_t* a = smem + s * LM_STAGE;
        uint8_t* b = a + LM_A;
        mbar_arrive_expect_tx(&full[s], LM_STAGE);
        if (TA) {
          tma_load_2d(a, &tm_x, &full[s], m, k);
          tma_load_2d(a + BOX, &tm_x, &full[s], m + 64, k);
        } else {
          tma_load_2d(a, &tm_x, &full[s], k, m);
        }
        if (TB) {
#pragma unroll
          for (int c = 0; c < LM_BN / 64; ++c)
            tma_load_2d(b + c * BOX, &tm_w, &full[s], n + 64 * c, k);
        } else {
          tma_load_2d(b, &tm_w, &full[s], k, n);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows cw·64 .. cw·64 + 63 of each tile
  setmaxnreg_inc<232>();
  const int cw = wg - 1, warp = t / 32, lane = t % 32;
  const uint32_t base = smem_u32(smem);
  float acc[LM_BN / 2];
  uint32_t it = 0;   // k steps consumed so far, over all tiles
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int64_t m0, n0;
    tile_of_block<LM_BM, LM_BN>(p, tile, m0, n0);
    for (int i = 0; i < nk; ++i, ++it) {
      const int s = it % LM_ST;
      mbar_wait(&full[s], (it / LM_ST) & 1);
      const uint32_t a = base + s * LM_STAGE + cw * BOX;
      const uint32_t b = base + s * LM_STAGE + LM_A;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = TA ? desc_sw128(a + kk * 16 * ROW, BOX, 1024)
                               : desc_sw128(a + kk * 32, 16, 1024);
        const uint64_t db = TB ? desc_sw128(b + kk * 16 * ROW, BOX, 1024)
                               : desc_sw128(b + kk * 32, 16, 1024);
        wgmma_ss<TA, TB>(acc, da, db, i > 0 || kk > 0);  // 0: overwrite
      }
      wgmma_commit();
      wgmma_wait<1>();   // step it − 1's products are done: release it
      if (i > 0 && t == 0) mbar_arrive(&empty[(it - 1) % LM_ST]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (t == 0) mbar_arrive(&empty[(it - 1) % LM_ST]);

    // Epilogue on the fp32 fragment, stored from registers: a quad of
    // threads writes 8 consecutive outputs of a row (16 or 32 bytes)
    const int64_t row = m0 + cw * 64 + warp * 16 + lane / 4;
    const int64_t col = n0 + 2 * (lane % 4);
    switch (p.epi) {
      case EPI_RELU: store_tile<EPI_RELU>(p, acc, row, col); break;
      case EPI_SILU: store_tile<EPI_SILU>(p, acc, row, col); break;
      case EPI_GELU_TANH: store_tile<EPI_GELU_TANH>(p, acc, row, col); break;
      case EPI_SCALE: store_tile<EPI_SCALE>(p, acc, row, col); break;
      default: store_tile<EPI_NONE>(p, acc, row, col);
    }
  }
}

// ---- small M: yᵀ = wᵀ · xᵀ, 64 columns of y a block ----

constexpr int SM_BN = 64;             // columns of y (rows of wᵀ) a block
constexpr int SM_THREADS = 160;       // a consumer warpgroup + a producer warp

template <int MP>
struct SmallM {
  static constexpr int ST = MP <= 16 ? 6 : 4;      // stages in the ring
  static constexpr uint32_t B = MP * ROW;           // x's tile, MP x 64
  static constexpr uint32_t STAGE = BOX + B;
  static constexpr size_t SMEM = ST * STAGE + 2 * ST * 8 + 1024;
  static_assert(B % 1024 == 0 && MP * (SM_BN * 4 + 16) <= ST * STAGE,
                "layout");
};

// wᵀ (64 x 64 of N x K) is the A operand: K-major for a K-major w
// (`table.t()`, TA 0), M-major (transposed by wgmma, TA 1) for a row-major
// w.  x (MP x 64, rows past M are TMA zeros) is the K-major B operand of
// an m64nMPk16 product.
template <int MP, int TA>
__global__ void __launch_bounds__(SM_THREADS)
    matmul_small_m_kernel(const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_x,
                          Params p) {
  typedef SmallM<MP> L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::ST * L::STAGE);
  uint64_t* empty = full + L::ST;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * SM_BN;
  const int nk = static_cast<int>((p.K + BK - 1) / BK);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < L::ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {   // producer warp
    if (lane == 0) {
      const int n = static_cast<int>(n0);
      for (int i = 0; i < nk; ++i) {
        const int s = i % L::ST, k = i * BK;
        mbar_wait(&empty[s], ((i / L::ST) & 1) ^ 1);
        uint8_t* a = smem + s * L::STAGE;
        mbar_arrive_expect_tx(&full[s], L::STAGE);
        if (TA)
          tma_load_2d(a, &tm_w, &full[s], n, k);
        else
          tma_load_2d(a, &tm_w, &full[s], k, n);
        tma_load_2d(a + BOX, &tm_x, &full[s], k, 0);
      }
    }
    return;
  }

  const uint32_t base = smem_u32(smem);
  float acc[MP / 2];
#pragma unroll
  for (int i = 0; i < MP / 2; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % L::ST;
    mbar_wait(&full[s], (i / L::ST) & 1);
    const uint32_t a = base + s * L::STAGE, b = a + BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = TA ? desc_sw128(a + kk * 16 * ROW, BOX, 1024)
                             : desc_sw128(a + kk * 32, 16, 1024);
      wgmma_ss<TA, 0>(acc, da, desc_sw128(b + kk * 32, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0 && tid == 0) mbar_arrive(&empty[(i - 1) % L::ST]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Epilogue: D is yᵀ (64 n x MP m), staged as y's rows in the output
  // type, then stored 16 bytes a thread.
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  const int pitch = SM_BN * (p.y_bf16 ? 2 : 4) + 16;
#pragma unroll
  for (int j = 0; j < MP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = warp * 16 + lane / 4 + 8 * h;
        const int m = 8 * j + 2 * (lane % 4) + e;
        const float v = epilogue(acc[4 * j + 2 * h + e], p.epi, p.factor);
        if (p.y_bf16)
          *reinterpret_cast<__nv_bfloat16*>(smem + m * pitch + n * 2) =
              __float2bfloat16_rn(v);
        else
          *reinterpret_cast<float*>(smem + m * pitch + n * 4) = v;
      }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  store_rows(p, smem, p.M < MP ? static_cast<int>(p.M) : MP, SM_BN, pitch,
             0, n0, tid, 128);
}

// A tensor map over an operand viewed as `outer` rows of `inner` bf16
// values `pitch` elements apart, read in boxes of 64 x `box_rows`.
cudaError_t operand_map(CUtensorMap* map, const void* base, int64_t inner,
                        int64_t outer, int64_t pitch, uint32_t box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(inner),
                            static_cast<uint64_t>(outer)};
  const uint64_t strides[1] = {static_cast<uint64_t>(pitch) * 2};
  const uint32_t box[2] = {64, box_rows};
  return tensor_map_bf16(map, base, 2, dims, strides, box);
}

template <int TA, int TB>
cudaError_t launch_large(const Params& p, const CUtensorMap& tx,
                         const CUtensorMap& tw, cudaStream_t s) {
  auto kern = matmul_wgmma_kernel<TA, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LM_SMEM);
  if (err != cudaSuccess) return err;
  const int64_t tiles =
      ((p.M + LM_BM - 1) / LM_BM) * ((p.N + LM_BN - 1) / LM_BN);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kern<<<blocks, LM_THREADS, LM_SMEM, s>>>(tx, tw, p);
  return cudaGetLastError();
}

// x (M, K): K-major (stride (sxm, 1)) or M-major (stride (1, sxk)); w
// (K, N): K-major (stride (1, swn)) or N-major (stride (swk, 1)).
cudaError_t launch_wgmma(const Params& p, int a_kmajor, int b_kmajor,
                         cudaStream_t s) {
  if (p.M > 0x7fffffff - LM_BM || p.N > 0x7fffffff - LM_BN ||
      p.K > 0x7fffffff - BK ||
      ((p.M + LM_BM - 1) / LM_BM) * ((p.N + LM_BN - 1) / LM_BN) > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  cudaError_t err =
      a_kmajor ? operand_map(&tx, p.x, p.K, p.M, p.sxm, LM_BM)
               : operand_map(&tx, p.x, p.M, p.K, p.sxk, 64);
  if (err == cudaSuccess)
    err = b_kmajor ? operand_map(&tw, p.w, p.K, p.N, p.swn, LM_BN)
                   : operand_map(&tw, p.w, p.N, p.K, p.swk, 64);
  if (err != cudaSuccess) return err;
  if (a_kmajor)
    return b_kmajor ? launch_large<0, 0>(p, tx, tw, s)
                    : launch_large<0, 1>(p, tx, tw, s);
  return b_kmajor ? launch_large<1, 0>(p, tx, tw, s)
                  : launch_large<1, 1>(p, tx, tw, s);
}

template <int MP, int TA>
cudaError_t launch_small(const Params& p, const CUtensorMap& tw,
                         const CUtensorMap& tx, cudaStream_t s) {
  auto kern = matmul_small_m_kernel<MP, TA>;
  constexpr size_t bytes = SmallM<MP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (p.N + SM_BN - 1) / SM_BN;
  kern<<<static_cast<unsigned>(blocks), SM_THREADS, bytes, s>>>(tw, tx, p);
  return cudaGetLastError();
}

template <int MP>
cudaError_t launch_small_mp(const Params& p, int b_kmajor, cudaStream_t s) {
  CUtensorMap tw, tx;
  cudaError_t err = operand_map(&tx, p.x, p.K, p.M, p.sxm, MP);
  if (err == cudaSuccess)
    err = b_kmajor ? operand_map(&tw, p.w, p.K, p.N, p.swn, 64)
                   : operand_map(&tw, p.w, p.N, p.K, p.swk, 64);
  if (err != cudaSuccess) return err;
  return b_kmajor ? launch_small<MP, 0>(p, tw, tx, s)
                  : launch_small<MP, 1>(p, tw, tx, s);
}

// M ≤ SMALL_M and x K-major; w either way.
cudaError_t launch_wgmma_small_m(const Params& p, int b_kmajor,
                                 cudaStream_t s) {
  if (p.N > 0x7fffffff - SM_BN || p.K > 0x7fffffff - BK)
    return cudaErrorInvalidValue;
  if (p.M <= 8) return launch_small_mp<8>(p, b_kmajor, s);
  if (p.M <= 16) return launch_small_mp<16>(p, b_kmajor, s);
  if (p.M <= 32) return launch_small_mp<32>(p, b_kmajor, s);
  if (p.M <= SMALL_M) return launch_small_mp<SMALL_M>(p, b_kmajor, s);
  return cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// fp32 (or mixed) on the CUDA cores
// ---------------------------------------------------------------------------

// Thread tid's four elements of a 128 x 8 tile (rows r, k columns c): four
// consecutive k in one row when k is the contiguous axis, else four
// consecutive rows at one k, so a warp's loads are coalesced either way.
__device__ __forceinline__ void simt_slot(bool k_fast, int e, int& r,
                                          int& c) {
  const int tid = threadIdx.x;
  if (k_fast) {
    r = tid >> 1;
    c = (tid & 1) * 4 + e;
  } else {
    r = (tid & 31) * 4 + e;
    c = tid >> 5;
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS) matmul_f32_kernel(Params p,
                                                             bool a_kfast,
                                                             bool b_kfast) {
  constexpr int LD = BM + 4;
  __shared__ __align__(16) float As[2][SBK][LD];  // [k][m]
  __shared__ __align__(16) float Bs[2][SBK][LD];  // [k][n]

  int64_t m0, n0;
  tile_of_block<BM, BN>(p, blockIdx.x, m0, n0);
  const TA* x = static_cast<const TA*>(p.x);
  const TB* w = static_cast<const TB*>(p.w);
  float ra[4], rb[4];
  auto load = [&](int64_t k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r, c;
      simt_slot(a_kfast, e, r, c);
      const int64_t m = m0 + r, k = k0 + c;
      ra[e] = (m < p.M && k < p.K) ? to_f(x[m * p.sxm + k * p.sxk]) : 0.f;
      simt_slot(b_kfast, e, r, c);
      const int64_t n = n0 + r, kb = k0 + c;
      rb[e] = (n < p.N && kb < p.K) ? to_f(w[kb * p.swk + n * p.swn]) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int r, c;
      simt_slot(a_kfast, e, r, c);
      As[buf][c][r] = ra[e];
      simt_slot(b_kfast, e, r, c);
      Bs[buf][c][r] = rb[e];
    }
  };

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int64_t nk = (p.K + SBK - 1) / SBK;
  if (nk > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int64_t kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * SBK);
#pragma unroll
    for (int k = 0; k < SBK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) =
          *reinterpret_cast<const float4*>(&As[cur][k][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&As[cur][k][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) =
          *reinterpret_cast<const float4*>(&Bs[cur][k][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&Bs[cur][k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }

  // rows ty·4 + i and 64 + ty·4 + i, columns tx·4 + j and 64 + tx·4 + j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      store_pair(p, m0 + (i >> 2) * 64 + ty * 4 + (i & 3),
                 n0 + (j >> 2) * 64 + tx * 4 + (j & 3), acc[i][j],
                 acc[i][j + 1]);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// y (M, N) row-major = epi(x (M, K) @ w (K, N)), summed in fp32.
// `strides` holds the element strides (x m, x k, w k, w n).  Types: 0 =
// float32, 1 = bfloat16.  route: 0 the fp32 CUDA-core kernel (any operand
// not bf16), 1 mma.sync (bf16 x bf16, any strides), 2 wgmma on TMA tiles
// and 3 its small-M form (M <= 64, x K-major): bf16 x bf16 whose operands
// a tensor map describes (one stride 1, the other a multiple of 8, a
// 16-byte-aligned base), K > 0.  a_kmajor / b_kmajor: x / w is read
// along k (else along m / n), the operand's contiguous axis; a_vec /
// b_vec (route 1): that axis has stride 1, the other a multiple of 8 and
// the base 16-byte alignment, so a bf16 operand may be read 16 bytes at a
// time.  Epilogue: 0 none, 1 relu, 2 silu, 3 tanh-gelu, 4 scale by
// `factor`.  M, N > 0, K >= 0.  Returns a cudaError_t; a tensor map that
// does not encode is an error, never another route.
int matmul_fwd(const void* x, const void* w, void* y, int64_t M, int64_t N,
               int64_t K, const int64_t* strides, int x_dtype, int w_dtype,
               int y_dtype, int route, int a_kmajor, int a_vec, int b_kmajor,
               int b_vec, int epi, float factor, void* stream) {
  const bool both_bf16 = x_dtype == 1 && w_dtype == 1;
  if (M <= 0 || N <= 0 || K < 0 || x_dtype < 0 || x_dtype > 1 ||
      w_dtype < 0 || w_dtype > 1 || y_dtype < 0 || y_dtype > 1 || epi < 0 ||
      epi > EPI_SCALE || route < ROUTE_FP32 || route > ROUTE_WGMMA_SMALL_M ||
      (route == ROUTE_FP32) == both_bf16 ||
      (route >= ROUTE_WGMMA && K == 0) ||
      (route == ROUTE_WGMMA_SMALL_M && (M > SMALL_M || !a_kmajor)))
    return cudaErrorInvalidValue;
  Params p{x,         w,         y,          M,          N,
           K,         strides[0], strides[1], strides[2], strides[3],
           y_dtype,   a_vec,     b_vec,      epi,        factor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == ROUTE_WGMMA)
    return static_cast<int>(tc::launch_wgmma(p, a_kmajor, b_kmajor, s));
  if (route == ROUTE_WGMMA_SMALL_M)
    return static_cast<int>(tc::launch_wgmma_small_m(p, b_kmajor, s));
  const int64_t tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(tiles));
  if (route == ROUTE_MMA_SYNC) {
    cudaError_t err =
        a_kmajor ? (b_kmajor ? launch_bf16<true, true>(p, grid, s)
                             : launch_bf16<true, false>(p, grid, s))
                 : (b_kmajor ? launch_bf16<false, true>(p, grid, s)
                             : launch_bf16<false, false>(p, grid, s));
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (x_dtype == 0 && w_dtype == 0) {
    matmul_f32_kernel<float, float>
        <<<grid, THREADS, 0, s>>>(p, a_kmajor, b_kmajor);
  } else if (x_dtype == 1) {
    matmul_f32_kernel<bf16, float>
        <<<grid, THREADS, 0, s>>>(p, a_kmajor, b_kmajor);
  } else {
    matmul_f32_kernel<float, bf16>
        <<<grid, THREADS, 0, s>>>(p, a_kmajor, b_kmajor);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
