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
// accumulator across the sequential k axis.  Here one block owns a 128 x
// 128 output tile and loops over k, its accumulators in registers.
//  * bf16 x bf16: 8 warps, each a 64 x 32 sub-tile of 4 x 4 mma.sync
//    m16n8k16 bf16 → fp32 tensor-core products, two blocks an SM.  k tiles
//    of 32 fill a ring of 4 in shared memory by cp.async (three tiles in
//    flight while one is multiplied).  Each operand's tile is kept along its
//    contiguous axis (k-major, or m- or n-major for a transposed view), rows
//    padded by 16 B so ldmatrix reads hit distinct banks; ldmatrix, with
//    .trans for the m- or n-major layouts, gives the mma fragments.  Aligned
//    chunks inside the operand are 16-byte cp.async copies; edges and odd
//    views are element loads with zeros outside, stored directly.
//  * any fp32 operand: a true-fp32 product on the CUDA cores (TF32 would
//    miss the 1e-4 tolerance): 256 threads, 8 x 8 outputs each, k tiles of
//    8 staged through registers into two shared-memory buffers; a bf16
//    operand is widened on load (its products are exact in fp32).
// wgmma, TMA and a warp-specialised, persistent design are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128;  // output tile of a block (both kernels)
constexpr int BK = 32;             // k tile of the tensor-core kernel
constexpr int STAGES = 4;          // k tiles in its shared-memory ring
constexpr int SBK = 8;             // k tile of the fp32 kernel
constexpr int GROUP_M = 8;         // row tiles walked together, for L2 reuse

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

// The epilogue on the fp32 sum, in torch's own fp32 formulas.
__device__ __forceinline__ float epilogue(float v, int code, float factor) {
  switch (code) {
    case EPI_RELU:
      return v <= 0.f ? 0.f : v;  // NaN stays NaN, as in torch.relu
    case EPI_SILU:
      return v / (1.f + expf(-v));
    case EPI_GELU_TANH: {
      const float beta = 0.7978845608028654f, kappa = 0.044715f;
      return 0.5f * v * (1.f + tanhf(beta * (v + kappa * v * v * v)));
    }
    case EPI_SCALE:
      return v * factor;
    default:
      return v;
  }
}

// Store out[m, n] and out[m, n + 1] (n even) where they lie inside.
__device__ __forceinline__ void store_pair(const Params& p, int64_t m,
                                           int64_t n, float v0, float v1) {
  if (m >= p.M || n >= p.N) return;
  v0 = epilogue(v0, p.epi, p.factor);
  v1 = epilogue(v1, p.epi, p.factor);
  const int64_t off = m * p.N + n;
  const bool pair = n + 1 < p.N && (p.N & 1) == 0;  // aligned to 2 elements
  if (p.y_bf16) {
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

// Output tile (tm, tn) of this block: GROUP_M row tiles are walked column
// by column, so blocks running together share x rows and w columns in L2.
__device__ __forceinline__ void tile_of_block(const Params& p, int64_t& m0,
                                              int64_t& n0) {
  const int64_t tiles_m = (p.M + BM - 1) / BM, tiles_n = (p.N + BN - 1) / BN;
  const int64_t pid = blockIdx.x, width = GROUP_M * tiles_n;
  const int64_t first = pid / width * GROUP_M;
  const int64_t rows =
      tiles_m - first < GROUP_M ? tiles_m - first : (int64_t)GROUP_M;
  m0 = (first + pid % width % rows) * BM;
  n0 = pid % width / rows * BN;
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
  tile_of_block(p, m0, n0);
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
  tile_of_block(p, m0, n0);
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
// float32, 1 = bfloat16.  a_kmajor / b_kmajor: keep x's / w's tile along k
// (else along m / n), the operand's contiguous axis; a_vec / b_vec: that
// axis has stride 1, the other a multiple of 8 and the base 16-byte
// alignment, so a bf16 operand may be read 16 bytes at a time.  Epilogue:
// 0 none, 1 relu, 2 silu, 3 tanh-gelu, 4 scale by `factor`.  M, N > 0,
// K >= 0.  Returns a cudaError_t.
int matmul_fwd(const void* x, const void* w, void* y, int64_t M, int64_t N,
               int64_t K, const int64_t* strides, int x_dtype, int w_dtype,
               int y_dtype, int a_kmajor, int a_vec, int b_kmajor, int b_vec,
               int epi, float factor, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || x_dtype < 0 || x_dtype > 1 ||
      w_dtype < 0 || w_dtype > 1 || y_dtype < 0 || y_dtype > 1 || epi < 0 ||
      epi > EPI_SCALE)
    return cudaErrorInvalidValue;
  const int64_t tiles = ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  Params p{x,         w,         y,          M,          N,
           K,         strides[0], strides[1], strides[2], strides[3],
           y_dtype,   a_vec,     b_vec,      epi,        factor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(tiles));
  if (x_dtype == 1 && w_dtype == 1) {
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
