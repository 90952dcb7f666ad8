// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd/ssd.py, ssd_pallas / _ssd_kernel (the
//   pl.pallas_call at :112).
//
// What it computes, per (b, h), over chunks of L steps, with the (N, P)
// state h carried in fp32 from chunk to chunk (zero at the start):
//   cum_t   = Σ_{u≤t} A·dt_u                          (inclusive, per chunk)
//   y_t     = Σ_{s≤t} (C_t·B_s)·exp(cum_t − cum_s)·dt_s·x_s   (intra-chunk)
//           + exp(cum_t)·C_t·h_prev                            (inter-chunk)
//           + D·x_t
//   h       = exp(cum_L)·h_prev + Σ_s exp(cum_L − cum_s)·dt_s·B_s ⊗ x_s
// B and C belong to group h / (H/G).  y is written in x's dtype, the final
// state as fp32 (B, H, N, P).  x, B, C are float32 or bfloat16; dt, A, D
// float32.  x, dt, B, C and y are read and written through their strides
// (the innermost one is 1), so the model passes views of its (B, S, ...)
// tensors and copies nothing.
//
// What bounds it on an H100: at mamba2-1.3b's prefill shape (L 128, N 128,
// P 64) the chunked form costs about 3.7 M multiply-adds per (b, h, chunk)
// against 4·(L·P + 2·L·N) input bytes, so it is bound by operations: fp32
// on the CUDA cores tops out at 67 TFLOP/s, TF32 on the tensor cores at
// 495, and three TF32 products per fp32 product (3xTF32) at 165.
//
// Two routes, chosen on the host (`kernels/ssd/ssd.py:route`):
//
// * tensor_cores (`ssd_tc_fwd`, namespace tc): the chunks in parallel, in
//   four launches on the caller's stream, as Mamba-2's chunked form splits
//   the work (`kernels/ssd/ref.py`):
//     1. cb_kernel, one block per (b, g, chunk): CB = C·Bᵀ (L × L) into a
//        scratch buffer.  It is the same for every head of a group, so it
//        is computed once and read by all of them.
//     2. state_kernel, one block per (b, g, chunk, up to 8 heads of the
//        group): per head the cumsum of A·dt, the chunk's total and its
//        state (B ⊙ w)ᵀ·x (N × P), w_s = exp(total − cum_s)·dt_s, into a
//        (B, H, chunks, N, P) fp32 scratch buffer.  B is loaded once for
//        the heads; x and dt go through a ring of two.
//     3. recur_kernel, (b, h) × slices of N·P: the recurrence over the
//        chunks, h_prev_c = exp(total_{c−1})·h_prev_{c−1} + state_{c−1},
//        elementwise and in place over the buffer, which then holds each
//        chunk's h_prev; the last h is the final state.
//     4. out_kernel, one block per (b, g, chunk, up to 8 heads): C and CB
//        are loaded once; per head y = exp(cum_t)·C·h_prev + (CB masked to
//        s ≤ t before the exponential, times the decay and dt)·x + D·x.
//        Below the diagonal block of each 16-row block the decay factors
//        through the block's first row into two terms of at most 1, so
//        those scores need no exponential of their own.
//   Each of 1, 2 and 4 is one block of 8 warps an SM (136, 136 and 209 KiB
//   of shared memory at the main shape, L 128, N 128, P 64).  Walking several
//   heads lets a block load the next head's tiles while it multiplies this
//   one's, and reads the operands the heads share once.
//   Every product runs on the tensor cores as mma.sync.m16n8k8 with TF32
//   operands and fp32 sums, a warp per 16-row block.  mma.sync and not
//   wgmma: wgmma takes tf32 only with both operands K-major, and three of
//   the four products have an MN-major operand (Bᵀ in the state, x in
//   scores·x, h_prev in C·h_prev); mma.sync reads its fragments from any
//   layout.  The contraction index is permuted inside each 8-deep step
//   (slot k stands for column 2k, slot k + 4 for column 2k + 1, in both
//   operands), so that a row's two values are one float2 read, and a
//   score tile formed in registers is an A fragment as it stands.  For
//   fp32 inputs each operand is split into its TF32 high part and the
//   remainder, and a product is the three mma of lo·hi, hi·lo and hi·hi
//   (3xTF32, about 21 bits of mantissa; lo·lo is dropped), each pass over
//   every tile before the next: plain TF32 keeps 10 bits, too few for the
//   fp32 tolerance.  For bf16 inputs every operand is exact in TF32 once
//   rounded to bf16 where the reference rounds it (scores, h_prev, B·w),
//   so a product is one mma: the reference's own arithmetic, bf16 products
//   summed in fp32.  Tiles come from device memory by 16-byte cp.async
//   (dt by 4-byte ones) into shared memory, x in its dtype, the rest as
//   fp32 (C and B are widened from bf16 in registers, once a block).  The
//   rows are padded so that every fragment read hits distinct banks: a row
//   pitch of 4 mod 8 floats (8 bf16) for values read singly down two rows,
//   8 mod 16 floats for float2 reads along a row.  Not TMA: its rules hold
//   for the model's views, but a box lands in shared memory unpadded, with
//   a pitch of a power of two, and the swizzle that would cure that limits
//   a box to 32 floats across and splits the float2 reads; cp.async gives
//   the same overlap with a layout chosen for the fragments.  The route
//   takes L a multiple of 32 up to 128, N a multiple of 16 up to 128, P of
//   16, 32 or 64 (the loops over P are unrolled at compile time), and x, B
//   and C whose base and strides are multiples of 16 bytes.
//   `tools/kernel_versus.py ssd` times each launch; the outputs take the
//   most.  Neither their per-head loads nor the order of the mma bound
//   them: with two warps on each scheduler, the chain from the shared-
//   memory reads through the split to the mma is what shows.
//
// * cuda_cores (`ssd_fwd`): every other admitted shape or view.  One block
//   of 256 threads owns one (b, h) and loops over its chunks, with the
//   state in shared memory: the TPU kernel's sequential chunk axis as a
//   loop.  Per chunk: x and B are loaded whole (as fp32), the cumsum is a
//   warp scan, then the query rows go in tiles of 64: the C rows of the
//   tile, the score tile (only s ≤ t is computed, and masked before exp, so
//   exp never sees cum_t − cum_s > 0), then y = scores·x + exp(cum_t)·
//   (C·h_prev) + D·x.  After the last row tile has read h_prev (barrier), B
//   is scaled by exp(cum_L − cum_s)·dt_s in place and the state update
//   runs, each thread owning its own (n, p) elements.  At L 128, N 128,
//   P 64 this takes 195 KB of dynamic shared memory, one block per SM.
//   Every product is fp32 FMAs on the CUDA cores, a 64×64 output tile per
//   pass, each thread a 4×4 micro-tile with stride 16; row strides are
//   odd, so a half-warp reading a column hits 16 banks.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: tx picks columns, ty picks rows
constexpr int TILE = 64;      // output rows and columns per pass
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int odd(int d) { return d | 1; }

// Shared-memory layout, in floats: x (L×P), B (L×N), C rows of one tile
// (RT×N), score tile (RT×L), state (N×P), dt (L), cum (L).
struct Smem {
  int ldx, ldb, lds, rt;
  size_t x, b, c, s, h, dt, cum, total;
  __host__ __device__ Smem(int L, int N, int P) {
    ldx = odd(P);
    ldb = odd(N);
    lds = odd(L);
    rt = L < TILE ? L : TILE;
    x = 0;
    b = x + (size_t)L * ldx;
    c = b + (size_t)L * ldb;
    s = c + (size_t)rt * ldb;
    h = s + (size_t)rt * lds;
    dt = h + (size_t)N * ldx;
    cum = dt + L;
    total = cum + L;
  }
  __host__ __device__ size_t bytes() const { return total * sizeof(float); }
};

// acc[i][j] += Σ_{k<K} A(row_i, k)·B(k, col_j) over one 64×64 output tile,
// where thread (ty, tx) owns rows r0 + ty + 16i and columns c0 + tx + 16j.
// A(r, k) = a[r·ars + k·aks], B(k, c) = b[k·bks + c·bcs].  Rows and columns
// past (M, Nc) are clamped to the last one: they are computed and dropped.
__device__ __forceinline__ void tile_mma(float acc[4][4], const float* a,
                                         int ars, int aks, const float* b,
                                         int bks, int bcs, int K, int r0,
                                         int M, int c0, int Nc) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* ap[4];
  const float* bp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ap[i] = a + min(r0 + ty + 16 * i, M - 1) * ars;
    bp[i] = b + min(c0 + tx + 16 * i, Nc - 1) * bcs;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = ap[i][k * aks];
      bv[i] = bp[i][k * bks];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t stride, int rows,
                                          int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += THREADS)
    dst[(i / cols) * ld + i % cols] =
        to_f(src[(i / cols) * stride + i % cols]);
}

// Element strides of the (batch, head or group, step) axes of x, dt, B, C
// and y; the innermost axis of x, B, C and y is contiguous.
struct Strides {
  int64_t x[3], dt[3], b[3], c[3], y[3];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Dskip,
               const T* __restrict__ Bm, const T* __restrict__ Cm,
               T* __restrict__ y, float* __restrict__ state,
               const Strides st, int H, int G, int S, int L, int N, int P) {
  extern __shared__ float smem[];
  const Smem lay(L, N, P);
  float* sX = smem + lay.x;
  float* sB = smem + lay.b;
  float* sC = smem + lay.c;
  float* sS = smem + lay.s;
  float* sH = smem + lay.h;
  float* sDt = smem + lay.dt;
  float* sCum = smem + lay.cum;
  const int ldx = lay.ldx, ldb = lay.ldb, lds = lay.lds, RT = lay.rt;

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a = A[h], dskip = Dskip[h];
  const T* xb = x + b * st.x[0] + h * st.x[1];
  const float* dtb = dt + b * st.dt[0] + h * st.dt[1];
  const T* Bb = Bm + b * st.b[0] + g * st.b[1];
  const T* Cb = Cm + b * st.c[0] + g * st.c[1];
  T* yb = y + b * st.y[0] + h * st.y[1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < N * P; i += THREADS)
    sH[(i / P) * ldx + i % P] = 0.f;

  for (int t0 = 0; t0 < S; t0 += L) {
    __syncthreads();  // the previous chunk's readers of x, B, dt are done
    load_rows(sX, ldx, xb + t0 * st.x[2], st.x[2], L, P);
    load_rows(sB, ldb, Bb + t0 * st.b[2], st.b[2], L, N);
    for (int i = threadIdx.x; i < L; i += THREADS)
      sDt[i] = dtb[(t0 + i) * st.dt[2]];
    if (warp == 0) {
      // inclusive scan of A·dt: each lane owns E = L/32 consecutive steps
      const int E = L / 32;
      float run = 0.f;
      for (int e = 0; e < E; ++e) {
        run += a * dtb[(t0 + lane * E + e) * st.dt[2]];
        sCum[lane * E + e] = run;
      }
      float incl = run;  // inclusive prefix of the lane totals
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      float off = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) off = 0.f;
      for (int e = 0; e < E; ++e) sCum[lane * E + e] += off;
    }
    __syncthreads();
    const float total = sCum[L - 1];

    for (int r0 = 0; r0 < L; r0 += RT) {
      const int rows = min(RT, L - r0);
      const int kmax = r0 + rows;  // keys s < kmax can be live for these rows
      load_rows(sC, ldb, Cb + (t0 + r0) * st.c[2], st.c[2], rows, N);
      __syncthreads();

      // score tile: sS[t][s] = (C_t·B_s)·exp(cum_t − cum_s)·dt_s for s ≤ t
      for (int c0 = 0; c0 < kmax; c0 += TILE) {
        float acc[4][4];
        zero(acc);
        tile_mma(acc, sC, ldb, 1, sB, 1, ldb, N, 0, rows, c0, kmax);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = ty + 16 * i;
          if (tl >= rows) continue;
          const int t = r0 + tl;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = c0 + tx + 16 * j;
            if (s >= kmax) continue;
            sS[tl * lds + s] =
                s <= t ? acc[i][j] * expf(sCum[t] - sCum[s]) * sDt[s] : 0.f;
          }
        }
      }
      __syncthreads();

      // y rows: scores·x + exp(cum_t)·(C·h_prev) + D·x
      for (int c0 = 0; c0 < P; c0 += TILE) {
        float intra[4][4], inter[4][4];
        zero(intra);
        zero(inter);
        tile_mma(intra, sS, lds, 1, sX, ldx, 1, kmax, 0, rows, c0, P);
        tile_mma(inter, sC, ldb, 1, sH, ldx, 1, N, 0, rows, c0, P);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = ty + 16 * i;
          if (tl >= rows) continue;
          const int t = r0 + tl;
          const float et = expf(sCum[t]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = c0 + tx + 16 * j;
            if (p >= P) continue;
            const float v =
                intra[i][j] + et * inter[i][j] + dskip * sX[t * ldx + p];
            yb[(t0 + t) * st.y[2] + p] = from_f<T>(v);
          }
        }
      }
      __syncthreads();  // sC, sS and h_prev are read
    }

    // B_s ← B_s · exp(total − cum_s) · dt_s, then the state update
    for (int i = threadIdx.x; i < L * N; i += THREADS) {
      const int s = i / N;
      sB[s * ldb + i % N] *= expf(total - sCum[s]) * sDt[s];
    }
    __syncthreads();
    const float et = expf(total);
    for (int r0 = 0; r0 < N; r0 += TILE)
      for (int c0 = 0; c0 < P; c0 += TILE) {
        float acc[4][4];
        zero(acc);
        tile_mma(acc, sB, 1, ldb, sX, ldx, 1, L, r0, N, c0, P);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = r0 + ty + 16 * i;
          if (n >= N) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = c0 + tx + 16 * j;
            if (p >= P) continue;
            float& hv = sH[n * ldx + p];
            hv = et * hv + acc[i][j];
          }
        }
      }
  }
  __syncthreads();
  float* out = state + (size_t)bh * N * P;
  for (int i = threadIdx.x; i < N * P; i += THREADS)
    out[i] = sH[(i / P) * ldx + i % P];
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const float* D, const void* Bm, const void* Cm, void* y,
                   float* state, const Strides& st, int Bsz, int H, int G,
                   int S, int L, int N, int P, cudaStream_t stream) {
  const size_t bytes = Smem(L, N, P).bytes();
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<Bsz * H, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, D, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), state, st, H, G, S, L, N,
      P);
  return cudaGetLastError();
}


// ------------------------------------------------------------------------
// The tensor-core route.
// ------------------------------------------------------------------------

namespace tc {

constexpr int THREADS = 256;  // every kernel of the route: 8 warps
constexpr int MAX_L = 128, MAX_N = 128;
constexpr int LT = MAX_L / 8;       // most 8-wide score tiles in a row

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0-3) of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// A value as the reference rounds it before a product: to bf16 on the
// bf16 route, untouched in fp32.
template <typename T> __device__ __forceinline__ float keep(float v) {
  return v;
}
template <> __device__ __forceinline__ float keep<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Fragments of one m16n8k8 step: the TF32 high parts, and for 3xTF32 the
// TF32 of the remainders.  A's registers in PTX order: (row g, slot t),
// (row g + 8, slot t), (row g, slot t + 4), (row g + 8, slot t + 4), with
// g = lane / 4, t = lane % 4; B's: (slot t, column g), (slot t + 4,
// column g).  Callers put contraction index k0 + 2t in slot t and
// k0 + 2t + 1 in slot t + 4, in A and B alike.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// 3xTF32's split: hi is v cut to TF32's 10 mantissa bits, lo = v − hi
// exactly, and the tensor core cuts lo to 10 bits in turn (an error under
// 2^-20·|v|).  Two instructions; cvt.rna.tf32.f32 takes five on sm_90.
template <bool SPLIT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);  // bf16-exact: a TF32 value already
  }
}

template <bool SPLIT>
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split<SPLIT>(a0, f.hi[0], f.lo[0]);
  split<SPLIT>(a1, f.hi[1], f.lo[1]);
  split<SPLIT>(a2, f.hi[2], f.lo[2]);
  split<SPLIT>(a3, f.hi[3], f.lo[3]);
  return f;
}

template <bool SPLIT>
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split<SPLIT>(b0, f.hi[0], f.lo[0]);
  split<SPLIT>(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[m][n] += a[m]·b[n] for M row tiles and NT column tiles, the small
// terms first under 3xTF32.  Each of the three passes runs over every
// tile before the next begins, so no mma waits on the one just issued.
template <bool SPLIT, int M, int NT>
__device__ __forceinline__ void mma(float (*d)[NT][4], const FragA* a,
                                    const FragB (&b)[NT]) {
  if (SPLIT) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(d[m][n], a[m].lo, b[n].hi);
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_tf32(d[m][n], a[m].hi, b[n].lo);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32(d[m][n], a[m].hi, b[n].hi);
}

// Rows [r0, r1) and columns [c0, c1) of a row-major array in device memory
// (row stride `stride` elements, each 16-byte chunk aligned) into shared
// memory at dst[r·ld + c]: by cp.async into the caller's open group where
// the two types match, by 16-byte loads widened in registers from bf16 to
// fp32.  Each thread keeps one 16-byte column of the rows it copies, so no
// index is divided per copy.
template <typename S, typename T>
__device__ __forceinline__ void load_tile(S* dst, int ld,
                                          const T* __restrict__ src,
                                          int64_t stride, int r0, int r1,
                                          int c0, int c1, int nthreads) {
  constexpr int V = 16 / sizeof(T);
  const int per_row = (c1 - c0) / V;
  if (per_row <= 0) return;
  const int rows_per_pass = nthreads / per_row;
  const int rr = threadIdx.x / per_row;
  if (rr >= rows_per_pass) return;
  const int c = c0 + (threadIdx.x % per_row) * V;
  for (int r = r0 + rr; r < r1; r += rows_per_pass) {
    const T* g = src + r * stride + c;
    S* s = dst + r * ld + c;
    if constexpr (sizeof(S) == sizeof(T)) {
      cp_async16(s, g);
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(g);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float2 f0 = __bfloat1622float2(p[0]), f1 = __bfloat1622float2(p[1]),
                   f2 = __bfloat1622float2(p[2]), f3 = __bfloat1622float2(p[3]);
      reinterpret_cast<float4*>(s)[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      reinterpret_cast<float4*>(s)[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }
}

// dst[i] = src[i·stride] for i < n, by 4-byte cp.async into the open group.
__device__ __forceinline__ void load_column(float* dst,
                                            const float* __restrict__ src,
                                            int64_t stride, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cp_async4(dst + i, src + i * stride);
}

// Row pitch, in elements, of x kept in its dtype in shared memory: P + 4
// floats or P + 8 bf16, so that single values read down two rows of a
// fragment hit distinct banks.
template <typename T>
__host__ __device__ constexpr int x_pitch(int P) {
  return P + (sizeof(T) == 4 ? 4 : 8);
}

// Warp 0's inclusive cumsum of a·dt over the chunk's L values of dt at sDt
// into sCum (each lane L/32 consecutive steps, then a warp scan of the lane
// totals); returns the chunk's total in every lane.
__device__ __forceinline__ float warp_cumsum(const float* sDt, float* sCum,
                                             float a, int L) {
  const int lane = threadIdx.x % 32, E = L / 32;
  float run = 0.f;
  for (int e = 0; e < E; ++e) {
    run += a * sDt[lane * E + e];
    sCum[lane * E + e] = run;
  }
  float incl = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  float off = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) off = 0.f;
  for (int e = 0; e < E; ++e) sCum[lane * E + e] += off;
  __syncwarp();
  return sCum[L - 1];
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 1. CB = C·Bᵀ for one chunk of one group: cb[b, g, c] (L × L, row t),
// each 16-row block written up to its diagonal 16 columns (out_kernel masks
// the rest).  sC and sB are [L][N + 8]: both operands are read as float2
// along a row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, const Strides st, int G, int S, int L,
              int N) {
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) float smem[];
  const int ld = N + 8;
  float* sC = smem;
  float* sB = smem + L * ld;
  const int nc = S / L, bgc = blockIdx.x, c = bgc % nc, bg = bgc / nc;
  const int b = bg / G, g = bg % G, t0 = c * L;
  load_tile(sC, ld, Cm + b * st.c[0] + g * st.c[1] + t0 * st.c[2], st.c[2],
            0, L, 0, N, THREADS);
  load_tile(sB, ld, Bm + b * st.b[0] + g * st.b[1] + t0 * st.b[2], st.b[2],
            0, L, 0, N, THREADS);
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  float* out = cb + (size_t)bgc * L * L;
  for (int r0 = warp * 16; r0 < L; r0 += THREADS / 2) {
    const int nj = r0 / 8 + 2;  // 8-wide column tiles up to the diagonal
    float acc[LT][1][4] = {};
    for (int k0 = 0; k0 < N; k0 += 8) {
      const float2 u =
          *reinterpret_cast<const float2*>(sC + (r0 + gq) * ld + k0 + 2 * tq);
      const float2 v = *reinterpret_cast<const float2*>(
          sC + (r0 + gq + 8) * ld + k0 + 2 * tq);
      const FragA a[1] = {frag_a<SPLIT>(u.x, v.x, u.y, v.y)};
#pragma unroll
      for (int j = 0; j < LT; ++j)
        if (j < nj) {
          const float2 w = *reinterpret_cast<const float2*>(
              sB + (8 * j + gq) * ld + k0 + 2 * tq);
          const FragB b[1] = {frag_b<SPLIT>(w.x, w.y)};
          mma<SPLIT, 1>(&acc[j], a, b);
        }
    }
#pragma unroll
    for (int j = 0; j < LT; ++j)
      if (j < nj) {
        float* o = out + (r0 + gq) * L + 8 * j + 2 * tq;
        store2<float>(o, acc[j][0][0], acc[j][0][1]);
        store2<float>(o + 8 * L, acc[j][0][2], acc[j][0][3]);
      }
  }
}

// The first head and the number of heads of block `blk` of a kernel that
// gives each block one chunk of HB heads of one group; also its (b, g, c).
struct HeadGroup {
  int b, g, c, h0, nh;
  __device__ HeadGroup(int blk, int H, int G, int nc, int HB) {
    const int hpg = H / G, nhb = (hpg + HB - 1) / HB, hb = blk % nhb;
    const int bgc = blk / nhb;
    c = bgc % nc;
    g = (bgc / nc) % G;
    b = bgc / nc / G;
    h0 = g * hpg + hb * HB;
    nh = min(HB, hpg - hb * HB);
  }
};

// 2. The chunk states of HB heads that share one chunk of B: for each head
// the cumsum of A·dt, the chunk's total, and (B ⊙ w)ᵀ·x (N × P) into
// states[b, h, c], totals[b, h, c].  B is loaded once ([L][N + 4], fp32);
// x and dt go through a ring of two, the next head's landing (cp.async)
// while this one's product runs.  Each warp owns 16 rows of N.  x stays in
// its dtype in shared memory ([L][P + 4] fp32, [L][P + 8] bf16), both read
// as single values down two rows.
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 1)
    state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 float* __restrict__ states, float* __restrict__ totals,
                 const Strides st, int H, int G, int S, int L, int N, int P,
                 int HB) {
  constexpr bool SPLIT = sizeof(T) == 4;
  extern __shared__ __align__(16) float smem[];
  const int ldb = N + 4, ldx = x_pitch<T>(P);
  float* sB = smem;
  T* sX = reinterpret_cast<T*>(sB + L * ldb);  // [2][L][ldx]
  float* sDt = reinterpret_cast<float*>(sX + 2 * L * ldx);  // [2][L]
  float* sCum = sDt + 2 * L;
  float* sW = sCum + L;
  const int nc = S / L;
  const HeadGroup hg(blockIdx.x, H, G, nc, HB);
  const int t0 = hg.c * L;
  load_tile(sB, ldb, Bm + hg.b * st.b[0] + hg.g * st.b[1] + t0 * st.b[2],
            st.b[2], 0, L, 0, N, THREADS);
  auto load_head = [&](int i) {  // x and dt of head h0 + i into ring i % 2
    const int h = hg.h0 + i;
    load_tile(sX + (i & 1) * L * ldx, ldx,
              x + hg.b * st.x[0] + h * st.x[1] + t0 * st.x[2], st.x[2], 0, L,
              0, P, THREADS);
    load_column(sDt + (i & 1) * L,
                dt + hg.b * st.dt[0] + h * st.dt[1] + t0 * st.dt[2],
                st.dt[2], L);
  };
  load_head(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = warp * 16;
  for (int i = 0; i < hg.nh; ++i) {
    const int h = hg.h0 + i;
    if (i + 1 < hg.nh) load_head(i + 1);
    cp_async_commit();
    cp_async_wait(1);
    __syncthreads();  // head i's x and dt (and B) are in
    const float* dti = sDt + (i & 1) * L;
    if (warp == 0) {
      const float total = warp_cumsum(dti, sCum, A[h], L);
      for (int s = lane; s < L; s += 32)
        sW[s] = keep<T>(__expf(total - sCum[s]) * dti[s]);
      if (lane == 0) totals[((size_t)hg.b * H + h) * nc + hg.c] = total;
    }
    __syncthreads();  // sW
    const T* xi = sX + (i & 1) * L * ldx;
    if (m0 < N) {
      float acc[1][NP][4] = {};
#pragma unroll 2
      for (int k0 = 0; k0 < L; k0 += 8) {
        const int s0 = k0 + 2 * tq;
        const float w0 = sW[s0], w1 = sW[s0 + 1];
        const float* b0 = sB + s0 * ldb + m0 + gq;
        const float* b1 = b0 + ldb;
        const FragA a[1] = {
            frag_a<SPLIT>(keep<T>(b0[0] * w0), keep<T>(b0[8] * w0),
                          keep<T>(b1[0] * w1), keep<T>(b1[8] * w1))};
        const T* x0 = xi + s0 * ldx + gq;
        const T* x1 = x0 + ldx;
        FragB b[NP];
#pragma unroll
        for (int j = 0; j < NP; ++j)
          b[j] = frag_b<SPLIT>(to_f(x0[8 * j]), to_f(x1[8 * j]));
        mma<SPLIT, 1>(acc, a, b);
      }
      float* out = states + (((size_t)hg.b * H + h) * nc + hg.c) * N * P +
                   (m0 + gq) * P + 2 * tq;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        store2<float>(out + 8 * j, acc[0][j][0], acc[0][j][1]);
        store2<float>(out + 8 * P + 8 * j, acc[0][j][2], acc[0][j][3]);
      }
    }
    __syncthreads();  // ring slot i % 2, sW and sCum are free again
  }
}

// 3. The recurrence over the chunks of one (b, h), in place: states[c]
// becomes the h_prev of chunk c, and the last h goes to `state`.  Each
// thread owns four consecutive elements of N·P and keeps four chunks'
// loads in flight.
__global__ void __launch_bounds__(THREADS)
    recur_kernel(float* __restrict__ states, const float* __restrict__ totals,
                 float* __restrict__ state, int nc, int NP4, int blocks) {
  const int bh = blockIdx.x / blocks;
  const int e = (blockIdx.x % blocks) * THREADS + threadIdx.x;
  if (e >= NP4) return;
  float4* buf = reinterpret_cast<float4*>(states) + (size_t)bh * nc * NP4 + e;
  const float* tot = totals + (size_t)bh * nc;
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 v[4];
    float k[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + i < nc) {
        v[i] = buf[(size_t)(c0 + i) * NP4];
        k[i] = expf(tot[c0 + i]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (c0 + i < nc) {
        buf[(size_t)(c0 + i) * NP4] = run;
        run = make_float4(fmaf(k[i], run.x, v[i].x), fmaf(k[i], run.y, v[i].y),
                          fmaf(k[i], run.z, v[i].z), fmaf(k[i], run.w, v[i].w));
      }
  }
  reinterpret_cast<float4*>(state)[(size_t)bh * NP4 + e] = run;
}

// 4. y for one chunk of HB heads that share one chunk of C and of CB.  C
// ([L][N + 8]) and CB ([L][L + 8]) are loaded once; then per head: exp(
// cum_t)·C·h_prev, the scores (CB times the decay and dt, formed in
// registers from CB a k-step at a time; in the diagonal block masked to
// s ≤ t before the exponential, below it from the factored decay in sF),
// scores·x, and D·x.  h_prev ([N][P + 4]) and x with dt ([L][P + 4] fp32,
// [L][P + 8] bf16) each have one slot, refilled by cp.async as soon as
// their product is done: the next head's h_prev lands while this head's
// scores·x runs, its x while its C·h_prev runs.  Warps come in pairs, one
// per half of P; pair p owns the 16-row blocks p and L/16 − 1 − p, so that
// every warp has the same share of the causal scores.
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS, 1)
    out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Dskip,
               const T* __restrict__ Cm, const float* __restrict__ cb,
               const float* __restrict__ hprev, T* __restrict__ y,
               const Strides st, int H, int G, int S, int L, int N, int P,
               int HB) {
  constexpr bool SPLIT = sizeof(T) == 4;
  constexpr int NH = NP / 2;  // 8-wide tiles of P a warp owns
  extern __shared__ __align__(16) float smem[];
  const int ldc = N + 8, ldcb = L + 8, ldh = P + 4, ldx = x_pitch<T>(P);
  float* sC = smem;
  float* sCB = sC + L * ldc;
  float* sH = sCB + L * ldcb;
  T* sX = reinterpret_cast<T*>(sH + N * ldh);
  float* sDt = reinterpret_cast<float*>(sX + L * ldx);
  float* sCum = sDt + L;
  float* sF = sCum + L;  // [L/16][L]
  const int nc = S / L;
  const HeadGroup hg(blockIdx.x, H, G, nc, HB);
  const int t0 = hg.c * L;
  load_tile(sC, ldc, Cm + hg.b * st.c[0] + hg.g * st.c[1] + t0 * st.c[2],
            st.c[2], 0, L, 0, N, THREADS);
  load_tile(sCB, ldcb, cb + ((size_t)(hg.b * G + hg.g) * nc + hg.c) * L * L,
            L, 0, L, 0, L, THREADS);
  cp_async_commit();
  auto load_h = [&](int h) {
    load_tile(sH, ldh, hprev + (((size_t)hg.b * H + h) * nc + hg.c) * N * P,
              P, 0, N, 0, P, THREADS);
  };
  auto load_x = [&](int h) {
    load_tile(sX, ldx, x + hg.b * st.x[0] + h * st.x[1] + t0 * st.x[2],
              st.x[2], 0, L, 0, P, THREADS);
    load_column(sDt, dt + hg.b * st.dt[0] + h * st.dt[1] + t0 * st.dt[2],
                st.dt[2], L);
  };
  load_h(hg.h0);
  cp_async_commit();
  load_x(hg.h0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int pair = warp / 2, p0 = (warp % 2) * NH * 8;
  const bool live = pair < L / 32;
  const int rb[2] = {pair, L / 16 - 1 - pair};
  for (int i = 0; i < hg.nh; ++i) {
    const int h = hg.h0 + i;
    cp_async_wait(1);
    __syncthreads();  // h_prev of head i (and C, CB) are in
    float acc[2][NH][4] = {};
    if (live) {
#pragma unroll 2
      for (int k0 = 0; k0 < N; k0 += 8) {
        FragA a[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* c0 = sC + (16 * rb[r] + gq) * ldc + k0 + 2 * tq;
          const float2 u = *reinterpret_cast<const float2*>(c0);
          const float2 v = *reinterpret_cast<const float2*>(c0 + 8 * ldc);
          a[r] = frag_a<SPLIT>(u.x, v.x, u.y, v.y);
        }
        const float* h0 = sH + (k0 + 2 * tq) * ldh + p0 + gq;
        const float* h1 = h0 + ldh;
        FragB f[NH];
#pragma unroll
        for (int n = 0; n < NH; ++n)
          f[n] = frag_b<SPLIT>(keep<T>(h0[8 * n]), keep<T>(h1[8 * n]));
        mma<SPLIT, 2>(acc, a, f);
      }
    }
    __syncthreads();  // sH is read
    if (i + 1 < hg.nh) load_h(h + 1);
    cp_async_commit();
    cp_async_wait(1);
    __syncthreads();  // x and dt of head i are in
    if (warp == 0) warp_cumsum(sDt, sCum, A[h], L);
    __syncthreads();  // sCum
    // Below the diagonal block of the 16-row block k (rows t ≥ r = 16k,
    // columns s < r) the decay factors through row r: exp(cum_t − cum_s) =
    // exp(cum_t − cum_r)·exp(cum_r − cum_s), both at most 1.  sF[k][s] holds
    // the column factor times dt_s, so those scores need no exponential.
    for (int e = threadIdx.x; e < L / 16 * L; e += THREADS) {
      const int k = e / L, s = e % L;
      if (s < 16 * k) sF[e] = __expf(sCum[16 * k] - sCum[s]) * sDt[s];
    }
    __syncthreads();  // sF
    if (live) {
      const float dsk = Dskip[h];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int ta = 16 * rb[r] + gq, tb = ta + 8;
        const float cta = sCum[ta], ctb = sCum[tb];
        const float ea = __expf(cta), eb = __expf(ctb);
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          acc[r][n][0] *= ea;
          acc[r][n][1] *= ea;
          acc[r][n][2] *= eb;
          acc[r][n][3] *= eb;
        }
        const float* cba = sCB + ta * ldcb + 2 * tq;
        const float cr = sCum[16 * rb[r]];
        const float ga = __expf(cta - cr), gb = __expf(ctb - cr);
        const float* fr = sF + rb[r] * L + 2 * tq;
        // steps below the diagonal block: the factored decay
#pragma unroll 2
        for (int j = 0; j < 2 * rb[r]; ++j) {
          const int s0 = 8 * j + 2 * tq;
          const float2 u = *reinterpret_cast<const float2*>(cba + 8 * j);
          const float2 v =
              *reinterpret_cast<const float2*>(cba + 8 * ldcb + 8 * j);
          const float2 fs = *reinterpret_cast<const float2*>(fr + 8 * j);
          const FragA a[1] = {frag_a<SPLIT>(
              keep<T>(u.x * ga * fs.x), keep<T>(v.x * gb * fs.x),
              keep<T>(u.y * ga * fs.y), keep<T>(v.y * gb * fs.y))};
          const T* x0 = sX + s0 * ldx + p0 + gq;
          const T* x1 = x0 + ldx;
          FragB f[NH];
#pragma unroll
          for (int n = 0; n < NH; ++n)
            f[n] = frag_b<SPLIT>(to_f(x0[8 * n]), to_f(x1[8 * n]));
          mma<SPLIT, 1>(&acc[r], a, f);
        }
        // the diagonal block: masked to s ≤ t before the exponential
#pragma unroll
        for (int j = 2 * rb[r]; j <= 2 * rb[r] + 1; ++j) {
          const int s0 = 8 * j + 2 * tq;
          const float2 u = *reinterpret_cast<const float2*>(cba + 8 * j);
          const float2 v =
              *reinterpret_cast<const float2*>(cba + 8 * ldcb + 8 * j);
          const float2 cs = *reinterpret_cast<const float2*>(sCum + s0);
          const float2 ds = *reinterpret_cast<const float2*>(sDt + s0);
          const FragA a[1] = {frag_a<SPLIT>(
              s0 <= ta ? keep<T>(u.x * __expf(cta - cs.x) * ds.x) : 0.f,
              s0 <= tb ? keep<T>(v.x * __expf(ctb - cs.x) * ds.x) : 0.f,
              s0 < ta ? keep<T>(u.y * __expf(cta - cs.y) * ds.y) : 0.f,
              s0 < tb ? keep<T>(v.y * __expf(ctb - cs.y) * ds.y) : 0.f)};
          const T* x0 = sX + s0 * ldx + p0 + gq;
          const T* x1 = x0 + ldx;
          FragB f[NH];
#pragma unroll
          for (int n = 0; n < NH; ++n)
            f[n] = frag_b<SPLIT>(to_f(x0[8 * n]), to_f(x1[8 * n]));
          mma<SPLIT, 1>(&acc[r], a, f);
        }
        T* ya = y + hg.b * st.y[0] + h * st.y[1] + (t0 + ta) * st.y[2] + p0 +
                2 * tq;
        T* yb = ya + 8 * st.y[2];
        const T* xa = sX + ta * ldx + p0 + 2 * tq;
        const T* xb = xa + 8 * ldx;
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          store2<T>(ya + 8 * n, acc[r][n][0] + dsk * to_f(xa[8 * n]),
                    acc[r][n][1] + dsk * to_f(xa[8 * n + 1]));
          store2<T>(yb + 8 * n, acc[r][n][2] + dsk * to_f(xb[8 * n]),
                    acc[r][n][3] + dsk * to_f(xb[8 * n + 1]));
        }
      }
    }
    __syncthreads();  // sX, sDt, sCum and sF are read
    if (i + 1 < hg.nh) load_x(h + 1);
    cp_async_commit();
  }
}

struct Smem {
  size_t cb, state, out;
  template <typename T>
  static Smem of(int L, int N, int P) {
    const size_t xb = sizeof(T) * L * x_pitch<T>(P), f = sizeof(float);
    return Smem{f * 2 * L * (N + 8), f * (L * (N + 4) + 4 * L) + 2 * xb,
                f * (L * (N + 8) + L * (L + 8) + N * (P + 4) + 2 * L +
                     L / 16 * L) + xb};
  }
};

// Heads a block of state_kernel and out_kernel takes: up to 8, fewer where
// the grid would then fill the card fewer than four times over.
int heads_per_block(int Bsz, int H, int nc) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return std::max(1, std::min(8, Bsz * H * nc / (4 * sms)));
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int NP>
cudaError_t launch(const T* x, const float* dt, const float* A,
                   const float* D, const T* Bm, const T* Cm, T* y,
                   float* state, float* cb, float* states, float* totals,
                   const Strides& st, int Bsz, int H, int G, int S, int L,
                   int N, int P, cudaStream_t stream) {
  const Smem sm = Smem::of<T>(L, N, P);
  const int nc = S / L, HB = heads_per_block(Bsz, H, nc);
  const int blocks = Bsz * G * nc * ((H / G + HB - 1) / HB);
  cudaError_t err;
  if ((err = allow_smem(cb_kernel<T>, sm.cb)) != cudaSuccess) return err;
  cb_kernel<T><<<Bsz * G * nc, THREADS, sm.cb, stream>>>(Bm, Cm, cb, st, G,
                                                          S, L, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(state_kernel<T, NP>, sm.state)) != cudaSuccess)
    return err;
  state_kernel<T, NP><<<blocks, THREADS, sm.state, stream>>>(
      x, dt, A, Bm, states, totals, st, H, G, S, L, N, P, HB);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int NP4 = N * P / 4, rblocks = (NP4 + THREADS - 1) / THREADS;
  recur_kernel<<<Bsz * H * rblocks, THREADS, 0, stream>>>(states, totals,
                                                           state, nc, NP4,
                                                           rblocks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(out_kernel<T, NP>, sm.out)) != cudaSuccess)
    return err;
  out_kernel<T, NP><<<blocks, THREADS, sm.out, stream>>>(
      x, dt, A, D, Cm, cb, states, y, st, H, G, S, L, N, P, HB);
  return cudaGetLastError();
}

// P = 8·NP with NP 2, 4 or 8: the product loops over P run at compile time.
template <typename T>
cudaError_t launch_p(const T* x, const float* dt, const float* A,
                     const float* D, const T* Bm, const T* Cm, T* y,
                     float* state, float* cb, float* states, float* totals,
                     const Strides& st, int Bsz, int H, int G, int S, int L,
                     int N, int P, cudaStream_t stream) {
  switch (P) {
    case 16:
      return launch<T, 2>(x, dt, A, D, Bm, Cm, y, state, cb, states, totals,
                          st, Bsz, H, G, S, L, N, P, stream);
    case 32:
      return launch<T, 4>(x, dt, A, D, Bm, Cm, y, state, cb, states, totals,
                          st, Bsz, H, G, S, L, N, P, stream);
    case 64:
      return launch<T, 8>(x, dt, A, D, Bm, Cm, y, state, cb, states, totals,
                          st, Bsz, H, G, S, L, N, P, stream);
  }
  return cudaErrorInvalidValue;
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace tc

// The shapes every route admits.
bool admitted(int Bsz, int H, int G, int S, int L, int N, int P) {
  return Bsz > 0 && H > 0 && G > 0 && H % G == 0 && N > 0 && P > 0 &&
         L > 0 && L % 32 == 0 && S > 0 && S % L == 0;
}

Strides unpack(const int64_t* strides) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.c[i] = strides[9 + i];
    st.y[i] = strides[12 + i];
  }
  return st;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, H, S, P), dt (B, H, S) fp32, A/D (H,) fp32, B/C (B, G, S, N),
// y (B, H, S, P), state (B, H, N, P) fp32.  `strides` holds 15 element
// strides, (batch, head or group, step) of x, dt, B, C and y in turn; the
// last axis of x, B, C and y is contiguous, and A, D and state are
// contiguous.  x, B, C and y share dtype: 0 = float32, 1 = bfloat16.  S
// must be a multiple of the chunk L, and L a multiple of 32; shapes whose
// tiles need more shared memory than a block can have are refused.
// Returns a cudaError_t.  The CUDA-core route.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* D,
            const void* Bm, const void* Cm, void* y, void* state,
            const int64_t* strides, int Bsz, int H, int G, int S, int L, int N,
            int P, int dtype, void* stream) {
  if (!admitted(Bsz, H, G, S, L, N, P)) return cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* out = static_cast<float*>(state);
  if (dtype == 0)
    return launch<float>(x, dtf, Af, Df, Bm, Cm, y, out, st, Bsz, H, G, S, L,
                         N, P, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Df, Bm, Cm, y, out, st, Bsz, H,
                                 G, S, L, N, P, s);
  return cudaErrorInvalidValue;
}

// The tensor-core route (see the top of this file): ssd_fwd's arguments,
// then three fp32 scratch buffers, cb (B, G, S/L, L, L), states (B, H, S/L,
// N, P) and totals (B, H, S/L), then the stream.  Also refuses what the
// route does not take: L over 128, N not a multiple of 16 or over 128, P
// other than 16, 32 or 64, an x, B or C whose base or strides are
// not multiples of 16 bytes, a y not aligned for pairs of elements.
int ssd_tc_fwd(const void* x, const void* dt, const void* A, const void* D,
               const void* Bm, const void* Cm, void* y, void* state,
               const int64_t* strides, int Bsz, int H, int G, int S, int L,
               int N, int P, int dtype, void* cb, void* states, void* totals,
               void* stream) {
  if (!admitted(Bsz, H, G, S, L, N, P) || L > tc::MAX_L || N % 16 != 0 ||
      N > tc::MAX_N || (P != 16 && P != 32 && P != 64) ||
      (dtype != 0 && dtype != 1) ||
      cb == nullptr || states == nullptr || totals == nullptr)
    return cudaErrorInvalidValue;
  const Strides st = unpack(strides);
  const int elt = dtype == 0 ? 4 : 2;
  const void* rows[3] = {x, Bm, Cm};
  const int64_t* rs[3] = {st.x, st.b, st.c};
  for (int i = 0; i < 3; ++i) {
    if (!tc::aligned(rows[i], 16)) return cudaErrorInvalidValue;
    for (int k = 0; k < 3; ++k)
      if (rs[i][k] * elt % 16 != 0) return cudaErrorInvalidValue;
  }
  if (!tc::aligned(y, 2 * elt) || st.y[0] % 2 || st.y[1] % 2 || st.y[2] % 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* out = static_cast<float*>(state);
  float* cbf = static_cast<float*>(cb);
  float* stf = static_cast<float*>(states);
  float* tot = static_cast<float*>(totals);
  if (dtype == 0)
    return tc::launch_p<float>(
        static_cast<const float*>(x), dtf, Af, Df,
        static_cast<const float*>(Bm), static_cast<const float*>(Cm),
        static_cast<float*>(y), out, cbf, stf, tot, st, Bsz, H, G, S, L, N,
        P, s);
  typedef __nv_bfloat16 bf16;
  return tc::launch_p<bf16>(static_cast<const bf16*>(x), dtf, Af, Df,
                          static_cast<const bf16*>(Bm),
                          static_cast<const bf16*>(Cm), static_cast<bf16*>(y),
                          out, cbf, stf, tot, st, Bsz, H, G, S, L, N, P, s);
}

}  // extern "C"
