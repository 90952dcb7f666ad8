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
// float32; every product is taken in fp32.  x, dt, B, C and y are read and
// written through their strides (the innermost one is 1), so the model
// passes views of its (B, S, ...) tensors and copies nothing.
//
// What bounds it on an H100: at mamba2-1.3b's prefill shape (L 128,
// N 128, P 64) a chunk costs about 3.6 M multiply-adds per (b, h) against
// 4·(L·P + 2·L·N) input bytes, so it is bound by operations.  This first
// version computes in fp32 on the CUDA cores (ceiling 67 TFLOP/s), not on
// the tensor cores; wgmma, TMA-fed tiles and a parallel chunk-state pass
// are later work.
//
// Design.  The TPU kernel keeps the state in VMEM scratch across a
// sequential ("arbitrary") chunk grid axis.  Hopper runs blocks in no
// order, so one block of 256 threads owns one (b, h) and loops over its
// chunks, with the state in shared memory.  Per chunk: x and B are loaded
// whole (as fp32), the cumsum is a warp scan, then the query rows go in
// tiles of 64: the C rows of the tile, the score tile (only s ≤ t is
// computed, and masked before exp, so exp never sees cum_t − cum_s > 0),
// then y = scores·x + exp(cum_t)·(C·h_prev) + D·x.  After the last row
// tile has read h_prev (barrier), B is scaled by exp(cum_L − cum_s)·dt_s
// in place and the state update runs, each thread owning its own (n, p)
// elements.  At L 128, N 128, P 64 this takes 195 KB of dynamic shared
// memory, one block per SM, and B·H = 256 blocks.  Every product is a
// 64×64 output tile per pass, each thread a 4×4 micro-tile with stride 16;
// row strides are odd, so a half-warp reading a column hits 16 banks.

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
// Returns a cudaError_t.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* D,
            const void* Bm, const void* Cm, void* y, void* state,
            const int64_t* strides, int Bsz, int H, int G, int S, int L, int N,
            int P, int dtype, void* stream) {
  if (Bsz <= 0 || H <= 0 || G <= 0 || H % G != 0 || N <= 0 || P <= 0 ||
      L <= 0 || L % 32 != 0 || S <= 0 || S % L != 0)
    return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
    st.b[i] = strides[6 + i];
    st.c[i] = strides[9 + i];
    st.y[i] = strides[12 + i];
  }
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

}  // extern "C"
