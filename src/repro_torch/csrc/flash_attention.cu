// Flash attention forward for Hopper (sm_90a): GQA, causal, sliding
// window, tanh softcap, fp32 online softmax.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
//   flash_attention_pallas / _flash_kernel (the pl.pallas_call at :136).
//
// What it computes, per (b, hq):  s = (q · kᵀ in fp32) × scale, then
// cap·tanh(s/cap) when cap > 0; keys with col ≥ Sk, col > row (causal) or
// col ≤ row − window (window > 0) are masked; softmax in fp32; o = p · v,
// written in the input dtype.  A row with no live key gives 0.
//
// What bounds it on an H100: at prefill lengths it is compute-bound
// (about 4·D flops per live (row, col) pair against 2 bytes per element
// of q, k, v, o).  This first version does its arithmetic in fp32 on the
// CUDA cores, not the tensor cores, so its ceiling is the card's fp32
// rate (67 TFLOP/s), not the 989 TFLOP/s of bf16 wgmma; moving the two
// products onto wgmma with TMA-fed tiles is later work.
//
// Design.  The TPU kernel walks kv tiles as a sequential grid axis and
// carries (m, l, acc) in VMEM scratch between grid steps.  Here one block
// owns one (b, hq, 64-row q tile) and loops over kv tiles itself, so the
// state stays in registers.  The loop covers only the tiles between the
// first and last live key of the q tile, computed from the causal and
// window bounds, instead of testing every tile.  q, k, v tiles are held in
// fp32 in dynamic shared memory (rows padded by one word so that threads
// reading one column of sixteen rows hit sixteen banks); at D = 256 that
// is 214 KB, one block per SM.  Each of the 256 threads owns 4 q rows:
// 4×4 scores of a 64×64 tile, and 4 rows × D/16 columns of the output
// accumulator.  The 16 threads that share a row sit in one half-warp, so
// row max and row sum are shuffles.  The q tiles of a head are issued
// last tile first, so the longest causal tiles start earliest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16: tx picks columns, ty picks rows
constexpr float NEG_INF = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + 2 * (size_t)BK * (D + 1) +
                          (size_t)BQ * (BK + 1));
}

template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int nrows_valid, int rows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * LD + d] =
        (row0 + r < nrows_valid) ? to_f(src[(size_t)(row0 + r) * D + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Hq, int G,
                     int Sq, int Sk, int causal, int window, float scale,
                     float softcap) {
  constexpr int LD = D + 1;
  constexpr int LDS = BK + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y;                  // b * Hq + hq
  const int b = bh / Hq, hq = bh % Hq;
  const int Hkv = Hq / G;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)(b * Hkv + hq / G) * Sk * D;
  const T* vb = v + (size_t)(b * Hkv + hq / G) * Sk * D;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<T, D>(sQ, qb, q0, Sq, BQ);

  // Live keys of this q tile: [k_lo, k_hi).
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_lo / BK) * BK; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, kb, k0, Sk, BK);
    load_tile<T, D>(sV, vb, k0, Sk, BK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool live[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        live[j] = col < Sk && (!causal || col <= row) &&
                  (window <= 0 || col > row - window);
        float x = s[i][j] * scale;  // fp32 dot, then scale, then softcap
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = live[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        sP[(ty + 16 * i) * LDS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = sV[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
    T* orow = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                   float scale, float softcap, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hkv, Sq, Sk,
      causal, window, scale, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Sk, int D,
                       int causal, int window, float scale, float softcap,
                       cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                           scale, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                            scale, softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                            scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o (B, Hq, Sq, D), all contiguous.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Sk, int D,
                        int dtype, int causal, int window, float scale,
                        float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, window,
                             scale, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                     window, scale, softcap, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
