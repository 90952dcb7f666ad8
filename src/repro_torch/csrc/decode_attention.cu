// Single-token decode attention for Hopper (sm_90a): GQA with the G q
// heads of one kv head packed together, sliding window, tanh softcap,
// fp32 online softmax.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py,
//   decode_attention_pallas / _decode_kernel (the pl.pallas_call at :119).
//
// What it computes, per (b, kv head h) and each of its G q heads:
// attention of q over cache keys [lo, kv_len), lo = max(0, kv_len − window)
// when window > 0 else 0; s = (q · k in fp32) × scale, then cap·tanh(s/cap)
// when cap > 0; softmax in fp32; o in the input dtype; no live key → 0.
// `kv_len` comes either by value or as a pointer to an int32 on the card,
// so a decode loop never copies it to the host.
//
// What bounds it on an H100: memory.  Every live key and value row is read
// once (2·D·bytes per key per kv head) for about 4·G·D flops, far under the
// card's 295 flops per byte, so the bound is bytes / 3.35 TB/s.
//
// Design.  One block of 512 threads per (b, kv head), as the TPU kernel's
// grid has one (b, h) column per kv head; the TPU's sequential kv-tile
// axis becomes a split across the block's 16 warps.  Each warp walks its
// own interleaved runs of U keys, each lane holding D/32 contiguous
// elements of a row (16-byte loads, so a warp reads a whole row in one
// coalesced request), with U rows of k and v in flight per lane, and keeps
// its own (m, l, acc) for the G heads in registers; a dot product is a
// warp shuffle reduction.  Only live keys are visited, so no mask is
// needed.  At the end the 16 partial softmaxes are merged through shared
// memory.  The limit of this design is parallelism: at B·Hkv = 16 blocks
// it reaches only 16 of the 132 SMs, so it cannot approach the memory
// bound; splitting the keys across blocks is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;
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

// N contiguous elements from p (16-byte aligned when N·sizeof(T) is a
// multiple of 16) into fp32 registers.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&out)[N]) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < N; c += V) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) out[c + j] = to_f(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(p[j]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int* __restrict__ kv_len_dev, int kv_len_host, int S,
                  int window, float scale, float softcap) {
  constexpr int EPL = D / 32;                       // elements per lane
  constexpr int U = G >= 8 ? 1 : (G >= 4 ? 2 : 4);  // keys in flight
  extern __shared__ float smem[];                   // NW x G x (D + 2)

  const int bh = blockIdx.x;  // b * Hkv + h
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int kv_len = kv_len_dev ? *kv_len_dev : kv_len_host;
  kv_len = min(max(kv_len, 0), S);
  const int lo = window > 0 ? max(0, kv_len - window) : 0;

  const T* kb = k + (size_t)bh * S * D + lane * EPL;
  const T* vb = v + (size_t)bh * S * D + lane * EPL;

  float qr[G][EPL], acc[G][EPL], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_row<T, EPL>(q + ((size_t)bh * G + g) * D + lane * EPL, qr[g]);
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int base = lo + warp * U; base < kv_len; base += NW * U) {
    float kr[U][EPL], vr[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = min(base + u, kv_len - 1);  // tail rows re-read a live one
      load_row<T, EPL>(kb + (size_t)key * D, kr[u]);
      load_row<T, EPL>(vb + (size_t)key * D, vr[u]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kr[u][e], part);
        float x = warp_sum(part) * scale;  // fp32 dot, then scale, then cap
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[u] = x;
        if (base + u < kv_len) mx = fmaxf(mx, x);
      }
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = base + u < kv_len ? expf(s[u] - mx) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vr[u][e], acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // Merge the NW partial softmaxes.
  constexpr int LD = D + 2;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* row = smem + (warp * G + g) * LD;
#pragma unroll
    for (int e = 0; e < EPL; ++e) row[lane * EPL + e] = acc[g][e];
    if (lane == 0) {
      row[D] = m[g];
      row[D + 1] = l[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, smem[(w * G + g) * LD + D]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float* row = smem + (w * G + g) * LD;
      const float c = expf(row[D] - M);
      L = fmaf(row[D + 1], c, L);
      A = fmaf(row[d], c, A);
    }
    o[((size_t)bh * G + g) * D + d] = from_f<T>(L == 0.f ? 0.f : A / L);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* kv_len_dev, int kv_len_host, int B, int Hkv,
                   int S, int window, float scale, float softcap,
                   cudaStream_t stream) {
  auto kern = decode_kernel<T, D, G>;
  const size_t bytes = sizeof(float) * NW * G * (D + 2);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<B * Hkv, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), kv_len_dev, kv_len_host, S,
      window, scale, softcap);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, void* o,
                       const int* kd, int kh, int B, int Hkv, int G, int S,
                       int window, float scale, float softcap,
                       cudaStream_t s) {
  switch (G) {
    case 1:
      return launch<T, D, 1>(q, k, v, o, kd, kh, B, Hkv, S, window, scale,
                             softcap, s);
    case 2:
      return launch<T, D, 2>(q, k, v, o, kd, kh, B, Hkv, S, window, scale,
                             softcap, s);
    case 4:
      return launch<T, D, 4>(q, k, v, o, kd, kh, B, Hkv, S, window, scale,
                             softcap, s);
    case 8:
      return launch<T, D, 8>(q, k, v, o, kd, kh, B, Hkv, S, window, scale,
                             softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       const int* kd, int kh, int B, int Hkv, int G, int S,
                       int D, int window, float scale, float softcap,
                       cudaStream_t s) {
  switch (D) {
    case 64:
      return dispatch_g<T, 64>(q, k, v, o, kd, kh, B, Hkv, G, S, window,
                               scale, softcap, s);
    case 128:
      return dispatch_g<T, 128>(q, k, v, o, kd, kh, B, Hkv, G, S, window,
                                scale, softcap, s);
    case 256:
      return dispatch_g<T, 256>(q, k, v, o, kd, kh, B, Hkv, G, S, window,
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

// q (B, Hq, D), k/v (B, Hkv, S, D), o (B, Hq, D), all contiguous with
// 16-byte-aligned bases.  kv_len_dev, when not null, points to one int32
// on the card and takes the place of kv_len_host.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                         const void* kv_len_dev, int kv_len_host, int B,
                         int Hq, int Hkv, int S, int D, int dtype, int window,
                         float scale, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  const int* kd = static_cast<const int*>(kv_len_dev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = Hq / Hkv;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, kd, kv_len_host, B, Hkv, G, S, D,
                             window, scale, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, kd, kv_len_host, B, Hkv, G,
                                     S, D, window, scale, softcap, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
