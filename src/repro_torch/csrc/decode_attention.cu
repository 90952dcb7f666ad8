// Single-token decode attention for Hopper (sm_90a): GQA with the q heads
// of one kv head packed together, sliding window, tanh softcap, fp32
// online softmax, the live keys split across the card.
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
// Design.  The TPU kernel walks the keys of one (b, kv head) as a
// sequential grid axis.  Here the grid is (B·Hkv·G/GB, SPLITS): each block
// holds GB ≤ 8 q heads of one kv head in registers (the host's
// `heads_per_block`; G 16 is two blocks of 8 that read the same keys, the
// second mostly from L2) and takes one
// SPLITS-th of the live keys [lo, kv_len), its slice computed on the card
// from kv_len, so a decode loop's split never depends on a host read.
// SPLITS is fixed by the host from the cache's capacity and the SM count
// (`decode_attention.py:num_splits`), about two blocks an SM.  Inside a
// block, 8 warps walk interleaved runs of rows; a row is read 16 bytes a
// lane by LPR = min(32, D·bytes/16) lanes, so a warp reads 32/LPR whole
// rows in one coalesced request, U rows of k and v per lane in flight and
// the next U prefetched while the current ones are used.  Each lane group
// keeps its own (m, l, acc) and a dot product is a shuffle reduction over
// its LPR lanes.  Only live keys are visited, so no mask is needed.  The
// softcap's tanh and the softmax's exponentials are built from ex2 and
// rcp, a few instructions a score.
//
// Merge, in the same launch (one launch a call: the decode step is
// host-bound).  The partial softmaxes of a block are merged through shared
// memory; with SPLITS > 1 each block then writes its (m, l, acc) to
// scratch the wrapper allocates, and the last block of a (b, kv head, head
// block) to arrive, found by an atomic counter that it returns to 0, merges
// the SPLITS partials and writes o.  A block whose slice is empty
// contributes (m = −inf, l = 0).  The counters persist in the wrapper, one
// array per (device, stream), zeroed once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// exp and tanh of the hot loop from ex2 and rcp (relative error about
// 1e-7, inside the fp32 tolerance): a few instructions a score where the
// library's expf and tanhf take tens.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float exp_fast(float x) {
  return ex2_approx(x * LOG2E);
}
__device__ __forceinline__ float tanh_fast(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n"
      : "=f"(r)
      : "f"(1.f + ex2_approx(2.f * LOG2E * x)));
  return 1.f - 2.f * r;
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// One 16-byte piece of a row as fp32 values.
__device__ __forceinline__ void unpack(const uint4& r, float (&out)[4],
                                       float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&out)[8],
                                       __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// How one row of D elements of T is read: 16-byte pieces, LPR lanes a
// row, NC pieces (EPL elements) a lane, RPW rows a warp at once.  Lane c of
// a row holds pieces j·LPR + c, j < NC, so a warp's loads are contiguous.
template <typename T, int D>
struct Row {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int CHUNKS = D / V;
  static constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32;
  static constexpr int NC = CHUNKS / LPR;
  static constexpr int EPL = NC * V;
  static constexpr int RPW = 32 / LPR;
  static_assert(CHUNKS % LPR == 0 && 32 % LPR == 0, "row split");
};

template <typename T, int D>
__device__ __forceinline__ void load_raw(const T* __restrict__ row, int c,
                                         uint4 (&r)[Row<T, D>::NC]) {
  typedef Row<T, D> R;
#pragma unroll
  for (int j = 0; j < R::NC; ++j)
    r[j] = __ldg(reinterpret_cast<const uint4*>(row) + j * R::LPR + c);
}

template <typename T, int D>
__device__ __forceinline__ void to_floats(const uint4 (&r)[Row<T, D>::NC],
                                          float (&out)[Row<T, D>::EPL]) {
  typedef Row<T, D> R;
#pragma unroll
  for (int j = 0; j < R::NC; ++j) {
    float piece[R::V];
    unpack(r[j], piece, T());
#pragma unroll
    for (int e = 0; e < R::V; ++e) out[j * R::V + e] = piece[e];
  }
}

// Element d of the row that lane c holds as its i-th value.
template <typename T, int D>
__device__ __forceinline__ int elem_of(int c, int i) {
  typedef Row<T, D> R;
  return ((i / R::V) * R::LPR + c) * R::V + i % R::V;
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(THREADS)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  const int* __restrict__ kv_len_dev, int kv_len_host, int S,
                  int G, int window, float scale, float softcap,
                  float* __restrict__ part, int* __restrict__ counters) {
  typedef Row<T, D> R;
  constexpr int EPL = R::EPL, NC = R::NC, RPW = R::RPW;
  constexpr int U = GB <= 2 ? 4 : (GB <= 4 ? 2 : 1);  // rows a load round
  constexpr int STEP = NW * RPW * U;  // rows a block visits a round
  constexpr int LD = D + 2;           // acc, then m and l
  extern __shared__ float smem[];     // NW·RPW x GB x LD

  const int splits = gridDim.y, split = blockIdx.y;
  const int nhb = G / GB;
  const int bh = blockIdx.x / nhb, hb = blockIdx.x % nhb;  // b·Hkv + h
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / R::LPR, c = lane % R::LPR;

  int kv_len = kv_len_dev ? *kv_len_dev : kv_len_host;
  kv_len = min(max(kv_len, 0), S);
  const int lo = window > 0 ? max(0, kv_len - window) : 0;
  const int per = (kv_len - lo + splits - 1) / splits;
  const int k0 = lo + split * per, k1 = min(kv_len, k0 + per);

  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const size_t q_row0 = (size_t)bh * G + (size_t)hb * GB;

  float qr[GB][EPL], acc[GB][EPL], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    uint4 raw[NC];
    load_raw<T, D>(q + (q_row0 + g) * D, c, raw);
    to_floats<T, D>(raw, qr[g]);
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // Rows base + u·RPW + grp of this lane group; a tail row re-reads the
  // last live one and counts for nothing.
  uint4 kr[U][NC], vr[U][NC];
  auto load = [&](int base, uint4 (&kd)[U][NC], uint4 (&vd)[U][NC]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = min(base + u * RPW + grp, k1 - 1);
      load_raw<T, D>(kb + (size_t)key * D, c, kd[u]);
      load_raw<T, D>(vb + (size_t)key * D, c, vd[u]);
    }
  };
  int base = k0 + warp * U * RPW;
  if (base < k1) load(base, kr, vr);
  for (; base < k1; base += STEP) {
    uint4 kn[U][NC], vn[U][NC];
    if (base + STEP < k1) load(base + STEP, kn, vn);   // warp-uniform

    float s[GB][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      to_floats<T, D>(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float part_dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          part_dot = fmaf(qr[g][e], kf[e], part_dot);
#pragma unroll
        for (int off = R::LPR / 2; off > 0; off >>= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
        float x = part_dot * scale;  // fp32 dot, then scale, then cap
        if (softcap > 0.f) x = softcap * tanh_fast(x * inv_cap);
        s[g][u] = x;
      }
    }
    float p[GB][U];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (base + u * RPW + grp < k1) mx = fmaxf(mx, s[g][u]);
      const float alpha = exp_fast(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[g][u] = base + u * RPW + grp < k1 ? exp_fast(s[g][u] - mx) : 0.f;
        l[g] += p[g][u];
      }
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
      to_floats<T, D>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[g][e] = fmaf(p[g][u], vf[e], acc[g][e]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        kr[u][j] = kn[u][j];
        vr[u][j] = vn[u][j];
      }
  }

  // Merge the block's NW·RPW partial softmaxes through shared memory.
  const int pidx = warp * RPW + grp;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float* row = smem + (pidx * GB + g) * LD;
#pragma unroll
    for (int e = 0; e < EPL; ++e) row[elem_of<T, D>(c, e)] = acc[g][e];
    if (c == 0) {
      row[D] = m[g];
      row[D + 1] = l[g];
    }
  }
  __syncthreads();
  constexpr int NP = NW * RPW;
  float* mine = part + ((size_t)blockIdx.x * splits + split) * GB * LD;
  for (int idx = threadIdx.x; idx < GB * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NP; ++w) M = fmaxf(M, smem[(w * GB + g) * LD + D]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NP; ++w) {
      const float* row = smem + (w * GB + g) * LD;
      const float f = expf(row[D] - M);
      L = fmaf(row[D + 1], f, L);
      A = fmaf(row[d], f, A);
    }
    if (splits == 1) {
      o[(q_row0 + g) * D + d] = from_f<T>(L == 0.f ? 0.f : A / L);
    } else {
      mine[g * LD + d] = A;
      if (d == 0) {
        mine[g * LD + D] = M;
        mine[g * LD + D + 1] = L;
      }
    }
  }
  if (splits == 1) return;

  // The last block of this (b, kv head, head block) merges the splits.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* parts = part + (size_t)blockIdx.x * splits * GB * LD;
  for (int idx = threadIdx.x; idx < GB * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = NEG_INF;
    for (int sp = 0; sp < splits; ++sp)
      M = fmaxf(M, __ldcg(parts + (sp * GB + g) * LD + D));
    float L = 0.f, A = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* row = parts + (sp * GB + g) * LD;
      const float f = expf(__ldcg(row + D) - M);
      L = fmaf(__ldcg(row + D + 1), f, L);
      A = fmaf(__ldcg(row + d), f, A);
    }
    o[(q_row0 + g) * D + d] = from_f<T>(L == 0.f ? 0.f : A / L);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const int* kv_len_dev;
  int kv_len_host, B, Hkv, G, GB, S, window, splits;
  float scale, softcap;
  float* part;
  int* counters;
  cudaStream_t stream;
};

template <typename T, int D, int GB>
cudaError_t launch(const Args& a) {
  auto kern = decode_kernel<T, D, GB>;
  const size_t bytes =
      sizeof(float) * NW * Row<T, D>::RPW * GB * (D + 2);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv * (a.G / GB), a.splits);
  kern<<<grid, THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.kv_len_dev,
      a.kv_len_host, a.S, a.G, a.window, a.scale, a.softcap, a.part,
      a.counters);
  return cudaGetLastError();
}

// The q heads a block holds in registers, GB, divides G.
template <typename T, int D>
cudaError_t dispatch_g(const Args& a) {
  if (a.GB <= 0 || a.G % a.GB != 0) return cudaErrorInvalidValue;
  switch (a.GB) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 4: return launch<T, D, 4>(a);
    case 5: return launch<T, D, 5>(a);
    case 6: return launch<T, D, 6>(a);
    case 8: return launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(const Args& a, int D) {
  switch (D) {
    case 64: return dispatch_g<T, 64>(a);
    case 128: return dispatch_g<T, 128>(a);
    case 256: return dispatch_g<T, 256>(a);
    default: return cudaErrorInvalidValue;
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
// 1 = bfloat16.  heads_per_block (GB): q heads a block holds, 1, 2, 4,
// 5, 6 or 8, dividing G = Hq / Hkv; splits: key slices a (b, kv head);
// with splits > 1, `part` holds B·Hq·splits·(D + 2) floats of scratch and
// `counters` B·Hkv·(G/GB) int32 that are 0 (and are left 0).  Returns a
// cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v, void* o,
                         const void* kv_len_dev, int kv_len_host, int B,
                         int Hq, int Hkv, int S, int D, int dtype, int window,
                         float scale, float softcap, int heads_per_block,
                         int splits, void* part, void* counters,
                         void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || splits < 1 ||
      splits > 65535 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<const int*>(kv_len_dev), kv_len_host,
               B, Hkv, Hq / Hkv, heads_per_block, S, window, splits, scale,
               softcap, static_cast<float*>(part), static_cast<int*>(counters),
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>(a, D);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, D);
  return cudaErrorInvalidValue;
}

}  // extern "C"
