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
// of q, k, v, o): 989 TFLOP/s on the bf16 tensor cores.  In this design
// the softmax (scale, tanh, mask, max, exp2, sums: two MUFU operations a
// score) runs between the two products of a tile, with the tensor cores
// idle, so the bf16 route is bound by tensor-core time plus softmax time
// per tile; overlapping them (warp specialisation, ping-pong between the
// warpgroups) is the next step.
//
// bf16 route (the serving path).  One 256-thread block owns one (b, hq,
// 128-row q tile): two warpgroups of 64 q rows each, as wgmma's M is 64.
// Tiles come by TMA through 3-D tensor maps (D, S, B·H), so rows past the
// end of a head read as zeros, never the next head's, in the 128-byte
// swizzle wgmma reads (hopper.cuh): Q 128 x D once, K and V in a ring of
// two stages of 64 x D (192 KB of shared memory at D 256, one block an
// SM).  Thread 0 issues tile j+1's loads before the warpgroups start tile
// j; one mbarrier a stage counts the bytes.  Per tile and warpgroup:
// s = q·kᵀ by D/16 wgmma m64n64k16 from shared memory (both K-major);
// scale, softcap (tanh.approx: on scores past the cap its error does not
// show in the bf16 output, whose row errors equal those of an accurate
// tanh, which costs a third MUFU operation a score) and, on edge and
// diagonal tiles only, the mask, in fp32 on the accumulator fragment, in
// the log2 domain so the exponentials are ex2; row max over the quad by two shuffles; p rounded to bf16 in
// registers is the A operand of o += p·v by m64nDk16 with v MN-major from
// shared memory (the transpose bit).  o stays in registers
// (D/2 fp32 a thread), is divided by the row sum, staged in bf16 through
// the warpgroup's rows of the Q buffer and stored in 16-byte pieces.  The
// loop visits only the kv tiles between the block's first and last live
// key (causal and window bounds); a warpgroup skips tiles with no live
// key for its own rows.  Blocks run longest causal q tile first over all
// heads (the q tile index is the grid's slow axis).
//
// fp32 route (the card-vs-CPU check and the tests: TF32 would miss the
// 1e-4 tolerance), on the CUDA cores.  The TPU kernel walks kv tiles as a
// sequential grid axis and carries (m, l, acc) in VMEM scratch between
// grid steps.  Here one block owns one (b, hq, 64-row q tile) and loops
// over kv tiles itself, so the state stays in registers.  The loop covers
// only the tiles between the first and last live key of the q tile.  q,
// k, v tiles are held in fp32 in dynamic shared memory (rows padded by
// one word so that threads reading one column of sixteen rows hit sixteen
// banks); at D = 256 that is 214 KB, one block per SM.  Each of the 256
// threads owns 4 q rows: 4×4 scores of a 64×64 tile, and 4 rows × D/16
// columns of the output accumulator.  The 16 threads that share a row sit
// in one half-warp, so row max and row sum are shuffles.  The q tiles of a
// head are issued last tile first, so the longest causal tiles start
// earliest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---- fp32 route: CUDA cores ----

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;  // 16 x 16: tx picks columns, ty picks rows
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + 2 * (size_t)BK * (D + 1) +
                          (size_t)BQ * (BK + 1));
}

template <int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int nrows_valid, int rows) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    dst[r * LD + d] =
        (row0 + r < nrows_valid) ? src[(size_t)(row0 + r) * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Hq, int G, int Sq, int Sk, int causal, int window,
                     float scale, float softcap) {
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
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)(b * Hkv + hq / G) * Sk * D;
  const float* vb = v + (size_t)(b * Hkv + hq / G) * Sk * D;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(sQ, qb, q0, Sq, BQ);

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
    load_tile<D>(sK, kb, k0, Sk, BK);
    load_tile<D>(sV, vb, k0, Sk, BK);
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
    float* orow = o + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Sq, int Sk, int causal, int window,
                   float scale, float softcap, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hq / Hkv,
      Sq, Sk, causal, window, scale, softcap);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Sk, int D,
                       int causal, int window, float scale, float softcap,
                       cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                        scale, softcap, s);
    case 128:
      return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                         scale, softcap, s);
    case 256:
      return launch<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                         scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---- bf16 route: wgmma on TMA-fed tiles ----

namespace tc {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;       // q rows per block: two warpgroups of 64
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;     // kv tiles in the shared-memory ring
constexpr uint32_t ROW = 128;             // bytes of a swizzled box row
constexpr uint32_t Q_BLK = BQ * ROW;      // one 64-column block of Q
constexpr uint32_t KV_BLK = BK * ROW;     // one 64-column block of K or V
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int NB = D / 64;       // column blocks (TMA boxes) a row
  static constexpr uint32_t Q_BYTES = NB * Q_BLK;
  static constexpr uint32_t KV_BYTES = NB * KV_BLK;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // + the barriers, + slack to align the base to 1,024 bytes
  static constexpr size_t SMEM = BAR_OFF + STAGES * 8 + 1024;
};

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 64) wgmma_m64n64k16_rs(o, a, desc_v);
  else if constexpr (D == 128) wgmma_m64n128k16_rs(o, a, desc_v);
  else wgmma_m64n256k16_rs(o, a, desc_v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ o, int Hq, int G, int Sq, int Sk,
                          int causal, int window, float scale,
                          float softcap) {
  typedef Layout<D> L;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const uint32_t sq = smem_u32(smem);

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int bh = blockIdx.x;                  // b * Hq + hq
  const int b = bh / Hq, hq = bh % Hq;
  const int kv_plane = b * (Hq / G) + hq / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first

  // Live keys of the block: [k_lo, k_hi), in kv tiles j0 .. j0+n_tiles-1.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int j0 = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - j0 : 0;

  auto load_kv = [&](int stage, int j) {
#pragma unroll
    for (int c = 0; c < L::NB; ++c) {
      tma_load_3d(smem + L::K_OFF + stage * L::KV_BYTES + c * KV_BLK, &tm_k,
                  &full[stage], c * 64, j * BK, kv_plane);
      tma_load_3d(smem + L::V_OFF + stage * L::KV_BYTES + c * KV_BLK, &tm_v,
                  &full[stage], c * 64, j * BK, kv_plane);
    }
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && n_tiles > 0) {   // Q and the first kv tile on stage 0
    mbar_arrive_expect_tx(&full[0], L::Q_BYTES + 2 * L::KV_BYTES);
#pragma unroll
    for (int c = 0; c < L::NB; ++c)
      tma_load_3d(smem + c * Q_BLK, &tm_q, &full[0], c * 64, q0, bh);
    load_kv(0, j0);
  }

  // This warpgroup's rows [r0, r_end] (rows ≥ Sq are computed, not
  // stored); this thread's rows row_a and row_a + 8, and its first column
  // in each 8-column group of a fragment.
  const int r0 = q0 + wg * 64;
  const int r_end = min(r0 + 63, Sq - 1);
  const int row_a = r0 + warp * 16 + lane / 4;
  const int col_t = 2 * (lane % 4);
  const uint32_t q_desc_base = sq + wg * 64 * ROW;
  // s·mul, or cap_l2·tanh(s·sc), is the score in the log2 domain
  const bool capped = softcap > 0.f;
  const float sc = capped ? scale / softcap : 0.f;
  const float mul = capped ? softcap * LOG2E : scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = (j0 + it) * BK;
    if (it > 0) __syncthreads();   // tile it-1 is done: its stage is free
    if (tid == 0 && it + 1 < n_tiles) {
      mbar_arrive_expect_tx(&full[stage ^ 1], 2 * L::KV_BYTES);
      load_kv(stage ^ 1, j0 + it + 1);
    }
    mbar_wait(&full[stage], (it >> 1) & 1);
    // no live key for this warpgroup's rows (warpgroup-uniform)
    if (r0 > r_end || (causal && k0 > r_end) ||
        (window > 0 && k0 + BK - 1 <= r0 - window))
      continue;

    // s = q · kᵀ: D/16 k16 slices, 4 to each 64-column block
    const uint32_t k_base = sq + L::K_OFF + stage * L::KV_BYTES;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off_q = (kk / 4) * Q_BLK + (kk % 4) * 32;
      const uint32_t off_k = (kk / 4) * KV_BLK + (kk % 4) * 32;
      wgmma_ss<0, 0>(s, desc_sw128(q_desc_base + off_q, 16, 1024),
                     desc_sw128(k_base + off_k, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // scale, softcap, mask; register 4n + 2i + j is (row_a + 8i,
    // k0 + 8n + col_t + j)
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > r0) ||
                      (window > 0 && k0 <= r_end - window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[4 * n + 2 * i + j];
          x = capped ? mul * tanh_approx(x * sc) : x * mul;
          if (edge) {
            const int row = row_a + 8 * i, col = k0 + 8 * n + col_t + j;
            const bool live = col < Sk && (!causal || col <= row) &&
                              (window <= 0 || col > row - window);
            if (!live) x = -INFINITY;
          }
          s[4 * n + 2 * i + j] = x;
        }

    // online softmax: the 4 threads of a quad share a row
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      base[i] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet
      alpha[i] = ex2(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= alpha[i];   // l is this thread's share; summed at the end
    }
    uint32_t pa[4][4];    // p in bf16: the A fragments of 4 k16 slices
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r & 1;
        const float p0 = ex2(s[8 * kk + 2 * r] - base[i]);
        const float p1 = ex2(s[8 * kk + 2 * r + 1] - base[i]);
        l[i] += p0 + p1;
        pa[kk][r] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[4 * n + 2 * i] *= alpha[i];
        acc[4 * n + 2 * i + 1] *= alpha[i];
      }

    // o += p · v: v MN-major, 16 keys (2,048 bytes) a k16 slice, its
    // 64-column blocks KV_BLK apart
    const uint32_t v_base = sq + L::V_OFF + stage * L::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(acc, pa[kk],
                  desc_sw128(v_base + kk * 16 * ROW, KV_BLK, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // Epilogue: o / l in bf16 into this warpgroup's rows of the Q buffer (Q
  // has arrived and been read: every thread waited on tile 0), in Q's
  // swizzled layout, then 16-byte stores of the live rows.
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] == 0.f ? 0.f : 1.f / l[i];
  }
  uint8_t* so = smem + wg * 64 * ROW;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + lane / 4 + 8 * i;
      *reinterpret_cast<uint32_t*>(so + (n / 8) * Q_BLK + r * ROW +
                                   ((n % 8) ^ (r % 8)) * 16 + col_t * 2) =
          pack_bf16(acc[4 * n + 2 * i] * inv[i],
                    acc[4 * n + 2 * i + 1] * inv[i]);
    }
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "r"(128) : "memory");
  constexpr int CHUNKS = D / 8;   // 16-byte pieces of an output row
  for (int idx = t; idx < 64 * CHUNKS; idx += 128) {
    const int r = idx / CHUNKS, cc = idx % CHUNKS;
    if (r0 + r >= Sq) break;
    const uint4 val = *reinterpret_cast<const uint4*>(
        so + (cc / 8) * Q_BLK + r * ROW + ((cc % 8) ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(o + ((size_t)bh * Sq + r0 + r) * D + cc * 8) =
        val;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                   int window, float scale, float softcap,
                   cudaStream_t stream) {
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;   // grid's y limit
  const uint64_t row = D * sizeof(bf16);
  CUtensorMap tm[3];
  const void* base[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const uint64_t S = i == 0 ? Sq : Sk, planes = (i == 0 ? Hq : Hkv) * B;
    const uint64_t dims[3] = {(uint64_t)D, S, planes};
    const uint64_t strides[2] = {row, S * row};
    const uint32_t box[3] = {64, (uint32_t)(i == 0 ? BQ : BK), 1};
    cudaError_t err = tensor_map_bf16(&tm[i], base[i], 3, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  auto kern = flash_fwd_bf16_kernel<D>;
  constexpr size_t bytes = Layout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hq, n_qt);
  kern<<<grid, THREADS, bytes, stream>>>(tm[0], tm[1], tm[2],
                                         static_cast<bf16*>(o), Hq, Hq / Hkv,
                                         Sq, Sk, causal, window, scale,
                                         softcap);
  return cudaGetLastError();
}

cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Sk, int D,
                       int causal, int window, float scale, float softcap,
                       cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                        scale, softcap, s);
    case 128:
      return launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                         scale, softcap, s);
    case 256:
      return launch<256>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window,
                         scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o (B, Hq, Sq, D), all contiguous;
// bfloat16 bases 16-byte aligned (TMA).
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Sk, int D,
                        int dtype, int causal, int window, float scale,
                        float softcap, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, window,
                      scale, softcap, s);
  if (dtype == 1)
    return tc::dispatch_d(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, window,
                          scale, softcap, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
