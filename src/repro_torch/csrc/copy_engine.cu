// The iDMA transport layer's copy kernels for Hopper (sm_90a): a dense copy
// on the TMA's bulk-copy engine, a 2-D copy with a fused element transform,
// and the N-D strided gather that materialises any view.
//
// Replaces: src/repro/kernels/copy_engine/copy_engine.py — copy_2d_pallas
//   (_copy_kernel, the pl.pallas_call at :176) and strided_copy_nd_pallas
//   (:208).
//
// What it computes.  Every entry point writes a fresh contiguous output,
// element o in row-major order, from the input element at
//   offset(o) = Σ_d index_d(o) · stride_d
// over the input's shape and element strides (stride 0 for an expanded
// dimension).  copy_bulk and copy_gather move the bytes unchanged;
// copy_convert loads a float32, bfloat16 or float16 element, multiplies it
// by `factor` in fp32 and rounds once, to nearest even, into the output's
// type (the in-stream `cast` and `scale` transforms); copy_zero writes
// zeros (the `zero` transform).
//
// What bounds it on an H100: each element is read once and written once
// with no arithmetic to speak of, so the bytes moved (3.35 TB/s).
//
// Design.  The TPU kernels walk legalized VMEM tiles from a TilePlan.
//
// copy_bulk takes an input that is one dense run with 16-byte-aligned
// source and destination (the host chooses it: copy_engine.route).  It is
// the paper's back-end on this card's own DMA engine, the TMA's non-tensor
// bulk copies.  The run is cut in 16 KB chunks, one a block, the grid as
// large as the chunks (73,728 blocks for gemma2-2b's 1.18 GB table).  One
// thread of the block is read and write manager: it loads its chunk into
// shared memory with one bulk load that completes on an mbarrier, stores
// it back with one bulk store, and leaves once the store has completed
// (wait_group 0).  The last block's threads copy the tail under 16 bytes.
// Nothing passes through registers.  A block reserves 72 KB of shared
// memory, so an SM holds 3 blocks: 48 KB in flight an SM, and the hardware
// hands blocks out in order, so the bytes in flight sweep the run front to
// back.  Timed in turns (PERF.md §6): more blocks an SM are slower
// (13 by 2%), and so is a persistent grid of one block an SM, each owning
// one span through a ring of stages (by 4-6%), and a register copy at the
// same 3 blocks an SM with 8 16-byte loads a thread in flight (by 0.3%;
// tools/dma_variants.cu).  What bounds it is the bytes moved; it runs at
// about 91% of the data sheet's 3.35 TB/s, level with the driver's
// device-to-device copy.
//
// The other routes.  The host merges dimensions that are contiguous with
// each other and drops unit ones, so a dense input is one dimension, then
// widens the unit moved to the largest of 16, 8, 4, 2 bytes that the
// innermost run, every other stride and the base address allow.  One
// thread per output unit, in a grid-stride loop, so a warp's stores are
// contiguous and its loads are as contiguous as the view's innermost
// stride.  The index split divides by each dimension's size: with
// precomputed magic numbers (multiply-high and shift) when the output
// has fewer than 2^31 units, by 64-bit division above that.  copy_convert
// takes eight elements a thread with 16-byte loads and stores when the
// input is one dense, 16-byte-aligned run, and the element loop
// otherwise.  Offsets are 64-bit throughout.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DIMS = 8;

// Dimensions innermost first.  div_* are the magic numbers of size[k]
// for n < 2^31: q = (umulhi(n, m) + n) >> s.
struct Geometry {
  int ndim;
  int64_t size[MAX_DIMS];
  int64_t stride[MAX_DIMS];
  uint32_t div_m[MAX_DIMS];
  uint32_t div_s[MAX_DIMS];
};

template <bool SMALL>
__device__ __forceinline__ int64_t offset_of(int64_t o, const Geometry& g) {
  int64_t off = 0;
  if (SMALL) {
    uint32_t r = (uint32_t)o;
#pragma unroll
    for (int k = 0; k < MAX_DIMS; ++k) {
      if (k == g.ndim - 1) {
        off += (int64_t)r * g.stride[k];
        break;
      }
      const uint32_t q = (__umulhi(r, g.div_m[k]) + r) >> g.div_s[k];
      off += (int64_t)(r - q * (uint32_t)g.size[k]) * g.stride[k];
      r = q;
    }
  } else {
    int64_t r = o;
#pragma unroll
    for (int k = 0; k < MAX_DIMS; ++k) {
      if (k == g.ndim - 1) {
        off += r * g.stride[k];
        break;
      }
      const int64_t q = r / g.size[k];
      off += (r - q * g.size[k]) * g.stride[k];
      r = q;
    }
  }
  return off;
}

template <typename U, bool SMALL>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const U* __restrict__ src, U* __restrict__ dst, int64_t n,
              Geometry g) {
  const int64_t step = (int64_t)gridDim.x * THREADS;
  for (int64_t o = (int64_t)blockIdx.x * THREADS + threadIdx.x; o < n;
       o += step)
    dst[o] = src[offset_of<SMALL>(o, g)];
}

__global__ void __launch_bounds__(THREADS)
zero_kernel(uint8_t* __restrict__ dst, int64_t nbytes, bool vector) {
  const int64_t step = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nvec = vector ? nbytes / 16 : 0;
  for (int64_t v = tid; v < nvec; v += step)
    reinterpret_cast<uint4*>(dst)[v] = make_uint4(0, 0, 0, 0);
  for (int64_t b = nvec * 16 + tid; b < nbytes; b += step) dst[b] = 0;
}

// Element codecs: raw bits ↔ fp32.
struct F32 {
  using Raw = uint32_t;
  static __device__ __forceinline__ float get(Raw r) {
    return __uint_as_float(r);
  }
  static __device__ __forceinline__ Raw put(float f) {
    return __float_as_uint(f);
  }
};
struct BF16 {
  using Raw = uint16_t;
  static __device__ __forceinline__ float get(Raw r) {
    return __bfloat162float(__ushort_as_bfloat16(r));
  }
  static __device__ __forceinline__ Raw put(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
struct F16 {
  using Raw = uint16_t;
  static __device__ __forceinline__ float get(Raw r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ Raw put(float f) {
    return __half_as_ushort(__float2half_rn(f));
  }
};

__device__ __forceinline__ uint32_t& word(uint4& q, int i) {
  return i == 0 ? q.x : (i == 1 ? q.y : (i == 2 ? q.z : q.w));
}

// V raw elements of type R packed in 16-byte vectors.
template <typename R, int V>
struct Pack {
  static constexpr int NQ = V * (int)sizeof(R) / 16;
  static constexpr int PER_WORD = 4 / (int)sizeof(R);
  uint4 q[NQ];
  __device__ __forceinline__ R get(int k) {
    const int w = k / PER_WORD;
    return (R)(word(q[w / 4], w % 4) >> (8 * sizeof(R) * (k % PER_WORD)));
  }
  __device__ __forceinline__ void put(int k, R r) {
    const int w = k / PER_WORD;
    uint32_t& dst = word(q[w / 4], w % 4);
    if (k % PER_WORD == 0) dst = 0;
    dst |= (uint32_t)r << (8 * sizeof(R) * (k % PER_WORD));
  }
};

// One dense, 16-byte-aligned input run: eight elements a thread.
template <typename In, typename Out>
__global__ void __launch_bounds__(THREADS)
convert_dense(const typename In::Raw* __restrict__ x,
              typename Out::Raw* __restrict__ y, int64_t n, float factor) {
  constexpr int V = 8;
  using PI = Pack<typename In::Raw, V>;
  using PO = Pack<typename Out::Raw, V>;
  const int64_t step = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nvec = n / V;
  for (int64_t v = tid; v < nvec; v += step) {
    PI a;
    PO b;
    const uint4* src = reinterpret_cast<const uint4*>(x + v * V);
#pragma unroll
    for (int i = 0; i < PI::NQ; ++i) a.q[i] = src[i];
#pragma unroll
    for (int k = 0; k < V; ++k) b.put(k, Out::put(In::get(a.get(k)) * factor));
    uint4* dst = reinterpret_cast<uint4*>(y + v * V);
#pragma unroll
    for (int i = 0; i < PO::NQ; ++i) dst[i] = b.q[i];
  }
  for (int64_t e = nvec * V + tid; e < n; e += step)
    y[e] = Out::put(In::get(x[e]) * factor);
}

template <typename In, typename Out, bool SMALL>
__global__ void __launch_bounds__(THREADS)
convert_strided(const typename In::Raw* __restrict__ x,
                typename Out::Raw* __restrict__ y, int64_t n, Geometry g,
                float factor) {
  const int64_t step = (int64_t)gridDim.x * THREADS;
  for (int64_t o = (int64_t)blockIdx.x * THREADS + threadIdx.x; o < n;
       o += step)
    y[o] = Out::put(In::get(x[offset_of<SMALL>(o, g)]) * factor);
}

int grid_for(int64_t work) {
  const int sms = hopper::sm_count() > 0 ? hopper::sm_count() : 132;
  const int64_t blocks = (work + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * 16;
  return (int)(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

// Reads outermost-first shape/strides into an innermost-first Geometry;
// returns the element count, or -1 for a shape it cannot take.
int64_t make_geometry(int ndim, const int64_t* shape, const int64_t* strides,
                      Geometry* g) {
  if (ndim < 1 || ndim > MAX_DIMS) return -1;
  int64_t n = 1;
  g->ndim = ndim;
  for (int k = 0; k < ndim; ++k) {
    const int64_t size = shape[ndim - 1 - k];
    if (size < 0 || strides[ndim - 1 - k] < 0) return -1;
    g->size[k] = size;
    g->stride[k] = strides[ndim - 1 - k];
    n *= size;
    uint32_t s = 0;
    while (s < 32 && (uint64_t(1) << s) < (uint64_t)size) ++s;
    g->div_s[k] = s;
    g->div_m[k] =
        size > 0 && size < (int64_t(1) << 31)
            ? (uint32_t)(((uint64_t(1) << 32) * ((uint64_t(1) << s) - size)) /
                             size +
                         1)
            : 0;
  }
  return n;
}

constexpr int64_t SMALL_LIMIT = int64_t(1) << 31;

template <typename U>
cudaError_t gather(const void* src, void* dst, int64_t n, const Geometry& g,
                   cudaStream_t stream) {
  const int grid = grid_for(n);
  if (n < SMALL_LIMIT)
    gather_kernel<U, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const U*>(src), static_cast<U*>(dst), n, g);
  else
    gather_kernel<U, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const U*>(src), static_cast<U*>(dst), n, g);
  return cudaGetLastError();
}

template <typename In, typename Out>
cudaError_t convert(const void* src, void* dst, int64_t n, const Geometry& g,
                    float factor, cudaStream_t stream) {
  using RI = typename In::Raw;
  using RO = typename Out::Raw;
  const bool dense = g.ndim == 1 && g.stride[0] == 1 &&
                     reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (dense) {
    convert_dense<In, Out><<<grid_for(n / 8 + 8), THREADS, 0, stream>>>(
        static_cast<const RI*>(src), static_cast<RO*>(dst), n, factor);
  } else if (n < SMALL_LIMIT) {
    convert_strided<In, Out, true><<<grid_for(n), THREADS, 0, stream>>>(
        static_cast<const RI*>(src), static_cast<RO*>(dst), n, g, factor);
  } else {
    convert_strided<In, Out, false><<<grid_for(n), THREADS, 0, stream>>>(
        static_cast<const RI*>(src), static_cast<RO*>(dst), n, g, factor);
  }
  return cudaGetLastError();
}

template <typename In>
cudaError_t convert_to(int out_code, const void* src, void* dst, int64_t n,
                       const Geometry& g, float factor, cudaStream_t s) {
  switch (out_code) {
    case 0: return convert<In, F32>(src, dst, n, g, factor, s);
    case 1: return convert<In, BF16>(src, dst, n, g, factor, s);
    case 2: return convert<In, F16>(src, dst, n, g, factor, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The bulk route: one dense, 16-byte-aligned run on the TMA's bulk copies
// ---------------------------------------------------------------------------

namespace bulk {

using namespace hopper;

constexpr int CHUNK = 16384;     // a block's bytes: one bulk load, one store
constexpr int RESERVE = 73728;   // shared memory a block takes: 3 an SM
constexpr int THREADS = 32;
static_assert(CHUNK % 128 == 0 && CHUNK + 8 <= RESERVE,
              "whole 128-byte lines and the mbarrier within the reserve");

// `body` bytes (a multiple of 16) by bulk copies, block b taking the chunk
// at b·CHUNK, then the tail up to `nbytes` by the last block's threads.
__global__ void __launch_bounds__(THREADS)
copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            int64_t body, int64_t nbytes) {
  extern __shared__ __align__(128) uint8_t buf[];
  uint64_t* full = reinterpret_cast<uint64_t*>(buf + CHUNK);
  if (blockIdx.x == gridDim.x - 1)
    for (int64_t b = body + threadIdx.x; b < nbytes; b += THREADS)
      dst[b] = src[b];
  const int64_t off = (int64_t)blockIdx.x * CHUNK;
  if (threadIdx.x != 0 || off >= body) return;
  const uint32_t bytes = (uint32_t)(body - off < CHUNK ? body - off : CHUNK);
  mbar_init(full, 1);
  mbar_fence_init();
  mbar_arrive_expect_tx(full, bytes);
  bulk_load(buf, src + off, bytes, full);
  mbar_wait(full, 0);
  bulk_store(dst + off, buf, bytes);
  bulk_commit();
  bulk_wait<0>();   // the store is in global memory before the block leaves
}

cudaError_t launch_copy(const void* src, void* dst, int64_t nbytes,
                        cudaStream_t stream) {
  const int64_t body = nbytes & ~int64_t(15);
  const int64_t blocks = (body + CHUNK - 1) / CHUNK;
  if (blocks >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RESERVE);
  if (err != cudaSuccess) return err;
  copy_kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), THREADS, RESERVE,
                stream>>>(static_cast<const uint8_t*>(src),
                          static_cast<uint8_t*>(dst), body, nbytes);
  return cudaGetLastError();
}

}  // namespace bulk

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each writes a contiguous output on `stream` and returns a cudaError_t.
// shape and strides are outermost first, at most 8 dimensions, strides
// non-negative.

// Copies `nbytes` bytes from src to dst, both 16-byte aligned and not
// overlapping, on the bulk route.
int copy_bulk(const void* src, void* dst, int64_t nbytes, void* stream) {
  if (nbytes < 0) return cudaErrorInvalidValue;
  if (nbytes == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return cudaErrorMisalignedAddress;
  return bulk::launch_copy(src, dst, nbytes,
                           static_cast<cudaStream_t>(stream));
}

// Moves units of `unit` bytes (1, 2, 4, 8 or 16); shape and strides count
// units; src and dst are aligned to the unit.
int copy_gather(const void* src, void* dst, int ndim, const int64_t* shape,
                const int64_t* strides, int unit, void* stream) {
  Geometry g;
  const int64_t n = make_geometry(ndim, shape, strides, &g);
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(src) % unit ||
      reinterpret_cast<uintptr_t>(dst) % unit)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 1: return gather<uint8_t>(src, dst, n, g, s);
    case 2: return gather<uint16_t>(src, dst, n, g, s);
    case 4: return gather<uint32_t>(src, dst, n, g, s);
    case 8: return gather<uint2>(src, dst, n, g, s);
    case 16: return gather<uint4>(src, dst, n, g, s);
    default: return cudaErrorInvalidValue;
  }
}

// Writes `nbytes` zero bytes.
int copy_zero(void* dst, int64_t nbytes, void* stream) {
  if (nbytes < 0) return cudaErrorInvalidValue;
  if (nbytes == 0) return cudaSuccess;
  const bool vector = reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  zero_kernel<<<grid_for(vector ? nbytes / 16 + 16 : nbytes), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(dst), nbytes, vector);
  return cudaGetLastError();
}

// Element types: 0 float32, 1 bfloat16, 2 float16; shape and strides
// count elements.
int copy_convert(const void* src, void* dst, int ndim, const int64_t* shape,
                 const int64_t* strides, int in_code, int out_code,
                 float factor, void* stream) {
  Geometry g;
  const int64_t n = make_geometry(ndim, shape, strides, &g);
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return convert_to<F32>(out_code, src, dst, n, g, factor, s);
    case 1: return convert_to<BF16>(out_code, src, dst, n, g, factor, s);
    case 2: return convert_to<F16>(out_code, src, dst, n, g, factor, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
