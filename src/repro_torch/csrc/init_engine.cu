// The Init pseudo-protocol's three generators for Hopper (sm_90a):
// constant, incrementing and pseudorandom fills of a 2-D output.
//
// Replaces: src/repro/kernels/init_engine/init_engine.py — memset_pallas
//   (_memset_kernel, the pl.pallas_call in _launch at :73),
//   iota_fill_pallas (_iota_kernel, :95) and prng_fill_pallas
//   (_prng_kernel, :108).
//
// What each computes, for element e = row·cols + col of a row-major
// (rows, cols) output:
//   memset  the value, already cast to the output dtype on the host and
//           passed as a 32-bit word holding its 1-, 2- or 4-byte pattern
//           repeated: the card never converts it;
//   iota    v = uint32(e) + uint32(start), wrapping mod 2^32, then the
//           int32 reading of v converted to the output dtype (the
//           reference's int32 arithmetic, without C++'s signed overflow);
//   prng    bits = splitmix32(uint32(e) + seed), the counter truncated
//           to 32 bits as the reference's uint32 arithmetic does; uint32
//           raw, float32 (bits >> 8)·2^-24, bfloat16 that float32
//           rounded to nearest even, int8 the low byte.
// splitmix32's constants are repro/core/backend.py:35-42's.
//
// What bounds it on an H100: nothing is read, so each fill is bound by
// the bytes it writes (3.35 TB/s).  The arithmetic, a few integer
// operations a word, stays far below the card's rate.
//
// Design.  The TPU kernels write one legalized VMEM tile per grid step.
// Here a grid-stride loop over 16-byte vectors (4 to 16 elements) with
// 64-bit element indices writes the output front to back, so each warp
// stores 512 contiguous bytes; the last n mod V elements are written one
// by one.  The output is a fresh contiguous tensor; a base that is not
// 16-byte aligned takes the element loop alone.  Every generator produces
// the raw bits of its output dtype, so one kernel template serves all.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  uint32_t z = x;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

// Output kinds: how a 32-bit value becomes the raw bits of one element.
enum Kind : int {
  RAW8 = 0,    // low byte (int8, uint8)
  RAW16 = 1,   // low half-word (int16, uint16)
  RAW32 = 2,   // the word (int32, uint32)
  BOOL = 3,    // value != 0
  F32 = 4,     // int32 value → float32, round to nearest even
  BF16 = 5,    // int32 value → float32 → bfloat16, each to nearest even
  F16 = 6,     // int32 value → float32 → float16, each to nearest even
};

template <typename U>
__device__ __forceinline__ U int_bits(uint32_t v, int kind) {
  switch (kind) {
    case BOOL:
      return static_cast<U>(v != 0u);
    case F32:
      return static_cast<U>(__float_as_uint(__int2float_rn((int)v)));
    case BF16:
      return static_cast<U>(__bfloat16_as_ushort(
          __float2bfloat16_rn(__int2float_rn((int)v))));
    case F16:
      return static_cast<U>(__half_as_ushort(
          __float2half_rn(__int2float_rn((int)v))));
    default:
      return static_cast<U>(v);  // RAW*: the low bits
  }
}

// PRNG kinds: 0 uint32, 1 float32, 2 bfloat16, 3 int8.
template <typename U>
__device__ __forceinline__ U prng_bits(uint32_t bits, int kind) {
  if (kind == 0) return static_cast<U>(bits);
  if (kind == 3) return static_cast<U>(bits & 0xFFu);
  const float u = (float)(bits >> 8) * 0x1p-24f;
  if (kind == 1) return static_cast<U>(__float_as_uint(u));
  return static_cast<U>(__bfloat16_as_ushort(__float2bfloat16_rn(u)));
}

struct MemsetGen {
  uint32_t pattern;
  template <typename U>
  __device__ __forceinline__ U at(int64_t) const {
    return static_cast<U>(pattern);
  }
};

struct IotaGen {
  uint32_t start;
  int kind;
  template <typename U>
  __device__ __forceinline__ U at(int64_t e) const {
    return int_bits<U>((uint32_t)e + start, kind);
  }
};

struct PrngGen {
  uint32_t seed;
  int kind;
  template <typename U>
  __device__ __forceinline__ U at(int64_t e) const {
    return prng_bits<U>(splitmix32((uint32_t)e + seed), kind);
  }
};

// U is the raw element type (1, 2 or 4 bytes); n elements.
template <typename U, typename Gen>
__global__ void __launch_bounds__(THREADS)
fill_kernel(U* __restrict__ out, int64_t n, Gen gen, bool vector) {
  constexpr int V = 16 / sizeof(U);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int64_t nvec = vector ? n / V : 0;
  constexpr int PER_WORD = 4 / sizeof(U);
  for (int64_t v = tid; v < nvec; v += stride) {
    uint32_t w[4];  // little-endian: element k in the low bits
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = 0;
#pragma unroll
      for (int j = 0; j < PER_WORD; ++j)
        w[i] |= (uint32_t)gen.template at<U>(v * V + i * PER_WORD + j)
                << (8 * sizeof(U) * j);
    }
    reinterpret_cast<uint4*>(out)[v] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int64_t e = nvec * V + tid; e < n; e += stride)
    out[e] = gen.template at<U>(e);
}

int grid_for(int64_t work) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t blocks = (work + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * 16;
  return (int)(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

template <typename Gen>
cudaError_t launch(void* out, int64_t n, int itemsize, Gen gen,
                   cudaStream_t stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const bool vector = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t work = vector ? n / (16 / itemsize) + 16 : n;
  const int grid = grid_for(work);
  switch (itemsize) {
    case 1:
      fill_kernel<uint8_t, Gen><<<grid, THREADS, 0, stream>>>(
          static_cast<uint8_t*>(out), n, gen, vector);
      break;
    case 2:
      fill_kernel<uint16_t, Gen><<<grid, THREADS, 0, stream>>>(
          static_cast<uint16_t*>(out), n, gen, vector);
      break;
    case 4:
      fill_kernel<uint32_t, Gen><<<grid, THREADS, 0, stream>>>(
          static_cast<uint32_t*>(out), n, gen, vector);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each fills the n elements of a contiguous output of `itemsize` bytes
// (1, 2 or 4) on `stream` and returns a cudaError_t.

// `pattern` holds the value's bytes, repeated to fill 32 bits.
int init_memset(void* out, int64_t n, int itemsize, uint32_t pattern,
                void* stream) {
  return launch(out, n, itemsize, MemsetGen{pattern},
                static_cast<cudaStream_t>(stream));
}

// `kind` is one of Kind and must fit `itemsize`.
int init_iota(void* out, int64_t n, int itemsize, uint32_t start, int kind,
              void* stream) {
  const int need[] = {1, 2, 4, 1, 4, 2, 2};
  if (kind < 0 || kind > F16 || need[kind] != itemsize)
    return cudaErrorInvalidValue;
  return launch(out, n, itemsize, IotaGen{start, kind},
                static_cast<cudaStream_t>(stream));
}

// `kind`: 0 uint32, 1 float32, 2 bfloat16, 3 int8.
int init_prng(void* out, int64_t n, int itemsize, uint32_t seed, int kind,
              void* stream) {
  const int need[] = {4, 4, 2, 1};
  if (kind < 0 || kind > 3 || need[kind] != itemsize)
    return cudaErrorInvalidValue;
  return launch(out, n, itemsize, PrngGen{seed, kind},
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"
