// Register-copy variants of the copy engine's bulk route and of the Init
// engine's memset, kept to time them against in turns on the card:
//
//   python3 tools/kernel_versus.py copy --alt-source tools/dma_variants.cu
//   python3 tools/kernel_versus.py memset --alt-source tools/dma_variants.cu
//
// They export the C entries copy_bulk (csrc/copy_engine.cu) and
// init_memset (csrc/init_engine.cu), with the same arguments and results,
// so the wrappers call them in their place.
//
// copy_bulk: each thread issues VAR_UNROLL 16-byte loads
// (ld.global.nc.L1::no_allocate) before it stores them with streaming
// stores (st.global.cs), so VAR_UNROLL x 16 bytes a thread are in flight.
// init_memset: each thread VAR_UNROLL 16-byte stores (st.global.v4), of a
// 1-, 2- or 4-byte pattern.  A block takes VAR_UNROLL x 256 vectors, the
// grid as large as the work.  Each block reserves VAR_RESERVE_BYTES of
// shared memory it never uses, which caps the blocks an SM holds (72 KB:
// 3, as the bulk copy does).  The tail under 16 bytes is written byte by
// byte.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef VAR_UNROLL
#define VAR_UNROLL 8
#endif
#ifndef VAR_RESERVE_BYTES
#define VAR_RESERVE_BYTES 0
#endif

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = VAR_UNROLL;
constexpr int64_t PER_BLOCK = (int64_t)THREADS * UNROLL;  // vectors a block

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            int64_t nvec, int64_t nbytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const int64_t base = (int64_t)blockIdx.x * PER_BLOCK;
  uint4 r[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int64_t v = base + k * THREADS + threadIdx.x;
    if (v < nvec) r[k] = load_stream(s + v);
  }
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int64_t v = base + k * THREADS + threadIdx.x;
    if (v < nvec) store_stream(d + v, r[k]);
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int64_t b = nvec * 16 + threadIdx.x; b < nbytes; b += THREADS)
      dst[b] = src[b];
}

__global__ void __launch_bounds__(THREADS)
memset_kernel(uint8_t* __restrict__ out, int64_t nvec, int64_t nbytes,
              uint32_t pattern) {
  const uint4 w = make_uint4(pattern, pattern, pattern, pattern);
  uint4* d = reinterpret_cast<uint4*>(out);
  const int64_t base = (int64_t)blockIdx.x * PER_BLOCK;
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int64_t v = base + k * THREADS + threadIdx.x;
    if (v < nvec) d[v] = w;
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int64_t b = nvec * 16 + threadIdx.x; b < nbytes; b += THREADS)
      out[b] = (uint8_t)(pattern >> (8 * (b % 4)));
}

// copy_kernel from src, or memset_kernel of `pattern` when src is null.
cudaError_t launch(const void* kernel, int64_t nbytes, cudaStream_t stream,
                   const void* src, void* dst, uint32_t pattern) {
  const int64_t nvec = nbytes / 16;
  const int64_t grid = (nvec + PER_BLOCK - 1) / PER_BLOCK;
  if (grid >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  if (VAR_RESERVE_BYTES > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        VAR_RESERVE_BYTES);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)(grid < 1 ? 1 : grid);
  if (src != nullptr)
    copy_kernel<<<blocks, THREADS, VAR_RESERVE_BYTES, stream>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nvec,
        nbytes);
  else
    memset_kernel<<<blocks, THREADS, VAR_RESERVE_BYTES, stream>>>(
        static_cast<uint8_t*>(dst), nvec, nbytes, pattern);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int copy_bulk(const void* src, void* dst, int64_t nbytes, void* stream) {
  if (nbytes < 0) return cudaErrorInvalidValue;
  if (nbytes == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return cudaErrorMisalignedAddress;
  return launch((const void*)copy_kernel, nbytes,
                static_cast<cudaStream_t>(stream), src, dst, 0);
}

int init_memset(void* out, int64_t n, int itemsize, uint32_t pattern,
                void* stream) {
  if (n < 0 || (itemsize != 1 && itemsize != 2 && itemsize != 4))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  if (reinterpret_cast<uintptr_t>(out) % 16) return cudaErrorMisalignedAddress;
  return launch((const void*)memset_kernel, n * itemsize,
                static_cast<cudaStream_t>(stream), nullptr, out, pattern);
}

}  // extern "C"
