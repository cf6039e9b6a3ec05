// Shared helpers of the port's hand-written kernels (sm_90a, plain C entry
// points bound with ctypes from ddls_tpu_torch/kernels/__init__.py).
//
// Conventions every kernel follows:
//  * it launches on the stream it is handed (PyTorch's current stream) and
//    never synchronises;
//  * it allocates nothing: the Python wrapper allocates every output;
//  * the C entry returns cudaGetLastError() right after the launch, so a
//    refused launch (too many threads, too much shared memory) reaches the
//    wrapper, which raises.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#define DDLS_EXPORT extern "C" __attribute__((visibility("default")))

namespace ddls {

constexpr int kWarpSize = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// Butterfly sum: every lane ends with the sum over the warp.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = kWarpSize / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

// cp.async (sm_80 and later): a copy from global to shared memory that
// runs while the thread goes on, 4 bytes (through L1) or 16 (around it).
// Copies issued since the last commit form a group; wait_group<N> waits
// until at most N of this thread's groups are still in flight. A barrier
// after the wait makes every thread's copies visible to the block.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline int grid_for(int items, int per_block) {
  return (items + per_block - 1) / per_block;
}

}  // namespace ddls
