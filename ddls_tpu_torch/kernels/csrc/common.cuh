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

inline int grid_for(int items, int per_block) {
  return (items + per_block - 1) / per_block;
}

}  // namespace ddls
