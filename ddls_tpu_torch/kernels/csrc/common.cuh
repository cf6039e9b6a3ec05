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

// Lets `kernel` launch with `smem` bytes of dynamic shared memory: above
// the default 48 KB it must be told so first, up to the device's opt-in
// maximum (a larger request returns cudaErrorInvalidValue, which the C
// entry returns and the wrapper raises on).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  constexpr size_t kDefaultSmem = 48 * 1024;
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The shared memory a CTA may take on this device (the opt-in maximum).
inline int smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return static_cast<int>(err);
}

// Butterfly sum: every lane ends with the sum over the warp.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = kWarpSize / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

// warp_sum of T independent values a lane (T a power of two, at most 32)
// with fewer shuffles: at each offset of the butterfly, while a lane holds
// more than one tree, the lanes with that offset's bit clear keep the lower
// half of the trees and those with it set the upper half, each sending its
// partner the half the partner keeps, so one shuffle serves two trees.
// Every addition pairs the very operands warp_sum pairs, so each tree's sum
// has warp_sum's bits. Returns the sum of this lane's tree: tree t's lanes
// are those whose bits 4, 3, ... (one a halving, log2 T of them) spell t
// from its top bit down (the lower bits of the lane are free).
template <int T>
__device__ __forceinline__ float packed_warp_sums(float (&v)[T]) {
  static_assert(T >= 1 && T <= kWarpSize && (T & (T - 1)) == 0,
                "T must be a power of two, at most the warp");
  const int lane = threadIdx.x % kWarpSize;
#pragma unroll
  for (int j = 0; j < 5; ++j) {  // offsets 16, 8, 4, 2, 1
    const int offset = (kWarpSize / 2) >> j;
    const bool upper = (lane & offset) != 0;
#pragma unroll
    for (int t = 0; t < T / 2; ++t) {
      if (t < (T >> j) / 2) {  // trees still two a lane: one shuffle each
        const int u = t + (T >> j) / 2;
        const float got =
            __shfl_xor_sync(kFullMask, upper ? v[t] : v[u], offset);
        v[t] = (upper ? v[u] : v[t]) + got;
      }
    }
    if ((T >> j) <= 1) v[0] += __shfl_xor_sync(kFullMask, v[0], offset);
  }
  return v[0];
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

// The least of the warp's values, every lane getting it, with ties
// resolved as a serial scan from lane 0 up with a strict < resolves them:
// after the step of distance d lane i holds the least of lanes
// [i, i + 2d), and it takes the upper half's only when that is strictly
// less, so the lowest lane of the least class wins (a -0 and +0 tie keeps
// the serial answer's sign). A NaN is kept on the lower side, where a
// serial scan from +inf would skip it.
template <typename V>
__device__ __forceinline__ V warp_first_min(V v) {
#pragma unroll
  for (int d = 1; d < kWarpSize; d <<= 1) {
    const V up = __shfl_down_sync(kFullMask, v, d);
    v = up < v ? up : v;
  }
  return __shfl_sync(kFullMask, v, 0);
}

// The flow deps of one row of the device env (K24's is_flow and chan):
// visit(c) for each dep j in [0, n) whose flag is set, c = max(chan[j],
// 0) (the reference clips a flow's channel at 0), the block's threads
// over the row. From where both rows are 16-byte aligned, 16 flags are
// one uint4 load and their channels four int4 loads, made only where a
// flag of the four is set; a scalar head before and tail after (the whole
// row scalar where the two rows never align together).
template <typename Visit>
__device__ __forceinline__ void for_each_flow(const bool* __restrict__ flow,
                                              const int* __restrict__ chan,
                                              int n, Visit visit) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(flow) &
                                     15)) & 15);
  if (head > n || (reinterpret_cast<uintptr_t>(chan + head) & 15) != 0) {
    head = n;
  }
  const int body = head + (n - head) / 16 * 16;
  for (int j = tid; j < head; j += nt) {
    if (flow[j]) visit(max(chan[j], 0));
  }
  for (int j = head + 16 * tid; j < body; j += 16 * nt) {
    const uint4 f = *reinterpret_cast<const uint4*>(flow + j);
    const unsigned w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (w[q] == 0) continue;
      const int4 c = *reinterpret_cast<const int4*>(chan + j + 4 * q);
      if (w[q] & 0xffu) visit(max(c.x, 0));
      if (w[q] & 0xff00u) visit(max(c.y, 0));
      if (w[q] & 0xff0000u) visit(max(c.z, 0));
      if (w[q] & 0xff000000u) visit(max(c.w, 0));
    }
  }
  for (int j = body + tid; j < n; j += nt) {
    if (flow[j]) visit(max(chan[j], 0));
  }
}

// The block sets `bytes` bytes at p to `byte` (0 for a float 0 or false,
// 0xff for an int -1): 16 bytes a store from the first 16-byte boundary,
// single bytes before it and after the last.
__device__ __forceinline__ void block_fill(void* p, size_t bytes,
                                           unsigned char byte) {
  unsigned char* c = static_cast<unsigned char*>(p);
  size_t head = (16 - (reinterpret_cast<uintptr_t>(c) & 15)) & 15;
  head = head < bytes ? head : bytes;
  const size_t body = head + (bytes - head) / 16 * 16;
  const unsigned w = byte * 0x01010101u;
  const uint4 v = make_uint4(w, w, w, w);
  const size_t tid = threadIdx.x, nt = blockDim.x;
  for (size_t i = tid; i < head; i += nt) c[i] = byte;
  for (size_t i = head + 16 * tid; i < body; i += 16 * nt) {
    *reinterpret_cast<uint4*>(c + i) = v;
  }
  for (size_t i = body + tid; i < bytes; i += nt) c[i] = byte;
}

inline int grid_for(int items, int per_block) {
  return (items + per_block - 1) / per_block;
}

}  // namespace ddls
