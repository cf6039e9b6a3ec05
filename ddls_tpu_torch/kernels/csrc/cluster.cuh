// Thread-block clusters for the kernels that spread one lane over several
// CTAs (K21 lookahead.cu, K24 pricing.cu): the launch through
// cudaLaunchKernelEx with a cluster dimension, the occupancy query the
// wrappers choose the cluster size with, reads of another CTA's shared
// memory that one lane of a warp makes for the whole warp, and integer
// max / min atomics that hold across the cluster.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace ddls {

namespace cg = cooperative_groups;

// a cluster of more than 8 CTAs needs the non-portable attribute; 16 is
// the H100's largest
constexpr int kMaxCluster = 16;

// `lanes` clusters of `G` CTAs of `threads` threads each, `smem` bytes of
// dynamic shared memory a CTA, on `stream`. `attr` must outlive `config`.
inline void cluster_config(cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr, int lanes, int G,
                           int threads, size_t smem, cudaStream_t stream) {
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(static_cast<unsigned>(lanes * G));
  config->blockDim = dim3(static_cast<unsigned>(threads));
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(G);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  config->attrs = attr;
  config->numAttrs = 1;
}

// What `kernel` must be told before it launches with `smem` bytes of
// dynamic shared memory in clusters of `G`.
template <typename K>
cudaError_t prepare_cluster(K kernel, int G, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && G > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// Lane 0 of the warp reads `*p` (another CTA's shared memory, through
// distributed shared memory) and shares it with the warp: one remote load
// a warp instead of 32. The whole warp must call it.
template <typename V>
__device__ __forceinline__ V warp_read(const V* p) {
  V v{};
  if ((threadIdx.x & 31) == 0) v = *p;
  return __shfl_sync(0xffffffffu, v, 0);
}

// atomicMax / atomicMin on an integer that may lie in another CTA's shared
// memory. 32-bit: the hardware atomic. 64-bit: a compare-and-swap loop,
// since the 64-bit max and min reach the shared window through an
// emulation that holds only within the CTA (measured on the H100: a
// cluster of 2 lost updates to the other CTA's word), while the 64-bit
// compare-and-swap is atomic across the cluster.
__device__ __forceinline__ void cluster_max(int* p, int v) {
  atomicMax(p, v);
}
__device__ __forceinline__ void cluster_min(int* p, int v) {
  atomicMin(p, v);
}
__device__ __forceinline__ void cluster_max(long long* p, long long v) {
  unsigned long long* u = reinterpret_cast<unsigned long long*>(p);
  unsigned long long seen = *u;
  while (static_cast<long long>(seen) < v) {
    const unsigned long long was =
        atomicCAS(u, seen, static_cast<unsigned long long>(v));
    if (was == seen) break;
    seen = was;
  }
}
__device__ __forceinline__ void cluster_min(long long* p, long long v) {
  unsigned long long* u = reinterpret_cast<unsigned long long*>(p);
  unsigned long long seen = *u;
  while (static_cast<long long>(seen) > v) {
    const unsigned long long was =
        atomicCAS(u, seen, static_cast<unsigned long long>(v));
    if (was == seen) break;
    seen = was;
  }
}

// The two halves of a cluster barrier: arrive (releasing this thread's
// writes) and wait (acquiring the others'); every thread of every CTA of
// the cluster arrives once before it waits. Work between the two overlaps
// the other CTAs' arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace ddls
