// K19 clip_adam: one optimiser step over every parameter leaf of a learner:
// optax's chain(clip_by_global_norm(clip), adam(lr)) or chain(clip,
// rmsprop(lr, decay, eps, momentum)), then apply_updates, in at most three
// launches and with no host round trip.
//
// Replaces the optax update that XLA compiled for the TPU inside each
// learner's jitted step: ddls_tpu/rl/ppo.py:206-208,282 (and
// rl/impala.py:133-140, rl/pg.py:82-84, rl/dqn.py:240-242, rl/es.py:95,190).
//
// The leaves stay where the modules keep them. A device table holds, per
// leaf, the parameter, mu and nu pointers and the leaf's size (built once
// per train state by the wrapper, rebuilt when a leaf's storage moves); the
// gradients are fresh tensors every step, so their pointers travel by value
// in a kernel argument.
//
//   ddls_clip_adam_norm    per-block sums of g^2 (block (leaf, chunk), a
//                          fixed tree inside the block) -> partial [G]
//   ddls_clip_adam_reduce  one block sums the partials in a fixed order ->
//                          norm = sqrt(sum)
//   ddls_clip_adam_update  per element: g' = g if norm < clip else
//                          (g / norm) * clip (clip chosen on the device),
//                          then, in optax's order of float32 operations,
//     adam:    mu = mu b1 + g' (1 - b1); nu = nu b2 + (g' g')(1 - b2);
//              p += ((mu / bc1) / (sqrt(nu / bc2) + eps)) * (-lr)
//     rmsprop: nu = nu d + (g' g')(1 - d); u = (g' rsqrt(nu + eps)) (-lr);
//              with momentum mu = mu m + u and p += mu, else p += u
//   with bc1 = 1 - b1^count, bc2 = 1 - b2^count the float32 bias corrections
//   the wrapper hands in (Learner._bias_correction).
//
// The global norm is a fixed-order float32 reduction (not bitwise the
// plain version's per-leaf norms then their norm); a norm within rounding
// of clip may take the other side of the comparison than the plain
// version's, and the two results then differ by that rounding.
//
// What bounds it on the H100: latency (the shipped policy's 5,838 floats are
// ~117 KB of reads and writes: 35 ns at 3.35 TB/s).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // elements of one leaf per block
constexpr int kMaxLeaves = 96;

struct Grads {
  const float* g[kMaxLeaves];
};

// device table, int64 entries: [0, L) params, [L, 2L) mu (0 when absent),
// [2L, 3L) nu, [3L, 4L) sizes
__device__ __forceinline__ long long entry(const long long* table, int i) {
  return table[i];
}

__global__ void __launch_bounds__(kThreads)
clip_adam_norm_kernel(Grads grads, const long long* __restrict__ table,
                      float* __restrict__ partial, int n_leaves) {
  __shared__ float red[kThreads];
  const int leaf = blockIdx.y;
  const long long size = entry(table, 3 * n_leaves + leaf);
  const long long begin = static_cast<long long>(blockIdx.x) * kChunk;
  const float* g = grads.g[leaf];
  float s = 0.0f;
  for (long long i = begin + threadIdx.x; i < begin + kChunk && i < size;
       i += kThreads) {
    const float v = g[i];
    s = fmaf(v, v, s);
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[static_cast<size_t>(leaf) * gridDim.x + blockIdx.x] = red[0];
  }
}

__global__ void __launch_bounds__(kThreads)
clip_adam_reduce_kernel(const float* __restrict__ partial,
                        float* __restrict__ norm, int n) {
  __shared__ float red[kThreads];
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) s = __fadd_rn(s, partial[i]);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) norm[0] = sqrtf(red[0]);
}

struct Hyper {
  float clip;       // used when norm != nullptr
  float lr;
  float b1;         // adam: b1; rmsprop: momentum
  float omb1;       // 1 - b1 (adam)
  float b2;         // adam: b2; rmsprop: decay
  float omb2;       // 1 - b2
  float eps;
  float bc1;        // adam's bias corrections
  float bc2;
  int mode;         // 0 adam, 1 rmsprop, 2 rmsprop with momentum
};

__global__ void __launch_bounds__(kThreads)
clip_adam_update_kernel(Grads grads, const long long* __restrict__ table,
                        const float* __restrict__ norm, Hyper hp,
                        int n_leaves) {
  const int leaf = blockIdx.y;
  const long long size = entry(table, 3 * n_leaves + leaf);
  const long long i = static_cast<long long>(blockIdx.x) * kChunk +
                      threadIdx.x;
  float* p = reinterpret_cast<float*>(entry(table, leaf));
  float* mu = reinterpret_cast<float*>(entry(table, n_leaves + leaf));
  float* nu = reinterpret_cast<float*>(entry(table, 2 * n_leaves + leaf));
  const float* g_leaf = grads.g[leaf];
  float n_g = 0.0f;
  bool clip = false;
  if (norm != nullptr) {
    n_g = norm[0];
    clip = !(n_g < hp.clip);
  }
  for (long long j = i; j < size && j < (blockIdx.x + 1LL) * kChunk;
       j += kThreads) {
    float g = g_leaf[j];
    if (clip) g = __fmul_rn(__fdiv_rn(g, n_g), hp.clip);
    const float g2 = __fmul_rn(g, g);
    if (hp.mode == 0) {
      const float m = __fadd_rn(__fmul_rn(mu[j], hp.b1),
                                __fmul_rn(g, hp.omb1));
      const float v = __fadd_rn(__fmul_rn(nu[j], hp.b2),
                                __fmul_rn(g2, hp.omb2));
      mu[j] = m;
      nu[j] = v;
      const float m_hat = __fdiv_rn(m, hp.bc1);
      const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.bc2)), hp.eps);
      p[j] = __fadd_rn(p[j], __fmul_rn(__fdiv_rn(m_hat, denom), -hp.lr));
    } else {
      const float v = __fadd_rn(__fmul_rn(nu[j], hp.b2),
                                __fmul_rn(g2, hp.omb2));
      nu[j] = v;
      const float u = __fmul_rn(__fmul_rn(rsqrtf(__fadd_rn(v, hp.eps)), g),
                                -hp.lr);
      if (hp.mode == 2) {
        const float m = __fadd_rn(__fmul_rn(mu[j], hp.b1), u);
        mu[j] = m;
        p[j] = __fadd_rn(p[j], m);
      } else {
        p[j] = __fadd_rn(p[j], u);
      }
    }
  }
}

bool read_grads(const long long* host, int n_leaves, Grads* out) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves) return false;
  for (int i = 0; i < n_leaves; ++i) {
    out->g[i] = reinterpret_cast<const float*>(host[i]);
    if (out->g[i] == nullptr) return false;
  }
  return true;
}

}  // namespace

DDLS_EXPORT int ddls_clip_adam_norm(const void* grad_table, const void* table,
                                    void* partial, int n_leaves, int chunks,
                                    void* stream) {
  Grads grads;
  if (chunks <= 0 ||
      !read_grads(static_cast<const long long*>(grad_table), n_leaves,
                  &grads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  clip_adam_norm_kernel<<<dim3(chunks, n_leaves), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      grads, static_cast<const long long*>(table),
      static_cast<float*>(partial), n_leaves);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_clip_adam_reduce(const void* partial, void* norm, int n,
                                      void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  clip_adam_reduce_kernel<<<1, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(norm), n);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_clip_adam_update(const void* grad_table,
                                      const void* table, const void* norm,
                                      int n_leaves, int chunks, int mode,
                                      float clip, float lr, float b1,
                                      float omb1, float b2, float omb2,
                                      float eps, float bc1, float bc2,
                                      void* stream) {
  Grads grads;
  if (chunks <= 0 || mode < 0 || mode > 2 ||
      !read_grads(static_cast<const long long*>(grad_table), n_leaves,
                  &grads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Hyper hp{clip, lr, b1, omb1, b2, omb2, eps, bc1, bc2, mode};
  clip_adam_update_kernel<<<dim3(chunks, n_leaves), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      grads, static_cast<const long long*>(table),
      static_cast<const float*>(norm), hp, n_leaves);
  return static_cast<int>(cudaGetLastError());
}
