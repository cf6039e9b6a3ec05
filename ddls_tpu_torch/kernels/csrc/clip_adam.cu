// K19 clip_adam: one optimiser step over every parameter leaf of a learner:
// optax's chain(clip_by_global_norm(clip), adam(lr)) or chain(clip,
// rmsprop(lr, decay, eps, momentum)), then apply_updates, in one launch and
// with no host round trip.
//
// Replaces the optax update that XLA compiled for the TPU inside each
// learner's jitted step: ddls_tpu/rl/ppo.py:206-208,282 (and
// rl/impala.py:133-140, rl/pg.py:82-84, rl/dqn.py:240-242, rl/es.py:95,190).
//
// Per element, with norm the global norm of the gradients and the clip
// chosen on the device (g' = g if norm < clip else (g / norm) * clip), in
// optax's order of float32 operations:
//   adam:    mu = mu b1 + g' (1 - b1); nu = nu b2 + (g' g')(1 - b2);
//            p += ((mu / bc1) / (sqrt(nu / bc2) + eps)) * (-lr)
//   rmsprop: nu = nu d + (g' g')(1 - d); u = (g' rsqrt(nu + eps)) (-lr);
//            with momentum mu = mu m + u and p += mu, else p += u
// with bc1 = 1 - b1^count, bc2 = 1 - b2^count the float32 bias corrections
// the wrapper hands in (Learner._bias_correction).
//
// The global norm is a fixed-order float32 reduction (not bitwise the
// plain version's per-leaf norms then their norm; a norm within rounding of
// clip may take the other side of the comparison than the plain version's,
// and the two results then differ by that rounding). Its order is the one
// the earlier three-launch design fixed, kept bit for bit: the leaves'
// elements cut into jobs (leaf, chunk) of kChunk elements, flat index j =
// leaf * chunks + chunk (an empty job's partial is 0); a job's partial is a
// 256-thread block's sum: thread t takes elements t, t + 256, ... of the
// chunk (one fmaf each, in order), then the tree over strides 128, 64, ...,
// 1; the norm is sqrt of a 256-thread block's sum of the partials: thread t
// takes partials t, t + 256, ... in order, then the same tree. One warp
// computes either sum here: lane l holds threads l + 32 m (m = 0..7),
// adds the tree's first three levels among them and shuffles the last
// five (tree256), which pairs the very operands the block's tree pairs.
//
// What bounds it on the H100: latency (the shipped policy's 5,838 floats
// are ~117 KB of reads and writes: 35 ns at 3.35 TB/s). The earlier design
// took three launches (a grid of (chunks, leaves) blocks, most of them empty
// at the shipped sizes, a one-block reduce, the update grid), each a launch
// and a chain of global round trips. This design is one launch of one
// thread-block cluster of `ctas` CTAs (the wrapper's plan: a CTA for every
// 768 elements, up to 16):
//  * the wrapper passes the leaves by value (gradient, parameter and moment
//    pointers, sizes) with its plan: the flat jobs cut into contiguous runs,
//    one a CTA, balanced by elements;
//  * a CTA's warps take its jobs in turn, reading g, p, mu and nu from
//    global memory where they use them (staging them in shared memory with
//    cp.async first measured no faster at the plan's CTA counts);
//  * each warp writes its jobs' partials into every CTA's copy of all the
//    partials (distributed shared memory); one cluster barrier, the only
//    one; every warp then computes the norm from its CTA's own copy, the
//    same bits in every warp, and the update spreads the CTA's elements
//    over all its threads (a warp a job left most threads idle behind a
//    few long chains of dependent divisions). Nothing reads another CTA's
//    shared memory after the barrier, so the CTAs leave as they finish.
// No float atomics, so every run gives the same bits.
#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / ddls::kWarpSize;
constexpr int kChunk = 1024;  // elements of one job (a leaf's chunk)
constexpr int kMaxLeaves = 96;

struct Leaves {
  const float* g[kMaxLeaves];
  float* p[kMaxLeaves];
  float* mu[kMaxLeaves];  // null without (rmsprop)
  float* nu[kMaxLeaves];
  int size[kMaxLeaves];
  int bounds[ddls::kMaxCluster + 1];  // CTA r's jobs: [bounds[r], bounds[r+1])
  int n_leaves, chunks;
};

struct Hyper {
  float clip;       // used when has_clip
  float lr;
  float b1;         // adam: b1; rmsprop: momentum
  float omb1;       // 1 - b1 (adam)
  float b2;         // adam: b2; rmsprop: decay
  float omb2;       // 1 - b2
  float eps;
  float bc1;        // adam's bias corrections
  float bc2;
  int mode;         // 0 adam, 1 rmsprop, 2 rmsprop with momentum
  int has_clip;
};

// the elements of chunk c of a leaf of `size` elements
__host__ __device__ __forceinline__ int job_size(int size, int c) {
  const int left = size - c * kChunk;
  return left < 0 ? 0 : (left < kChunk ? left : kChunk);
}

// A 256-thread block's tree sum (strides 128, 64, ..., 1, each thread t
// adding t + stride) of the values s_t, from one warp: v[m] holds
// s_{lane + 32 m}. The result is in lane 0.
__device__ __forceinline__ float tree256(const float (&v)[8]) {
  const float r0 = __fadd_rn(v[0], v[4]), r1 = __fadd_rn(v[1], v[5]);
  const float r2 = __fadd_rn(v[2], v[6]), r3 = __fadd_rn(v[3], v[7]);
  float s = __fadd_rn(__fadd_rn(r0, r2), __fadd_rn(r1, r3));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s = __fadd_rn(s, __shfl_down_sync(ddls::kFullMask, s, d));
  }
  return s;
}

// One job's partial (the old norm block's sum of its chunk's squares),
// every lane of the warp getting it.
__device__ __forceinline__ float job_partial(const float* g, int n,
                                             int lane) {
  float v[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int t = lane + 32 * m;
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunk / 256; ++k) {
      const int i = t + 256 * k;
      if (i < n) s = fmaf(g[i], g[i], s);
    }
    v[m] = s;
  }
  return __shfl_sync(ddls::kFullMask, tree256(v), 0);
}

// The element update (optax's order of float32 operations).
__device__ __forceinline__ void update_one(const Hyper& hp, float scale_norm,
                                           bool clip, float g, float& p,
                                           float& mu, float& nu) {
  if (clip) g = __fmul_rn(__fdiv_rn(g, scale_norm), hp.clip);
  const float g2 = __fmul_rn(g, g);
  if (hp.mode == 0) {
    const float m = __fadd_rn(__fmul_rn(mu, hp.b1), __fmul_rn(g, hp.omb1));
    const float v = __fadd_rn(__fmul_rn(nu, hp.b2), __fmul_rn(g2, hp.omb2));
    mu = m;
    nu = v;
    const float m_hat = __fdiv_rn(m, hp.bc1);
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, hp.bc2)), hp.eps);
    p = __fadd_rn(p, __fmul_rn(__fdiv_rn(m_hat, denom), -hp.lr));
  } else {
    const float v = __fadd_rn(__fmul_rn(nu, hp.b2), __fmul_rn(g2, hp.omb2));
    nu = v;
    const float u =
        __fmul_rn(__fmul_rn(rsqrtf(__fadd_rn(v, hp.eps)), g), -hp.lr);
    if (hp.mode == 2) {
      const float m = __fadd_rn(__fmul_rn(mu, hp.b1), u);
      mu = m;
      p = __fadd_rn(p, m);
    } else {
      p = __fadd_rn(p, u);
    }
  }
}

// The dynamic shared memory of a CTA of `jobs` jobs, of `n_flat` over the
// cluster (bytes): every job's partial (n_flat floats, at the same place in
// every CTA: the other CTAs write theirs there) and each of its jobs'
// offset in the update's order (jobs + 1 ints).
__host__ __device__ inline size_t smem_bytes(int jobs, int n_flat) {
  return 4 * (static_cast<size_t>(jobs) + 1 + n_flat);
}

__global__ void __launch_bounds__(kThreads)
clip_adam_kernel(Leaves lv, Hyper hp) {
  extern __shared__ __align__(16) unsigned char smem[];
  ddls::cg::cluster_group cluster = ddls::cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / ddls::kWarpSize;
  const int lane = tid % ddls::kWarpSize;
  const int j0 = lv.bounds[rank];
  const int n_jobs = lv.bounds[rank + 1] - j0;
  const int n_flat = lv.n_leaves * lv.chunks;
  const bool has_mu = hp.mode != 1;
  float* s_all = reinterpret_cast<float*>(smem);      // [n_flat]
  int* s_off = reinterpret_cast<int*>(s_all + n_flat);  // [n_jobs + 1]

  // each job's place in the concatenation of the CTA's jobs that the
  // update spreads over its threads: every warp scans the jobs itself (no
  // barrier) and writes the offsets of the jobs it takes (k = warp, warp +
  // kWarps, ...)
  int total = 0;
  for (int k0 = 0; k0 < n_jobs; k0 += ddls::kWarpSize) {
    const int k = k0 + lane;
    const int j = j0 + k;
    const int leaf = j / lv.chunks;
    const int n = k < n_jobs ? job_size(lv.size[leaf], j - leaf * lv.chunks)
                             : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < ddls::kWarpSize; d <<= 1) {
      const int up = __shfl_up_sync(ddls::kFullMask, incl, d);
      if (lane >= d) incl += up;
    }
    if (k < n_jobs && k % kWarps == warp) s_off[k] = total + incl - n;
    total += __shfl_sync(ddls::kFullMask, incl, ddls::kWarpSize - 1);
  }
  if (tid == 0) s_off[n_jobs] = total;

  float norm = 0.0f;
  bool clip = false;
  if (hp.has_clip) {
    // each job's partial, written into every CTA's copy of the partials
    // (lane q to CTA q, over distributed shared memory)
    for (int k = warp; k < n_jobs; k += kWarps) {
      const int j = j0 + k;
      const int leaf = j / lv.chunks;
      const int c = j - leaf * lv.chunks;
      const int n = job_size(lv.size[leaf], c);
      const float part = n > 0 ? job_partial(
          lv.g[leaf] + static_cast<size_t>(c) * kChunk, n, lane) : 0.0f;
      if (lane < ctas) *cluster.map_shared_rank(s_all + j, lane) = part;
    }
    if (ctas == 1) {
      __syncthreads();
    } else {
      cluster.sync();  // every partial in every CTA; no remote access after
    }
    // the norm, in every warp from the CTA's own copy: thread t of the old
    // reduce block takes the partials t, t + 256, ... (flat order), then
    // the tree
    float v[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      float s = 0.0f;
      for (int i = lane + 32 * m; i < n_flat; i += 256) {
        s = __fadd_rn(s, s_all[i]);
      }
      v[m] = s;
    }
    norm = sqrtf(__shfl_sync(ddls::kFullMask, tree256(v), 0));
    clip = !(norm < hp.clip);
  } else {
    __syncthreads();  // every warp's offsets, for the update's threads
  }

  // the update over all the CTA's threads: thread t takes positions t, t +
  // kThreads, ... of its jobs' concatenation (job k at [s_off[k],
  // s_off[k + 1])), each element's chain of dependent operations beside
  // the other threads'
  for (int f = tid, k = 0; f < total; f += kThreads) {
    while (f >= s_off[k + 1]) ++k;
    const int j = j0 + k;
    const int leaf = j / lv.chunks;
    const int c = j - leaf * lv.chunks;
    const size_t at = static_cast<size_t>(c) * kChunk + (f - s_off[k]);
    float p = lv.p[leaf][at];
    float mu = has_mu ? lv.mu[leaf][at] : 0.0f;
    float nu = lv.nu[leaf][at];
    update_one(hp, norm, clip, lv.g[leaf][at], p, mu, nu);
    lv.p[leaf][at] = p;
    if (has_mu) lv.mu[leaf][at] = mu;
    lv.nu[leaf][at] = nu;
  }
}

}  // namespace

// The leaves, read from host memory: `grads` int64 [L] gradient pointers;
// `leaves` int64 [4 L + ctas + 1]: parameter pointers, mu pointers (0 for
// none: rmsprop), nu pointers, sizes, then the plan's job bounds (CTA r
// takes flat jobs [bounds[r], bounds[r + 1]), bounds[ctas] = L * chunks);
// then the jobs a leaf (chunks), the cluster size, whether to clip (clip is
// the threshold), the rule (0 adam, 1 rmsprop, 2 rmsprop with momentum)
// and its float32 constants.
DDLS_EXPORT int ddls_clip_adam(const void* grads, const void* leaves,
                               int n_leaves, int chunks, int ctas,
                               int has_clip, int mode,
                               float clip, float lr, float b1, float omb1,
                               float b2, float omb2, float eps, float bc1,
                               float bc2, void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || chunks <= 0 || ctas <= 0 ||
      ctas > ddls::kMaxCluster || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* g = static_cast<const long long*>(grads);
  const long long* t = static_cast<const long long*>(leaves);
  Leaves lv{};
  lv.n_leaves = n_leaves;
  lv.chunks = chunks;
  for (int i = 0; i < n_leaves; ++i) {
    lv.g[i] = reinterpret_cast<const float*>(g[i]);
    lv.p[i] = reinterpret_cast<float*>(t[i]);
    lv.mu[i] = reinterpret_cast<float*>(t[n_leaves + i]);
    lv.nu[i] = reinterpret_cast<float*>(t[2 * n_leaves + i]);
    lv.size[i] = static_cast<int>(t[3 * n_leaves + i]);
    if (lv.g[i] == nullptr || lv.p[i] == nullptr || lv.nu[i] == nullptr ||
        (mode != 1 && lv.mu[i] == nullptr) || lv.size[i] < 0 ||
        lv.size[i] > chunks * kChunk) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // the shared memory of the CTA of the most jobs: its jobs' offsets and
  // every job's partial
  size_t smem = 0;
  for (int r = 0; r <= ctas; ++r) {
    lv.bounds[r] = static_cast<int>(t[4 * n_leaves + r]);
    if (r > 0) {
      if (lv.bounds[r] < lv.bounds[r - 1]) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const size_t bytes =
          smem_bytes(lv.bounds[r] - lv.bounds[r - 1], n_leaves * chunks);
      smem = bytes > smem ? bytes : smem;
    }
  }
  if (lv.bounds[0] != 0 || lv.bounds[ctas] != n_leaves * chunks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Hyper hp{clip, lr, b1, omb1, b2, omb2, eps, bc1, bc2, mode,
                 has_clip};
  cudaError_t err = ddls::prepare_cluster(clip_adam_kernel, ctas, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  ddls::cluster_config(&config, &attr, 1, ctas, kThreads, smem,
                       static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&config, clip_adam_kernel, lv, hp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
