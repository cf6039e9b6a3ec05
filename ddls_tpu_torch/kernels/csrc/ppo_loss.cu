// K8 ppo_loss: the clipped-surrogate PPO loss of one minibatch, its six
// metrics, and its gradient with respect to the logits and the values, in
// one launch (forward and backward together).
//
// Replaces ddls_tpu/rl/ppo.py:124 ppo_loss with :94 categorical_entropy and
// the backward jax.value_and_grad derives from them (ppo.py:276-285), which
// XLA compiled for the TPU. Per row i, over A actions of masked logits x:
//
//   logp    = log_softmax(x); lp = logp[action]; p = exp(logp)
//   ratio   = exp(lp - old_logp)
//   surr    = min(ratio adv, clip(ratio, 1 - c, 1 + c) adv)
//   vf      = max((v - tgt)^2, (old_v + clip(v - old_v, -vc, vc) - tgt)^2)
//   ent     = -sum_j where(p_j > 0, p_j logp_j, 0)
//
// and over the M rows: policy_loss = -mean(surr), kl = mean(old_logp - lp),
// vf_loss = 0.5 mean(vf), entropy = mean(ent), clip_frac =
// mean(|ratio - 1| > c), total = policy_loss + kl_coeff kl + vf_coeff
// vf_loss - entropy_coeff entropy. The gradient is d total / d x and
// d total / d v, with JAX's rules at the kinks: jnp.minimum and
// jnp.maximum pass half the gradient to each side when the two are equal,
// and jnp.clip is max then min, so a ratio exactly at 1 +- c gets half.
// Masked logits (finfo.min + logit) give p = 0 exactly, so the where() in
// the entropy gives them no gradient; the softmax term does not either.
//
// What bounds it on the H100: latency. M A floats of logits in, the same
// out, a few hundred flops per row: far under a microsecond of bytes at
// 3.35 TB/s. Each row is a dependent chain (a max, a sum, then three
// independent sums over its actions), so the design puts as many rows in
// flight as it can and keeps the cross-row sums to one pass. The first
// design ran one CTA of 8 warps, each walking 16 of the main path's 128
// rows in turn with a lane an action (at A = 17 half the warp idle), then
// five block sums of ten barriers each. This design:
//
//   * a row takes a group of L lanes, L the least power of two with 4 L >=
//     A (each lane holds at most four actions; 8 lanes at A = 17), so
//     32 / L rows of a warp are in flight, their trees width-L shuffles;
//   * a CTA of up to 1,024 threads: the main path's 128 rows at A = 17
//     are one pass; a row's group loads its scalars once (its first lane)
//     and shares them;
//   * each row's five terms (surr, old_logp - lp, vf, ent, clipped) are
//     added by the group's first lane in row order, then one warp tree
//     over the five, one barrier, and one warp over the warps' sums;
//   * past two passes of rows a CTA (M > 2 x 1,024 / L), the rows are
//     split over a thread-block cluster of up to 8 CTAs (contiguous
//     chunks), and CTA 0 adds the CTAs' five sums in rank order over
//     distributed shared memory. A cluster needs no scratch in device
//     memory and no counters (K5's ticket reduce needs both), and its two
//     barriers are paid only where the rows would take many passes.
//
// The wrapper chooses L, the threads and the cluster size from M and A
// alone (rl/ppo.py ppo_loss_launch), and every sum runs in a fixed order,
// so the same inputs give the same bits on every run. kl_coeff is read
// from device memory, so the caller never waits on the card for it.
#include <cmath>

#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / ddls::kWarpSize;
constexpr int kMaxActions = 2 * ddls::kWarpSize;
constexpr int kMaxCtas = 8;  // a portable cluster
constexpr int kTerms = 5;    // surr, old_logp - lp, vf, ent, clipped
constexpr int kSlots = 4;    // actions a lane holds, at most
constexpr int kMaxLanes = kMaxActions / kSlots;  // lanes a row, at most

// max and sum over a row's group of L lanes (L a power of two <= 16);
// every lane of the warp must call them
template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int offset = L / 2; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(ddls::kFullMask, v, offset));
  }
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int offset = L / 2; offset > 0; offset >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(ddls::kFullMask, v, offset));
  }
  return v;
}

// the group's first lane's v, on every lane of the group
template <int L>
__device__ __forceinline__ float from_first(float v) {
  return __shfl_sync(ddls::kFullMask, v, 0, L);
}

// d min(x, y) / d x and d max(x, y) / d x, JAX's balanced rule
__device__ __forceinline__ float min_grad(float x, float y) {
  return x < y ? 1.0f : (x == y ? 0.5f : 0.0f);
}
__device__ __forceinline__ float max_grad(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
ppo_loss_kernel(const float* __restrict__ logits,      // [M, A]
                const float* __restrict__ values,      // [M]
                const int* __restrict__ actions,       // [M]
                const float* __restrict__ old_logp,    // [M]
                const float* __restrict__ old_values,  // [M]
                const float* __restrict__ advs,        // [M]
                const float* __restrict__ targets,     // [M]
                const float* __restrict__ kl_coeff,    // [1]
                float* __restrict__ metrics,           // [6]
                float* __restrict__ total,             // [1]
                float* __restrict__ dlogits,           // [M, A]
                float* __restrict__ dvalues,           // [M]
                int m, int a, float lo, float hi, float clip, float vf_clip,
                float vf_coeff, float ent_coeff) {
  constexpr int kRowsPerWarp = ddls::kWarpSize / L;
  __shared__ float warp_s[kMaxWarps][kTerms];
  __shared__ float cta_s[kTerms];
  const int tid = threadIdx.x;
  const int warp = tid / ddls::kWarpSize;
  const int lane = tid % ddls::kWarpSize;
  const int q = lane % L;  // the lane's place in its row's group
  const int n_warps = blockDim.x / ddls::kWarpSize;
  const int n_ctas = gridDim.x;  // one cluster
  const int chunk = (m + n_ctas - 1) / n_ctas;
  const int begin = blockIdx.x * chunk;
  const int end = min(m, begin + chunk);
  const float m_f = static_cast<float>(m);
  const float kc = kl_coeff[0];
  // d total / d (per-row term), as the reference's means pass it down
  const float g_surr = __fdiv_rn(-1.0f, m_f);
  const float g_kl = __fdiv_rn(-kc, m_f);            // d / d lp via kl
  const float g_vf = __fdiv_rn(__fmul_rn(vf_coeff, 0.5f), m_f);
  const float g_q = __fdiv_rn(ent_coeff, m_f);       // d / d (p logp)

  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;

  // r0 is the warp's first row of a pass: the loop is warp-uniform, and a
  // group past the chunk's end computes on zeros and writes nothing
  for (int r0 = begin + warp * kRowsPerWarp; r0 < end;
       r0 += n_warps * kRowsPerWarp) {
    const int r = r0 + lane / L;
    const bool live = r < end;
    const float* x_row = logits + static_cast<size_t>(live ? r : 0) * a;
    // the row's scalars, loaded by the group's first lane
    float s_adv = 0.0f, s_olp = 0.0f, s_v = 0.0f, s_tgt = 0.0f, s_ov = 0.0f;
    int s_act = 0;
    if (live && q == 0) {
      s_adv = advs[r];
      s_olp = old_logp[r];
      s_v = values[r];
      s_tgt = targets[r];
      s_ov = old_values[r];
      s_act = actions[r];
    }
    float x[kSlots], sh[kSlots], e[kSlots], lp[kSlots], p[kSlots],
        g_ent[kSlots];
    float mx_part = -INFINITY;
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      const int j = q + h * L;
      x[h] = j < a ? (live ? x_row[j] : 0.0f) : -INFINITY;
      mx_part = fmaxf(mx_part, x[h]);
    }
    const float mx = group_max<L>(mx_part);
    float e_part = 0.0f;
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      const int j = q + h * L;
      sh[h] = j < a ? __fsub_rn(x[h], mx) : 0.0f;
      e[h] = j < a ? expf(sh[h]) : 0.0f;
      e_part = __fadd_rn(e_part, e[h]);
    }
    const float s = group_sum<L>(e_part);
    const float lse = logf(s);
    const int act = __shfl_sync(ddls::kFullMask, s_act, 0, L);
    float q_part = 0.0f, lp_act = 0.0f, g_ent_part = 0.0f;
#pragma unroll
    for (int h = 0; h < kSlots; ++h) {
      const int j = q + h * L;
      lp[h] = __fsub_rn(sh[h], lse);
      p[h] = j < a ? expf(lp[h]) : 0.0f;
      g_ent[h] = 0.0f;
      if (j < a && p[h] > 0.0f) {
        q_part = __fadd_rn(q_part, __fmul_rn(p[h], lp[h]));
        // the entropy's gradient per action (needs no row scalar)
        g_ent[h] = __fadd_rn(__fmul_rn(g_q, p[h]),
                             __fmul_rn(__fmul_rn(g_q, lp[h]), p[h]));
      }
      g_ent_part = __fadd_rn(g_ent_part, g_ent[h]);
      if (j == act) lp_act = lp[h];
    }
    // three independent trees: their shuffles overlap
    const float ent = -group_sum<L>(q_part);
    const float lp_a = group_sum<L>(lp_act);  // one lane holds it
    const float g_ent_sum = group_sum<L>(g_ent_part);

    // the row's scalars: every lane of the group computes the same values
    const float adv = from_first<L>(s_adv);
    const float olp = from_first<L>(s_olp);
    const float ratio = expf(__fsub_rn(lp_a, olp));
    const float s1 = __fmul_rn(ratio, adv);
    const float inner = fmaxf(lo, ratio);
    const float rc = fminf(hi, inner);
    const float s2 = __fmul_rn(rc, adv);
    const float surr = fminf(s1, s2);
    const float v = from_first<L>(s_v);
    const float tgt = from_first<L>(s_tgt);
    const float ov = from_first<L>(s_ov);
    const float err1 = __fsub_rn(v, tgt);
    const float e1 = __fmul_rn(err1, err1);
    const float dv = __fsub_rn(v, ov);
    const float dv_in = fmaxf(-vf_clip, dv);
    const float dv_c = fminf(vf_clip, dv_in);
    const float err2 = __fsub_rn(__fadd_rn(ov, dv_c), tgt);
    const float e2 = __fmul_rn(err2, err2);
    const float vf = fmaxf(e1, e2);

    // gradients
    const float gs1 = __fmul_rn(g_surr, min_grad(s1, s2));
    const float gs2 = __fmul_rn(g_surr, min_grad(s2, s1));
    const float g_inner = __fmul_rn(__fmul_rn(gs2, adv), min_grad(inner, hi));
    const float g_ratio = __fadd_rn(__fmul_rn(gs1, adv),
                                    __fmul_rn(g_inner, max_grad(ratio, lo)));
    const float g_lp = __fadd_rn(__fmul_rn(g_ratio, ratio), g_kl);
    const float ge1 = __fmul_rn(g_vf, max_grad(e1, e2));
    const float ge2 = __fmul_rn(g_vf, max_grad(e2, e1));
    const float g_dvc = __fmul_rn(ge2, __fmul_rn(2.0f, err2));
    const float g_dv = __fmul_rn(__fmul_rn(g_dvc, min_grad(dv_in, vf_clip)),
                                 max_grad(dv, -vf_clip));
    const float g_v =
        __fadd_rn(__fmul_rn(ge1, __fmul_rn(2.0f, err1)), g_dv);

    // both log-softmax backwards
    if (live) {
#pragma unroll
      for (int h = 0; h < kSlots; ++h) {
        const int j = q + h * L;
        if (j >= a) continue;
        const float sm = __fdiv_rn(e[h], s);
        const float d1 =
            __fsub_rn(j == act ? g_lp : 0.0f, __fmul_rn(sm, g_lp));
        const float d2 = __fsub_rn(g_ent[h], __fmul_rn(sm, g_ent_sum));
        dlogits[static_cast<size_t>(r) * a + j] = __fadd_rn(d1, d2);
      }
      if (q == 0) {
        dvalues[r] = g_v;
        acc[0] = __fadd_rn(acc[0], surr);
        acc[1] = __fadd_rn(acc[1], __fsub_rn(olp, lp_a));
        acc[2] = __fadd_rn(acc[2], vf);
        acc[3] = __fadd_rn(acc[3], ent);
        acc[4] = __fadd_rn(acc[4],
                           fabsf(__fsub_rn(ratio, 1.0f)) > clip ? 1.0f
                                                                : 0.0f);
      }
    }
  }

  // the five sums: each warp's lanes (a fixed butterfly), then the warps
  // in order on warp 0, then (in a cluster) the CTAs in rank order
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = ddls::warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) warp_s[warp][k] = acc[k];
  }
  __syncthreads();
  float sums[kTerms];
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) {
      sums[k] = ddls::warp_sum(lane < n_warps ? warp_s[lane][k] : 0.0f);
    }
    if (lane == 0 && n_ctas > 1) {
#pragma unroll
      for (int k = 0; k < kTerms; ++k) cta_s[k] = sums[k];
    }
  }
  if (n_ctas > 1) {
    ddls::cg::cluster_group cluster = ddls::cg::this_cluster();
    cluster.sync();  // every CTA's sums are in its shared memory
    if (cluster.block_rank() == 0 && tid == 0) {
#pragma unroll
      for (int k = 0; k < kTerms; ++k) sums[k] = cta_s[k];
      for (int c = 1; c < n_ctas; ++c) {
        const float* other = cluster.map_shared_rank(cta_s, c);
#pragma unroll
        for (int k = 0; k < kTerms; ++k) {
          sums[k] = __fadd_rn(sums[k], other[k]);
        }
      }
    }
    cluster.sync();  // CTA 0 has read them: their shared memory may go
    if (cluster.block_rank() != 0) return;
  }
  if (tid == 0) {
    const float policy_loss = -__fdiv_rn(sums[0], m_f);
    const float kl = __fdiv_rn(sums[1], m_f);
    const float vf_loss = __fmul_rn(0.5f, __fdiv_rn(sums[2], m_f));
    const float entropy = __fdiv_rn(sums[3], m_f);
    const float tot = __fsub_rn(
        __fadd_rn(__fadd_rn(policy_loss, __fmul_rn(kc, kl)),
                  __fmul_rn(vf_coeff, vf_loss)),
        __fmul_rn(ent_coeff, entropy));
    metrics[0] = policy_loss;
    metrics[1] = vf_loss;
    metrics[2] = kl;
    metrics[3] = entropy;
    metrics[4] = tot;
    metrics[5] = __fdiv_rn(sums[4], m_f);
    total[0] = tot;
  }
}

template <int L>
cudaError_t launch(int threads, int ctas, cudaStream_t stream,
                   const float* logits, const float* values,
                   const int* actions, const float* old_logp,
                   const float* old_values, const float* advs,
                   const float* targets, const float* kl_coeff,
                   float* metrics, float* total, float* dlogits,
                   float* dvalues, int m, int a, float lo, float hi,
                   float clip, float vf_clip, float vf_coeff,
                   float ent_coeff) {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  ddls::cluster_config(&config, &attr, 1, ctas, threads, 0, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &config, ppo_loss_kernel<L>, logits, values, actions, old_logp,
      old_values, advs, targets, kl_coeff, metrics, total, dlogits, dvalues,
      m, a, lo, hi, clip, vf_clip, vf_coeff, ent_coeff);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// K8 over M rows of A <= 64 actions, `lanes` lanes a row (a power of two,
// 4 lanes >= A), `threads` threads a CTA (a multiple of 32, at most 1,024)
// and one cluster of `ctas` CTAs (1-8), each taking ceil(M / ctas)
// consecutive rows.
DDLS_EXPORT int ddls_ppo_loss(const void* logits, const void* values,
                              const void* actions, const void* old_logp,
                              const void* old_values, const void* advs,
                              const void* targets, const void* kl_coeff,
                              void* metrics, void* total, void* dlogits,
                              void* dvalues, int m, int a, int lanes,
                              int threads, int ctas, float lo, float hi,
                              float clip, float vf_clip, float vf_coeff,
                              float ent_coeff, void* stream) {
  if (m <= 0 || a <= 0 || a > kMaxActions || lanes <= 0 ||
      lanes > kMaxLanes || (lanes & (lanes - 1)) != 0 ||
      kSlots * lanes < a || threads < ddls::kWarpSize ||
      threads > kMaxThreads || threads % ddls::kWarpSize != 0 || ctas < 1 ||
      ctas > kMaxCtas) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto args = [&](auto launcher) {
    return launcher(
        threads, ctas, static_cast<cudaStream_t>(stream),
        static_cast<const float*>(logits), static_cast<const float*>(values),
        static_cast<const int*>(actions),
        static_cast<const float*>(old_logp),
        static_cast<const float*>(old_values),
        static_cast<const float*>(advs), static_cast<const float*>(targets),
        static_cast<const float*>(kl_coeff), static_cast<float*>(metrics),
        static_cast<float*>(total), static_cast<float*>(dlogits),
        static_cast<float*>(dvalues), m, a, lo, hi, clip, vf_clip, vf_coeff,
        ent_coeff);
  };
  cudaError_t err;
  switch (lanes) {
    case 1: err = args(launch<1>); break;
    case 2: err = args(launch<2>); break;
    case 4: err = args(launch<4>); break;
    case 8: err = args(launch<8>); break;
    default: err = args(launch<16>); break;
  }
  return static_cast<int>(err);
}
