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
// 3.35 TB/s. The design is one block; one warp per row (a lane per action,
// two when A > 32) computes the row's log-softmax with shuffles, its loss
// terms and its gradient, and writes the row's five loss terms to a
// scratch row; then the block reduces the scratch in a fixed order (each
// thread's strided slice, then a tree) into the metrics, so the same
// inputs give the same bits on every run. kl_coeff is read from device
// memory, so the caller never waits on the card for it.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * ddls::kWarpSize;
constexpr int kMaxActions = 2 * ddls::kWarpSize;
constexpr int kTerms = 5;  // surr, old_logp - lp, vf, ent, clipped

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = ddls::kWarpSize / 2; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(ddls::kFullMask, v, offset));
  }
  return v;
}

// d min(x, y) / d x and d max(x, y) / d x, JAX's balanced rule
__device__ __forceinline__ float min_grad(float x, float y) {
  return x < y ? 1.0f : (x == y ? 0.5f : 0.0f);
}
__device__ __forceinline__ float max_grad(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

__device__ float block_sum(float v, float* s) {
  s[threadIdx.x] = v;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  const float total = s[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kThreads)
ppo_loss_kernel(const float* __restrict__ logits,      // [M, A]
                const float* __restrict__ values,      // [M]
                const int* __restrict__ actions,       // [M]
                const float* __restrict__ old_logp,    // [M]
                const float* __restrict__ old_values,  // [M]
                const float* __restrict__ advs,        // [M]
                const float* __restrict__ targets,     // [M]
                const float* __restrict__ kl_coeff,    // [1]
                float* __restrict__ rowterms,          // [kTerms, M]
                float* __restrict__ metrics,           // [6]
                float* __restrict__ total,             // [1]
                float* __restrict__ dlogits,           // [M, A]
                float* __restrict__ dvalues,           // [M]
                int m, int a, float lo, float hi, float clip, float vf_clip,
                float vf_coeff, float ent_coeff) {
  __shared__ float red_s[kThreads];
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const float m_f = static_cast<float>(m);
  const float kc = kl_coeff[0];
  // d total / d (per-row term), as the reference's means pass it down
  const float g_surr = __fdiv_rn(-1.0f, m_f);
  const float g_kl = __fdiv_rn(-kc, m_f);            // d / d lp via kl
  const float g_vf = __fdiv_rn(__fmul_rn(vf_coeff, 0.5f), m_f);
  const float g_q = __fdiv_rn(ent_coeff, m_f);       // d / d (p logp)

  for (int r = warp; r < m; r += kWarps) {
    const float* x_row = logits + static_cast<size_t>(r) * a;
    float x[2], sh[2], e[2], lp[2], p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + h * ddls::kWarpSize;
      x[h] = j < a ? x_row[j] : -INFINITY;
    }
    const float mx = warp_max(fmaxf(x[0], x[1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + h * ddls::kWarpSize;
      sh[h] = j < a ? __fsub_rn(x[h], mx) : 0.0f;
      e[h] = j < a ? expf(sh[h]) : 0.0f;
    }
    const float s = ddls::warp_sum(__fadd_rn(e[0], e[1]));
    const float lse = logf(s);
    const int act = actions[r];
    float q_part = 0.0f;
    float lp_act = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + h * ddls::kWarpSize;
      lp[h] = __fsub_rn(sh[h], lse);
      p[h] = j < a ? expf(lp[h]) : 0.0f;
      if (j < a && p[h] > 0.0f) {
        q_part = __fadd_rn(q_part, __fmul_rn(p[h], lp[h]));
      }
      if (j == act) lp_act = lp[h];
    }
    const float ent = -ddls::warp_sum(q_part);
    const float lp_a = ddls::warp_sum(lp_act);  // one lane holds it

    // the row's scalars: every lane computes the same values
    const float adv = advs[r];
    const float olp = old_logp[r];
    const float ratio = expf(__fsub_rn(lp_a, olp));
    const float s1 = __fmul_rn(ratio, adv);
    const float inner = fmaxf(lo, ratio);
    const float rc = fminf(hi, inner);
    const float s2 = __fmul_rn(rc, adv);
    const float surr = fminf(s1, s2);
    const float v = values[r];
    const float tgt = targets[r];
    const float ov = old_values[r];
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

    // the entropy's gradient per action, then both log-softmax backwards
    float g_ent[2];
    float g_ent_part = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + h * ddls::kWarpSize;
      g_ent[h] = 0.0f;
      if (j < a && p[h] > 0.0f) {
        g_ent[h] = __fadd_rn(__fmul_rn(g_q, p[h]),
                             __fmul_rn(__fmul_rn(g_q, lp[h]), p[h]));
      }
      g_ent_part = __fadd_rn(g_ent_part, g_ent[h]);
    }
    const float g_ent_sum = ddls::warp_sum(g_ent_part);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + h * ddls::kWarpSize;
      if (j >= a) continue;
      const float sm = __fdiv_rn(e[h], s);
      const float d1 = __fsub_rn(j == act ? g_lp : 0.0f, __fmul_rn(sm, g_lp));
      const float d2 = __fsub_rn(g_ent[h], __fmul_rn(sm, g_ent_sum));
      dlogits[static_cast<size_t>(r) * a + j] = __fadd_rn(d1, d2);
    }
    if (lane == 0) {
      dvalues[r] = g_v;
      rowterms[r] = surr;
      rowterms[m + r] = __fsub_rn(olp, lp_a);
      rowterms[2 * m + r] = vf;
      rowterms[3 * m + r] = ent;
      rowterms[4 * m + r] =
          fabsf(__fsub_rn(ratio, 1.0f)) > clip ? 1.0f : 0.0f;
    }
  }
  __syncthreads();  // every row's terms are written
  float sums[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float part = 0.0f;
    for (int r = threadIdx.x; r < m; r += kThreads) {
      part = __fadd_rn(part, rowterms[k * m + r]);
    }
    sums[k] = block_sum(part, red_s);
  }
  if (threadIdx.x == 0) {
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

}  // namespace

DDLS_EXPORT int ddls_ppo_loss(const void* logits, const void* values,
                              const void* actions, const void* old_logp,
                              const void* old_values, const void* advs,
                              const void* targets, const void* kl_coeff,
                              void* rowterms, void* metrics, void* total,
                              void* dlogits, void* dvalues, int m, int a,
                              float lo, float hi, float clip, float vf_clip,
                              float vf_coeff, float ent_coeff, void* stream) {
  if (m <= 0 || a <= 0 || a > kMaxActions) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ppo_loss_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(values),
      static_cast<const int*>(actions), static_cast<const float*>(old_logp),
      static_cast<const float*>(old_values), static_cast<const float*>(advs),
      static_cast<const float*>(targets),
      static_cast<const float*>(kl_coeff), static_cast<float*>(rowterms),
      static_cast<float*>(metrics), static_cast<float*>(total),
      static_cast<float*>(dlogits), static_cast<float*>(dvalues), m, a, lo,
      hi, clip, vf_clip, vf_coeff, ent_coeff);
  return static_cast<int>(cudaGetLastError());
}
