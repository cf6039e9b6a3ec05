// K12 ac_loss: the actor-critic loss of the IMPALA and policy-gradient
// updates, its seven metrics, and its gradient with respect to the logits
// and the values, in one launch (forward and backward together); and
// ac_logp, the same log-softmax's log-probability of each row's action,
// which V-trace (K10) takes before the loss can run.
//
// Replaces ddls_tpu/rl/impala.py:201 ImpalaLearner._loss and
// ddls_tpu/rl/pg.py:141 PGLearner._loss with the backward
// jax.value_and_grad derives from them, which XLA compiled for the TPU.
// Per row i (B-major, row = b T + t), over A actions of masked logits x:
//
//   logp = log_softmax(x); lp = logp[action]; p = exp(logp)
//   lm   = where(isfinite(logp), logp, 0)         (impala.py's guard)
//   ent  = -sum_j p_j lm_j
//   rho  = exp(lp - behavior_logp)
//
// and over the N kept rows (every row, or, with drop_last, every row but
// each lane's last step t = T - 1, impala.py's vtrace_drop_last_ts):
// policy_loss = -mean(lp w), vf_loss = 0.5 mean((v - vs)^2), entropy =
// mean(ent), total = policy_loss + vf_coeff vf_loss - ent_coeff entropy,
// mean_rho = mean(rho), clip_rho_fraction = mean(rho > clip_rho), and
// mean(w) (PG's mean_return_to_go). w is V-trace's pg_adv for IMPALA and
// the reward-to-go for PG, which runs with vf_coeff = ent_coeff = 0 and
// no dropped step. The gradient is d total / d x and d total / d v; a
// dropped row gets zero, as the reference's slice gives it. Masked logits
// (finfo.min + logit) are finite, so the guard keeps them, and p = 0 gives
// them no entropy gradient.
//
// What bounds it on the H100: latency. R A floats of logits in, the same
// out, a few hundred flops per row: far under a microsecond of bytes at
// 3.35 TB/s. The design is K8's: one block; one warp per row (a lane per
// action, two when A > 32) computes the row's log-softmax with shuffles,
// its loss terms and its gradient, and writes the row's six terms to a
// scratch row; then the block reduces the scratch in a fixed order (each
// thread's strided slice, then a tree) into the metrics, so the same
// inputs give the same bits on every run. ac_logp runs the same row code.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * ddls::kWarpSize;
constexpr int kMaxActions = 2 * ddls::kWarpSize;
constexpr int kTerms = 6;  // lp w, (v - vs)^2, ent, rho, rho > clip, w

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = ddls::kWarpSize / 2; offset > 0; offset >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(ddls::kFullMask, v, offset));
  }
  return v;
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

// One row's log-softmax in a warp: this lane's entries j = lane and lane +
// 32 (e: exp(x - max), lp: log-probability), the row's sum of e, and the
// log-probability of the row's action (every lane gets it).
struct RowSoftmax {
  float e[2], lp[2], s, lp_act;
};

__device__ __forceinline__ RowSoftmax row_softmax(const float* x_row, int a,
                                                  int act, int lane) {
  RowSoftmax out;
  float x[2], sh[2];
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
    out.e[h] = j < a ? expf(sh[h]) : 0.0f;
  }
  out.s = ddls::warp_sum(__fadd_rn(out.e[0], out.e[1]));
  const float lse = logf(out.s);
  float lp_act = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + h * ddls::kWarpSize;
    out.lp[h] = __fsub_rn(sh[h], lse);
    if (j == act) lp_act = out.lp[h];
  }
  out.lp_act = ddls::warp_sum(lp_act);  // one lane holds it
  return out;
}

__global__ void __launch_bounds__(kThreads)
ac_logp_kernel(const float* __restrict__ logits,  // [R, A]
               const int* __restrict__ actions,   // [R]
               float* __restrict__ logp,          // [R]
               int rows, int a) {
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  for (int r = blockIdx.x * kWarps + warp; r < rows;
       r += gridDim.x * kWarps) {
    const RowSoftmax sm =
        row_softmax(logits + static_cast<size_t>(r) * a, a, actions[r], lane);
    if (lane == 0) logp[r] = sm.lp_act;
  }
}

__global__ void __launch_bounds__(kThreads)
ac_loss_kernel(const float* __restrict__ logits,         // [R, A]
               const float* __restrict__ values,         // [R]
               const int* __restrict__ actions,          // [R]
               const float* __restrict__ weights,        // [R]
               const float* __restrict__ vs,             // [R]
               const float* __restrict__ behavior_logp,  // [R]
               float* __restrict__ rowterms,             // [kTerms, R]
               float* __restrict__ metrics,              // [7]
               float* __restrict__ total,                // [1]
               float* __restrict__ dlogits,              // [R, A]
               float* __restrict__ dvalues,              // [R]
               int rows, int a, int t_len, int drop_last, float vf_coeff,
               float ent_coeff, float clip_rho) {
  __shared__ float red_s[kThreads];
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int kept = drop_last ? rows - rows / t_len : rows;
  const float n_f = static_cast<float>(kept);
  // d total / d (per-row term), as the reference's means pass it down
  const float g_pol = __fdiv_rn(-1.0f, n_f);              // d / d (lp w)
  const float g_vf = __fdiv_rn(__fmul_rn(vf_coeff, 0.5f), n_f);
  const float g_q = __fdiv_rn(ent_coeff, n_f);            // d / d (p lm)

  for (int r = warp; r < rows; r += kWarps) {
    float* dx_row = dlogits + static_cast<size_t>(r) * a;
    if (drop_last && r % t_len == t_len - 1) {
      for (int j = lane; j < a; j += ddls::kWarpSize) dx_row[j] = 0.0f;
      if (lane == 0) {
        dvalues[r] = 0.0f;
        for (int k = 0; k < kTerms; ++k) rowterms[k * rows + r] = 0.0f;
      }
      continue;
    }
    const int act = actions[r];
    const RowSoftmax sm =
        row_softmax(logits + static_cast<size_t>(r) * a, a, act, lane);
    const float w = weights[r];
    const float g_lp = __fmul_rn(g_pol, w);
    float q_part = 0.0f;
    float g[2];
    float g_part = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + h * ddls::kWarpSize;
      g[h] = 0.0f;
      if (j >= a) continue;
      const float p = expf(sm.lp[h]);
      const bool finite = isfinite(sm.lp[h]);
      const float lm = finite ? sm.lp[h] : 0.0f;
      q_part = __fadd_rn(q_part, __fmul_rn(p, lm));
      // d (p lm) / d logp: p lm through exp, p through the guarded logp
      g[h] = __fadd_rn(__fmul_rn(__fmul_rn(g_q, lm), p),
                       finite ? __fmul_rn(g_q, p) : 0.0f);
      if (j == act) g[h] = __fadd_rn(g[h], g_lp);
      g_part = __fadd_rn(g_part, g[h]);
    }
    const float ent = -ddls::warp_sum(q_part);
    const float g_sum = ddls::warp_sum(g_part);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + h * ddls::kWarpSize;
      if (j >= a) continue;
      // the log-softmax backward: g_j - softmax_j sum_k g_k
      dx_row[j] = __fsub_rn(g[h], __fmul_rn(__fdiv_rn(sm.e[h], sm.s), g_sum));
    }
    if (lane == 0) {
      const float err = __fsub_rn(values[r], vs[r]);
      const float rho = expf(__fsub_rn(sm.lp_act, behavior_logp[r]));
      dvalues[r] = __fmul_rn(g_vf, __fmul_rn(2.0f, err));
      rowterms[r] = __fmul_rn(sm.lp_act, w);
      rowterms[rows + r] = __fmul_rn(err, err);
      rowterms[2 * rows + r] = ent;
      rowterms[3 * rows + r] = rho;
      rowterms[4 * rows + r] = rho > clip_rho ? 1.0f : 0.0f;
      rowterms[5 * rows + r] = w;
    }
  }
  __syncthreads();  // every row's terms are written
  float sums[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float part = 0.0f;
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      part = __fadd_rn(part, rowterms[k * rows + r]);
    }
    sums[k] = block_sum(part, red_s);
  }
  if (threadIdx.x == 0) {
    const float policy_loss = -__fdiv_rn(sums[0], n_f);
    const float vf_loss = __fmul_rn(0.5f, __fdiv_rn(sums[1], n_f));
    const float entropy = __fdiv_rn(sums[2], n_f);
    const float tot = __fsub_rn(
        __fadd_rn(policy_loss, __fmul_rn(vf_coeff, vf_loss)),
        __fmul_rn(ent_coeff, entropy));
    metrics[0] = policy_loss;
    metrics[1] = vf_loss;
    metrics[2] = entropy;
    metrics[3] = tot;
    metrics[4] = __fdiv_rn(sums[3], n_f);
    // the float32 mean of a count as XLA takes it: times the reciprocal
    metrics[5] = __fmul_rn(sums[4], __frcp_rn(n_f));
    metrics[6] = __fdiv_rn(sums[5], n_f);
    total[0] = tot;
  }
}

}  // namespace

DDLS_EXPORT int ddls_ac_logp(const void* logits, const void* actions,
                             void* logp, int rows, int a, void* stream) {
  if (rows <= 0 || a <= 0 || a > kMaxActions) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ac_logp_kernel<<<ddls::grid_for(rows, kWarps), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(actions),
      static_cast<float*>(logp), rows, a);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_ac_loss(const void* logits, const void* values,
                             const void* actions, const void* weights,
                             const void* vs, const void* behavior_logp,
                             void* rowterms, void* metrics, void* total,
                             void* dlogits, void* dvalues, int rows, int a,
                             int t_len, int drop_last, float vf_coeff,
                             float ent_coeff, float clip_rho, void* stream) {
  if (rows <= 0 || a <= 0 || a > kMaxActions || t_len <= 0 ||
      rows % t_len != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ac_loss_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(values),
      static_cast<const int*>(actions), static_cast<const float*>(weights),
      static_cast<const float*>(vs),
      static_cast<const float*>(behavior_logp),
      static_cast<float*>(rowterms), static_cast<float*>(metrics),
      static_cast<float*>(total), static_cast<float*>(dlogits),
      static_cast<float*>(dvalues), rows, a, t_len, drop_last, vf_coeff,
      ent_coeff, clip_rho);
  return static_cast<int>(cudaGetLastError());
}
