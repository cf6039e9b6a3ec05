// K13 dqn_act: Ape-X DQN's per-env epsilon-greedy action over the valid
// actions; K14 dqn_td_loss: the double/dueling DQN TD loss, its metrics,
// the new priorities |td| and its gradient, in one entry point.
//
// Replaces ddls_tpu/rl/dqn.py:262-279 ApexDQNLearner._masked_q and
// _sample_actions over :103 dueling_q_values (K13), and :290-334 the
// update's loss_fn with its metrics, |td| and the backward
// jax.value_and_grad derives from it, over :114 huber (K14), which XLA
// compiled for the TPU.
//
// The dueling Q of a row of logits l [A] and a value v is
//
//   q_j = (v + l_j) - mean(l),   mean(l) = (l_0 + l_1 + ... + l_{A-1}) inv_a
//
// with the sum taken left to right and inv_a = float32(1 / A) (XLA takes a
// float32 mean as the sum times the reciprocal); without dueling q = l.
//
// K13, per row (env) b, in this order of float operations:
//   masked_j = mask_j ? q_j : finfo(float32).min    (a where, not a floor)
//   greedy   = first argmax_j masked_j
//   rand     = first argmax_j (log(mask_j + 1e-30) - log(-log u_pick_j))
//   action   = u_explore < eps ? rand : greedy
// rand is jax.random.categorical(pick_rng, log(mask + 1e-30)) with its
// uniforms handed in: an invalid action sits at log(1e-30) = -69.08, not at
// -inf, and a fully masked row draws over every action. The uniforms come
// from the caller (a torch.Generator on the main path, the reference's
// recorded bits in the parity checks), so the kernel draws nothing.
//
// K14, per replay row i, from the three forwards (online on obs, online on
// next_obs, target on next_obs):
//   q_sel  = q_online[i, a_i]
//   best   = first argmax_j where(next_mask_j, double_q ? q_online_next_j
//                                               : q_target_next_j, min)
//   td     = q_sel - (r_i + discount_i q_target_next[i, best])
//   h      = |td| <= 1 ? (0.5 td) td : |td| - 0.5              (delta = 1)
// and over the N rows: loss = mean(w h), mean_q = mean(q_sel), mean |td|,
// max |td|. The gradient reaches the online forward on obs only: with
// g = w clip(td, -1, 1) / N, d logits_j = g (1[j = a] - 1/A) under dueling
// (g 1[j = a] without) and d value = g (0 without dueling).
//
// What bounds them on the H100: latency. K13 reads [B, A] floats a few
// times over and writes B ints; K14 reads seven [N, A] and [N] arrays and
// writes [N, A] + 2 N floats: a few hundred kilobytes at most, well under a
// microsecond at 3.35 TB/s. The design: one warp per row, one lane per
// action (A <= 32); the mean is a left-to-right chain of shuffles that every
// lane repeats, so the kernel rounds as the plain version does, and the
// argmaxes are butterflies with ties to the lowest index. K14 runs as two
// launches behind one entry: a grid over rows writes each row's gradient
// and its three loss terms to a scratch row, then one block reduces the
// scratch in a fixed order (each thread's strided slice, then a tree), so
// the same inputs give the same bits on every run, with no atomics.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowThreads = kWarps * ddls::kWarpSize;
constexpr int kReduceThreads = 256;
constexpr int kTerms = 3;  // w h, q_sel, |td|

// The dueling Q of this lane's action: lane j < a holds l_j; every lane
// takes the row's sum in the same left-to-right order.
__device__ __forceinline__ float dueling_q(float l, float v, int a,
                                           int dueling, float inv_a) {
  float s = __shfl_sync(ddls::kFullMask, l, 0);
  for (int k = 1; k < a; ++k) {
    s = __fadd_rn(s, __shfl_sync(ddls::kFullMask, l, k));
  }
  if (!dueling) return l;
  return __fsub_rn(__fadd_rn(v, l), __fmul_rn(s, inv_a));
}

// First argmax over the warp: (value, index) with ties to the lowest index;
// a lane outside the row enters at -inf with an index past the row.
__device__ __forceinline__ int warp_argmax(float x, int idx) {
#pragma unroll
  for (int offset = ddls::kWarpSize / 2; offset > 0; offset >>= 1) {
    const float ox = __shfl_xor_sync(ddls::kFullMask, x, offset);
    const int oi = __shfl_xor_sync(ddls::kFullMask, idx, offset);
    if (ox > x || (ox == x && oi < idx)) {
      x = ox;
      idx = oi;
    }
  }
  return idx;
}

__global__ void __launch_bounds__(kRowThreads)
dqn_act_kernel(const float* __restrict__ logits,     // [rows, a]
               const float* __restrict__ values,     // [rows]
               const int* __restrict__ mask,         // [rows, a]
               const float* __restrict__ eps,        // [rows]
               const float* __restrict__ u_explore,  // [rows]
               const float* __restrict__ u_pick,     // [rows, a]
               int* __restrict__ actions,            // [rows]
               int rows, int a, int dueling, float inv_a) {
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warps leave together
  const bool live = lane < a;
  const size_t at = static_cast<size_t>(row) * a + lane;
  const float l = live ? logits[at] : 0.0f;
  const float q = dueling_q(l, values[row], a, dueling, inv_a);
  const int mk = live ? mask[at] : 0;
  const float masked = live ? (mk != 0 ? q : -FLT_MAX) : -INFINITY;
  const int greedy = warp_argmax(masked, live ? lane : ddls::kWarpSize);
  float z = -INFINITY;
  if (live) {
    const float log_mask = logf(__fadd_rn(static_cast<float>(mk), 1e-30f));
    z = __fsub_rn(log_mask, logf(-logf(u_pick[at])));
  }
  const int rand = warp_argmax(z, live ? lane : ddls::kWarpSize);
  if (lane == 0) actions[row] = u_explore[row] < eps[row] ? rand : greedy;
}

__global__ void __launch_bounds__(kRowThreads)
dqn_td_rows_kernel(const float* __restrict__ logits,       // [rows, a]
                   const float* __restrict__ values,       // [rows]
                   const float* __restrict__ next_logits,  // [rows, a]
                   const float* __restrict__ next_values,  // [rows]
                   const float* __restrict__ tgt_logits,   // [rows, a]
                   const float* __restrict__ tgt_values,   // [rows]
                   const int* __restrict__ next_mask,      // [rows, a]
                   const int* __restrict__ actions,        // [rows]
                   const float* __restrict__ rewards,      // [rows]
                   const float* __restrict__ discounts,    // [rows]
                   const float* __restrict__ weights,      // [rows]
                   float* __restrict__ rowterms,           // [kTerms, rows]
                   float* __restrict__ td_abs,             // [rows]
                   float* __restrict__ dlogits,            // [rows, a]
                   float* __restrict__ dvalues,            // [rows]
                   int rows, int a, int double_q, int dueling,
                   float inv_a, float inv_n) {
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  const bool live = lane < a;
  const size_t at = static_cast<size_t>(row) * a + lane;
  const float q = dueling_q(live ? logits[at] : 0.0f, values[row], a,
                            dueling, inv_a);
  const float q_tgt = dueling_q(live ? tgt_logits[at] : 0.0f,
                                tgt_values[row], a, dueling, inv_a);
  float sel = q_tgt;
  if (double_q) {
    sel = dueling_q(live ? next_logits[at] : 0.0f, next_values[row], a,
                    dueling, inv_a);
  }
  const float masked =
      live ? (next_mask[at] != 0 ? sel : -FLT_MAX) : -INFINITY;
  const int best = warp_argmax(masked, live ? lane : ddls::kWarpSize);
  const int act = actions[row];
  const float q_sel = __shfl_sync(ddls::kFullMask, q, act);
  const float next_q = __shfl_sync(ddls::kFullMask, q_tgt, best);
  const float target = __fadd_rn(rewards[row],
                                 __fmul_rn(discounts[row], next_q));
  const float td = __fsub_rn(q_sel, target);
  const float abs_td = fabsf(td);
  const float w = weights[row];
  const float g = __fmul_rn(__fmul_rn(w, fminf(fmaxf(td, -1.0f), 1.0f)),
                            inv_n);
  if (live) {
    const float own = lane == act ? g : 0.0f;
    dlogits[at] = dueling ? __fsub_rn(own, __fmul_rn(g, inv_a)) : own;
  }
  if (lane == 0) {
    const float h = abs_td <= 1.0f ? __fmul_rn(__fmul_rn(0.5f, td), td)
                                   : __fsub_rn(abs_td, 0.5f);
    dvalues[row] = dueling ? g : 0.0f;
    td_abs[row] = abs_td;
    rowterms[row] = __fmul_rn(w, h);
    rowterms[rows + row] = q_sel;
    rowterms[2 * rows + row] = abs_td;
  }
}

__global__ void __launch_bounds__(kReduceThreads)
dqn_td_reduce_kernel(const float* __restrict__ rowterms,  // [kTerms, rows]
                     float* __restrict__ metrics,          // [4]
                     float* __restrict__ total,            // [1]
                     int rows, float inv_n) {
  __shared__ float s[kReduceThreads];
  float out[kTerms + 1];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
    float part = 0.0f;
    for (int r = threadIdx.x; r < rows; r += kReduceThreads) {
      part = __fadd_rn(part, rowterms[k * rows + r]);
    }
    s[threadIdx.x] = part;
    __syncthreads();
    for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) {
        s[threadIdx.x] = __fadd_rn(s[threadIdx.x], s[threadIdx.x + stride]);
      }
      __syncthreads();
    }
    out[k] = s[0];
    __syncthreads();
  }
  // max |td| (|td| >= 0, so 0 starts the maximum)
  float part = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kReduceThreads) {
    part = fmaxf(part, rowterms[2 * rows + r]);
  }
  s[threadIdx.x] = part;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s[threadIdx.x] = fmaxf(s[threadIdx.x], s[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  out[kTerms] = s[0];
  if (threadIdx.x == 0) {
    const float loss = __fmul_rn(out[0], inv_n);
    metrics[0] = loss;
    metrics[1] = __fmul_rn(out[1], inv_n);
    metrics[2] = __fmul_rn(out[2], inv_n);
    metrics[3] = out[kTerms];
    total[0] = loss;
  }
}

}  // namespace

DDLS_EXPORT int ddls_dqn_act(const void* logits, const void* values,
                             const void* mask, const void* eps,
                             const void* u_explore, const void* u_pick,
                             void* actions, int rows, int a, int dueling,
                             float inv_a, void* stream) {
  if (rows <= 0 || a <= 0 || a > ddls::kWarpSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dqn_act_kernel<<<ddls::grid_for(rows, kWarps), kRowThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(values),
      static_cast<const int*>(mask), static_cast<const float*>(eps),
      static_cast<const float*>(u_explore),
      static_cast<const float*>(u_pick), static_cast<int*>(actions), rows, a,
      dueling, inv_a);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_dqn_td_loss(
    const void* logits, const void* values, const void* next_logits,
    const void* next_values, const void* tgt_logits, const void* tgt_values,
    const void* next_mask, const void* actions, const void* rewards,
    const void* discounts, const void* weights, void* rowterms,
    void* metrics, void* total, void* td_abs, void* dlogits, void* dvalues,
    int rows, int a, int double_q, int dueling, float inv_a, float inv_n,
    void* stream) {
  if (rows <= 0 || a <= 0 || a > ddls::kWarpSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  dqn_td_rows_kernel<<<ddls::grid_for(rows, kWarps), kRowThreads, 0, s>>>(
      static_cast<const float*>(logits), static_cast<const float*>(values),
      static_cast<const float*>(next_logits),
      static_cast<const float*>(next_values),
      static_cast<const float*>(tgt_logits),
      static_cast<const float*>(tgt_values),
      static_cast<const int*>(next_mask), static_cast<const int*>(actions),
      static_cast<const float*>(rewards), static_cast<const float*>(discounts),
      static_cast<const float*>(weights), static_cast<float*>(rowterms),
      static_cast<float*>(td_abs), static_cast<float*>(dlogits),
      static_cast<float*>(dvalues), rows, a, double_q, dueling, inv_a, inv_n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dqn_td_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      static_cast<const float*>(rowterms), static_cast<float*>(metrics),
      static_cast<float*>(total), rows, inv_n);
  return static_cast<int>(cudaGetLastError());
}
