// K10 vtrace and K11 reward_to_go: the reverse-time scans of the IMPALA
// and policy-gradient updates over a [T, B] trajectory.
//
// K10 replaces ddls_tpu/rl/impala.py:69 vtrace, K11 ddls_tpu/rl/pg.py:49
// reward_to_go (each a reverse lax.scan that XLA compiled for the TPU).
// Per lane b, backwards over t, with nd = 1 - dones[t, b] and next_v =
// values[t + 1, b] (last_values[b] at t = T - 1):
//
// K10: rho   = exp(target_logp - behavior_logp)
//      delta = min(clip_rho, rho) * ((rewards + (gamma * next_v) * nd)
//                                    - values)
//      acc   = delta + ((gamma * min(1, rho)) * nd) * acc
//      vs    = values + acc
//      pg_adv = min(clip_pg_rho, rho) * ((rewards + (gamma * next_vs) * nd)
//                                        - values)
//   where next_vs is vs[t + 1, b], computed the step before, and
//   last_values[b] at t = T - 1: one sweep gives both outputs.
// K11: g = rewards + (gamma * nd) * g, from a zero tail.
//
// Each product and sum rounds on its own, in the reference's association
// order (no contraction). K11's gamma * nd rounds gamma to float32, as the
// reference's weak-typed product with the float32 not_done does even
// under x64.
//
// What bounds them on the H100: latency. The work is a few floats of
// traffic per entry and a T-long dependency chain per lane; there is
// nothing to fill the card with. The design is one thread per lane that
// runs the recurrence (the scan's sequential axis stays a loop inside the
// thread), as K7 does; lanes beyond one block's threads take more blocks.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
vtrace_kernel(const float* __restrict__ behavior_logp,  // [T, B]
              const float* __restrict__ target_logp,    // [T, B]
              const float* __restrict__ rewards,        // [T, B]
              const float* __restrict__ values,         // [T, B]
              const float* __restrict__ dones,          // [T, B], 0 or 1
              const float* __restrict__ last_values,    // [B]
              float* __restrict__ vs,                   // [T, B]
              float* __restrict__ pg_adv,               // [T, B]
              int t_len, int lanes, float gamma, float clip_rho,
              float clip_pg_rho) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= lanes) return;
  const float last = last_values[b];
  float acc = 0.0f;
  float next_vs = last;
  for (int t = t_len - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * lanes + b;
    const float next_v = t == t_len - 1 ? last : values[i + lanes];
    const float v = values[i];
    const float r = rewards[i];
    const float nd = __fsub_rn(1.0f, dones[i]);
    const float rho = expf(__fsub_rn(target_logp[i], behavior_logp[i]));
    const float delta = __fmul_rn(
        fminf(clip_rho, rho),
        __fsub_rn(__fadd_rn(r, __fmul_rn(__fmul_rn(gamma, next_v), nd)), v));
    acc = __fadd_rn(delta,
                    __fmul_rn(__fmul_rn(__fmul_rn(gamma, fminf(1.0f, rho)),
                                        nd),
                              acc));
    const float vs_t = __fadd_rn(v, acc);
    vs[i] = vs_t;
    pg_adv[i] = __fmul_rn(
        fminf(clip_pg_rho, rho),
        __fsub_rn(__fadd_rn(r, __fmul_rn(__fmul_rn(gamma, next_vs), nd)), v));
    next_vs = vs_t;
  }
}

__global__ void __launch_bounds__(kThreads)
reward_to_go_kernel(const float* __restrict__ rewards,  // [T, B]
                    const float* __restrict__ dones,    // [T, B], 0 or 1
                    float* __restrict__ returns,        // [T, B]
                    int t_len, int lanes, float gamma) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= lanes) return;
  float g = 0.0f;
  for (int t = t_len - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * lanes + b;
    const float nd = __fsub_rn(1.0f, dones[i]);
    g = __fadd_rn(rewards[i], __fmul_rn(__fmul_rn(gamma, nd), g));
    returns[i] = g;
  }
}

}  // namespace

DDLS_EXPORT int ddls_vtrace(const void* behavior_logp, const void* target_logp,
                            const void* rewards, const void* values,
                            const void* dones, const void* last_values,
                            void* vs, void* pg_adv, int t_len, int lanes,
                            float gamma, float clip_rho, float clip_pg_rho,
                            void* stream) {
  if (t_len <= 0 || lanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  vtrace_kernel<<<ddls::grid_for(lanes, kThreads), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(behavior_logp),
      static_cast<const float*>(target_logp),
      static_cast<const float*>(rewards), static_cast<const float*>(values),
      static_cast<const float*>(dones),
      static_cast<const float*>(last_values), static_cast<float*>(vs),
      static_cast<float*>(pg_adv), t_len, lanes, gamma, clip_rho,
      clip_pg_rho);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_reward_to_go(const void* rewards, const void* dones,
                                  void* returns, int t_len, int lanes,
                                  float gamma, void* stream) {
  if (t_len <= 0 || lanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  reward_to_go_kernel<<<ddls::grid_for(lanes, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(dones),
      static_cast<float*>(returns), t_len, lanes, gamma);
  return static_cast<int>(cudaGetLastError());
}
