// K7 gae_normalize: generalised advantage estimation over a [T, B]
// trajectory, value targets, and the advantage normalisation, in one
// launch.
//
// Replaces ddls_tpu/rl/ppo.py:101 compute_gae (a reverse lax.scan) and the
// normalisation in PPOLearner._train_step (ppo.py:298-301), which XLA
// compiled for the TPU. Per lane b, backwards over t:
//
//   next_v  = values[t + 1, b] (last_values[b] at t = T - 1)
//   nd      = 1 - dones[t, b]
//   delta   = rewards + (gamma * next_v) * nd - values
//   adv     = delta + ((gamma * lam) * nd) * carry;  carry = adv
//   targets = adv + values            (from the RAW advantages, as ppo.py)
//
// then, when normalising, adv = (adv - mean) / (std + 1e-8) with the
// population std (jnp.std, ddof 0) over all T * B entries. Each product
// and sum rounds on its own, in the reference's association order (no
// contraction), and gamma * lam arrives from the host already rounded, as
// the reference's Python-float product is.
//
// What bounds it on the H100: latency. The work is 5 T B floats of traffic
// and a T-long dependency chain per lane; there is nothing to fill the
// card with. The design is one block: a thread per lane runs the
// recurrence (the scan's sequential axis stays a loop inside the thread),
// then the whole block takes the mean and the variance with a fixed-order
// tree reduction (each thread's strided slice in index order, then the
// tree), so the normalised advantages are the same bits on every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// sum of s[0..kThreads) by a fixed tree; every thread gets the total
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
  __syncthreads();  // s is reused by the next reduction
  return total;
}

__global__ void __launch_bounds__(kThreads)
gae_normalize_kernel(const float* __restrict__ rewards,   // [T, B]
                     const float* __restrict__ values,    // [T, B]
                     const float* __restrict__ dones,     // [T, B], 0 or 1
                     const float* __restrict__ last_values,  // [B]
                     float* __restrict__ adv,             // [T, B]
                     float* __restrict__ targets,         // [T, B]
                     int t_len, int lanes, float gamma, float gamma_lam,
                     int normalize) {
  __shared__ float red_s[kThreads];
  for (int b = threadIdx.x; b < lanes; b += kThreads) {
    float carry = 0.0f;
    for (int t = t_len - 1; t >= 0; --t) {
      const size_t i = static_cast<size_t>(t) * lanes + b;
      const float next_v =
          t == t_len - 1 ? last_values[b] : values[i + lanes];
      const float nd = __fsub_rn(1.0f, dones[i]);
      const float delta = __fsub_rn(
          __fadd_rn(rewards[i], __fmul_rn(__fmul_rn(gamma, next_v), nd)),
          values[i]);
      carry = __fadd_rn(delta, __fmul_rn(__fmul_rn(gamma_lam, nd), carry));
      adv[i] = carry;
      targets[i] = __fadd_rn(carry, values[i]);
    }
  }
  if (!normalize) return;
  __syncthreads();  // every lane's advantages are written
  const size_t n = static_cast<size_t>(t_len) * lanes;
  const float n_f = static_cast<float>(n);
  float part = 0.0f;
  for (size_t i = threadIdx.x; i < n; i += kThreads) {
    part = __fadd_rn(part, adv[i]);
  }
  const float mean = __fdiv_rn(block_sum(part, red_s), n_f);
  part = 0.0f;
  for (size_t i = threadIdx.x; i < n; i += kThreads) {
    const float c = __fsub_rn(adv[i], mean);
    part = __fadd_rn(part, __fmul_rn(c, c));
  }
  const float var = __fdiv_rn(block_sum(part, red_s), n_f);
  const float denom = __fadd_rn(sqrtf(var), 1e-8f);
  for (size_t i = threadIdx.x; i < n; i += kThreads) {
    adv[i] = __fdiv_rn(__fsub_rn(adv[i], mean), denom);
  }
}

}  // namespace

DDLS_EXPORT int ddls_gae_normalize(const void* rewards, const void* values,
                                   const void* dones, const void* last_values,
                                   void* adv, void* targets, int t_len,
                                   int lanes, float gamma, float gamma_lam,
                                   int normalize, void* stream) {
  if (t_len <= 0 || lanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  gae_normalize_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(values),
      static_cast<const float*>(dones),
      static_cast<const float*>(last_values), static_cast<float*>(adv),
      static_cast<float*>(targets), t_len, lanes, gamma, gamma_lam,
      normalize);
  return static_cast<int>(cudaGetLastError());
}
