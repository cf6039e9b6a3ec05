// K15 es_update: evolution strategies' rank-shaped gradient estimate, with
// the population's centred ranks, the fitness metrics and the gradient's
// global norm, in one launch; K16 es_act: the population's noisy greedy
// actions over masked logits.
//
// Replaces ddls_tpu/rl/es.py:63 centered_ranks and the gradient of
// :172-197 ESLearner._update with its metrics and optax.global_norm (K15),
// and the noisy argmax of :133-152 _pop_actions over the logits that
// ddls_tpu/models/policy.py:87 _mask_logits masks (K16), which XLA
// compiled for the TPU.
//
// K15, for a population of P (even) with fitness f [P] (float32) and the
// first half's noise eps [P/2, n] over the n parameters theta:
//   rank_i = #{j: f_j < f_i} + #{j < i: f_j = f_i}, NaN above every number
//            (argsort(argsort(f)), stable, as jnp.argsort orders NaN last)
//   w_i    = fma(rank_i, f32(1 / max(P - 1, 1)), -0.5), rounded once (the
//            reciprocal rounded to float32 first, as the jitted reference
//            computes it)
//   pw_k   = w_k - w_{k + P/2}
//   g      = fma(l2, theta, -acc * f32(1 / (P sigma))), with
//   acc    = fma(pw_{P/2-1}, eps_{P/2-1}, ... fma(pw_1, eps_1, pw_0 eps_0))
//   (the jitted reference's operations on XLA's CPU backend, in order)
// with the fitness mean, max (NaN-propagating), standard deviation (ddof 0)
// and sqrt(sum g^2), optax's global norm.
//
// K16, per member p over A actions, in this order of float operations:
//   z_j    = (logit_j + max(log mask_j, finfo(float32).min)) + std noise_j
//   action = first argmax_j z_j
// A masked z sits ~3.4e38 below any valid one, which Gaussian noise cannot
// bridge, so noise never picks an invalid action (a fully masked row picks
// index 0). The noise comes from the caller (a torch.Generator on the main
// path, the reference's recorded draws in the parity checks).
//
// What bounds them on the H100: latency. K15 reads P/2 + 1 vectors of n
// floats and writes one (~140 KB for P = 10 at the shipped policy's 5.8k
// parameters, ~40 ns at 3.35 TB/s); K16 reads three [P, A] arrays. K15 is
// one block: every thread ranks its own member against all P (P^2
// comparisons, exact), the pair weights go to shared memory, then the
// threads stride over the parameters, each summing its element's noise in
// pair order, and the block reduces the squares in a fixed order (each
// thread's strided slice, then a tree), so the same inputs give the same
// bits on every run. K16 is K9's shape: one warp per member, one lane per
// action, a butterfly argmax with ties to the lowest index.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxPopulation = 1024;
constexpr int kWarps = 4;

__global__ void __launch_bounds__(kThreads)
es_update_kernel(const float* __restrict__ fitness,  // [p]
                 const float* __restrict__ eps,      // [p / 2, n]
                 const float* __restrict__ theta,    // [n]
                 float* __restrict__ grads,          // [n]
                 float* __restrict__ weights,        // [p]
                 float* __restrict__ metrics,        // [4]
                 int p, int n, float p_sigma, float l2) {
  __shared__ float pair_w[kMaxPopulation / 2];
  __shared__ float w_s[kMaxPopulation];
  __shared__ float red_s[kThreads];
  const int half = p / 2;
  for (int i = threadIdx.x; i < p; i += kThreads) {
    const float fi = fitness[i];
    const bool nan_i = isnan(fi);
    int rank = 0;
    for (int j = 0; j < p; ++j) {
      const float fj = fitness[j];
      const bool nan_j = isnan(fj);
      const bool before =
          nan_i ? (!nan_j || j < i)
                : (!nan_j && (fj < fi || (fj == fi && j < i)));
      rank += before ? 1 : 0;
    }
    // the jitted reference's arithmetic: XLA multiplies by the float32
    // reciprocal of the constant denominator and fuses the - 0.5
    const float w = __fmaf_rn(static_cast<float>(rank),
                              __frcp_rn(static_cast<float>(max(p - 1, 1))),
                              -0.5f);
    w_s[i] = w;
    weights[i] = w;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < half; k += kThreads) {
    pair_w[k] = __fsub_rn(w_s[k], w_s[k + half]);
  }
  __syncthreads();
  float sq = 0.0f;
  // the division by the constant P sigma as the jitted reference does it:
  // a product with the float32 reciprocal
  const float inv_p_sigma = __frcp_rn(p_sigma);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float acc = __fmul_rn(pair_w[0], eps[i]);
    for (int k = 1; k < half; ++k) {
      acc = __fmaf_rn(pair_w[k], eps[static_cast<size_t>(k) * n + i], acc);
    }
    const float g = __fmaf_rn(l2, theta[i], __fmul_rn(-acc, inv_p_sigma));
    grads[i] = g;
    sq = __fadd_rn(sq, __fmul_rn(g, g));
  }
  red_s[threadIdx.x] = sq;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      red_s[threadIdx.x] = __fadd_rn(red_s[threadIdx.x],
                                     red_s[threadIdx.x + stride]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float p_f = static_cast<float>(p);
    float sum = 0.0f;
    float mx = fitness[0];
    for (int j = 0; j < p; ++j) {
      const float fj = fitness[j];
      sum = __fadd_rn(sum, fj);
      if (isnan(fj) || fj > mx) mx = isnan(mx) ? mx : fj;
    }
    const float mean = __fdiv_rn(sum, p_f);
    float var = 0.0f;
    for (int j = 0; j < p; ++j) {
      const float d = __fsub_rn(fitness[j], mean);
      var = __fadd_rn(var, __fmul_rn(d, d));
    }
    metrics[0] = mean;
    metrics[1] = mx;
    metrics[2] = sqrtf(__fdiv_rn(var, p_f));
    metrics[3] = sqrtf(red_s[0]);
  }
}

__global__ void __launch_bounds__(kWarps * ddls::kWarpSize)
es_act_kernel(const float* __restrict__ logits,  // [rows, a]
              const int* __restrict__ mask,      // [rows, a]
              const float* __restrict__ noise,   // [rows, a]
              int* __restrict__ actions,         // [rows]
              int rows, int a, float noise_std) {
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warps leave together
  float z = -INFINITY;
  int idx = ddls::kWarpSize;
  if (lane < a) {
    const size_t at = static_cast<size_t>(row) * a + lane;
    const int mk = mask[at];
    const float floor_term =
        mk == 1 ? 0.0f : fmaxf(logf(static_cast<float>(mk)), -FLT_MAX);
    z = __fadd_rn(__fadd_rn(logits[at], floor_term),
                  __fmul_rn(noise_std, noise[at]));
    idx = lane;
  }
#pragma unroll
  for (int offset = ddls::kWarpSize / 2; offset > 0; offset >>= 1) {
    const float oz = __shfl_xor_sync(ddls::kFullMask, z, offset);
    const int oi = __shfl_xor_sync(ddls::kFullMask, idx, offset);
    if (oz > z || (oz == z && oi < idx)) {
      z = oz;
      idx = oi;
    }
  }
  if (lane == 0) actions[row] = idx;
}

}  // namespace

DDLS_EXPORT int ddls_es_update(const void* fitness, const void* eps,
                               const void* theta, void* grads, void* weights,
                               void* metrics, int p, int n, float p_sigma,
                               float l2, void* stream) {
  if (p < 2 || p % 2 != 0 || p > kMaxPopulation || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  es_update_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(fitness), static_cast<const float*>(eps),
      static_cast<const float*>(theta), static_cast<float*>(grads),
      static_cast<float*>(weights), static_cast<float*>(metrics), p, n,
      p_sigma, l2);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_es_act(const void* logits, const void* mask,
                            const void* noise, void* actions, int rows, int a,
                            float noise_std, void* stream) {
  if (rows <= 0 || a <= 0 || a > ddls::kWarpSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  es_act_kernel<<<ddls::grid_for(rows, kWarps), kWarps * ddls::kWarpSize, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(mask),
      static_cast<const float*>(noise), static_cast<int*>(actions), rows, a,
      noise_std);
  return static_cast<int>(cudaGetLastError());
}
