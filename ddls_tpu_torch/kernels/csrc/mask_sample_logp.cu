// K9 mask_sample_logp: mask the logits, draw one action per row by
// Gumbel-max from handed-in uniforms, and give its log-probability.
//
// Replaces ddls_tpu/rl/ppo.py:PPOLearner._sample_actions (ppo.py:262-268)
// over the logits that ddls_tpu/models/policy.py:_mask_logits (policy.py:87)
// masks, i.e. jax.random.categorical (Gumbel-max, jax._src.random._gumbel
// mode "low") + jax.nn.log_softmax + take_along_axis, per row r:
//
//   m[i]    = logit[i] + max(log(mask[i]), finfo(float32).min)
//   g[i]    = -log(-log(u[i]))             u in [finfo(float32).tiny, 1)
//   a       = argmax_i (m[i] + g[i])       ties to the lowest index
//   logp    = (m[a] - max m) - log(sum_i exp(m[i] - max m))
//
// A masked m is finite (finfo.min + logit rounds to finfo.min), so a fully
// masked row has every m + g equal to finfo.min: a = 0 and logp = -log(A),
// as in the reference. The uniforms come from the caller (a
// torch.Generator on the main path, the reference's recorded bits in the
// parity checks), so the kernel draws nothing itself.
//
// What bounds it on the H100: neither; at rollout shapes ([8, 17]) it reads
// three [B, A] float32 arrays and writes two [B] arrays, a few hundred
// bytes, so its cost is launch latency. One warp per row, one lane per
// action (A <= 32): warp shuffles give the max, the argmax and the sum;
// several rows per block, nothing shared between rows, no atomics.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * ddls::kWarpSize)
mask_sample_logp_kernel(const float* __restrict__ logits,  // [rows, a]
                        const int* __restrict__ mask,      // [rows, a]
                        const float* __restrict__ u,       // [rows, a]
                        int* __restrict__ action,          // [rows]
                        float* __restrict__ logp,          // [rows]
                        int rows, int a) {
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;  // whole warps leave together
  const bool live = lane < a;
  float m = -FLT_MAX;
  float z = -FLT_MAX;
  if (live) {
    const size_t at = static_cast<size_t>(row) * a + lane;
    const int mk = mask[at];
    const float floor_term =
        mk == 1 ? 0.0f : fmaxf(logf(static_cast<float>(mk)), -FLT_MAX);
    m = __fadd_rn(logits[at], floor_term);
    const float g = -logf(-logf(u[at]));
    z = __fadd_rn(m, g);
  }
  // max of m, and the first maximum of z
  float m_max = m;
  float best = z;
  int best_i = live ? lane : ddls::kWarpSize;
#pragma unroll
  for (int offset = ddls::kWarpSize / 2; offset > 0; offset >>= 1) {
    m_max = fmaxf(m_max, __shfl_xor_sync(ddls::kFullMask, m_max, offset));
    const float other = __shfl_xor_sync(ddls::kFullMask, best, offset);
    const int other_i = __shfl_xor_sync(ddls::kFullMask, best_i, offset);
    if (other > best || (other == best && other_i < best_i)) {
      best = other;
      best_i = other_i;
    }
  }
  const float shifted = __fsub_rn(m, m_max);
  const float sum = ddls::warp_sum(live ? expf(shifted) : 0.0f);
  const float picked = __shfl_sync(ddls::kFullMask, shifted, best_i);
  if (lane == 0) {
    action[row] = best_i;
    logp[row] = __fsub_rn(picked, logf(sum));
  }
}

}  // namespace

DDLS_EXPORT int ddls_mask_sample_logp(const void* logits, const void* mask,
                                      const void* u, void* action, void* logp,
                                      int rows, int a, void* stream) {
  if (rows <= 0 || a <= 0 || a > ddls::kWarpSize) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = ddls::grid_for(rows, kWarps);
  mask_sample_logp_kernel<<<grid, kWarps * ddls::kWarpSize, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(mask),
      static_cast<const float*>(u), static_cast<int*>(action),
      static_cast<float*>(logp), rows, a);
  return static_cast<int>(cudaGetLastError());
}
