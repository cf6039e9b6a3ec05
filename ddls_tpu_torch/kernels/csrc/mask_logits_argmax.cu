// K4 mask_logits_argmax: masked logits and the greedy action per row.
//
// Replaces ddls_tpu/models/policy.py:GNNPolicy._mask_logits (policy.py:87-92)
// and the host np.argmax the JAX server takes over its output
// (serve/server.py:669):
//
//   masked[r, i] = logits[r, i] + max(log(mask[r, i]), finfo(float32).min)
//   action[r]    = argmax_i masked[r, i], ties to the lowest index
//
// A masked logit is therefore finite (finfo.min + logit, which rounds to
// finfo.min for logits of ordinary size), exactly as the reference computes
// it, so a fully masked row still has an answer (index 0 when its masked
// logits all round to finfo.min). For the 0/1 masks the encoder emits,
// log(1) = 0 and log(0) = -inf are taken exactly.
//
// What bounds it on the H100: neither; at serving shapes ([8, 17]) it is one
// launch of a few hundred bytes, so its cost is launch latency. One warp per
// row: each lane keeps its first maximum over a strided pass, and a shuffle
// reduction keeps the larger value, or the lower index on a tie.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * ddls::kWarpSize)
mask_logits_argmax_kernel(const float* __restrict__ logits,  // [rows, a]
                          const int* __restrict__ mask,      // [rows, a]
                          float* __restrict__ masked,        // [rows, a]
                          long long* __restrict__ action,    // [rows]
                          int rows, int a) {
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= rows) return;
  float best = 0.0f;
  int best_i = -1;
  for (int i = lane; i < a; i += ddls::kWarpSize) {
    const size_t at = static_cast<size_t>(row) * a + i;
    const int m = mask[at];
    const float floor_term =
        m == 1 ? 0.0f : fmaxf(logf(static_cast<float>(m)), -FLT_MAX);
    const float v = __fadd_rn(logits[at], floor_term);
    masked[at] = v;
    if (best_i < 0 || v > best) {
      best = v;
      best_i = i;
    }
  }
#pragma unroll
  for (int offset = ddls::kWarpSize / 2; offset > 0; offset >>= 1) {
    const float other = __shfl_xor_sync(ddls::kFullMask, best, offset);
    const int other_i = __shfl_xor_sync(ddls::kFullMask, best_i, offset);
    if (other_i >= 0 &&
        (best_i < 0 || other > best || (other == best && other_i < best_i))) {
      best = other;
      best_i = other_i;
    }
  }
  if (lane == 0) action[row] = best_i;
}

}  // namespace

DDLS_EXPORT int ddls_mask_logits_argmax(const void* logits, const void* mask,
                                        void* masked, void* action, int rows,
                                        int a, void* stream) {
  if (rows <= 0 || a <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = ddls::grid_for(rows, kWarps);
  mask_logits_argmax_kernel<<<grid, kWarps * ddls::kWarpSize, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(mask),
      static_cast<float*>(masked), static_cast<long long*>(action), rows, a);
  return static_cast<int>(cudaGetLastError());
}
