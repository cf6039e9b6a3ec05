// K3 masked_mean_pool_concat: per-graph masked mean of the node
// embeddings, written beside the graph embedding.
//
// Replaces ddls_tpu/ops/segment.py:masked_mean (segment.py:61) under the
// vmap of GNNPolicy.flat_batched (policy.py:140) and the concat that
// follows it (policy.py:144), which XLA compiled for the TPU:
//
//   out[b] = [sum_n mask[b, n] * emb[b, n] / max(sum_n mask[b, n], 1), graph_emb[b]]
//
// What bounds it on the H100: bytes (one multiply-add per float read). One
// block per graph: thread t owns feature t % f of node slice t / f, walks
// its nodes in order, and thread f' then adds the slices' partial sums in
// slice order, so the sum is the same bits on every run and the [B, 24]
// readout input is written once, with no separate concat pass.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
masked_mean_pool_concat_kernel(const float* __restrict__ emb,        // [B, n, f]
                               const float* __restrict__ node_mask,  // [B, n]
                               const float* __restrict__ graph_emb,  // [B, g]
                               float* __restrict__ out,              // [B, f + g]
                               int n_nodes, int f, int g) {
  __shared__ float part_s[kThreads];
  __shared__ float count_s[kThreads];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int slices = kThreads / f;
  const int slice = t / f;
  const int j = t - slice * f;
  const float* emb_b = emb + static_cast<size_t>(b) * n_nodes * f;
  const float* mask_b = node_mask + static_cast<size_t>(b) * n_nodes;
  float acc = 0.0f;
  float count = 0.0f;
  if (slice < slices) {
    for (int n = slice; n < n_nodes; n += slices) {
      const float m = mask_b[n];
      acc = __fadd_rn(acc, __fmul_rn(emb_b[static_cast<size_t>(n) * f + j], m));
      count = __fadd_rn(count, m);
    }
  }
  part_s[t] = acc;
  count_s[t] = count;
  __syncthreads();
  float* out_b = out + static_cast<size_t>(b) * (f + g);
  if (t < f) {
    float total = 0.0f;
    float n_real = 0.0f;
    for (int s = 0; s < slices; ++s) {
      total = __fadd_rn(total, part_s[s * f + t]);
      n_real = __fadd_rn(n_real, count_s[s * f + t]);
    }
    out_b[t] = __fdiv_rn(total, fmaxf(n_real, 1.0f));
  }
  for (int k = t; k < g; k += kThreads) {
    out_b[f + k] = graph_emb[static_cast<size_t>(b) * g + k];
  }
}

}  // namespace

DDLS_EXPORT int ddls_masked_mean_pool_concat(const void* emb,
                                             const void* node_mask,
                                             const void* graph_emb, void* out,
                                             int batch, int n_nodes, int f,
                                             int g, void* stream) {
  if (batch <= 0 || n_nodes <= 0 || f <= 0 || f > kThreads || g < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  masked_mean_pool_concat_kernel<<<batch, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(emb), static_cast<const float*>(node_mask),
      static_cast<const float*>(graph_emb), static_cast<float*>(out), n_nodes,
      f, g);
  return static_cast<int>(cudaGetLastError());
}
