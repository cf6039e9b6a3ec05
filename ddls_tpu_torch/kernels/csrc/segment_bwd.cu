// K6 segment_bwd: the backward of the segment routines (K2's CSR mean, K3's
// pooling) and the transpose of K1's row gather. Three entry points:
//
//   * ddls_csr_segment_mean_bwd — backward of K2 (csr_segment_mean.cu),
//     replacing the backward of ddls_tpu/ops/segment.py:37
//     masked_segment_mean (with its extra self-message) and the node mask
//     of gnn.py:95. With d_tot[v] = (dOut[v] * mask[v]) / (deg(v) + 1), the
//     reference's order (the node mask is applied after the division):
//     d_msg[e] = d_tot[dst[e]] for a real edge, 0 for a padded one
//     (edge_dst[e] < 0), and d_self[v] = d_tot[v].
//   * ddls_csr_segment_sum — out[u] = sum of g[e] over the real edges e
//     with src[e] == u, along the SOURCE-sorted CSR (build_csr of src), in
//     ascending edge id: the transpose of K1's gather a[idx] (gnn.py:89),
//     with no atomics.
//   * ddls_masked_mean_pool_concat_bwd — backward of K3
//     (masked_mean_pool_concat.cu), replacing the backward of
//     ddls_tpu/ops/segment.py:61 masked_mean under the vmap and the concat
//     of policy.py:140-144: d_emb[b, n] = (dPool[b] / count_b) * mask[b, n]
//     with count_b = max(sum_n mask[b, n], 1), and the graph-embedding
//     columns passed through to d_graph.
//
// What bounds them on the H100: bytes. Each is a gather or a broadcast
// (no reuse to exploit), so the design is one coalesced pass: a thread per
// output element for the mean backward, a warp per node (lanes along the
// features) for the CSR sum, a block per graph for the pooling backward.
// Every sum runs in a fixed order, so the same inputs give the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / ddls::kWarpSize;

__global__ void __launch_bounds__(kThreads)
csr_segment_mean_bwd_kernel(const float* __restrict__ dout,     // [V, f]
                            const int* __restrict__ row_ptr,    // [V + 1]
                            const int* __restrict__ edge_dst,   // [E]
                            const float* __restrict__ node_mask,  // [V]
                            float* __restrict__ d_msg,          // [E, f]
                            float* __restrict__ d_self,         // [V, f]
                            int n_nodes, int n_edges, int f) {
  const size_t n_msg = static_cast<size_t>(n_edges) * f;
  const size_t total = n_msg + static_cast<size_t>(n_nodes) * f;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const bool is_msg = i < n_msg;
    const size_t j = is_msg ? i : i - n_msg;
    const int row = static_cast<int>(j / f);
    const int col = static_cast<int>(j - static_cast<size_t>(row) * f);
    const int v = is_msg ? edge_dst[row] : row;
    float g = 0.0f;
    if (v >= 0) {
      const float denom = static_cast<float>(row_ptr[v + 1] - row_ptr[v] + 1);
      g = __fdiv_rn(__fmul_rn(dout[static_cast<size_t>(v) * f + col],
                              node_mask[v]),
                    denom);
    }
    if (is_msg) {
      d_msg[j] = g;
    } else {
      d_self[j] = g;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
csr_segment_sum_kernel(const float* __restrict__ g,        // [rows, f]
                       const int* __restrict__ row_ptr,    // [V + 1]
                       const int* __restrict__ col,        // [>= nnz]
                       float* __restrict__ out,            // [V, f]
                       int n_nodes, int f) {
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int u = blockIdx.x * kWarps + warp;
  if (u >= n_nodes) return;
  const int begin = row_ptr[u];
  const int end = row_ptr[u + 1];
  for (int j = lane; j < f; j += ddls::kWarpSize) {
    float acc = 0.0f;
    for (int e = begin; e < end; ++e) {
      acc = __fadd_rn(acc, g[static_cast<size_t>(col[e]) * f + j]);
    }
    out[static_cast<size_t>(u) * f + j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
masked_mean_pool_concat_bwd_kernel(const float* __restrict__ dout,
                                   const float* __restrict__ node_mask,
                                   float* __restrict__ d_emb,
                                   float* __restrict__ d_graph,
                                   int n_nodes, int f, int g) {
  // dout [B, f + g], node_mask [B, n], d_emb [B, n, f], d_graph [B, g]
  __shared__ float count_s[kThreads];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* mask_b = node_mask + static_cast<size_t>(b) * n_nodes;
  float count = 0.0f;
  for (int n = t; n < n_nodes; n += kThreads) {
    count = __fadd_rn(count, mask_b[n]);
  }
  count_s[t] = count;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) count_s[t] = __fadd_rn(count_s[t], count_s[t + stride]);
    __syncthreads();
  }
  const float denom = fmaxf(count_s[0], 1.0f);
  const float* dout_b = dout + static_cast<size_t>(b) * (f + g);
  float* d_emb_b = d_emb + static_cast<size_t>(b) * n_nodes * f;
  for (int i = t; i < n_nodes * f; i += kThreads) {
    const int n = i / f;
    const int j = i - n * f;
    d_emb_b[i] = __fmul_rn(__fdiv_rn(dout_b[j], denom), mask_b[n]);
  }
  for (int k = t; k < g; k += kThreads) {
    d_graph[static_cast<size_t>(b) * g + k] = dout_b[f + k];
  }
}

}  // namespace

DDLS_EXPORT int ddls_csr_segment_mean_bwd(const void* dout,
                                          const void* row_ptr,
                                          const void* edge_dst,
                                          const void* node_mask, void* d_msg,
                                          void* d_self, int n_nodes,
                                          int n_edges, int f, void* stream) {
  if (n_nodes <= 0 || n_edges < 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t total =
      (static_cast<size_t>(n_edges) + static_cast<size_t>(n_nodes)) * f;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 65535 ? want : 65535);
  csr_segment_mean_bwd_kernel<<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<const int*>(row_ptr),
      static_cast<const int*>(edge_dst), static_cast<const float*>(node_mask),
      static_cast<float*>(d_msg), static_cast<float*>(d_self), n_nodes,
      n_edges, f);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_csr_segment_sum(const void* g, const void* row_ptr,
                                     const void* col, void* out, int n_nodes,
                                     int f, void* stream) {
  if (n_nodes <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  csr_segment_sum_kernel<<<ddls::grid_for(n_nodes, kWarps), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(row_ptr),
      static_cast<const int*>(col), static_cast<float*>(out), n_nodes, f);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_masked_mean_pool_concat_bwd(const void* dout,
                                                 const void* node_mask,
                                                 void* d_emb, void* d_graph,
                                                 int batch, int n_nodes,
                                                 int f, int g, void* stream) {
  if (batch <= 0 || n_nodes <= 0 || f <= 0 || g < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  masked_mean_pool_concat_bwd_kernel<<<batch, kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dout), static_cast<const float*>(node_mask),
      static_cast<float*>(d_emb), static_cast<float*>(d_graph), n_nodes, f,
      g);
  return static_cast<int>(cudaGetLastError());
}
