// K2 csr_segment_mean: per-node mean over {self} U in-edges, destination
// sorted, without atomics.
//
// Replaces ddls_tpu/ops/segment.py:masked_segment_mean (segment.py:37, via
// masked_segment_sum at :17) as MeanPoolLayer calls it (gnn.py:96-99),
// which XLA compiled to a scatter-add for the TPU. For node v with in-edges
// csr(v) = col[row_ptr[v] .. row_ptr[v+1]) (ascending edge id):
//
//   out[v] = node_mask[v] * (sum_{e in csr(v)} msg[e] + self[v]) / (deg(v) + 1)
//
// summed in the reference's order: the edges in ascending id, then the
// self term, then one division. Masked edges never enter the CSR (it is
// built on the host, ddls_tpu_torch/ops/segment.py:build_csr), so the
// padded edges that point at node 0 contribute nothing.
//
// What bounds it on the H100: bytes (one add per float read). The design
// answers the port's other constraint, determinism: a float scatter-add
// with atomics (index_add_) sums in a different order each run, which
// would break "batching never changes an answer". One warp owns each
// destination node, its lanes span the features, and each lane walks the
// node's CSR slice in order, so the result is the same bits on every run.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * ddls::kWarpSize)
csr_segment_mean_kernel(const float* __restrict__ msg,       // [n_msg, f]
                        const float* __restrict__ self_msg,  // [n_nodes, f]
                        const int* __restrict__ row_ptr,     // [n_nodes + 1]
                        const int* __restrict__ col,         // [nnz]
                        const float* __restrict__ node_mask, // [n_nodes]
                        float* __restrict__ out,             // [n_nodes, f]
                        int n_nodes, int f) {
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int v = blockIdx.x * kWarps + warp;
  if (v >= n_nodes) return;
  const int begin = row_ptr[v];
  const int end = row_ptr[v + 1];
  const float denom = static_cast<float>(end - begin + 1);
  const float keep = node_mask[v];
  for (int j = lane; j < f; j += ddls::kWarpSize) {
    float acc = 0.0f;
    for (int e = begin; e < end; ++e) {
      acc = __fadd_rn(acc, msg[static_cast<size_t>(col[e]) * f + j]);
    }
    acc = __fadd_rn(acc, self_msg[static_cast<size_t>(v) * f + j]);
    out[static_cast<size_t>(v) * f + j] = __fmul_rn(__fdiv_rn(acc, denom), keep);
  }
}

}  // namespace

DDLS_EXPORT int ddls_csr_segment_mean(const void* msg, const void* self_msg,
                                      const void* row_ptr, const void* col,
                                      const void* node_mask, void* out,
                                      int n_nodes, int f, void* stream) {
  if (n_nodes <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = ddls::grid_for(n_nodes, kWarps);
  csr_segment_mean_kernel<<<grid, kWarps * ddls::kWarpSize, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(msg), static_cast<const float*>(self_msg),
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(node_mask), static_cast<float*>(out), n_nodes,
      f);
  return static_cast<int>(cudaGetLastError());
}
