// K20 minibatch_gather: a learner's minibatch as one flattened graph, from
// the staged trajectory's per-sample rows, in one launch.
//
// Replaces the shuffle gather of ddls_tpu/rl/ppo.py:343 (traj rows taken by
// a permutation) and the per-sample offsets of ddls_tpu/models/policy.py:
// 130-134 (node indices shifted by b * N into one mega-graph), which XLA
// compiled for the TPU, together with the host-built CSRs the port's
// forward and backward read.
//
// Inputs: the staged rows (Learner.stage_traj) node_features [S, N, Fn],
// edge_features [S, E, Fe], graph_features [S, G], action_mask [S, A] int32,
// node_mask [S, N] and structure [S, 4E + 2(N + 1)] int32, each sample's own
// flattened graph as [src E | edge_dst E | dst row_ptr N+1 | dst col E |
// src row_ptr N+1 | src col E]; idx [M] int64. Block m takes sample
// s = idx[m] and writes row m of every output:
//   * the feature, mask and action-mask rows, copied;
//   * src + m N and edge_dst + m N (edge_dst -1, a padded edge, kept);
//   * both CSRs re-based: row_ptr[m N + v] = local row_ptr[v] + start_m and
//     col[start_m + k] = local col[k] + m E for the sample's nnz real edges,
//     where start_m = sum of nnz over the samples before m (the block sums
//     them itself: integers, exact in any order), row_ptr[M N] the total;
//     entries of col past the total are 0 (each block zeroes the part of
//     [m E, (m + 1) E) at or past the total), as Learner._offset_csr and
//     ops/segment.py build_csr leave them.
// The result equals prepare_flat_batch of the same samples array for array.
//
// What bounds it on the H100: bytes (at pad (150, 512) and M = 128, ~2.2 MB
// read and ~2.2 MB written).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
minibatch_gather_kernel(
    const float* __restrict__ nf, const float* __restrict__ ef,
    const float* __restrict__ gf, const int* __restrict__ am,
    const float* __restrict__ nm, const int* __restrict__ structure,
    const long long* __restrict__ idx, float* __restrict__ nf_out,
    float* __restrict__ ef_out, float* __restrict__ gf_out,
    int* __restrict__ am_out, float* __restrict__ nm_out,
    int* __restrict__ src_out, int* __restrict__ edge_dst_out,
    int* __restrict__ ptr_out, int* __restrict__ col_out,
    int* __restrict__ s_ptr_out, int* __restrict__ s_col_out, int m_total,
    int n, int e, int fn, int fe, int g, int a) {
  __shared__ int red[2][kThreads / ddls::kWarpSize][2];
  const int m = blockIdx.x;
  const long long s = idx[m];
  const int width = 4 * e + 2 * (n + 1);
  const int dst_ptr = 2 * e;
  const int dst_col = dst_ptr + n + 1;
  const int src_ptr = dst_col + e;
  const int src_col = src_ptr + n + 1;
  // nnz before m and in all, for both CSRs
  int pre_d = 0, tot_d = 0, pre_s = 0, tot_s = 0;
  for (int j = threadIdx.x; j < m_total; j += kThreads) {
    const int* row = structure + idx[j] * width;
    const int nd = row[dst_ptr + n];
    const int ns = row[src_ptr + n];
    tot_d += nd;
    tot_s += ns;
    if (j < m) {
      pre_d += nd;
      pre_s += ns;
    }
  }
  int v[4] = {pre_d, tot_d, pre_s, tot_s};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int off = ddls::kWarpSize / 2; off > 0; off >>= 1) {
      v[q] += __shfl_xor_sync(ddls::kFullMask, v[q], off);
    }
  }
  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  if (lane == 0) {
    red[0][warp][0] = v[0];
    red[0][warp][1] = v[1];
    red[1][warp][0] = v[2];
    red[1][warp][1] = v[3];
  }
  __syncthreads();
  pre_d = tot_d = pre_s = tot_s = 0;
  for (int w = 0; w < kThreads / ddls::kWarpSize; ++w) {
    pre_d += red[0][w][0];
    tot_d += red[0][w][1];
    pre_s += red[1][w][0];
    tot_s += red[1][w][1];
  }

  const int* row = structure + s * width;
  const size_t nf_w = static_cast<size_t>(n) * fn;
  for (size_t i = threadIdx.x; i < nf_w; i += kThreads) {
    nf_out[m * nf_w + i] = nf[s * nf_w + i];
  }
  const size_t ef_w = static_cast<size_t>(e) * fe;
  for (size_t i = threadIdx.x; i < ef_w; i += kThreads) {
    ef_out[m * ef_w + i] = ef[s * ef_w + i];
  }
  for (int i = threadIdx.x; i < g; i += kThreads) {
    gf_out[static_cast<size_t>(m) * g + i] = gf[s * g + i];
  }
  for (int i = threadIdx.x; i < a; i += kThreads) {
    am_out[static_cast<size_t>(m) * a + i] = am[s * a + i];
  }
  const int node_off = m * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    nm_out[static_cast<size_t>(m) * n + i] = nm[s * n + i];
    ptr_out[node_off + i] = row[dst_ptr + i] + pre_d;
    s_ptr_out[node_off + i] = row[src_ptr + i] + pre_s;
  }
  if (m == m_total - 1 && threadIdx.x == 0) {
    ptr_out[m_total * n] = tot_d;
    s_ptr_out[m_total * n] = tot_s;
  }
  const int edge_off = m * e;
  const int nnz_d = row[dst_ptr + n];
  const int nnz_s = row[src_ptr + n];
  for (int k = threadIdx.x; k < e; k += kThreads) {
    src_out[edge_off + k] = row[k] + node_off;
    const int d = row[e + k];
    edge_dst_out[edge_off + k] = d >= 0 ? d + node_off : d;
    if (k < nnz_d) col_out[pre_d + k] = row[dst_col + k] + edge_off;
    if (k < nnz_s) s_col_out[pre_s + k] = row[src_col + k] + edge_off;
    const int p = edge_off + k;
    if (p >= tot_d) col_out[p] = 0;
    if (p >= tot_s) s_col_out[p] = 0;
  }
}

}  // namespace

DDLS_EXPORT int ddls_minibatch_gather(
    const void* nf, const void* ef, const void* gf, const void* am,
    const void* nm, const void* structure, const void* idx, void* nf_out,
    void* ef_out, void* gf_out, void* am_out, void* nm_out, void* src_out,
    void* edge_dst_out, void* ptr_out, void* col_out, void* s_ptr_out,
    void* s_col_out, int m, int n, int e, int fn, int fe, int g, int a,
    void* stream) {
  if (m <= 0 || n <= 0 || e <= 0 || fn <= 0 || fe <= 0 || g < 0 || a <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  minibatch_gather_kernel<<<m, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(nf), static_cast<const float*>(ef),
      static_cast<const float*>(gf), static_cast<const int*>(am),
      static_cast<const float*>(nm), static_cast<const int*>(structure),
      static_cast<const long long*>(idx), static_cast<float*>(nf_out),
      static_cast<float*>(ef_out), static_cast<float*>(gf_out),
      static_cast<int*>(am_out), static_cast<float*>(nm_out),
      static_cast<int*>(src_out), static_cast<int*>(edge_dst_out),
      static_cast<int*>(ptr_out), static_cast<int*>(col_out),
      static_cast<int*>(s_ptr_out), static_cast<int*>(s_col_out), m, n, e,
      fn, fe, g, a);
  return static_cast<int>(cudaGetLastError());
}
