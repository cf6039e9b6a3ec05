// K6 segment_bwd: the backward of the segment routines (K2's CSR mean, K3's
// pooling) and the transpose of K1's row gather. Three entry points:
//
//   * ddls_csr_segment_mean_bwd — backward of K2 (csr_segment_mean.cu),
//     replacing the backward of ddls_tpu/ops/segment.py:37
//     masked_segment_mean (with its extra self-message) and the node mask
//     of gnn.py:95. With d_tot[v] = (dOut[v] * mask[v]) / (deg(v) + 1), the
//     reference's order (the node mask is applied before the division):
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
//     columns passed through to d_graph. The mask must hold only 0 and 1
//     (every caller's does: it is made from the batch's boolean node
//     masks): the count is then exact in any order.
//
// What bounds them on the H100: the mean backward its bytes (the update's
// two calls write ~6.8 MB), the other two latency (a chain of dependent
// loads, a launch). The first design lost time to the element as its unit:
// a thread per output float with a 64-bit division for its row and four
// loads of the row's inputs, scalar stores; a whole warp a node over the
// columns, half of it idle at the message width 16; an 8-barrier tree to
// count at most 150 mask entries. This design takes a ROW as its unit. Each
// C entry plans its launch from the sizes and pointers (make_plan;
// ops/segment.py segment_bwd_plan mirrors it): V, the floats a lane moves
// at once (4: 16-byte loads and stores, where the width is a multiple of 4
// and every pointer the entry moves in vectors is 16-byte aligned, unless
// the caller forces 1; else 1, with the same bits), and the lanes of a
// row's group (the least power of two at least the row's V-float units,
// at most 32):
//   * the mean backward: a group a row of d_msg or d_self, which reads the
//     row's edge_dst, row_ptr pair and node mask once and dout[v] as
//     V-float vectors; the index arithmetic in 32 bits, no division per
//     element, the per-element arithmetic unchanged;
//   * the CSR sum keeps the first design, a warp a node, each lane adding
//     its columns over the node's edges in ascending edge id from 0.0f
//     (__fadd_rn): its time is each node's chain of dependent loads
//     (row_ptr, col, g), and on the H100 a group sized to the width took
//     3% longer at the update's calls, 8 edges' loads in flight 1% less;
//   * the pooling backward: a few warps a graph, each counting the mask
//     with shuffles (no barrier); a lane keeps one V-float column unit, so
//     it divides once per column, and writes its rows with V-float stores.
// Every sum runs in a fixed order, no float atomics: the same inputs give
// the same bits, the first design's bits.
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / ddls::kWarpSize;
// the pooling backward's warps a graph: enough that a lane writes about
// kPoolLaneRows rows, at most kPoolMaxWarps
constexpr int kPoolLaneRows = 4;
constexpr int kPoolMaxWarps = 8;

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load(const float* p) {
  Vec<V> out;
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out.v[0] = q.x;
    out.v[1] = q.y;
    out.v[2] = q.z;
    out.v[3] = q.w;
  } else {
    out.v[0] = *p;
  }
  return out;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Vec<V>& x) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  } else {
    *p = x.v[0];
  }
}

// groups of `lanes` lanes, a row (of the E edge rows, then the V node rows)
// a group; units = f / V vectors a row, the group's lanes over them
template <int V>
__global__ void __launch_bounds__(kThreads)
csr_segment_mean_bwd_kernel(const float* __restrict__ dout,     // [V, f]
                            const int* __restrict__ row_ptr,    // [V + 1]
                            const int* __restrict__ edge_dst,   // [E]
                            const float* __restrict__ node_mask,  // [V]
                            float* __restrict__ d_msg,          // [E, f]
                            float* __restrict__ d_self,         // [V, f]
                            int n_nodes, int n_edges, int f, int lanes) {
  const int per_block = kThreads / lanes;
  const int row = blockIdx.x * per_block + threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  if (row >= n_edges + n_nodes) return;
  const bool is_msg = row < n_edges;
  const int v = is_msg ? edge_dst[row] : row - n_edges;
  float* out = (is_msg ? d_msg + static_cast<size_t>(row) * f
                       : d_self + static_cast<size_t>(v) * f);
  const int units = f / V;
  Vec<V> g;
  if (v < 0) {
#pragma unroll
    for (int i = 0; i < V; ++i) g.v[i] = 0.0f;
    for (int u = lane; u < units; u += lanes) store<V>(out + u * V, g);
    return;
  }
  const float denom = static_cast<float>(row_ptr[v + 1] - row_ptr[v] + 1);
  const float m = node_mask[v];
  const float* in = dout + static_cast<size_t>(v) * f;
  for (int u = lane; u < units; u += lanes) {
    const Vec<V> d = load<V>(in + u * V);
#pragma unroll
    for (int i = 0; i < V; ++i) g.v[i] = __fdiv_rn(__fmul_rn(d.v[i], m), denom);
    store<V>(out + u * V, g);
  }
}

// a warp a node, its lanes over the columns
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

// `warps` warps a graph: warp w of graph b writes rows w * per + (lane's
// row in the pass), stepping warps * per rows, where per = 32 / units rows
// of `units` V-float units share a pass (a lane's unit is fixed); past 32
// units a lane takes units lane, lane + 32, ... over every row
template <int V>
__global__ void __launch_bounds__(kThreads)
masked_mean_pool_concat_bwd_kernel(const float* __restrict__ dout,
                                   const float* __restrict__ node_mask,
                                   float* __restrict__ d_emb,
                                   float* __restrict__ d_graph,
                                   int batch, int n_nodes, int f, int g,
                                   int warps) {
  // dout [B, f + g], node_mask [B, n], d_emb [B, n, f], d_graph [B, g]
  const int gw = blockIdx.x * kWarps + threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const int b = gw / warps;
  const int w = gw - b * warps;
  if (b >= batch) return;  // warp-uniform
  const float* mask_b = node_mask + static_cast<size_t>(b) * n_nodes;
  float count = 0.0f;
  for (int n = lane; n < n_nodes; n += ddls::kWarpSize) {
    count = __fadd_rn(count, mask_b[n]);
  }
  const float denom = fmaxf(ddls::warp_sum(count), 1.0f);
  const float* dout_b = dout + static_cast<size_t>(b) * (f + g);
  float* d_emb_b = d_emb + static_cast<size_t>(b) * n_nodes * f;
  const int units = f / V;
  const int per = units <= ddls::kWarpSize ? ddls::kWarpSize / units : 1;
  const int unit0 = units <= ddls::kWarpSize ? lane % units : lane;
  const int row0 = units <= ddls::kWarpSize ? lane / units : 0;
  if (row0 < per) {
    for (int u = unit0; u < units; u += ddls::kWarpSize) {
      Vec<V> q;
#pragma unroll
      for (int i = 0; i < V; ++i) q.v[i] = __fdiv_rn(dout_b[u * V + i], denom);
      for (int n = w * per + row0; n < n_nodes; n += warps * per) {
        const float m = mask_b[n];
        Vec<V> o;
#pragma unroll
        for (int i = 0; i < V; ++i) o.v[i] = __fmul_rn(q.v[i], m);
        store<V>(d_emb_b + static_cast<size_t>(n) * f + u * V, o);
      }
    }
  }
  if (w == 0) {
    for (int k = lane; k < g; k += ddls::kWarpSize) {
      d_graph[static_cast<size_t>(b) * g + k] = dout_b[f + k];
    }
  }
}

bool aligned16(std::initializer_list<const void*> ps) {
  for (const void* p : ps) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) != 0) return false;
  }
  return true;
}

enum Entry { kMeanBwd = 0, kSum = 1, kPool = 2 };

// A launch: vec floats a lane at once (1 or 4), group lanes a row (the
// mean backward, the CSR sum) or warps a graph (the pooling backward),
// blocks CTAs of kThreads threads
struct Plan {
  int vec, group, blocks;
};

// `rows` rows (E + V for the mean backward, V for the CSR sum, B graphs of
// `n_nodes` nodes for the pooling backward) at width f; vec_ok: every
// pointer the entry moves in vectors is 16-byte aligned and no form is
// forced
Plan make_plan(int entry, int f, int rows, int n_nodes, bool vec_ok) {
  Plan p;
  if (entry == kSum) {  // a warp a node, by the float
    p.vec = 1;
    p.group = ddls::kWarpSize;
    p.blocks = ddls::grid_for(rows, kWarps);
    return p;
  }
  p.vec = vec_ok && f % 4 == 0 ? 4 : 1;
  const int units = f / p.vec;
  if (entry == kPool) {
    const int per = units <= ddls::kWarpSize ? ddls::kWarpSize / units : 1;
    const int want = ddls::grid_for(n_nodes, kPoolLaneRows * per);
    p.group = want < 1 ? 1 : (want > kPoolMaxWarps ? kPoolMaxWarps : want);
    p.blocks = static_cast<int>(
        (static_cast<long long>(rows) * p.group + kWarps - 1) / kWarps);
  } else {
    p.group = 1;
    while (p.group < units && p.group < ddls::kWarpSize) p.group *= 2;
    p.blocks = ddls::grid_for(rows, kThreads / p.group);
  }
  return p;
}

}  // namespace

// The plan an entry takes (make_plan) at width f over `rows` rows (and
// `n_nodes` nodes a graph for the pooling backward) with its vector
// pointers aligned or not and the scalar form forced or not, packed as
// (blocks << 9) | (group << 3) | vec. Launches nothing: the tests hold
// ops/segment.py segment_bwd_plan against it.
DDLS_EXPORT int ddls_segment_bwd_plan(int entry, int f, int rows,
                                      int n_nodes, int aligned, int force,
                                      int* out) {
  if (entry < kMeanBwd || entry > kPool || f <= 0 || rows < 0 ||
      (entry == kPool && n_nodes <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(entry, f, rows, n_nodes, aligned && !force);
  if (p.blocks >= (1 << 22)) return static_cast<int>(cudaErrorInvalidValue);
  *out = (p.blocks << 9) | (p.group << 3) | p.vec;
  return 0;
}

// dout [V, f], row_ptr [V + 1], edge_dst [E] (-1 padded), node_mask [V];
// out d_msg [E, f], d_self [V, f]. force: 1 takes the scalar form.
DDLS_EXPORT int ddls_csr_segment_mean_bwd(const void* dout,
                                          const void* row_ptr,
                                          const void* edge_dst,
                                          const void* node_mask, void* d_msg,
                                          void* d_self, int n_nodes,
                                          int n_edges, int f, int force,
                                          void* stream) {
  if (n_nodes <= 0 || n_edges < 0 || f <= 0 ||
      static_cast<long long>(n_nodes) + n_edges >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(kMeanBwd, f, n_nodes + n_edges, 0,
                           !force && aligned16({dout, d_msg, d_self}));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel) {
    kernel<<<p.blocks, kThreads, 0, s>>>(
        static_cast<const float*>(dout), static_cast<const int*>(row_ptr),
        static_cast<const int*>(edge_dst),
        static_cast<const float*>(node_mask), static_cast<float*>(d_msg),
        static_cast<float*>(d_self), n_nodes, n_edges, f, p.group);
    return static_cast<int>(cudaGetLastError());
  };
  return p.vec == 4 ? go(csr_segment_mean_bwd_kernel<4>)
                    : go(csr_segment_mean_bwd_kernel<1>);
}

// g [rows, f], row_ptr [V + 1], col [>= nnz]; out [V, f].
DDLS_EXPORT int ddls_csr_segment_sum(const void* g, const void* row_ptr,
                                     const void* col, void* out, int n_nodes,
                                     int f, void* stream) {
  if (n_nodes <= 0 || f <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(kSum, f, n_nodes, 0, false);
  csr_segment_sum_kernel<<<p.blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(row_ptr),
      static_cast<const int*>(col), static_cast<float*>(out), n_nodes, f);
  return static_cast<int>(cudaGetLastError());
}

// dout [B, f + g], node_mask [B, n] (0 or 1 only); out d_emb [B, n, f],
// d_graph [B, g]. The vector form needs only d_emb aligned (dout is read
// by the float). force as ddls_csr_segment_mean_bwd's.
DDLS_EXPORT int ddls_masked_mean_pool_concat_bwd(const void* dout,
                                                 const void* node_mask,
                                                 void* d_emb, void* d_graph,
                                                 int batch, int n_nodes,
                                                 int f, int g, int force,
                                                 void* stream) {
  if (batch <= 0 || n_nodes <= 0 || f <= 0 || g < 0 ||
      static_cast<long long>(batch) * kPoolMaxWarps >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = make_plan(kPool, f, batch, n_nodes,
                           !force && aligned16({d_emb}));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel) {
    kernel<<<p.blocks, kThreads, 0, s>>>(
        static_cast<const float*>(dout), static_cast<const float*>(node_mask),
        static_cast<float*>(d_emb), static_cast<float*>(d_graph), batch,
        n_nodes, f, g, p.group);
    return static_cast<int>(cudaGetLastError());
  };
  return p.vec == 4 ? go(masked_mean_pool_concat_bwd_kernel<4>)
                    : go(masked_mean_pool_concat_bwd_kernel<1>);
}
