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
// summed in the reference's order: from 0.0f the edges in ascending id,
// then the self term, then one division, then the mask. Masked edges never
// enter the CSR (it is built on the host, ddls_tpu_torch/ops/segment.py:
// build_csr), so the padded edges that point at node 0 contribute nothing.
// A float scatter-add with atomics (index_add_) would sum in a different
// order each run and break "batching never changes an answer"; every
// element here is one lane's sum in that fixed order, the same bits on
// every run and in every form below.
//
// What bounds it on the H100: bytes (one add per float read) behind a
// chain of dependent loads a node (row_ptr, col, msg). The first design
// ran a warp a node with its lanes over the features and the edge loop
// nested inside the feature loop: at the update's message width 64 every
// lane walked the CSR twice, re-reading col and waiting on col -> msg for
// each edge. This design plans the launch from the width in the C entry
// (make_plan; ops/segment.py csr_segment_mean_plan mirrors it):
//   * a group of G lanes a node, G the least power of two at least the
//     row's floats, at most 32; a lane owns the floats lane, lane + G, ...
//     (C chunks, up to 8, held in registers), so it walks the node's CSR
//     once for all of them (past 8 chunks of a whole warp, once per 8);
//   * the group loads the node's col slice once, coalesced, a window at a
//     time, and hands each edge id out by __shfl_sync; a lane issues the
//     message loads of 4 edges (one chunk) or 2 (more) before it adds
//     them, in ascending edge order; the self row is loaded before the
//     walk; a warp of one node loops to a warp-uniform bound.
// A lane moves one float at a time: 16-byte units were slower on the H100
// at the widths the policy runs, 16 and 64 (PERF.md section 6).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxChunks = 8;

// kThreads / G nodes a CTA, G lanes a node; lane l of a node's group owns
// floats p + c * G + l (c < C) of each pass p over the row's f floats
template <int G, int C>
__global__ void __launch_bounds__(kThreads)
csr_segment_mean_kernel(const float* __restrict__ msg,       // [n_msg, f]
                        const float* __restrict__ self_msg,  // [n_nodes, f]
                        const int* __restrict__ row_ptr,     // [n_nodes + 1]
                        const int* __restrict__ col,         // [>= nnz]
                        const float* __restrict__ node_mask, // [n_nodes]
                        float* __restrict__ out,             // [n_nodes, f]
                        int n_nodes, int f) {
  // edges a batch (their loads issued before their adds), col entries a
  // lane holds a window, edges a window
  constexpr int kBatch = C == 1 ? 4 : 2;
  constexpr int kHeld = kBatch > G ? kBatch / G : 1;
  constexpr int kWindow = kHeld * G;
  constexpr bool kWarpNode = G == ddls::kWarpSize;
  const int lane = threadIdx.x % G;
  const int v = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  if (v >= n_nodes) return;  // the whole group
  // the group's lanes: the shuffles name only them (the groups of one
  // warp walk CSR slices of different lengths)
  const unsigned group_mask =
      kWarpNode ? ddls::kFullMask
                : ((1u << (G % ddls::kWarpSize)) - 1u)
                      << (threadIdx.x % ddls::kWarpSize / G * G);
  const int begin = row_ptr[v];
  const int deg = row_ptr[v + 1] - begin;
  // a warp of one node: a bound the compiler knows is warp-uniform
  const int span = kWarpNode ? __reduce_max_sync(ddls::kFullMask, deg) : deg;
  const float denom = static_cast<float>(deg + 1);
  const float keep = node_mask[v];
  const float* self_row = self_msg + static_cast<size_t>(v) * f;
  float* out_row = out + static_cast<size_t>(v) * f;
  for (int pass = 0; pass < f; pass += G * C) {
    float self[C], acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = pass + c * G + lane;
      if (u < f) self[c] = self_row[u];
      acc[c] = 0.0f;
    }
    for (int o = 0; o < span; o += kWindow) {
      int held[kHeld];
#pragma unroll
      for (int k = 0; k < kHeld; ++k) {
        const int e = o + k * G + lane;
        held[k] = e < deg ? col[begin + e] : 0;
      }
#pragma unroll
      for (int b0 = 0; b0 < kWindow; b0 += kBatch) {
        if (o + b0 >= span) break;  // the whole group
        float m[kBatch][C];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int w = b0 + j;
          const int edge =
              G == 1 ? held[w]
                     : __shfl_sync(group_mask, held[w / G], w % G, G);
          const float* row = msg + static_cast<size_t>(edge) * f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int u = pass + c * G + lane;
            m[j][c] = o + w < deg && u < f ? row[u] : 0.0f;
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (o + b0 + j < deg) {
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], m[j][c]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int u = pass + c * G + lane;
      if (u < f) {
        out_row[u] =
            __fmul_rn(__fdiv_rn(__fadd_rn(acc[c], self[c]), denom), keep);
      }
    }
  }
}

// A launch: group lanes a node, chunks floats a lane a pass, blocks CTAs
// of kThreads threads
struct Plan {
  int group, chunks, blocks;
};

Plan make_plan(int f, int n_nodes) {
  Plan p;
  p.group = 1;
  while (p.group < f && p.group < ddls::kWarpSize) p.group *= 2;
  p.chunks = 1;
  while (p.chunks < kMaxChunks && p.group * p.chunks < f) p.chunks *= 2;
  p.blocks = ddls::grid_for(n_nodes, kThreads / p.group);
  return p;
}

// the kernel of a plan (past one float a lane, a whole warp a node)
template <typename Go>
cudaError_t launch_plan(const Plan& p, Go go) {
  switch (p.chunks) {
    case 2: return go(csr_segment_mean_kernel<32, 2>);
    case 4: return go(csr_segment_mean_kernel<32, 4>);
    case kMaxChunks: return go(csr_segment_mean_kernel<32, kMaxChunks>);
    default: break;
  }
  switch (p.group) {
    case 1: return go(csr_segment_mean_kernel<1, 1>);
    case 2: return go(csr_segment_mean_kernel<2, 1>);
    case 4: return go(csr_segment_mean_kernel<4, 1>);
    case 8: return go(csr_segment_mean_kernel<8, 1>);
    case 16: return go(csr_segment_mean_kernel<16, 1>);
    default: return go(csr_segment_mean_kernel<32, 1>);
  }
}

}  // namespace

// The plan the entry takes (make_plan) at width f over n_nodes nodes,
// packed as (blocks << 10) | (chunks << 6) | group. Launches nothing: the
// tests hold ops/segment.py csr_segment_mean_plan against it.
DDLS_EXPORT int ddls_csr_segment_mean_plan(int f, int n_nodes, int* out) {
  if (f <= 0 || n_nodes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(f, n_nodes);
  if (p.blocks >= (1 << 21)) return static_cast<int>(cudaErrorInvalidValue);
  *out = (p.blocks << 10) | (p.chunks << 6) | p.group;
  return 0;
}

// msg [n_msg, f], self_msg [n_nodes, f], row_ptr [n_nodes + 1], col
// [>= nnz], node_mask [n_nodes]; out [n_nodes, f].
DDLS_EXPORT int ddls_csr_segment_mean(const void* msg, const void* self_msg,
                                      const void* row_ptr, const void* col,
                                      const void* node_mask, void* out,
                                      int n_nodes, int f, void* stream) {
  if (n_nodes <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(f, n_nodes);
  const auto go = [&](auto kernel) {
    kernel<<<p.blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(msg), static_cast<const float*>(self_msg),
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const float*>(node_mask), static_cast<float*>(out),
        n_nodes, f);
    return cudaGetLastError();
  };
  return static_cast<int>(launch_plan(p, go));
}
