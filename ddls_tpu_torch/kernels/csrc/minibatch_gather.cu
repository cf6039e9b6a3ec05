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
// src row_ptr N+1 | src col E]; idx [M] int64. CTA m takes sample
// s = idx[m] and writes row m of every output:
//   * the feature, mask and action-mask rows, copied;
//   * src + m N and edge_dst + m N (edge_dst -1, a padded edge, kept);
//   * both CSRs re-based: row_ptr[m N + v] = local row_ptr[v] + start_m and
//     col[start_m + k] = local col[k] + m E for the sample's nnz real edges,
//     where start_m = sum of nnz over the samples before m, row_ptr[M N]
//     the total; entries of col past the total are 0, as
//     Learner._offset_csr and ops/segment.py build_csr leave them.
// The result equals prepare_flat_batch of the same samples array for array.
//
// What bounds it on the H100: bytes (at the update's (38, 128) bucket and
// M = 128, ~0.6 MB read and as much written) behind the chain of loads
// that gives start_m. The first design had every CTA of 256 threads sum
// the nnz of all M samples before any copy, then copy with 4-byte
// accesses. In this design a CTA's summing warps find start_m while its
// other warps copy everything that needs no prefix (the features, the
// masks, src and edge_dst), each array in 16-, 8- or 4-byte units as its
// base addresses and per-sample strides allow (chosen in the C entry and
// kept in the kernel's parameters, so a thread holds few registers), 4
// units in flight a thread; every thread also loads the sample's local
// row_ptr and col before the prefix is known, and after one barrier the
// CTA writes them re-based. The summing warps (one for each 128 samples,
// 256 past 256 samples; at most 16) add the nnz of all M samples (idx[j],
// then the sample's two counts, 4 samples a lane in flight, 8 past 256
// samples, the faster depths on the H100), so the CTA knows the total and
// those warps zero the col entries of its range [m E, (m + 1) E) at or
// past it, which no sample writes. No workspace, no fence, no atomic. The
// plan (gather_plan; models/policy.py minibatch_gather_plan mirrors it) is
// chosen in the C entry from the sizes. Each CTA still reads all M
// samples' counts (M^2 loads a call): they hide behind the copies at the
// sizes the port's callers send (M up to 512); at a few thousand rows they
// do not (PERF.md section 6).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
// copy units a thread has in flight
constexpr int kInFlight = 4;
// samples whose counts a summing lane has in flight: kShortAhead up to
// kShortRows samples, kLongAhead past; the most warps that sum
constexpr int kShortAhead = 4;
constexpr int kLongAhead = 8;
constexpr int kShortRows = 256;
constexpr int kMaxSumWarps = 16;
// row_ptr and col entries a thread loads before the prefix is known:
// kHeld passes of the CTA's threads (the rest it loads after); 4 spilled
// past the 64 registers a 1,024-thread bound allows and was slower on the
// H100 (PERF.md section 6)
constexpr int kHeld = 1;
constexpr int kSpans = 7;

// One array's copy: n 4-byte words a sample, from src + s * src_stride to
// dst + m * dst_stride, each word w written as w + m N where mode is 1 (2:
// a negative w kept), in units of 2^shift words and the n % 2^shift words
// after the last whole unit one a unit; first: its first unit in the CTA's
// run of every array's units.
struct Span {
  const int* src;
  int* dst;
  int src_stride, dst_stride, n, shift, first, mode;
};

struct Spans {
  Span q[kSpans];
  int units;  // of all arrays
};

// The copies that need no prefix, thread t of `copiers`: the features,
// the masks, src and edge_dst of sample s into row m, kInFlight units in
// flight
__device__ __forceinline__ void copy_rows(const Spans& spans, long long s,
                                          int m, int node_off, int t,
                                          int copiers) {
  for (int u0 = t; u0 < spans.units; u0 += kInFlight * copiers) {
    int4 r[kInFlight];
    int* to[kInFlight];
    int shift[kInFlight], add[kInFlight];
    bool keep_neg[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int u = u0 + k * copiers;
      to[k] = nullptr;
      if (u < spans.units) {
        int q = 0;
#pragma unroll
        for (int j = 1; j < kSpans; ++j) q += u >= spans.q[j].first;
        const Span& sp = spans.q[q];
        const int i = u - sp.first;
        const int body = sp.n >> sp.shift;
        // a whole unit's first word, or the single word of the tail
        const int word =
            i < body ? i << sp.shift : i + body * ((1 << sp.shift) - 1);
        const int* from = sp.src + s * sp.src_stride + word;
        to[k] = sp.dst + static_cast<size_t>(m) * sp.dst_stride + word;
        shift[k] = i < body ? sp.shift : 0;
        add[k] = sp.mode ? node_off : 0;
        keep_neg[k] = sp.mode == 2;
        if (shift[k] == 2) {
          r[k] = *reinterpret_cast<const int4*>(from);
        } else if (shift[k] == 1) {
          const int2 v = *reinterpret_cast<const int2*>(from);
          r[k] = make_int4(v.x, v.y, 0, 0);
        } else {
          r[k] = make_int4(*from, 0, 0, 0);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (to[k] == nullptr) continue;
      const auto map = [&](int w) {
        return keep_neg[k] && w < 0 ? w : w + add[k];
      };
      if (shift[k] == 2) {
        *reinterpret_cast<int4*>(to[k]) =
            make_int4(map(r[k].x), map(r[k].y), map(r[k].z), map(r[k].w));
      } else if (shift[k] == 1) {
        *reinterpret_cast<int2*>(to[k]) = make_int2(map(r[k].x), map(r[k].y));
      } else {
        *to[k] = map(r[k].x);
      }
    }
  }
}

// the prefix and totals from the summing warps' parts
__device__ __forceinline__ void add_parts(const int (*parts)[4],
                                          int sum_warps, int (&pre)[2],
                                          int (&tot)[2]) {
  pre[0] = pre[1] = tot[0] = tot[1] = 0;
  for (int w = 0; w < sum_warps; ++w) {
    pre[0] += parts[w][0];
    pre[1] += parts[w][1];
    tot[0] += parts[w][2];
    tot[1] += parts[w][3];
  }
}

template <int kAhead>
__global__ void __launch_bounds__(kMaxThreads)
minibatch_gather_kernel(
    const __grid_constant__ Spans spans, const int* __restrict__ structure,
    const long long* __restrict__ idx, int* __restrict__ ptr_out,
    int* __restrict__ col_out, int* __restrict__ s_ptr_out,
    int* __restrict__ s_col_out, int sum_warps, int m_total, int n, int e) {
  // the counts by summing warp
  __shared__ int parts[kMaxSumWarps][4];
  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long s = idx[m];
  const int width = 4 * e + 2 * (n + 1);
  const int dst_ptr = 2 * e;
  const int dst_col = dst_ptr + n + 1;
  const int src_ptr = dst_col + e;
  const int src_col = src_ptr + n + 1;
  const int* row = structure + s * width;
  const int node_off = m * n;
  const int edge_off = m * e;
  // the local row_ptr and col entries this thread re-bases after the sum
  int held_ptr[2][kHeld], held_col[2][kHeld];
#pragma unroll
  for (int h = 0; h < kHeld; ++h) {
    const int i = tid + h * nt;
    held_ptr[0][h] = i < n ? row[dst_ptr + i] : 0;
    held_ptr[1][h] = i < n ? row[src_ptr + i] : 0;
    held_col[0][h] = i < e ? row[dst_col + i] : 0;
    held_col[1][h] = i < e ? row[src_col + i] : 0;
  }

  const int nd = row[dst_ptr + n];
  const int ns = row[src_ptr + n];
  int pre[2], tot[2];
  const int warp = tid / ddls::kWarpSize;
  if (warp < sum_warps) {
    // the summing warps: kAhead samples a lane in flight (idx[j], then the
    // sample's two counts)
    int part[4] = {0, 0, 0, 0};  // before m and in all, each CSR
    for (int j0 = tid; j0 < m_total;
         j0 += kAhead * sum_warps * ddls::kWarpSize) {
      int d[kAhead], sv[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int j = j0 + k * sum_warps * ddls::kWarpSize;
        d[k] = sv[k] = 0;
        if (j < m_total) {
          const int* r = structure + idx[j] * width;
          d[k] = r[dst_ptr + n];
          sv[k] = r[src_ptr + n];
        }
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const bool before = j0 + k * sum_warps * ddls::kWarpSize < m;
        part[0] += before ? d[k] : 0;
        part[1] += before ? sv[k] : 0;
        part[2] += d[k];
        part[3] += sv[k];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      part[q] = __reduce_add_sync(ddls::kFullMask, part[q]);
    }
    if (tid % ddls::kWarpSize == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) parts[warp][q] = part[q];
    }
    // the summing warps meet (barrier 1), each adds the parts, and they
    // zero the col entries of this sample's range at or past each total
    // (no sample writes them) while the copies run
    asm volatile("bar.sync 1, %0;" ::"r"(sum_warps * ddls::kWarpSize)
                 : "memory");
    add_parts(parts, sum_warps, pre, tot);
    const int from_d = max(edge_off, tot[0]);
    const int from_s = max(edge_off, tot[1]);
    for (int p = from_d + tid; p < edge_off + e;
         p += sum_warps * ddls::kWarpSize) {
      col_out[p] = 0;
    }
    for (int p = from_s + tid; p < edge_off + e;
         p += sum_warps * ddls::kWarpSize) {
      s_col_out[p] = 0;
    }
  } else {  // the other warps: the copies
    copy_rows(spans, s, m, node_off, tid - sum_warps * ddls::kWarpSize,
              nt - sum_warps * ddls::kWarpSize);
  }
  __syncthreads();
  add_parts(parts, sum_warps, pre, tot);

  int* const ptr_outs[2] = {ptr_out, s_ptr_out};
  int* const col_outs[2] = {col_out, s_col_out};
  const int ptr_at[2] = {dst_ptr, src_ptr};
  const int col_at[2] = {dst_col, src_col};
  const int counts[2] = {nd, ns};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int at = pre[c];
    const int count = counts[c];
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int i = tid + h * nt;
      if (i < n) ptr_outs[c][node_off + i] = held_ptr[c][h] + at;
      if (i < count) col_outs[c][at + i] = held_col[c][h] + edge_off;
    }
    for (int i = tid + kHeld * nt; i < n; i += nt) {
      ptr_outs[c][node_off + i] = row[ptr_at[c] + i] + at;
    }
    for (int i = tid + kHeld * nt; i < count; i += nt) {
      col_outs[c][at + i] = row[col_at[c] + i] + edge_off;
    }
  }
  if (m == m_total - 1 && tid == 0) {
    ptr_out[m_total * n] = tot[0];
    s_ptr_out[m_total * n] = tot[1];
  }
}

// the unit (words, as a power of two) an array moves in: the widest that
// both base addresses and both per-sample strides (in words) allow
int unit_shift(const void* src, const void* dst, long long src_stride,
               long long dst_stride) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) |
                      reinterpret_cast<uintptr_t>(dst);
  const long long st = src_stride | dst_stride;
  if ((a & 15) == 0 && (st & 3) == 0) return 2;
  if ((a & 7) == 0 && (st & 1) == 0) return 1;
  return 0;
}

// A launch: the summing lanes' samples in flight (ahead), the summing
// warps (one for each ahead * 32 samples, at most kMaxSumWarps), threads a
// CTA (those and enough copying warps for about kInFlight two-word units a
// thread, at most the CTA's rest)
struct Plan {
  int ahead, sum_warps, threads;
};

Plan gather_plan(int m, int n, int e, int fn, int fe, int g, int a) {
  Plan p;
  p.ahead = m > kShortRows ? kLongAhead : kShortAhead;
  const int per_sum = p.ahead * ddls::kWarpSize;
  p.sum_warps = std::min((m + per_sum - 1) / per_sum, kMaxSumWarps);
  const long long words = static_cast<long long>(n) * fn +
                          static_cast<long long>(e) * fe + g + a + n + 2ll * e;
  const long long per_warp = 2ll * kInFlight * ddls::kWarpSize;
  const long long copy = std::min<long long>(
      std::max<long long>((words + per_warp - 1) / per_warp, 1),
      kMaxThreads / ddls::kWarpSize - p.sum_warps);
  p.threads = static_cast<int>(ddls::kWarpSize * (p.sum_warps + copy));
  return p;
}

bool bad_sizes(int m, int n, int e, int fn, int fe, int g, int a) {
  return m <= 0 || n <= 0 || e <= 0 || fn <= 0 || fe <= 0 || g < 0 ||
         a <= 0 || static_cast<long long>(m) * e >= (1ll << 31) ||
         static_cast<long long>(m) * n >= (1ll << 31) - 1 ||
         static_cast<long long>(n) * fn >= (1ll << 31) ||
         static_cast<long long>(e) * fe >= (1ll << 31);
}

}  // namespace

// The plan the entry takes (gather_plan) for m samples of the given sizes,
// packed as (threads << 10) | (ahead << 5) | sum_warps. Launches nothing:
// the tests hold models/policy.py minibatch_gather_plan against it.
DDLS_EXPORT int ddls_minibatch_gather_plan(int m, int n, int e, int fn,
                                           int fe, int g, int a, int* out) {
  if (bad_sizes(m, n, e, fn, fe, g, a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = gather_plan(m, n, e, fn, fe, g, a);
  *out = (p.threads << 10) | (p.ahead << 5) | p.sum_warps;
  return 0;
}

DDLS_EXPORT int ddls_minibatch_gather(
    const void* nf, const void* ef, const void* gf, const void* am,
    const void* nm, const void* structure, const void* idx, void* nf_out,
    void* ef_out, void* gf_out, void* am_out, void* nm_out, void* src_out,
    void* edge_dst_out, void* ptr_out, void* col_out, void* s_ptr_out,
    void* s_col_out, int m, int n, int e, int fn, int fe, int g, int a,
    void* stream) {
  if (bad_sizes(m, n, e, fn, fe, g, a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = gather_plan(m, n, e, fn, fe, g, a);
  const int width = 4 * e + 2 * (n + 1);
  const auto* st = static_cast<const int*>(structure);
  struct Array {
    const void* src;
    void* dst;
    int src_stride, dst_stride, n, mode;
  };
  const Array arrays[kSpans] = {
      {nf, nf_out, n * fn, n * fn, n * fn, 0},
      {ef, ef_out, e * fe, e * fe, e * fe, 0},
      {gf, gf_out, g, g, g, 0},
      {am, am_out, a, a, a, 0},
      {nm, nm_out, n, n, n, 0},
      {st, src_out, width, e, e, 1},           // src + m N
      {st + e, edge_dst_out, width, e, e, 2}};  // edge_dst, -1 kept
  Spans spans;
  spans.units = 0;
  for (int q = 0; q < kSpans; ++q) {
    Span& sp = spans.q[q];
    sp.src = static_cast<const int*>(arrays[q].src);
    sp.dst = static_cast<int*>(arrays[q].dst);
    sp.src_stride = arrays[q].src_stride;
    sp.dst_stride = arrays[q].dst_stride;
    sp.n = arrays[q].n;
    sp.shift = unit_shift(sp.src, sp.dst, sp.src_stride, sp.dst_stride);
    sp.first = spans.units;
    sp.mode = arrays[q].mode;
    spans.units += (sp.n >> sp.shift) + (sp.n & ((1 << sp.shift) - 1));
  }
  const auto go = [&](auto kernel) {
    kernel<<<m, p.threads, 0, static_cast<cudaStream_t>(stream)>>>(
        spans, st, static_cast<const long long*>(idx),
        static_cast<int*>(ptr_out), static_cast<int*>(col_out),
        static_cast<int*>(s_ptr_out), static_cast<int*>(s_col_out),
        p.sum_warps, m, n, e);
    return static_cast<int>(cudaGetLastError());
  };
  return p.ahead == kLongAhead ? go(minibatch_gather_kernel<kLongAhead>)
                               : go(minibatch_gather_kernel<kShortAhead>);
}
