// K27 memo_probe and K28 memo_insert: the device episode's lookahead memo,
// one set-associative table per lane, split around K21.
//
// Replace ddls_tpu/sim/jax_memo.py:201 memo_lookahead (with :167
// canonical_groups), which the reference runs inside eval_cfg
// (sim/jax_env.py:1064-1070) under lax.cond(action_ok, ...): both kernels
// touch a lane's table only where it evaluates a candidate (`active`).
//
// K27 (before K21), one CTA per lane: the key of the lane's candidate is
// (cfg, the canonical first-appearance groups of where(op_valid, ots, -1),
// the mounted dep times' bits). First appearance per server code is an
// integer atomicMin into shared memory (deterministic); a code's group is
// the number of codes that first appear before it. The hash is
// sum(payload * weights) over uint32 with wrap-around: integer addition
// is associative, so the block's tree gives the reference's bits, and the
// set is hash % n_sets. The compare of the full key against every way is
// bitwise over uint32 words (a float64 time is two words, low first, the
// order of bitcast_convert_type), spread over the block with one
// __syncthreads_and a way: -0.0 never matches 0.0 and NaN never matches.
// It writes the groups, the set, hit, the hit way, the stored (t, ok) and
// K21's skip = hit | !active. For a lane that is not active every output
// is zero (groups -1) and skip is set.
//
// K28 (after K21), one CTA per lane that is active: t and ok become the
// stored ones where K27 hit (written over K21's outputs in place); on a
// miss the key and the computed value go to way rr[set] % n_ways, rr
// moves on, and the eviction is counted if the way held a key. The hits,
// misses and evicts are per-lane integers (no atomics), traced per step
// when the caller asks.
//
// What bounds them on the H100: K27 reads a key (1 + N + Mw words: 13,553
// in float32 at N = 480, M = 13,072) and up to n_ways stored keys from
// HBM, ~160 KB a lane; K28 writes one key on a miss. Both are one CTA a
// lane, so at 2 lanes the card is latency-bound; the reads are coalesced.
#include "common.cuh"

namespace {

constexpr int kProbeThreads = 512;
constexpr int kInsertThreads = 256;

__device__ __forceinline__ unsigned warp_sum_u32(unsigned v) {
#pragma unroll
  for (int offset = ddls::kWarpSize / 2; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(ddls::kFullMask, v, offset);
  }
  return v;
}

struct Table {
  int* key_cfg;         // [B, S, W]
  int* key_groups;      // [B, S, W, N]
  unsigned* key_times;  // [B, S, W, Mw]
  void* val_t;          // [B, S, W]
  bool* val_ok;         // [B, S, W]
  int* rr;              // [B, S]
};

struct Probe {
  int* groups;  // [B, N]
  int* set;
  bool* hit;
  int* way;
  void* t;
  bool* ok;
  bool* skip;
};

template <typename T>
__global__ void __launch_bounds__(kProbeThreads) memo_probe_kernel(
    const int* __restrict__ cfg, const bool* __restrict__ active,
    const int* __restrict__ ots, const bool* __restrict__ op_valid,
    const unsigned* __restrict__ twords, Table tb,
    const unsigned* __restrict__ weights, Probe pr, int n, int m_words,
    int n_sets, int n_ways, int n_codes) {
  extern __shared__ int sh[];
  int* first = sh;           // [n_codes] first op index of each code
  int* rank = sh + n_codes;  // [n_codes] its group
  __shared__ unsigned s_part[kProbeThreads / ddls::kWarpSize];
  __shared__ int s_set, s_way;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* g_out = pr.groups + static_cast<size_t>(b) * n;
  if (!active[b]) {
    for (int i = tid; i < n; i += nt) g_out[i] = -1;
    if (tid == 0) {
      pr.set[b] = 0;
      pr.hit[b] = false;
      pr.way[b] = 0;
      static_cast<T*>(pr.t)[b] = static_cast<T>(0);
      pr.ok[b] = false;
      pr.skip[b] = true;
    }
    return;
  }
  const int c = cfg[b];
  const bool* valid = op_valid + static_cast<size_t>(c) * n;
  const int* o = ots + static_cast<size_t>(b) * n;
  const unsigned* tw = twords + static_cast<size_t>(b) * m_words;

  // canonical groups: first appearance per server code (code -1 -> 0)
  for (int k = tid; k < n_codes; k += nt) first[k] = n;
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    if (valid[i]) atomicMin(&first[o[i] + 1], i);
  }
  __syncthreads();
  for (int k = tid; k < n_codes; k += nt) {
    const int f = first[k];
    int r = -1;
    if (f < n) {
      r = 0;
      for (int k2 = 0; k2 < n_codes; ++k2) r += first[k2] < f ? 1 : 0;
    }
    rank[k] = r;
  }
  __syncthreads();

  // the groups and the hash of (cfg, groups, time words)
  unsigned acc = tid == 0 ? static_cast<unsigned>(c) * weights[0] : 0u;
  for (int i = tid; i < n; i += nt) {
    const int g = valid[i] ? rank[o[i] + 1] : -1;
    g_out[i] = g;
    acc += static_cast<unsigned>(g) * weights[1 + i];
  }
  for (int j = tid; j < m_words; j += nt) acc += tw[j] * weights[1 + n + j];
  acc = warp_sum_u32(acc);
  if ((tid & (ddls::kWarpSize - 1)) == 0) s_part[tid / ddls::kWarpSize] = acc;
  __syncthreads();
  if (tid == 0) {
    unsigned h = 0;
    for (int w = 0; w < nt / ddls::kWarpSize; ++w) h += s_part[w];
    s_set = static_cast<int>(h % static_cast<unsigned>(n_sets));
    s_way = -1;
  }
  __syncthreads();
  const int set = s_set;

  // the full key against every way, bitwise
  for (int w = 0; w < n_ways; ++w) {
    const size_t e = (static_cast<size_t>(b) * n_sets + set) * n_ways + w;
    bool eq = tb.key_cfg[e] == c;
    const int* kg = tb.key_groups + e * n;
    for (int i = tid; i < n && eq; i += nt) {
      eq = kg[i] == (valid[i] ? rank[o[i] + 1] : -1);
    }
    const unsigned* kt = tb.key_times + e * m_words;
    for (int j = tid; j < m_words && eq; j += nt) eq = kt[j] == tw[j];
    const int all = __syncthreads_and(eq ? 1 : 0);
    if (tid == 0 && all && s_way < 0) s_way = w;
  }
  if (tid == 0) {
    const bool hit = s_way >= 0;
    const int way = hit ? s_way : 0;
    const size_t e = (static_cast<size_t>(b) * n_sets + set) * n_ways + way;
    pr.set[b] = set;
    pr.hit[b] = hit;
    pr.way[b] = way;
    static_cast<T*>(pr.t)[b] = static_cast<const T*>(tb.val_t)[e];
    pr.ok[b] = tb.val_ok[e];
    pr.skip[b] = hit;
  }
}

template <typename T>
__global__ void __launch_bounds__(kInsertThreads) memo_insert_kernel(
    const int* __restrict__ cfg, const bool* __restrict__ active,
    const unsigned* __restrict__ twords, Probe pr, T* t_step, bool* ok_la,
    Table tb, int* hits, int* misses, int* evicts, int* tr_hits,
    int* tr_misses, int* tr_evicts, int n, int m_words, int n_sets,
    int n_ways, int t_stride, int cols, int d) {
  __shared__ long long s_entry;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  if (active[b]) {
    if (tid == 0) {
      const bool hit = pr.hit[b];
      T* t_at = t_step + static_cast<size_t>(b) * t_stride;
      const T t = hit ? static_cast<const T*>(pr.t)[b] : *t_at;
      const bool ok = hit ? pr.ok[b] : ok_la[b];
      *t_at = t;
      ok_la[b] = ok;
      s_entry = -1;
      if (hit) {
        hits[b] += 1;
      } else {
        const size_t at_rr = static_cast<size_t>(b) * n_sets + pr.set[b];
        const int way = tb.rr[at_rr] % n_ways;
        const size_t e = at_rr * n_ways + way;
        evicts[b] += tb.key_cfg[e] >= 0 ? 1 : 0;
        misses[b] += 1;
        tb.key_cfg[e] = cfg[b];
        static_cast<T*>(tb.val_t)[e] = t;
        tb.val_ok[e] = ok;
        tb.rr[at_rr] += 1;
        s_entry = static_cast<long long>(e);
      }
    }
    __syncthreads();
    if (s_entry >= 0) {
      const size_t e = static_cast<size_t>(s_entry);
      const int* g = pr.groups + static_cast<size_t>(b) * n;
      int* kg = tb.key_groups + e * n;
      for (int i = tid; i < n; i += nt) kg[i] = g[i];
      const unsigned* tw = twords + static_cast<size_t>(b) * m_words;
      unsigned* kt = tb.key_times + e * m_words;
      for (int j = tid; j < m_words; j += nt) kt[j] = tw[j];
    }
  }
  if (tid == 0 && tr_hits != nullptr) {
    const size_t at = static_cast<size_t>(b) * cols + d;
    tr_hits[at] = hits[b];
    tr_misses[at] = misses[b];
    tr_evicts[at] = evicts[b];
  }
}

}  // namespace

// cfg [B], active [B], ots [B, N] (server codes -1 .. n_srv - 1),
// op_valid [K, N], times [B, M] (of the type is_f64 names: Mw = M or 2M
// words), the table (key_cfg, key_groups, key_times as int32 words,
// val_t, val_ok, rr), the hash weights [1 + N + Mw]; out groups [B, N],
// set, hit, way, t, ok, skip [B].
DDLS_EXPORT int ddls_memo_probe(
    const void* cfg, const void* active, const void* ots,
    const void* op_valid, const void* times, void* key_cfg,
    void* key_groups, void* key_times, void* val_t, void* val_ok, void* rr,
    const void* weights, void* groups, void* set, void* hit, void* way,
    void* t, void* ok, void* skip, int lanes, int n, int m, int n_sets,
    int n_ways, int n_srv, int is_f64, void* stream) {
  if (lanes <= 0 || n < 1 || m < 1 || n_sets < 1 || n_ways < 1 ||
      n_srv < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // server codes: -1 (an op left unplaced) and 0 .. n_srv - 1
  const int n_codes = n_srv + 1;
  const size_t smem = 2 * sizeof(int) * n_codes;
  const Table tb{static_cast<int*>(key_cfg), static_cast<int*>(key_groups),
                 static_cast<unsigned*>(key_times), val_t,
                 static_cast<bool*>(val_ok), static_cast<int*>(rr)};
  const Probe pr{static_cast<int*>(groups), static_cast<int*>(set),
                 static_cast<bool*>(hit), static_cast<int*>(way), t,
                 static_cast<bool*>(ok), static_cast<bool*>(skip)};
  const int m_words = is_f64 ? 2 * m : m;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    memo_probe_kernel<double><<<lanes, kProbeThreads, smem, s>>>(
        static_cast<const int*>(cfg), static_cast<const bool*>(active),
        static_cast<const int*>(ots), static_cast<const bool*>(op_valid),
        static_cast<const unsigned*>(times), tb,
        static_cast<const unsigned*>(weights), pr, n, m_words, n_sets,
        n_ways, n_codes);
  } else {
    memo_probe_kernel<float><<<lanes, kProbeThreads, smem, s>>>(
        static_cast<const int*>(cfg), static_cast<const bool*>(active),
        static_cast<const int*>(ots), static_cast<const bool*>(op_valid),
        static_cast<const unsigned*>(times), tb,
        static_cast<const unsigned*>(weights), pr, n, m_words, n_sets,
        n_ways, n_codes);
  }
  return static_cast<int>(cudaGetLastError());
}

// cfg, active, times [B, M], K27's outputs, K21's t_step (every
// t_stride-th element, overwritten) and ok_la, the table and the per-lane
// counters hits, misses, evicts; the trace (memo_hits, memo_misses,
// memo_evicts [B, cols], column d; null for none).
DDLS_EXPORT int ddls_memo_insert(
    const void* cfg, const void* active, const void* times, void* groups,
    void* set, void* hit, void* way, void* t, void* ok, void* skip,
    void* t_step, void* ok_la, void* key_cfg, void* key_groups,
    void* key_times, void* val_t, void* val_ok, void* rr, void* hits,
    void* misses, void* evicts, void* tr_hits, void* tr_misses,
    void* tr_evicts, int lanes, int n, int m, int n_sets, int n_ways,
    int t_stride, int cols, int d, int is_f64, void* stream) {
  if (lanes <= 0 || n < 1 || m < 1 || n_sets < 1 || n_ways < 1 ||
      (tr_hits != nullptr && (d < 0 || d >= cols))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Table tb{static_cast<int*>(key_cfg), static_cast<int*>(key_groups),
                 static_cast<unsigned*>(key_times), val_t,
                 static_cast<bool*>(val_ok), static_cast<int*>(rr)};
  const Probe pr{static_cast<int*>(groups), static_cast<int*>(set),
                 static_cast<bool*>(hit), static_cast<int*>(way), t,
                 static_cast<bool*>(ok), static_cast<bool*>(skip)};
  const int m_words = is_f64 ? 2 * m : m;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    memo_insert_kernel<double><<<lanes, kInsertThreads, 0, s>>>(
        static_cast<const int*>(cfg), static_cast<const bool*>(active),
        static_cast<const unsigned*>(times), pr,
        static_cast<double*>(t_step), static_cast<bool*>(ok_la), tb,
        static_cast<int*>(hits), static_cast<int*>(misses),
        static_cast<int*>(evicts), static_cast<int*>(tr_hits),
        static_cast<int*>(tr_misses), static_cast<int*>(tr_evicts), n,
        m_words, n_sets, n_ways, t_stride, cols, d);
  } else {
    memo_insert_kernel<float><<<lanes, kInsertThreads, 0, s>>>(
        static_cast<const int*>(cfg), static_cast<const bool*>(active),
        static_cast<const unsigned*>(times), pr, static_cast<float*>(t_step),
        static_cast<bool*>(ok_la), tb, static_cast<int*>(hits),
        static_cast<int*>(misses), static_cast<int*>(evicts),
        static_cast<int*>(tr_hits), static_cast<int*>(tr_misses),
        static_cast<int*>(tr_evicts), n, m_words, n_sets, n_ways, t_stride,
        cols, d);
  }
  return static_cast<int>(cudaGetLastError());
}
