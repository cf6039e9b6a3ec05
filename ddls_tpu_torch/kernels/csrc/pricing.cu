// K24 price_and_score: dep pricing and the SRPT lookahead scores of one
// placed job per lane.
//
// Replaces ddls_tpu/sim/jax_env.py:606 jax_price_and_score and :564
// _jnp_all_reduce_time. Per lane:
//  1. the flow mask (valid, size > 0, source and destination on other
//     servers) and each flow's channel (pair_channel, the direct link);
//  2. candidate collective groups: symmetric iff the multiset of the valid
//     edges' source servers equals that of their destination servers (the
//     reference sorts both and compares; two per-group histograms over the
//     server codes are the same test without a sort); the distinct comm
//     groups, racks and servers among the present servers price the RAMP
//     hierarchical all-reduce; asymmetric groups' edges fall back to
//     one-to-one times; then the 2-edge sync pairs and the static
//     one-to-one edges, each stage overwriting the one before;
//  3. every valid dep's SRPT rank in one stable descending order of the
//     priced times (the reference's lexsort: the key -time, then the edge
//     index), -0.0 read as 0.0, NaN after +inf;
//  4. each op's SRPT rank among the ops of its server (compute cost
//     descending, insertion order breaking ties);
//  5. the scores pri * (n + 1) + (n - sorted_rank), the mounted times (zero
//     where not a flow) and the finite check.
// Arithmetic as XLA compiles the reference on the CPU, in float32 and
// float64: `prop + 2 io + size / rate` is one fused multiply-add by the
// constant's reciprocal, and so are the scores (the float32 products pass
// 2**24 at 13,072 deps); every other operation rounds on its own. The
// file is built with -fmad=false (kernels/__init__.py EXTRA_FLAGS), so
// nvcc contracts nothing on its own; the fused ones are __fma_rn /
// __fmaf_rn.
//
// What bounds it on the H100: latency, and the sort. The bytes it must
// move (the lane's config rows, ~0.5 MB at M = 13,072 deps, and the five
// outputs) take ~0.2 us at 3.35 TB/s. The design:
//  * a lane's valid deps and ops are the prefixes [0, n_deps[c]) and
//    [0, n_ops[c]) of its config rows (device_env.stack_config_tables
//    lays them out so), and only those are priced, sorted and ranked; the
//    padded tail is written as the reference leaves it (time 0, no flow,
//    channel -1, the score's fused multiply-add with priority 0);
//  * a lane runs on a thread-block cluster of G CTAs (1 <= G <= 16, the
//    wrapper's choice from the number of lanes, so that lanes x G fills
//    the card's SMs with at most a short second wave,
//    kernels.choose_cluster). CTA r owns the r-th chunk of
//    ceil(m_c / G) valid deps and 1/G of the ops; the collective groups
//    are dealt out g = r, r + G, ...; the sync pairs and one-to-one edges
//    i = r, r + G, .... The priced times go to the `times` output, read
//    back with L2 loads after the cluster barrier that ends each stage;
//  * each CTA sorts its chunk's (order-preserving key, index) pairs in
//    shared memory (bitonic, next_pow2(chunk) slots: 55 stages at 1,024
//    slots against 105 at 16,384 on one CTA), then copies the other CTAs'
//    sorted keys through distributed shared memory; a dep's rank is its
//    place in its own chunk plus, in every other chunk, the keys below it
//    (binary search). The chunks are index ranges, so a lower chunk's equal
//    keys count and a higher chunk's do not: exactly the (key, index)
//    order, any G giving the same ranks;
//  * the trap: the reference sorts all M slots, and a valid dep whose time
//    is NaN (key 0xff...fe) sorts after the M - m_c invalid slots (key of
//    +inf), so its rank counts them; ranking the prefix alone adds them
//    back (no other valid key exceeds +inf's, and a valid dep of time
//    -inf ties with them and comes first by index);
//  * integer atomics only, no float atomics; the finite check is an
//    integer AND into CTA 0's shared memory.
#include <cmath>

#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

template <typename T>
struct Fp;

template <>
struct Fp<float> {
  using Bits = unsigned int;
  __device__ static unsigned long long key(float x) {
    if (x != x) return 0xfffffffffffffffeULL;  // NaN after +inf
    if (x == 0.0f) x = 0.0f;                   // -0.0 reads as 0.0
    const Bits b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  __device__ static float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  __device__ static float frexp_(float x, int* e) { return frexpf(x, e); }
};

template <>
struct Fp<double> {
  using Bits = unsigned long long;
  __device__ static unsigned long long key(double x) {
    if (x != x) return 0xfffffffffffffffeULL;
    if (x == 0.0) x = 0.0;
    const Bits b = static_cast<Bits>(__double_as_longlong(x));
    return (b & 0x8000000000000000ULL) ? ~b : (b | 0x8000000000000000ULL);
  }
  __device__ static double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  __device__ static double frexp_(double x, int* e) { return frexp(x, e); }
};

template <typename T>
__device__ T tmin(T a, T b) {
  return b < a ? b : a;
}

// ceil(log2(x)), exact, for x >= 1
template <typename T>
__device__ T ceil_log2(T x) {
  int e;
  const T m = Fp<T>::frexp_(x, &e);
  return static_cast<T>(m == static_cast<T>(0.5) ? e - 1 : e);
}

struct Comm {
  double x, x_floor, data_per_tx, prop_io, inv_rate;
};

// the reference's _jnp_all_reduce_time, operation by operation
template <typename T>
__device__ T all_reduce_time(T msg, T n_servers, T n_racks, T n_cgs,
                             const Comm& cm) {
  const T x = static_cast<T>(cm.x);
  const T subs[4] = {n_cgs, tmin(n_cgs, n_servers), n_racks,
                     ceil(n_servers / x)};
  T sizes[4];
  sizes[0] = ceil(msg / subs[0]);
  for (int i = 1; i < 4; ++i) sizes[i] = ceil(sizes[i - 1] / subs[i]);
  const T two = static_cast<T>(2.0);
  T comm = 0, comp = 0;
  for (int step = 0; step < 4; ++step) {
    const T sub = subs[step];
    const bool live = sub > static_cast<T>(1);
    const T safe = live ? sub : two;
    const T n_op = ceil_log2(safe);
    const T n_bytes = (safe + static_cast<T>(1)) * two;
    const T ai = n_op / n_bytes;
    const T total_ops = n_op * (sizes[step] * safe / safe) / two;
    const T add_t = total_ops / tmin(static_cast<T>(2e12) * ai,
                                     static_cast<T>(130e12));
    comp = comp + (live ? add_t : static_cast<T>(0));
    const T spare = tmin(static_cast<T>(cm.x_floor),
                         floor(x / (safe - static_cast<T>(1)))) -
                    static_cast<T>(1);
    const T bw = (static_cast<T>(1) + spare) * static_cast<T>(cm.data_per_tx);
    comm = comm + (live ? static_cast<T>(cm.prop_io) + sizes[step] / bw
                        : static_cast<T>(0));
  }
  return two * comm + comp;
}

template <typename T>
__device__ T one_to_one_time(bool same, T size, const Comm& cm) {
  if (same || size == static_cast<T>(0)) return static_cast<T>(0);
  return Fp<T>::fma(size, static_cast<T>(cm.inv_rate),
                    static_cast<T>(cm.prop_io));
}

struct Tables {
  const int *n_ops, *n_deps;
  const bool* op_valid;
  const void* op_compute;
  const int *op_sorted_rank, *insertion_rank;
  const bool* dep_valid;
  const int *dep_src, *dep_dst;
  const void* dep_size;
  const int* dep_sorted_rank;
  const bool* grp_valid;
  const int *grp_edges, *grp_u, *grp_v;
  const bool* grp_edge_valid;
  const void* grp_msg;
  const bool* sync_valid;
  const int *sync_edges, *sync_u, *sync_v;
  const void* sync_msg;
  const bool* o2o_valid;
  const int* o2o_edges;
  const int* pair_channel;
};

// the padded sizes, and the cluster: G CTAs a lane, each sorting at most
// `chunk_max` deps in `p_max` (a power of two) slots and keeping a copy of
// the other G - 1 chunks' sorted keys
struct Dims {
  int n, m, groups, group_edges, n_sync, n_o2o, C, R, S, G, chunk_max,
      p_max;
};

constexpr unsigned long long kNanKey = 0xfffffffffffffffeULL;
constexpr unsigned long long kPadKey = 0xffffffffffffffffULL;

// one CTA's dynamic shared memory, carved in this order by the kernel
template <typename T>
size_t smem_bytes(const Dims& dm) {
  const size_t n_srv = static_cast<size_t>(dm.C) * dm.R * dm.S;
  return static_cast<size_t>(dm.p_max) * 8 +
         static_cast<size_t>(dm.G - 1) * dm.chunk_max * 8 +
         static_cast<size_t>(dm.n + dm.groups) * sizeof(T) +
         (static_cast<size_t>(dm.n) * 2 + dm.groups * n_srv * 2 +
          dm.groups) * 4 +
         static_cast<size_t>(dm.p_max) * 2 + dm.n + 16;
}

// the sorted keys[0, len) below `key`, or (`equal`) not above it
__device__ int count_below(const unsigned long long* keys, int len,
                           unsigned long long key, bool equal) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned long long k = keys[mid];
    if (k < key || (equal && k == key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) price_and_score_kernel(
    const int* __restrict__ ots, const int* __restrict__ cfg, Tables tb,
    T* times, bool* __restrict__ is_flow, int* __restrict__ chan,
    T* __restrict__ op_score, T* __restrict__ dep_score,
    bool* __restrict__ finite_ok, Dims dm, Comm cm) {
  ddls::cg::cluster_group cluster = ddls::cg::this_cluster();
  const int G = dm.G;
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_srv = dm.C * dm.R * dm.S;
  extern __shared__ unsigned long long smem_keys[];
  unsigned long long* s_key = smem_keys;                   // [p_max]
  unsigned long long* s_rkey = s_key + dm.p_max;  // [(G - 1) chunk_max]
  T* s_cost = reinterpret_cast<T*>(
      s_rkey + static_cast<size_t>(G - 1) * dm.chunk_max);  // [N]
  T* s_grp_time = s_cost + dm.n;                             // [groups]
  int* s_sc = reinterpret_cast<int*>(s_grp_time + dm.groups);  // [N]
  int* s_ins = s_sc + dm.n;                                    // [N]
  int* s_hist = s_ins + dm.n;                        // [groups * n_srv]
  int* s_present = s_hist + dm.groups * n_srv;       // [groups * n_srv]
  int* s_sym = s_present + dm.groups * n_srv;        // [groups]
  unsigned short* s_idx =
      reinterpret_cast<unsigned short*>(s_sym + dm.groups);    // [p_max]
  unsigned char* s_valid =
      reinterpret_cast<unsigned char*>(s_idx + dm.p_max);      // [N]
  __shared__ int s_finite;

  const int lane = blockIdx.x / G;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int c = cfg[lane];
  const int n = dm.n, m = dm.m;
  const size_t cn = static_cast<size_t>(c) * n;
  const size_t cm_ = static_cast<size_t>(c) * m;
  const T* op_compute = static_cast<const T*>(tb.op_compute) + cn;
  const T* dep_size = static_cast<const T*>(tb.dep_size) + cm_;
  const bool* dep_valid = tb.dep_valid + cm_;
  const int* dep_src = tb.dep_src + cm_;
  const int* dep_dst = tb.dep_dst + cm_;
  const int* dep_rank = tb.dep_sorted_rank + cm_;
  ots += static_cast<size_t>(lane) * n;
  times += static_cast<size_t>(lane) * m;
  is_flow += static_cast<size_t>(lane) * m;
  chan += static_cast<size_t>(lane) * m;
  dep_score += static_cast<size_t>(lane) * m;
  op_score += static_cast<size_t>(lane) * n;
  // the valid prefixes, and this CTA's chunk [lo, lo + len) of the deps
  const int m_c = min(max(tb.n_deps[c], 0), m);
  const int n_c = min(max(tb.n_ops[c], 0), n);
  const int chunk = (m_c + G - 1) / G;
  const int lo = min(rank * chunk, m_c);
  const int len = min(chunk, m_c - lo);
  const T md = static_cast<T>(tb.n_deps[c]);

  for (int i = tid; i < n; i += nt) {
    s_sc[i] = ots[i];
    s_cost[i] = op_compute[i];
    s_ins[i] = tb.insertion_rank[cn + i];
    s_valid[i] = tb.op_valid[cn + i];
  }
  for (int i = tid; i < dm.groups * n_srv; i += nt) {
    s_hist[i] = 0;
    s_present[i] = 0;
  }
  if (tid == 0) s_finite = 1;
  __syncthreads();

  // 1. the chunk's flow mask and channels, raw times zero; this CTA's
  // share of the padded tail written as it ends
  for (int jj = tid; jj < len; jj += nt) {
    const int j = lo + jj;
    const int src = max(s_sc[max(dep_src[j], 0)], 0);
    const int dst = max(s_sc[max(dep_dst[j], 0)], 0);
    const bool flow = dep_valid[j] && dep_size[j] > static_cast<T>(0) &&
                      src != dst;
    is_flow[j] = flow;
    chan[j] = flow ? tb.pair_channel[src * n_srv + dst] : -1;
    times[j] = static_cast<T>(0);
  }
  for (int j = m_c + rank * nt + tid; j < m; j += G * nt) {
    is_flow[j] = false;
    chan[j] = -1;
    times[j] = static_cast<T>(0);
    dep_score[j] = Fp<T>::fma(static_cast<T>(0), md + static_cast<T>(1),
                              md - static_cast<T>(dep_rank[j]));
  }
  cluster.sync();

  // 2a. the owned groups' histograms and present servers
  const size_t cg = static_cast<size_t>(c) * dm.groups;
  const size_t cge = cg * dm.group_edges;
  const int owned = rank < dm.groups ? (dm.groups - rank + G - 1) / G : 0;
  for (int i = tid; i < owned * dm.group_edges; i += nt) {
    const int g = rank + G * (i / dm.group_edges);
    const size_t k = cge + static_cast<size_t>(g) * dm.group_edges +
                     i % dm.group_edges;
    if (!tb.grp_edge_valid[k]) continue;
    const int u = max(s_sc[max(tb.grp_u[k], 0)], 0);
    const int v = max(s_sc[max(tb.grp_v[k], 0)], 0);
    atomicAdd(&s_hist[g * n_srv + u], 1);
    atomicSub(&s_hist[g * n_srv + v], 1);
    s_present[g * n_srv + min(u, n_srv - 1)] = 1;
    s_present[g * n_srv + min(v, n_srv - 1)] = 1;
  }
  __syncthreads();
  // 2b. per owned group: symmetric, span counts, all-reduce time
  for (int gi = tid; gi < owned; gi += nt) {
    const int g = rank + G * gi;
    bool sym = tb.grp_valid[cg + g];
    int n_in = 0;
    unsigned long long hit_s = 0, hit_r = 0, hit_c = 0;
    for (int s = 0; s < n_srv; ++s) {
      sym = sym && s_hist[g * n_srv + s] == 0;
      if (s_present[g * n_srv + s]) {
        ++n_in;
        hit_s |= 1ULL << (s % dm.S);
        hit_r |= 1ULL << ((s / dm.S) % dm.R);
        hit_c |= 1ULL << (s / (dm.R * dm.S));
      }
    }
    const T one = static_cast<T>(1);
    const T cs = static_cast<T>(__popcll(hit_s));
    const T cr = static_cast<T>(__popcll(hit_r));
    const T cc = static_cast<T>(__popcll(hit_c));
    const T msg = static_cast<const T*>(tb.grp_msg)[cg + g];
    const T t = all_reduce_time<T>(msg, cs > one ? cs : one,
                                   cr > one ? cr : one, cc > one ? cc : one,
                                   cm);
    s_grp_time[g] = n_in <= 1 ? static_cast<T>(0) : t;
    s_sym[g] = sym;
  }
  __syncthreads();
  // 2c. the owned groups' edges (an edge past the prefix is never a flow:
  // its mounted time is 0 whatever is priced)
  for (int i = tid; i < owned * dm.group_edges; i += nt) {
    const int g = rank + G * (i / dm.group_edges);
    const size_t k = cge + static_cast<size_t>(g) * dm.group_edges +
                     i % dm.group_edges;
    if (!tb.grp_edge_valid[k]) continue;
    const int e = tb.grp_edges[k];
    if (e < 0 || e >= m_c) continue;
    const int u = max(s_sc[max(tb.grp_u[k], 0)], 0);
    const int v = max(s_sc[max(tb.grp_v[k], 0)], 0);
    times[e] = s_sym[g] ? s_grp_time[g]
                        : one_to_one_time<T>(u == v, dep_size[e], cm);
  }
  cluster.sync();
  // 2d. sync pairs
  const size_t cs_ = static_cast<size_t>(c) * dm.n_sync;
  for (int i = rank + G * tid; i < dm.n_sync; i += G * nt) {
    if (!tb.sync_valid[cs_ + i]) continue;
    const int u = max(s_sc[max(tb.sync_u[cs_ + i], 0)], 0);
    const int v = max(s_sc[max(tb.sync_v[cs_ + i], 0)], 0);
    T t = static_cast<T>(0);
    if (u != v) {
      const T one = static_cast<T>(1), two = static_cast<T>(2);
      const int S = dm.S, R = dm.R;
      t = all_reduce_time<T>(static_cast<const T*>(tb.sync_msg)[cs_ + i],
                             u % S == v % S ? one : two,
                             (u / S) % R == (v / S) % R ? one : two,
                             u / (R * S) == v / (R * S) ? one : two, cm);
    }
    for (int k = 0; k < 2; ++k) {
      const int e = tb.sync_edges[(cs_ + i) * 2 + k];
      if (e >= 0 && e < m_c) times[e] = t;
    }
  }
  cluster.sync();
  // 2e. static one-to-one edges
  const size_t co = static_cast<size_t>(c) * dm.n_o2o;
  for (int i = rank + G * tid; i < dm.n_o2o; i += G * nt) {
    if (!tb.o2o_valid[co + i]) continue;
    const int e = tb.o2o_edges[co + i];
    if (e < 0 || e >= m_c) continue;
    const int src = max(s_sc[max(dep_src[e], 0)], 0);
    const int dst = max(s_sc[max(dep_dst[e], 0)], 0);
    times[e] = one_to_one_time<T>(src == dst, dep_size[e], cm);
  }
  cluster.sync();

  // 3. the chunk's stable ascending sort of (key, index): key(-time), or
  // +inf's for an invalid slot
  int P = 1;
  while (P < len) P <<= 1;
  for (int p = tid; p < P; p += nt) {
    unsigned long long key = kPadKey;
    if (p < len) {
      const int j = lo + p;
      key = dep_valid[j] ? Fp<T>::key(-__ldcg(times + j))
                         : Fp<T>::key(static_cast<T>(INFINITY));
    }
    s_key[p] = key;
    s_idx[p] = static_cast<unsigned short>(p);
  }
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int q = tid; q < P / 2; q += nt) {
        const int i = 2 * q - (q & (jj - 1));  // bit jj of i clear
        const int l = i + jj;
        const unsigned long long ki = s_key[i], kl = s_key[l];
        const unsigned short ii = s_idx[i], il = s_idx[l];
        const bool greater = ki > kl || (ki == kl && ii > il);
        if (greater == ((i & k) == 0)) {
          s_key[i] = kl;
          s_key[l] = ki;
          s_idx[i] = il;
          s_idx[l] = ii;
        }
      }
      __syncthreads();
    }
  }
  cluster.sync();
  // the other chunks' sorted keys, through distributed shared memory
  for (int t = tid; t < (G - 1) * chunk; t += nt) {
    const int qq = t / chunk;
    const int off = t - qq * chunk;
    const int q = qq < rank ? qq : qq + 1;
    if (off < min(chunk, m_c - min(q * chunk, m_c))) {
      s_rkey[t] = cluster.map_shared_rank(s_key, q)[off];
    }
  }
  __syncthreads();
  // 4. each dep's rank among all M slots, staged in dep_score
  for (int p = tid; p < len; p += nt) {
    const unsigned long long key = s_key[p];
    int r = p;
    for (int qq = 0; qq < G - 1; ++qq) {
      const int q = qq < rank ? qq : qq + 1;
      r += count_below(s_rkey + qq * chunk,
                       min(chunk, m_c - min(q * chunk, m_c)), key, q < rank);
    }
    if (key == kNanKey) r += m - m_c;
    dep_score[lo + s_idx[p]] = static_cast<T>(r);
  }
  __syncthreads();
  // SRPT dep priorities (rank), flows only; then the scores
  bool finite = true;
  for (int jj = tid; jj < len; jj += nt) {
    const int j = lo + jj;
    const bool flow = is_flow[j];
    const T pri = flow ? dep_score[j] : static_cast<T>(0);
    dep_score[j] = Fp<T>::fma(pri, md + static_cast<T>(1),
                              md - static_cast<T>(dep_rank[j]));
    const T mounted = flow ? __ldcg(times + j) : static_cast<T>(0);
    times[j] = mounted;
    finite = finite && isfinite(mounted);
  }
  if (!finite) atomicAnd(cluster.map_shared_rank(&s_finite, 0), 0);
  // 5. SRPT op priorities within each server, over the valid ops
  const T nd = static_cast<T>(tb.n_ops[c]);
  const int* op_rank = tb.op_sorted_rank + cn;
  const int op_chunk = (n + G - 1) / G;
  const int op_hi = min(n, (rank + 1) * op_chunk);
  for (int i = rank * op_chunk + tid; i < op_hi; i += nt) {
    const int sc = s_sc[i];
    int pri = 0;
    if (sc >= 0) {
      const T cost = s_cost[i];
      const int ins = s_ins[i];
      for (int k = 0; k < n_c; ++k) {
        if (s_sc[k] != sc || !s_valid[k]) continue;
        if (s_cost[k] > cost || (s_cost[k] == cost && s_ins[k] < ins)) ++pri;
      }
    }
    op_score[i] = Fp<T>::fma(static_cast<T>(pri), nd + static_cast<T>(1),
                             nd - static_cast<T>(op_rank[i]));
  }
  cluster.sync();
  if (rank == 0 && tid == 0) finite_ok[lane] = s_finite;
}

// the cluster's sizes for padded sizes n, m and cluster size G
Dims dims_for(int n, int m, int groups, int group_edges, int n_sync,
              int n_o2o, int C, int R, int S, int G) {
  const int chunk_max = (m + G - 1) / G;
  int p_max = 1;
  while (p_max < chunk_max) p_max <<= 1;
  return Dims{n, m, groups, group_edges, n_sync, n_o2o, C, R, S, G,
              chunk_max, p_max};
}

bool dims_ok(int n, int m, int groups, int group_edges, int n_sync,
             int n_o2o, int C, int R, int S, int G) {
  return n >= 1 && m >= 1 && m <= 65535 && groups >= 1 &&
         group_edges >= 1 && n_sync >= 1 && n_o2o >= 1 && C >= 1 &&
         R >= 1 && S >= 1 && C <= 64 && R <= 64 && S <= 64 && G >= 1 &&
         G <= ddls::kMaxCluster;
}

template <typename T>
int launch(const int* ots, const int* cfg, const Tables& tb, void* times,
           void* is_flow, void* chan, void* op_score, void* dep_score,
           void* finite_ok, int lanes, const Dims& dm, const Comm& cm,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(dm);
  cudaError_t err =
      ddls::prepare_cluster(price_and_score_kernel<T>, dm.G, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  ddls::cluster_config(&config, &attr, lanes, dm.G, kThreads, smem, stream);
  err = cudaLaunchKernelEx(
      &config, price_and_score_kernel<T>, ots, cfg, tb,
      static_cast<T*>(times), static_cast<bool*>(is_flow),
      static_cast<int*>(chan), static_cast<T*>(op_score),
      static_cast<T*>(dep_score), static_cast<bool*>(finite_ok), dm, cm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int max_clusters(const Dims& dm, int* out) {
  const size_t smem = smem_bytes<T>(dm);
  cudaError_t err =
      ddls::prepare_cluster(price_and_score_kernel<T>, dm.G, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  ddls::cluster_config(&config, &attr, 1, dm.G, kThreads, smem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, price_and_score_kernel<T>, &config));
}

}  // namespace

// ots [B, N] int32, cfg [B] int32; the config tables in
// device_env.PRICING_TABLES order, then pair_channel [n_srv, n_srv]; the
// outputs times [B, M] (mounted), is_flow [B, M] bools, chan [B, M] int32,
// op_score [B, N], dep_score [B, M], finite_ok [B] bools; the sizes and
// the cluster size G (1-16 CTAs a lane); the constants x, rate, prop + 2
// io and rate / x (doubles, cast to the float type in the kernel, as the
// reference's weak-typed Python floats are).
DDLS_EXPORT int ddls_price_and_score(
    const void* ots, const void* cfg, const void* n_ops, const void* n_deps,
    const void* op_valid, const void* op_compute, const void* op_sorted_rank,
    const void* insertion_rank, const void* dep_valid, const void* dep_src,
    const void* dep_dst, const void* dep_size, const void* dep_sorted_rank,
    const void* grp_valid, const void* grp_edges, const void* grp_u,
    const void* grp_v, const void* grp_edge_valid, const void* grp_msg,
    const void* sync_valid, const void* sync_edges, const void* sync_u,
    const void* sync_v, const void* sync_msg, const void* o2o_valid,
    const void* o2o_edges, const void* pair_channel, void* times,
    void* is_flow, void* chan, void* op_score, void* dep_score,
    void* finite_ok, int lanes, int n, int m, int groups, int group_edges,
    int n_sync, int n_o2o, int C, int R, int S, int G, double x,
    double rate, double prop_io, double data_per_tx, int is_f64,
    void* stream) {
  if (lanes <= 0 ||
      !dims_ok(n, m, groups, group_edges, n_sync, n_o2o, C, R, S, G)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables tb{
      static_cast<const int*>(n_ops), static_cast<const int*>(n_deps),
      static_cast<const bool*>(op_valid), op_compute,
      static_cast<const int*>(op_sorted_rank),
      static_cast<const int*>(insertion_rank),
      static_cast<const bool*>(dep_valid), static_cast<const int*>(dep_src),
      static_cast<const int*>(dep_dst), dep_size,
      static_cast<const int*>(dep_sorted_rank),
      static_cast<const bool*>(grp_valid), static_cast<const int*>(grp_edges),
      static_cast<const int*>(grp_u), static_cast<const int*>(grp_v),
      static_cast<const bool*>(grp_edge_valid), grp_msg,
      static_cast<const bool*>(sync_valid),
      static_cast<const int*>(sync_edges), static_cast<const int*>(sync_u),
      static_cast<const int*>(sync_v), sync_msg,
      static_cast<const bool*>(o2o_valid), static_cast<const int*>(o2o_edges),
      static_cast<const int*>(pair_channel)};
  const Dims dm =
      dims_for(n, m, groups, group_edges, n_sync, n_o2o, C, R, S, G);
  const double inv_rate_f64 = 1.0 / rate;
  const float inv_rate_f32 = 1.0f / static_cast<float>(rate);
  const Comm cm{x, std::floor(x), data_per_tx, prop_io,
                is_f64 ? inv_rate_f64 : static_cast<double>(inv_rate_f32)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return launch<double>(static_cast<const int*>(ots),
                          static_cast<const int*>(cfg), tb, times, is_flow,
                          chan, op_score, dep_score, finite_ok, lanes, dm, cm,
                          s);
  }
  return launch<float>(static_cast<const int*>(ots),
                       static_cast<const int*>(cfg), tb, times, is_flow, chan,
                       op_score, dep_score, finite_ok, lanes, dm, cm, s);
}

// How many clusters of G CTAs of K24 at these sizes the device runs at
// once (cudaOccupancyMaxActiveClusters), into *out; the wrapper's choice
// of G reads it. Launches nothing.
DDLS_EXPORT int ddls_price_and_score_clusters(int n, int m, int groups,
                                              int group_edges, int n_sync,
                                              int n_o2o, int C, int R, int S,
                                              int G, int is_f64, void* out) {
  if (!dims_ok(n, m, groups, group_edges, n_sync, n_o2o, C, R, S, G)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims dm =
      dims_for(n, m, groups, group_edges, n_sync, n_o2o, C, R, S, G);
  int* clusters = static_cast<int*>(out);
  return is_f64 ? max_clusters<double>(dm, clusters)
                : max_clusters<float>(dm, clusters);
}
