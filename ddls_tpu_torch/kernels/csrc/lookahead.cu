// K21 lookahead: the array lookahead engine's tick loop, one thread-block
// cluster per lane, the whole loop inside the kernel (one launch per call,
// whatever the number of ticks).
//
// Replaces ddls_tpu/sim/jax_lookahead.py:313 jax_lookahead (a
// lax.while_loop that XLA compiled, vmapped over lanes at :457). Per lane,
// each tick of the reference's `body` (:357-426):
//  1. readiness, snapshotted before this tick's completions: an op is
//     ready when valid, not done and all its non-mutual parents are done;
//     a dep when valid, not done and its source op is done;
//  2. per worker, the best score of its ready ops; EVERY ready op whose
//     score equals its worker's best is selected (float ties select all of
//     them, as `per_worker == best_score` does), and only if the best > 0;
//  3. per channel, the best score of the ready flow deps over all L
//     channel columns; a flow dep is nominated if its score is >= the best
//     on any of its channels and > 0;
//  4. the tick is the smaller of the shortest selected op and the comm
//     bound (0 if any non-flow dep is ready, else the shortest nominated
//     dep); a tick >= BIG means the lane is stuck (ok = false);
//  5. the selected ops advance, then the ready non-flow deps if there are
//     any, else ALL ready flow deps (the reference's parallel-flow hack);
//  6. non-mutual completed deps add one to their child's parent count;
//  7. comp_oh, comm_oh, busy += tick * #selected and t accumulate, in that
//     order.
// The loop stops when every valid op and dep is done, when stuck, or after
// N + E + 4 ticks of the padded sizes; ok = finished && !stuck. A lane whose
// `skip` flag is set (the reference's `skip`, :316,325-335,355; a null
// `skip` sets none) runs no tick and returns its initial accumulators.
//
// Two entries: the per-lane one reads every input with a leading lane
// axis; the indexed one (the device env's) reads the config tables'
// rows through `cfg` (op_compute as op_remaining, op_valid, num_parents,
// dep_valid, dep_src, dep_dst, dep_mutual) and makes op_worker from the
// placement (`ots` where the op is valid, else -1), so the episode
// gathers nothing a step.
//
// What bounds it on the H100: latency, not bytes or operations. Each tick
// is a few passes over the lane's ops and deps with a data-dependent trip
// count (tens to hundreds of ticks), each pass ending in a barrier. The
// bytes it must move are the inputs read once and 6 numbers a lane
// written; the card could move them in microseconds. What the design does
// about it:
//  * extent: a setup pass finds each lane's last valid op and dep (the
//    episode's valid slots are a prefix; the padded builder's last valid
//    index is exact whatever the layout), and the ticks walk only up to
//    them;
//  * a lane runs on a cluster of G CTAs (1 <= G <= 16; the wrapper takes
//    4 unless told otherwise); a lane of at most kClusterMinDeps
//    deps runs on its first CTA alone, with block barriers, and the others
//    leave at once (a cluster barrier costs ~1,400 cycles on the H100, and
//    two a tick outweigh the share of a small lane's work they save).
//    Every CTA keeps a copy of all the lane's ops (at most a few hundred)
//    and runs the op side of each tick on it, the same bits in every
//    copy: readiness, the per-worker bests, the selection, the shortest
//    selected op, the advance. CTA r owns the r-th chunk of the lane's
//    deps. Each CTA keeps its op copy, its deps' mutable state (remaining
//    times, flags) and the fields each pass reads (score, source,
//    destination, channels as their table slots, flow, mutual) in shared
//    memory where they fit: each lane carves the shared memory launched
//    for its own extents and keeps in global memory, as one CTA a lane
//    did, the groups that do not fit (a lane of ~8,000 deps or more on
//    one CTA: its dep fields); nothing is routed to another path;
//  * a dep's readiness reads its source op in the CTA's own copy; a
//    completed dep adds one to its child's parent count in every copy (G
//    integer atomics over DSMEM);
//  * the per-channel bests are one table spread over the cluster (channel
//    c in CTA c % G), in shared memory where the whole two-row table of a
//    lane on one CTA (2 C entries) fits beside the rest, else in the
//    lane's workspace (the same layout; read around L1, updated with the
//    same atomics, so the same bits), reduced with order-preserving
//    integer max over DSMEM
//    (max and min are exact in any order, so an order-preserving float ->
//    int encoding makes them deterministic; scores of -1 are negative, so
//    not a plain bit cast; in float64 the 64-bit max and min are
//    compare-and-swap loops, cluster.cuh cluster_max). The minima over
//    remaining times key every NaN below -inf, and the tick and the
//    advance's clamp keep a NaN, so a NaN time propagates as the
//    reference's jnp.min, jnp.minimum and jnp.maximum do; the shortest
//    nominated dep, the flags and the completions are integer atomics into
//    CTA 0's shared memory. Tables and counters are double-buffered by
//    tick parity, so a tick takes two cluster barriers (the kernel's
//    comment at lookahead_kernel says which phase each orders); every
//    thread computes the tick from the same values (the same bits
//    everywhere) and CTA 0's thread 0 the accumulators, in the reference's
//    order. There is no float atomic anywhere;
//  * bit equality: every accumulation is written with explicit rounding
//    (__fadd_rn and friends), so nvcc contracts nothing on its own. In
//    float32, busy + tick * count is one fused multiply-add (__fmaf_rn),
//    as XLA's CPU compiler contracts it in the reference (rounding twice
//    leaves the recorded lanes' busy a float32 step off); in float64 the
//    product and the sum round apart, as the C++ engine computes them.
//    The kernel equals its plain PyTorch version bit for bit at every G,
//    and in float32 the JAX engine's answers.
// The kernel is a template on the float type: float32 (the simulator's
// entry points, as the reference's arrays are float32) and float64 (the
// reference's x64 mode).
#include "cluster.cuh"
#include "common.cuh"

namespace {

constexpr float kBig = 3.4e38f;  // the reference's BIG (float32, also x64)
// threads a CTA at most: 512 leave 128 registers a thread and no spills
// (at 1,024 the tick loop spills and a tick took ~20% longer on the H100)
constexpr int kMaxThreads = 512;

template <typename T>
struct Num;

template <>
struct Num<float> {
  using Ord = int;
  // order-preserving: a < b  <=>  enc(a) < enc(b) (for non-NaN, with -0
  // below +0)
  __device__ static Ord enc(float f) {
    const int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7fffffff;
  }
  __device__ static float dec(Ord i) {
    return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
  }
  // a minimum's key: enc, every NaN (either sign) below -inf, so that a
  // minimum over remaining times is NaN when any operand is, as jnp.min
  // and torch.amin are; dec of the lowest key is a NaN
  __device__ static Ord min_key(float f) {
    return f != f ? static_cast<Ord>(0x80000000u) : enc(f);
  }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  // busy + tick * count: fused, as XLA computes it
  __device__ static float busy_step(float busy, float tick, float count) {
    return __fmaf_rn(tick, count, busy);
  }
};

template <>
struct Num<double> {
  using Ord = long long;
  __device__ static Ord enc(double f) {
    const long long i = __double_as_longlong(f);
    return i >= 0 ? i : i ^ 0x7fffffffffffffffLL;
  }
  __device__ static double dec(Ord i) {
    return __longlong_as_double(i >= 0 ? i : i ^ 0x7fffffffffffffffLL);
  }
  __device__ static Ord min_key(double f) {
    return f != f ? static_cast<Ord>(0x8000000000000000ull) : enc(f);
  }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  // busy + tick * count: rounded apart, as the C++ engine computes it
  __device__ static double busy_step(double busy, double tick, double count) {
    return __dadd_rn(busy, __dmul_rn(tick, count));
  }
};

// op / dep flags of the tick
constexpr unsigned char kReady = 1;     // op ready
constexpr unsigned char kSelected = 2;  // op selected
constexpr unsigned char kFlow = 1;      // dep ready, flow
constexpr unsigned char kNonFlow = 2;   // dep ready, non-flow

// The thirteen inputs; the table fields (op_remaining, op_valid,
// num_parents, dep_valid, dep_src, dep_dst, dep_mutual) are read at row
// cfg[lane] when `cfg` is given (the indexed entry, which makes op_worker
// from `ots`), else at row lane.
struct Inputs {
  const void* op_remaining;
  const bool* op_valid;
  const int* op_worker;
  const void* op_score;
  const int* num_parents;
  const void* dep_remaining;
  const bool* dep_valid;
  const int* dep_src;
  const int* dep_dst;
  const bool* dep_mutual;
  const bool* dep_is_flow;
  const void* dep_score;
  const int* dep_channel;
  const int* cfg;
  const int* ots;
  const bool* skip;
};

struct Outputs {
  void* vals;  // [B, 4]: t, comm, comp, busy
  bool* ok;
  int* ticks;
};

// The sizes, the cluster, and which groups of a CTA's state live in its
// shared memory: the ops (every op of the lane, one copy a CTA: state and
// fields; else that copy in the lane's global workspace), the dep chunk's
// state (else in the workspace) and the dep chunk's fields (else read from
// the inputs). The per-worker bests always live in shared memory, the
// per-channel bests there where the launch's plan found room for a whole
// lane's table on one CTA (`cbest_smem`), else in the workspace. The
// launch passes the padded sizes with no group placed; each lane places
// its groups for its own extents (`plan`) in the `smem` bytes launched.
struct Shape {
  int n, e, links, W, C, G;
  int dep_chunk, cslice;  // ceil(E / G), ceil(C / G)
  int ops_smem, dep_state_smem, dep_fields_smem;
  int cbest_smem;
  int smem;
};

// byte offsets of one CTA's arrays; each rounded up to 8 bytes. In shared
// memory: the tables, the ops, the dep state, the dep fields (the groups
// the shape puts there). In a lane's workspace: the channel table when it
// is not in shared memory (room for G CTAs' two rows of ceil(C / G) at any
// G up to the launch's: 2 (C + G) entries), G copies of the ops group
// (`ops_bytes` each) when they are not in shared memory, then the dep
// state of all E deps when it is not.
struct Layout {
  size_t wbest, cbest;                                  // tables
  size_t rem_op, op_score, num_parents, parent_done, worker, op_valid,
      op_flag, op_done, ops_bytes;                      // ops (group-relative)
  size_t ops, rem_dep, dep_done, dep_flag;              // dep state
  size_t dep_score, dep_src, dep_dst, dep_channel, dep_valid, dep_mutual,
      dep_flow;                                         // dep fields
  size_t total;
};

struct Carver {
  size_t at = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t here = at;
    at += (bytes + 7) / 8 * 8;
    return here;
  }
};

template <typename T>
__host__ __device__ Layout carve(const Shape& s, bool smem) {
  Layout L{};
  const size_t fb = sizeof(T);  // also the order-preserving integer's size
  Carver g;                     // the ops group, relative to its start
  L.rem_op = g.take(s.n * fb);
  L.op_score = g.take(s.n * fb);
  L.num_parents = g.take(s.n * 4);
  L.parent_done = g.take(s.n * 4);
  L.worker = g.take(s.n * 4);
  L.op_valid = g.take(s.n);
  L.op_flag = g.take(s.n);
  L.op_done = g.take(s.n);
  L.ops_bytes = g.at;
  const int ndep = smem ? s.dep_chunk : s.e;
  Carver c;
  if (smem) L.wbest = c.take(s.W * fb);
  if (smem && s.cbest_smem) {
    L.cbest = c.take(2 * static_cast<size_t>(s.cslice) * fb);
  } else if (!smem && !s.cbest_smem) {
    L.cbest = c.take(2 * (static_cast<size_t>(s.C) + s.G) * fb);
  }
  if (smem == static_cast<bool>(s.ops_smem)) {
    L.ops = c.take(smem ? L.ops_bytes : L.ops_bytes * s.G);
  }
  if (smem == static_cast<bool>(s.dep_state_smem)) {
    L.rem_dep = c.take(ndep * fb);
    L.dep_done = c.take(ndep);
    L.dep_flag = c.take(ndep);
  }
  if (smem && s.dep_fields_smem) {
    L.dep_score = c.take(ndep * fb);
    L.dep_src = c.take(ndep * 4);
    L.dep_dst = c.take(ndep * 4);
    L.dep_channel = c.take(static_cast<size_t>(ndep) * s.links * 4);
    L.dep_valid = c.take(ndep);
    L.dep_mutual = c.take(ndep);
    L.dep_flow = c.take(ndep);
  }
  L.total = c.at;
  return L;
}

template <typename V>
__device__ __forceinline__ V warp_min(V v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    const V o = __shfl_xor_sync(0xffffffffu, v, offset);
    v = o < v ? o : v;
  }
  return v;
}

// `s` with n ops and e deps, no group placed.
__host__ __device__ inline Shape shape_of(int n, int e, int links, int W,
                                         int C, int G, int smem) {
  return Shape{n, e, links, W, C, G, (e + G - 1) / G, (C + G - 1) / G,
               0, 0, 0, 1, smem};
}

// Places the groups of `s` in its shared memory, in the order the ticks
// touch them most, while they fit.
template <typename T>
__host__ __device__ void plan(Shape* s) {
  int* flags[3] = {&s->ops_smem, &s->dep_state_smem, &s->dep_fields_smem};
  for (int* f : flags) {
    *f = 1;
    if (carve<T>(*s, true).total > static_cast<size_t>(s->smem)) *f = 0;
  }
}

// A lane of more deps than this spreads over the launch's cluster; a
// smaller one runs on one CTA (measured on the H100 over the replay's and
// the pricing decision's lanes: at ~2,800 deps one CTA is faster than 2-8,
// at ~11,500 four are faster than one).
constexpr int kClusterMinDeps = 4096;

// Orders the CTA's (G == 1) or the cluster's memory accesses: a cluster
// barrier costs ~1,400 cycles at 1,024 threads on the H100, a block
// barrier ~75.
__device__ __forceinline__ void lane_sync(ddls::cg::cluster_group& cluster,
                                          int G) {
  if (G == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// CTA 0's reductions of tick t, by parity p = t & 1: the shortest
// nominated dep and the flags of tick t, and the completions of tick t - 1
// (read together in phase C, one load a warp)
template <typename Ord>
struct __align__(16) Slot {
  Ord min_dep;
  int nonflow, flow, done;
};

// a channel's place in the cluster's table: its CTA (c % G) and its index
// there (c / G), packed; -1 for a channel out of range
__device__ __forceinline__ int channel_slot(int c, int C, int G) {
  return c >= 0 && c < C ? ((c % G) << 20) | (c / G) : -1;
}

// The tick loop, two cluster barriers a tick. Every CTA keeps a copy of
// all the lane's ops and runs the op side of each tick on it (readiness,
// the per-worker bests, the selection, the shortest selected op, the
// advance), the same bits in every CTA; each CTA owns a chunk of the deps.
// Tick t (p = t & 1):
//  B. each CTA: its op copy's readiness, bests, selection and shortest
//     op; its ready flow deps nominated against channel table p, their
//     shortest into CTA 0's slot p; slot p ^ 1 and table p ^ 1 reset;
//  -- cluster barrier 1;
//  C. each CTA: slot p (tick t - 1's completions: the loop ends here,
//     before tick t, when nothing remains), the tick, the advance of its
//     op copy, then one pass over its deps: the advance (a completed dep
//     adds one to its child's parent count in every copy; CTA 0's slot
//     p ^ 1 counts the completions, the ops' once) and the readiness for
//     tick t + 1 (its flow deps' scores into table p ^ 1, channel c in CTA
//     c % G; the flags into slot p ^ 1);
//  -- cluster barrier 2.
// Tick 0's readiness runs before the loop.
// With G = 1 the barriers are block barriers. Another CTA's shared memory
// is reached through DSMEM (~200 cycles a round trip on the H100), the
// CTA's own directly.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lookahead_kernel(Inputs in, Outputs out, Shape sh,
                     unsigned char* __restrict__ ws, size_t ws_lane) {
  using N_ = Num<T>;
  using Ord = typename N_::Ord;
  ddls::cg::cluster_group cluster = ddls::cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  // CTA 0's: the setup's extents and count; the tick's slots
  __shared__ int s_last_op, s_last_dep, s_count;
  __shared__ Slot<Ord> s_slot[2];
  // every CTA's: by parity, its shortest selected op and selected count
  __shared__ Ord s_min_op[2];
  __shared__ int s_nsel[2];

  const int GL = sh.G;  // the launch's cluster size
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / GL;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const bool head = rank == 0 && tid == 0;
  const int n = sh.n, e = sh.e, links = sh.links;
  const int W = sh.W, C = sh.C;
  const size_t row =
      in.cfg != nullptr ? static_cast<size_t>(in.cfg[lane]) : lane;
  const size_t tn = row * n, te = row * e;
  const size_t on = static_cast<size_t>(lane) * n;
  const size_t oe = static_cast<size_t>(lane) * e;
  const Ord neg_one = N_::enc(static_cast<T>(-1));
  const Ord big = N_::enc(static_cast<T>(kBig));
  Slot<Ord>* slots = rank == 0 ? s_slot : cluster.map_shared_rank(s_slot, 0);

  if (head) {
    s_last_op = 0;
    s_last_dep = 0;
    s_count = 0;
    for (int p = 0; p < 2; ++p) s_slot[p] = Slot<Ord>{big, 0, 0, 0};
  }
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      s_min_op[p] = big;
      s_nsel[p] = 0;
    }
  }
  lane_sync(cluster, GL);
  // setup: the lane's last valid op and dep and its valid count
  {
    int last_op = 0, last_dep = 0, count = 0;
    for (int i = rank * nt + tid; i < n; i += GL * nt) {
      if (in.op_valid[tn + i]) {
        last_op = i + 1;
        ++count;
      }
    }
    for (int j = rank * nt + tid; j < e; j += GL * nt) {
      if (in.dep_valid[te + j]) {
        last_dep = j + 1;
        ++count;
      }
    }
    last_op = __reduce_max_sync(0xffffffffu, last_op);
    last_dep = __reduce_max_sync(0xffffffffu, last_dep);
    count = __reduce_add_sync(0xffffffffu, count);
    if ((tid & 31) == 0) {
      if (last_op) atomicMax(cluster.map_shared_rank(&s_last_op, 0), last_op);
      if (last_dep) {
        atomicMax(cluster.map_shared_rank(&s_last_dep, 0), last_dep);
      }
      if (count) atomicAdd(cluster.map_shared_rank(&s_count, 0), count);
    }
  }
  lane_sync(cluster, GL);
  const int n_last = ddls::warp_read(cluster.map_shared_rank(&s_last_op, 0));
  const int e_last =
      ddls::warp_read(cluster.map_shared_rank(&s_last_dep, 0));
  int remaining = ddls::warp_read(cluster.map_shared_rank(&s_count, 0));
  T* vals = static_cast<T*>(out.vals) + 4 * static_cast<size_t>(lane);
  if (in.skip != nullptr && in.skip[lane]) {
    if (head) {
      vals[0] = vals[1] = vals[2] = vals[3] = static_cast<T>(0);
      out.ok[lane] = remaining == 0;
      out.ticks[lane] = 0;
    }
    lane_sync(cluster, GL);  // CTA 0 stays until every CTA has read its counts
    return;
  }

  // a lane of at most kClusterMinDeps deps runs on CTA 0 alone (block
  // barriers; the other CTAs leave): two cluster barriers a tick cost more
  // than its share of the work saves
  const int G = e_last > kClusterMinDeps ? GL : 1;
  if (rank >= G) return;
  // this lane's shape: its extents, its groups placed in the shared
  // memory launched (the workspace keeps the padded layout)
  Shape ls = shape_of(n_last, e_last, links, W, C, G, sh.smem);
  ls.cbest_smem = sh.cbest_smem;
  plan<T>(&ls);
  const int dep_chunk = ls.dep_chunk;
  const int dep_lo = min(rank * dep_chunk, e_last);
  const int dep_len = min(dep_chunk, e_last - dep_lo);
  const Layout S = carve<T>(ls, true);
  const Layout Wl = carve<T>(sh, false);
  unsigned char* lws = ws + static_cast<size_t>(lane) * ws_lane;
  // this CTA's op copy; CTA q's parent counts
  const bool ops_smem = ls.ops_smem;
  const size_t o_rem = ops_smem ? S.rem_op : Wl.rem_op;
  const size_t o_score = ops_smem ? S.op_score : Wl.op_score;
  const size_t o_np = ops_smem ? S.num_parents : Wl.num_parents;
  const size_t o_pd = ops_smem ? S.parent_done : Wl.parent_done;
  const size_t o_worker = ops_smem ? S.worker : Wl.worker;
  const size_t o_valid = ops_smem ? S.op_valid : Wl.op_valid;
  const size_t o_flag = ops_smem ? S.op_flag : Wl.op_flag;
  const size_t o_done = ops_smem ? S.op_done : Wl.op_done;
  unsigned char* ops_base =
      ops_smem ? smem + S.ops : lws + Wl.ops + rank * Wl.ops_bytes;
  T* rem_op = reinterpret_cast<T*>(ops_base + o_rem);
  T* op_score = reinterpret_cast<T*>(ops_base + o_score);
  int* num_parents = reinterpret_cast<int*>(ops_base + o_np);
  int* parent_done = reinterpret_cast<int*>(ops_base + o_pd);
  int* worker = reinterpret_cast<int*>(ops_base + o_worker);
  bool* op_valid = reinterpret_cast<bool*>(ops_base + o_valid);
  unsigned char* op_flag = ops_base + o_flag;
  unsigned char* op_done = ops_base + o_done;
  auto parents_of = [&](int q) -> int* {
    if (q == rank) return parent_done;
    return ops_smem ? cluster.map_shared_rank(parent_done, q)
                    : reinterpret_cast<int*>(lws + Wl.ops +
                                             q * Wl.ops_bytes + o_pd);
  };
  // the dep chunk: element 0 is this CTA's first dep
  const bool state_smem = ls.dep_state_smem;
  unsigned char* db = state_smem ? smem : lws;
  const size_t dd = state_smem ? 0 : dep_lo;
  T* rem_dep = reinterpret_cast<T*>(db + (state_smem ? S.rem_dep
                                                     : Wl.rem_dep)) + dd;
  unsigned char* dep_done =
      db + (state_smem ? S.dep_done : Wl.dep_done) + dd;
  unsigned char* dep_flag =
      db + (state_smem ? S.dep_flag : Wl.dep_flag) + dd;
  // the fields; in shared memory each channel is kept as its table slot
  const bool packed = ls.dep_fields_smem;
  const bool* dep_valid;
  const int *dep_src, *dep_dst, *dep_channel;
  const bool *dep_mutual, *dep_flow;
  const T* dep_score;
  if (packed) {
    bool* v = reinterpret_cast<bool*>(smem + S.dep_valid);
    int* src = reinterpret_cast<int*>(smem + S.dep_src);
    int* dst = reinterpret_cast<int*>(smem + S.dep_dst);
    int* ch = reinterpret_cast<int*>(smem + S.dep_channel);
    bool* mut = reinterpret_cast<bool*>(smem + S.dep_mutual);
    bool* flow = reinterpret_cast<bool*>(smem + S.dep_flow);
    T* sc = reinterpret_cast<T*>(smem + S.dep_score);
    for (int jj = tid; jj < dep_len; jj += nt) {
      const size_t j = dep_lo + jj;
      v[jj] = in.dep_valid[te + j];
      src[jj] = in.dep_src[te + j];
      dst[jj] = in.dep_dst[te + j];
      mut[jj] = in.dep_mutual[te + j];
      flow[jj] = in.dep_is_flow[oe + j];
      sc[jj] = static_cast<const T*>(in.dep_score)[oe + j];
      for (int l = 0; l < links; ++l) {
        ch[static_cast<size_t>(jj) * links + l] =
            channel_slot(in.dep_channel[(oe + j) * links + l], C, G);
      }
    }
    dep_valid = v;
    dep_src = src;
    dep_dst = dst;
    dep_channel = ch;
    dep_mutual = mut;
    dep_flow = flow;
    dep_score = sc;
  } else {
    dep_valid = in.dep_valid + te + dep_lo;
    dep_src = in.dep_src + te + dep_lo;
    dep_dst = in.dep_dst + te + dep_lo;
    dep_mutual = in.dep_mutual + te + dep_lo;
    dep_flow = in.dep_is_flow + oe + dep_lo;
    dep_score = static_cast<const T*>(in.dep_score) + oe + dep_lo;
    dep_channel = in.dep_channel + (oe + dep_lo) * links;
  }
  // the per-worker bests (this CTA's own) and, by parity, the per-channel
  // bests (channel c in CTA c % G at c / G: CTA q's two rows in its shared
  // memory, or at q * 2 cslice in the lane's workspace)
  Ord* s_wbest = reinterpret_cast<Ord*>(smem + S.wbest);
  const bool cbest_smem = ls.cbest_smem;
  const int cslice = ls.cslice;
  Ord* g_cbest = reinterpret_cast<Ord*>(lws + Wl.cbest);
  Ord* s_cbest = cbest_smem ? reinterpret_cast<Ord*>(smem + S.cbest)
                            : g_cbest + 2 * static_cast<size_t>(rank) * cslice;
  auto best_at = [&](int jj, int l, int p) -> Ord* {
    const int c = dep_channel[static_cast<size_t>(jj) * links + l];
    const int slot = packed ? c : channel_slot(c, C, G);
    if (slot < 0) return nullptr;
    const int q = slot >> 20;
    Ord* table = q == rank ? s_cbest
                 : cbest_smem ? cluster.map_shared_rank(s_cbest, q)
                              : g_cbest + 2 * static_cast<size_t>(q) * cslice;
    return table + p * cslice + (slot & 0xfffff);
  };
  // a best's value: in the workspace, read at L2 (another CTA's atomics
  // land there; this SM's L1 may hold an older copy)
  auto best_value = [&](const Ord* b) -> Ord {
    return cbest_smem ? *b : __ldcg(b);
  };

  for (int i = tid; i < n_last; i += nt) {
    const bool v = in.op_valid[tn + i];
    rem_op[i] = static_cast<const T*>(in.op_remaining)[tn + i];
    op_score[i] = static_cast<const T*>(in.op_score)[on + i];
    num_parents[i] = in.num_parents[tn + i];
    parent_done[i] = 0;
    worker[i] = in.ots != nullptr ? (v ? in.ots[on + i] : -1)
                                  : in.op_worker[on + i];
    op_valid[i] = v;
    op_flag[i] = 0;
    op_done[i] = 0;
  }
  for (int jj = tid; jj < dep_len; jj += nt) {
    rem_dep[jj] = static_cast<const T*>(in.dep_remaining)[oe + dep_lo + jj];
    dep_done[jj] = 0;
    dep_flag[jj] = 0;
  }
  for (int w = tid; w < W; w += nt) s_wbest[w] = neg_one;
  for (int x = tid; x < 2 * cslice; x += nt) s_cbest[x] = neg_one;
  lane_sync(cluster, G);

  // a dep's readiness for tick `tp` (parity `q`) from the op copy: its
  // flag; a ready flow dep's score into the per-channel bests `q`; whether
  // a flow or a non-flow dep is ready
  auto find_ready = [&](int jj, bool done, int q, bool& any_flow,
                        bool& any_nonflow) -> unsigned char {
    const int src = dep_src[jj];
    if (done || !dep_valid[jj] || src < 0 || src >= n_last ||
        !op_done[src]) {
      return 0;
    }
    if (!dep_flow[jj]) {
      any_nonflow = true;
      return kNonFlow;
    }
    any_flow = true;
    const Ord sc = N_::enc(dep_score[jj]);
    for (int l = 0; l < links; ++l) {
      Ord* b = best_at(jj, l, q);
      if (b != nullptr) ddls::cluster_max(b, sc);
    }
    return kFlow;
  };
  auto post_flags = [&](bool any_flow, bool any_nonflow, int q) {
    if (__any_sync(0xffffffffu, any_flow) && (tid & 31) == 0) {
      slots[q].flow = 1;
    }
    if (__any_sync(0xffffffffu, any_nonflow) && (tid & 31) == 0) {
      slots[q].nonflow = 1;
    }
  };
  // A(0): the deps ready at tick 0
  {
    bool any_flow = false, any_nonflow = false;
    for (int jj = tid; jj < dep_len; jj += nt) {
      dep_flag[jj] = find_ready(jj, false, 0, any_flow, any_nonflow);
    }
    post_flags(any_flow, any_nonflow, 0);
  }
  lane_sync(cluster, G);

  // CTA 0's thread 0 keeps the reference's scalars
  T t = 0, comm = 0, comp = 0, busy = 0;
  const int max_iters = n + e + 4;
  int it = 0;
  bool stuck = false, drained = false;
  while (it < max_iters) {
    const int p = it & 1;
    // B. the deps' nomination (their shortest is read only when no
    // non-flow dep is ready); the op copy's readiness, bests and
    // selection; the other parity's slot and channel bests reset
    if (head) s_slot[p ^ 1] = Slot<Ord>{big, 0, 0, 0};
    if (tid == 0) {
      s_min_op[p ^ 1] = big;
      s_nsel[p ^ 1] = 0;
    }
    for (int x = tid; x < cslice; x += nt) {
      s_cbest[(p ^ 1) * cslice + x] = neg_one;
    }
    Ord min_dep = big;
    for (int jj = tid; jj < dep_len; jj += nt) {
      if (dep_flag[jj] != kFlow) continue;
      const T sc = dep_score[jj];
      bool nominated = false;
      for (int l = 0; l < links; ++l) {
        const Ord* b = best_at(jj, l, p);
        if (b == nullptr) continue;
        const T best = N_::dec(best_value(b));
        if (sc >= best && sc > static_cast<T>(0)) nominated = true;
      }
      if (nominated) {
        const Ord r = N_::min_key(rem_dep[jj]);
        min_dep = r < min_dep ? r : min_dep;
      }
    }
    for (int i = tid; i < n_last; i += nt) {
      const bool ready = op_valid[i] && !op_done[i] &&
                         parent_done[i] >= num_parents[i];
      op_flag[i] = ready ? kReady : 0;
      const int w = worker[i];
      if (ready && w >= 0 && w < W) {
        atomicMax(&s_wbest[w], N_::enc(op_score[i]));
      }
    }
    min_dep = warp_min(min_dep);
    if ((tid & 31) == 0 && min_dep != big) {
      ddls::cluster_min(&slots[p].min_dep, min_dep);
    }
    __syncthreads();
    int nsel_local = 0;
    Ord min_op = big;
    for (int i = tid; i < n_last; i += nt) {
      if (!(op_flag[i] & kReady)) continue;
      const int w = worker[i];
      if (w < 0 || w >= W) continue;
      const T best = N_::dec(s_wbest[w]);
      if (op_score[i] == best && best > static_cast<T>(0)) {
        op_flag[i] = kReady | kSelected;
        ++nsel_local;
        const Ord r = N_::min_key(rem_op[i]);
        min_op = r < min_op ? r : min_op;
      }
    }
    nsel_local = __reduce_add_sync(0xffffffffu, nsel_local);
    min_op = warp_min(min_op);
    if ((tid & 31) == 0) {
      if (nsel_local) atomicAdd(&s_nsel[p], nsel_local);
      if (min_op != big) atomicMin(&s_min_op[p], min_op);
    }
    lane_sync(cluster, G);

    // C. the last tick's completions (the loop ends before this tick when
    // nothing remains), the tick (every thread, the same bits) and the
    // accumulators (CTA 0's thread 0)
    const Slot<Ord> slot = slots[p];
    remaining -= slot.done;
    if (remaining <= 0) {
      drained = true;
      break;
    }
    const bool nonflow = slot.nonflow != 0;
    const T shortest_op = N_::dec(s_min_op[p]);
    const int nsel = s_nsel[p];
    const T shortest_comm =
        nonflow ? static_cast<T>(0) : N_::dec(slot.min_dep);
    // the smaller, NaN if either is (torch.minimum, jnp.minimum)
    const T tick = shortest_op < shortest_comm || shortest_op != shortest_op
                       ? shortest_op
                       : shortest_comm;
    stuck = tick >= static_cast<T>(kBig);
    if (head && !stuck) {
      comp = N_::add(comp, nsel > 0 ? tick : static_cast<T>(0));
      comm = N_::add(comm,
                     !nonflow && slot.flow ? tick : static_cast<T>(0));
      busy = N_::busy_step(busy, tick, static_cast<T>(nsel));
      t = N_::add(t, tick);
    }
    ++it;
    // a stuck tick adds nothing (the reference's safe_tick is 0) and ends
    // the lane
    if (stuck) break;

    // advance the op copy; then, in one pass, advance the deps, count
    // completions and parents, and find the deps ready at the next tick
    // (A of tick it, parity p ^ 1)
    int done_local = 0;
    for (int w = tid; w < W; w += nt) s_wbest[w] = neg_one;
    for (int i = tid; i < n_last; i += nt) {
      if (!(op_flag[i] & kSelected)) continue;
      T r = N_::sub(rem_op[i], tick);
      // max(r, 0), a NaN kept (torch.maximum)
      r = r > static_cast<T>(0) || r != r ? r : static_cast<T>(0);
      rem_op[i] = r;
      if (r <= static_cast<T>(0)) {
        op_done[i] = 1;
        if (rank == 0) ++done_local;
      }
    }
    __syncthreads();  // the op copy's completions before the deps read it
    const unsigned char advance = nonflow ? kNonFlow : kFlow;
    bool any_flow = false, any_nonflow = false;
    for (int jj = tid; jj < dep_len; jj += nt) {
      bool done = dep_done[jj];
      if (dep_flag[jj] == advance) {
        T r = N_::sub(rem_dep[jj], tick);
        r = r > static_cast<T>(0) || r != r ? r : static_cast<T>(0);
        rem_dep[jj] = r;
        if (r <= static_cast<T>(0)) {
          dep_done[jj] = 1;
          done = true;
          ++done_local;
          const int dst = dep_dst[jj];
          // a child past the last valid op is never ready: its count is
          // never read
          if (!dep_mutual[jj] && dst >= 0 && dst < n_last) {
            for (int q = 0; q < G; ++q) atomicAdd(parents_of(q) + dst, 1);
          }
        }
      }
      dep_flag[jj] = find_ready(jj, done, p ^ 1, any_flow, any_nonflow);
    }
    post_flags(any_flow, any_nonflow, p ^ 1);
    done_local = __reduce_add_sync(0xffffffffu, done_local);
    if ((tid & 31) == 0 && done_local) {
      atomicAdd(&slots[p ^ 1].done, done_local);
    }
    lane_sync(cluster, G);
  }
  lane_sync(cluster, G);  // every completion counted; CTA 0 stays until then
  if (head) {
    // leaving at the tick limit, the last tick's completions are still to
    // be counted
    if (!drained && !stuck) remaining -= s_slot[it & 1].done;
    vals[0] = t;
    vals[1] = comm;
    vals[2] = comp;
    vals[3] = busy;
    out.ok[lane] = remaining <= 0 && !stuck;
    out.ticks[lane] = it;
  }
}

// threads a CTA: enough for the ops and the padded dep chunk at two slots
// a thread, up to kMaxThreads
int threads_for(int n, int dep_chunk) {
  int threads = 128;
  while (threads < kMaxThreads && threads * 2 < n + dep_chunk) {
    threads *= 2;
  }
  return threads;
}

// The launch's shape: the padded sizes, no group placed, and the shared
// memory a CTA takes: what the padded lane would place, up to `budget`.
// The channel table goes to the workspace where a lane on one CTA could
// not hold it (or `cbest_global` asks so). Returns false when not even the
// per-worker bests fit.
template <typename T>
bool plan_launch(Shape* s, int n, int e, int links, int W, int C, int G,
                 int budget, int cbest_global) {
  *s = shape_of(n, e, links, W, C, G, budget);
  // a lane of up to kClusterMinDeps deps runs on one CTA
  s->cslice = C;
  const int one_cta = e < kClusterMinDeps ? e : kClusterMinDeps;
  if (s->dep_chunk < one_cta) s->dep_chunk = one_cta;
  s->cbest_smem = !cbest_global;
  if (carve<T>(*s, true).total > static_cast<size_t>(budget)) {
    s->cbest_smem = 0;
  }
  if (carve<T>(*s, true).total > static_cast<size_t>(budget)) return false;
  Shape full = *s;
  plan<T>(&full);
  s->smem = static_cast<int>(carve<T>(full, true).total);
  return true;
}


bool sizes_ok(int n, int e, int links, int W, int C, int G) {
  return n >= 0 && e >= 0 && links >= 1 && W >= 1 && C >= 1 && G >= 1 &&
         G <= ddls::kMaxCluster;
}

template <typename T>
int launch(const Inputs& in, const Outputs& out, void* ws, size_t ws_lane,
           int lanes, int n, int e, int links, int W, int C, int G,
           int cbest_global, cudaStream_t stream) {
  int budget = 0;
  int rc = ddls::smem_optin(&budget);
  if (rc != 0) return rc;
  Shape sh;
  if (!plan_launch<T>(&sh, n, e, links, W, C, G, budget, cbest_global)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (carve<T>(sh, false).total > ws_lane) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(sh.smem);
  cudaError_t err = ddls::prepare_cluster(lookahead_kernel<T>, G, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  ddls::cluster_config(&config, &attr, lanes, G,
                       threads_for(n, sh.dep_chunk), smem, stream);
  err = cudaLaunchKernelEx(&config, lookahead_kernel<T>, in, out, sh,
                           static_cast<unsigned char*>(ws), ws_lane);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The thirteen inputs in jax_lookahead's order ([B, N] ops, [B, E] deps,
// [B, E, L] dep_channel; floats of the type `is_f64` names, bools as one
// byte, the rest int32), or, with `cfg` ([B] int32), the config tables
// [K, N] / [K, E] for op_remaining, op_valid, num_parents, dep_valid,
// dep_src, dep_dst, dep_mutual, with op_worker null and `ots` [B, N] int32
// in its place; then `skip` ([B] bools, or null); the workspace
// (`ws_lane` bytes a lane, uninitialised; the kernel sets up what it
// uses); the outputs; the sizes, the cluster size G (1-16 CTAs a lane) and
// `cbest_global` (1: the channel table in the workspace even where shared
// memory would hold it; the tests hold both forms).
DDLS_EXPORT int ddls_lookahead(
    const void* op_remaining, const void* op_valid, const void* op_worker,
    const void* op_score, const void* num_parents, const void* dep_remaining,
    const void* dep_valid, const void* dep_src, const void* dep_dst,
    const void* dep_mutual, const void* dep_is_flow, const void* dep_score,
    const void* dep_channel, const void* cfg, const void* ots,
    const void* skip, void* ws, void* out_vals, void* out_ok,
    void* out_ticks, int ws_lane, int lanes, int n, int e, int links,
    int num_workers, int num_channels, int G, int is_f64, int cbest_global,
    void* stream) {
  if (lanes <= 0 || ws_lane < 0 ||
      !sizes_ok(n, e, links, num_workers, num_channels, G) ||
      (cfg == nullptr) != (ots == nullptr) ||
      (cfg == nullptr) == (op_worker == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{op_remaining,
                  static_cast<const bool*>(op_valid),
                  static_cast<const int*>(op_worker),
                  op_score,
                  static_cast<const int*>(num_parents),
                  dep_remaining,
                  static_cast<const bool*>(dep_valid),
                  static_cast<const int*>(dep_src),
                  static_cast<const int*>(dep_dst),
                  static_cast<const bool*>(dep_mutual),
                  static_cast<const bool*>(dep_is_flow),
                  dep_score,
                  static_cast<const int*>(dep_channel),
                  static_cast<const int*>(cfg),
                  static_cast<const int*>(ots),
                  static_cast<const bool*>(skip)};
  const Outputs out{out_vals, static_cast<bool*>(out_ok),
                    static_cast<int*>(out_ticks)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t wl = static_cast<size_t>(ws_lane);
  if (is_f64) {
    return launch<double>(in, out, ws, wl, lanes, n, e, links, num_workers,
                          num_channels, G, cbest_global, s);
  }
  return launch<float>(in, out, ws, wl, lanes, n, e, links, num_workers,
                       num_channels, G, cbest_global, s);
}

// The workspace a lane of K21 needs at these sizes (bytes, into *out):
// what the launch's plan keeps out of shared memory.
DDLS_EXPORT int ddls_lookahead_workspace(int n, int e, int links,
                                         int num_workers, int num_channels,
                                         int G, int is_f64, int cbest_global,
                                         void* out) {
  if (!sizes_ok(n, e, links, num_workers, num_channels, G)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int budget = 0;
  const int rc = ddls::smem_optin(&budget);
  if (rc != 0) return rc;
  Shape sh;
  const bool ok =
      is_f64 ? plan_launch<double>(&sh, n, e, links, num_workers,
                                   num_channels, G, budget, cbest_global)
             : plan_launch<float>(&sh, n, e, links, num_workers,
                                  num_channels, G, budget, cbest_global);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  *static_cast<int*>(out) = static_cast<int>(
      is_f64 ? carve<double>(sh, false).total : carve<float>(sh, false).total);
  return 0;
}
