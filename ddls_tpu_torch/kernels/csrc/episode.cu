// K25 episode_step: one decision's commit and the event clock up to the
// next decision, for every lane of the device episode.
//
// Replaces the replay half of ddls_tpu/sim/jax_env.py:974 _episode_kernels:
// `decision` (:1105-1163: the channel check, the SLA gate and the cause
// code over eval_cfg's outputs, the masked commit into the first free slot,
// the reward) with the episode's scan body (:1269-1297: the trace, the
// counters), then `advance` (:1165-1214: the lax.while_loop of ticks, each
// the smallest of the next arrival, the simulation end and the running
// slots' remaining times; completions free memory, servers and channels;
// an arrival queues the next job) until a job queues or the episode ends,
// then the next decision's config row, cfg = type[row] * n_deg +
// deg_col[action], so that the episode needs no host sync. One CTA per lane.
//
// The segment and policy episodes (sim/jax_env.py:1457, :1596) use three
// more parts, each switched on by its arguments: the episode counters of
// the step (done, accepted, blocked with the still-running slots where
// the episode ended, return, completed, arrived: :1702-1724); the
// in-kernel reset (:1693-1699): an ended lane's state becomes its fresh
// one, computed here from the bank (t 0, every server free with the
// worker memory, job 0 queued, the next arrival arrival_t[1], the
// counters 0) rather than read from a stored copy, which is the same
// state bit for bit; and the next step's observation fields (type, SLA
// fraction, steps of the queued job, the occupied servers and running
// slots counted over the block). There the action is sampled on the card
// after this kernel, so the config row comes from ddls_episode_prepare,
// one thread a lane, launched once the action is known.
//
// Arithmetic as the reference's: jct = t_step * steps, max_jct = (sla_frac
// * seq_compute) * steps, the commit time t + jct, each rounded on its own
// (the file is built with -fmad=false, kernels/__init__.py EXTRA_FLAGS);
// a completion frees its slot when done - t - eps <= 0, an arrival queues
// when t + eps >= its time; the freed memory is the completed slots'
// rows summed in slot order, then added (the reference's completions @
// slot_mem: a server belongs to at most one slot, so each column sums at
// most one nonzero row and every order gives the same bits).
//
// The scenario mode (the failure walk, ddls_tpu/scenarios/failures.py:137
// inflate_duration_jax as sim/jax_env.py:1014 scenario_adjusted applies it
// at :1138-1141): with the scenario's tables (per-server speeds, the
// t0-sorted windows' t0, t1, rate, kind and resource), warp 0 inflates a
// deciding lane's jct after the gate, before the trace and the commit:
// r0, the slowest speed over the block's server mask (inf when it is
// empty; a warp reduction); t_done = t + jct / r0; then each window that touches the lane
// (its server in the server mask for a preemption, its channel in the
// channel mask for a straggler) and overlaps the remaining run from lo =
// max(t0, t) either fits it at its rate (lo + remaining / r) or pushes it
// past its end (t1 + (remaining - r * span)); the jct becomes t_done - t.
// The expressions are the reference's, each rounded on its own (XLA fuses
// none of them: the fuzzed rows of the recording say so), the divisor
// guard included. The SLA gate stays on the nominal jct. A lane that
// decides nothing keeps jct 0, which the walk leaves at 0. Without the
// tables the kernel is the nominal one, a template instance of its own.
//
// What bounds it on the H100: latency. A decision reads the lane's placement
// and pricing outputs over its configuration's valid prefixes (21 to
// 13,072 deps, up to ~65 KB) and writes a few hundred bytes of state; a
// tick is a few comparisons over the R = n_srv slots. The card could do
// either in well under a microsecond; the time is a chain of dependent
// steps. The design, one CTA of kThreads a lane:
//  * the channel check and the two masks read deps [0, n_deps[c]) and ops
//    [0, n_ops[c]) of the lane's configuration c only (K24 writes every dep
//    past the prefix as no flow, and op_valid is the prefix), flags 16 and
//    channels 4 at a time (common.cuh for_each_flow), against the lane's
//    chan_occ staged in shared memory: one shared load a flow;
//  * the decision's scalars and the event clock run on warp 0 in
//    registers: the lane of index i owns slots [i K, i K + K), K =
//    ceil(R / 32), read once and written back once (the kernel is a
//    template on KS = 4, 8, 16 or 32 slots a lane, the least that holds
//    K); the first free slot is a ballot and its lowest lane; each tick's
//    least remaining time is a tree over the warp that returns a serial
//    scan's bits (common.cuh warp_first_min); the completions are ballots;
//    no block barrier a tick;
//  * a surface the above does not fit takes a form of its own, with the
//    same arithmetic in the same order (the same bits): past 1,024 slots
//    warp 0's lanes keep their slot blocks in the lane's state in global
//    memory (KS = 0); where the channel occupancy does not fit the opt-in
//    shared memory the flows read it from global memory; where the
//    channel mask does not fit either, the commit writes the slot's
//    channel row by a second pass over the flows, and the walk finds each
//    straggler window's channel among them. The C entry picks each form
//    from the sizes; its `forms` argument forces them (the tests hold
//    every form against the plain version);
//  * the ticks read neither mem, srv_job nor chan_occ, and nothing inside
//    the loop commits, so a slot completes at most once a launch: the
//    block frees the union of the launch's completed slots once, after the
//    loop, reading only their rows. The per-tick sum equals this one
//    because a server belongs to at most one running job, so a column of
//    the completed slots' slot_mem rows has at most one nonzero term
//    (tests/test_torch_episode_prefix.py holds the order on every recorded
//    replay and on C1's bank);
//  * the reset's clears are 16-byte stores (common.cuh block_fill).
// No float atomics.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
// the shared-memory forms (sim/device_env.py EPISODE_FORMS)
constexpr int kOccGlobal = 1, kMaskFree = 2;

// Warp 0's slots: lane ln owns slots [ln K, ln K + K) of the R (`lim` of
// them: fewer at the end). With KS > 0 they live in registers (K <= KS;
// every loop runs KS steps, unrolled, so each array index is a constant);
// with KS = 0 in the lane's state in global memory (loops of K steps), the
// launch's completions flagged in shared memory. Loops over k run the same
// count on every lane (the ballots need the whole warp).
template <typename T, int KS>
struct Slots {
  bool valid[KS];
  T t_done[KS];
  unsigned freed = 0;  // bit k: slot k completed this launch
  int lim = 0;
  __device__ void load(bool* sv, T* st, unsigned char*, int ln, int K,
                       int R) {
    lim = min(max(R - ln * K, 0), K);
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const bool mine = k < lim;
      valid[k] = mine && sv[ln * K + k];
      t_done[k] = mine ? st[ln * K + k] : static_cast<T>(0);
    }
  }
  __device__ static constexpr int bound(int) { return KS; }
  __device__ bool owns(int k) const { return k < lim; }
  __device__ bool is_valid(int k) const { return valid[k]; }
  __device__ T done_at(int k) const { return t_done[k]; }
  __device__ void take(int slot_k, T t) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k == slot_k) {
        valid[k] = true;
        t_done[k] = t;
      }
    }
  }
  __device__ void complete(int k) {
    valid[k] = false;
    freed |= 1u << k;
  }
  __device__ bool was_freed(int k) const { return (freed >> k) & 1u; }
  __device__ void store(bool* sv, T* st, int ln, int K) const {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (k < lim) {
        sv[ln * K + k] = valid[k];
        st[ln * K + k] = t_done[k];
      }
    }
  }
};

template <typename T>
struct Slots<T, 0> {
  bool* sv;
  T* st;
  unsigned char* fr;  // shared: completed this launch
  int lim = 0;
  __device__ void load(bool* sv_, T* st_, unsigned char* fr_, int ln, int K,
                       int R) {
    lim = min(max(R - ln * K, 0), K);
    sv = sv_ + ln * K;
    st = st_ + ln * K;
    fr = fr_ + ln * K;
    for (int k = 0; k < lim; ++k) fr[k] = 0;
  }
  __device__ static int bound(int K) { return K; }
  __device__ bool owns(int k) const { return k < lim; }
  __device__ bool is_valid(int k) const { return k < lim && sv[k]; }
  __device__ T done_at(int k) const { return st[k]; }
  __device__ void take(int k, T t) {
    sv[k] = true;
    st[k] = t;
  }
  __device__ void complete(int k) {
    sv[k] = false;
    fr[k] = 1;
  }
  __device__ bool was_freed(int k) const { return k < lim && fr[k]; }
  __device__ void store(bool*, T*, int, int) const {}
};

struct State {
  void *t, *mem;
  int *srv_job, *chan_occ;
  bool* slot_valid;
  void* slot_t_done;
  void* slot_mem;
  bool *slot_servers, *slot_chan;
  int *queue_row, *ptr;
  void* next_arrival;
  bool* done;
  int *completed, *accepted, *blocked;
  void* ret;
  int* cfg;
  bool* active;
  int* ticks;
};

struct Trace {
  void* reward;
  bool* accept;
  int* cause;
  void *jct, *t;
  bool* has_job;
};

struct Bank {
  const int* type;
  const void *steps, *sla_frac, *arrival_t;
};

struct Raw {
  const int* ots;
  const void* new_mem;
  const bool *ok_place, *is_flow;
  const int* chan;
  const bool* finite_ok;
  const void* t_step;
  const bool* ok_la;
  const int* la_ticks;
};

// the configuration tables the kernel reads: op_valid [K, N], seq_compute
// [K], deg_col [n_col], n_deps and n_ops [K]
struct Tables {
  const bool* op_valid;
  const void* seq_compute;
  const int *deg_col, *n_deps, *n_ops;
};

// the segment's per-step episode counters [B, decisions] (null: none)
struct Seg {
  bool* done;
  int *accepted, *blocked;
  void* ret;
  int *completed, *arrived;
};

// the observation fields [B, decisions + 1] (null: none)
struct Fields {
  int* jtype;
  void *frac, *steps;
  int *n_occupied, *n_running;
};

// the scenario's tables (speeds [n_srv]; t0, t1, rate, kind, res [n_win])
struct Scenario {
  const void *speeds, *t0, *t1, *rate;
  const int *kind, *res;
  int n_win;
};

struct Dims {
  int n_srv, n_chan, slots, n, m, jobs, decisions, d, n_deg, n_cfg, n_col,
      t_step_stride, prepare, reset, forms;
  double sim_end, eps, success, fail, worker_mem;
};

// the reference's cause codes (sim/device_env.py CAUSE_*)
constexpr int kAccepted = 0, kNotHandled = 1, kOpPlacement = 2,
              kDepPlacement = 3, kSla = 4, kEngine = 5;

// The failure walk of one lane (every lane of warp 0, the same bits): the
// jct of a job of nominal duration jct starting at t on the servers srv
// and channels chan (or, without the channel mask, win: whether window i's
// channel is one of the job's). r0, the slowest speed over the server mask
// (inf when it is empty), is a warp reduction over each lane's servers
// [i KS, i KS + KS), KS = ceil(n_srv / 32), with a serial scan's bits; the
// windows run in order, each reading the last t_done.
template <typename T>
__device__ T failure_walk(const Scenario& sc, T t, T jct,
                          const unsigned char* srv, const unsigned char* chan,
                          const unsigned char* win, int n_srv, int ln) {
  const T* speeds = static_cast<const T*>(sc.speeds);
  const T* t0 = static_cast<const T*>(sc.t0);
  const T* t1 = static_cast<const T*>(sc.t1);
  const T* rate = static_cast<const T*>(sc.rate);
  const int ks = (n_srv + ddls::kWarpSize - 1) / ddls::kWarpSize;
  T r0 = static_cast<T>(INFINITY);
  for (int s = ln * ks; s < (ln + 1) * ks && s < n_srv; ++s) {
    if (srv[s]) r0 = speeds[s] < r0 ? speeds[s] : r0;
  }
  r0 = ddls::warp_first_min(r0);
  T t_done = t + jct / r0;
  for (int i = 0; i < sc.n_win; ++i) {
    const T w0 = t0[i], w1 = t1[i], r = rate[i];
    const T lo = w0 > t ? w0 : t;
    const bool affects = sc.kind[i] == 0   ? srv[sc.res[i]]
                         : chan != nullptr ? chan[sc.res[i]]
                                           : win[i];
    const bool overlap = affects && lo < w1 && t_done > lo;
    const T remaining = t_done - lo;
    const T span = w1 - lo;
    const T cap = r * span;
    const bool fits = r > static_cast<T>(0) && remaining <= cap;
    const T t_new =
        fits ? lo + remaining / (r > static_cast<T>(0) ? r : static_cast<T>(1))
             : w1 + (remaining - cap);
    t_done = overlap ? t_new : t_done;
  }
  return t_done - t;
}

// The dynamic shared memory of a launch (bytes, in this order): the
// staged chan_occ [n_chan] ints (unless kOccGlobal), the completed slots'
// list [R] ints, the memory form's completion flags [R] (KS = 0), the
// server mask [n_srv], then the channel mask [n_chan] or, without it
// (kMaskFree), each scenario window's channel flag [n_win].
__host__ __device__ inline size_t episode_smem(int n_srv, int n_chan, int R,
                                              int forms, int ks, int n_win) {
  const size_t occ = forms & kOccGlobal ? 0 : static_cast<size_t>(n_chan);
  return sizeof(int) * (occ + R) + (ks == 0 ? R : 0) + n_srv +
         (forms & kMaskFree ? n_win : static_cast<size_t>(n_chan));
}

template <typename T, bool kScenario, int KS>
__global__ void __launch_bounds__(kThreads) episode_step_kernel(
    State st, Trace tr, Bank bk, const int* __restrict__ actions, Raw raw,
    Tables tb, Seg sg, Fields fl, Dims dm, Scenario sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_srv = dm.n_srv, n_chan = dm.n_chan, R = dm.slots;
  const bool occ_global = dm.forms & kOccGlobal;
  const bool mask_free = dm.forms & kMaskFree;
  int* s_occ = reinterpret_cast<int*>(smem);      // [n_chan] chan_occ
  int* s_freed = s_occ + (occ_global ? 0 : n_chan);  // [R] completed
  unsigned char* s_fr = reinterpret_cast<unsigned char*>(s_freed + R);
  unsigned char* s_srv = s_fr + (KS == 0 ? R : 0);   // [n_srv] mask
  // [n_chan] mask, or the windows' channel flags [n_win]
  unsigned char* s_chan = mask_free ? nullptr : s_srv + n_srv;
  unsigned char* s_win = s_srv + n_srv;
  __shared__ int s_accept, s_slot, s_ticked, s_n_freed, s_running,
      s_occupied;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ln = tid & (ddls::kWarpSize - 1);
  const bool warp0 = tid < ddls::kWarpSize;
  T* t_p = static_cast<T*>(st.t) + b;
  T* mem = static_cast<T*>(st.mem) + static_cast<size_t>(b) * n_srv;
  int* srv_job = st.srv_job + static_cast<size_t>(b) * n_srv;
  int* chan_occ = st.chan_occ + static_cast<size_t>(b) * n_chan;
  bool* slot_valid = st.slot_valid + static_cast<size_t>(b) * R;
  T* slot_t_done = static_cast<T*>(st.slot_t_done) + static_cast<size_t>(b) * R;
  T* slot_mem = static_cast<T*>(st.slot_mem) +
                static_cast<size_t>(b) * R * n_srv;
  bool* slot_servers = st.slot_servers + static_cast<size_t>(b) * R * n_srv;
  bool* slot_chan = st.slot_chan + static_cast<size_t>(b) * R * n_chan;
  const int* ots = raw.ots + static_cast<size_t>(b) * dm.n;
  const T* new_mem =
      static_cast<const T*>(raw.new_mem) + static_cast<size_t>(b) * n_srv;
  const int J = dm.jobs;
  const T* arrival_t =
      static_cast<const T*>(bk.arrival_t) + static_cast<size_t>(b) * (J + 1);
  T* next_arrival = static_cast<T*>(st.next_arrival) + b;

  const int queue_row = st.queue_row[b];
  const bool has_job = queue_row >= 0 && !st.done[b];
  const bool active = st.active[b];
  const int c = st.cfg[b];

  // warp 0's slots: lane ln owns [ln K, ln K + K)
  const int K = (R + ddls::kWarpSize - 1) / ddls::kWarpSize;
  Slots<T, KS> sl;
  if (warp0) sl.load(slot_valid, slot_t_done, s_fr, ln, K, R);

  // ---- the lane's channel occupancy staged, the masks cleared
  if (!occ_global) {
    for (int ch = tid; ch < n_chan; ch += nt) s_occ[ch] = chan_occ[ch];
  }
  ddls::block_fill(s_srv, static_cast<size_t>(n_srv) +
                              (mask_free ? (kScenario ? sc.n_win : 0)
                                         : n_chan), 0);
  __syncthreads();

  // ---- the decision: the channel check and the two masks over the
  // configuration's valid deps and ops
  bool ok_chan = true;
  const int nd = min(max(tb.n_deps[c], 0), dm.m);
  const bool* flow_row = raw.is_flow + static_cast<size_t>(b) * dm.m;
  const int* chan_row = raw.chan + static_cast<size_t>(b) * dm.m;
  ddls::for_each_flow(flow_row, chan_row, nd, [&](int ch) {
    if ((occ_global ? chan_occ[ch] : s_occ[ch]) >= 0) ok_chan = false;
    if (!mask_free) s_chan[ch] = 1;
  });
  if (kScenario && mask_free) {
    // each straggler window whose channel one of the flows takes
    ddls::for_each_flow(flow_row, chan_row, nd, [&](int ch) {
      for (int i = 0; i < sc.n_win; ++i) {
        if (sc.kind[i] != 0 && sc.res[i] == ch) s_win[i] = 1;
      }
    });
  }
  const bool* valid_row = tb.op_valid + static_cast<size_t>(c) * dm.n;
  const int no = min(max(tb.n_ops[c], 0), dm.n);
  for (int i = tid; i < no; i += nt) {
    if (valid_row[i] && ots[i] >= 0) s_srv[ots[i]] = 1;
  }
  const bool chan_free = __syncthreads_and(ok_chan) != 0;

  // ---- the gate, the cause, the walk, the first free slot, the trace and
  // the counters (warp 0, every lane the same scalars; lane 0 writes)
  T t = static_cast<T>(0);
  int q_row = queue_row;
  if (warp0) {
    t = *t_p;
    const int row = queue_row > 0 ? queue_row : 0;
    const size_t at = static_cast<size_t>(b) * J + row;
    const T steps = static_cast<const T*>(bk.steps)[at];
    const T sla = static_cast<const T*>(bk.sla_frac)[at];
    const T t_step = static_cast<const T*>(
        raw.t_step)[static_cast<size_t>(b) * dm.t_step_stride];
    T jct = t_step * steps;
    const T max_jct =
        sla * static_cast<const T*>(tb.seq_compute)[c] * steps;
    const bool sla_ok = !(jct > max_jct);
    const bool engine_ok = raw.ok_la[b] && raw.finite_ok[b];
    const bool ok_place = raw.ok_place[b];
    bool accept = ok_place && chan_free && sla_ok && engine_ok;
    int cause = !ok_place ? kOpPlacement
                : !chan_free ? kDepPlacement
                : !engine_ok ? kEngine
                : !sla_ok ? kSla : kAccepted;
    if (!active) {
      accept = false;
      cause = kNotHandled;
      jct = static_cast<T>(0);
    }
    if constexpr (kScenario) {
      if (active) {
        jct = failure_walk(sc, t, jct, s_srv, s_chan, s_win, n_srv, ln);
      }
    }
    // the first free slot: each lane's first, then the lowest such lane
    int first = -1;
#pragma unroll
    for (int k = sl.bound(K) - 1; k >= 0; --k) {
      if (sl.owns(k) && !sl.is_valid(k)) first = k;
    }
    const unsigned any_free = __ballot_sync(ddls::kFullMask, first >= 0);
    const int owner = any_free ? __ffs(any_free) - 1 : 0;
    const int slot = __shfl_sync(ddls::kFullMask, ln * K + first, owner);
    accept = accept && any_free != 0 && has_job;
    if (accept && ln == owner) sl.take(first, t + jct);
    if (has_job) q_row = -1;
    if (ln == 0) {
      const T reward = has_job
                           ? static_cast<T>(accept ? dm.success : dm.fail)
                           : static_cast<T>(0);
      const size_t td = static_cast<size_t>(b) * dm.decisions + dm.d;
      static_cast<T*>(tr.reward)[td] = reward;
      tr.accept[td] = accept;
      tr.cause[td] = has_job ? cause : -1;
      static_cast<T*>(tr.jct)[td] = has_job ? jct : static_cast<T>(0);
      static_cast<T*>(tr.t)[td] = t;
      tr.has_job[td] = has_job;
      st.accepted[b] += (has_job && accept) ? 1 : 0;
      st.blocked[b] += (has_job && !accept) ? 1 : 0;
      T* ret = static_cast<T*>(st.ret) + b;
      *ret = *ret + reward;
      if (active) st.ticks[b] += raw.la_ticks[b];
      s_accept = accept;
      s_slot = slot;
    }
  }
  __syncthreads();

  // ---- the commit into the slot (the block)
  if (s_accept) {
    const int slot = s_slot;
    for (int s = tid; s < n_srv; s += nt) {
      const T delta = mem[s] - new_mem[s];
      slot_mem[static_cast<size_t>(slot) * n_srv + s] = delta;
      slot_servers[static_cast<size_t>(slot) * n_srv + s] = s_srv[s];
      if (s_srv[s]) srv_job[s] = slot;
      mem[s] = new_mem[s];
    }
    bool* chan_row_out = slot_chan + static_cast<size_t>(slot) * n_chan;
    if (!mask_free) {
      for (int ch = tid; ch < n_chan; ch += nt) {
        chan_row_out[ch] = s_chan[ch];
        if (s_chan[ch]) chan_occ[ch] = slot;
      }
    } else {
      // the slot's row cleared, then set again over the flows
      ddls::block_fill(chan_row_out, n_chan, 0);
      __syncthreads();
      ddls::for_each_flow(flow_row, chan_row, nd, [&](int ch) {
        chan_row_out[ch] = true;
        chan_occ[ch] = slot;
      });
    }
  }

  // ---- the event clock (warp 0): tick until a job queues or the episode
  // ends; the slots in registers, the launch's completions collected
  if (warp0) {
    const T sim_end = static_cast<T>(dm.sim_end);
    const T eps = static_cast<T>(dm.eps);
    T next = *next_arrival;
    int ptr = st.ptr[b];
    bool done = st.done[b];
    int completed = st.completed[b];
    bool ticked = false;
    while (q_row < 0 && !done) {
      ticked = true;
      // the least remaining time, as the serial loop over r = 0..R-1
      T rem = static_cast<T>(INFINITY);
#pragma unroll
      for (int k = 0; k < sl.bound(K); ++k) {
        if (sl.is_valid(k)) {
          const T left = sl.done_at(k) - t;
          rem = left < rem ? left : rem;
        }
      }
      rem = ddls::warp_first_min(rem);
      const T to_arrival = next - t;
      const T to_end = sim_end - t;
      T tick = to_end < to_arrival ? to_end : to_arrival;
      tick = rem < tick ? rem : tick;
      tick = tick > static_cast<T>(0) ? tick : static_cast<T>(0);
      const T t2 = t + tick;
      int n_done = 0;
      bool running = false;
#pragma unroll
      for (int k = 0; k < sl.bound(K); ++k) {
        const bool comp = sl.is_valid(k) &&
                          (sl.done_at(k) - t2 - eps <= static_cast<T>(0));
        n_done += __popc(__ballot_sync(ddls::kFullMask, comp));
        if (comp) sl.complete(k);
        running = running || sl.is_valid(k);
      }
      const bool any_running = __any_sync(ddls::kFullMask, running);
      completed += n_done;
      const bool arrived = ptr < J && t2 + eps >= next;
      const int q_row2 = arrived ? ptr : q_row;
      const int ptr2 = ptr + (arrived ? 1 : 0);
      if (arrived) next = arrival_t[ptr2 < 0 ? 0 : (ptr2 > J ? J : ptr2)];
      q_row = q_row2;
      ptr = ptr2;
      done = t2 >= sim_end || (ptr2 >= J && !any_running && q_row2 < 0);
      t = t2;
    }
    // write the slots and the scalars back; list the completed slots in
    // slot order (lane-major: an exclusive scan of the lanes' counts)
    int mine = 0, running = 0;
    sl.store(slot_valid, slot_t_done, ln, K);
#pragma unroll
    for (int k = 0; k < sl.bound(K); ++k) {
      mine += sl.was_freed(k) ? 1 : 0;
      running += sl.is_valid(k) ? 1 : 0;
    }
    int before = mine;
#pragma unroll
    for (int d = 1; d < ddls::kWarpSize; d <<= 1) {
      const int v = __shfl_up_sync(ddls::kFullMask, before, d);
      if (ln >= d) before += v;
    }
    before -= mine;
#pragma unroll
    for (int k = 0; k < sl.bound(K); ++k) {
      if (sl.was_freed(k)) s_freed[before++] = ln * K + k;
    }
    running = __reduce_add_sync(ddls::kFullMask, running);
    if (ln == ddls::kWarpSize - 1) s_n_freed = before;
    if (ln == 0) {
      *t_p = t;
      st.queue_row[b] = q_row;
      st.ptr[b] = ptr;
      *next_arrival = next;
      st.done[b] = done;
      st.completed[b] = completed;
      s_ticked = ticked;
      s_running = running;
    }
  }
  __syncthreads();

  // ---- the completions of the launch free memory (summed in slot order),
  // servers and channels, once
  if (s_ticked) {
    const int nf = s_n_freed;
    for (int s = tid; s < n_srv; s += nt) {
      T add = static_cast<T>(0);
      bool srv_freed = false;
      for (int i = 0; i < nf; ++i) {
        const size_t at = static_cast<size_t>(s_freed[i]) * n_srv + s;
        add = add + slot_mem[at];
        srv_freed = srv_freed || slot_servers[at];
      }
      mem[s] = mem[s] + add;
      if (srv_freed) srv_job[s] = -1;
    }
    if (nf) {
      for (int ch = tid; ch < n_chan; ch += nt) {
        bool chan_freed = false;
        for (int i = 0; i < nf; ++i) {
          chan_freed = chan_freed ||
                       slot_chan[static_cast<size_t>(s_freed[i]) * n_chan + ch];
        }
        if (chan_freed) chan_occ[ch] = -1;
      }
    }
  }

  // ---- the segment's counters, the in-kernel reset, the next fields
  if (sg.done != nullptr || dm.reset || fl.jtype != nullptr) {
    __syncthreads();
    const bool ended = st.done[b];
    if (tid == 0 && sg.done != nullptr) {
      const size_t td = static_cast<size_t>(b) * dm.decisions + dm.d;
      sg.done[td] = ended;
      sg.accepted[td] = st.accepted[b];
      sg.blocked[td] = st.blocked[b] + (ended ? s_running : 0);
      static_cast<T*>(sg.ret)[td] = static_cast<T*>(st.ret)[b];
      sg.completed[td] = st.completed[b];
      sg.arrived[td] = st.ptr[b];
    }
    __syncthreads();
    if (dm.reset && ended) {
      const T worker_mem = static_cast<T>(dm.worker_mem);
      for (int s = tid; s < n_srv; s += nt) mem[s] = worker_mem;
      ddls::block_fill(srv_job, sizeof(int) * n_srv, 0xff);
      ddls::block_fill(chan_occ, sizeof(int) * n_chan, 0xff);
      ddls::block_fill(slot_valid, R, 0);
      ddls::block_fill(slot_t_done, sizeof(T) * R, 0);
      ddls::block_fill(slot_mem, sizeof(T) * R * n_srv, 0);
      ddls::block_fill(slot_servers, static_cast<size_t>(R) * n_srv, 0);
      ddls::block_fill(slot_chan, static_cast<size_t>(R) * n_chan, 0);
      if (tid == 0) {
        *t_p = static_cast<T>(0);
        st.queue_row[b] = 0;
        st.ptr[b] = 1;
        *next_arrival = arrival_t[1];
        st.done[b] = false;
        st.completed[b] = 0;
        st.accepted[b] = 0;
        st.blocked[b] = 0;
        static_cast<T*>(st.ret)[b] = static_cast<T>(0);
        s_running = 0;
      }
      __syncthreads();
    }
    if (fl.jtype != nullptr) {
      if (tid == 0) s_occupied = 0;
      __syncthreads();
      int occupied = 0;
      for (int s = tid; s < n_srv; s += nt) occupied += srv_job[s] >= 0 ? 1 : 0;
      if (occupied) atomicAdd(&s_occupied, occupied);
      __syncthreads();
      if (tid == 0) {
        const int qr = st.queue_row[b];
        const size_t at = static_cast<size_t>(b) * J + (qr > 0 ? qr : 0);
        const size_t tf =
            static_cast<size_t>(b) * (dm.decisions + 1) + dm.d + 1;
        fl.jtype[tf] = bk.type[at];
        static_cast<T*>(fl.frac)[tf] = static_cast<const T*>(bk.sla_frac)[at];
        static_cast<T*>(fl.steps)[tf] = static_cast<const T*>(bk.steps)[at];
        fl.n_occupied[tf] = s_occupied;
        fl.n_running[tf] = s_running;
      }
    }
  }

  // ---- the next decision's config row
  if (dm.prepare && tid == 0 && dm.d + 1 < dm.decisions) {
    const int action =
        actions[static_cast<size_t>(b) * dm.decisions + dm.d + 1];
    const int qr = st.queue_row[b];
    const bool next_job = qr >= 0 && !st.done[b];
    const int row = qr > 0 ? qr : 0;
    const int col = tb.deg_col[action < 0 ? 0
                               : (action >= dm.n_col ? dm.n_col - 1
                                                     : action)];
    int cfg = bk.type[static_cast<size_t>(b) * J + row] * dm.n_deg + col;
    cfg = cfg < 0 ? 0 : (cfg >= dm.n_cfg ? dm.n_cfg - 1 : cfg);
    st.cfg[b] = cfg;
    st.active[b] = next_job && action > 0 && col >= 0;
  }
}

// the config row and active flag of each lane's action (thread per lane)
__global__ void episode_prepare_kernel(
    const int* __restrict__ queue_row, const bool* __restrict__ done,
    const int* __restrict__ bank_type, const int* __restrict__ action,
    const int* __restrict__ deg_col, int* __restrict__ cfg,
    bool* __restrict__ active, int lanes, int jobs, int n_deg, int n_cfg,
    int n_col) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lanes) return;
  const int a = action[b];
  const int qr = queue_row[b];
  const bool has_job = qr >= 0 && !done[b];
  const int col = deg_col[a < 0 ? 0 : (a >= n_col ? n_col - 1 : a)];
  int c = bank_type[static_cast<size_t>(b) * jobs + (qr > 0 ? qr : 0)] *
              n_deg + col;
  c = c < 0 ? 0 : (c >= n_cfg ? n_cfg - 1 : c);
  cfg[b] = c;
  active[b] = has_job && a > 0 && col >= 0;
}

}  // namespace

// The state (sim/device_env.py STATE_FIELDS order), the trace
// (TRACE_FIELDS), the bank (BANK_FIELDS), actions [B, D] int32 (null
// without prepare), the decision's kernel outputs (ots, new_mem, ok_place,
// is_flow, chan, finite_ok, t_step (every t_step_stride-th element),
// ok_la, the lookahead's ticks), the tables op_valid [K, N], seq_compute
// [K], deg_col [n_col], n_deps and n_ops [K] int32 (each configuration's
// valid prefixes), the segment's counters (SEGMENT_TRACE_FIELDS,
// [B, D], null for none) and the observation fields (OBS_FIELDS, [B, D +
// 1], null for none); then the sizes, decision d, whether to prepare the
// next decision from actions and whether to reset an ended episode; the
// constants sim_end, eps, the success and fail rewards and the worker
// memory; floats of the type is_f64 names; then the scenario's tables
// (speeds [n_srv], t0, t1, rate [n_win] of that type, kind and res [n_win]
// int32; speeds null for none) and n_win; last the forms to take even where
// the surface's shared memory does not need them (kOccGlobal | kMaskFree)
// and warp 0's slots a lane (4, 8, 16 or 32 with 32 of them at least the
// slots; 0 for the memory form: sim/device_env.py episode_slots_a_lane).
DDLS_EXPORT int ddls_episode_step(
    void* t, void* mem, void* srv_job, void* chan_occ, void* slot_valid,
    void* slot_t_done, void* slot_mem, void* slot_servers, void* slot_chan,
    void* queue_row, void* ptr, void* next_arrival, void* done,
    void* completed, void* accepted, void* blocked, void* ret, void* cfg,
    void* active, void* ticks, void* tr_reward, void* tr_accept,
    void* tr_cause, void* tr_jct, void* tr_t, void* tr_has_job,
    const void* bank_type, const void* bank_steps, const void* bank_sla,
    const void* bank_arrival, const void* actions, const void* ots,
    const void* new_mem, const void* ok_place, const void* is_flow,
    const void* chan, const void* finite_ok, const void* t_step,
    const void* ok_la, const void* la_ticks, const void* op_valid,
    const void* seq_compute, const void* deg_col, const void* n_deps,
    const void* n_ops, void* seg_done,
    void* seg_accepted, void* seg_blocked, void* seg_ret,
    void* seg_completed, void* seg_arrived, void* f_jtype, void* f_frac,
    void* f_steps, void* f_occupied, void* f_running, int lanes, int n_srv,
    int n_chan, int slots, int n, int m, int jobs, int decisions, int d,
    int n_deg, int n_cfg, int n_col, int t_step_stride, int prepare,
    int reset, double sim_end, double eps, double success, double fail,
    double worker_mem, int is_f64, const void* sc_speeds, const void* sc_t0,
    const void* sc_t1, const void* sc_rate, const void* sc_kind,
    const void* sc_res, int n_win, int forms, int ks, void* stream) {
  const bool scenario = sc_speeds != nullptr;
  if (lanes <= 0 || n_srv < 1 || n_chan < 1 || slots < 1 || n < 1 || m < 1 ||
      jobs < 1 || d < 0 || d >= decisions || n_col < 1 || n_cfg < 1 ||
      forms < 0 || forms > (kOccGlobal | kMaskFree) ||
      !(ks == 0 || ((ks == 4 || ks == 8 || ks == 16 || ks == 32) &&
                    ks * ddls::kWarpSize >= slots)) ||
      n_deps == nullptr ||
      n_ops == nullptr || (prepare && actions == nullptr) || n_win < 0 ||
      (scenario && n_win > 0 &&
       (sc_t0 == nullptr || sc_t1 == nullptr || sc_rate == nullptr ||
        sc_kind == nullptr || sc_res == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const State st{t, mem, static_cast<int*>(srv_job),
                 static_cast<int*>(chan_occ), static_cast<bool*>(slot_valid),
                 slot_t_done, slot_mem, static_cast<bool*>(slot_servers),
                 static_cast<bool*>(slot_chan), static_cast<int*>(queue_row),
                 static_cast<int*>(ptr), next_arrival,
                 static_cast<bool*>(done), static_cast<int*>(completed),
                 static_cast<int*>(accepted), static_cast<int*>(blocked), ret,
                 static_cast<int*>(cfg), static_cast<bool*>(active),
                 static_cast<int*>(ticks)};
  const Trace tr{tr_reward, static_cast<bool*>(tr_accept),
                 static_cast<int*>(tr_cause), tr_jct, tr_t,
                 static_cast<bool*>(tr_has_job)};
  const Bank bk{static_cast<const int*>(bank_type), bank_steps, bank_sla,
                bank_arrival};
  const Raw raw{static_cast<const int*>(ots), new_mem,
                static_cast<const bool*>(ok_place),
                static_cast<const bool*>(is_flow),
                static_cast<const int*>(chan),
                static_cast<const bool*>(finite_ok), t_step,
                static_cast<const bool*>(ok_la),
                static_cast<const int*>(la_ticks)};
  const Seg sg{static_cast<bool*>(seg_done), static_cast<int*>(seg_accepted),
               static_cast<int*>(seg_blocked), seg_ret,
               static_cast<int*>(seg_completed),
               static_cast<int*>(seg_arrived)};
  const Fields fl{static_cast<int*>(f_jtype), f_frac, f_steps,
                  static_cast<int*>(f_occupied),
                  static_cast<int*>(f_running)};
  // each form the shared memory needs, beyond those forced
  int budget = 0;
  const int rc = ddls::smem_optin(&budget);
  if (rc != 0) return rc;
  const int wins = scenario ? n_win : 0;
  const auto need = [&](int f) {
    return episode_smem(n_srv, n_chan, slots, f, ks, wins);
  };
  // (less the kernel's few static bytes)
  const size_t room = static_cast<size_t>(budget) - 256;
  if (need(forms) > room) forms |= kOccGlobal;
  if (need(forms) > room) forms |= kMaskFree;
  const size_t smem = need(forms);
  const Dims dm{n_srv, n_chan, slots, n, m, jobs, decisions, d, n_deg, n_cfg,
                n_col, t_step_stride, prepare, reset, forms, sim_end, eps,
                success, fail, worker_mem};
  const Scenario sc{sc_speeds, sc_t0, sc_t1, sc_rate,
                    static_cast<const int*>(sc_kind),
                    static_cast<const int*>(sc_res), scenario ? n_win : 0};
  const Tables tb{static_cast<const bool*>(op_valid), seq_compute,
                  static_cast<const int*>(deg_col),
                  static_cast<const int*>(n_deps),
                  static_cast<const int*>(n_ops)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* acts = static_cast<const int*>(actions);
  const auto launch = [&](auto kernel) {
    const cudaError_t err = ddls::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<lanes, kThreads, smem, s>>>(st, tr, bk, acts, raw, tb, sg, fl,
                                         dm, sc);
    return static_cast<int>(cudaGetLastError());
  };
  // the instance of the float type, the mode and the slots a lane
  const auto by_slots = [&](auto of) {
    switch (ks) {
      case 4: return launch(of(std::integral_constant<int, 4>{}));
      case 8: return launch(of(std::integral_constant<int, 8>{}));
      case 16: return launch(of(std::integral_constant<int, 16>{}));
      case 32: return launch(of(std::integral_constant<int, 32>{}));
      default: return launch(of(std::integral_constant<int, 0>{}));
    }
  };
  if (is_f64) {
    return scenario ? by_slots([](auto k) {
      return episode_step_kernel<double, true, decltype(k)::value>;
    })
                    : by_slots([](auto k) {
                        return episode_step_kernel<double, false,
                                                   decltype(k)::value>;
                      });
  }
  return scenario ? by_slots([](auto k) {
    return episode_step_kernel<float, true, decltype(k)::value>;
  })
                  : by_slots([](auto k) {
                      return episode_step_kernel<float, false,
                                                 decltype(k)::value>;
                    });
}

// queue_row [B], done [B], bank type [B, J], action [B] int32, deg_col
// [n_col]; out cfg [B], active [B].
DDLS_EXPORT int ddls_episode_prepare(const void* queue_row, const void* done,
                                     const void* bank_type,
                                     const void* action, const void* deg_col,
                                     void* cfg, void* active, int lanes,
                                     int jobs, int n_deg, int n_cfg,
                                     int n_col, void* stream) {
  if (lanes <= 0 || jobs < 1 || n_deg < 1 || n_cfg < 1 || n_col < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kPrepareThreads = 128;
  episode_prepare_kernel<<<ddls::grid_for(lanes, kPrepareThreads),
                           kPrepareThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(queue_row), static_cast<const bool*>(done),
      static_cast<const int*>(bank_type), static_cast<const int*>(action),
      static_cast<const int*>(deg_col), static_cast<int*>(cfg),
      static_cast<bool*>(active), lanes, jobs, n_deg, n_cfg, n_col);
  return static_cast<int>(cudaGetLastError());
}
