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
// when t + eps >= its time; the freed memory is the completing slots'
// rows summed in slot order, then added (the reference's completions @
// slot_mem: a server belongs to at most one slot, so each column sums at
// most one nonzero row and every order gives the same bits).
//
// The scenario mode (the failure walk, ddls_tpu/scenarios/failures.py:137
// inflate_duration_jax as sim/jax_env.py:1014 scenario_adjusted applies it
// at :1138-1141): with the scenario's tables (per-server speeds, the
// t0-sorted windows' t0, t1, rate, kind and resource), thread 0 inflates a
// deciding lane's jct after the gate, before the trace and the commit:
// r0, the slowest speed over the block's server mask (inf when it is
// empty); t_done = t + jct / r0; then each window that touches the lane
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
// and pricing outputs (~30 KB at M = 13,072 deps) and writes a few hundred
// bytes of state, and a tick touches 32 slots x 1,024 servers and channels;
// the card could do either in well under a microsecond. The work is a few
// dependent steps, each a block-wide pass and a barrier: the design keeps
// the scalars of the decision and of each tick on one thread in shared
// memory and spreads only the per-server and per-channel passes over the
// block. No float atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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
      t_step_stride, prepare, reset;
  double sim_end, eps, success, fail, worker_mem;
};

// the reference's cause codes (sim/device_env.py CAUSE_*)
constexpr int kAccepted = 0, kNotHandled = 1, kOpPlacement = 2,
              kDepPlacement = 3, kSla = 4, kEngine = 5;

// the failure walk of one lane (thread 0): the jct of a job of nominal
// duration jct starting at t on the servers srv and channels chan
template <typename T>
__device__ T failure_walk(const Scenario& sc, T t, T jct,
                          const unsigned char* srv, const unsigned char* chan,
                          int n_srv) {
  const T* speeds = static_cast<const T*>(sc.speeds);
  const T* t0 = static_cast<const T*>(sc.t0);
  const T* t1 = static_cast<const T*>(sc.t1);
  const T* rate = static_cast<const T*>(sc.rate);
  T r0 = static_cast<T>(INFINITY);
  for (int s = 0; s < n_srv; ++s) {
    if (srv[s]) r0 = speeds[s] < r0 ? speeds[s] : r0;
  }
  T t_done = t + jct / r0;
  for (int i = 0; i < sc.n_win; ++i) {
    const T w0 = t0[i], w1 = t1[i], r = rate[i];
    const T lo = w0 > t ? w0 : t;
    const bool affects = sc.kind[i] == 0 ? srv[sc.res[i]] : chan[sc.res[i]];
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

template <typename T, bool kScenario>
__global__ void __launch_bounds__(kThreads) episode_step_kernel(
    State st, Trace tr, Bank bk, const int* __restrict__ actions, Raw raw,
    const bool* __restrict__ op_valid, const T* __restrict__ seq_compute,
    const int* __restrict__ deg_col, Seg sg, Fields fl, Dims dm,
    Scenario sc) {
  extern __shared__ unsigned char smem[];
  unsigned char* s_srv = smem;                 // [n_srv] server mask
  unsigned char* s_chan = s_srv + dm.n_srv;    // [n_chan] channel mask
  unsigned char* s_comp = s_chan + dm.n_chan;  // [slots] completions
  __shared__ int s_ok_chan, s_accept, s_slot, s_live, s_running, s_occupied;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int n_srv = dm.n_srv, n_chan = dm.n_chan, R = dm.slots;
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
  const bool* is_flow = raw.is_flow + static_cast<size_t>(b) * dm.m;
  const int* chan = raw.chan + static_cast<size_t>(b) * dm.m;
  const int J = dm.jobs;

  const int queue_row = st.queue_row[b];
  const bool has_job = queue_row >= 0 && !st.done[b];
  const bool active = st.active[b];
  const int c = st.cfg[b];

  // ---- the decision: the channel check and the two masks
  for (int s = tid; s < n_srv; s += nt) s_srv[s] = 0;
  for (int ch = tid; ch < n_chan; ch += nt) s_chan[ch] = 0;
  if (tid == 0) s_ok_chan = 1;
  __syncthreads();
  bool ok_chan = true;
  for (int j = tid; j < dm.m; j += nt) {
    if (!is_flow[j]) continue;
    const int ch = chan[j] > 0 ? chan[j] : 0;
    if (chan_occ[ch] >= 0) ok_chan = false;
    s_chan[ch] = 1;
  }
  if (!ok_chan) s_ok_chan = 0;
  const bool* valid_row = op_valid + static_cast<size_t>(c) * dm.n;
  for (int i = tid; i < dm.n; i += nt) {
    if (valid_row[i] && ots[i] >= 0) s_srv[ots[i]] = 1;
  }
  __syncthreads();

  // ---- the gate, the cause, the trace and the counters (thread 0)
  if (tid == 0) {
    const T t = *t_p;
    const int row = queue_row > 0 ? queue_row : 0;
    const size_t at = static_cast<size_t>(b) * J + row;
    const T steps = static_cast<const T*>(bk.steps)[at];
    const T sla = static_cast<const T*>(bk.sla_frac)[at];
    const T t_step = static_cast<const T*>(
        raw.t_step)[static_cast<size_t>(b) * dm.t_step_stride];
    T jct = t_step * steps;
    const T max_jct = sla * seq_compute[c] * steps;
    const bool sla_ok = !(jct > max_jct);
    const bool engine_ok = raw.ok_la[b] && raw.finite_ok[b];
    const bool ok_place = raw.ok_place[b];
    bool accept = ok_place && s_ok_chan && sla_ok && engine_ok;
    int cause = !ok_place ? kOpPlacement
                : !s_ok_chan ? kDepPlacement
                : !engine_ok ? kEngine
                : !sla_ok ? kSla : kAccepted;
    if (!active) {
      accept = false;
      cause = kNotHandled;
      jct = static_cast<T>(0);
    }
    if constexpr (kScenario) {
      if (active) jct = failure_walk(sc, t, jct, s_srv, s_chan, n_srv);
    }
    int slot = 0;
    bool all_valid = true;
    for (int r = R - 1; r >= 0; --r) {
      if (!slot_valid[r]) {
        slot = r;
        all_valid = false;
      }
    }
    accept = accept && !all_valid && has_job;
    const T reward = has_job ? static_cast<T>(accept ? dm.success : dm.fail)
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
    if (has_job) st.queue_row[b] = -1;
    if (active) st.ticks[b] += raw.la_ticks[b];
    if (accept) {
      slot_valid[slot] = true;
      slot_t_done[slot] = t + jct;
    }
    s_accept = accept;
    s_slot = slot;
  }
  __syncthreads();

  // ---- the commit into the slot
  if (s_accept) {
    const int slot = s_slot;
    for (int s = tid; s < n_srv; s += nt) {
      const T delta = mem[s] - new_mem[s];
      slot_mem[static_cast<size_t>(slot) * n_srv + s] = delta;
      slot_servers[static_cast<size_t>(slot) * n_srv + s] = s_srv[s];
      if (s_srv[s]) srv_job[s] = slot;
      mem[s] = new_mem[s];
    }
    for (int ch = tid; ch < n_chan; ch += nt) {
      slot_chan[static_cast<size_t>(slot) * n_chan + ch] = s_chan[ch];
      if (s_chan[ch]) chan_occ[ch] = slot;
    }
  }
  __syncthreads();

  // ---- the event clock: tick until a job queues or the episode ends
  const T* arrival_t =
      static_cast<const T*>(bk.arrival_t) + static_cast<size_t>(b) * (J + 1);
  const T sim_end = static_cast<T>(dm.sim_end);
  const T eps = static_cast<T>(dm.eps);
  T* next_arrival = static_cast<T*>(st.next_arrival) + b;
  while (true) {
    if (tid == 0) {
      s_live = st.queue_row[b] < 0 && !st.done[b];
      if (s_live) {
        const T t = *t_p;
        T rem = static_cast<T>(INFINITY);
        for (int r = 0; r < R; ++r) {
          if (slot_valid[r]) {
            const T left = slot_t_done[r] - t;
            rem = left < rem ? left : rem;
          }
        }
        const T to_arrival = *next_arrival - t;
        const T to_end = sim_end - t;
        T tick = to_end < to_arrival ? to_end : to_arrival;
        tick = rem < tick ? rem : tick;
        tick = tick > static_cast<T>(0) ? tick : static_cast<T>(0);
        const T t2 = t + tick;
        int n_done = 0;
        bool any_running = false;
        for (int r = 0; r < R; ++r) {
          const bool comp =
              slot_valid[r] && (slot_t_done[r] - t2 - eps <= static_cast<T>(0));
          s_comp[r] = comp;
          n_done += comp ? 1 : 0;
          if (comp) slot_valid[r] = false;
          any_running = any_running || slot_valid[r];
        }
        st.completed[b] += n_done;
        const int ptr = st.ptr[b];
        const bool arrived = ptr < J && t2 + eps >= *next_arrival;
        const int queue_row2 = arrived ? ptr : st.queue_row[b];
        const int ptr2 = ptr + (arrived ? 1 : 0);
        if (arrived) {
          *next_arrival = arrival_t[ptr2 < 0 ? 0 : (ptr2 > J ? J : ptr2)];
        }
        st.queue_row[b] = queue_row2;
        st.ptr[b] = ptr2;
        st.done[b] = t2 >= sim_end ||
                     (ptr2 >= J && !any_running && queue_row2 < 0);
        *t_p = t2;
      }
    }
    __syncthreads();
    if (!s_live) break;
    // completions free memory (summed in slot order), servers, channels
    for (int s = tid; s < n_srv; s += nt) {
      T freed = static_cast<T>(0);
      bool srv_freed = false;
      for (int r = 0; r < R; ++r) {
        if (!s_comp[r]) continue;
        freed = freed + slot_mem[static_cast<size_t>(r) * n_srv + s];
        srv_freed = srv_freed || slot_servers[static_cast<size_t>(r) * n_srv + s];
      }
      mem[s] = mem[s] + freed;
      if (srv_freed) srv_job[s] = -1;
    }
    for (int ch = tid; ch < n_chan; ch += nt) {
      bool freed = false;
      for (int r = 0; r < R; ++r) {
        freed = freed ||
                (s_comp[r] && slot_chan[static_cast<size_t>(r) * n_chan + ch]);
      }
      if (freed) chan_occ[ch] = -1;
    }
    __syncthreads();
  }

  // ---- the segment's counters, the in-kernel reset, the next fields
  if (sg.done != nullptr || dm.reset || fl.jtype != nullptr) {
    if (tid == 0) s_running = 0;
    __syncthreads();
    int running = 0;
    for (int r = tid; r < R; r += nt) running += slot_valid[r] ? 1 : 0;
    if (running) atomicAdd(&s_running, running);
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
      for (int s = tid; s < n_srv; s += nt) {
        mem[s] = worker_mem;
        srv_job[s] = -1;
      }
      for (int ch = tid; ch < n_chan; ch += nt) chan_occ[ch] = -1;
      for (int r = tid; r < R; r += nt) {
        slot_valid[r] = false;
        slot_t_done[r] = static_cast<T>(0);
      }
      for (int i = tid; i < R * n_srv; i += nt) {
        slot_mem[i] = static_cast<T>(0);
        slot_servers[i] = false;
      }
      for (int i = tid; i < R * n_chan; i += nt) slot_chan[i] = false;
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
    const int col = deg_col[action < 0 ? 0
                            : (action >= dm.n_col ? dm.n_col - 1 : action)];
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
// [K] and deg_col [n_col], the segment's counters (SEGMENT_TRACE_FIELDS,
// [B, D], null for none) and the observation fields (OBS_FIELDS, [B, D +
// 1], null for none); then the sizes, decision d, whether to prepare the
// next decision from actions and whether to reset an ended episode; the
// constants sim_end, eps, the success and fail rewards and the worker
// memory; floats of the type is_f64 names; then the scenario's tables
// (speeds [n_srv], t0, t1, rate [n_win] of that type, kind and res [n_win]
// int32; speeds null for none) and n_win.
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
    const void* seq_compute, const void* deg_col, void* seg_done,
    void* seg_accepted, void* seg_blocked, void* seg_ret,
    void* seg_completed, void* seg_arrived, void* f_jtype, void* f_frac,
    void* f_steps, void* f_occupied, void* f_running, int lanes, int n_srv,
    int n_chan, int slots, int n, int m, int jobs, int decisions, int d,
    int n_deg, int n_cfg, int n_col, int t_step_stride, int prepare,
    int reset, double sim_end, double eps, double success, double fail,
    double worker_mem, int is_f64, const void* sc_speeds, const void* sc_t0,
    const void* sc_t1, const void* sc_rate, const void* sc_kind,
    const void* sc_res, int n_win, void* stream) {
  const bool scenario = sc_speeds != nullptr;
  if (lanes <= 0 || n_srv < 1 || n_chan < 1 || slots < 1 || n < 1 || m < 1 ||
      jobs < 1 || d < 0 || d >= decisions || n_col < 1 || n_cfg < 1 ||
      (prepare && actions == nullptr) || n_win < 0 ||
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
  const Dims dm{n_srv, n_chan, slots, n, m, jobs, decisions, d, n_deg, n_cfg,
                n_col, t_step_stride, prepare, reset, sim_end, eps, success,
                fail, worker_mem};
  const Scenario sc{sc_speeds, sc_t0, sc_t1, sc_rate,
                    static_cast<const int*>(sc_kind),
                    static_cast<const int*>(sc_res), scenario ? n_win : 0};
  const size_t smem = static_cast<size_t>(n_srv) + n_chan + slots;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* acts = static_cast<const int*>(actions);
  const bool* valid = static_cast<const bool*>(op_valid);
  const int* cols = static_cast<const int*>(deg_col);
  if (is_f64) {
    const double* seq = static_cast<const double*>(seq_compute);
    if (scenario) {
      episode_step_kernel<double, true><<<lanes, kThreads, smem, s>>>(
          st, tr, bk, acts, raw, valid, seq, cols, sg, fl, dm, sc);
    } else {
      episode_step_kernel<double, false><<<lanes, kThreads, smem, s>>>(
          st, tr, bk, acts, raw, valid, seq, cols, sg, fl, dm, sc);
    }
  } else {
    const float* seq = static_cast<const float*>(seq_compute);
    if (scenario) {
      episode_step_kernel<float, true><<<lanes, kThreads, smem, s>>>(
          st, tr, bk, acts, raw, valid, seq, cols, sg, fl, dm, sc);
    } else {
      episode_step_kernel<float, false><<<lanes, kThreads, smem, s>>>(
          st, tr, bk, acts, raw, valid, seq, cols, sg, fl, dm, sc);
    }
  }
  return static_cast<int>(cudaGetLastError());
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
