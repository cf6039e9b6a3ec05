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
// Arithmetic as the reference's: jct = t_step * steps, max_jct = (sla_frac
// * seq_compute) * steps, the commit time t + jct, each rounded on its own
// (the file is built with -fmad=false, kernels/__init__.py EXTRA_FLAGS);
// a completion frees its slot when done - t - eps <= 0, an arrival queues
// when t + eps >= its time; the freed memory is the completing slots'
// rows summed in slot order (the reference's completions @ slot_mem: the
// products are exact, only the order of the sum matters), then added.
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

struct Dims {
  int n_srv, n_chan, slots, n, m, jobs, decisions, d, n_deg, n_cfg, n_col,
      t_step_stride;
  double sim_end, eps, success, fail;
};

// the reference's cause codes (sim/device_env.py CAUSE_*)
constexpr int kAccepted = 0, kNotHandled = 1, kOpPlacement = 2,
              kDepPlacement = 3, kSla = 4, kEngine = 5;

template <typename T>
__global__ void __launch_bounds__(kThreads) episode_step_kernel(
    State st, Trace tr, Bank bk, const int* __restrict__ actions, Raw raw,
    const bool* __restrict__ op_valid, const T* __restrict__ seq_compute,
    const int* __restrict__ deg_col, Dims dm) {
  extern __shared__ unsigned char smem[];
  unsigned char* s_srv = smem;                 // [n_srv] server mask
  unsigned char* s_chan = s_srv + dm.n_srv;    // [n_chan] channel mask
  unsigned char* s_comp = s_chan + dm.n_chan;  // [slots] completions
  __shared__ int s_ok_chan, s_accept, s_slot, s_live;

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

  // ---- the next decision's config row
  if (tid == 0 && dm.d + 1 < dm.decisions) {
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

}  // namespace

// The state (sim/device_env.py STATE_FIELDS order), the trace
// (TRACE_FIELDS), the bank (BANK_FIELDS), actions [B, D] int32, the
// decision's kernel outputs (ots, new_mem, ok_place, is_flow, chan,
// finite_ok, t_step (every t_step_stride-th element), ok_la, the
// lookahead's ticks), the tables op_valid [K, N], seq_compute [K] and
// deg_col [n_col]; then the sizes and decision d; the constants sim_end,
// eps, the success and fail rewards; floats of the type is_f64 names.
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
    const void* seq_compute, const void* deg_col, int lanes, int n_srv,
    int n_chan, int slots, int n, int m, int jobs, int decisions, int d,
    int n_deg, int n_cfg, int n_col, int t_step_stride, double sim_end,
    double eps, double success, double fail, int is_f64, void* stream) {
  if (lanes <= 0 || n_srv < 1 || n_chan < 1 || slots < 1 || n < 1 || m < 1 ||
      jobs < 1 || d < 0 || d >= decisions || n_col < 1 || n_cfg < 1) {
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
  const Dims dm{n_srv, n_chan, slots, n, m, jobs, decisions, d, n_deg, n_cfg,
                n_col, t_step_stride, sim_end, eps, success, fail};
  const size_t smem = static_cast<size_t>(n_srv) + n_chan + slots;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    episode_step_kernel<double><<<lanes, kThreads, smem, s>>>(
        st, tr, bk, static_cast<const int*>(actions), raw,
        static_cast<const bool*>(op_valid),
        static_cast<const double*>(seq_compute),
        static_cast<const int*>(deg_col), dm);
  } else {
    episode_step_kernel<float><<<lanes, kThreads, smem, s>>>(
        st, tr, bk, static_cast<const int*>(actions), raw,
        static_cast<const bool*>(op_valid),
        static_cast<const float*>(seq_compute),
        static_cast<const int*>(deg_col), dm);
  }
  return static_cast<int>(cudaGetLastError());
}
