// K21 lookahead: the array lookahead engine's tick loop, one CTA per lane,
// the whole loop inside the kernel (one launch per call, whatever the
// number of ticks).
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
// N + E + 4 ticks of the padded sizes; ok = finished && !stuck.
//
// What bounds it on the H100: latency, not bytes or operations. Each tick
// is a few passes over the lane's N ops and E deps with a data-dependent
// trip count (tens to hundreds of ticks), and every pass ends in a
// block-wide barrier (four a tick). The bytes it must move are the inputs
// read once and 6 numbers a lane written; the card could move them in
// microseconds. What the design does about it:
//  * lane state does not fit shared memory at the large buckets (the dep
//    arrays alone are ~21 B x 16k = 340 KB against 227 KB a block): the
//    read-only inputs and the mutable remaining times, flags and parent
//    counts stay in global memory (16 lanes at the largest bucket fit the
//    50 MB L2 many times over); shared memory holds only what each tick
//    reduces: the per-worker and per-channel best scores (sized at launch
//    from W and C, above 48 KB through cudaFuncSetAttribute; a launch that
//    is still refused returns its error), the tick's minima and flags;
//  * reductions use integer atomics in shared memory only: max and min are
//    exact in any order, so an order-preserving float -> int encoding
//    (not a plain bit cast: scores of -1 are negative) makes atomicMax and
//    atomicMin deterministic; the parent-count update is an integer add.
//    There is no float atomic anywhere;
//  * bit equality: every accumulation is written with explicit rounding
//    (__fadd_rn and friends), so nvcc contracts nothing on its own. In
//    float32, busy + tick * count is one fused multiply-add (__fmaf_rn),
//    as XLA's CPU compiler contracts it in the reference (rounding twice
//    leaves the recorded lanes' busy a float32 step off); in float64 the
//    product and the sum round apart, as the C++ engine computes them.
//    The kernel equals its plain PyTorch version bit for bit, and in
//    float32 the JAX engine's answers.
// The kernel is a template on the float type: float32 (the simulator's
// two entry points, as the reference's arrays are float32) and float64
// (the reference's x64 mode).
#include "common.cuh"

namespace {

constexpr float kBig = 3.4e38f;  // the reference's BIG (float32, also x64)
// at most 64 registers a thread, so a block of 1024 threads fits an SM
constexpr int kMaxThreads = 1024;

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
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  // busy + tick * count: rounded apart, as the C++ engine computes it
  __device__ static double busy_step(double busy, double tick, double count) {
    return __dadd_rn(busy, __dmul_rn(tick, count));
  }
};

// op / dep flags of the tick (flags_*[1]); flags_*[0] holds done
constexpr unsigned char kReady = 1;     // op ready
constexpr unsigned char kSelected = 2;  // op selected
constexpr unsigned char kFlow = 1;      // dep ready, flow
constexpr unsigned char kNonFlow = 2;   // dep ready, non-flow

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) lookahead_kernel(
    const T* __restrict__ op_remaining, const bool* __restrict__ op_valid,
    const int* __restrict__ op_worker, const T* __restrict__ op_score,
    const int* __restrict__ num_parents, const T* __restrict__ dep_remaining,
    const bool* __restrict__ dep_valid, const int* __restrict__ dep_src,
    const int* __restrict__ dep_dst, const bool* __restrict__ dep_mutual,
    const bool* __restrict__ dep_is_flow, const T* __restrict__ dep_score,
    const int* __restrict__ dep_channel,
    T* __restrict__ rem_op_ws,                 // [B, N]
    T* __restrict__ rem_dep_ws,                // [B, E]
    unsigned char* __restrict__ flags_op_ws,   // [B, 2, N]
    unsigned char* __restrict__ flags_dep_ws,  // [B, 2, E]
    int* __restrict__ parents_ws,              // [B, N]
    T* __restrict__ out_vals,                  // [B, 4]: t, comm, comp, busy
    bool* __restrict__ out_ok, int* __restrict__ out_ticks, int n, int e,
    int links, int num_workers, int num_channels) {
  using N_ = Num<T>;
  using Ord = typename N_::Ord;
  extern __shared__ long long smem_raw[];
  Ord* s_wbest = reinterpret_cast<Ord*>(smem_raw);  // [W]
  Ord* s_cbest = s_wbest + num_workers;             // [C]
  __shared__ Ord s_min_op, s_min_dep;
  __shared__ int s_any_nonflow, s_any_flow, s_nsel, s_remaining;
  __shared__ int s_stuck, s_tick_nonflow;
  __shared__ T s_tick;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t on = static_cast<size_t>(lane) * n;
  const size_t oe = static_cast<size_t>(lane) * e;
  op_remaining += on; op_valid += on; op_worker += on; op_score += on;
  num_parents += on; dep_remaining += oe; dep_valid += oe; dep_src += oe;
  dep_dst += oe; dep_mutual += oe; dep_is_flow += oe; dep_score += oe;
  dep_channel += oe * links;
  T* rem_op = rem_op_ws + on;
  T* rem_dep = rem_dep_ws + oe;
  unsigned char* op_done = flags_op_ws + 2 * on;
  unsigned char* op_flag = op_done + n;
  unsigned char* dep_done = flags_dep_ws + 2 * oe;
  unsigned char* dep_flag = dep_done + e;
  int* parent_done = parents_ws + on;

  const Ord neg_one = N_::enc(static_cast<T>(-1));
  const Ord big = N_::enc(static_cast<T>(kBig));
  if (tid == 0) {
    s_min_op = big;
    s_min_dep = big;
    s_any_nonflow = 0;
    s_any_flow = 0;
    s_nsel = 0;
    s_remaining = 0;
    s_stuck = 0;
  }
  for (int w = tid; w < num_workers; w += nthreads) s_wbest[w] = neg_one;
  for (int c = tid; c < num_channels; c += nthreads) s_cbest[c] = neg_one;
  __syncthreads();
  int valid_local = 0;
  for (int i = tid; i < n; i += nthreads) {
    rem_op[i] = op_remaining[i];
    op_done[i] = 0;
    op_flag[i] = 0;
    parent_done[i] = 0;
    valid_local += op_valid[i] ? 1 : 0;
  }
  for (int j = tid; j < e; j += nthreads) {
    rem_dep[j] = dep_remaining[j];
    dep_done[j] = 0;
    dep_flag[j] = 0;
    valid_local += dep_valid[j] ? 1 : 0;
  }
  if (valid_local) atomicAdd(&s_remaining, valid_local);
  __syncthreads();

  // thread 0's accumulators (the reference's scalars)
  T t = 0, comm = 0, comp = 0, busy = 0;
  const int max_iters = n + e + 4;
  int it = 0;
  while (s_remaining > 0 && it < max_iters) {
    // 1. readiness; per-worker and per-channel best scores
    for (int i = tid; i < n; i += nthreads) {
      const bool ready = op_valid[i] && !op_done[i] &&
                         parent_done[i] >= num_parents[i];
      op_flag[i] = ready ? kReady : 0;
      const int w = op_worker[i];
      if (ready && w >= 0 && w < num_workers) {
        atomicMax(&s_wbest[w], N_::enc(op_score[i]));
      }
    }
    for (int j = tid; j < e; j += nthreads) {
      const bool ready = dep_valid[j] && !dep_done[j] && op_done[dep_src[j]];
      unsigned char flag = 0;
      if (ready) {
        if (dep_is_flow[j]) {
          flag = kFlow;
          s_any_flow = 1;
          const Ord sc = N_::enc(dep_score[j]);
          for (int l = 0; l < links; ++l) {
            const int c = dep_channel[static_cast<size_t>(j) * links + l];
            if (c >= 0 && c < num_channels) atomicMax(&s_cbest[c], sc);
          }
        } else {
          flag = kNonFlow;
          s_any_nonflow = 1;
        }
      }
      dep_flag[j] = flag;
    }
    __syncthreads();

    // 2. selection and the two bounds
    int nsel_local = 0;
    for (int i = tid; i < n; i += nthreads) {
      if (!(op_flag[i] & kReady)) continue;
      const int w = op_worker[i];
      if (w < 0 || w >= num_workers) continue;
      const Ord best = s_wbest[w];
      if (op_score[i] == N_::dec(best) && N_::dec(best) > static_cast<T>(0)) {
        op_flag[i] = kReady | kSelected;
        ++nsel_local;
        atomicMin(&s_min_op, N_::enc(rem_op[i]));
      }
    }
    if (nsel_local) atomicAdd(&s_nsel, nsel_local);
    if (!s_any_nonflow) {
      for (int j = tid; j < e; j += nthreads) {
        if (dep_flag[j] != kFlow) continue;
        const T sc = dep_score[j];
        bool nominated = false;
        for (int l = 0; l < links; ++l) {
          const int c = dep_channel[static_cast<size_t>(j) * links + l];
          if (c >= 0 && c < num_channels && sc >= N_::dec(s_cbest[c]) &&
              sc > static_cast<T>(0)) {
            nominated = true;
          }
        }
        if (nominated) atomicMin(&s_min_dep, N_::enc(rem_dep[j]));
      }
    }
    __syncthreads();

    // 3. the tick, the accumulators, and the reset for the next tick
    if (tid == 0) {
      const T shortest_op = N_::dec(s_min_op);
      const T shortest_comm =
          s_any_nonflow ? static_cast<T>(0) : N_::dec(s_min_dep);
      const T tick = shortest_op < shortest_comm ? shortest_op
                                                 : shortest_comm;
      const bool stuck = tick >= static_cast<T>(kBig);
      s_tick = tick;
      s_stuck = stuck;
      s_tick_nonflow = s_any_nonflow;
      if (!stuck) {
        const bool ticked_ops = s_nsel > 0;
        const bool ticked_flows = !s_any_nonflow && s_any_flow;
        comp = N_::add(comp, ticked_ops ? tick : static_cast<T>(0));
        comm = N_::add(comm, ticked_flows ? tick : static_cast<T>(0));
        busy = N_::busy_step(busy, tick, static_cast<T>(s_nsel));
        t = N_::add(t, tick);
      }
      s_min_op = big;
      s_min_dep = big;
      s_any_nonflow = 0;
      s_any_flow = 0;
      s_nsel = 0;
    }
    __syncthreads();
    ++it;
    // a stuck tick adds nothing (the reference's safe_tick is 0) and ends
    // the lane
    if (s_stuck) break;

    // 4.-6. advance ops and deps; count completions and parents
    const T tick = s_tick;
    const bool nonflow = s_tick_nonflow;
    int done_local = 0;
    for (int i = tid; i < n; i += nthreads) {
      if (!(op_flag[i] & kSelected)) continue;
      T r = N_::sub(rem_op[i], tick);
      r = r > static_cast<T>(0) ? r : static_cast<T>(0);
      rem_op[i] = r;
      if (r <= static_cast<T>(0)) {
        op_done[i] = 1;
        ++done_local;
      }
    }
    const unsigned char advance = nonflow ? kNonFlow : kFlow;
    for (int j = tid; j < e; j += nthreads) {
      if (dep_flag[j] != advance) continue;
      T r = N_::sub(rem_dep[j], tick);
      r = r > static_cast<T>(0) ? r : static_cast<T>(0);
      rem_dep[j] = r;
      if (r <= static_cast<T>(0)) {
        dep_done[j] = 1;
        ++done_local;
        if (!dep_mutual[j]) atomicAdd(&parent_done[dep_dst[j]], 1);
      }
    }
    if (done_local) atomicSub(&s_remaining, done_local);
    for (int w = tid; w < num_workers; w += nthreads) s_wbest[w] = neg_one;
    for (int c = tid; c < num_channels; c += nthreads) s_cbest[c] = neg_one;
    __syncthreads();
  }
  if (tid == 0) {
    T* out = out_vals + 4 * static_cast<size_t>(lane);
    out[0] = t;
    out[1] = comm;
    out[2] = comp;
    out[3] = busy;
    out_ok[lane] = s_remaining == 0 && !s_stuck;
    out_ticks[lane] = it;
  }
}

int threads_for(int n, int e) {
  int threads = 128;
  while (threads < kMaxThreads && threads * 8 < n + e) threads *= 2;
  return threads;
}

template <typename T>
int launch(const void* const* in, void* rem_op, void* rem_dep,
           void* flags_op, void* flags_dep, void* parents, void* out_vals,
           void* out_ok, void* out_ticks, int lanes, int n, int e, int links,
           int num_workers, int num_channels, cudaStream_t stream) {
  using Ord = typename Num<T>::Ord;
  const size_t smem =
      static_cast<size_t>(num_workers + num_channels) * sizeof(Ord);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lookahead_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lookahead_kernel<T><<<lanes, threads_for(n, e), smem, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const bool*>(in[1]),
      static_cast<const int*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const int*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const bool*>(in[6]), static_cast<const int*>(in[7]),
      static_cast<const int*>(in[8]), static_cast<const bool*>(in[9]),
      static_cast<const bool*>(in[10]), static_cast<const T*>(in[11]),
      static_cast<const int*>(in[12]), static_cast<T*>(rem_op),
      static_cast<T*>(rem_dep), static_cast<unsigned char*>(flags_op),
      static_cast<unsigned char*>(flags_dep), static_cast<int*>(parents),
      static_cast<T*>(out_vals), static_cast<bool*>(out_ok),
      static_cast<int*>(out_ticks), n, e, links, num_workers, num_channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The thirteen inputs in jax_lookahead's order, each with a leading lane
// axis ([B, N] ops, [B, E] deps, [B, E, L] dep_channel; floats of the type
// `is_f64` names, bools as one byte, the rest int32), the working state
// (uninitialised; the kernel sets it up), then the outputs.
DDLS_EXPORT int ddls_lookahead(
    const void* op_remaining, const void* op_valid, const void* op_worker,
    const void* op_score, const void* num_parents, const void* dep_remaining,
    const void* dep_valid, const void* dep_src, const void* dep_dst,
    const void* dep_mutual, const void* dep_is_flow, const void* dep_score,
    const void* dep_channel, void* rem_op, void* rem_dep, void* flags_op,
    void* flags_dep, void* parents, void* out_vals, void* out_ok,
    void* out_ticks, int lanes, int n, int e, int links, int num_workers,
    int num_channels, int is_f64, void* stream) {
  const void* in[13] = {op_remaining, op_valid, op_worker, op_score,
                        num_parents, dep_remaining, dep_valid, dep_src,
                        dep_dst, dep_mutual, dep_is_flow, dep_score,
                        dep_channel};
  if (lanes <= 0 || n < 0 || e < 0 || links < 1 || num_workers < 1 ||
      num_channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_f64) {
    return launch<double>(in, rem_op, rem_dep, flags_op, flags_dep, parents,
                          out_vals, out_ok, out_ticks, lanes, n, e, links,
                          num_workers, num_channels,
                          static_cast<cudaStream_t>(stream));
  }
  return launch<float>(in, rem_op, rem_dep, flags_op, flags_dep, parents,
                       out_vals, out_ok, out_ticks, lanes, n, e, links,
                       num_workers, num_channels,
                       static_cast<cudaStream_t>(stream));
}
