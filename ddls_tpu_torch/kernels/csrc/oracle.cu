// K29 price_reduce and K30 oracle_select: in-kernel candidate pricing's
// last step and the OracleJCT heuristic's choice of degree.
//
// K29 replaces the reduction at the end of ddls_tpu/sim/jax_env.py:1085
// price_all (over :1023 eval_cfg, vmapped over the config axis): for each
// of the B * n_deg rows that evaluated config type[row] * n_deg + j of
// lane row / n_deg (placement K23, pricing K24, the lookahead K21, all
// without a commit), the candidate's verdict and price:
//   ok  = ok_place & ok_chan & ok_la & finite_ok,
//   ok_chan = every dep is not a flow or its channel is free in the lane's
//             live occupancy (chan_occ[lane, chan] < 0),
//   jct = t_step * steps (one rounding, the episode's float type).
// A lane with no queued job (or whose episode ended) writes ok = false and
// jct = 0 for every degree: the reference prices only inside its has-job
// branch, so these rows are never read.
//
// K30 replaces the choice in :1799 make_oracle_episode_fn (:1831-1869), the
// device counterpart of envs/baselines.py OracleJCT.compute_action: with
// the observation's action mask restricted to the degrees (:1395
// _kernel_action_mask: 1 needs a free server, an even degree d needs d free
// servers and a symmetric block shape), the limit
//   max_jct = sla_frac * (orig_seq_sum[type] * steps)
// (the unpartitioned job's sequential sum, in that association order and
// the episode's float type), the action is the smallest degree with
// mask & ok & jct <= max_jct; else the smallest-JCT degree with mask & ok
// by a strict < scan in degree order (the first minimum wins); else the
// smallest degree the mask allows; else 0. Lanes with no queued job take
// action 0, as the reference's skip branch.
//
// What bounds them on the H100: launch latency. K29 reads each row's
// valid prefix of flow flags and channels (21 to 13,072 deps a row on the
// shipped surface, up to ~65 KB) and writes two values a row; K30 reads
// ~200 bytes a lane. The design: K29 one CTA of 1,024 threads a row; a
// row that cannot pass (no job, or ok_place, ok_la or finite_ok false:
// ok is a conjunction) skips the scan; the others stage their lane's
// channel occupancy in shared memory (where a surface's channels do not
// fit the opt-in shared memory, they read it from global memory where the
// scan meets a flow instead: the same test, the same bits), scan only
// [0, n_deps) of the row's
// configuration cfg[r] (K24 writes every dep past it as no flow), flags
// 16 and channels 4 at a time (common.cuh for_each_flow), and AND the
// channel test over the block with __syncthreads_and (an AND is exact in
// any order). K30 one thread a lane, the degree scans sequential in
// degree order as the reference's. No float atomics; built with
// -fmad=false (kernels/__init__.py EXTRA_FLAGS): nothing here adds a
// product, and nothing may be fused.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kReduceThreads = 1024;
constexpr int kSelectThreads = 64;

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kReduceThreads) price_reduce_kernel(
    const bool* __restrict__ is_flow, const int* __restrict__ chan,
    const bool* __restrict__ ok_place, const bool* __restrict__ finite_ok,
    const T* __restrict__ t_step, const bool* __restrict__ ok_la,
    const int* __restrict__ chan_occ, const int* __restrict__ queue_row,
    const bool* __restrict__ done, const T* __restrict__ bank_steps,
    const int* __restrict__ cfg, const int* __restrict__ n_deps,
    bool* __restrict__ ok_out, T* __restrict__ jct_out, int n_deg, int m,
    int n_chan, int n_jobs, int t_stride) {
  extern __shared__ int s_occ[];  // [n_chan] the lane's channel occupancy
  const int r = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = r / n_deg;
  const int row = queue_row[lane];
  if (!(row >= 0 && !done[lane])) {
    if (tid == 0) {
      ok_out[r] = false;
      jct_out[r] = static_cast<T>(0);
    }
    return;
  }
  const T steps = bank_steps[static_cast<size_t>(lane) * n_jobs + row];
  const T jct = t_step[static_cast<size_t>(r) * t_stride] * steps;
  if (!(ok_place[r] && ok_la[r] && finite_ok[r])) {
    if (tid == 0) {
      ok_out[r] = false;
      jct_out[r] = jct;
    }
    return;
  }
  const int* occ = chan_occ + static_cast<size_t>(lane) * n_chan;
  if (kStaged) {
    for (int i = tid; i < n_chan; i += blockDim.x) s_occ[i] = occ[i];
    __syncthreads();
  }
  const int nd = min(max(n_deps[cfg[r]], 0), m);
  int free_chan = 1;
  ddls::for_each_flow(is_flow + static_cast<size_t>(r) * m,
                      chan + static_cast<size_t>(r) * m, nd, [&](int c) {
                        if ((kStaged ? s_occ : occ)[c] >= 0) free_chan = 0;
                      });
  const int all_free = __syncthreads_and(free_chan);
  if (tid == 0) {
    ok_out[r] = all_free != 0;
    jct_out[r] = jct;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSelectThreads) oracle_select_kernel(
    const bool* __restrict__ ok, const T* __restrict__ jct,
    const int* __restrict__ srv_job, const int* __restrict__ queue_row,
    const bool* __restrict__ done, const int* __restrict__ bank_type,
    const T* __restrict__ bank_steps, const T* __restrict__ bank_frac,
    const T* __restrict__ orig_seq_sum,
    const bool* __restrict__ shapes_exist, const int* __restrict__ degrees,
    int* __restrict__ action_out, int lanes, int n_deg, int n_srv,
    int n_jobs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= lanes) return;
  const int row = queue_row[b];
  if (!(row >= 0 && !done[b])) {
    action_out[b] = 0;
    return;
  }
  int occupied = 0;
  for (int s = 0; s < n_srv; ++s) {
    occupied += srv_job[static_cast<size_t>(b) * n_srv + s] >= 0;
  }
  const int free_srv = n_srv - occupied;
  const size_t at = static_cast<size_t>(b) * n_jobs + row;
  const T steps = bank_steps[at];
  const T max_jct = bank_frac[at] * (orig_seq_sum[bank_type[at]] * steps);
  const bool* lane_ok = ok + static_cast<size_t>(b) * n_deg;
  const T* lane_jct = jct + static_cast<size_t>(b) * n_deg;
  int first_acc = -1, best_deg = -1, first_valid = -1;
  T best_jct = static_cast<T>(INFINITY);
  for (int j = 0; j < n_deg; ++j) {
    const int d = degrees[j];
    const bool valid = d == 0 || (d == 1 && free_srv >= 1) ||
                       (d > 1 && d % 2 == 0 && d <= free_srv &&
                        shapes_exist[d]);
    if (!valid) continue;
    if (first_valid < 0) first_valid = d;
    if (!lane_ok[j]) continue;
    const T v = lane_jct[j];
    if (first_acc < 0 && v <= max_jct) first_acc = d;
    if (v < best_jct) {
      best_jct = v;
      best_deg = d;
    }
  }
  action_out[b] = first_acc >= 0 ? first_acc
                  : best_deg >= 0 ? best_deg
                  : first_valid >= 0 ? first_valid : 0;
}

}  // namespace

// K29: per row r of R = lanes * n_deg: is_flow [R, M] bools, chan [R, M]
// int32, ok_place / finite_ok / ok_la [R] bools, t_step [R] floats
// `t_stride` apart (is_f64 names the type); per lane: chan_occ [B, n_chan]
// int32, queue_row [B] int32, done [B] bools, bank steps [B, J] floats;
// the row's configuration cfg [R] int32 and the table n_deps [K] int32
// (its valid prefix); out ok [B, n_deg] bools, jct [B, n_deg] floats; then
// the sizes and `occ_global` (1: read the occupancy from global memory even
// where it fits shared memory; the tests hold both forms).
DDLS_EXPORT int ddls_price_reduce(const void* is_flow, const void* chan,
                                  const void* ok_place, const void* finite_ok,
                                  const void* t_step, const void* ok_la,
                                  const void* chan_occ, const void* queue_row,
                                  const void* done, const void* bank_steps,
                                  const void* cfg, const void* n_deps,
                                  void* ok, void* jct, int lanes, int n_deg,
                                  int m, int n_chan, int n_jobs, int t_stride,
                                  int is_f64, int occ_global, void* stream) {
  if (lanes <= 0 || n_deg < 1 || m < 1 || n_chan < 1 || n_jobs < 1 ||
      t_stride < 1 || cfg == nullptr || n_deps == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = lanes * n_deg;
  int budget = 0;
  const int rc = ddls::smem_optin(&budget);
  if (rc != 0) return rc;
  // the occupancy staged where it fits the opt-in shared memory
  const size_t occ_bytes = static_cast<size_t>(n_chan) * sizeof(int);
  const int staged = !occ_global && occ_bytes <= static_cast<size_t>(budget);
  const size_t smem = staged ? occ_bytes : 0;
  const bool* flow = static_cast<const bool*>(is_flow);
  const int* ch = static_cast<const int*>(chan);
  const bool* place = static_cast<const bool*>(ok_place);
  const bool* fin = static_cast<const bool*>(finite_ok);
  const bool* la = static_cast<const bool*>(ok_la);
  const int* occ = static_cast<const int*>(chan_occ);
  const int* qr = static_cast<const int*>(queue_row);
  const bool* dn = static_cast<const bool*>(done);
  const int* c = static_cast<const int*>(cfg);
  const int* nd = static_cast<const int*>(n_deps);
  const auto launch = [&](auto kernel, const auto* t, const auto* steps,
                          auto* jct_out) {
    const cudaError_t err = ddls::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<rows, kReduceThreads, smem, s>>>(
        flow, ch, place, fin, t, la, occ, qr, dn, steps, c, nd,
        static_cast<bool*>(ok), jct_out, n_deg, m, n_chan, n_jobs, t_stride);
    return static_cast<int>(cudaGetLastError());
  };
  if (is_f64) {
    const double* t = static_cast<const double*>(t_step);
    const double* steps = static_cast<const double*>(bank_steps);
    double* out = static_cast<double*>(jct);
    return staged ? launch(price_reduce_kernel<double, true>, t, steps, out)
                  : launch(price_reduce_kernel<double, false>, t, steps, out);
  }
  const float* t = static_cast<const float*>(t_step);
  const float* steps = static_cast<const float*>(bank_steps);
  float* out = static_cast<float*>(jct);
  return staged ? launch(price_reduce_kernel<float, true>, t, steps, out)
                : launch(price_reduce_kernel<float, false>, t, steps, out);
}

// K30: ok [B, n_deg] bools, jct [B, n_deg] floats (K29's), srv_job
// [B, n_srv] int32, queue_row [B] int32, done [B] bools, the bank's type
// [B, J] int32, steps and sla_frac [B, J] floats, orig_seq_sum [K] floats
// (is_f64 names the type), shapes_exist [A] bools, degrees [n_deg] int32;
// out action [B] int32.
DDLS_EXPORT int ddls_oracle_select(const void* ok, const void* jct,
                                   const void* srv_job, const void* queue_row,
                                   const void* done, const void* bank_type,
                                   const void* bank_steps,
                                   const void* bank_frac,
                                   const void* orig_seq_sum,
                                   const void* shapes_exist,
                                   const void* degrees, void* action,
                                   int lanes, int n_deg, int n_srv,
                                   int n_jobs, int is_f64, void* stream) {
  if (lanes <= 0 || n_deg < 1 || n_srv < 1 || n_jobs < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = ddls::grid_for(lanes, kSelectThreads);
  if (is_f64) {
    oracle_select_kernel<double><<<grid, kSelectThreads, 0, s>>>(
        static_cast<const bool*>(ok), static_cast<const double*>(jct),
        static_cast<const int*>(srv_job), static_cast<const int*>(queue_row),
        static_cast<const bool*>(done), static_cast<const int*>(bank_type),
        static_cast<const double*>(bank_steps),
        static_cast<const double*>(bank_frac),
        static_cast<const double*>(orig_seq_sum),
        static_cast<const bool*>(shapes_exist),
        static_cast<const int*>(degrees), static_cast<int*>(action), lanes,
        n_deg, n_srv, n_jobs);
  } else {
    oracle_select_kernel<float><<<grid, kSelectThreads, 0, s>>>(
        static_cast<const bool*>(ok), static_cast<const float*>(jct),
        static_cast<const int*>(srv_job), static_cast<const int*>(queue_row),
        static_cast<const bool*>(done), static_cast<const int*>(bank_type),
        static_cast<const float*>(bank_steps),
        static_cast<const float*>(bank_frac),
        static_cast<const float*>(orig_seq_sum),
        static_cast<const bool*>(shapes_exist),
        static_cast<const int*>(degrees), static_cast<int*>(action), lanes,
        n_deg, n_srv, n_jobs);
  }
  return static_cast<int>(cudaGetLastError());
}
