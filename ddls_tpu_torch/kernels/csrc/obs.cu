// K26 kernel_obs: the policy's observation of a queued job, rebuilt from
// compact fields, for R rows (the B lanes of a segment step, or every
// (lane, step) row of a collected segment).
//
// Replaces ddls_tpu/sim/jax_env.py:1409 _kernel_obs and :1395
// _kernel_action_mask (vmapped over rows by rebuild_obs_batch, :1766). A
// row's inputs are its job type, SLA fraction, training steps, occupied
// server count and running job count; its outputs the graph features
// [G] float32 and the action mask [A] int32. The graph features are the
// type's static row (the host encoder's observation of the model's
// prototype, built once) with entries 2, 3, 4, 5, 8, 15 and 16 rebuilt,
// the first G - A entries clipped to [0, 1] and cast to float32 last, then
// the mask as floats. The static node and edge rows are not written here:
// the forward's batch gathers them by type with K20 (sim/device_env.py
// DeviceObs.forward_batch) and rebuild_obs_batch with index gathers.
//
// Arithmetic: the reference's. In float64 (x64) the host encoder's
// (envs/obs.py): seq = orig_seq_sum * steps, max_jct = frac * seq, each
// entry (val - lo) / (hi - lo), the occupancy fractions count / n_srv; so
// the row is bit-equal to the host's. In float32 the program XLA compiles
// for the reference on the CPU: (val - lo) times the float32 reciprocal of
// hi - lo, and frac * seq - lo one fused multiply-add (measured against
// jax.jit of _kernel_obs, tests/test_torch_device_collect.py). Bounds with
// hi == lo give 1.0. The file builds with -fmad=false, so nvcc fuses
// nothing else.
//
// With candidate prices (the price-feature observation, :1492-1512 and
// :1437-1441; envs/obs.py _price_features), the row's K29 output (ok and
// jct [n_deg] of the queued job's degrees) appends A more entries after
// the mask: for an action a that is a degree column j whose candidate is
// ok and allowed by the mask, min(jct / max(frac * seq, 1e-30), 2) / 2
// (seq = orig_seq_sum * steps, as above: the host's limit), 1.0 for every
// other action; in float64 the host encoder's arithmetic, in float32 the
// same operations each rounded to float32 (the reference's float64 casts
// are float32 without x64), the division correctly rounded.
//
// What bounds it on the H100: launch latency. A row reads ~20 bytes of
// fields and a 136-byte static row and writes 204 bytes; one thread a row.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  // c: {lo, hi - lo, float32(1) / float32(hi - lo)}
  __device__ static float norm(float val, const double* c) {
    if (c[1] == 0.0) return 1.0f;
    return __fmul_rn(__fsub_rn(val, static_cast<float>(c[0])),
                     static_cast<float>(c[2]));
  }
  __device__ static float norm_product(float a, float b, const double* c) {
    if (c[1] == 0.0) return 1.0f;
    return __fmul_rn(__fmaf_rn(a, b, -static_cast<float>(c[0])),
                     static_cast<float>(c[2]));
  }
  __device__ static float price(float jct, float frac, float seq) {
    const float limit = fmaxf(__fmul_rn(frac, seq), 1e-30f);
    return __fmul_rn(fminf(__fdiv_rn(jct, limit), 2.0f), 0.5f);
  }
};

template <>
struct Arith<double> {
  __device__ static double norm(double val, const double* c) {
    if (c[1] == 0.0) return 1.0;
    return __ddiv_rn(__dsub_rn(val, c[0]), c[1]);
  }
  __device__ static double norm_product(double a, double b, const double* c) {
    return norm(__dmul_rn(a, b), c);
  }
  __device__ static double price(double jct, double frac, double seq) {
    const double limit = fmax(__dmul_rn(frac, seq), 1e-30);
    return __dmul_rn(fmin(__ddiv_rn(jct, limit), 2.0), 0.5);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) kernel_obs_kernel(
    const int* __restrict__ jtype, const T* __restrict__ frac,
    const T* __restrict__ steps, const int* __restrict__ n_occupied,
    const int* __restrict__ n_running, const float* __restrict__ static_gf,
    const T* __restrict__ orig_seq_sum, const bool* __restrict__ shapes_exist,
    const double* __restrict__ consts, const bool* __restrict__ price_ok,
    const T* __restrict__ price_jct, const int* __restrict__ deg_col,
    float* __restrict__ gf, int* __restrict__ mask, int rows, int stride,
    int width, int n_actions, int n_srv, int n_deg) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const size_t at = static_cast<size_t>(r) * stride;
  const int jt = jtype[at];
  const T fr = frac[at];
  const T st = steps[at];
  const int occ = n_occupied[at];
  const int run = n_running[at];
  const float* row = static_gf + static_cast<size_t>(jt) * width;
  const int out_width = width + (price_ok != nullptr ? n_actions : 0);
  float* out = gf + static_cast<size_t>(r) * out_width;
  int* mout = mask + static_cast<size_t>(r) * n_actions;
  const int n_feat = width - n_actions;
  const T seq = orig_seq_sum[jt] * st;
  const T srv = static_cast<T>(n_srv);
  for (int k = 0; k < n_feat; ++k) {
    T v;
    switch (k) {
      case 2: v = Arith<T>::norm(seq, consts); break;
      case 3: v = Arith<T>::norm_product(fr, seq, consts + 3); break;
      case 4: v = Arith<T>::norm(fr, consts + 6); break;
      case 5: v = fr; break;
      case 8: v = Arith<T>::norm(st, consts + 9); break;
      case 15: v = static_cast<T>(occ) / srv; break;
      case 16: v = static_cast<T>(run) / srv; break;
      default: v = static_cast<T>(row[k]);
    }
    v = v < static_cast<T>(0) ? static_cast<T>(0) : v;
    v = v > static_cast<T>(1) ? static_cast<T>(1) : v;
    out[k] = static_cast<float>(v);
  }
  const int free_srv = n_srv - occ;
  for (int a = 0; a < n_actions; ++a) {
    const bool ok = a == 0 || (a == 1 && free_srv >= 1) ||
                    (a > 1 && a % 2 == 0 && a <= free_srv && shapes_exist[a]);
    mout[a] = ok ? 1 : 0;
    out[n_feat + a] = ok ? 1.0f : 0.0f;
    if (price_ok != nullptr) {
      const int j = deg_col[a];
      const size_t at_j = static_cast<size_t>(r) * n_deg + j;
      out[width + a] =
          j >= 0 && ok && price_ok[at_j]
              ? static_cast<float>(Arith<T>::price(price_jct[at_j], fr, seq))
              : 1.0f;
    }
  }
}

}  // namespace

// The fields jtype, frac, steps, n_occupied, n_running (each R entries
// `stride` apart; frac and steps of the type is_f64 names), the tables
// static_gf [K, width] float32, orig_seq_sum [K], shapes_exist [A] and
// consts [4, 3] double (lo, hi - lo, float32 reciprocal of hi - lo of the
// sequential-JCT, max-JCT, SLA-fraction and training-steps bounds); with
// prices, price_ok [R, n_deg] bools and price_jct [R, n_deg] floats (K29's)
// and deg_col [>= A] int32 (action -> degree column, -1 for none), else
// three nulls; out gf [R, width (+ A with prices)] float32 and mask
// [R, A] int32.
DDLS_EXPORT int ddls_kernel_obs(const void* jtype, const void* frac,
                                const void* steps, const void* n_occupied,
                                const void* n_running, const void* static_gf,
                                const void* orig_seq_sum,
                                const void* shapes_exist, const void* consts,
                                const void* price_ok, const void* price_jct,
                                const void* deg_col, void* gf, void* mask,
                                int rows, int stride, int width,
                                int n_actions, int n_srv, int n_deg,
                                int is_f64, void* stream) {
  if (rows <= 0 || stride < 1 || width <= n_actions || n_actions < 1 ||
      n_srv < 1 ||
      (price_ok != nullptr &&
       (price_jct == nullptr || deg_col == nullptr || n_deg < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = ddls::grid_for(rows, kThreads);
  if (is_f64) {
    kernel_obs_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(jtype), static_cast<const double*>(frac),
        static_cast<const double*>(steps),
        static_cast<const int*>(n_occupied),
        static_cast<const int*>(n_running),
        static_cast<const float*>(static_gf),
        static_cast<const double*>(orig_seq_sum),
        static_cast<const bool*>(shapes_exist),
        static_cast<const double*>(consts),
        static_cast<const bool*>(price_ok),
        static_cast<const double*>(price_jct), static_cast<const int*>(deg_col),
        static_cast<float*>(gf), static_cast<int*>(mask), rows, stride,
        width, n_actions, n_srv, n_deg);
  } else {
    kernel_obs_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(jtype), static_cast<const float*>(frac),
        static_cast<const float*>(steps),
        static_cast<const int*>(n_occupied),
        static_cast<const int*>(n_running),
        static_cast<const float*>(static_gf),
        static_cast<const float*>(orig_seq_sum),
        static_cast<const bool*>(shapes_exist),
        static_cast<const double*>(consts),
        static_cast<const bool*>(price_ok),
        static_cast<const float*>(price_jct), static_cast<const int*>(deg_col),
        static_cast<float*>(gf), static_cast<int*>(mask), rows, stride,
        width, n_actions, n_srv, n_deg);
  }
  return static_cast<int>(cudaGetLastError());
}
