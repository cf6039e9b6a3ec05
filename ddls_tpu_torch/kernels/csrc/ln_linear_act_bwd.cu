// K5 ln_linear_act_bwd: the backward of K1 (row LayerNorm -> Dense -> act,
// with the optional row gather and right-hand concat).
//
// Replaces the backward that XLA derived for the TPU from
// ddls_tpu/models/gnn.py:FeatureModule.__call__ (gnn.py:45-60) through
// jax.value_and_grad (ddls_tpu/rl/ppo.py:276-285), and the per-row side of
// the message gather's backward (gnn.py:89). Row r's input is
//
//   x_r = concat(a[idx[r]] if idx else a[r], b[r] if b else zeros(fb))
//
// and, given dY = d out, the entry ddls_ln_linear_act_bwd writes
//
//   * dx_a[r] = d x_r[:fa] per ROW (for an idx call the caller folds these
//     into the rows of a along the source CSR: csr_segment_sum in
//     segment_bwd.cu, a fixed-order sum with no atomics);
//   * db[r] = d x_r[fa:] when b is given (the zero right half of the
//     self-message gets no gradient);
//   * one row of per-block partial sums of dW [fo, k], dbias [fo],
//     d ln_w [k] and d ln_b [k];
//
// and ddls_ln_linear_act_bwd_reduce sums the partial rows in block order.
//
// Arithmetic: the forward is recomputed exactly as K1 does it (ln_row.cuh),
// so z and the activation-derivative decisions are K1's bit for bit. The
// LayerNorm backward is the derivative of flax's FAST variance, not torch's
// LayerNorm: with mean = s * (1/K), raw = s2 * (1/K) - mean^2, var =
// max(0, raw), rstd = rsqrt(var + 1e-6), y = (x - mean) * (rstd * w) + b,
//
//   d rstd = sum_k dy_k (x_k - mean) w_k,
//   d var  = d rstd * (-0.5 * rstd / (var + eps))       (lax.rsqrt's jvp),
//   d raw  = d var * {1 if raw > 0, 0.5 if raw == 0, 0 if raw < 0}
//            (jnp.maximum passes half the gradient to each side at a tie),
//   d x_k  = dy_k rstd w_k + (d mean + 2 x_k d raw) / K,
//   d mean = -sum_k dy_k rstd w_k - 2 mean d raw.
//
// What bounds it on the H100: bytes, as K1 (per row it reads K + O floats,
// writes K, and does ~6 K O flops: under 20 flop per byte). The design keeps
// every intermediate out of device memory: W is staged in shared memory in
// both layouts ([k][o] for the recomputed product, [o][k] for dy = dz W, so
// the lanes of a warp read neighbouring words either way); a block walks
// tiles of kTile rows, one warp per row, and keeps the tile's y, dz and the
// LayerNorm-parameter terms in shared memory; then every thread adds the
// tile into the parameter-gradient entries it owns, in row order, in
// registers. Nothing is atomic: the grid size is a function of the row
// count alone (the wrapper passes it), each block's tiles and each entry's
// row order are fixed, and the reduce entry sums the blocks in order, so
// the same inputs give the same bits on every run.
#include "common.cuh"
#include "ln_row.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * ddls::kWarpSize;
constexpr int kTile = 32;  // rows per tile
constexpr int kMaxParams = ddls::kLnMaxIn * ddls::kLnMaxOut +
                           ddls::kLnMaxOut + 2 * ddls::kLnMaxIn;
constexpr int kPerThread = (kMaxParams + kThreads - 1) / kThreads;

// d max(0, raw) / d raw, jnp.maximum's rule
__device__ __forceinline__ float clamp_grad(float raw) {
  return raw > 0.0f ? 1.0f : (raw == 0.0f ? 0.5f : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
ln_linear_act_bwd_kernel(const float* __restrict__ a,
                         const int* __restrict__ idx,
                         const float* __restrict__ b,
                         const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b,
                         const float* __restrict__ w,     // [fo, k]
                         const float* __restrict__ bias,  // [fo]
                         const float* __restrict__ dout,  // [rows, fo]
                         float* __restrict__ dx_a,        // [rows, fa] or null
                         float* __restrict__ db,          // [rows, fb] or null
                         float* __restrict__ partial,     // [grid, n_params]
                         int rows, int fa, int fb, int b_given, int fo,
                         int act) {
  extern __shared__ float smem[];
  const int k_in = fa + fb;
  const int n_w = k_in * fo;
  const int n_params = n_w + fo + 2 * k_in;
  float* w_s = smem;              // [k][o]
  float* wt_s = w_s + n_w;        // [o][k]
  float* bias_s = wt_s + n_w;     // [fo]
  float* lnw_s = bias_s + fo;     // [k]
  float* lnb_s = lnw_s + k_in;    // [k]
  float* y_t = lnb_s + k_in;      // [kTile][k]
  float* dz_t = y_t + kTile * k_in;    // [kTile][fo]
  float* gw_t = dz_t + kTile * fo;     // [kTile][k]: dy (x - mean) rstd
  float* gb_t = gw_t + kTile * k_in;   // [kTile][k]: dy

  for (int i = threadIdx.x; i < n_w; i += kThreads) {
    const int o = i / k_in;
    const int k = i - o * k_in;
    const float v = w[i];
    w_s[k * fo + o] = v;
    wt_s[i] = v;
  }
  for (int i = threadIdx.x; i < fo; i += kThreads) bias_s[i] = bias[i];
  for (int i = threadIdx.x; i < k_in; i += kThreads) {
    lnw_s[i] = ln_w[i];
    lnb_s[i] = ln_b[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const float inv_k = 1.0f / static_cast<float>(k_in);
  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;

  const int n_tiles = (rows + kTile - 1) / kTile;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int r = warp; r < kTile; r += kWarps) {
      const int row = tile * kTile + r;
      float* y = y_t + r * k_in;
      float* dz = dz_t + r * fo;
      float* gw = gw_t + r * k_in;
      float* gb = gb_t + r * k_in;
      if (row >= rows) {  // warp-uniform: the ragged end adds zeros
        for (int k = lane; k < k_in; k += ddls::kWarpSize) {
          y[k] = 0.0f;
          gw[k] = 0.0f;
          gb[k] = 0.0f;
        }
        for (int o = lane; o < fo; o += ddls::kWarpSize) dz[o] = 0.0f;
        continue;
      }
      const float* a_row =
          a + static_cast<size_t>(idx != nullptr ? idx[row] : row) * fa;
      const float* b_row =
          b_given ? b + static_cast<size_t>(row) * fb : nullptr;
      float x[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + h * ddls::kWarpSize;
        float v = 0.0f;
        if (k < fa) {
          v = a_row[k];
        } else if (k < k_in && b_row != nullptr) {
          v = b_row[k - fa];
        }
        x[h] = v;
      }
      const ddls::RowStats st = ddls::row_stats(x[0], x[1], inv_k);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + h * ddls::kWarpSize;
        if (k < k_in) y[k] = ddls::ln_apply(x[h], st, lnw_s[k], lnb_s[k]);
      }
      __syncwarp();
      // z as K1 computes it, then dz = dY * act'(z)
      for (int o = lane; o < fo; o += ddls::kWarpSize) {
        const float z = ddls::dense_pre(y, w_s, k_in, fo, o, bias_s[o]);
        dz[o] = __fmul_rn(dout[static_cast<size_t>(row) * fo + o],
                          ddls::activate_grad(z, act));
      }
      __syncwarp();
      // dy = dz W, then the LayerNorm backward
      float dxc[2];
      float part_rstd = 0.0f;
      float part_mean = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + h * ddls::kWarpSize;
        dxc[h] = 0.0f;
        if (k < k_in) {
          float dy = 0.0f;
          for (int o = 0; o < fo; ++o) {
            dy = fmaf(dz[o], wt_s[o * k_in + k], dy);
          }
          const float xc = __fsub_rn(x[h], st.mean);
          const float d_mul = __fmul_rn(dy, xc);
          gb[k] = dy;
          gw[k] = __fmul_rn(d_mul, st.inv_std);
          part_rstd = __fadd_rn(part_rstd, __fmul_rn(d_mul, lnw_s[k]));
          dxc[h] = __fmul_rn(dy, __fmul_rn(st.inv_std, lnw_s[k]));
          part_mean = __fadd_rn(part_mean, dxc[h]);
        }
      }
      const float d_rstd = ddls::warp_sum(part_rstd);
      const float sum_dxc = ddls::warp_sum(part_mean);
      const float d_var = __fmul_rn(
          d_rstd,
          __fmul_rn(-0.5f, __fdiv_rn(st.inv_std,
                                     __fadd_rn(st.var, ddls::kLnEps))));
      const float d_raw = __fmul_rn(d_var, clamp_grad(st.raw));
      const float d_mean = __fsub_rn(
          -sum_dxc, __fmul_rn(d_raw, __fmul_rn(2.0f, st.mean)));
      const float d_s = __fmul_rn(d_mean, inv_k);
      const float d_s2 = __fmul_rn(d_raw, inv_k);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + h * ddls::kWarpSize;
        if (k >= k_in) continue;
        const float dx = __fadd_rn(
            __fadd_rn(dxc[h], d_s), __fmul_rn(d_s2, __fmul_rn(2.0f, x[h])));
        if (k < fa) {
          if (dx_a != nullptr) dx_a[static_cast<size_t>(row) * fa + k] = dx;
        } else if (db != nullptr) {
          db[static_cast<size_t>(row) * fb + (k - fa)] = dx;
        }
      }
    }
    __syncthreads();
    // the tile's rows into this thread's parameter-gradient entries, in
    // row order: dW[o][k] += dz[o] y[k], dbias[o] += dz[o],
    // d ln_w[k] += dy (x - mean) rstd, d ln_b[k] += dy
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e >= n_params) continue;
      float s = acc[j];
      if (e < n_w) {
        const int o = e / k_in;
        const int k = e - o * k_in;
        for (int r = 0; r < kTile; ++r) {
          s = fmaf(dz_t[r * fo + o], y_t[r * k_in + k], s);
        }
      } else if (e < n_w + fo) {
        const int o = e - n_w;
        for (int r = 0; r < kTile; ++r) s = __fadd_rn(s, dz_t[r * fo + o]);
      } else if (e < n_w + fo + k_in) {
        const int k = e - n_w - fo;
        for (int r = 0; r < kTile; ++r) s = __fadd_rn(s, gw_t[r * k_in + k]);
      } else {
        const int k = e - n_w - fo - k_in;
        for (int r = 0; r < kTile; ++r) s = __fadd_rn(s, gb_t[r * k_in + k]);
      }
      acc[j] = s;
    }
    __syncthreads();  // the tile buffers are rewritten by the next tile
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < n_params) {
      partial[static_cast<size_t>(blockIdx.x) * n_params + e] = acc[j];
    }
  }
}

// out[e] = sum over blocks g = 0, 1, ... of partial[g][e], in that order
__global__ void __launch_bounds__(kThreads)
ln_linear_act_bwd_reduce_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int blocks,
                                int n_params) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_params) return;
  float s = 0.0f;
  for (int g = 0; g < blocks; ++g) {
    s = __fadd_rn(s, partial[static_cast<size_t>(g) * n_params + e]);
  }
  out[e] = s;
}

size_t smem_bytes(int k_in, int fo) {
  return sizeof(float) * (2 * static_cast<size_t>(k_in) * fo + fo +
                          2 * k_in + kTile * (3 * k_in + fo));
}

}  // namespace

DDLS_EXPORT int ddls_ln_linear_act_bwd(
    const void* a, const void* idx, const void* b, const void* ln_w,
    const void* ln_b, const void* w, const void* bias, const void* dout,
    void* dx_a, void* db, void* partial, int rows, int fa, int fb,
    int b_given, int fo, int act, int blocks, void* stream) {
  if (rows <= 0 || fa <= 0 || fb < 0 || fa + fb > ddls::kLnMaxIn ||
      fo <= 0 || fo > ddls::kLnMaxOut || blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(fa + fb, fo);
  // raise the dynamic shared-memory limit once, to the largest size yet
  // (the first launch, before any CUDA-graph capture, sets it)
  static size_t configured = 0;
  if (bytes > configured) {
    const cudaError_t attr = cudaFuncSetAttribute(
        ln_linear_act_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(ddls::kLnMaxIn, ddls::kLnMaxOut)));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    configured = smem_bytes(ddls::kLnMaxIn, ddls::kLnMaxOut);
  }
  ln_linear_act_bwd_kernel<<<blocks, kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const int*>(idx),
      static_cast<const float*>(b), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(dout),
      static_cast<float*>(dx_a), static_cast<float*>(db),
      static_cast<float*>(partial), rows, fa, fb, b_given, fo, act);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_ln_linear_act_bwd_reduce(const void* partial, void* out,
                                              int blocks, int n_params,
                                              void* stream) {
  if (blocks <= 0 || n_params <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ln_linear_act_bwd_reduce_kernel<<<ddls::grid_for(n_params, kThreads),
                                    kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      n_params);
  return static_cast<int>(cudaGetLastError());
}
