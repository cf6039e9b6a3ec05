// K1 ln_linear_act: row LayerNorm -> Dense -> activation, with an optional
// row gather and an optional right-hand concat fused into the load.
//
// Replaces ddls_tpu/models/gnn.py:FeatureModule.__call__ (gnn.py:45-60, its
// first LayerNorm -> Dense -> act) and the message gather of
// MeanPoolLayer.__call__ (gnn.py:89, node_int[edges_src] concatenated with
// edge_int), which XLA compiled for the TPU. Row r's input is
//
//   x_r = concat(a[idx[r]] if idx else a[r], b[r] if b else zeros(fb))
//
// and the output is act((LN(x_r) * ln_w + ln_b) @ W^T + bias), with flax's
// LayerNorm: epsilon 1e-6 and the fast variance max(E[x^2] - E[x]^2, 0),
// the means taken as sum * (1/K) as XLA lowers jnp.mean.
//
// What bounds it on the H100: bytes. Per row it reads K <= 64 floats and
// writes O <= 64 floats, and does 2*K*O flops: at most 16 flop per byte
// moved against the card's 67 TFLOP/s fp32 / 3.35 TB/s = 20, so device
// memory is the limit. The design keeps every intermediate out of device
// memory: the [B*E, 32] message tensor of the reduce-on-messages call is
// never written (the gather happens in the load), W (<= 16 KB) and the LN
// parameters are staged once per block in shared memory, and the normalised
// row lives in a per-warp shared buffer between the statistics and the
// product. One warp per row; the row statistics come from warp shuffles.
#include "common.cuh"
#include "ln_row.cuh"

namespace {

constexpr int kMaxIn = ddls::kLnMaxIn;
constexpr int kMaxOut = ddls::kLnMaxOut;
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * ddls::kWarpSize)
ln_linear_act_kernel(const float* __restrict__ a, const int* __restrict__ idx,
                     const float* __restrict__ b,
                     const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b,
                     const float* __restrict__ w,     // [fo, k] (torch layout)
                     const float* __restrict__ bias,  // [fo]
                     float* __restrict__ out,         // [rows, fo]
                     int rows, int fa, int fb, int b_given, int fo, int act) {
  __shared__ float w_s[kMaxIn * kMaxOut];  // [k][o]: lanes read along o
  __shared__ float bias_s[kMaxOut];
  __shared__ float lnw_s[kMaxIn];
  __shared__ float lnb_s[kMaxIn];
  __shared__ float y_s[kWarps][kMaxIn];

  const int k_in = fa + fb;
  for (int i = threadIdx.x; i < k_in * fo; i += blockDim.x) {
    const int o = i / k_in;
    const int k = i - o * k_in;
    w_s[k * fo + o] = w[i];
  }
  for (int i = threadIdx.x; i < fo; i += blockDim.x) bias_s[i] = bias[i];
  for (int i = threadIdx.x; i < k_in; i += blockDim.x) {
    lnw_s[i] = ln_w[i];
    lnb_s[i] = ln_b[i];
  }
  __syncthreads();

  const int warp = threadIdx.x / ddls::kWarpSize;
  const int lane = threadIdx.x % ddls::kWarpSize;
  const float inv_k = 1.0f / static_cast<float>(k_in);
  float* y = y_s[warp];

  for (int row = blockIdx.x * kWarps + warp; row < rows;
       row += gridDim.x * kWarps) {
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
    for (int o = lane; o < fo; o += ddls::kWarpSize) {
      out[static_cast<size_t>(row) * fo + o] = ddls::activate(
          ddls::dense_pre(y, w_s, k_in, fo, o, bias_s[o]), act);
    }
    __syncwarp();  // y is rewritten by the warp's next row
  }
}

}  // namespace

DDLS_EXPORT int ddls_ln_linear_act(const void* a, const void* idx,
                                   const void* b, const void* ln_w,
                                   const void* ln_b, const void* w,
                                   const void* bias, void* out, int rows,
                                   int fa, int fb, int b_given, int fo,
                                   int act, void* stream) {
  if (rows <= 0 || fa <= 0 || fb < 0 || fa + fb > kMaxIn || fo <= 0 ||
      fo > kMaxOut) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = ddls::grid_for(rows, kWarps);
  ln_linear_act_kernel<<<grid, kWarps * ddls::kWarpSize, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const int*>(idx),
      static_cast<const float*>(b), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), rows, fa, fb,
      b_given, fo, act);
  return static_cast<int>(cudaGetLastError());
}
