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

namespace {

constexpr int kMaxIn = 64;
constexpr int kMaxOut = 64;
constexpr int kWarps = 8;

// Activation codes, in the order of ddls_tpu_torch/models/gnn.py:ACTIVATIONS.
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 0:  // relu: jnp.maximum(x, 0)
      return fmaxf(x, 0.0f);
    case 1:  // leaky_relu: jnp.where(x >= 0, x, 0.01 * x)
      return x >= 0.0f ? x : 0.01f * x;
    case 2:  // tanh
      return tanhf(x);
    case 3:  // swish: x * sigmoid(x)
      return x * (1.0f / (1.0f + expf(-x)));
    default: {  // gelu, tanh approximation (flax's default)
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      const float inner = k * (x + 0.044715f * (x * x * x));
      return x * (0.5f * (1.0f + tanhf(inner)));
    }
  }
}

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
    // separate roundings (no contraction), as the reference's ops round
    const float s = ddls::warp_sum(__fadd_rn(x[0], x[1]));
    const float s2 = ddls::warp_sum(
        __fadd_rn(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1])));
    const float mean = __fmul_rn(s, inv_k);
    const float var =
        fmaxf(__fsub_rn(__fmul_rn(s2, inv_k), __fmul_rn(mean, mean)), 0.0f);
    const float inv_std = 1.0f / sqrtf(__fadd_rn(var, 1e-6f));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = lane + h * ddls::kWarpSize;
      if (k < k_in) {
        y[k] = __fadd_rn(__fmul_rn(__fsub_rn(x[h], mean),
                                   __fmul_rn(inv_std, lnw_s[k])),
                         lnb_s[k]);
      }
    }
    __syncwarp();
    for (int o = lane; o < fo; o += ddls::kWarpSize) {
      float acc = 0.0f;
      for (int k = 0; k < k_in; ++k) acc = fmaf(y[k], w_s[k * fo + o], acc);
      out[static_cast<size_t>(row) * fo + o] =
          activate(__fadd_rn(acc, bias_s[o]), act);
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
