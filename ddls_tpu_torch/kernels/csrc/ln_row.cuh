// The row arithmetic that K1 (ln_linear_act.cu) and its backward K5
// (ln_linear_act_bwd.cu) share: flax's LayerNorm statistics, the normalised
// value, the Dense pre-activation, the activations and their derivatives. K5 recomputes the forward
// with these same functions, so its pre-activations are K1's bit for bit
// and every activation-derivative decision (z > 0, z >= 0) matches the
// forward's.
#pragma once

#include "common.cuh"

namespace ddls {

constexpr int kLnMaxIn = 64;   // two features per lane
constexpr int kLnMaxOut = 64;
constexpr float kLnEps = 1e-6f;

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

// d act / d x at the pre-activation x, with JAX's rules at the kinks:
// jax.nn.relu's derivative is 0 at 0, leaky_relu's where(x >= 0) is 1.
__device__ __forceinline__ float activate_grad(float x, int act) {
  switch (act) {
    case 0:
      return x > 0.0f ? 1.0f : 0.0f;
    case 1:
      return x >= 0.0f ? 1.0f : 0.01f;
    case 2: {
      const float t = tanhf(x);
      return 1.0f - t * t;
    }
    case 3: {
      const float s = 1.0f / (1.0f + expf(-x));
      return s + x * s * (1.0f - s);
    }
    default: {
      const float k = 0.7978845608028654f;
      const float inner = k * (x + 0.044715f * (x * x * x));
      const float t = tanhf(inner);
      return 0.5f * (1.0f + t) +
             0.5f * x * (1.0f - t * t) * k * (1.0f + 3.0f * 0.044715f * x * x);
    }
  }
}

// flax LayerNorm statistics of one row held two features per lane (zeros
// past the row's width): mean = sum * (1/K) as XLA lowers jnp.mean, and the
// fast variance raw = E[x^2] - E[x]^2 clamped at 0. Every lane of the warp
// must call it. Separate roundings (no contraction), as the reference's ops
// round.
struct RowStats {
  float mean;
  float raw;  // E[x^2] - E[x]^2 before the clamp (K5 needs its sign)
  float var;
  float inv_std;
};

__device__ __forceinline__ RowStats row_stats(float x0, float x1,
                                              float inv_k) {
  RowStats st;
  const float s = warp_sum(__fadd_rn(x0, x1));
  const float s2 =
      warp_sum(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)));
  st.mean = __fmul_rn(s, inv_k);
  st.raw = __fsub_rn(__fmul_rn(s2, inv_k), __fmul_rn(st.mean, st.mean));
  st.var = fmaxf(st.raw, 0.0f);
  st.inv_std = 1.0f / sqrtf(__fadd_rn(st.var, kLnEps));
  return st;
}

// y = (x - mean) * (inv_std * scale) + bias, flax's _normalize order.
__device__ __forceinline__ float ln_apply(float x, const RowStats& st,
                                          float scale, float bias) {
  return __fadd_rn(__fmul_rn(__fsub_rn(x, st.mean),
                             __fmul_rn(st.inv_std, scale)),
                   bias);
}

// z = sum_k y[k] w_s[k * fo + o] + bias: the Dense pre-activation of
// output o, one fused multiply-add per feature in feature order.
__device__ __forceinline__ float dense_pre(const float* y, const float* w_s,
                                           int k_in, int fo, int o,
                                           float bias) {
  float acc = 0.0f;
  for (int k = 0; k < k_in; ++k) acc = fmaf(y[k], w_s[k * fo + o], acc);
  return __fadd_rn(acc, bias);
}

}  // namespace ddls
