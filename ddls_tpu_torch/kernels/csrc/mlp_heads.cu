// K17 mlp_heads: the policy's logit and value heads (Dense -> act -> ... ->
// Dense, each head its own stack) from the pooled embedding, both heads and
// every layer in one launch; K18 mlp_heads_bwd and mlp_heads_bwd_reduce:
// their backward.
//
// Replaces ddls_tpu/models/policy.py:38 MLPHead.__call__, used at :145-146
// (the logit head and the value head over final_emb), and the backward that
// XLA derived for it through jax.value_and_grad, compiled for the TPU.
//
// Shapes: x [rows, K] float32 (K <= 64; the shipped policy's 24), then per
// head up to three Dense layers (up to two hidden layers of width <= 256,
// the default fcnet_hiddens (256, 256)), the logit head ending in A <= 64
// outputs, the value head in 1. Each layer's weight is read where nn.Linear
// keeps it, [out, in] row-major, and its bias [out]; the layer table (one
// pointer pair and two widths per layer) travels by value as a kernel
// argument, so the modules keep their own tensors (functional_call and the
// DQN target network reach the kernel with theirs).
//
// Arithmetic, per row and output: z_o = (sum_k h_k W[o, k]) + b_o, one fused
// multiply-add per input in input order, then the bias; hidden layers apply
// the activation (K1's codes and functions, ln_row.cuh). The backward
// recomputes every pre-activation with the same function (K5's pattern), so
// its activation-derivative decisions are the forward's bit for bit (relu's
// derivative at 0 is 0, JAX's rule).
//
// What bounds it on the H100: latency. The shipped heads move ~100 bytes a
// row and ~3 KB of weights; the 256-wide ones ~70 KB of weights. A block
// takes a tile of rows; each layer's weight is staged through shared memory
// in chunks of output rows (a 256 x 256 layer does not fit, so it streams),
// transposed on the way in for the forward ([k][o]: a warp's lanes take
// neighbouring outputs of one row and read neighbouring words) and kept as
// is for the backward ([o][k]: lanes take neighbouring inputs). The tile's
// activations stay in shared memory between layers. The backward writes one
// row of per-block partial parameter gradients, each entry owned by one
// thread and summed in row order, and the reduce entry adds the rows in
// block order: no atomics, the same bits on every run for a given row count.
#include "common.cuh"
#include "ln_row.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 3;
constexpr int kMaxIn = 64;
constexpr int kMaxHidden = 256;
constexpr int kMaxOut = 64;
constexpr int kWChunk = 8192;   // floats of one weight chunk (32 KB)
constexpr int kRowsFwd = 16;    // rows per forward tile
constexpr int kRowsBwd = 8;     // rows per backward tile

struct Layer {
  const float* w;  // [out, in]
  const float* b;  // [out]
  int in;
  int out;
};

struct Heads {
  Layer layer[2][kMaxLayers];
  int n_layers[2];
  int n_params;      // all weights and biases, head 0's layers first
  int stride;        // row stride of the activation buffers
  int chunk;         // floats of the weight chunk buffer
};

// z = sum_k h[k] w[k * ws] + b, in input order: the one Dense arithmetic
// that the forward and the backward's recompute share
__device__ __forceinline__ float dense_dot(const float* h, const float* w,
                                           int ws, int n, float b) {
  float acc = 0.0f;
  for (int k = 0; k < n; ++k) acc = fmaf(h[k], w[k * ws], acc);
  return __fadd_rn(acc, b);
}

// stage output rows [o0, o0 + oc) of layer L: transposed ([k][o - o0]) for
// the forward, as stored ([o - o0][k]) for the backward
__device__ __forceinline__ void stage_chunk(const Layer& L, int o0, int oc,
                                            float* w_s, bool transpose) {
  const int n = oc * L.in;
  const float* src = L.w + static_cast<size_t>(o0) * L.in;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = src[i];
    if (transpose) {
      const int o = i / L.in;
      const int k = i - o * L.in;
      w_s[k * oc + o] = v;
    } else {
      w_s[i] = v;
    }
  }
}

// out[r][o] = act(z) (or z on the last layer) for the tile's rows, from
// in_s [rows][in_stride]
__device__ void layer_forward(const Layer& L, const float* in_s,
                              int in_stride, float* out_s, int out_stride,
                              float* w_s, int chunk, int tile_rows, int act,
                              bool last, float* z_s) {
  const int oc_max = max(1, min(L.out, chunk / L.in));
  for (int o0 = 0; o0 < L.out; o0 += oc_max) {
    const int oc = min(oc_max, L.out - o0);
    stage_chunk(L, o0, oc, w_s, true);
    __syncthreads();
    for (int p = threadIdx.x; p < tile_rows * oc; p += kThreads) {
      const int r = p / oc;
      const int o = p - r * oc;
      const float z = dense_dot(in_s + r * in_stride, w_s + o, oc, L.in,
                                L.b[o0 + o]);
      if (z_s != nullptr) z_s[r * out_stride + o0 + o] = z;
      out_s[r * out_stride + o0 + o] = last ? z : ddls::activate(z, act);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
mlp_heads_kernel(const float* __restrict__ x,  // [rows, k]
                 Heads heads,
                 float* __restrict__ logits,   // [rows, a]
                 float* __restrict__ value,    // [rows]
                 int rows, int act) {
  extern __shared__ float smem[];
  const int st = heads.stride;
  const int k_in = heads.layer[0][0].in;
  float* x_s = smem;                      // [kRowsFwd][st]
  float* buf0 = x_s + kRowsFwd * st;      // [kRowsFwd][st]
  float* buf1 = buf0 + kRowsFwd * st;     // [kRowsFwd][st]
  float* out_s = buf1 + kRowsFwd * st;    // [kRowsFwd][st]
  float* w_s = out_s + kRowsFwd * st;     // [chunk]
  const int row0 = blockIdx.x * kRowsFwd;
  const int tile_rows = min(kRowsFwd, rows - row0);
  for (int i = threadIdx.x; i < tile_rows * k_in; i += kThreads) {
    const int r = i / k_in;
    const int k = i - r * k_in;
    x_s[r * st + k] = x[static_cast<size_t>(row0 + r) * k_in + k];
  }
  __syncthreads();
  for (int h = 0; h < 2; ++h) {
    const int n = heads.n_layers[h];
    const float* in_s = x_s;
    for (int l = 0; l < n; ++l) {
      const bool last = l == n - 1;
      float* dst = last ? out_s : (l % 2 == 0 ? buf0 : buf1);
      layer_forward(heads.layer[h][l], in_s, st, dst, st, w_s, heads.chunk,
                    tile_rows, act, last, nullptr);
      in_s = dst;
    }
    const int a = heads.layer[h][n - 1].out;
    for (int i = threadIdx.x; i < tile_rows * a; i += kThreads) {
      const int r = i / a;
      const int o = i - r * a;
      const float v = out_s[r * st + o];
      if (h == 0) {
        logits[static_cast<size_t>(row0 + r) * a + o] = v;
      } else {
        value[row0 + r] = v;
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- backward
// Per tile and head: recompute the hidden pre-activations z_l and outputs
// h_l, then walk the layers backwards with d = d out:
//   dW_l[o][k] += sum_r d[r][o] h_{l-1}[r][k], db_l[o] += sum_r d[r][o],
//   d h_{l-1}[r][k] = sum_o d[r][o] W_l[o][k] (chunks of o in order),
//   d = d h_{l-1} * act'(z_{l-1}),
// and d x = d h_0 of head 0 + d h_0 of head 1.
__global__ void __launch_bounds__(kThreads)
mlp_heads_bwd_kernel(const float* __restrict__ x,       // [rows, k]
                     Heads heads,
                     const float* __restrict__ dlogits,  // [rows, a]
                     const float* __restrict__ dvalue,   // [rows]
                     float* __restrict__ dx,              // [rows, k]
                     float* __restrict__ partial,  // [grid, n_params]
                     int rows, int act) {
  extern __shared__ float smem[];
  const int st = heads.stride;
  const int k_in = heads.layer[0][0].in;
  const int tile = kRowsBwd * st;
  float* x_s = smem;
  float* z_s[2] = {x_s + tile, x_s + 2 * tile};   // hidden pre-activations
  float* h_s[2] = {x_s + 3 * tile, x_s + 4 * tile};  // hidden outputs
  float* d_a = x_s + 5 * tile;
  float* d_b = x_s + 6 * tile;
  float* dx_s = x_s + 7 * tile;
  float* w_s = x_s + 8 * tile;
  float* part = partial + static_cast<size_t>(blockIdx.x) * heads.n_params;
  const int n_tiles = (rows + kRowsBwd - 1) / kRowsBwd;
  bool first = true;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * kRowsBwd;
    const int tile_rows = min(kRowsBwd, rows - row0);
    // rows past the end hold zeros: they add +0 to every gradient entry
    for (int i = threadIdx.x; i < kRowsBwd * k_in; i += kThreads) {
      const int r = i / k_in;
      const int k = i - r * k_in;
      x_s[r * st + k] = r < tile_rows
          ? x[static_cast<size_t>(row0 + r) * k_in + k] : 0.0f;
      dx_s[r * st + k] = 0.0f;
    }
    __syncthreads();
    int p_base = 0;
    for (int h = 0; h < 2; ++h) {
      const int n = heads.n_layers[h];
      // the forward, hidden layers only
      const float* in_s = x_s;
      for (int l = 0; l + 1 < n; ++l) {
        layer_forward(heads.layer[h][l], in_s, st, h_s[l], st, w_s,
                      heads.chunk, kRowsBwd, act, false, z_s[l]);
        in_s = h_s[l];
      }
      // d out, zero past the tile's rows
      const int a = heads.layer[h][n - 1].out;
      float* d = d_a;
      float* d_next = d_b;
      for (int i = threadIdx.x; i < kRowsBwd * a; i += kThreads) {
        const int r = i / a;
        const int o = i - r * a;
        float v = 0.0f;
        if (r < tile_rows) {
          v = h == 0 ? dlogits[static_cast<size_t>(row0 + r) * a + o]
                     : dvalue[row0 + r];
        }
        d[r * st + o] = v;
      }
      __syncthreads();
      // parameter offsets of this head's layers
      int off[kMaxLayers];
      int acc_off = p_base;
      for (int l = 0; l < n; ++l) {
        off[l] = acc_off;
        acc_off += heads.layer[h][l].out * heads.layer[h][l].in +
                   heads.layer[h][l].out;
      }
      p_base = acc_off;
      for (int l = n - 1; l >= 0; --l) {
        const Layer& L = heads.layer[h][l];
        const float* hin = l == 0 ? x_s : h_s[l - 1];
        // dW and db: entry e owned by one thread, rows in order
        const int n_w = L.out * L.in;
        for (int e = threadIdx.x; e < n_w + L.out; e += kThreads) {
          float s = 0.0f;
          if (e < n_w) {
            const int o = e / L.in;
            const int k = e - o * L.in;
            for (int r = 0; r < kRowsBwd; ++r) {
              s = fmaf(d[r * st + o], hin[r * st + k], s);
            }
          } else {
            const int o = e - n_w;
            for (int r = 0; r < kRowsBwd; ++r) s = __fadd_rn(s, d[r * st + o]);
          }
          float* slot = part + off[l] + e;
          *slot = first ? s : __fadd_rn(*slot, s);
        }
        // d h_{l-1} (for l == 0 this head's part of d x) into d_next,
        // chunks of outputs in order
        const int oc_max = max(1, min(L.out, heads.chunk / L.in));
        float* acc_s = d_next;
        for (int i = threadIdx.x; i < kRowsBwd * L.in; i += kThreads) {
          const int r = i / L.in;
          const int k = i - r * L.in;
          acc_s[r * st + k] = 0.0f;
        }
        for (int o0 = 0; o0 < L.out; o0 += oc_max) {
          const int oc = min(oc_max, L.out - o0);
          __syncthreads();  // previous chunk's readers are done with w_s
          stage_chunk(L, o0, oc, w_s, false);
          __syncthreads();
          for (int i = threadIdx.x; i < kRowsBwd * L.in; i += kThreads) {
            const int r = i / L.in;
            const int k = i - r * L.in;
            float s = acc_s[r * st + k];
            for (int o = 0; o < oc; ++o) {
              s = fmaf(d[r * st + o0 + o], w_s[o * L.in + k], s);
            }
            acc_s[r * st + k] = s;
          }
        }
        __syncthreads();
        if (l == 0) {
          for (int i = threadIdx.x; i < kRowsBwd * k_in; i += kThreads) {
            const int r = i / k_in;
            const int k = i - r * k_in;
            dx_s[r * st + k] = __fadd_rn(dx_s[r * st + k], acc_s[r * st + k]);
          }
        } else {
          const float* z = z_s[l - 1];
          for (int i = threadIdx.x; i < kRowsBwd * L.in; i += kThreads) {
            const int r = i / L.in;
            const int k = i - r * L.in;
            acc_s[r * st + k] = __fmul_rn(
                acc_s[r * st + k], ddls::activate_grad(z[r * st + k], act));
          }
          float* tmp = d;
          d = d_next;
          d_next = tmp;
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < tile_rows * k_in; i += kThreads) {
      const int r = i / k_in;
      const int k = i - r * k_in;
      dx[static_cast<size_t>(row0 + r) * k_in + k] = dx_s[r * st + k];
    }
    first = false;
    __syncthreads();
  }
}

// out[e] = sum over blocks g = 0, 1, ... of partial[g][e], in that order
__global__ void __launch_bounds__(kThreads)
mlp_heads_bwd_reduce_kernel(const float* __restrict__ partial,
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

// The layer table from the host: per head h and layer l, the four int64
// entries (weight pointer, bias pointer, in, out) at (h * 3 + l) * 4, then
// the two layer counts at 24 and 25. Returns false on a shape it does not
// take.
bool read_heads(const long long* table, Heads* heads, int* k_in, int* a) {
  int widest = 0;
  int largest = 0;
  heads->n_params = 0;
  for (int h = 0; h < 2; ++h) {
    const int n = static_cast<int>(table[24 + h]);
    if (n < 1 || n > kMaxLayers) return false;
    heads->n_layers[h] = n;
    for (int l = 0; l < n; ++l) {
      const long long* e = table + (h * kMaxLayers + l) * 4;
      Layer& L = heads->layer[h][l];
      L.w = reinterpret_cast<const float*>(e[0]);
      L.b = reinterpret_cast<const float*>(e[1]);
      L.in = static_cast<int>(e[2]);
      L.out = static_cast<int>(e[3]);
      if (L.w == nullptr || L.b == nullptr || L.in <= 0 || L.out <= 0) {
        return false;
      }
      const int prev = l == 0 ? heads->layer[0][0].in
                              : heads->layer[h][l - 1].out;
      if (L.in != prev) return false;
      const bool last = l == n - 1;
      if (!last && L.out > kMaxHidden) return false;
      if (last && L.out > (h == 0 ? kMaxOut : 1)) return false;
      if (last && h == 1 && L.out != 1) return false;
      widest = max(widest, L.out);
      largest = max(largest, L.in * L.out);
      heads->n_params += L.out * L.in + L.out;
    }
  }
  *k_in = heads->layer[0][0].in;
  if (*k_in > kMaxIn) return false;
  *a = heads->layer[0][heads->n_layers[0] - 1].out;
  widest = max(widest, *k_in);
  heads->stride = widest + 1;  // odd: rows of a tile fall in other banks
  // every layer's input width (<= 256) fits the chunk: in <= in * out
  heads->chunk = min(largest, kWChunk);
  return true;
}

size_t fwd_bytes(const Heads& h) {
  return sizeof(float) * (4 * static_cast<size_t>(kRowsFwd) * h.stride +
                          h.chunk);
}

size_t bwd_bytes(const Heads& h) {
  return sizeof(float) * (8 * static_cast<size_t>(kRowsBwd) * h.stride +
                          h.chunk);
}

size_t fwd_max_bytes() {
  return sizeof(float) *
         (4 * static_cast<size_t>(kRowsFwd) * (kMaxHidden + 1) + kWChunk);
}

size_t bwd_max_bytes() {
  return sizeof(float) *
         (8 * static_cast<size_t>(kRowsBwd) * (kMaxHidden + 1) + kWChunk);
}

}  // namespace

DDLS_EXPORT int ddls_mlp_heads(const void* x, const void* table,
                               void* logits, void* value, int rows, int act,
                               void* stream) {
  Heads heads;
  int k_in = 0;
  int a = 0;
  if (rows <= 0 || !read_heads(static_cast<const long long*>(table), &heads,
                               &k_in, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // raise the dynamic shared-memory limit once, to the kernel's largest
  // size (the first launch, before any CUDA-graph capture, sets it)
  static bool configured = false;
  if (!configured) {
    const cudaError_t attr = cudaFuncSetAttribute(
        mlp_heads_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(fwd_max_bytes()));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    configured = true;
  }
  mlp_heads_kernel<<<ddls::grid_for(rows, kRowsFwd), kThreads,
                     fwd_bytes(heads), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), heads, static_cast<float*>(logits),
      static_cast<float*>(value), rows, act);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_mlp_heads_bwd(const void* x, const void* table,
                                   const void* dlogits, const void* dvalue,
                                   void* dx, void* partial, int rows, int act,
                                   int blocks, void* stream) {
  Heads heads;
  int k_in = 0;
  int a = 0;
  if (rows <= 0 || blocks <= 0 ||
      !read_heads(static_cast<const long long*>(table), &heads, &k_in, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t attr = cudaFuncSetAttribute(
        mlp_heads_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bwd_max_bytes()));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    configured = true;
  }
  mlp_heads_bwd_kernel<<<blocks, kThreads, bwd_bytes(heads),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), heads,
      static_cast<const float*>(dlogits), static_cast<const float*>(dvalue),
      static_cast<float*>(dx), static_cast<float*>(partial), rows, act);
  return static_cast<int>(cudaGetLastError());
}

DDLS_EXPORT int ddls_mlp_heads_bwd_reduce(const void* partial, void* out,
                                          int blocks, int n_params,
                                          void* stream) {
  if (blocks <= 0 || n_params <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mlp_heads_bwd_reduce_kernel<<<ddls::grid_for(n_params, kThreads), kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), blocks,
      n_params);
  return static_cast<int>(cudaGetLastError());
}
