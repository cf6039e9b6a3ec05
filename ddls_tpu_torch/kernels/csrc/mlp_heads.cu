// K17 mlp_heads: the policy's logit and value heads (Dense -> act -> ... ->
// Dense, each head its own stack) from the pooled embedding, both heads and
// every layer in one launch; K18 mlp_heads_bwd: their backward, the sum of
// the parameter gradients over the rows included.
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
// What bounds them on the H100: latency. The shipped heads move ~100 bytes
// a row and ~4.6 KB of weights; the 256-wide ones ~70 KB of weights.
//
// K17's first design took 16-row tiles of 256 threads (the update's 128
// rows on 8 CTAs), ran the heads one after the other and restaged every
// layer's weight chunk, transposed, with scalar loads between two barriers:
// four dependent global round trips and about ten barriers a tile at the
// shipped widths. This design (K18's techniques on the forward):
//  * stages the tile's x and every weight and bias of both heads at the
//    start, all in flight together with cp.async: one round trip. A
//    weight keeps its layout with each row padded by one float, so the
//    copies coalesce and write distinct banks, and a warp's lanes (on
//    neighbouring outputs) read one column in distinct banks; a transposed
//    copy would send a warp's writes to one bank (at the Ape-X DQN's 256
//    wide layer: 14 us a launch at one row on the H100). Heads too
//    wide to fit (the default 256 x 256 hidden layers) stream each layer
//    through two chunk buffers (K18's, transposed), the next chunk's
//    copies issued before the current one is used;
//  * runs both heads' layer l in one pass over the block's threads, one
//    barrier a layer depth; the last layer's outputs go straight to global
//    memory, the hidden ones stay in shared memory;
//  * takes the host's tile (models/policy.py heads_fwd_plan: serving's rows
//    in one CTA, the update's 128 rows 4 a CTA over 32 SMs; wider heads
//    fewer rows a CTA) and as many
//    threads as a depth has items (at most 512).
// Every output is dense_dot whatever the tile or form, so its bits are the
// first design's.
//
// K18 keeps the order of sums of its first design (8-row tiles, rows in
// order within a tile; CTA g's tiles g, g + G, ... in order; the CTAs'
// rows in block order), so its bits are that design's at every row count.
// That design lost its time to a chain of dependent global round trips:
// every layer pass, the recompute's and the backward's, restaged its
// weight chunk with scalar loads between two barriers (eight round trips a
// tile at the shipped widths), and a second launch added the per-CTA rows.
// This design:
//  * stages every weight (as stored, for d h, and transposed, for the
//    recompute) and bias of both heads at the start, with the tile's x and
//    output gradients, all in flight together with cp.async (16 bytes a
//    copy where aligned): one round trip; heads too wide to fit stream
//    their layers through two chunk buffers, the next chunk's copies issued
//    before the current one is used;
//  * runs both heads' layers together, a step (one barrier) per layer
//    depth: the recompute, then each backward step's parameter entries and
//    d h (the activation derivative applied as d h is stored) in one pass;
//  * folds the reduce into the launch: up to 16 CTAs (128 rows, the
//    update's minibatch) launch as one thread-block cluster whose CTAs add
//    the rows in block order over distributed shared memory; more launch
//    as clusters of 8 that take a ticket, and the CTAs of the last
//    cluster to finish add the rows from global memory, each a slice of
//    the columns, 16 loads of a column in flight (the counter is the
//    wrapper's, one a (device, stream), set back to 0 by that cluster,
//    so the launch replays inside a CUDA graph; one cluster takes none).
// No float atomics: the same inputs give the same bits on every run.
#include "cluster.cuh"
#include "common.cuh"
#include "ln_row.cuh"

namespace {

constexpr int kMaxFwdThreads = 512;  // K17's, at most
constexpr int kMaxBwdThreads = 512;  // K18's, at most (its plan's)
constexpr int kMaxLayers = 3;
constexpr int kMaxIn = 64;
constexpr int kMaxHidden = 256;
constexpr int kMaxOut = 64;
constexpr int kWChunk = 8192;   // floats of one weight chunk (32 KB)
constexpr int kMaxTile = 16;    // rows per forward tile, at most
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

// acc = fmaf(a[i as], b[i bs], acc) for i = 0, 1, ..., n - 1 in order;
// eight pairs loaded ahead of their eight fmafs, so the shared loads'
// latency is paid once a group, not once a term
__device__ __forceinline__ float fma_chain(const float* a, int as,
                                           const float* b, int bs, int n,
                                           float acc) {
  constexpr int kAhead = 8;
  int i = 0;
  for (; i + kAhead <= n; i += kAhead) {
    float x[kAhead], y[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      x[j] = a[(i + j) * as];
      y[j] = b[(i + j) * bs];
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) acc = fmaf(x[j], y[j], acc);
  }
  for (; i < n; ++i) acc = fmaf(a[i * as], b[i * bs], acc);
  return acc;
}

// z = sum_k h[k] w[k * ws] + b, in input order: the one Dense arithmetic
// that the forward and the backward's recompute share
__device__ __forceinline__ float dense_dot(const float* h, const float* w,
                                           int ws, int n, float b) {
  return __fadd_rn(fma_chain(h, 1, w, ws, n, 0.0f), b);
}

// n floats from global src into shared dst (16-byte aligned), the block's
// threads: 16-byte copies where src is aligned too
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      ddls::cp_async16(dst + 4 * i, src + 4 * i);
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += blockDim.x) {
      ddls::cp_async4(dst + i, src + i);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      ddls::cp_async4(dst + i, src + i);
    }
  }
}

// output rows [o0, o0 + oc) of W [out][in] transposed into dst [in][oc]
__device__ __forceinline__ void copy_async_t(float* dst, const float* w,
                                             int in, int o0, int oc) {
  const float* src = w + static_cast<size_t>(o0) * in;
  for (int i = threadIdx.x; i < oc * in; i += blockDim.x) {
    const int o = i / in;
    ddls::cp_async4(dst + (i - o * in) * oc + o, src + i);
  }
}

// Streams output rows of L through the two buffers, oc_max = chunk / in at
// a time, transposed ([k][o - o0]) or as stored ([o - o0][k]); calls
// use(w, o0, oc) on each chunk once it has landed, with the next chunk's
// copies in flight. Every thread of the block calls it.
template <typename Use>
__device__ void stream_layer(const Layer& L, float* buf0, float* buf1,
                             int chunk, bool transpose, Use use) {
  const int oc_max = max(1, min(L.out, chunk / L.in));
  const int n_chunks = (L.out + oc_max - 1) / oc_max;
  auto issue = [&](int c) {
    const int o0 = c * oc_max;
    const int oc = min(oc_max, L.out - o0);
    float* dst = (c & 1) ? buf1 : buf0;
    if (transpose) {
      copy_async_t(dst, L.w, L.in, o0, oc);
    } else {
      copy_async(dst, L.w + static_cast<size_t>(o0) * L.in, oc * L.in);
    }
    ddls::cp_async_commit();
  };
  issue(0);
  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      issue(c + 1);
      ddls::cp_async_wait_group<1>();
    } else {
      ddls::cp_async_wait_group<0>();
    }
    __syncthreads();
    const int o0 = c * oc_max;
    use((c & 1) ? buf1 : buf0, o0, min(oc_max, L.out - o0));
    __syncthreads();
  }
}

// e / n for 0 <= e, e * n < 2^32: the high word of e * ceil(2^32 / n)
// (exact there, since the ceiling's excess over 2^32 / n is below one);
// made on the host where a kernel's divisors are known at launch (the
// 64-bit division costs a thread a few hundred cycles)
struct FastDiv {
  unsigned m;
  int n;
  FastDiv() = default;
  __host__ __device__ explicit FastDiv(int n_)
      : m(n_ == 1 ? 0u
                  : static_cast<unsigned>((0x100000000ull + n_ - 1) / n_)),
        n(n_) {}
  __device__ int operator()(int e) const {
    return n == 1 ? e : static_cast<int>(__umulhi(static_cast<unsigned>(e),
                                                  m));
  }
};

// a[1] where `second`, else a[0]: constant indices, so a small array of
// per-head values stays in registers
template <typename V>
__device__ __forceinline__ V pick(bool second, const V (&a)[2]) {
  return second ? a[1] : a[0];
}

// ------------------------------------------------------------- forward
// The forward's shared-memory layout (floats, each array 16-byte aligned),
// computed on the host: the tile's x, a head's hidden outputs (two buffers
// where it has two hidden layers), every bias; then every weight as stored
// with each row padded by one float ([out][in + 1]: a warp's lanes, on
// neighbouring outputs, read one column in distinct banks) -- `resident`
// -- or two chunk buffers the layers stream through (transposed).
struct Fwd {
  int x;
  int h[2][2];
  int b[2][kMaxLayers];
  int w[2][kMaxLayers];   // resident
  int buf[2];             // streaming
  int resident;
  int floats;             // the dynamic shared memory
  FastDiv by_k;                       // the input width
  FastDiv by_in[2][kMaxLayers];       // each layer's inputs
  FastDiv by_out[2][kMaxLayers];      // each layer's outputs
};

// W [out][in] into dst [out][in + 1] (rows padded by one float), the
// block's threads, 4 bytes a copy: neighbouring threads copy neighbouring
// words, so the reads coalesce and the writes take distinct banks
__device__ __forceinline__ void copy_async_padded(float* dst, const float* w,
                                                  int n, const FastDiv& by_in) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ddls::cp_async4(dst + i + by_in(i), w + i);  // o * (in + 1) + k
  }
}

// out = z on a head's last layer (into logits or value), else act(z) into
// the head's hidden buffer
__device__ __forceinline__ void put_output(float z, bool last, bool value_head,
                                           int r, int o, int row0, int a,
                                           float* __restrict__ logits,
                                           float* __restrict__ value,
                                           float* h_s, int st, int act) {
  if (!last) {
    h_s[r * st + o] = ddls::activate(z, act);
  } else if (value_head) {
    value[row0 + r] = z;
  } else {
    logits[static_cast<size_t>(row0 + r) * a + o] = z;
  }
}

template <bool kResident>
__global__ void __launch_bounds__(kMaxFwdThreads)
mlp_heads_kernel(const float* __restrict__ x,  // [rows, k]
                 Heads heads, Fwd lay,
                 float* __restrict__ logits,   // [rows, a]
                 float* __restrict__ value,    // [rows]
                 int rows, int act, int tile) {
  extern __shared__ __align__(16) float sm[];
  const int st = heads.stride;
  const int k_in = heads.layer[0][0].in;
  const int a = heads.layer[0][heads.n_layers[0] - 1].out;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * tile;
  const int tr = min(tile, rows - row0);
  float* x_s = sm + lay.x;

  // the tile's x, every bias and (resident) every weight, in flight
  // together
  const float* xt = x + static_cast<size_t>(row0) * k_in;
  for (int i = tid; i < tr * k_in; i += nt) {
    const int r = lay.by_k(i);
    ddls::cp_async4(x_s + r * st + (i - r * k_in), xt + i);
  }
  for (int h = 0; h < 2; ++h) {
    for (int l = 0; l < heads.n_layers[h]; ++l) {
      const Layer& L = heads.layer[h][l];
      copy_async(sm + lay.b[h][l], L.b, L.out);
      if (kResident) {
        copy_async_padded(sm + lay.w[h][l], L.w, L.out * L.in,
                          lay.by_in[h][l]);
      }
    }
  }
  ddls::cp_async_commit();
  ddls::cp_async_wait_group<0>();
  __syncthreads();

  if (kResident) {
    // both heads a step a layer depth (layer s of each head that has it),
    // their items (row r, output o; o fastest) in one range; the depth
    // loop unrolled, so every table index is a constant (a kernel
    // parameter indexed at run time would be copied to local memory)
    const int steps = max(heads.n_layers[0], heads.n_layers[1]);
#pragma unroll
    for (int s = 0; s < kMaxLayers; ++s) {
      if (s >= steps) break;
      int n[2], width[2], depth[2];
      bool last[2];
      const float *in_s[2], *w[2], *bias[2];
      float* h_s[2];
      FastDiv by_out[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool on = s < heads.n_layers[h];
        const Layer& L = heads.layer[h][s];
        n[h] = on ? tr * L.out : 0;
        width[h] = L.out;
        depth[h] = L.in;
        last[h] = s == heads.n_layers[h] - 1;
        in_s[h] = s == 0 ? x_s : sm + lay.h[h][(s - 1) & 1];
        h_s[h] = sm + lay.h[h][s & 1];
        w[h] = sm + lay.w[h][s];
        bias[h] = sm + lay.b[h][s];
        by_out[h] = lay.by_out[h][s];
      }
      for (int p = tid; p < n[0] + n[1]; p += nt) {
        // (the heads' values picked, not indexed: a register array
        // indexed at run time would live in local memory)
        const bool h1 = p >= n[0];
        const int q = p - (h1 ? n[0] : 0);
        const int r = pick(h1, by_out)(q);
        const int o = q - r * pick(h1, width);
        const int k = pick(h1, depth);
        const float z = dense_dot(pick(h1, in_s) + r * st,
                                  pick(h1, w) + o * (k + 1), 1, k,
                                  pick(h1, bias)[o]);
        put_output(z, pick(h1, last), h1, r, o, row0, a, logits, value,
                   pick(h1, h_s), st, act);
      }
      if (s + 1 < steps) __syncthreads();
    }
  } else {
    // streaming: each head and layer in turn, the weights in chunks
    float* buf0 = sm + lay.buf[0];
    float* buf1 = sm + lay.buf[1];
    for (int h = 0; h < 2; ++h) {
      const int n = heads.n_layers[h];
      for (int l = 0; l < n; ++l) {
        const Layer& L = heads.layer[h][l];
        const float* in_s = l == 0 ? x_s : sm + lay.h[h][(l - 1) & 1];
        float* h_s = sm + lay.h[h][l & 1];
        const float* b_s = sm + lay.b[h][l];
        const bool last = l == n - 1;
        stream_layer(L, buf0, buf1, heads.chunk, true,
                     [&](const float* w, int o0, int oc) {
          const FastDiv by_oc(oc);
          for (int p = tid; p < tr * oc; p += nt) {
            const int r = by_oc(p);
            const int o = p - r * oc;
            const float z = dense_dot(in_s + r * st, w + o, oc, L.in,
                                      b_s[o0 + o]);
            put_output(z, last, h == 1, r, o0 + o, row0, a, logits, value,
                       h_s, st, act);
          }
        });
      }
    }
  }
}

// ------------------------------------------------------------- backward
// Per 8-row tile and head: recompute the hidden pre-activations z_l and
// outputs h_l, then walk the layers backwards with d = d out:
//   dW_l[o][k] += sum_r d[r][o] h_{l-1}[r][k], db_l[o] += sum_r d[r][o]
//     (rows in order, one fmaf a row; rows past the end hold zeros),
//   d h_{l-1}[r][k] = sum_o d[r][o] W_l[o][k] (outputs in order),
//   d = d h_{l-1} * act'(z_{l-1}),
// and d x = (0 + d h_0 of head 0) + d h_0 of head 1. CTA g of the G =
// min(tiles, 132) that take tiles sums tiles g, g + G, ... in order into
// its partial row P_g; the gradient is ((0 + P_0) + P_1) + ... + P_{G-1}.
// These are the sums, in the same order, of the earlier two-launch design
// (per-CTA rows in global memory, then a reduce kernel), so the results
// keep its bits at every row count.
//
// The shared-memory layout (floats, each array 16-byte aligned), computed
// on the host: the tile's x, the hidden z and h of each head, two output-
// gradient buffers a head, every bias; then either every weight as stored
// ([out][in], for d h) and, for the hidden layers, transposed ([in][out],
// for the recompute) -- `resident` -- or two chunk buffers the layers
// stream through; then, where they fit, every part's row (a launch of one
// cluster: the CTAs write their rows into rank 0's, which adds them) or
// else the CTA's own partial row.
struct Bwd {
  int x;
  int z[2][kMaxLayers - 1], h[2][kMaxLayers - 1];
  int d[2][2];
  int b[2][kMaxLayers];
  int w[2][kMaxLayers], wt[2][kMaxLayers];  // resident
  int buf[2];                               // streaming
  int rows;          // [parts][n_params] in rank 0, or -1
  int acc;           // the CTA's partial row, or -1 (global memory)
  int p_off[2][kMaxLayers];  // a layer's W, then b, in the gradient
  int resident;
  int floats;        // the dynamic shared memory
};


// one parameter-gradient entry e of layer L over the tile (e < out * in:
// W[o][k]; else b[e - out * in]), rows in order, added into the CTA's row;
// by_in divides by L.in
__device__ __forceinline__ void param_entry(const Layer& L, const float* d,
                                            const float* hin, int st, int e,
                                            const FastDiv& by_in,
                                            float* slot, bool first) {
  const int n_w = L.out * L.in;
  float s = 0.0f;
  if (e < n_w) {
    const int o = by_in(e);
    const int k = e - o * L.in;
#pragma unroll
    for (int r = 0; r < kRowsBwd; ++r) {
      s = fmaf(d[r * st + o], hin[r * st + k], s);
    }
  } else {
    const int o = e - n_w;
#pragma unroll
    for (int r = 0; r < kRowsBwd; ++r) s = __fadd_rn(s, d[r * st + o]);
  }
  *slot = first ? s : __fadd_rn(*slot, s);
}

template <bool kResident>
__global__ void __launch_bounds__(kMaxBwdThreads)
mlp_heads_bwd_kernel(const float* __restrict__ x,       // [rows, k]
                     Heads heads, Bwd lay,
                     const float* __restrict__ dlogits,  // [rows, a]
                     const float* __restrict__ dvalue,   // [rows]
                     float* __restrict__ dx,              // [rows, k]
                     float* __restrict__ grads,           // [n_params]
                     float* __restrict__ partial,  // [parts, n_params]
                     int* __restrict__ counter,    // the clusters' ticket
                     int rows, int act, int parts) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_last;
  const int st = heads.stride;
  const int k_in = heads.layer[0][0].in;
  const int n_params = heads.n_params;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int b = blockIdx.x;
  const int n_tiles = (rows + kRowsBwd - 1) / kRowsBwd;
  float* x_s = sm + lay.x;

  // every bias, and (resident) every weight in both layouts, in flight
  for (int h = 0; h < 2; ++h) {
    const int n = heads.n_layers[h];
    for (int l = 0; l < n; ++l) {
      const Layer& L = heads.layer[h][l];
      copy_async(sm + lay.b[h][l], L.b, L.out);
      if (kResident) {
        copy_async(sm + lay.w[h][l], L.w, L.out * L.in);
        if (l + 1 < n) copy_async_t(sm + lay.wt[h][l], L.w, L.in, 0, L.out);
      }
    }
  }
  ddls::cp_async_commit();
  // the CTA's partial row: in rank 0's rows (one tile a CTA there), its own
  // shared memory, or the scratch
  ddls::cg::cluster_group cluster = ddls::cg::this_cluster();
  float* acc =
      lay.rows >= 0
          ? cluster.map_shared_rank(sm + lay.rows, 0) +
                static_cast<size_t>(b) * n_params
      : lay.acc >= 0 ? sm + lay.acc
                     : partial + static_cast<size_t>(b) * n_params;
  bool first = true;
  for (int t = b; b < parts && t < n_tiles; t += parts) {
    const int row0 = t * kRowsBwd;
    const int tile_rows = min(kRowsBwd, rows - row0);
    // the tile's x and output gradients; zeros past its rows
    for (int i = tid; i < kRowsBwd * k_in; i += nt) {
      const int r = i / k_in;
      const int k = i - r * k_in;
      if (r < tile_rows) {
        ddls::cp_async4(x_s + r * st + k,
                        x + static_cast<size_t>(row0 + r) * k_in + k);
      } else {
        x_s[r * st + k] = 0.0f;
      }
    }
    for (int h = 0; h < 2; ++h) {
      const int a = heads.layer[h][heads.n_layers[h] - 1].out;
      float* d = sm + lay.d[h][0];
      for (int i = tid; i < kRowsBwd * a; i += nt) {
        const int r = i / a;
        const int o = i - r * a;
        if (r < tile_rows) {
          ddls::cp_async4(d + r * st + o,
                          h == 0 ? dlogits + static_cast<size_t>(row0 + r) * a
                                       + o
                                 : dvalue + row0 + r);
        } else {
          d[r * st + o] = 0.0f;
        }
      }
    }
    ddls::cp_async_commit();
    ddls::cp_async_wait_group<0>();
    __syncthreads();
    int cur[2] = {0, 0};  // which d buffer holds a head's current d
    if (kResident) {
      // the recompute, both heads a step a layer depth (layer s of each
      // head that has it as a hidden layer), their items in one range;
      // the row is an item's low three bits, so items need no division
      const int steps = max(heads.n_layers[0], heads.n_layers[1]) - 1;
      for (int s = 0; s < steps; ++s) {
        int n[2];
        const float *in_s[2], *wt[2], *bias[2];
        float *z_s[2], *h_s[2];
        int width[2], depth[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool on = s + 1 < heads.n_layers[h];
          const Layer& L = heads.layer[h][on ? s : 0];
          n[h] = on ? kRowsBwd * L.out : 0;
          width[h] = L.out;
          depth[h] = L.in;
          in_s[h] = s == 0 ? x_s : sm + lay.h[h][on ? s - 1 : 0];
          wt[h] = sm + lay.wt[h][on ? s : 0];
          bias[h] = sm + lay.b[h][on ? s : 0];
          z_s[h] = sm + lay.z[h][on ? s : 0];
          h_s[h] = sm + lay.h[h][on ? s : 0];
        }
        for (int p = tid; p < n[0] + n[1]; p += nt) {
          // (the heads' values picked, not indexed: a register array
          // indexed at run time would live in local memory)
          const bool h1 = p >= n[0];
          const int q = p - (h1 ? n[0] : 0);
          const int r = q % kRowsBwd;
          const int o = q / kRowsBwd;
          const float z = dense_dot(pick(h1, in_s) + r * st,
                                    pick(h1, wt) + o, pick(h1, width),
                                    pick(h1, depth), pick(h1, bias)[o]);
          pick(h1, z_s)[r * st + o] = z;
          pick(h1, h_s)[r * st + o] = ddls::activate(z, act);
        }
        __syncthreads();
      }
      // the backward, both heads a step a layer depth (head h's layer
      // n_h - 1 - s): each head's parameter entries, then its d h, in one
      // range
      const int bsteps = max(heads.n_layers[0], heads.n_layers[1]);
      for (int s = 0; s < bsteps; ++s) {
        Layer L[2];
        int entries[2], n[2];
        const float *d[2], *hin[2], *w[2], *z[2];
        float *dn[2], *slot[2];
        bool deeper[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool on = s < heads.n_layers[h];
          const int l = on ? heads.n_layers[h] - 1 - s : 0;
          L[h] = heads.layer[h][l];
          entries[h] = L[h].out * L[h].in + L[h].out;
          n[h] = on ? entries[h] + kRowsBwd * L[h].in : 0;
          d[h] = sm + lay.d[h][cur[h]];
          dn[h] = sm + lay.d[h][cur[h] ^ 1];
          hin[h] = l == 0 ? x_s : sm + lay.h[h][l - 1];
          w[h] = sm + lay.w[h][l];
          z[h] = sm + lay.z[h][l > 0 ? l - 1 : 0];
          slot[h] = acc + lay.p_off[h][l];
          deeper[h] = l > 0;
        }
        const FastDiv by_in[2] = {FastDiv(L[0].in), FastDiv(L[1].in)};
        for (int p = tid; p < n[0] + n[1]; p += nt) {
          const bool h1 = p >= n[0];
          const int q = p - (h1 ? n[0] : 0);
          const Layer Lh = pick(h1, L);
          const int e = pick(h1, entries);
          if (q < e) {
            param_entry(Lh, pick(h1, d), pick(h1, hin), st, q,
                        pick(h1, by_in), pick(h1, slot) + q, first);
            continue;
          }
          const int r = (q - e) % kRowsBwd;
          const int k = (q - e) / kRowsBwd;
          float v = fma_chain(pick(h1, d) + r * st, 1, pick(h1, w) + k,
                              Lh.in, Lh.out, 0.0f);
          if (pick(h1, deeper)) {
            v = __fmul_rn(v, ddls::activate_grad(pick(h1, z)[r * st + k],
                                                 act));
          }
          pick(h1, dn)[r * st + k] = v;
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (s < heads.n_layers[h]) cur[h] ^= 1;
        }
      }
    } else {
      // streaming: each head and layer in turn, the weights in chunks
      float* buf0 = sm + lay.buf[0];
      float* buf1 = sm + lay.buf[1];
      const int chunk = heads.chunk;
      for (int h = 0; h < 2; ++h) {
        const int n = heads.n_layers[h];
        for (int l = 0; l + 1 < n; ++l) {
          const Layer& L = heads.layer[h][l];
          const float* in_s = l == 0 ? x_s : sm + lay.h[h][l - 1];
          float* z_s = sm + lay.z[h][l];
          float* h_s = sm + lay.h[h][l];
          const float* b_s = sm + lay.b[h][l];
          stream_layer(L, buf0, buf1, chunk, true,
                       [&](const float* w, int o0, int oc) {
            for (int p = tid; p < kRowsBwd * oc; p += nt) {
              const int r = p / oc;
              const int o = p - r * oc;
              const float z = dense_dot(in_s + r * st, w + o, oc, L.in,
                                        b_s[o0 + o]);
              z_s[r * st + o0 + o] = z;
              h_s[r * st + o0 + o] = ddls::activate(z, act);
            }
          });
        }
        for (int l = n - 1; l >= 0; --l) {
          const Layer& L = heads.layer[h][l];
          const float* d = sm + lay.d[h][cur[h]];
          float* dn = sm + lay.d[h][cur[h] ^ 1];
          const float* hin = l == 0 ? x_s : sm + lay.h[h][l - 1];
          const FastDiv by_in(L.in);
          for (int e = tid; e < L.out * L.in + L.out; e += nt) {
            param_entry(L, d, hin, st, e, by_in, acc + lay.p_off[h][l] + e,
                        first);
          }
          stream_layer(L, buf0, buf1, chunk, false,
                       [&](const float* w, int o0, int oc) {
            for (int i = tid; i < kRowsBwd * L.in; i += nt) {
              const int r = i / L.in;
              const int k = i - r * L.in;
              dn[r * st + k] = fma_chain(d + r * st + o0, 1, w + k, L.in, oc,
                                         o0 == 0 ? 0.0f : dn[r * st + k]);
            }
          });
          if (l > 0) {
            const float* z = sm + lay.z[h][l - 1];
            for (int i = tid; i < kRowsBwd * L.in; i += nt) {
              const int r = i / L.in;
              const int k = i - r * L.in;
              dn[r * st + k] = __fmul_rn(
                  dn[r * st + k], ddls::activate_grad(z[r * st + k], act));
            }
            __syncthreads();
          }
          cur[h] ^= 1;
        }
      }
    }
    // d x = (0 + head 0's d h_0) + head 1's
    const float* d0 = sm + lay.d[0][cur[0]];
    const float* d1 = sm + lay.d[1][cur[1]];
    for (int i = tid; i < tile_rows * k_in; i += nt) {
      const int r = i / k_in;
      const int k = i - r * k_in;
      dx[static_cast<size_t>(row0 + r) * k_in + k] = __fadd_rn(
          __fadd_rn(0.0f, d0[r * st + k]), d1[r * st + k]);
    }
    first = false;
    __syncthreads();
  }
  ddls::cp_async_wait_group<0>();  // a CTA without a tile

  // the gradient: ((0 + P_0) + P_1) + ... over the parts in order: rank 0
  // adds the rows in its shared memory, or the CTAs of the last cluster to
  // finish (the only one where the grid is one cluster) add them from the
  // scratch, each a slice of the columns
  const int crank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int clusters = static_cast<int>(gridDim.x) / csize;
  if (lay.rows < 0 && lay.acc >= 0 && b < parts) {
    float* row = partial + static_cast<size_t>(b) * n_params;
    for (int e = tid; e < n_params; e += nt) row[e] = acc[e];
  }
  if (clusters > 1) __threadfence();
  cluster.sync();
  constexpr int kInFlight = 16;  // a column's loads in flight
  if (lay.rows >= 0) {
    if (crank != 0) return;  // no CTA reads another's shared memory now
    const float* rows_s = sm + lay.rows;
    for (int e = tid; e < n_params; e += nt) {
      float s = 0.0f;
      for (int g = 0; g < parts; ++g) {
        s = __fadd_rn(s, rows_s[static_cast<size_t>(g) * n_params + e]);
      }
      grads[e] = s;
    }
    return;
  }
  if (clusters > 1) {
    // the ticket: rank 0 of each cluster takes one; the last one reduces
    if (crank == 0 && tid == 0) {
      s_last = atomicAdd(counter, 1) == clusters - 1;
    }
    cluster.sync();
    const bool last = *cluster.map_shared_rank(&s_last, 0) != 0;
    ddls::cluster_arrive();  // rank 0's flag read
    if (!last) {
      ddls::cluster_wait();
      return;
    }
    __threadfence();
  }
  for (int e = crank * nt + tid; e < n_params; e += csize * nt) {
    float s = 0.0f;
    for (int g0 = 0; g0 < parts; g0 += kInFlight) {
      float v[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        v[i] = g0 + i < parts
                   ? __ldcg(partial +
                            static_cast<size_t>(g0 + i) * n_params + e)
                   : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        if (g0 + i < parts) s = __fadd_rn(s, v[i]);
      }
    }
    grads[e] = s;
  }
  if (clusters > 1) {
    if (crank == 0 && tid == 0) *counter = 0;  // ready for the next launch
    ddls::cluster_wait();
  }
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

// The forward's layout for `heads` at `tile` rows in `budget` bytes of
// shared memory: resident where every weight fits, else streaming. False
// when not even the streaming layout fits.
bool fwd_layout(const Heads& heads, int tile, size_t budget, Fwd* lay) {
  *lay = Fwd{};
  int at = 0;
  auto take = [&](int floats) {
    const int here = at;
    at += (floats + 3) / 4 * 4;
    return here;
  };
  const int t = tile * heads.stride;
  lay->x = take(t);
  lay->by_k = FastDiv(heads.layer[0][0].in);
  for (int h = 0; h < 2; ++h) {
    const int n = heads.n_layers[h];
    for (int l = 0; l + 1 < n; ++l) lay->h[h][l] = take(t);
    for (int l = 0; l < n; ++l) {
      lay->b[h][l] = take(heads.layer[h][l].out);
      lay->by_out[h][l] = FastDiv(heads.layer[h][l].out);
    }
  }
  const int before = at;
  for (int h = 0; h < 2; ++h) {
    for (int l = 0; l < heads.n_layers[h]; ++l) {
      const Layer& L = heads.layer[h][l];
      lay->w[h][l] = take((L.in + 1) * L.out);
      lay->by_in[h][l] = FastDiv(L.in);
    }
  }
  const auto fits = [&](int floats) {
    return sizeof(float) * static_cast<size_t>(floats) <= budget;
  };
  lay->resident = fits(at);
  if (!lay->resident) {
    at = before;
    lay->buf[0] = take(heads.chunk);
    lay->buf[1] = take(heads.chunk);
    if (!fits(at)) return false;
  }
  lay->floats = at;
  return true;
}

// K17's threads: the most items of a layer depth at `tile` rows (resident;
// a chunk's at most `chunk` outputs streaming) or a sixteenth of the
// weights to stage (resident), in whole warps, at most kMaxFwdThreads
int fwd_threads(const Heads& heads, const Fwd& lay, int tile) {
  // at most 16 staging copies a thread
  int weights = 0;
  for (int h = 0; h < 2; ++h) {
    for (int l = 0; l < heads.n_layers[h]; ++l) {
      weights += heads.layer[h][l].in * heads.layer[h][l].out;
    }
  }
  int most = lay.resident ? (weights + 15) / 16 : 0;
  for (int s = 0; s < kMaxLayers; ++s) {
    int items = 0;
    for (int h = 0; h < 2; ++h) {
      if (s >= heads.n_layers[h]) continue;
      const Layer& L = heads.layer[h][s];
      const int oc = max(1, min(L.out, heads.chunk / L.in));
      items = lay.resident ? items + tile * L.out : max(items, tile * oc);
    }
    most = max(most, items);
  }
  const int warps = (most + ddls::kWarpSize - 1) / ddls::kWarpSize;
  return min(kMaxFwdThreads, max(1, warps) * ddls::kWarpSize);
}

// The backward's layout for `heads` in `budget` bytes of shared memory:
// resident where every weight (both layouts of the hidden ones) fits;
// then, for a launch of one cluster whose CTAs take one tile each, the
// `parts` rows where they fit, else the CTA's partial row where it fits.
// False when not even the streaming layout fits.
bool bwd_layout(const Heads& heads, size_t budget, int parts,
                bool one_cluster, Bwd* lay) {
  *lay = Bwd{};
  int at = 0;
  auto take = [&](int floats) {
    const int here = at;
    at += (floats + 3) / 4 * 4;
    return here;
  };
  const int tile = kRowsBwd * heads.stride;
  lay->x = take(tile);
  int p = 0;
  for (int h = 0; h < 2; ++h) {
    const int n = heads.n_layers[h];
    for (int l = 0; l + 1 < n; ++l) {
      lay->z[h][l] = take(tile);
      lay->h[h][l] = take(tile);
    }
    lay->d[h][0] = take(tile);
    lay->d[h][1] = take(tile);
    for (int l = 0; l < n; ++l) {
      const Layer& L = heads.layer[h][l];
      lay->b[h][l] = take(L.out);
      lay->p_off[h][l] = p;
      p += L.out * L.in + L.out;
    }
  }
  const int before = at;
  for (int h = 0; h < 2; ++h) {
    const int n = heads.n_layers[h];
    for (int l = 0; l < n; ++l) {
      const Layer& L = heads.layer[h][l];
      lay->w[h][l] = take(L.out * L.in);
      if (l + 1 < n) lay->wt[h][l] = take(L.out * L.in);
    }
  }
  const auto fits = [&](int floats) {
    return sizeof(float) * static_cast<size_t>(floats) <= budget;
  };
  lay->resident = fits(at);
  if (!lay->resident) {
    at = before;
    lay->buf[0] = take(heads.chunk);
    lay->buf[1] = take(heads.chunk);
    if (!fits(at)) return false;
  }
  const int rows = parts * heads.n_params;
  lay->rows = one_cluster && fits(at + rows) ? take(rows) : -1;
  lay->acc = lay->rows < 0 && fits(at + heads.n_params)
                 ? take(heads.n_params) : -1;
  lay->floats = at;
  return true;
}

}  // namespace

// The forward: x [rows, k] float32, the layer table (per head h and layer
// l, the four int64 entries weight pointer, bias pointer, in, out at (h *
// 3 + l) * 4, then the two layer counts), out logits [rows, a] and value
// [rows]; `tile` rows a CTA (1-16, models/policy.py heads_fwd_plan).
DDLS_EXPORT int ddls_mlp_heads(const void* x, const void* table,
                               void* logits, void* value, int rows, int act,
                               int tile, void* stream) {
  Heads heads;
  int k_in = 0;
  int a = 0;
  if (rows <= 0 || tile < 1 || tile > kMaxTile ||
      !read_heads(static_cast<const long long*>(table), &heads, &k_in, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int budget = 0;
  int rc = ddls::smem_optin(&budget);
  if (rc != 0) return rc;
  Fwd lay;
  if (!fwd_layout(heads, tile, static_cast<size_t>(budget), &lay)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // raise the dynamic shared-memory limit once, to the card's opt-in (the
  // first launch, before any CUDA-graph capture, sets it)
  static bool configured = false;
  if (!configured) {
    cudaError_t attr = cudaFuncSetAttribute(
        mlp_heads_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        budget);
    if (attr == cudaSuccess) {
      attr = cudaFuncSetAttribute(
          mlp_heads_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    }
    if (attr != cudaSuccess) return static_cast<int>(attr);
    configured = true;
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(lay.floats);
  const int threads = fwd_threads(heads, lay, tile);
  const auto launch = [&](auto kernel) {
    kernel<<<ddls::grid_for(rows, tile), threads, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), heads, lay, static_cast<float*>(logits),
        static_cast<float*>(value), rows, act, tile);
    return static_cast<int>(cudaGetLastError());
  };
  return lay.resident ? launch(mlp_heads_kernel<true>)
                      : launch(mlp_heads_kernel<false>);
}

// The backward: x [rows, k], the layer table (as ddls_mlp_heads), dlogits
// [rows, a], dvalue [rows]; out dx [rows, k] and grads [n_params] (every
// weight and bias, head 0's layers first, W then b); `partial` [parts,
// n_params] scratch, `counter` one int32, 0 between launches (the ticket:
// the wrapper's, one a (device, stream); null where the grid is one
// cluster, which takes no ticket). The grid is `clusters` clusters
// of `cluster_size` CTAs (1-16), at least `parts`, of `threads` threads (a
// multiple of 32 up to 1,024); the first `parts` CTAs take the tiles (one
// each where the grid is one cluster).
DDLS_EXPORT int ddls_mlp_heads_bwd(const void* x, const void* table,
                                   const void* dlogits, const void* dvalue,
                                   void* dx, void* grads, void* partial,
                                   void* counter, int rows, int act,
                                   int parts, int cluster_size, int clusters,
                                   int threads, void* stream) {
  Heads heads;
  int k_in = 0;
  int a = 0;
  if (rows <= 0 || parts <= 0 || cluster_size < 1 ||
      cluster_size > ddls::kMaxCluster || clusters < 1 ||
      cluster_size * clusters < parts ||
      (clusters > 1 && counter == nullptr) ||
      threads < 32 || threads > kMaxBwdThreads || threads % 32 != 0 ||
      (clusters == 1 && (rows + kRowsBwd - 1) / kRowsBwd > parts) ||
      !read_heads(static_cast<const long long*>(table), &heads, &k_in, &a)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int budget = 0;
  int rc = ddls::smem_optin(&budget);
  if (rc != 0) return rc;
  Bwd lay;
  // leave room for the kernel's static shared memory
  if (!bwd_layout(heads, static_cast<size_t>(budget) - 1024, parts,
                  clusters == 1, &lay)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(lay.floats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    cudaError_t err = ddls::prepare_cluster(kernel, cluster_size, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr;
    ddls::cluster_config(&config, &attr, clusters, cluster_size, threads,
                         smem, s);
    err = cudaLaunchKernelEx(
        &config, kernel, static_cast<const float*>(x), heads, lay,
        static_cast<const float*>(dlogits), static_cast<const float*>(dvalue),
        static_cast<float*>(dx), static_cast<float*>(grads),
        static_cast<float*>(partial), static_cast<int*>(counter), rows, act,
        parts);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  };
  return lay.resident ? launch(mlp_heads_bwd_kernel<true>)
                      : launch(mlp_heads_bwd_kernel<false>);
}
