// K5 ln_linear_act_bwd: the backward of K1 (row LayerNorm -> Dense -> act,
// with the optional row gather and right-hand concat), the parameter
// gradients' sum over the CTAs included.
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
//   * out = [dW [fo, k], dbias [fo], d ln_w [k], d ln_b [k]], summed over
//     every row.
//
// Arithmetic: the forward is recomputed exactly as K1 does it (ln_row.cuh:
// the row statistics, the normalised value, each pre-activation as one
// fmaf chain over the features in order, then the bias), so z and the
// activation-derivative decisions are K1's bit for bit. The LayerNorm
// backward is the derivative of flax's FAST variance, not torch's
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
// What bounds it on the H100: operations, on the CUDA cores (~6 K O flops
// a row against K + O floats read and K written; the three products need
// full float32: TF32 keeps three digits, and z must be K1's fmaf chain);
// at the main path's widths (K, O <= 64, 128 to 16,384 rows) a call is
// short enough that each CTA's chain of dependent steps sets its time.
// The first design lost its time to (a) one 8-warp block per SM walking
// many 32-row tiles with little in flight, (b) one lane per output of a
// row's products (at widths 8-64 most lanes idle), (c) two shared loads
// per FMA in the parameter gradients, (d) no overlap of loads with
// compute, and (e) a second launch summing the per-block partial rows
// with 132 dependent loads an entry. This design:
//
//   * tiles of 16, 32 or 64 rows, the smallest that needs at most 256 CTAs
//     at one tile a CTA (else 64-row tiles, a CTA taking tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ...): the wrapper computes the grid from the
//     row count alone, and small calls spread over more SMs with fewer
//     rows a warp;
//   * the CTA copies a tile's rows with cp.async, whole-tile at a time (a
//     copy a float, or a 16-byte chunk where the width and the addresses
//     allow; a gathered copy reads its own row's index), and W in both
//     layouts the same way; the next tile's rows go into the second of two
//     buffers while the current one computes;
//   * the row statistics and the LayerNorm backward stay one warp a row,
//     in K1's lane layout (two rows a warp at once, so their shuffles
//     overlap; the statistics' four sums in one packed butterfly), so dx
//     and db keep their arithmetic;
//   * z = y W^T and dy = dz W are register-tiled (z_tile, dy_tile): each
//     thread holds RM rows x 4 outputs (or features), RM a template
//     argument so the loads pipeline, and runs the inner index serially in
//     the old order, reading one float4 of W and one y (or dz) a row per
//     step, so every z and dy is the old value;
//   * dW, dbias, d ln_w, d ln_b accumulate in register micro-tiles of a
//     2-D tiling of [fo, k] (4 x 4 a thread, over the tile's rows in order,
//     reading dz and y as float4 a row ahead: half a shared load per FMA);
//     where the micro-tiles leave threads idle the rows are split over up
//     to 8 groups, summed in group order at the CTA's end;
//   * the reduce is folded in: each CTA writes its partial row, fences and
//     takes a ticket of its group of kGroup CTAs; the last CTA of a group
//     sums the group's rows in block order, and the last group to finish
//     sums the group rows in order, every row's load of a column in flight
//     before the adds. The counters are the wrapper's, one set per (device,
//     stream), so launches that overlap run on distinct sets; each is set
//     back to 0 by the CTA that read it last, so the launch replays inside
//     a CUDA graph.
//
// The tiling, the copies, the statistics and z_tile are K1's own code
// (ln_tile.cuh), so this kernel's pre-activations are K1's by construction.
//
// Nothing is a float atomic and every sum runs in a fixed order, so the
// same inputs give the same bits on every run. Shared memory: W in both
// layouts, the LayerNorm parameters, two input buffers and the tile's y
// and dy, row strides padded so that eight rows fall in distinct banks:
// 91 KB (10^3 bytes) at 32 -> 64 and 64-row tiles (the reduce-on-messages
// call), 141 KB at 64 -> 64; 128 registers, so two CTAs an SM.
#include "common.cuh"
#include "ln_row.cuh"
#include "ln_tile.cuh"

namespace {

using ddls::kMaxTile;
using ddls::kMicro;
using ddls::Tiling;
constexpr int kWarps = ddls::kTileWarps;
constexpr int kThreads = ddls::kTileThreads;
constexpr int kRowBatch = 2;   // rows a warp carries at once (A and D)
static_assert(16 / kWarps % kRowBatch == 0,
              "a warp's rows of the smallest tile come in whole batches");
constexpr int kGroup = 16;     // CTAs a reduce group; at most kGroup groups

// d max(0, raw) / d raw, jnp.maximum's rule
__device__ __forceinline__ float clamp_grad(float raw) {
  return raw > 0.0f ? 1.0f : (raw == 0.0f ? 0.5f : 0.0f);
}

// Tile `tile`'s rows into buffer `buf`: the input rows into x (ln_tile.cuh
// load_x), dout[r] into d, zeros in the padding.
__device__ __forceinline__ void load_tile(
    const Tiling& t, float* smem, int buf, int tile, int rows, int tid,
    const float* __restrict__ a, const int* __restrict__ idx,
    const float* __restrict__ b, const float* __restrict__ dout, int fa,
    int fb, int b_given) {
  float* xb = smem + t.xbuf + buf * t.tile * t.ks;
  float* db = smem + t.dbuf + buf * t.tile * t.os;
  ddls::load_x(t, xb, tile, rows, tid, a, idx, b, fa, fb, b_given);
  ddls::copy_rows(db, t.os, dout, nullptr, t.fo, tile * t.tile, t.tile,
                  rows, tid);
  const int d_pad = t.os - t.fo;
  for (int e = tid; e < t.tile * d_pad; e += kThreads) {
    const int r = e / d_pad;
    db[r * t.os + t.fo + (e - r * d_pad)] = 0.0f;
  }
}

// out[e] = the sum of rows[g][e] over rows g = 0, ..., n - 1 (n <= kGroup,
// each `stride` floats, a multiple of 4), added in row order from 0, for
// e < stride: a float4 column a thread, every row's load in flight before
// the adds (the rows come from other CTAs: read around L1).
__device__ __forceinline__ void sum_rows(const float* rows, int n,
                                         int stride, float* out, int tid) {
  for (int c = 4 * tid; c < stride; c += 4 * kThreads) {
    float4 v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      v[g] = g < n ? __ldcg(reinterpret_cast<const float4*>(
                         rows + static_cast<size_t>(g) * stride + c))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (g < n) {
        s.x = __fadd_rn(s.x, v[g].x);
        s.y = __fadd_rn(s.y, v[g].y);
        s.z = __fadd_rn(s.z, v[g].z);
        s.w = __fadd_rn(s.w, v[g].w);
      }
    }
    *reinterpret_cast<float4*>(out + c) = s;
  }
}

// Phase C for RM rows x 4 features a thread: dy = dz W, one fmaf chain
// over the outputs in order from 0.
template <int RM>
__device__ __forceinline__ void dy_tile(const Tiling& t, const float* w_s,
                                        const float* d_t, float* dy_t,
                                        int tid) {
  if (tid >= (t.tile / RM) * t.nkb) return;
  const int k0 = (tid % t.nkb) * kMicro;
  const int r0 = (tid / t.nkb) * RM;
  float acc[RM][kMicro];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
  }
  const float* dr = d_t + r0 * t.os;
#pragma unroll 4
  for (int o = 0; o < t.fo; ++o) {
    const float4 wv = *reinterpret_cast<const float4*>(w_s + o * t.ks + k0);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float dz = dr[i * t.os + o];
      acc[i][0] = fmaf(dz, wv.x, acc[i][0]);
      acc[i][1] = fmaf(dz, wv.y, acc[i][1]);
      acc[i][2] = fmaf(dz, wv.z, acc[i][2]);
      acc[i][3] = fmaf(dz, wv.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    *reinterpret_cast<float4*>(dy_t + (r0 + i) * t.ks + k0) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
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
                         float* __restrict__ partial,     // [grid, np4]
                         float* __restrict__ group_part,  // [J, np4]
                         float* __restrict__ out,         // [np4]
                         int* __restrict__ counters,      // [1 + J], zeros
                         int rows, int fa, int fb, int b_given, int fo,
                         int act, int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  const Tiling t = ddls::tiling(fa + fb, fo, tile_rows, true);
  const int k_in = t.k_in;
  const int tid = threadIdx.x;
  const int warp = tid / ddls::kWarpSize;
  const int lane = tid % ddls::kWarpSize;
  float* wt_s = smem + t.wt;
  float* w_s = smem + t.w;
  float* bias_s = smem + t.bias;
  float* lnw_s = smem + t.lnw;
  float* lnb_s = smem + t.lnb;
  float* stats = smem + t.stats;
  float* y_t = smem + t.y;
  float* dy_t = smem + t.dy;

  const int n_tiles = (rows + t.tile - 1) / t.tile;
  int tile = blockIdx.x;
  // W in both layouts and the small parameters by cp.async, every copy
  // in flight at once with the first tile's rows; zeros in the padding
  ddls::stage_params(t, smem, w, bias, ln_w, ln_b, true, tid);
  load_tile(t, smem, 0, tile, rows, tid, a, idx, b, dout, fa, fb, b_given);
  ddls::cp_async_commit();

  const float inv_k = 1.0f / static_cast<float>(k_in);
  // this thread's parameter micro-tile: 4 outputs x 4 features of dW,
  // with dbias (first feature block) and d ln_w, d ln_b (first output
  // block), over the rows of its group
  const bool has_mt = tid < t.n_mt * t.groups;
  const int grp = tid / t.n_mt;
  const int mt = tid - grp * t.n_mt;
  const int pkb = mt % t.nkb;
  const int pob = mt / t.nkb;
  const int g_rows = t.tile / t.groups;
  float acc_w[kMicro][kMicro], acc_b[kMicro], acc_lw[kMicro], acc_lb[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    acc_b[i] = acc_lw[i] = acc_lb[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc_w[i][j] = 0.0f;
  }

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int cur = it & 1;
    float* x_t = smem + t.xbuf + cur * t.tile * t.ks;
    float* d_t = smem + t.dbuf + cur * t.tile * t.os;
    // the next tile's rows into the other buffer, then wait for this one's
    if (tile + static_cast<int>(gridDim.x) < n_tiles) {
      load_tile(t, smem, cur ^ 1, tile + gridDim.x, rows, tid, a, idx, b,
                dout, fa, fb, b_given);
    }
    ddls::cp_async_commit();
    ddls::cp_async_wait_group<1>();
    __syncthreads();

    // (A) row statistics and y, one warp a row (K1's layout)
    ddls::tile_stats<kRowBatch>(t, x_t, y_t, lnw_s, lnb_s, stats, tile,
                                rows, tid);
    __syncthreads();

    // (B) z = y W^T + bias as K1 computes it (ln_tile.cuh z_tiles), then
    // dz = dY * act'(z) in place of dY (0 past the row count and the
    // outputs): rm_z rows x 4 outputs a thread
    ddls::z_tiles(t, wt_s, y_t, tid, [&](int r, int o0, const float* acc) {
      const bool live = tile * t.tile + r < rows;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int o = o0 + j;
        float dz = 0.0f;
        if (live && o < t.fo) {
          const float z = __fadd_rn(acc[j], bias_s[o]);
          dz = __fmul_rn(d_t[r * t.os + o], ddls::activate_grad(z, act));
        }
        d_t[r * t.os + o] = dz;
      }
    });
    __syncthreads();

    // (C) dy = dz W: rm_y rows x 4 features a thread, over the outputs in
    // order
    if (t.rm_y == 1) {
      dy_tile<1>(t, w_s, d_t, dy_t, tid);
    } else if (t.rm_y == 2) {
      dy_tile<2>(t, w_s, d_t, dy_t, tid);
    } else {
      dy_tile<4>(t, w_s, d_t, dy_t, tid);
    }
    __syncthreads();

    // (D) the LayerNorm backward, one warp a row (kRowBatch at once): dx
    // and db out, and dy (x - mean) rstd (d ln_w's term) in place of x
    for (int i0 = 0; i0 < t.tile / kWarps; i0 += kRowBatch) {
      float x[kRowBatch][2], dxc[kRowBatch][2];
      float part_rstd[kRowBatch], part_mean[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int r = warp + (i0 + i) * kWarps;
        const float inv_std = stats[4 * r + 3];
        const float mean = stats[4 * r];
        part_rstd[i] = 0.0f;
        part_mean[i] = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = lane + h * ddls::kWarpSize;
          x[i][h] = 0.0f;
          dxc[i][h] = 0.0f;
          if (k < k_in) {
            x[i][h] = x_t[r * t.ks + k];
            const float dy = dy_t[r * t.ks + k];
            const float xc = __fsub_rn(x[i][h], mean);
            const float d_mul = __fmul_rn(dy, xc);
            // rows past the row count have dy = 0, so this term is 0
            x_t[r * t.ks + k] = __fmul_rn(d_mul, inv_std);
            part_rstd[i] =
                __fadd_rn(part_rstd[i], __fmul_rn(d_mul, lnw_s[k]));
            dxc[i][h] = __fmul_rn(dy, __fmul_rn(inv_std, lnw_s[k]));
            part_mean[i] = __fadd_rn(part_mean[i], dxc[i][h]);
          }
        }
      }
      float d_rstd[kRowBatch], sum_dxc[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        d_rstd[i] = ddls::warp_sum(part_rstd[i]);
        sum_dxc[i] = ddls::warp_sum(part_mean[i]);
      }
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int r = warp + (i0 + i) * kWarps;
        const int row = tile * t.tile + r;
        if (row >= rows) continue;  // warp-uniform
        const float mean = stats[4 * r];
        const float raw = stats[4 * r + 1];
        const float var = stats[4 * r + 2];
        const float inv_std = stats[4 * r + 3];
        const float d_var = __fmul_rn(
            d_rstd[i],
            __fmul_rn(-0.5f,
                      __fdiv_rn(inv_std, __fadd_rn(var, ddls::kLnEps))));
        const float d_raw = __fmul_rn(d_var, clamp_grad(raw));
        const float d_mean = __fsub_rn(
            -sum_dxc[i], __fmul_rn(d_raw, __fmul_rn(2.0f, mean)));
        const float d_s = __fmul_rn(d_mean, inv_k);
        const float d_s2 = __fmul_rn(d_raw, inv_k);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = lane + h * ddls::kWarpSize;
          if (k >= k_in) continue;
          const float dx =
              __fadd_rn(__fadd_rn(dxc[i][h], d_s),
                        __fmul_rn(d_s2, __fmul_rn(2.0f, x[i][h])));
          if (k < fa) {
            if (dx_a != nullptr) {
              dx_a[static_cast<size_t>(row) * fa + k] = dx;
            }
          } else if (db != nullptr) {
            db[static_cast<size_t>(row) * fb + (k - fa)] = dx;
          }
        }
      }
    }
    __syncthreads();

    // (E) the tile's rows into this thread's parameter micro-tile, in row
    // order: dW[o][k] += dz[o] y[k], dbias[o] += dz[o],
    // d ln_w[k] += dy (x - mean) rstd, d ln_b[k] += dy
    if (has_mt) {
      const int o0 = pob * kMicro;
      const int k0 = pkb * kMicro;
      const bool ln_block = pob == 0;
      const int r_end = (grp + 1) * g_rows;
      int r = grp * g_rows;
      // each row's float4s are read a row ahead of their use
      float4 d4 = *reinterpret_cast<const float4*>(d_t + r * t.os + o0);
      float4 y4 = *reinterpret_cast<const float4*>(y_t + r * t.ks + k0);
      float4 g4 = *reinterpret_cast<const float4*>(x_t + r * t.ks + k0);
      float4 b4 = *reinterpret_cast<const float4*>(dy_t + r * t.ks + k0);
      for (; r < r_end; ++r) {
        const int rn = r + 1 < r_end ? r + 1 : r;
        const float4 d4n =
            *reinterpret_cast<const float4*>(d_t + rn * t.os + o0);
        const float4 y4n =
            *reinterpret_cast<const float4*>(y_t + rn * t.ks + k0);
        const float4 g4n =
            *reinterpret_cast<const float4*>(x_t + rn * t.ks + k0);
        const float4 b4n =
            *reinterpret_cast<const float4*>(dy_t + rn * t.ks + k0);
        const float dz[kMicro] = {d4.x, d4.y, d4.z, d4.w};
        const float yv[kMicro] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
#pragma unroll
          for (int j = 0; j < kMicro; ++j) {
            acc_w[i][j] = fmaf(dz[i], yv[j], acc_w[i][j]);
          }
        }
        if (pkb == 0) {
#pragma unroll
          for (int i = 0; i < kMicro; ++i) acc_b[i] = __fadd_rn(acc_b[i], dz[i]);
        }
        if (ln_block) {
          acc_lw[0] = __fadd_rn(acc_lw[0], g4.x);
          acc_lw[1] = __fadd_rn(acc_lw[1], g4.y);
          acc_lw[2] = __fadd_rn(acc_lw[2], g4.z);
          acc_lw[3] = __fadd_rn(acc_lw[3], g4.w);
          acc_lb[0] = __fadd_rn(acc_lb[0], b4.x);
          acc_lb[1] = __fadd_rn(acc_lb[1], b4.y);
          acc_lb[2] = __fadd_rn(acc_lb[2], b4.z);
          acc_lb[3] = __fadd_rn(acc_lb[3], b4.w);
        }
        d4 = d4n;
        y4 = y4n;
        g4 = g4n;
        b4 = b4n;
      }
    }
    __syncthreads();  // the buffers are rewritten by the tiles to come
  }
  ddls::cp_async_wait_group<0>();  // the last (empty) group

  // this CTA's partial row: the row groups summed in group order (rows of
  // np4 floats, the padding zero)
  const int np = t.n_params;
  const int np4 = (np + 3) / 4 * 4;
  const int n_w = fo * k_in;
  float* scratch = smem + t.xbuf;
  if (has_mt) {
    float* mine = scratch + grp * np;
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int o = pob * kMicro + i;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int k = pkb * kMicro + j;
        if (o < fo && k < k_in) mine[o * k_in + k] = acc_w[i][j];
      }
      if (pkb == 0 && o < fo) mine[n_w + o] = acc_b[i];
      const int k = pkb * kMicro + i;
      if (pob == 0 && k < k_in) {
        mine[n_w + fo + k] = acc_lw[i];
        mine[n_w + fo + k_in + k] = acc_lb[i];
      }
    }
  }
  __syncthreads();
  float* my_row = partial + static_cast<size_t>(blockIdx.x) * np4;
  for (int e = tid; e < np4; e += kThreads) {
    float s = 0.0f;
    if (e < np) {
      s = scratch[e];
      for (int g = 1; g < t.groups; ++g) {
        s = __fadd_rn(s, scratch[g * np + e]);
      }
    }
    my_row[e] = s;
  }

  // the reduce: the last CTA of each group of kGroup sums the group's
  // rows in block order; the last group to finish sums the group rows
  __shared__ int s_last;
  const int n_groups = (gridDim.x + kGroup - 1) / kGroup;
  const int gi = blockIdx.x / kGroup;
  const int g0 = gi * kGroup;
  const int g1 = min(static_cast<int>(gridDim.x), g0 + kGroup);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters + 1 + gi, 1) == g1 - g0 - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  sum_rows(partial + static_cast<size_t>(g0) * np4, g1 - g0, np4,
           n_groups == 1 ? out : group_part + static_cast<size_t>(gi) * np4,
           tid);
  if (tid == 0) counters[1 + gi] = 0;
  if (n_groups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counters, 1) == n_groups - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  sum_rows(group_part, n_groups, np4, out, tid);
  if (tid == 0) counters[0] = 0;
}

size_t smem_bytes(int k_in, int fo, int tile_rows) {
  return sizeof(float) *
         static_cast<size_t>(ddls::tiling(k_in, fo, tile_rows, true).total);
}

}  // namespace

// K5: rows [rows] of a [*, fa] (gathered by idx [rows] int32 when given),
// b [rows, fb] (or a zero right half of fb columns), ln_w / ln_b [fa + fb],
// w [fo, fa + fb], bias [fo], dout [rows, fo], in tiles of tile_rows (16,
// 32 or 64) rows over `blocks` CTAs (at most the tiles and kGroup^2);
// writes dx_a [rows, fa] and db [rows, fb] where given, partial [blocks,
// P4] and group_part [ceil(blocks / group), P4] as scratch, and out [P4],
// its first P the gradients (P = fo (fa + fb) + fo + 2 (fa + fb), P4 = P
// rounded up to a multiple of 4); group must be kGroup (16); counters
// [1 + ceil(blocks / group)] int32 must be zero and are left zero.
DDLS_EXPORT int ddls_ln_linear_act_bwd(
    const void* a, const void* idx, const void* b, const void* ln_w,
    const void* ln_b, const void* w, const void* bias, const void* dout,
    void* dx_a, void* db, void* partial, void* group_part, void* out,
    void* counters, int rows, int fa, int fb, int b_given, int fo, int act,
    int tile_rows, int blocks, int group, void* stream) {
  if (rows <= 0 || fa <= 0 || fb < 0 || fa + fb > ddls::kLnMaxIn ||
      fo <= 0 || fo > ddls::kLnMaxOut || group != kGroup ||
      (tile_rows != 16 && tile_rows != 32 && tile_rows != kMaxTile) ||
      blocks <= 0 || blocks > kGroup * kGroup ||
      blocks > (rows + tile_rows - 1) / tile_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(fa + fb, fo, tile_rows);
  // raise the dynamic shared-memory limit once, to the largest size any
  // widths take (the first launch, before any CUDA-graph capture, sets it)
  static size_t configured = 0;
  if (bytes > configured) {
    const size_t most =
        smem_bytes(ddls::kLnMaxIn, ddls::kLnMaxOut, kMaxTile);
    const cudaError_t attr = cudaFuncSetAttribute(
        ln_linear_act_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    configured = most;
  }
  ln_linear_act_bwd_kernel<<<blocks, kThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const int*>(idx),
      static_cast<const float*>(b), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(dout),
      static_cast<float*>(dx_a), static_cast<float*>(db),
      static_cast<float*>(partial), static_cast<float*>(group_part),
      static_cast<float*>(out), static_cast<int*>(counters), rows, fa, fb,
      b_given, fo, act, tile_rows);
  return static_cast<int>(cudaGetLastError());
}
