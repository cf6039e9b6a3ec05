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
// Arithmetic: the row statistics (warp_sum's butterfly over features k
// and k + 32 on lane k, then ln_row.cuh row_stats), ln_apply, each z as
// one fmaf chain over the features in order and then the bias, then
// activate. K5 recomputes these
// pre-activations with the same code (ln_tile.cuh), so its
// activation-derivative decisions are this kernel's.
//
// What bounds it on the H100: bytes. Per row it reads K <= 64 floats and
// writes O <= 64 floats, and does 2*K*O flops: at most 16 flop per byte
// moved against the card's 67 TFLOP/s fp32 / 3.35 TB/s = 20, so device
// memory is the limit; at the main path's sizes (1,200 to 16,384 rows, a
// few hundred KB to 6 MB a call) a call is short enough that each CTA's
// chain of dependent steps sets its time. The first design (one warp a
// row, 8 rows a CTA) staged and transposed all of W into every one of up
// to 2,048 CTAs, ran one lane an output (half the warp idle at O = 16)
// through a serial chain of shared loads, and stored a float a lane. This
// design is K5's forward half (ln_tile.cuh):
//
//   * tiles of 16, 32 or 64 rows, the smallest that needs at most 256 CTAs
//     at one tile a CTA (else 64-row tiles, a CTA taking tiles blockIdx.x,
//     blockIdx.x + gridDim.x, ...): the wrapper computes the grid from the
//     row count (models/gnn.py fwd_grid), and W and the LayerNorm
//     parameters are staged once a CTA;
//   * the CTA copies a tile's rows with cp.async (16-byte chunks where the
//     width and addresses allow; a gathered copy reads its own row's
//     index), the next tile's into the second of two buffers while the
//     current one computes;
//   * the row statistics one warp a row, all of a warp's rows of the tile
//     (2, 4 or 8) at once: their sums in one packed butterfly (common.cuh
//     packed_warp_sums, a shuffle serving two trees, each tree's bits
//     warp_sum's) and each row's square root and division on a lane of
//     its own, in one pass;
//   * z register-tiled, RM rows x 4 outputs a thread, the inner index
//     serial in feature order, y and W^T read as float4s (a y float4 a
//     row and four W^T float4s for 16 RM multiply-adds);
//   * each thread writes its 4 outputs of a row as one float4 where O % 4
//     == 0 and the output is 16-byte aligned (neighbouring threads on
//     neighbouring float4s of a row), else a float at a time.
//
// Two barriers a tile. The intermediates (the [B*E, 32] message tensor of
// the reduce-on-messages call, y) never reach device memory.
#include "common.cuh"
#include "ln_row.cuh"
#include "ln_tile.cuh"

namespace {

using ddls::kMicro;
using ddls::Tiling;

__global__ void __launch_bounds__(ddls::kTileThreads, 2)
ln_linear_act_kernel(const float* __restrict__ a, const int* __restrict__ idx,
                     const float* __restrict__ b,
                     const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b,
                     const float* __restrict__ w,     // [fo, k] (torch layout)
                     const float* __restrict__ bias,  // [fo]
                     float* __restrict__ out,         // [rows, fo]
                     int rows, int fa, int fb, int b_given, int fo, int act,
                     int tile_rows) {
  extern __shared__ __align__(16) float smem[];
  const Tiling t = ddls::tiling(fa + fb, fo, tile_rows, false);
  const int tid = threadIdx.x;
  const float* wt_s = smem + t.wt;
  const float* bias_s = smem + t.bias;
  float* y_t = smem + t.y;

  const int n_tiles = (rows + t.tile - 1) / t.tile;
  int tile = blockIdx.x;
  // the first tile's rows, then W^T and the small parameters, all in
  // flight at once
  ddls::load_x(t, smem + t.xbuf, tile, rows, tid, a, idx, b, fa, fb,
               b_given);
  ddls::stage_params(t, smem, w, bias, ln_w, ln_b, false, tid);
  ddls::cp_async_commit();
  const bool vec_out = fo % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16
                                          == 0;

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int cur = it & 1;
    const float* x_t = smem + t.xbuf + cur * t.tile * t.ks;
    // the next tile's rows into the other buffer (read by this CTA's
    // statistics one tile ago, before the barrier that ended them), then
    // wait for this one's
    if (tile + static_cast<int>(gridDim.x) < n_tiles) {
      ddls::load_x(t, smem + t.xbuf + (cur ^ 1) * t.tile * t.ks,
                   tile + gridDim.x, rows, tid, a, idx, b, fa, fb, b_given);
    }
    ddls::cp_async_commit();
    ddls::cp_async_wait_group<1>();
    __syncthreads();  // also: the last tile's products have read y

    // every row of a warp's share of the tile in flight at once
    if (t.tile == 16) {
      ddls::tile_stats<2>(t, x_t, y_t, smem + t.lnw, smem + t.lnb, nullptr,
                          tile, rows, tid);
    } else if (t.tile == 32) {
      ddls::tile_stats<4>(t, x_t, y_t, smem + t.lnw, smem + t.lnb, nullptr,
                          tile, rows, tid);
    } else {
      ddls::tile_stats<8>(t, x_t, y_t, smem + t.lnw, smem + t.lnb, nullptr,
                          tile, rows, tid);
    }
    __syncthreads();

    const int row0 = tile * t.tile;
    ddls::z_tiles(t, wt_s, y_t, tid, [&](int r, int o0, const float* acc) {
      const int row = row0 + r;
      if (row >= rows) return;
      float v[kMicro];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        v[j] = ddls::activate(__fadd_rn(acc[j], bias_s[o0 + j]), act);
      }
      float* dst = out + static_cast<size_t>(row) * fo + o0;
      if (vec_out) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          if (o0 + j < fo) dst[j] = v[j];
        }
      }
    });
  }
  ddls::cp_async_wait_group<0>();  // the last (empty) group
}

size_t smem_bytes(int k_in, int fo, int tile_rows) {
  return sizeof(float) *
         static_cast<size_t>(ddls::tiling(k_in, fo, tile_rows, false).total);
}

}  // namespace

// K1: rows [rows] of a [*, fa] (gathered by idx [rows] int32 when given),
// b [rows, fb] (or a zero right half of fb columns), ln_w / ln_b [fa + fb],
// w [fo, fa + fb], bias [fo] into out [rows, fo], in tiles of tile_rows
// (16, 32 or 64) rows over `blocks` CTAs (at most the tiles).
DDLS_EXPORT int ddls_ln_linear_act(const void* a, const void* idx,
                                   const void* b, const void* ln_w,
                                   const void* ln_b, const void* w,
                                   const void* bias, void* out, int rows,
                                   int fa, int fb, int b_given, int fo,
                                   int act, int tile_rows, int blocks,
                                   void* stream) {
  if (rows <= 0 || fa <= 0 || fb < 0 || fa + fb > ddls::kLnMaxIn ||
      fo <= 0 || fo > ddls::kLnMaxOut ||
      (tile_rows != 16 && tile_rows != 32 && tile_rows != ddls::kMaxTile) ||
      blocks <= 0 || blocks > (rows + tile_rows - 1) / tile_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = smem_bytes(fa + fb, fo, tile_rows);
  // raise the dynamic shared-memory limit once, to the largest size any
  // widths take (the first launch, before any CUDA-graph capture, sets it)
  static size_t configured = 0;
  if (bytes > configured) {
    const size_t most =
        smem_bytes(ddls::kLnMaxIn, ddls::kLnMaxOut, ddls::kMaxTile);
    const cudaError_t attr = cudaFuncSetAttribute(
        ln_linear_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    configured = most;
  }
  ln_linear_act_kernel<<<blocks, ddls::kTileThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const int*>(idx),
      static_cast<const float*>(b), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), rows, fa, fb,
      b_given, fo, act, tile_rows);
  return static_cast<int>(cudaGetLastError());
}
