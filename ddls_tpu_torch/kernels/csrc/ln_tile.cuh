// The row tiles that K1 (ln_linear_act.cu) and its backward K5
// (ln_linear_act_bwd.cu) share: the shared-memory layout of a tile of 16,
// 32 or 64 rows, the cp.async copies of the parameters and of a tile's
// rows (gathered or not, with the right-hand concat or its zero half), the
// row statistics one warp a row, and the register-tiled pre-activations
// z = y W^T + bias. K5 recomputes K1's forward with this very code, so its
// pre-activations are K1's by construction and every activation-derivative
// decision matches the forward's.
//
// Every function here is called by all kTileThreads threads of the CTA.
#pragma once

#include "common.cuh"
#include "ln_row.cuh"

namespace ddls {

constexpr int kTileWarps = 8;
constexpr int kTileThreads = kTileWarps * kWarpSize;
constexpr int kMaxTile = 64;   // rows a tile, at most (16, 32 or 64)
constexpr int kMicro = 4;      // a micro-tile's rows (at most) and columns
constexpr int kMaxGroups = 8;  // row groups of K5's parameter gradients

// A row stride of `width` floats: a multiple of 4 (float4 reads) whose
// quarter is odd, so eight consecutive rows start in distinct 4-bank sets.
__host__ __device__ inline int padded(int width) {
  const int w4 = (width + 3) / 4 * 4;
  return (w4 / 4) % 2 == 1 ? w4 : w4 + 4;
}

__host__ __device__ inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

// The tiling of one call's widths, and its shared memory in floats. The
// forward (K1) lays out W^T, the bias and LayerNorm parameters, two input
// buffers and y; the backward (K5) adds W, the row statistics, two dout
// buffers and dy, in the order below.
struct Tiling {
  int tile;                    // rows a tile
  int k_in, fo, ks, os;        // widths and padded row strides
  int nkb, nob;                // 4-wide column blocks of k and o
  int rm_z, rm_y;              // rows of a z / dy micro-tile
  int n_mt, groups;            // K5's parameter micro-tiles, row groups
  int n_params;
  // float offsets (w, stats, dbuf and dy: the backward only)
  int wt, w, bias, lnw, lnb, xbuf, dbuf, y, dy, stats, total;
};

__host__ __device__ inline Tiling tiling(int k_in, int fo, int tile,
                                         bool backward) {
  Tiling t{};
  t.tile = tile;
  t.k_in = k_in;
  t.fo = fo;
  t.ks = padded(k_in);
  t.os = padded(fo);
  t.nkb = (k_in + 3) / 4;
  t.nob = (fo + 3) / 4;
  t.rm_z = pow2_at_least((tile * t.nob + kTileThreads - 1) / kTileThreads);
  t.rm_y = pow2_at_least((tile * t.nkb + kTileThreads - 1) / kTileThreads);
  t.n_mt = t.nob * t.nkb;
  t.groups = 1;
  while (t.groups < kMaxGroups && 2 * t.groups * t.n_mt <= kTileThreads) {
    t.groups *= 2;
  }
  t.n_params = fo * k_in + fo + 2 * k_in;
  int o = 0;
  t.wt = o;  // [k][os]: z's float4 of outputs
  o += k_in * t.os;
  if (backward) {
    t.w = o;  // [fo][ks]: dy's float4 of features
    o += fo * t.ks;
  }
  t.bias = o;
  o += t.os;
  t.lnw = o;
  o += t.ks;
  t.lnb = o;
  o += t.ks;
  if (backward) {
    t.stats = o;  // [tile][4]: mean, raw, var, inv_std
    o += 4 * tile;
  }
  t.xbuf = o;  // [2][tile][ks]: x (K5: then d ln_w's term in place)
  o += 2 * tile * t.ks;
  if (backward) {
    t.dbuf = o;  // [2][tile][os]: dout, then dz in place
    o += 2 * tile * t.os;
  }
  t.y = o;  // [tile][ks]
  o += tile * t.ks;
  if (backward) {
    t.dy = o;  // [tile][ks]
    o += tile * t.ks;
  }
  // K5's row groups' sums reuse the tile buffers at the end
  const int scratch = backward ? t.xbuf + t.groups * t.n_params : 0;
  t.total = o > scratch ? o : scratch;
  return t;
}

// `width` floats of each of the tile's rows into shared rows `stride`
// apart, by the whole CTA: 16-byte cp.async where the width and the source
// allow (a copy a 4-float chunk), else 4-byte (a copy a float); a copy
// reads its own row's index when the rows are gathered (idx), so no warp
// walks the rows in turn. Zeros past the row count.
__device__ __forceinline__ void copy_rows(float* dst, int stride,
                                          const float* __restrict__ src,
                                          const int* __restrict__ idx,
                                          int width, int row0, int tile_rows,
                                          int rows, int tid) {
  const bool vec =
      width % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) %
              16 ==
          0;
  const int cw = vec ? 4 : 1;
  const int per_row = width / cw;
  for (int e = tid; e < tile_rows * per_row; e += kTileThreads) {
    const int r = e / per_row;
    const int c = (e - r * per_row) * cw;
    const int row = row0 + r;
    float* d = dst + r * stride + c;
    if (row >= rows) {
      for (int q = 0; q < cw; ++q) d[q] = 0.0f;
      continue;
    }
    const float* s =
        src + static_cast<size_t>(idx != nullptr ? idx[row] : row) * width +
        c;
    if (vec) {
      cp_async16(d, s);
    } else {
      cp_async4(d, s);
    }
  }
}

// W^T (and, for the backward, W), the bias and the LayerNorm parameters
// into shared memory by cp.async, zeros in the padding; the caller
// commits the group.
__device__ __forceinline__ void stage_params(
    const Tiling& t, float* smem, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ ln_w,
    const float* __restrict__ ln_b, bool both_layouts, int tid) {
  const int k_in = t.k_in, fo = t.fo;
  float* wt_s = smem + t.wt;
  float* w_s = smem + t.w;
  // element i = o k_in + k of w; a thread's (o, k) advance by the
  // stride's quotient and remainder (no division a copy)
  const int step_o = kTileThreads / k_in, step_k = kTileThreads % k_in;
  int o = tid / k_in, k = tid % k_in;
  for (int i = tid; i < fo * k_in; i += kTileThreads) {
    cp_async4(wt_s + k * t.os + o, w + i);
    if (both_layouts) cp_async4(w_s + o * t.ks + k, w + i);
    o += step_o;
    k += step_k;
    if (k >= k_in) {
      k -= k_in;
      ++o;
    }
  }
  for (int i = tid; i < k_in * (t.os - fo); i += kTileThreads) {
    const int k = i / (t.os - fo);
    wt_s[k * t.os + fo + (i - k * (t.os - fo))] = 0.0f;
  }
  if (both_layouts) {
    for (int i = tid; i < fo * (t.ks - k_in); i += kTileThreads) {
      const int o = i / (t.ks - k_in);
      w_s[o * t.ks + k_in + (i - o * (t.ks - k_in))] = 0.0f;
    }
  }
  for (int i = tid; i < t.os; i += kTileThreads) {
    if (i < fo) {
      cp_async4(smem + t.bias + i, bias + i);
    } else {
      smem[t.bias + i] = 0.0f;
    }
  }
  for (int i = tid; i < t.ks; i += kTileThreads) {
    if (i < k_in) {
      cp_async4(smem + t.lnw + i, ln_w + i);
      cp_async4(smem + t.lnb + i, ln_b + i);
    } else {
      smem[t.lnw + i] = 0.0f;
      smem[t.lnb + i] = 0.0f;
    }
  }
}

// Tile `tile`'s input rows into x buffer `xb`: a[idx[r]] (or a[r]) and
// b[r] (or the zero half), zeros in the padding.
__device__ __forceinline__ void load_x(const Tiling& t, float* xb, int tile,
                                       int rows, int tid,
                                       const float* __restrict__ a,
                                       const int* __restrict__ idx,
                                       const float* __restrict__ b, int fa,
                                       int fb, int b_given) {
  const int row0 = tile * t.tile;
  // the right half first: a gathered copy waits for its row's index
  if (b_given) {
    copy_rows(xb + fa, t.ks, b, nullptr, fb, row0, t.tile, rows, tid);
  }
  copy_rows(xb, t.ks, a, idx, fa, row0, t.tile, rows, tid);
  const int x_from = b_given ? t.k_in : fa;
  const int x_pad = t.ks - x_from;
  for (int e = tid; e < t.tile * x_pad; e += kTileThreads) {
    const int r = e / x_pad;
    xb[r * t.ks + x_from + (e - r * x_pad)] = 0.0f;
  }
}

// The row statistics and y = LN(x) of the tile's rows, one warp a row in
// K1's lane layout (features k and k + 32 on lane k), kBatch rows a warp
// at once so that their shuffles overlap (kBatch divides the warp's
// tile / kTileWarps rows); y = 0 past the row count. `stats` ([tile][4]:
// mean, raw, var, inv_std) is written when given.
template <int kBatch>
__device__ __forceinline__ void tile_stats(const Tiling& t, const float* x_t,
                                           float* y_t, const float* lnw_s,
                                           const float* lnb_s, float* stats,
                                           int tile, int rows, int tid) {
  const int warp = tid / kWarpSize;
  const int lane = tid % kWarpSize;
  const float inv_k = 1.0f / static_cast<float>(t.k_in);
  for (int i0 = 0; i0 < t.tile / kTileWarps; i0 += kBatch) {
    float x[kBatch][2];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = warp + (i0 + i) * kTileWarps;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + h * kWarpSize;
        x[i][h] = k < t.k_in ? x_t[r * t.ks + k] : 0.0f;
      }
    }
    // the 2 kBatch sums (each row's s, then each row's s2) in one packed
    // butterfly; lanes l and l ^ 16 then hold a row's s and s2, and every
    // lane takes its row's statistics (all rows in one pass: the square
    // root and division branch, so rows taken in turn would serialise)
    float v[2 * kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      v[i] = __fadd_rn(x[i][0], x[i][1]);
      v[kBatch + i] = __fadd_rn(__fmul_rn(x[i][0], x[i][0]),
                                __fmul_rn(x[i][1], x[i][1]));
    }
    const float sum = packed_warp_sums(v);
    const float other = __shfl_xor_sync(kFullMask, sum, 16);
    const bool high = (lane & 16) != 0;
    const RowStats mine =
        row_stats(high ? other : sum, high ? sum : other, inv_k);
    // row i's statistics are on lane i << kShift (and its copies)
    constexpr int kShift = kBatch == 1 ? 4 : kBatch == 2 ? 3
                         : kBatch == 4 ? 2 : 1;
    static_assert(kBatch == (16 >> kShift), "kBatch is 1, 2, 4 or 8");
    RowStats st[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      st[i].mean = __shfl_sync(kFullMask, mine.mean, i << kShift);
      st[i].inv_std = __shfl_sync(kFullMask, mine.inv_std, i << kShift);
    }
    if (stats != nullptr && (lane & ((1 << kShift) - 1)) == 0 && !high) {
      const int r = warp + (i0 + (lane >> kShift)) * kTileWarps;
      stats[4 * r] = mine.mean;
      stats[4 * r + 1] = mine.raw;
      stats[4 * r + 2] = mine.var;
      stats[4 * r + 3] = mine.inv_std;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int r = warp + (i0 + i) * kTileWarps;
      const bool live = tile * t.tile + r < rows;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = lane + h * kWarpSize;
        if (k < t.k_in) {
          y_t[r * t.ks + k] =
              live ? ln_apply(x[i][h], st[i], lnw_s[k], lnb_s[k]) : 0.0f;
        }
      }
    }
  }
}

// z = y W^T for RM rows x 4 outputs a thread, each z one fmaf chain over
// the features in order from 0 (the caller adds the bias after it):
// per 4 features a float4 of y a row and a float4 of W^T a feature (the
// features past the last multiple of 4 one at a time); then epi(r, o0,
// acc) for each of the thread's rows r, with acc[j] the sum of output
// o0 + j (0 for the padding outputs past fo).
template <int RM, typename Epilogue>
__device__ __forceinline__ void z_tile(const Tiling& t, const float* wt_s,
                                       const float* y_t, int tid,
                                       Epilogue epi) {
  if (tid >= (t.tile / RM) * t.nob) return;
  const int o0 = (tid % t.nob) * kMicro;
  const int r0 = (tid / t.nob) * RM;
  float acc[RM][kMicro];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
  }
  const float* yr = y_t + r0 * t.ks;
  const int k4 = t.k_in / 4 * 4;
  int k = 0;
#pragma unroll 2
  for (; k < k4; k += 4) {
    float yv[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(yr + i * t.ks + k);
      yv[i][0] = v.x;
      yv[i][1] = v.y;
      yv[i][2] = v.z;
      yv[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 wv =
          *reinterpret_cast<const float4*>(wt_s + (k + kk) * t.os + o0);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][0] = fmaf(yv[i][kk], wv.x, acc[i][0]);
        acc[i][1] = fmaf(yv[i][kk], wv.y, acc[i][1]);
        acc[i][2] = fmaf(yv[i][kk], wv.z, acc[i][2]);
        acc[i][3] = fmaf(yv[i][kk], wv.w, acc[i][3]);
      }
    }
  }
  for (; k < t.k_in; ++k) {
    const float4 wv = *reinterpret_cast<const float4*>(wt_s + k * t.os + o0);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float yv = yr[i * t.ks + k];
      acc[i][0] = fmaf(yv, wv.x, acc[i][0]);
      acc[i][1] = fmaf(yv, wv.y, acc[i][1]);
      acc[i][2] = fmaf(yv, wv.z, acc[i][2]);
      acc[i][3] = fmaf(yv, wv.w, acc[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) epi(r0 + i, o0, acc[i]);
}

// z_tile at the tiling's micro-tile height
template <typename Epilogue>
__device__ __forceinline__ void z_tiles(const Tiling& t, const float* wt_s,
                                        const float* y_t, int tid,
                                        Epilogue epi) {
  if (t.rm_z == 1) {
    z_tile<1>(t, wt_s, y_t, tid, epi);
  } else if (t.rm_z == 2) {
    z_tile<2>(t, wt_s, y_t, tid, epi);
  } else {
    z_tile<4>(t, wt_s, y_t, tid, epi);
  }
}

}  // namespace ddls
