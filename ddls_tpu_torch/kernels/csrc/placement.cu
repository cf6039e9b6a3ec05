// K22 first_fit_block and K23 allocate_job: the device env's placement.
//
// K22 replaces ddls_tpu/sim/jax_block_search.py:62 first_fit_block_jax
// (over :39 valid_anchor_mask; vmapped by jitted_first_fit :103): on each
// boolean server grid of a batch, the first (shape, origin) whose window is
// free, in (shape order, then lexicographic origin) order. One CTA per grid;
// one thread per (shape, anchor) pair tests the anchor (its window taken
// modulo the grid, as jnp.roll does; diagonal shapes, S == -1, have an empty
// window, as in the reference) and a block-wide integer atomicMin over
// shape * cells + anchor picks the first valid one.
//
// K23 replaces ddls_tpu/sim/jax_env.py:450 jax_allocate_job (over :384
// _anchor_masks and :424 _first_fit_from_masks): per lane, the placement of
// one job's forward ops in topological order (the reference's lax.scan is
// the loop inside the block), each op by parent co-location (the first
// parent whose server count equals the split and whose servers all have
// room), else by the first-fit block search over the split's shape row
// with the free mask "no other job and enough memory", then the memory
// commit and the op -> server writes of its forward and backward sub-ops.
// The anchor geometry (every cell of every shape at every anchor, the
// diagonal wrap through (dim + 1) and the in-ramp test included) comes
// precomputed from the host (ShapeTables.anchor_cells, built from the
// reference's own formula), so the kernel gathers where the reference
// computes. Inactive lanes write nothing (the reference scatters them into
// a dummy slot N).
//
// What bounds them on the H100: latency. K23 is a chain of 15 dependent
// steps of a few hundred tests each (16 shapes x 32 anchors at most), with
// three barriers a step; the bytes (the lane's config rows, ~3 KB, and
// 480 + 32 outputs) and the operations (~10^4) would take the card well
// under a microsecond. The design: one CTA per lane, everything a step
// reads or writes in shared memory (free memory, occupancy, the placed
// ops' servers), one thread per (shape-row position, anchor) pair, the
// first fit as one shared-memory integer atomicMin (exact in any order);
// no float atomics. The memory commit subtracts each op's share once per
// server, as the reference's scatter-add of zeros and one share does; the
// servers of one block are distinct, so no two threads write one server.
// Built with -fmad=false (kernels/__init__.py EXTRA_FLAGS): nothing here
// multiplies, and nothing may be fused.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) first_fit_block_kernel(
    const bool* __restrict__ free, const int* __restrict__ shapes,
    int* __restrict__ out, bool* __restrict__ found, int C, int R, int S,
    int n_shapes, int m0, int m1, int m2) {
  const int g = blockIdx.x;
  const int n_cells = C * R * S;
  free += static_cast<size_t>(g) * n_cells;
  __shared__ int s_best;
  if (threadIdx.x == 0) s_best = INT_MAX;
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_shapes * n_cells; idx += blockDim.x) {
    const int si = idx / n_cells;
    const int a = idx - si * n_cells;
    const int s0 = shapes[3 * si], s1 = shapes[3 * si + 1],
              s2 = shapes[3 * si + 2];
    if (!(m0 >= s0 && m1 >= s1 && m2 >= s2)) continue;
    const int i = a / (R * S), j = (a / S) % R, k = a % S;
    if (!(i < max(m0 - s0 + 1, 0) && j < max(m1 - s1 + 1, 0) &&
          k < max(m2 - s2 + 1, 0))) {
      continue;
    }
    bool ok = free[a];
    for (int dc = 0; ok && dc < s0; ++dc) {
      for (int dr = 0; ok && dr < s1; ++dr) {
        for (int ds = 0; ok && ds < s2; ++ds) {
          const int cell = (((i + dc) % C) * R + (j + dr) % R) * S +
                           (k + ds) % S;
          ok = free[cell];
        }
      }
    }
    if (ok) atomicMin(&s_best, si * n_cells + a);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool hit = s_best != INT_MAX;
    const int shape = hit ? s_best / n_cells : -1;
    const int rank = hit ? s_best % n_cells : n_cells + 1;
    int* o = out + 4 * static_cast<size_t>(g);
    o[0] = shape;
    o[1] = rank / (R * S);
    o[2] = (rank / S) % R;
    o[3] = rank % S;
    found[g] = hit;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) allocate_job_kernel(
    const T* __restrict__ mem_in, const bool* __restrict__ other_free,
    const int* __restrict__ cfg, const bool* __restrict__ f_valid,
    const int* __restrict__ f_split, const T* __restrict__ f_mem,
    const int* __restrict__ f_parents, const int* __restrict__ f_sub_fwd,
    const int* __restrict__ f_sub_bwd, const int* __restrict__ row_table,
    const int* __restrict__ anchor_cells,
    const bool* __restrict__ anchor_span, int* __restrict__ ots,
    T* __restrict__ mem_out, bool* __restrict__ ok_out, int n_srv, int n,
    int n_fwd, int n_par, int smax, int n_rows, int row_cols,
    int max_cells) {
  extern __shared__ long long smem_raw[];
  T* s_mem = reinterpret_cast<T*>(smem_raw);                        // [n_srv]
  int* s_op_servers = reinterpret_cast<int*>(s_mem + n_srv);        // [F*Smax]
  int* s_op_count = s_op_servers + n_fwd * smax;                    // [F]
  int* s_servers = s_op_count + n_fwd;                              // [Smax]
  unsigned char* s_free =
      reinterpret_cast<unsigned char*>(s_servers + smax);           // [n_srv]
  unsigned char* s_other = s_free + n_srv;                          // [n_srv]
  __shared__ int s_best, s_colo, s_ok;

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = cfg[lane];
  for (int s = tid; s < n_srv; s += blockDim.x) {
    s_mem[s] = mem_in[static_cast<size_t>(lane) * n_srv + s];
    s_other[s] = other_free[static_cast<size_t>(lane) * n_srv + s];
  }
  int* lane_ots = ots + static_cast<size_t>(lane) * n;
  for (int i = tid; i < n; i += blockDim.x) lane_ots[i] = -1;
  for (int i = tid; i < n_fwd * smax; i += blockDim.x) s_op_servers[i] = -1;
  for (int i = tid; i < n_fwd; i += blockDim.x) s_op_count[i] = 0;
  if (tid == 0) s_ok = 1;
  __syncthreads();

  const size_t crow = static_cast<size_t>(c) * n_fwd;
  for (int f = 0; f < n_fwd; ++f) {
    const bool valid = f_valid[crow + f];
    const int split = f_split[crow + f];
    const T per_mem = f_mem[crow + f];
    // the free mask of this op, and parent co-location (thread 0)
    for (int s = tid; s < n_srv; s += blockDim.x) {
      s_free[s] = s_other[s] && s_mem[s] >= per_mem;
    }
    if (tid == 0) {
      s_best = INT_MAX;
      int colo = 0;
      for (int pi = 0; pi < n_par; ++pi) {
        const int p = f_parents[(crow + f) * n_par + pi];
        const int pc = p > 0 ? p : 0;
        const int cnt = s_op_count[pc];
        bool mem_ok = true;
        for (int k = 0; k < smax; ++k) {
          const int srv = s_op_servers[pc * smax + k];
          if (k < cnt && !(s_mem[srv > 0 ? srv : 0] >= per_mem)) {
            mem_ok = false;
          }
        }
        const bool okp = p >= 0 && cnt > 0 && cnt == split && mem_ok;
        if (okp && !colo) {
          for (int k = 0; k < smax; ++k) {
            s_servers[k] = s_op_servers[pc * smax + k];
          }
        }
        colo |= okp;
      }
      s_colo = colo;
    }
    __syncthreads();

    // the first fit over the split's shape row
    const int r = min(max(split, 0), n_rows - 1);
    const int* row = row_table + static_cast<size_t>(r) * row_cols;
    for (int idx = tid; idx < row_cols * n_srv; idx += blockDim.x) {
      const int p = idx / n_srv;
      const int a = idx - p * n_srv;
      const int sid = row[p];
      if (sid < 0) continue;
      const size_t at = static_cast<size_t>(sid) * n_srv + a;
      if (!anchor_span[at]) continue;
      const int* cells = anchor_cells + at * max_cells;
      bool ok = true;
      for (int t = 0; ok && t < max_cells; ++t) {
        const int cell = cells[t];
        if (cell == -2) continue;  // past the shape's cell count
        ok = cell >= 0 && s_free[cell];
      }
      if (ok) atomicMin(&s_best, idx);
    }
    __syncthreads();

    // the commit (thread 0: at most Smax servers)
    if (tid == 0) {
      const bool colo = s_colo;
      const bool block_found = s_best != INT_MAX;
      if (!colo && block_found) {
        const int p = s_best / n_srv;
        const int a = s_best - p * n_srv;
        const int* cells =
            anchor_cells + (static_cast<size_t>(row[p]) * n_srv + a) *
                               max_cells;
        for (int k = 0; k < smax; ++k) {
          s_servers[k] = k < max_cells ? cells[k] : 0;
        }
      }
      const bool placed = colo || block_found;
      for (int k = 0; k < smax; ++k) {
        const int srv = s_servers[k];
        if (!(k < split && placed && valid && srv >= 0)) continue;
        s_mem[srv] = s_mem[srv] - per_mem;
        const int fwd = f_sub_fwd[(crow + f) * smax + k];
        const int bwd = f_sub_bwd[(crow + f) * smax + k];
        if (fwd >= 0) lane_ots[fwd] = srv;
        if (bwd >= 0) lane_ots[bwd] = srv;
      }
      if (valid && placed) {
        for (int k = 0; k < smax; ++k) {
          s_op_servers[f * smax + k] = s_servers[k];
        }
        s_op_count[f] = split;
      }
      if (!(placed || !valid)) s_ok = 0;
    }
    __syncthreads();
  }
  for (int s = tid; s < n_srv; s += blockDim.x) {
    mem_out[static_cast<size_t>(lane) * n_srv + s] = s_mem[s];
  }
  if (tid == 0) ok_out[lane] = s_ok;
}

template <typename T>
int launch_allocate(const void* const* p, int lanes, int n_srv, int n,
                    int n_fwd, int n_par, int smax, int n_rows, int row_cols,
                    int n_shapes, int max_cells, cudaStream_t stream) {
  (void)n_shapes;
  const size_t smem = static_cast<size_t>(n_srv) * sizeof(T) +
                      static_cast<size_t>(n_fwd * smax + n_fwd + smax) *
                          sizeof(int) +
                      2 * static_cast<size_t>(n_srv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        allocate_job_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  allocate_job_kernel<T><<<lanes, kThreads, smem, stream>>>(
      static_cast<const T*>(p[0]), static_cast<const bool*>(p[1]),
      static_cast<const int*>(p[2]), static_cast<const bool*>(p[3]),
      static_cast<const int*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const int*>(p[6]), static_cast<const int*>(p[7]),
      static_cast<const int*>(p[8]), static_cast<const int*>(p[9]),
      static_cast<const int*>(p[10]), static_cast<const bool*>(p[11]),
      static_cast<int*>(const_cast<void*>(p[12])),
      static_cast<T*>(const_cast<void*>(p[13])),
      static_cast<bool*>(const_cast<void*>(p[14])), n_srv, n, n_fwd, n_par,
      smax, n_rows, row_cols, max_cells);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K22: free [G, C, R, S] bools, shapes [n_shapes, 3] int32, out [G, 4]
// int32 (shape, i, j, k), found [G] bools; meta shape (m0, m1, m2).
DDLS_EXPORT int ddls_first_fit_block(const void* free, const void* shapes,
                                     void* out, void* found, int grids,
                                     int C, int R, int S, int n_shapes,
                                     int m0, int m1, int m2, void* stream) {
  if (grids <= 0 || C < 1 || R < 1 || S < 1 || n_shapes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  first_fit_block_kernel<<<grids, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(free), static_cast<const int*>(shapes),
      static_cast<int*>(out), static_cast<bool*>(found), C, R, S, n_shapes,
      m0, m1, m2);
  return static_cast<int>(cudaGetLastError());
}

// K23: mem [B, n_srv] floats (is_f64 names the type), other_free [B, n_srv]
// bools, cfg [B] int32; the config tables f_valid [K, F], f_split [K, F],
// f_mem [K, F], f_parents [K, F, P], f_sub_fwd / f_sub_bwd [K, F, Smax];
// the shape tables row [n_rows, row_cols], anchor_cells [n_shapes, n_srv,
// max_cells], anchor_span [n_shapes, n_srv]; outputs ots [B, N] int32,
// new_mem [B, n_srv], ok [B] bools.
DDLS_EXPORT int ddls_allocate_job(
    const void* mem, const void* other_free, const void* cfg,
    const void* f_valid, const void* f_split, const void* f_mem,
    const void* f_parents, const void* f_sub_fwd, const void* f_sub_bwd,
    const void* row, const void* anchor_cells, const void* anchor_span,
    void* ots, void* new_mem, void* ok, int lanes, int n_srv, int n,
    int n_fwd, int n_par, int smax, int n_rows, int row_cols, int n_shapes,
    int max_cells, int is_f64, void* stream) {
  const void* p[15] = {mem, other_free, cfg, f_valid, f_split, f_mem,
                       f_parents, f_sub_fwd, f_sub_bwd, row, anchor_cells,
                       anchor_span, ots, new_mem, ok};
  if (lanes <= 0 || n_srv < 1 || n_fwd < 0 || n_par < 1 || smax < 1 ||
      n_rows < 1 || row_cols < 1 || max_cells < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return launch_allocate<double>(p, lanes, n_srv, n, n_fwd, n_par, smax,
                                   n_rows, row_cols, n_shapes, max_cells, s);
  }
  return launch_allocate<float>(p, lanes, n_srv, n, n_fwd, n_par, smax,
                                n_rows, row_cols, n_shapes, max_cells, s);
}
