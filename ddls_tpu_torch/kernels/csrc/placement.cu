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
// a dummy slot N). With a state-lane index (state_lane[b], else b itself),
// row b places its job against that lane's memory and occupancy: in-kernel
// candidate pricing (jax_env.py:1085 price_all) evaluates every degree of
// a lane's queued job as its own row against the one live state.
//
// What bounds K22 on the H100: latency (one CTA a grid, one thread a
// (shape, anchor) pair, a block-wide integer atomicMin; no float atomics).
//
// What bounds K23: latency. A row is a chain of up to 15 dependent op steps
// (the config's valid forward ops), each a few hundred (position, anchor)
// tests; its bytes (~3 KB of config rows and state, 480 + 32 outputs) and
// operations (~10^4) would take the card well under a microsecond. The first
// design (one 256-thread CTA a row) lost its time to (a) each anchor test
// walking up to 16 anchor_cells entries in global memory, every load waiting on
// the one before; (b) thread 0 running the parent co-location and the commit
// alone, from global memory; (c) three CTA barriers a step; (d) all F slots
// scanned, the invalid tail too; (e) one CTA a row, 8 or 72 of 132 SMs busy.
// This design: one warp a row, kAllocRows = 4 rows a CTA (one warp for each of
// the SM's four schedulers, so the rows of a CTA never wait on each other for
// issue, and the shape tables are staged once for four rows). Each CTA stages
// the shape tables with cp.async: the row table, the occupancy bitmasks
// anchor_bits (bit s of an anchor's words set for each server s of its block,
// built on the host) and anchor_ok (in span, no cell off the ramp).
// anchor_cells stays in global memory: the commit reads the chosen block's
// servers from it, one independent load a lane. Each warp stages its row's
// config rows, its state lane's memory and occupancy, and keeps its ots row,
// the placed ops' servers and counts in shared memory; after one CTA barrier
// only __syncwarp and warp votes follow. Per op: the free mask is W =
// ceil(n_srv / 32) ballots of "no other job and enough memory" (word 0 kept in
// a register); parent co-location takes each parent in order, lanes k < count
// test their server's memory and __all_sync decides; the first fit has each
// lane test its anchors as anchor_ok && (anchor_bits & ~free) == 0 at every
// position of the split's shape row (the loads independent, so they overlap),
// one warp OR of the per-lane position masks gives the first position where any
// anchor fits and a ballot there the lowest anchor: the reference's (position,
// anchor) order. The commit has lanes k < split subtract the op's share from
// their own server once and write the sub-ops' servers (the servers of one
// block, or one parent, are distinct, so no two lanes write one server). A
// row's loop runs over its config's n_fwd valid ops only: stack_config_tables
// puts them first, and an invalid op would commit nothing and never clear ok.
// Shared memory on the shipped 32-server surface: 3.0 KB (10^3 bytes) of shape
// tables and 5.3 KB a row in float32 (5.5 KB in float64), 24.2 KB a CTA (25.0
// KB in float64). The bitmasks grow with the square of the server count
// (355,888 bytes a CTA at 256 servers in float32, past the H100's 232,448),
// so the C entry chooses one of two forms from the sizes (alloc_plan):
// "shared" (everything staged, kAllocRows rows a CTA) where it fits; else
// "global_tables": anchor_bits and anchor_ok read from global memory
// (read-only loads that stay in L2: ~0.35 MB at 256 servers), the row table
// and the rows' parts still staged, as many rows a CTA (4 down to 1) as
// their parts fit. The tests and the first fit's order are the same in
// both forms, so are the bits. Built with -fmad=false
// (kernels/__init__.py EXTRA_FLAGS): nothing here multiplies, and nothing
// may be fused.
#include <climits>
#include <type_traits>

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

// K23: up to kAllocRows rows a CTA, one warp each
constexpr int kAllocRows = 4;
constexpr int kAllocThreads = kAllocRows * ddls::kWarpSize;

// K23's forms: where the shape tables live (device_env.ALLOC_FORMS)
constexpr int kTablesShared = 0;  // row table, anchor_bits, anchor_ok staged
constexpr int kTablesGlobal = 1;  // anchor_bits, anchor_ok from global

inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Byte offsets into K23's dynamic shared memory, each a multiple of 16:
// the CTA's staged shape tables, then `rows` copies of a row's part
// (offsets from its own base); the form and rows a CTA.
struct AllocLayout {
  size_t row, bits, ok, cta;
  size_t mem, other, freew, split, fmem, parents, sub_fwd, sub_bwd,
      op_servers, op_count, ots, per_row;
  size_t total;
  int form, rows;
};

template <typename T>
AllocLayout alloc_layout(int n_srv, int n, int n_fwd, int n_par, int smax,
                         int n_rows, int row_cols, int n_shapes, int form,
                         int rows) {
  AllocLayout L{};
  L.form = form;
  L.rows = rows;
  const size_t words = (n_srv + 31) / 32;
  const size_t anchors = static_cast<size_t>(n_shapes) * n_srv;
  size_t o = 0;
  L.row = o;
  o = align16(o + sizeof(int) * n_rows * row_cols);
  L.bits = o;
  if (form == kTablesShared) {
    o = align16(o + sizeof(unsigned) * anchors * words);
  }
  L.ok = o;
  if (form == kTablesShared) o = align16(o + anchors);
  L.cta = o;
  size_t w = 0;
  L.mem = w;
  w = align16(w + sizeof(T) * n_srv);
  L.other = w;
  w = align16(w + n_srv);
  L.freew = w;
  w = align16(w + sizeof(unsigned) * words);
  L.split = w;
  w = align16(w + sizeof(int) * n_fwd);
  L.fmem = w;
  w = align16(w + sizeof(T) * n_fwd);
  L.parents = w;
  w = align16(w + sizeof(int) * n_fwd * n_par);
  L.sub_fwd = w;
  w = align16(w + sizeof(int) * n_fwd * smax);
  L.sub_bwd = w;
  w = align16(w + sizeof(int) * n_fwd * smax);
  L.op_servers = w;
  w = align16(w + sizeof(int) * n_fwd * smax);
  L.op_count = w;
  w = align16(w + sizeof(int) * n_fwd);
  L.ots = w;
  w = align16(w + sizeof(int) * n);
  L.per_row = w;
  L.total = L.cta + static_cast<size_t>(rows) * w;
  return L;
}

// The form of a launch within `optin` bytes a CTA: shared at kAllocRows
// rows where it fits (and `force` is 0), else the tables from global
// memory at the most rows a CTA that fit. rows == 0: no form fits.
template <typename T>
AllocLayout alloc_plan(int n_srv, int n, int n_fwd, int n_par, int smax,
                       int n_rows, int row_cols, int n_shapes, size_t optin,
                       int force) {
  for (int form = force; form <= kTablesGlobal; ++form) {
    const int most = form == kTablesShared ? kAllocRows : 1;
    for (int rows = kAllocRows; rows >= most; --rows) {
      const AllocLayout L = alloc_layout<T>(n_srv, n, n_fwd, n_par, smax,
                                            n_rows, row_cols, n_shapes,
                                            form, rows);
      if (L.total <= optin) return L;
    }
  }
  AllocLayout none{};
  return none;
}

// `bytes` bytes from global `src` into shared `dst` by threads `tid` of
// `nthr`: 16-byte cp.async where both addresses allow it, else 4-byte,
// and plain copies for what is left. The caller commits, waits and syncs.
__device__ void stage(void* dst, const void* src, size_t bytes, int tid,
                      int nthr) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const uintptr_t both =
      reinterpret_cast<uintptr_t>(d) | reinterpret_cast<uintptr_t>(s);
  size_t body = 0;
  if (both % 16 == 0) {
    body = bytes & ~static_cast<size_t>(15);
    for (size_t i = 16 * static_cast<size_t>(tid); i < body;
         i += 16 * static_cast<size_t>(nthr)) {
      ddls::cp_async16(d + i, s + i);
    }
  } else if (both % 4 == 0) {
    body = bytes & ~static_cast<size_t>(3);
    for (size_t i = 4 * static_cast<size_t>(tid); i < body;
         i += 4 * static_cast<size_t>(nthr)) {
      ddls::cp_async4(d + i, s + i);
    }
  }
  for (size_t i = body + tid; i < bytes; i += nthr) d[i] = s[i];
}

// *p, through the read-only path where p is in global memory
template <bool kGlobal, typename U>
__device__ __forceinline__ U ld(const U* p) {
  if constexpr (kGlobal) {
    return __ldg(p);
  } else {
    return *p;
  }
}

// Whether shape `sid`'s block at anchor `a` lies on free servers: the
// anchor is ok and none of its servers' bits is missing from the free
// mask (word 0 `free0`, the others `freew`). False for sid < 0 or an
// anchor past the grid. kGlobal: the tables are global memory's.
template <bool kGlobal>
__device__ __forceinline__ bool fits_free(int sid, int a, int n_srv,
                                          int words,
                                          const unsigned char* s_ok,
                                          const unsigned* s_bits,
                                          unsigned free0,
                                          const unsigned* freew) {
  if (sid < 0 || a >= n_srv) return false;
  const int at = sid * n_srv + a;
  bool fits = ld<kGlobal>(s_ok + at) != 0 &&
              (ld<kGlobal>(s_bits + at * words) & ~free0) == 0u;
  for (int w = 1; fits && w < words; ++w) {
    fits = (ld<kGlobal>(s_bits + at * words + w) & ~freew[w]) == 0u;
  }
  return fits;
}

template <typename T, int kForm>
__global__ void __launch_bounds__(kAllocThreads) allocate_job_kernel(
    const T* __restrict__ mem_in, const bool* __restrict__ other_free,
    const int* __restrict__ cfg, const int* __restrict__ state_lane,
    const int* __restrict__ f_count, const int* __restrict__ f_split, const T* __restrict__ f_mem,
    const int* __restrict__ f_parents, const int* __restrict__ f_sub_fwd,
    const int* __restrict__ f_sub_bwd, const int* __restrict__ row_table,
    const int* __restrict__ anchor_cells,
    const unsigned* __restrict__ anchor_bits,
    const bool* __restrict__ anchor_ok, int* __restrict__ ots,
    T* __restrict__ mem_out, bool* __restrict__ ok_out, AllocLayout L,
    int lanes, int n_srv, int n, int n_fwd, int n_par, int smax,
    int n_rows, int row_cols, int n_shapes, int max_cells) {
  constexpr bool kGlobalTables = kForm == kTablesGlobal;
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (n_srv + 31) / 32;
  const size_t anchors = static_cast<size_t>(n_shapes) * n_srv;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int warp = tid / ddls::kWarpSize;
  const int lane = tid % ddls::kWarpSize;

  // the CTA's shape tables: staged, or global memory's (the form's)
  const int* s_row = reinterpret_cast<const int*>(smem + L.row);
  const unsigned* s_bits =
      kGlobalTables ? anchor_bits
                    : reinterpret_cast<const unsigned*>(smem + L.bits);
  const unsigned char* s_ok =
      kGlobalTables ? reinterpret_cast<const unsigned char*>(anchor_ok)
                    : smem + L.ok;
  stage(smem + L.row, row_table, sizeof(int) * n_rows * row_cols, tid,
        nthr);
  if (!kGlobalTables) {
    stage(smem + L.bits, anchor_bits, sizeof(unsigned) * anchors * words,
          tid, nthr);
    stage(smem + L.ok, anchor_ok, anchors, tid, nthr);
  }

  // this warp's row, its state lane and its config rows over the valid
  // prefix
  const int b = blockIdx.x * L.rows + warp;
  unsigned char* base = smem + L.cta + warp * L.per_row;
  T* s_mem = reinterpret_cast<T*>(base + L.mem);
  const unsigned char* s_other = base + L.other;
  unsigned* s_freew = reinterpret_cast<unsigned*>(base + L.freew);
  const int* s_split = reinterpret_cast<const int*>(base + L.split);
  const T* s_fmem = reinterpret_cast<const T*>(base + L.fmem);
  const int* s_parents = reinterpret_cast<const int*>(base + L.parents);
  const int* s_sub_fwd = reinterpret_cast<const int*>(base + L.sub_fwd);
  const int* s_sub_bwd = reinterpret_cast<const int*>(base + L.sub_bwd);
  int* s_op_servers = reinterpret_cast<int*>(base + L.op_servers);
  int* s_op_count = reinterpret_cast<int*>(base + L.op_count);
  int* s_ots = reinterpret_cast<int*>(base + L.ots);
  int nf = 0;
  if (b < lanes) {
    // all F slots are staged (the valid count's load is not waited for)
    const int c = cfg[b];
    const size_t src =
        static_cast<size_t>(state_lane != nullptr ? state_lane[b] : b) *
        n_srv;
    const size_t crow = static_cast<size_t>(c) * n_fwd;
    const int ws = ddls::kWarpSize;
    stage(base + L.mem, mem_in + src, sizeof(T) * n_srv, lane, ws);
    stage(base + L.other, other_free + src, n_srv, lane, ws);
    stage(base + L.split, f_split + crow, sizeof(int) * n_fwd, lane, ws);
    stage(base + L.fmem, f_mem + crow, sizeof(T) * n_fwd, lane, ws);
    stage(base + L.parents, f_parents + crow * n_par,
          sizeof(int) * n_fwd * n_par, lane, ws);
    stage(base + L.sub_fwd, f_sub_fwd + crow * smax,
          sizeof(int) * n_fwd * smax, lane, ws);
    stage(base + L.sub_bwd, f_sub_bwd + crow * smax,
          sizeof(int) * n_fwd * smax, lane, ws);
    for (int i = lane; i < n; i += ws) s_ots[i] = -1;
    for (int i = lane; i < n_fwd * smax; i += ws) s_op_servers[i] = -1;
    for (int i = lane; i < n_fwd; i += ws) s_op_count[i] = 0;
    nf = min(f_count[c], n_fwd);
  }
  ddls::cp_async_commit();
  ddls::cp_async_wait_group<0>();
  __syncthreads();
  if (b >= lanes) return;  // warp-uniform; no CTA barrier follows

  // the ops f < nf are the config's valid ones (a prefix of the slots)
  bool ok = true;
  for (int f = 0; f < nf; ++f) {
    const int split = s_split[f];
    const T per_mem = s_fmem[f];
    // the free mask (no other job, enough memory): word 0 in a register,
    // the others in shared memory
    unsigned free0 = 0u;
    for (int j = 0; j < words; ++j) {
      const int s = j * ddls::kWarpSize + lane;
      const unsigned m = __ballot_sync(
          ddls::kFullMask, s < n_srv && s_other[s] && s_mem[s] >= per_mem);
      if (j == 0) {
        free0 = m;
      } else if (lane == 0) {
        s_freew[j] = m;
      }
    }
    if (words > 1) __syncwarp();
    // parent co-location: the first parent whose server count equals the
    // split and whose servers all have room
    int colo = -1;
    for (int pi = 0; pi < n_par; ++pi) {
      const int p = s_parents[f * n_par + pi];
      const int pc = p > 0 ? p : 0;
      const int cnt = s_op_count[pc];
      if (p < 0 || cnt <= 0 || cnt != split) continue;  // warp-uniform
      bool room = true;
      for (int k = lane; k < cnt; k += ddls::kWarpSize) {
        room = room && s_mem[s_op_servers[pc * smax + k]] >= per_mem;
      }
      if (__all_sync(ddls::kFullMask, room)) {
        colo = pc;
        break;
      }
    }
    // the first fit over the split's shape row: positions in order, then
    // the lowest anchor. Each lane tests its anchors at every position of
    // a chunk of 32 (the loads overlap), a warp OR finds the first
    // position where any fits, and a ballot there the lowest anchor.
    const int* row_ids = s_row + min(max(split, 0), n_rows - 1) * row_cols;
    int pick_sid = -1, pick_a = -1;
    for (int p0 = 0; colo < 0 && pick_a < 0 && p0 < row_cols;
         p0 += ddls::kWarpSize) {
      const int n_pos = min(ddls::kWarpSize, row_cols - p0);
      unsigned any = 0u;
      for (int j = 0; j < words; ++j) {
        const int a = j * ddls::kWarpSize + lane;
        unsigned mine = 0u;
#pragma unroll 4
        for (int q = 0; q < n_pos; ++q) {
          if (fits_free<kGlobalTables>(row_ids[p0 + q], a, n_srv, words,
                                       s_ok, s_bits, free0, s_freew)) {
            mine |= 1u << q;
          }
        }
        any |= __reduce_or_sync(ddls::kFullMask, mine);
      }
      if (any == 0u) continue;
      const int sid = row_ids[p0 + __ffs(any) - 1];
      for (int j = 0; j < words; ++j) {
        const int a = j * ddls::kWarpSize + lane;
        const unsigned hit = __ballot_sync(
            ddls::kFullMask,
            fits_free<kGlobalTables>(sid, a, n_srv, words, s_ok, s_bits,
                                     free0, s_freew));
        if (hit != 0u) {
          pick_sid = sid;
          pick_a = j * ddls::kWarpSize + __ffs(hit) - 1;
          break;
        }
      }
    }
    // the commit: lane k takes the block's k-th server
    const bool placed = colo >= 0 || pick_a >= 0;
    if (placed) {
      const int* cells =
          colo >= 0 ? s_op_servers + colo * smax
                    : anchor_cells + (static_cast<size_t>(pick_sid) * n_srv +
                                      pick_a) * max_cells;
      const int n_cells = colo >= 0 ? smax : max_cells;
      for (int k = lane; k < smax; k += ddls::kWarpSize) {
        const int srv = k < n_cells ? cells[k] : 0;
        if (k < split && srv >= 0) {
          s_mem[srv] = s_mem[srv] - per_mem;
          const int fwd = s_sub_fwd[f * smax + k];
          const int bwd = s_sub_bwd[f * smax + k];
          if (fwd >= 0) s_ots[fwd] = srv;
          if (bwd >= 0) s_ots[bwd] = srv;
        }
        s_op_servers[f * smax + k] = srv;
      }
      if (lane == 0) s_op_count[f] = split;
    }
    ok = ok && placed;
    __syncwarp();
  }
  for (int s = lane; s < n_srv; s += ddls::kWarpSize) {
    mem_out[static_cast<size_t>(b) * n_srv + s] = s_mem[s];
  }
  for (int i = lane; i < n; i += ddls::kWarpSize) {
    ots[static_cast<size_t>(b) * n + i] = s_ots[i];
  }
  if (lane == 0) ok_out[b] = ok;
}

// The shared memory a CTA may take on this device (the opt-in maximum),
// asked once.
int smem_optin(int* bytes) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &cached, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *bytes = cached;
  return 0;
}

template <typename T, int kForm>
int launch_form(const void* const* p, const AllocLayout& L, int lanes,
                int n_srv, int n, int n_fwd, int n_par, int smax, int n_rows,
                int row_cols, int n_shapes, int max_cells,
                cudaStream_t stream) {
  // raise the dynamic shared-memory limit to the largest size yet (the
  // first launch, before any CUDA-graph capture, sets it)
  static size_t configured = 48 * 1024;
  if (L.total > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        allocate_job_kernel<T, kForm>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = L.total;
  }
  allocate_job_kernel<T, kForm>
      <<<ddls::grid_for(lanes, L.rows), L.rows * ddls::kWarpSize, L.total,
         stream>>>(
          static_cast<const T*>(p[0]), static_cast<const bool*>(p[1]),
          static_cast<const int*>(p[2]), static_cast<const int*>(p[3]),
          static_cast<const int*>(p[4]), static_cast<const int*>(p[5]),
          static_cast<const T*>(p[6]), static_cast<const int*>(p[7]),
          static_cast<const int*>(p[8]), static_cast<const int*>(p[9]),
          static_cast<const int*>(p[10]), static_cast<const int*>(p[11]),
          static_cast<const unsigned*>(p[12]),
          static_cast<const bool*>(p[13]),
          static_cast<int*>(const_cast<void*>(p[14])),
          static_cast<T*>(const_cast<void*>(p[15])),
          static_cast<bool*>(const_cast<void*>(p[16])), L, lanes, n_srv, n,
          n_fwd, n_par, smax, n_rows, row_cols, n_shapes, max_cells);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_allocate(const void* const* p, int lanes, int n_srv, int n,
                    int n_fwd, int n_par, int smax, int n_rows, int row_cols,
                    int n_shapes, int max_cells, int force,
                    cudaStream_t stream) {
  int optin = 0;
  const int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const AllocLayout L = alloc_plan<T>(n_srv, n, n_fwd, n_par, smax, n_rows,
                                      row_cols, n_shapes,
                                      static_cast<size_t>(optin), force);
  if (L.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto go = [&](auto kernel_form) {
    return launch_form<T, decltype(kernel_form)::value>(
        p, L, lanes, n_srv, n, n_fwd, n_par, smax, n_rows, row_cols,
        n_shapes, max_cells, stream);
  };
  return L.form == kTablesShared
             ? go(std::integral_constant<int, kTablesShared>{})
             : go(std::integral_constant<int, kTablesGlobal>{});
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

// K23: mem [S, n_srv] floats (is_f64 names the type), other_free [S, n_srv]
// bools, cfg [B] int32, state_lane [B] int32 (each row's state lane, < S;
// null: row b reads lane b, S = B); the config tables n_fwd [K] (the
// valid forward ops: the first n_fwd of the F slots, as
// stack_config_tables builds them), f_split [K, F], f_mem [K, F],
// f_parents [K, F, P], f_sub_fwd / f_sub_bwd [K, F, Smax]; the shape
// tables row [n_rows, row_cols], anchor_cells [n_shapes, n_srv,
// max_cells], anchor_bits [n_shapes, n_srv, ceil(n_srv / 32)] 32-bit
// words, anchor_ok [n_shapes, n_srv] bools; outputs ots [B, N] int32,
// new_mem [B, n_srv], ok [B] bools.
DDLS_EXPORT int ddls_allocate_job(
    const void* mem, const void* other_free, const void* cfg,
    const void* state_lane, const void* n_fwd_of, const void* f_split,
    const void* f_mem, const void* f_parents, const void* f_sub_fwd,
    const void* f_sub_bwd, const void* row, const void* anchor_cells,
    const void* anchor_bits, const void* anchor_ok, void* ots,
    void* new_mem, void* ok, int lanes, int n_srv, int n, int n_fwd,
    int n_par, int smax, int n_rows, int row_cols, int n_shapes,
    int max_cells, int is_f64, int force, void* stream) {
  const void* p[17] = {mem, other_free, cfg, state_lane, n_fwd_of, f_split,
                       f_mem, f_parents, f_sub_fwd, f_sub_bwd, row,
                       anchor_cells, anchor_bits, anchor_ok, ots, new_mem,
                       ok};
  if (lanes <= 0 || n_srv < 1 || n_fwd < 0 || n_par < 1 || smax < 1 ||
      n_rows < 1 || row_cols < 1 || n_shapes < 1 || max_cells < 1 ||
      force < kTablesShared || force > kTablesGlobal) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return launch_allocate<double>(p, lanes, n_srv, n, n_fwd, n_par, smax,
                                   n_rows, row_cols, n_shapes, max_cells,
                                   force, s);
  }
  return launch_allocate<float>(p, lanes, n_srv, n, n_fwd, n_par, smax,
                                n_rows, row_cols, n_shapes, max_cells, force,
                                s);
}

// K23's plan for these sizes on the current device (alloc_plan; `force`
// as ddls_allocate_job's), packed into one int: (shared bytes a CTA << 5)
// | (rows a CTA << 2) | form; cudaErrorInvalidValue where no form fits.
// Launches nothing.
DDLS_EXPORT int ddls_allocate_job_smem(int n_srv, int n, int n_fwd,
                                       int n_par, int smax, int n_rows,
                                       int row_cols, int n_shapes,
                                       int is_f64, int force, int* out) {
  int optin = 0;
  const int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const size_t budget = static_cast<size_t>(optin);
  const AllocLayout L =
      is_f64 ? alloc_plan<double>(n_srv, n, n_fwd, n_par, smax, n_rows,
                                  row_cols, n_shapes, budget, force)
             : alloc_plan<float>(n_srv, n, n_fwd, n_par, smax, n_rows,
                                 row_cols, n_shapes, budget, force);
  if (L.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  *out = static_cast<int>(L.total << 5) | (L.rows << 2) | L.form;
  return 0;
}

// The shared memory a CTA may take on the current device (the opt-in
// maximum), in bytes. Launches nothing.
DDLS_EXPORT int ddls_smem_optin(int* out) { return smem_optin(out); }
