"""Masked segment reductions over padded edge lists, in PyTorch.

Counterpart of ``ddls_tpu/ops/segment.py``. The three JAX functions keep
their signatures and arithmetic as plain PyTorch (``masked_segment_sum``,
``masked_segment_mean`` with ``extra``, ``masked_mean``). The policy's
forward reaches two kernels through the wrappers below, and its backward
three more:

* ``csr_segment_mean`` (K2) takes the destination-sorted CSR that
  ``build_csr`` makes on the host at batch-assembly time, and sums each
  node's in-edges in ascending edge id with no atomics — the same bits on
  every run, so batching can never change an answer; its backward is
  ``csr_segment_mean_bwd`` (K6);
* ``masked_mean_pool_concat`` (K3) pools each graph's node embeddings and
  writes them beside the graph embedding; its backward is
  ``masked_mean_pool_concat_bwd`` (K6);
* ``csr_segment_sum`` (K6) folds per-edge rows into nodes along the
  SOURCE-sorted CSR (``build_csr`` of the edge sources): the transpose of
  the message gather ``node_int[src]``, again in ascending edge id.

Each wrapper takes its plain version for tensors on the CPU and launches
its CUDA kernel for tensors on the card (``kernels.launch_counts`` counts
the launches). On the card the two forward wrappers are
``torch.autograd.Function``s whose backward is the K6 kernel; on the CPU
autograd differentiates the plain versions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels


def masked_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       mask: torch.Tensor, num_segments: int
                       ) -> torch.Tensor:
    """Sum ``data[e]`` [E, F] into ``out[segment_ids[e]]`` for the edges
    where ``mask`` [E] (bool) is True. Returns [num_segments, F]."""
    data = torch.where(mask[:, None], data, torch.zeros_like(data))
    out = data.new_zeros((num_segments, data.shape[1]))
    return out.index_add_(0, segment_ids.long(), data)


def masked_segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                        mask: torch.Tensor, num_segments: int,
                        extra: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Mean of the unmasked incoming edge values per segment, averaged
    together with one ``extra`` [num_segments, F] value per segment when
    given (the GNN's self-message). Segments with nothing to average
    return 0."""
    totals = masked_segment_sum(data, segment_ids, mask, num_segments)
    counts = masked_segment_sum(mask.to(data.dtype)[:, None], segment_ids,
                                mask, num_segments)[:, 0]
    if extra is not None:
        totals = totals + extra
        counts = counts + 1.0
    return totals / torch.clamp(counts, min=1.0)[:, None]


def masked_mean(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the unmasked rows of ``data`` [N, F]; 0 if all masked."""
    weights = mask.to(data.dtype)
    total = torch.sum(data * weights[:, None], dim=0)
    count = torch.clamp(torch.sum(weights), min=1.0)
    return total / count


def build_csr(dst: np.ndarray, edge_mask: np.ndarray, num_segments: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Destination-sorted CSR of the unmasked edges, on the host.

    Returns ``(row_ptr [num_segments + 1], col [E])``, both int32: the
    unmasked edges into node ``v`` are ``col[row_ptr[v]:row_ptr[v+1]]``,
    in ascending edge id (a stable sort by destination). ``col`` keeps the
    edge list's length so its shape is fixed; entries past
    ``row_ptr[-1]`` are 0 and never read. Masked edges are dropped, so
    what their destination holds (padding points at node 0) never matters.
    Raises if an unmasked edge's destination lies outside the segments."""
    dst = np.asarray(dst).reshape(-1)
    edge_mask = np.asarray(edge_mask, dtype=bool).reshape(-1)
    if dst.shape != edge_mask.shape:
        raise ValueError(f"dst {dst.shape} and edge_mask "
                         f"{edge_mask.shape} differ in shape")
    ids = np.flatnonzero(edge_mask)
    real = dst[ids].astype(np.int64)
    if real.size and (real.min() < 0 or real.max() >= num_segments):
        raise ValueError(f"edge destinations must lie in [0, "
                         f"{num_segments}), got [{real.min()}, "
                         f"{real.max()}]")
    order = np.argsort(real, kind="stable")
    col = np.zeros(dst.shape[0], np.int32)
    col[:ids.size] = ids[order]
    row_ptr = np.zeros(num_segments + 1, np.int32)
    np.cumsum(np.bincount(real, minlength=num_segments), out=row_ptr[1:])
    return row_ptr, col


# ------------------------------------------------------------ K2: CSR mean
def csr_segment_mean_plain(msg: torch.Tensor, self_msg: torch.Tensor,
                           row_ptr: torch.Tensor, col: torch.Tensor,
                           node_mask: torch.Tensor) -> torch.Tensor:
    """``out[v] = node_mask[v] * (sum_{e in csr(v)} msg[e] + self_msg[v])
    / (deg(v) + 1)``, the edges added one at a time in ascending id, then
    the self term — the kernel's order and the reference's."""
    n_nodes, f = self_msg.shape
    begin = row_ptr[:-1].long()
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    # a zero row past the messages: slots beyond a node's degree add +0.0
    padded = torch.cat([msg, msg.new_zeros((1, f))])
    sentinel = msg.shape[0]
    acc = self_msg.new_zeros((n_nodes, f))
    max_deg = int(deg.max()) if n_nodes else 0
    for j in range(max_deg):
        take = j < deg
        pos = torch.clamp(begin + j, max=max(col.shape[0] - 1, 0))
        edge = torch.where(take, col.long()[pos],
                           torch.full_like(pos, sentinel))
        acc = acc + padded[edge]
    acc = acc + self_msg
    return acc / (deg + 1).to(acc.dtype)[:, None] * node_mask[:, None]


def csr_segment_mean(msg: torch.Tensor, self_msg: torch.Tensor,
                     row_ptr: torch.Tensor, col: torch.Tensor,
                     node_mask: torch.Tensor,
                     edge_dst: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: per-node mean over {self} U in-edges from a CSR (``build_csr``).

    ``msg`` [n_msg, F] and ``self_msg`` [V, F] float32, ``row_ptr`` [V+1]
    and ``col`` [>= nnz] int32, ``node_mask`` [V] float32 (1 keeps a node,
    0 zeroes it). Returns [V, F]. ``edge_dst`` [n_msg] int32 (each edge's
    destination, -1 for a padded edge) is what the card's backward needs:
    without it a CUDA result that requires grad raises."""
    if kernels.on_cpu(msg, self_msg, row_ptr, col, node_mask):
        return csr_segment_mean_plain(msg, self_msg, row_ptr, col, node_mask)
    if not kernels.needs_grad(msg, self_msg):
        return _csr_segment_mean_cuda(msg, self_msg, row_ptr, col, node_mask)
    if edge_dst is None:
        raise ValueError("csr_segment_mean's backward on the card needs "
                         "edge_dst (prepare_flat_batch gives it)")
    return _CsrSegmentMean.apply(msg, self_msg, row_ptr, col, node_mask,
                                 edge_dst)


def _csr_segment_mean_cuda(msg, self_msg, row_ptr, col, node_mask):
    n_nodes, f = self_msg.shape
    kernels.check_cuda("msg", msg, torch.float32)
    if msg.dim() != 2 or msg.shape[1] != f:
        raise ValueError(f"msg must be [n_msg, {f}], got "
                         f"{tuple(msg.shape)}")
    kernels.check_cuda("self_msg", self_msg, torch.float32)
    kernels.check_cuda("row_ptr", row_ptr, torch.int32, (n_nodes + 1,))
    kernels.check_cuda("col", col, torch.int32)
    kernels.check_cuda("node_mask", node_mask, torch.float32, (n_nodes,))
    out = torch.empty_like(self_msg)
    if n_nodes:
        kernels.launch("csr_segment_mean", msg.data_ptr(),
                       self_msg.data_ptr(), row_ptr.data_ptr(),
                       col.data_ptr(), node_mask.data_ptr(),
                       out.data_ptr(), n_nodes, f)
    return out


# K2's launch plan (kernels/csrc/csr_segment_mean.cu make_plan, which the
# C entry runs on its sizes; the card tests hold this mirror against the C
# entry's ``ddls_csr_segment_mean_plan``): CTAs of ``MEAN_THREADS``
# threads, a group of lanes a node
MEAN_THREADS = 128
_MEAN_MAX_CHUNKS = 8


class MeanPlan(NamedTuple):
    """One K2 launch: ``group`` lanes a node (a power of two up to 32),
    ``chunks`` floats a lane holds in registers during one walk of the
    node's CSR, ``blocks`` CTAs."""
    group: int
    chunks: int
    blocks: int

    def packed(self) -> int:
        """As ``ddls_csr_segment_mean_plan`` reports it."""
        return (self.blocks << 10) | (self.chunks << 6) | self.group


def csr_segment_mean_plan(f: int, n_nodes: int) -> MeanPlan:
    """K2's plan at width ``f`` over ``n_nodes`` nodes: a group of the
    least power of two lanes at least ``f``, at most 32; the least power
    of two chunks, at most 8, that covers the row with the group (past 8
    chunks of 32 lanes, a lane walks the CSR once for each 8)."""
    group = min(_WARP, 1 << max(f - 1, 0).bit_length())
    chunks = 1
    while chunks < _MEAN_MAX_CHUNKS and group * chunks < f:
        chunks *= 2
    return MeanPlan(group, chunks, -(-n_nodes // (MEAN_THREADS // group)))


class _CsrSegmentMean(torch.autograd.Function):
    """K2 forward, K6 ``csr_segment_mean_bwd`` backward."""

    @staticmethod
    def forward(ctx, msg, self_msg, row_ptr, col, node_mask, edge_dst):
        ctx.save_for_backward(row_ptr, edge_dst, node_mask)
        return _csr_segment_mean_cuda(msg, self_msg, row_ptr, col,
                                      node_mask)

    @staticmethod
    def backward(ctx, dout):
        row_ptr, edge_dst, node_mask = ctx.saved_tensors
        d_msg, d_self = csr_segment_mean_bwd(dout.contiguous(), row_ptr,
                                             edge_dst, node_mask)
        return d_msg, d_self, None, None, None, None


# ------------------------------------------------- K6's launch plans
# (kernels/csrc/segment_bwd.cu make_plan, which each C entry runs on its
# sizes and pointers; the card tests hold this mirror against the C
# entry's ``ddls_segment_bwd_plan``): CTAs of ``SEGMENT_THREADS`` threads;
# a lane of the mean or pooling backward moves 4 floats at once (16-byte
# loads and stores) where the width is a multiple of 4 and every pointer
# the entry moves in vectors is 16-byte aligned, else 1 (the same bits; a
# test forces 1 with ``kernels._forcing(<entry>, "scalar")``); the CSR
# sum takes a warp a node, by the float
SEGMENT_ENTRIES = ("csr_segment_mean_bwd", "csr_segment_sum",
                   "masked_mean_pool_concat_bwd")
SEGMENT_THREADS = 256
_WARP = 32
# rows a lane of the pooling backward writes, about; its warps a graph
_POOL_LANE_ROWS, _POOL_MAX_WARPS = 4, 8


class SegmentPlan(NamedTuple):
    """One K6 launch: ``vec`` floats a lane at once (1 or 4), ``group``
    lanes a row (the mean backward, the CSR sum: a power of two up to 32)
    or warps a graph (the pooling backward), ``blocks`` CTAs."""
    vec: int
    group: int
    blocks: int

    def packed(self) -> int:
        """As ``ddls_segment_bwd_plan`` reports it."""
        return (self.blocks << 9) | (self.group << 3) | self.vec


def segment_bwd_plan(name: str, f: int, rows: int, n_nodes: int = 0,
                     aligned: bool = True) -> SegmentPlan:
    """The plan of K6's entry ``name`` at width ``f`` over ``rows`` rows
    (E + V for ``csr_segment_mean_bwd``, V for ``csr_segment_sum``, B
    graphs of ``n_nodes`` nodes for ``masked_mean_pool_concat_bwd``),
    its vector pointers ``aligned`` or not: the CSR sum takes a warp a
    node, a float a lane; the mean backward a group of lanes a row, the
    least power of two at least the row's ``f / vec`` units (at most 32;
    a lane then takes every 32nd unit); the pooling backward takes warps a graph (each counts the
    graph's mask itself), enough that a lane writes about 4 rows (a pass of
    a warp covers ``32 // units`` rows, one where a row has more than 32
    units), at most 8."""
    if name == "csr_segment_sum":
        return SegmentPlan(1, _WARP, -(-rows // (SEGMENT_THREADS // _WARP)))
    vec = 4 if aligned and f % 4 == 0 else 1
    units = f // vec
    if name == "masked_mean_pool_concat_bwd":
        per = _WARP // units if units <= _WARP else 1
        group = min(_POOL_MAX_WARPS,
                    max(1, -(-n_nodes // (_POOL_LANE_ROWS * per))))
        return SegmentPlan(vec, group,
                           -(-rows * group // (SEGMENT_THREADS // _WARP)))
    group = min(_WARP, 1 << max(units - 1, 0).bit_length())
    return SegmentPlan(vec, group, -(-rows // (SEGMENT_THREADS // group)))


def _scalar(name: str) -> int:
    """The C entries' ``force``: 1 where a test forces the scalar form."""
    return int(kernels.forced(name) == "scalar")


def csr_segment_mean_bwd_plain(dout: torch.Tensor, row_ptr: torch.Tensor,
                               edge_dst: torch.Tensor,
                               node_mask: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``csr_segment_mean``: with ``d_tot[v] = (dout[v] *
    node_mask[v]) / (deg(v) + 1)`` (the reference's order: the mask is
    applied before the division), returns ``(d_msg [E, F], d_self [V, F])``
    with ``d_msg[e] = d_tot[edge_dst[e]]`` for a real edge and 0 where
    ``edge_dst[e] < 0``, and ``d_self = d_tot``."""
    deg = (row_ptr[1:] - row_ptr[:-1]).to(dout.dtype)
    d_tot = (dout * node_mask[:, None]) / (deg + 1)[:, None]
    real = edge_dst >= 0
    d_msg = torch.where(real[:, None],
                        d_tot[torch.clamp(edge_dst.long(), min=0)],
                        torch.zeros((), dtype=dout.dtype))
    return d_msg, d_tot


def csr_segment_mean_bwd(dout: torch.Tensor, row_ptr: torch.Tensor,
                         edge_dst: torch.Tensor, node_mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 ``csr_segment_mean_bwd``: ``(d_msg [E, F], d_self [V, F])`` from
    ``dout`` [V, F] float32, ``row_ptr`` [V+1] int32, ``edge_dst`` [E] int32
    (-1 for a padded edge), ``node_mask`` [V] float32."""
    if kernels.on_cpu(dout, row_ptr, edge_dst, node_mask):
        return csr_segment_mean_bwd_plain(dout, row_ptr, edge_dst, node_mask)
    kernels.check_cuda("dout", dout, torch.float32)
    if dout.dim() != 2:
        raise ValueError(f"dout must be [V, F], got {tuple(dout.shape)}")
    n_nodes, f = dout.shape
    kernels.check_cuda("row_ptr", row_ptr, torch.int32, (n_nodes + 1,))
    kernels.check_cuda("edge_dst", edge_dst, torch.int32)
    if edge_dst.dim() != 1:
        raise ValueError(f"edge_dst must be 1-D, got "
                         f"{tuple(edge_dst.shape)}")
    kernels.check_cuda("node_mask", node_mask, torch.float32, (n_nodes,))
    n_edges = edge_dst.shape[0]
    d_msg = dout.new_empty((n_edges, f))
    d_self = torch.empty_like(dout)
    if n_nodes:
        kernels.launch("csr_segment_mean_bwd", dout.data_ptr(),
                       row_ptr.data_ptr(), edge_dst.data_ptr(),
                       node_mask.data_ptr(), d_msg.data_ptr(),
                       d_self.data_ptr(), n_nodes, n_edges, f,
                       _scalar("csr_segment_mean_bwd"))
    return d_msg, d_self


# --------------------------------------- K6: sum along the source CSR
def csr_segment_sum_plain(g: torch.Tensor, row_ptr: torch.Tensor,
                          col: torch.Tensor) -> torch.Tensor:
    """``out[u] = sum_{e in csr(u)} g[e]``, the edges added one at a time in
    ascending id (the kernel's order). Returns [V, F]."""
    n_nodes = row_ptr.shape[0] - 1
    f = g.shape[1]
    begin = row_ptr[:-1].long()
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    padded = torch.cat([g, g.new_zeros((1, f))])
    sentinel = g.shape[0]
    acc = g.new_zeros((n_nodes, f))
    max_deg = int(deg.max()) if n_nodes else 0
    for j in range(max_deg):
        take = j < deg
        pos = torch.clamp(begin + j, max=max(col.shape[0] - 1, 0))
        edge = torch.where(take, col.long()[pos],
                           torch.full_like(pos, sentinel))
        acc = acc + padded[edge]
    return acc


def csr_segment_sum(g: torch.Tensor, row_ptr: torch.Tensor,
                    col: torch.Tensor) -> torch.Tensor:
    """K6 ``csr_segment_sum``: per-edge rows ``g`` [E, F] float32 summed into
    the ``row_ptr.shape[0] - 1`` nodes of a CSR (``row_ptr`` [V+1], ``col``
    [>= nnz], int32) in ascending edge id. With the CSR of the edge
    SOURCES it is the transpose of the gather ``a[src]``."""
    if kernels.on_cpu(g, row_ptr, col):
        return csr_segment_sum_plain(g, row_ptr, col)
    kernels.check_cuda("g", g, torch.float32)
    if g.dim() != 2:
        raise ValueError(f"g must be [E, F], got {tuple(g.shape)}")
    kernels.check_cuda("row_ptr", row_ptr, torch.int32)
    kernels.check_cuda("col", col, torch.int32)
    n_nodes, f = row_ptr.shape[0] - 1, g.shape[1]
    out = g.new_empty((n_nodes, f))
    if n_nodes and f:
        kernels.launch("csr_segment_sum", g.data_ptr(), row_ptr.data_ptr(),
                       col.data_ptr(), out.data_ptr(), n_nodes, f)
    return out


# ------------------------------------------------ K3: pool + concat readout
def masked_mean_pool_concat_plain(emb: torch.Tensor, node_mask: torch.Tensor,
                                  graph_emb: torch.Tensor) -> torch.Tensor:
    """``[masked_mean(emb[b], node_mask[b]), graph_emb[b]]`` per graph."""
    weights = node_mask.to(emb.dtype)
    total = torch.sum(emb * weights[..., None], dim=1)
    count = torch.clamp(torch.sum(weights, dim=1), min=1.0)
    return torch.cat([total / count[:, None], graph_emb], dim=1)


def masked_mean_pool_concat(emb: torch.Tensor, node_mask: torch.Tensor,
                            graph_emb: torch.Tensor) -> torch.Tensor:
    """K3: per-graph masked mean of ``emb`` [B, N, F] under ``node_mask``
    [B, N] (float32 0/1), concatenated with ``graph_emb`` [B, G]: returns
    [B, F + G] (counterpart of the vmapped ``masked_mean`` plus the concat
    in ``GNNPolicy.flat_batched``)."""
    if kernels.on_cpu(emb, node_mask, graph_emb):
        return masked_mean_pool_concat_plain(emb, node_mask, graph_emb)
    if not kernels.needs_grad(emb, graph_emb):
        return _masked_mean_pool_concat_cuda(emb, node_mask, graph_emb)
    return _MaskedMeanPoolConcat.apply(emb, node_mask, graph_emb)


def _masked_mean_pool_concat_cuda(emb, node_mask, graph_emb):
    kernels.check_cuda("emb", emb, torch.float32)
    if emb.dim() != 3:
        raise ValueError(f"emb must be [B, N, F], got {tuple(emb.shape)}")
    batch, n_nodes, f = emb.shape
    if not (batch and n_nodes and 0 < f <= 256):
        raise ValueError(f"masked_mean_pool_concat takes B, N >= 1 and "
                         f"1 <= F <= 256, got {tuple(emb.shape)}")
    kernels.check_cuda("node_mask", node_mask, torch.float32,
                       (batch, n_nodes))
    kernels.check_cuda("graph_emb", graph_emb, torch.float32)
    if graph_emb.dim() != 2 or graph_emb.shape[0] != batch:
        raise ValueError(f"graph_emb must be [{batch}, G], got "
                         f"{tuple(graph_emb.shape)}")
    g = graph_emb.shape[1]
    out = emb.new_empty((batch, f + g))
    kernels.launch("masked_mean_pool_concat", emb.data_ptr(),
                   node_mask.data_ptr(), graph_emb.data_ptr(),
                   out.data_ptr(), batch, n_nodes, f, g)
    return out


class _MaskedMeanPoolConcat(torch.autograd.Function):
    """K3 forward, K6 ``masked_mean_pool_concat_bwd`` backward."""

    @staticmethod
    def forward(ctx, emb, node_mask, graph_emb):
        ctx.save_for_backward(node_mask)
        ctx.f = emb.shape[2]
        return _masked_mean_pool_concat_cuda(emb, node_mask, graph_emb)

    @staticmethod
    def backward(ctx, dout):
        (node_mask,) = ctx.saved_tensors
        d_emb, d_graph = masked_mean_pool_concat_bwd(dout.contiguous(),
                                                     node_mask, ctx.f)
        return d_emb, None, d_graph


def masked_mean_pool_concat_bwd_plain(dout: torch.Tensor,
                                      node_mask: torch.Tensor, f: int
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward of ``masked_mean_pool_concat``: ``d_emb[b, n] =
    (dout[b, :f] / count_b) * node_mask[b, n]`` with ``count_b =
    max(sum_n node_mask[b, n], 1)``, and ``d_graph = dout[:, f:]``."""
    count = torch.clamp(torch.sum(node_mask.to(dout.dtype), dim=1), min=1.0)
    d_emb = ((dout[:, :f] / count[:, None])[:, None, :]
             * node_mask.to(dout.dtype)[..., None])
    return d_emb, dout[:, f:]


def masked_mean_pool_concat_bwd(dout: torch.Tensor, node_mask: torch.Tensor,
                                f: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 ``masked_mean_pool_concat_bwd``: ``(d_emb [B, N, f], d_graph
    [B, G])`` from ``dout`` [B, f + G] and ``node_mask`` [B, N], float32.
    ``node_mask`` must hold only 0 and 1 (as every caller's, made from the
    batch's boolean node masks): the kernel counts it in an order of its
    own, which gives the plain version's count only then."""
    if kernels.on_cpu(dout, node_mask):
        return masked_mean_pool_concat_bwd_plain(dout, node_mask, f)
    kernels.check_cuda("dout", dout, torch.float32)
    if dout.dim() != 2 or not 0 < f <= dout.shape[1]:
        raise ValueError(f"dout must be [B, {f} + G], got "
                         f"{tuple(dout.shape)}")
    batch, g = dout.shape[0], dout.shape[1] - f
    kernels.check_cuda("node_mask", node_mask, torch.float32)
    if node_mask.dim() != 2 or node_mask.shape[0] != batch:
        raise ValueError(f"node_mask must be [{batch}, N], got "
                         f"{tuple(node_mask.shape)}")
    n_nodes = node_mask.shape[1]
    d_emb = dout.new_empty((batch, n_nodes, f))
    d_graph = dout.new_empty((batch, g))
    if batch and n_nodes:
        kernels.launch("masked_mean_pool_concat_bwd", dout.data_ptr(),
                       node_mask.data_ptr(), d_emb.data_ptr(),
                       d_graph.data_ptr(), batch, n_nodes, f, g,
                       _scalar("masked_mean_pool_concat_bwd"))
    return d_emb, d_graph
