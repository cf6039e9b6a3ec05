"""Masked segment reductions over padded edge lists, in PyTorch.

Counterpart of ``ddls_tpu/ops/segment.py``. The three JAX functions keep
their signatures and arithmetic as plain PyTorch (``masked_segment_sum``,
``masked_segment_mean`` with ``extra``, ``masked_mean``). The serving
forward reaches two kernels through the wrappers below:

* ``csr_segment_mean`` (K2) takes the destination-sorted CSR that
  ``build_csr`` makes on the host at batch-assembly time, and sums each
  node's in-edges in ascending edge id with no atomics — the same bits on
  every run, so batching can never change an answer;
* ``masked_mean_pool_concat`` (K3) pools each graph's node embeddings and
  writes them beside the graph embedding.

Each wrapper takes its plain version for tensors on the CPU and launches
its CUDA kernel for tensors on the card (``kernels.launch_counts`` counts
the launches).
"""
from __future__ import annotations

from typing import Optional, Tuple

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
                     node_mask: torch.Tensor) -> torch.Tensor:
    """K2: per-node mean over {self} U in-edges from a CSR (``build_csr``).

    ``msg`` [n_msg, F] and ``self_msg`` [V, F] float32, ``row_ptr`` [V+1]
    and ``col`` [>= nnz] int32, ``node_mask`` [V] float32 (1 keeps a node,
    0 zeroes it). Returns [V, F]."""
    if kernels.on_cpu(msg, self_msg, row_ptr, col, node_mask):
        return csr_segment_mean_plain(msg, self_msg, row_ptr, col, node_mask)
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

