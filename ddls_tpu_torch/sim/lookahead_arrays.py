"""The lookahead engines' inputs: one job's ops and deps as flat arrays.

Port: ``LookaheadArrays``, ``build_lookahead_arrays`` (padded, float32:
the array engine's, ``sim/lookahead.py``), ``build_native_lookahead_arrays``
(exact size, float64: the C++ engine's) and ``arrays_as_args`` from
``ddls_tpu/sim/jax_lookahead.py:43,68,188,474`` (numpy only). The padded
builder is the native one's output padded and cast, with the reference's
worker and channel numbering: the same arrays as the reference's padded
builder, without its Python loop over every dep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class LookaheadArrays:
    """Padded single-job lookahead inputs (all numpy, ready for device).

    Shapes: N = padded ops, E = padded deps, L = max channels per flow dep.
    ``op_score``/``dep_score`` are priority-with-rank combined scores
    (higher wins; distinct per valid slot). ``dep_channel`` holds channel
    indices (-1 padding) into a dense per-job channel renumbering.
    """
    op_remaining: np.ndarray   # [N] f32
    op_valid: np.ndarray       # [N] bool
    op_worker: np.ndarray      # [N] i32 (dense worker index, -1 pad)
    op_score: np.ndarray       # [N] f32
    num_parents: np.ndarray    # [N] i32 (non-mutual parent deps)
    dep_remaining: np.ndarray  # [E] f32
    dep_valid: np.ndarray      # [E] bool
    dep_src: np.ndarray        # [E] i32
    dep_dst: np.ndarray        # [E] i32
    dep_mutual: np.ndarray     # [E] bool
    dep_is_flow: np.ndarray    # [E] bool
    dep_score: np.ndarray      # [E] f32
    dep_channel: np.ndarray    # [E, L] i32 (-1 pad)
    num_workers: int           # static
    num_channels: int          # static


def _padded(x: np.ndarray, size: int, fill, dtype) -> np.ndarray:
    out = np.full((size,) + x.shape[1:], fill, dtype)
    out[:len(x)] = x
    return out


def build_lookahead_arrays(cluster, job, pad_ops: int, pad_deps: int,
                           pad_links: int = 1,
                           context: dict | None = None) -> LookaheadArrays:
    """The C++ engine's arrays (:func:`build_native_lookahead_arrays`,
    same ``context``) padded to ``pad_ops`` ops, ``pad_deps`` deps and
    ``pad_links`` channels per dep, in float32: the array engine's
    inputs (``sim/lookahead.py``). Workers are renumbered in sorted-id
    order and channels in order of first use, the reference's numbering
    (the engine's result does not depend on it: workers and channels only
    partition ops and deps). Raises ``ValueError`` when the job does not
    fit the padding (ops, deps, or channels per flow dep)."""
    n, m = job.graph.n_ops, job.graph.n_deps
    if n > pad_ops or m > pad_deps:
        raise ValueError(f"job needs ({n},{m}) > padding ({pad_ops},{pad_deps})")
    a = build_native_lookahead_arrays(cluster, job, context=context)
    links = a.dep_channel.shape[1]
    if links > pad_links:
        raise ValueError(f"a dep rides {links} channels > pad_links "
                         f"{pad_links}")

    # workers: the native numbering is by first use in op order
    op_to_worker = (context["op_to_worker"] if context is not None
                    else cluster.job_op_to_worker[job.details["job_idx"]])
    op_ids = job.graph.finalize()["op_ids"]
    first_op = np.unique(a.op_worker, return_index=True)[1]
    ids = [op_to_worker[op_ids[i]] for i in first_op]
    worker_rank = np.empty(len(ids), np.int32)
    worker_rank[sorted(range(len(ids)), key=ids.__getitem__)] = np.arange(
        len(ids), dtype=np.int32)
    op_worker = worker_rank[a.op_worker] if n else a.op_worker

    # channels: by first use in dep order, a dep's own in its list's order
    dep_channel = a.dep_channel
    used = dep_channel[dep_channel >= 0]
    if len(used):
        chans, first_use = np.unique(used, return_index=True)
        chan_rank = np.empty(chans[-1] + 1, np.int32)
        chan_rank[chans[np.argsort(first_use)]] = np.arange(
            len(chans), dtype=np.int32)
        dep_channel = np.where(dep_channel >= 0,
                               chan_rank[np.maximum(dep_channel, 0)], -1)
    dep_channel = np.pad(dep_channel.astype(np.int32),
                         ((0, pad_deps - m), (0, pad_links - links)),
                         constant_values=-1)

    f32, i32 = np.float32, np.int32
    return LookaheadArrays(
        op_remaining=_padded(a.op_remaining, pad_ops, 0, f32),
        op_valid=_padded(a.op_valid, pad_ops, False, bool),
        op_worker=_padded(op_worker, pad_ops, -1, i32),
        op_score=_padded(a.op_score, pad_ops, 0, f32),
        num_parents=_padded(a.num_parents, pad_ops, 0, i32),
        dep_remaining=_padded(a.dep_remaining, pad_deps, 0, f32),
        dep_valid=_padded(a.dep_valid, pad_deps, False, bool),
        dep_src=_padded(a.dep_src, pad_deps, 0, i32),
        dep_dst=_padded(a.dep_dst, pad_deps, 0, i32),
        dep_mutual=_padded(a.dep_mutual, pad_deps, False, bool),
        dep_is_flow=_padded(a.dep_is_flow, pad_deps, False, bool),
        dep_score=_padded(a.dep_score, pad_deps, 0, f32),
        dep_channel=dep_channel,
        num_workers=a.num_workers, num_channels=a.num_channels)


def build_native_lookahead_arrays(cluster, job,
                                  context: dict | None = None
                                  ) -> LookaheadArrays:
    """Exact-size f64 packing for the C++ engine (ddls_tpu_torch/native).

    Vectorised: the only Python
    loops left are one O(n_ops) pass for worker/priority lookups and one
    pass over *flow* deps for channel lists — the O(n_deps) per-edge dict
    walk is replaced by index arithmetic on ``graph.finalize()`` arrays.

    ``context`` supplies placement state for a job NOT mounted on the
    cluster (candidate pricing): {"op_to_worker": {op: worker_id},
    "op_pri": {op: pri}, "payload": DepArrays}. Without it, state is read
    from the cluster's mounted structures.
    """
    job_idx = job.details["job_idx"]
    graph = job.graph
    arrays = graph.finalize()
    n, m = graph.n_ops, graph.n_deps
    topo = cluster.topology
    op_ids = arrays["op_ids"]
    if context is not None:
        op_to_worker = context["op_to_worker"]
        ctx_op_pri = context.get("op_pri") or {}
    else:
        op_to_worker = cluster.job_op_to_worker[job_idx]
        ctx_op_pri = None
    worker_to_server = topo.worker_to_server
    workers = topo.workers

    op_worker = np.empty(n, np.int32)
    op_pri = np.zeros(n, np.float64)
    server_of_op = []
    worker_dense: Dict[str, int] = {}
    pri_maps: Dict[str, Dict[str, int]] = {}
    for i, op_id in enumerate(op_ids):
        w = op_to_worker[op_id]
        wi = worker_dense.get(w)
        if wi is None:
            wi = worker_dense.setdefault(w, len(worker_dense))
            pri_maps[w] = (ctx_op_pri if ctx_op_pri is not None
                           else workers[w].op_priority.get(job_idx, {}))
        op_worker[i] = wi
        server_of_op.append(worker_to_server[w])
        pri = pri_maps[w].get(op_id, 0)
        if pri:
            op_pri[i] = pri

    op_score = op_pri * (n + 1) + (n - arrays["op_sorted_rank"])

    edge_src = arrays["edge_src"].astype(np.int32)
    edge_dst = arrays["edge_dst"].astype(np.int32)
    _, dep_is_flow = graph.flow_mask(server_of_op)

    if getattr(job, "dep_init_run_time_arr", None) is not None:
        dep_remaining = job.dep_init_run_time_arr
    else:
        dep_remaining = np.zeros(m, np.float64)
        edge_index = arrays["edge_index"]
        for edge, t in job.dep_init_run_time.items():
            dep_remaining[edge_index[edge]] = t

    # channels + priorities: flow deps only
    dep_pri = np.zeros(m, np.float64)
    edge_ids = arrays["edge_ids"]
    flow_idx = np.nonzero(dep_is_flow)[0]
    payload = (context.get("payload") if context is not None
               else getattr(cluster, "job_dep_arrays", {}).get(job_idx))
    if payload is not None:
        # array pipeline: channels/priorities straight off the DepArrays
        # payload; per-job local channel renumbering is one searchsorted
        # (numbering order is irrelevant — channels only partition deps).
        # pri=None (placement without a schedule) degrades to priority 0
        # exactly like the host engine's zeros fallback
        pri_src = (payload.pri if payload.pri is not None
                   else np.zeros(m, np.int64))
        dep_pri[flow_idx] = pri_src[flow_idx].astype(np.float64)
        uniq = np.unique(payload.chan[flow_idx])
        n_chan = len(uniq)
        dep_channel = np.full((m, 1), -1, np.int32)
        dep_channel[flow_idx, 0] = np.searchsorted(
            uniq, payload.chan[flow_idx]).astype(np.int32)
    else:
        chan_dense: Dict[str, int] = {}
        dep_to_channels = cluster.job_dep_to_channels.get(job_idx, {})
        channel_id_to_channel = topo.channel_id_to_channel
        flow_channels = []
        links = 1
        for ei in flow_idx:
            edge = edge_ids[ei]
            channels = sorted(dep_to_channels.get(edge, ()))
            dense = []
            for ch_id in channels:
                ci = chan_dense.get(ch_id)
                if ci is None:
                    ci = chan_dense.setdefault(ch_id, len(chan_dense))
                dense.append(ci)
            flow_channels.append(dense)
            if len(dense) > links:
                links = len(dense)
            if channels:
                pri = channel_id_to_channel[channels[0]].dep_priority.get(
                    job_idx, {}).get(edge, 0)
                if pri:
                    dep_pri[ei] = pri
        n_chan = len(chan_dense)
        dep_channel = np.full((m, links), -1, np.int32)
        for ei, dense in zip(flow_idx, flow_channels):
            dep_channel[ei, :len(dense)] = dense

    dep_score = dep_pri * (m + 1) + (m - arrays["edge_sorted_rank"])

    return LookaheadArrays(
        op_remaining=arrays["compute"], op_valid=np.ones(n, bool),
        op_worker=op_worker, op_score=op_score,
        num_parents=arrays["num_parents"].astype(np.int32),
        dep_remaining=dep_remaining, dep_valid=np.ones(m, bool),
        dep_src=edge_src, dep_dst=edge_dst,
        dep_mutual=arrays["edge_mutual"], dep_is_flow=dep_is_flow,
        dep_score=dep_score, dep_channel=dep_channel,
        num_workers=max(len(worker_dense), 1),
        num_channels=max(n_chan, 1))


def arrays_as_args(a: LookaheadArrays) -> Tuple[np.ndarray, ...]:
    """The thirteen arrays in the engine's argument order."""
    return (a.op_remaining, a.op_valid, a.op_worker, a.op_score,
            a.num_parents, a.dep_remaining, a.dep_valid, a.dep_src,
            a.dep_dst, a.dep_mutual, a.dep_is_flow, a.dep_score,
            a.dep_channel)
