"""The device-resident episode replay of the canonical RAMP partitioning
environment: every decision of an episode (placement, dep pricing, the
lookahead, the SLA gate, the commit) and the event clock between them run
on the card, for a batch of lanes at once.

Port of the replay half of ``ddls_tpu/sim/jax_env.py``:

* the host-side table functions (numpy, float64): ``ShapeTables`` :77,
  ``build_shape_tables`` :113, ``ConfigPads`` :167, ``config_tables_for``
  :179, ``stack_config_tables`` :277, ``EpisodeTables`` :803,
  ``build_episode_tables`` :827, ``build_job_bank`` :906,
  ``sample_job_bank`` :929 and the ``CAUSE_*`` codes :776-799;
* placement (B8): ``allocate_job`` (``jax_allocate_job`` :450 over
  ``_anchor_masks`` :384 and ``_first_fit_from_masks`` :424), K23;
* pricing and SRPT scores (B9): ``all_reduce_time``
  (``_jnp_all_reduce_time`` :564) and ``price_and_score``
  (``jax_price_and_score`` :606), K24;
* the lookahead (B10): K21 (``sim/lookahead.py``), with ``skip`` for the
  lanes that decide nothing;
* the episode (the replay part of B13): ``episode_kernels`` (``eval_cfg``,
  ``decision``, ``advance``, ``init_state`` of ``_episode_kernels``
  :974-1237) and ``make_episode_fn`` :1240, with the commit and the event
  clock in K25 (``episode_step``).

Each kernel's wrapper launches it on CUDA tensors and runs its plain
PyTorch version (``*_plain``) on CPU tensors. The tables live on the
episode's device, built in float64 and cast to its float type (float32,
as ``jnp.asarray`` leaves them without x64, or float64, the reference's
x64 mode, which reproduces the host env's decisions exactly).

* the lookahead memo (B11, ``sim/device_memo.py``: K27 before K21 and
  K28 after it), threaded through ``EpisodeKernels.evaluate`` and
  ``make_episode_fn``'s ``memo_cfg``;
* the in-kernel observation (B12): ``build_obs_tables`` :1329,
  ``kernel_action_mask`` :1395 and ``kernel_obs`` :1409 (K26), and the
  policy forward's flattened batch put together on the device
  (``DeviceObs.forward_batch``, K20 over per-type rows built once);
* the policy and segment episodes (the rest of B13):
  ``make_policy_episode_fn`` :1457, ``segment_init`` :1585,
  ``make_segment_fn`` :1596 (K25 resets an ended lane's episode in
  place) and ``rebuild_obs_batch`` :1766;
* in-kernel candidate pricing and the OracleJCT episode (B13's oracle):
  ``EpisodeKernels.price_all`` :1085 (K23 with a state-lane index, K24,
  K21 without the memo, K29 ``price_reduce``), the oracle's choice
  (``oracle_select``, K30, :1831-1869) and ``make_oracle_episode_fn``
  :1799; the observation's price block (K26 with prices, :1492-1512),
  which the price-feature ``make_policy_episode_fn`` computes each step.

* the scenario mirror (B13's failure walk): ``build_episode_tables``
  keeps a non-nominal scenario's speeds and windows (reference:
  :875-888), ``DeviceTables.scenario`` holds them on the device, and the
  decision inflates each lane's jct after the gate and before the commit
  (``scenario_adjusted``, the counterpart of ``scenario_adjusted`` :1014
  over ``inflate_duration_jax``; K25's scenario mode).

Lanes are independent: a stacked run equals its lanes run one by one, bit
for bit. The episode updates its state tensors in place (the reference's
scan carries new arrays each decision).
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import functools
import random as _random
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.agents.block_search import (block_shapes_for,
                                                enumerate_block,
                                                factor_pairs)
from ddls_tpu_torch.agents.partitioners import build_partition_action
from ddls_tpu_torch.graphs.readers import backward_op_id
from ddls_tpu_torch.scenarios.failures import FAILURE_WORKER_PREEMPT
from ddls_tpu_torch.sim import device_memo
from ddls_tpu_torch.sim import lookahead as lookahead_mod
from ddls_tpu_torch.sim.partition import partition_graph, partitioned_op_id

Coord = Tuple[int, int, int]


# =========================================================================
# Shape system: the static candidate-block geometry of one RAMP topology.
# =========================================================================

@dataclasses.dataclass
class ShapeTables:
    """Distinct candidate block shapes for every split value, in host
    ``find_sub_block`` order, as padded index tables (reference: :77).

    ``row[s]`` lists shape ids for split ``s`` in the host's scan order,
    shapes with an empty origin span dropped. ``anchor_cells[sh, a, t]``
    is the server code of cell ``t`` of shape ``sh`` anchored at grid
    position ``a`` (the reference's modulo by ``bases``, diagonals wrapping
    through ``dim + 1``), -1 where that cell falls outside the ramp (the
    anchor is then invalid) and -2 past the shape's cell count;
    ``anchor_span[sh, a]`` says whether ``a`` lies in the shape's origin
    span. Both are precomputed here from the reference's formula
    (``_anchor_masks`` :384-421), so the placer gathers where the
    reference computes.

    Derived from them for K23's warp-wide first fit: ``anchor_bits[sh, a,
    w]`` has bit ``s % 32`` of word ``w = s // 32`` set when server ``s``
    is a cell of shape ``sh`` at anchor ``a`` (32-bit words held as int32),
    and ``anchor_ok[sh, a]`` is ``anchor_span`` with no cell outside the
    ramp: the anchor fits a free mask exactly when it is ok and none of
    its bits is missing from the mask.
    """
    ramp_shape: Coord
    shapes: List[Coord]            # distinct shapes (S==-1 -> diagonal)
    row: np.ndarray                # [max_split+1, MAX_SHAPES] i32, -1 pad
    offsets: np.ndarray            # [n_shapes, MAX_CELLS, 3] i32
    counts: np.ndarray             # [n_shapes] i32 servers per block
    bases: np.ndarray              # [n_shapes, 3] i32 modulo base per axis
    spans: np.ndarray              # [n_shapes, 3] i32 origin span extents
    diagonal: np.ndarray           # [n_shapes] bool
    anchor_cells: np.ndarray       # [n_shapes, n_cells, MAX_CELLS] i32
    anchor_span: np.ndarray        # [n_shapes, n_cells] bool
    anchor_bits: np.ndarray        # [n_shapes, n_cells, W] i32 bit words
    anchor_ok: np.ndarray          # [n_shapes, n_cells] bool


def _shape_span(shape: Coord, meta: Coord) -> Coord:
    # first_fit_block's span arithmetic, including the S == -1 quirk
    # span[2] = meta[2] + 2
    return (meta[0] - shape[0] + 1, meta[1] - shape[1] + 1,
            meta[2] - shape[2] + 1)


def _shape_cells(shape: Coord) -> List[Coord]:
    """Cell offsets at origin (0, 0, 0): the host's ``enumerate_block``
    on a huge phantom ramp, so that no modulo fires."""
    big = (1 << 20, 1 << 20, 1 << 20)
    return enumerate_block(shape, big, (0, 0, 0))


def _anchor_tables(ramp_shape: Coord, offsets, counts, bases, spans):
    C, R, S = ramp_shape
    n_shapes, max_cells = offsets.shape[:2]
    ii, jj, kk = np.meshgrid(np.arange(C), np.arange(R), np.arange(S),
                             indexing="ij")
    cells = np.full((n_shapes, C * R * S, max_cells), -2, np.int32)
    span = np.zeros((n_shapes, C * R * S), bool)
    for si in range(n_shapes):
        for t in range(int(counts[si])):
            off, base = offsets[si, t], bases[si]
            ci = (ii + int(off[0])) % int(base[0])
            cj = (jj + int(off[1])) % int(base[1])
            ck = (kk + int(off[2])) % int(base[2])
            in_ramp = (ci < C) & (cj < R) & (ck < S)
            code = (ci * R + cj) * S + ck
            cells[si, :, t] = np.where(in_ramp, code, -1).reshape(-1)
        # the host scans diagonal origins k over meta[2] + 2 values, but k
        # and k - S alias one block, so k < S covers every class in order
        span[si] = ((ii < int(spans[si, 0])) & (jj < int(spans[si, 1]))
                    & (kk < min(int(spans[si, 2]), S))).reshape(-1)
    return cells, span


def _anchor_bits(cells: np.ndarray, span: np.ndarray, n_srv: int):
    """(anchor_bits, anchor_ok) of ``anchor_cells`` and ``anchor_span``
    (see ``ShapeTables``)."""
    words = -(-n_srv // 32)
    bits = np.zeros(cells.shape[:2] + (words,), np.uint32)
    for t in range(cells.shape[2]):
        cell = cells[:, :, t]
        for w in range(words):
            inside = (cell >= 32 * w) & (cell < 32 * (w + 1))
            bit = np.left_shift(np.uint32(1),
                                np.where(inside, cell - 32 * w, 0)
                                .astype(np.uint32))
            bits[:, :, w] |= np.where(inside, bit, np.uint32(0))
    return bits.view(np.int32), span & ~(cells == -1).any(-1)


def build_shape_tables(ramp_shape: Coord, max_split: int) -> ShapeTables:
    meta = tuple(ramp_shape)
    per_split: Dict[int, List[Coord]] = {}
    for s in range(1, max_split + 1):
        if s != 1 and s % 2 != 0:
            continue  # odd splits > 1 cannot occur (RAMP symmetry)
        shapes = block_shapes_for(factor_pairs(s), meta)
        shapes += [(s, s, -1), (s, 1, 1)]
        shapes = [sh for sh in shapes
                  if all(x > 0 for x in _shape_span(sh, meta))]
        per_split[s] = shapes

    distinct: List[Coord] = []
    index: Dict[Coord, int] = {}
    for shapes in per_split.values():
        for sh in shapes:
            if sh not in index:
                index[sh] = len(distinct)
                distinct.append(sh)

    max_row = max((len(v) for v in per_split.values()), default=1)
    row = np.full((max_split + 1, max_row), -1, np.int32)
    for s, shapes in per_split.items():
        for p, sh in enumerate(shapes):
            row[s, p] = index[sh]

    n_shapes = max(len(distinct), 1)
    cell_lists = [_shape_cells(sh) for sh in distinct]
    max_cells = max((len(c) for c in cell_lists), default=1)
    offsets = np.zeros((n_shapes, max_cells, 3), np.int32)
    counts = np.zeros(n_shapes, np.int32)
    bases = np.zeros((n_shapes, 3), np.int32)
    spans = np.zeros((n_shapes, 3), np.int32)
    diagonal = np.zeros(n_shapes, bool)
    for i, sh in enumerate(distinct):
        cells = cell_lists[i]
        counts[i] = len(cells)
        offsets[i, :len(cells)] = cells
        diagonal[i] = sh[2] == -1
        # enumerate_block's modulo: regular blocks wrap at ramp dims (a
        # no-op inside the span), diagonals at (dim+1, dim+1, dim)
        bases[i] = ((ramp_shape[0] + 1, ramp_shape[1] + 1, ramp_shape[2])
                    if sh[2] == -1 else ramp_shape)
        spans[i] = _shape_span(sh, meta)
    anchor_cells, anchor_span = _anchor_tables(meta, offsets, counts, bases,
                                               spans)
    anchor_bits, anchor_ok = _anchor_bits(anchor_cells, anchor_span,
                                          int(np.prod(meta)))
    return ShapeTables(ramp_shape=meta, shapes=distinct, row=row,
                       offsets=offsets, counts=counts, bases=bases,
                       spans=spans, diagonal=diagonal,
                       anchor_cells=anchor_cells, anchor_span=anchor_span,
                       anchor_bits=anchor_bits, anchor_ok=anchor_ok)


# =========================================================================
# Config tables: everything static per (model, partition degree).
# =========================================================================

@dataclasses.dataclass
class ConfigPads:
    n_ops: int        # N: padded partitioned-op slots
    n_deps: int       # M: padded dep slots
    n_fwd: int        # F: padded forward-op scan slots
    n_parents: int    # P: padded parent-candidate slots
    max_split: int    # maximum sub-ops per op (block size)
    n_groups: int     # G: padded candidate collective groups
    group_edges: int  # Eg: padded edges per candidate group
    n_sync: int       # padded 2-edge sync pairs
    n_o2o: int        # padded one-to-one edges


def config_tables_for(graph, degree: int, quantum: float) -> dict:
    """Unpadded per-(model, degree) tables (numpy, float64) of the job's
    raw profile ``graph`` partitioned at ``degree`` (reference: :179)."""
    from ddls_tpu_torch.demands.job import Job
    from ddls_tpu_torch.sim.actions import build_grouping_arrays

    if degree != 1 and degree % 2 != 0:
        raise ValueError(f"degree must be 1 or even, got {degree}")
    action = build_partition_action(graph, quantum, degree)
    pgraph = partition_graph(graph, action)
    arrays = pgraph.finalize()
    n, m = pgraph.n_ops, pgraph.n_deps
    op_index = arrays["op_index"]

    original = Job(graph=graph, num_training_steps=1,
                   max_acceptable_jct_frac=1.0, job_id=0,
                   details={"model": "cfg", "job_idx": 0})
    partitioned = Job(graph=pgraph, num_training_steps=1,
                      max_acceptable_jct_frac=1.0, job_id=0,
                      details={"model": "cfg", "job_idx": 0},
                      original_job=original)

    forward_graph = graph.forward_view()
    n_forward = len(forward_graph.op_ids)
    split_fwd = {str(int(op)): int(action.get(str(int(op)), 1))
                 for op in forward_graph.op_ids}
    split_fwd = {k: v for k, v in split_fwd.items() if v > 1}

    topo = forward_graph.topo_order()
    fwd_slot = {str(int(op)): i for i, op in enumerate(topo)}

    f_split = np.zeros(len(topo), np.int32)
    f_mem = np.zeros(len(topo), np.float64)
    f_parents = []
    f_sub_fwd = np.full((len(topo), degree if degree > 0 else 1), -1,
                        np.int32)
    f_sub_bwd = np.full_like(f_sub_fwd, -1)
    insertion_rank = np.full(n, 0, np.int64)
    ins = 0
    for i, op in enumerate(topo):
        op_s = str(int(op))
        split = split_fwd.get(op_s, 1)
        b_op = backward_op_id(op_s, n_forward)
        mem = graph.memory_cost(op_s)
        if graph.has_op(b_op):
            mem += graph.memory_cost(b_op)
        f_split[i] = split
        f_mem[i] = mem / split
        f_parents.append([fwd_slot[str(int(p))]
                          for p in forward_graph.parents(op)])
        for k in range(split):
            if split > 1:
                fid = op_index[partitioned_op_id(op_s, k)]
                bid = op_index[partitioned_op_id(b_op, k)]
            else:
                fid = op_index[op_s]
                bid = op_index[b_op]
            f_sub_fwd[i, k] = fid
            f_sub_bwd[i, k] = bid
            # host insertion order: per placed server, fwd sub then bwd sub
            # (the SRPT stable sort's tie-break)
            insertion_rank[fid] = ins
            insertion_rank[bid] = ins + 1
            ins += 2

    grouping = build_grouping_arrays(original, partitioned, split_fwd)
    cand = [g for g in grouping["groups"] if not g["sync"]]
    sync = [g for g in grouping["groups"] if g["sync"]]
    edge_size = arrays["edge_size"]

    return {
        "n_ops": n, "n_deps": m,
        "op_compute": arrays["compute"].astype(np.float64),
        "op_sorted_rank": arrays["op_sorted_rank"].astype(np.int32),
        "num_parents": arrays["num_parents"].astype(np.int32),
        "insertion_rank": insertion_rank.astype(np.int32),
        "dep_src": arrays["edge_src"].astype(np.int32),
        "dep_dst": arrays["edge_dst"].astype(np.int32),
        "dep_size": edge_size.astype(np.float64),
        "dep_mutual": arrays["edge_mutual"].astype(bool),
        "dep_sorted_rank": arrays["edge_sorted_rank"].astype(np.int32),
        "f_split": f_split, "f_mem": f_mem, "f_parents": f_parents,
        "f_sub_fwd": f_sub_fwd, "f_sub_bwd": f_sub_bwd,
        "groups": cand, "sync": sync,
        "o2o_edges": grouping["o2o_edges"].astype(np.int32),
        "seq_compute": float(arrays["compute"].sum()),
    }


def stack_config_tables(per_cfg: Sequence[dict],
                        shape_tables: ShapeTables) -> Tuple[dict, ConfigPads]:
    """Pad and stack per-config tables along a leading cfg axis
    (reference: :277)."""
    pads = ConfigPads(
        n_ops=max(c["n_ops"] for c in per_cfg),
        n_deps=max(c["n_deps"] for c in per_cfg),
        n_fwd=max(len(c["f_split"]) for c in per_cfg),
        n_parents=max((len(p) for c in per_cfg for p in c["f_parents"]),
                      default=1) or 1,
        max_split=int(shape_tables.counts.max()),
        n_groups=max((len(c["groups"]) for c in per_cfg), default=1) or 1,
        group_edges=max((len(g["edges"]) for c in per_cfg
                         for g in c["groups"]), default=1) or 1,
        n_sync=max((len(c["sync"]) for c in per_cfg), default=1) or 1,
        n_o2o=max((len(c["o2o_edges"]) for c in per_cfg), default=1) or 1,
    )
    K = len(per_cfg)
    N, M, F, P = pads.n_ops, pads.n_deps, pads.n_fwd, pads.n_parents
    S = pads.max_split
    G, Eg, Sy, O = (pads.n_groups, pads.group_edges, pads.n_sync,
                    pads.n_o2o)

    out = {
        "n_ops": np.zeros(K, np.int32),
        "n_deps": np.zeros(K, np.int32),
        "n_fwd": np.zeros(K, np.int32),
        "op_valid": np.zeros((K, N), bool),
        "op_compute": np.zeros((K, N), np.float64),
        "op_sorted_rank": np.zeros((K, N), np.int32),
        "num_parents": np.zeros((K, N), np.int32),
        "insertion_rank": np.zeros((K, N), np.int32),
        "dep_valid": np.zeros((K, M), bool),
        "dep_src": np.zeros((K, M), np.int32),
        "dep_dst": np.zeros((K, M), np.int32),
        "dep_size": np.zeros((K, M), np.float64),
        "dep_mutual": np.zeros((K, M), bool),
        "dep_sorted_rank": np.zeros((K, M), np.int32),
        "f_valid": np.zeros((K, F), bool),
        "f_split": np.ones((K, F), np.int32),
        "f_mem": np.zeros((K, F), np.float64),
        "f_parents": np.full((K, F, P), -1, np.int32),
        "f_sub_fwd": np.full((K, F, S), -1, np.int32),
        "f_sub_bwd": np.full((K, F, S), -1, np.int32),
        "grp_valid": np.zeros((K, G), bool),
        "grp_edges": np.full((K, G, Eg), -1, np.int32),
        "grp_u": np.zeros((K, G, Eg), np.int32),
        "grp_v": np.zeros((K, G, Eg), np.int32),
        "grp_edge_valid": np.zeros((K, G, Eg), bool),
        "grp_msg": np.zeros((K, G), np.float64),
        "sync_valid": np.zeros((K, Sy), bool),
        "sync_edges": np.full((K, Sy, 2), -1, np.int32),
        "sync_u": np.zeros((K, Sy), np.int32),
        "sync_v": np.zeros((K, Sy), np.int32),
        "sync_msg": np.zeros((K, Sy), np.float64),
        "o2o_valid": np.zeros((K, O), bool),
        "o2o_edges": np.zeros((K, O), np.int32),
        "seq_compute": np.zeros(K, np.float64),
    }
    for k, c in enumerate(per_cfg):
        n, m, f = c["n_ops"], c["n_deps"], len(c["f_split"])
        out["n_ops"][k], out["n_deps"][k], out["n_fwd"][k] = n, m, f
        out["op_valid"][k, :n] = True
        out["op_compute"][k, :n] = c["op_compute"]
        out["op_sorted_rank"][k, :n] = c["op_sorted_rank"]
        out["num_parents"][k, :n] = c["num_parents"]
        out["insertion_rank"][k, :n] = c["insertion_rank"]
        out["dep_valid"][k, :m] = True
        out["dep_src"][k, :m] = c["dep_src"]
        out["dep_dst"][k, :m] = c["dep_dst"]
        out["dep_size"][k, :m] = c["dep_size"]
        out["dep_mutual"][k, :m] = c["dep_mutual"]
        out["dep_sorted_rank"][k, :m] = c["dep_sorted_rank"]
        out["f_valid"][k, :f] = True
        out["f_split"][k, :f] = c["f_split"]
        out["f_mem"][k, :f] = c["f_mem"]
        for i, parents in enumerate(c["f_parents"]):
            out["f_parents"][k, i, :len(parents)] = parents
        out["f_sub_fwd"][k, :f, :c["f_sub_fwd"].shape[1]] = c["f_sub_fwd"]
        out["f_sub_bwd"][k, :f, :c["f_sub_bwd"].shape[1]] = c["f_sub_bwd"]
        for gi, g in enumerate(c["groups"]):
            ne = len(g["edges"])
            out["grp_valid"][k, gi] = True
            out["grp_edges"][k, gi, :ne] = g["edges"]
            out["grp_u"][k, gi, :ne] = g["u"]
            out["grp_v"][k, gi, :ne] = g["v"]
            out["grp_edge_valid"][k, gi, :ne] = True
            out["grp_msg"][k, gi] = g["msg"]
        for si, g in enumerate(c["sync"]):
            out["sync_valid"][k, si] = True
            ne = len(g["edges"])
            out["sync_edges"][k, si, :ne] = g["edges"]
            out["sync_u"][k, si] = g["u"][0]
            out["sync_v"][k, si] = g["v"][0]
            out["sync_msg"][k, si] = g["msg"]
        no = len(c["o2o_edges"])
        out["o2o_valid"][k, :no] = True
        out["o2o_edges"][k, :no] = c["o2o_edges"]
        out["seq_compute"][k] = c["seq_compute"]
    return out, pads


# =========================================================================
# Episode tables, job banks and the blocked-cause codes.
# =========================================================================

# blocked-cause codes of the decision trace (the host's cause strings)
CAUSE_ACCEPTED = 0
CAUSE_NOT_HANDLED = 1        # action 0
CAUSE_OP_PLACEMENT = 2
CAUSE_DEP_PLACEMENT = 3
CAUSE_SLA = 4                # max_acceptable_job_completion_time_exceeded
CAUSE_ENGINE = 5             # lookahead non-convergence / non-finite price
                             # (the host raises; must never appear)

CAUSE_CODE_TO_STR = {
    CAUSE_ACCEPTED: None,
    CAUSE_NOT_HANDLED: "not_handled",
    CAUSE_OP_PLACEMENT: "op_placement",
    CAUSE_DEP_PLACEMENT: "dep_placement",
    CAUSE_SLA: "max_acceptable_job_completion_time_exceeded",
    CAUSE_ENGINE: "engine_failure",
}
CAUSE_STR_TO_CODE = {v: k for k, v in CAUSE_CODE_TO_STR.items()
                     if v is not None}
# the host's per-sub-action causes that collapse onto one code
CAUSE_STR_TO_CODE["op_partition"] = CAUSE_OP_PLACEMENT


@dataclasses.dataclass
class EpisodeTables:
    """Everything static for a device episode (numpy; reference: :803)."""
    st: ShapeTables
    tables: dict               # stacked config tables (numpy, float64)
    pads: ConfigPads
    types: List[str]           # model name -> type index (list order)
    degrees: List[int]         # action degree -> cfg column (list order)
    comm: dict                 # {x, rate, prop, io}
    pair_channel: np.ndarray   # [n_srv, n_srv] i32
    n_chan: int
    n_srv: int
    max_action: int            # env.max_partitions_per_op (action bound)
    sim_end: float
    eps: float                 # cluster.machine_epsilon
    success_reward: float
    fail_reward: float
    worker_mem: float          # per-server memory capacity at reset
    # a non-nominal scenario's inflation inputs in dense index space
    # (speeds [n_srv], window t0 / t1 / rate [W] float64; kind / res [W]
    # ints), or None
    scenario: Optional[dict] = None
    # the tables on each (device, float type) they were asked on
    on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)


def build_episode_tables(env, max_degree: Optional[int] = None,
                         quantum: Optional[float] = None) -> EpisodeTables:
    """The static side of the device episode, from a reset host env of the
    port (canonical RAMP single-channel complete topology, the
    job_acceptance reward; reference: :827), with the cluster's scenario
    runtime where it has one."""
    from ddls_tpu_torch.envs.rewards import JobAcceptance

    topo = env.cluster.topology
    dense = topo.dense_tables()
    if dense["pair_channel"] is None:
        raise ValueError("the device episode needs a single-channel "
                         "complete topology (canonical RAMP)")
    max_degree = max_degree or env.max_partitions_per_op
    quantum = quantum or env.min_op_run_time_quantum
    if max_degree > topo.num_workers:
        raise ValueError(
            f"max_degree {max_degree} exceeds the {topo.num_workers}-"
            "worker topology; cap max_partitions_per_op")

    gen = getattr(env.cluster, "jobs_generator", None)
    if gen is None:
        raise ValueError("build_episode_tables needs an env that was reset "
                         "(the cluster builds its jobs generator at reset)")
    model_graphs = {}
    for proto in gen.sampler.prototypes:
        model_graphs[proto.details["model"]] = proto.graph
    types = sorted(model_graphs)
    degrees = [d for d in range(1, max_degree + 1)
               if d == 1 or d % 2 == 0]

    st = build_shape_tables(topo.shape, min(max_degree, topo.num_workers))
    cfgs = []
    for m in types:
        for d in degrees:
            cfgs.append(config_tables_for(model_graphs[m], d, quantum))
    tables, pads = stack_config_tables(cfgs, st)

    if not isinstance(env.reward_function, JobAcceptance):
        raise ValueError(
            "the device episode replay supports the job_acceptance reward "
            f"only, env has {type(env.reward_function).__name__}")
    workers = list(topo.workers.values())
    if len({w.memory_capacity for w in workers}) != 1:
        raise ValueError("the device episode needs homogeneous worker "
                         "memory")
    # the scenario mirror: the inflation's inputs in dense index space
    sr = getattr(env.cluster, "scenario_runtime", None)
    scenario = None
    if sr is not None and not sr.is_nominal:
        scenario = {
            "speeds": np.asarray(sr.speeds, np.float64),
            "t0": np.asarray(sr.win_t0, np.float64),
            "t1": np.asarray(sr.win_t1, np.float64),
            "rate": np.asarray(sr.win_rate, np.float64),
            "kind": [int(k) for k in sr.win_kind],
            "res": [int(r) for r in sr.win_res],
        }
    return EpisodeTables(
        st=st, tables=tables, pads=pads, types=types, degrees=degrees,
        comm={"x": topo.num_communication_groups,
              "rate": topo.channel_bandwidth,
              "prop": topo.intra_gpu_propagation_latency,
              "io": topo.worker_io_latency},
        pair_channel=np.asarray(dense["pair_channel"], np.int32),
        n_chan=len(dense["channel_ids"]),
        n_srv=topo.num_workers,
        max_action=int(env.max_partitions_per_op),
        sim_end=float(env.max_simulation_run_time),
        eps=env.cluster.machine_epsilon,
        success_reward=getattr(env.reward_function, "success_reward", 1.0),
        fail_reward=getattr(env.reward_function, "fail_reward", -1.0),
        worker_mem=float(workers[0].memory_capacity),
        scenario=scenario)


def build_job_bank(et: EpisodeTables, records: Sequence[dict]) -> dict:
    """Job bank arrays (numpy) from per-arrival records, each
    {model, num_training_steps, sla_frac, time_arrived} (reference:
    :906)."""
    J = len(records)
    bank = {
        "type": np.zeros(J, np.int32),
        "steps": np.zeros(J, np.float64),
        "sla_frac": np.zeros(J, np.float64),
        "arrival_t": np.zeros(J + 1, np.float64),
    }
    if records and records[0]["time_arrived"] != 0.0:
        # the episode seeds job 0 as queued at t=0, as the cluster's reset
        raise ValueError("job bank must start with a t=0 arrival")
    for i, r in enumerate(records):
        bank["type"][i] = et.types.index(r["model"])
        bank["steps"][i] = r["num_training_steps"]
        bank["sla_frac"][i] = r["sla_frac"]
        bank["arrival_t"][i] = r["time_arrived"]
    bank["arrival_t"][J] = np.inf
    return bank


def sample_job_bank(et: EpisodeTables, env, n_jobs: int, seed: int) -> dict:
    """A job bank sampled from the env's own workload machinery
    (reference: :929): a deep copy of its generator, both process-global
    generators (numpy's and ``random``'s) seeded for the draw and
    restored after it, so the bank depends on ``seed`` alone and the env's
    streams are untouched. A pool that empties ends the bank early."""
    gen = copy.deepcopy(env.cluster.jobs_generator)
    np_state = np.random.get_state()
    py_state = _random.getstate()
    try:
        np.random.seed(seed)
        _random.seed(seed ^ 0x5DEECE66D)
        t, recs = 0.0, []
        for _ in range(n_jobs):
            if len(gen.sampler) == 0:
                break
            job = gen.sample_job()
            recs.append({
                "model": job.details.get("model"),
                "num_training_steps": job.num_training_steps,
                "sla_frac": float(job.max_acceptable_jct_frac),
                "time_arrived": t,
            })
            t += float(gen.sample_interarrival_time())
    finally:
        np.random.set_state(np_state)
        _random.setstate(py_state)
    return build_job_bank(et, recs)


# =========================================================================
# The tables on the episode's device.
# =========================================================================

class DeviceTables:
    """The episode tables as tensors on ``device``: floats in ``dtype``,
    the rest int32 or bool; the shape tables and the action -> config
    column map beside them."""

    def __init__(self, et: EpisodeTables, device, dtype: torch.dtype):
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"the episode runs in float32 or float64, got "
                            f"{dtype}")
        self.et, self.device, self.dtype = et, torch.device(device), dtype
        self.pads, self.st = et.pads, et.st

        def put(x, want=None):
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.to(device=self.device,
                        dtype=want or (dtype if t.is_floating_point()
                                       else None))

        self.t = {k: put(v) for k, v in et.tables.items()}
        self.row = put(et.st.row)
        self.anchor_cells = put(et.st.anchor_cells)
        self.anchor_span = put(et.st.anchor_span)
        self.anchor_bits = put(et.st.anchor_bits)
        self.anchor_ok = put(et.st.anchor_ok)
        self.pair_channel = put(et.pair_channel)
        # action value -> cfg column (-1 for odd/invalid actions), sized by
        # the env's action bound so no action clamps onto a valid column
        deg_col = np.full(max(et.max_action, max(et.degrees)) + 1, -1,
                          np.int32)
        for i, d in enumerate(et.degrees):
            deg_col[d] = i
        self.deg_col = put(deg_col)
        self.degrees = put(np.array(et.degrees, np.int32))
        self.deg_arange = put(np.arange(len(et.degrees), dtype=np.int32))
        self.n_deg = len(et.degrees)
        # each candidate-pricing row's state lane, by the number of lanes
        self.price_lanes: Dict[int, torch.Tensor] = {}
        self.n_cfg = len(et.tables["n_ops"])
        comm = et.comm
        # the reference's Python-float constants, as its float type rounds
        # them: prop + 2 io is summed in double before it meets an array
        self.comm = {"x": float(comm["x"]), "rate": float(comm["rate"]),
                     "prop_io": float(comm["prop"] + 2 * comm["io"]),
                     "data_per_tx": float(comm["rate"] / float(comm["x"]))}
        # the observation tables on this device (``device_obs``), by the
        # id of the host tables they were built from (kept alive here)
        self.obs_tables: Dict[int, tuple] = {}
        # the scenario's speeds [n_srv] and windows [W] in the float type,
        # their kinds and resources [W] int32 (K25 reads them) and as
        # host ints (the plain walk's unroll), or None
        self.scenario = None
        if et.scenario is not None:
            sc = et.scenario
            self.scenario = {
                **{k: put(np.asarray(sc[k], np.float64))
                   for k in ("speeds", "t0", "t1", "rate")},
                **{k: put(np.asarray(sc[k], np.int32))
                   for k in ("kind", "res")},
                "windows": list(zip(sc["kind"], sc["res"]))}


def device_tables(et: EpisodeTables, device="cuda",
                  dtype: torch.dtype = torch.float32) -> DeviceTables:
    """``et``'s tables on ``device`` in ``dtype`` (built once per device
    and float type, and kept on ``et``). Raises for CUDA on a machine
    without a card: the episode never moves to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the device episode runs on the CUDA card by "
                           "default and this machine has none; pass "
                           "device='cpu' for its plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the device episode runs on cuda or cpu, got "
                         f"{device}")
    key = (str(device), dtype)
    dev = et.on_device.get(key)
    if dev is None:
        dev = et.on_device[key] = DeviceTables(et, device, dtype)
    return dev


# =========================================================================
# Placement (B8): K23.
# =========================================================================

def _first_fit_rows(dev: DeviceTables, free: torch.Tensor,
                    split: torch.Tensor):
    """First fit over each lane's split row: (shape id, anchor rank,
    found), each [B] (reference: ``_anchor_masks`` + ``_first_fit_from_
    masks``). ``free`` [B, n_srv] bool."""
    st_cells = dev.anchor_cells.long()                # [n_sh, n_cells, T]
    lanes = free.shape[0]
    cell_free = torch.where(
        st_cells >= 0,
        free[:, st_cells.clamp(min=0).reshape(-1)].reshape(
            (lanes,) + st_cells.shape),
        st_cells == -2)                               # -2: past the count
    masks = cell_free.all(-1) & dev.anchor_span       # [B, n_sh, n_cells]
    n_cells = masks.shape[2]
    big = n_cells + 1
    lex = torch.arange(n_cells, dtype=torch.int32, device=free.device)
    row = dev.row[split.clamp(0, dev.row.shape[0] - 1).long()]  # [B, P]
    best_shape = torch.full((lanes,), -1, dtype=torch.int32,
                            device=free.device)
    best_rank = torch.full((lanes,), big, dtype=torch.int32,
                           device=free.device)
    found = torch.zeros(lanes, dtype=torch.bool, device=free.device)
    ar = torch.arange(lanes, device=free.device)
    for p in range(row.shape[1]):
        sid = row[:, p]
        mask = masks[ar, sid.clamp(min=0).long()] & (sid >= 0)[:, None]
        any_valid = mask.any(1)
        rank = torch.where(mask, lex, big).amin(1).to(torch.int32)
        take = any_valid & ~found
        best_shape = torch.where(take, sid, best_shape)
        best_rank = torch.where(take, rank, best_rank)
        found = found | any_valid
    return best_shape, best_rank, found


def allocate_job_plain(mem: torch.Tensor, other_free: torch.Tensor,
                       cfg: torch.Tensor, dev: DeviceTables,
                       state_lane: Optional[torch.Tensor] = None):
    """K23's plain version: the reference's scan over the forward ops
    (``jax_allocate_job`` :450) for every lane at once."""
    if state_lane is not None:
        mem, other_free = mem[state_lane.long()], other_free[state_lane.long()]
    lanes, n_srv = mem.shape
    pads = dev.pads
    F, N, Smax, P = pads.n_fwd, pads.n_ops, pads.max_split, pads.n_parents
    device = mem.device
    c = cfg.long()
    T = dev.t
    f_valid, f_split, f_mem = T["f_valid"][c], T["f_split"][c], T["f_mem"][c]
    f_parents = T["f_parents"][c]
    f_sub_fwd, f_sub_bwd = T["f_sub_fwd"][c], T["f_sub_bwd"][c]
    ar = torch.arange(lanes, device=device)
    lane = torch.arange(Smax, device=device)
    op_servers = torch.full((lanes, F, Smax), -1, dtype=torch.int32,
                            device=device)
    op_count = torch.zeros((lanes, F), dtype=torch.int32, device=device)
    ots = torch.full((lanes, N + 1), -1, dtype=torch.int32, device=device)
    ok = torch.ones(lanes, dtype=torch.bool, device=device)
    zero = torch.zeros((), dtype=mem.dtype, device=device)
    for f in range(F):
        valid, split, per_mem = f_valid[:, f], f_split[:, f], f_mem[:, f]
        # parent co-location: the first parent whose server count equals
        # split and whose servers all have room
        colo_found = torch.zeros(lanes, dtype=torch.bool, device=device)
        colo_servers = torch.full((lanes, Smax), -1, dtype=torch.int32,
                                  device=device)
        for pi in range(P):
            p = f_parents[:, f, pi]
            pc = p.clamp(min=0).long()
            servers = op_servers[ar, pc]
            cnt = op_count[ar, pc]
            active = lane[None, :] < cnt[:, None]
            srv_mem = mem.gather(1, servers.clamp(min=0).long())
            mem_ok = (~active | (srv_mem >= per_mem[:, None])).all(1)
            okp = (p >= 0) & (cnt > 0) & (cnt == split) & mem_ok
            take = okp & ~colo_found
            colo_servers = torch.where(take[:, None], servers, colo_servers)
            colo_found = colo_found | okp
        # the regular symmetric block search
        free = other_free & (mem >= per_mem[:, None])
        sid, rank, block_found = _first_fit_rows(dev, free, split)
        block = dev.anchor_cells[sid.clamp(min=0).long(),
                                 rank.clamp(max=dev.anchor_cells.shape[1]
                                            - 1).long()]
        block = torch.nn.functional.pad(block, (0, max(Smax - block.shape[1],
                                                       0)))[:, :Smax]
        servers = torch.where(colo_found[:, None], colo_servers, block)
        placed_ok = colo_found | block_found
        # the masked commit of this op's fwd + bwd sub-op pairs
        active = ((lane[None, :] < split[:, None]) & placed_ok[:, None]
                  & valid[:, None] & (servers >= 0))
        take = torch.where(active, per_mem[:, None], zero)
        mem = mem - torch.zeros_like(mem).scatter_add(
            1, servers.clamp(min=0).long(), take)
        for sub in (f_sub_fwd[:, f], f_sub_bwd[:, f]):
            idx = torch.where(active & (sub >= 0), sub, N).long()
            ots.scatter_(1, idx, torch.where(active & (sub >= 0), servers,
                                             -1))
        write = valid & placed_ok
        op_servers[:, f] = torch.where(write[:, None], servers,
                                       op_servers[:, f])
        op_count[:, f] = torch.where(write, split, op_count[:, f])
        ok = ok & (placed_ok | ~valid)
    return ots[:, :N].contiguous(), mem, ok


# K23's forms (kernels/csrc/placement.cu): where its shape tables live
ALLOC_FORMS = ("shared", "global_tables")
_ALLOC_ROWS = 4  # rows a CTA, at most (a warp each)


class AllocPlan(NamedTuple):
    """K23's launch on a surface: its form (an index of ``ALLOC_FORMS``),
    rows a CTA and dynamic shared memory a CTA in bytes."""
    form: int
    rows: int
    smem: int

    def packed(self) -> int:
        """As ``ddls_allocate_job_smem`` reports it."""
        return (self.smem << 5) | (self.rows << 2) | self.form


def _align16(x: int) -> int:
    return (x + 15) & ~15


def alloc_layout_bytes(sizes: Sequence[int], is_f64: bool, form: int,
                       rows: int) -> int:
    """``placement.cu`` ``alloc_layout``'s total: the staged shape tables
    of ``form`` and ``rows`` copies of a row's part. ``sizes`` are the C
    entry's (n_srv, n_ops, n_fwd, n_parents, max_split, n_rows, row_cols,
    n_shapes)."""
    n_srv, n, n_fwd, n_par, smax, n_rows, row_cols, n_shapes = sizes
    t = 8 if is_f64 else 4
    words = (n_srv + 31) // 32
    anchors = n_shapes * n_srv
    cta = _align16(4 * n_rows * row_cols)
    if form == 0:
        cta = _align16(cta + 4 * anchors * words)
        cta = _align16(cta + anchors)
    per_row = 0
    for nbytes in (t * n_srv, n_srv, 4 * words, 4 * n_fwd, t * n_fwd,
                   4 * n_fwd * n_par, 4 * n_fwd * smax, 4 * n_fwd * smax,
                   4 * n_fwd * smax, 4 * n_fwd, 4 * n):
        per_row = _align16(per_row + nbytes)
    return cta + rows * per_row


def allocate_job_plan(sizes: Sequence[int], is_f64: bool, optin: int,
                      force: int = 0) -> Optional[AllocPlan]:
    """A mirror of ``placement.cu`` ``alloc_plan``: the shared form at 4
    rows a CTA where it fits in ``optin`` bytes (and ``force`` is 0), else
    the tables from global memory at the most rows a CTA (4 to 1) that
    fit; None where none fits (the C entry then fails)."""
    for form in range(force, len(ALLOC_FORMS)):
        for rows in range(_ALLOC_ROWS, _ALLOC_ROWS - 1 if form == 0 else 0,
                          -1):
            smem = alloc_layout_bytes(sizes, is_f64, form, rows)
            if smem <= optin:
                return AllocPlan(form, rows, smem)
    return None


def allocate_job_sizes(dev: DeviceTables) -> Tuple[int, ...]:
    """K23's C sizes of ``dev``'s surface (``allocate_job_plan``'s
    ``sizes``)."""
    pads = dev.pads
    return (dev.et.n_srv, pads.n_ops, pads.n_fwd, pads.n_parents,
            pads.max_split, dev.row.shape[0], dev.row.shape[1],
            dev.anchor_cells.shape[0])


def allocate_job(mem: torch.Tensor, other_free: torch.Tensor,
                 cfg: torch.Tensor, dev: DeviceTables,
                 state_lane: Optional[torch.Tensor] = None):
    """K23: place one job per row. ``mem`` [S, n_srv] free memory (the
    episode's float type), ``other_free`` [S, n_srv] bool (not occupied by
    another job), ``cfg`` [B] int32 config rows; row ``b`` reads state lane
    ``state_lane[b]`` (int32 [B], each < S; candidate pricing's rows share
    their lane's state) or, without it, lane ``b`` (S = B). Returns ``(ots
    [B, N] int32 (-1 unplaced), new_mem [B, n_srv], ok [B] bool)``; where
    ok is False the outputs are partial, as the reference's. The C entry
    chooses K23's form from the surface's sizes (``allocate_job_plan``);
    a test forces the global one with ``kernels._forcing("allocate_job",
    1)``."""
    if kernels.on_cpu(mem, other_free, cfg, state_lane):
        return allocate_job_plain(mem, other_free, cfg, dev, state_lane)
    states, n_srv = mem.shape
    lanes = cfg.shape[0]
    kernels.check_cuda("mem", mem, dev.dtype, (states, dev.et.n_srv))
    kernels.check_cuda("other_free", other_free, torch.bool, (states, n_srv))
    kernels.check_cuda("cfg", cfg, torch.int32, (lanes,))
    if state_lane is None:
        if states != lanes:
            raise ValueError(f"{lanes} config rows for {states} state lanes "
                             "need a state_lane index")
    else:
        kernels.check_cuda("state_lane", state_lane, torch.int32, (lanes,))
    pads = dev.pads
    is_f64 = int(dev.dtype == torch.float64)
    sizes = (*allocate_job_sizes(dev), dev.anchor_cells.shape[2])
    ots = torch.empty((lanes, pads.n_ops), dtype=torch.int32,
                      device=mem.device)
    new_mem = torch.empty((lanes, n_srv), dtype=mem.dtype, device=mem.device)
    ok = torch.empty(lanes, dtype=torch.bool, device=mem.device)
    T = dev.t
    if lanes:
        kernels.launch(
            "allocate_job" if state_lane is None else "allocate_job_indexed",
            mem.data_ptr(), other_free.data_ptr(),
            cfg.data_ptr(), kernels.ptr(state_lane), T["n_fwd"].data_ptr(),
            T["f_split"].data_ptr(), T["f_mem"].data_ptr(),
            T["f_parents"].data_ptr(), T["f_sub_fwd"].data_ptr(),
            T["f_sub_bwd"].data_ptr(), dev.row.data_ptr(),
            dev.anchor_cells.data_ptr(), dev.anchor_bits.data_ptr(),
            dev.anchor_ok.data_ptr(),
            ots.data_ptr(), new_mem.data_ptr(), ok.data_ptr(), lanes,
            *sizes, is_f64, int(kernels.forced("allocate_job", 0)))
    return ots, new_mem, ok


# =========================================================================
# Pricing and SRPT scores (B9): K24.
# =========================================================================

def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """ceil(log2(x)) exactly (x >= 1): the reference's ``ceil(log2(x))``
    gives the exact value at every integer it meets, in float32 and
    float64 alike."""
    m, e = torch.frexp(x)
    return torch.where(m == 0.5, e - 1, e).to(x.dtype)


def all_reduce_time(msg, n_servers, n_racks, n_cgs, *, x: float,
                    rate: float, prop_io: float, data_per_tx: float):
    """The RAMP hierarchical all-reduce time, elementwise, in the
    reference's order of operations (``_jnp_all_reduce_time`` :564; the
    host's ``sim/comm_model.py:ramp_all_reduce_time``). The span inputs
    are integer-valued floats >= 1; the constants are the reference's
    Python floats: ``prop_io`` is ``prop + 2 * io`` summed in double, and
    ``data_per_tx`` is ``rate / x``."""
    # every constant is a tensor: a Python float over a tensor divides by
    # the tensor's reciprocal in PyTorch, another rounding than XLA's
    def const(v):
        return torch.full_like(msg, v)

    mem_frequency, peak_flops, bytes_per_comp = 2e12, 130e12, 2.0
    subs = [n_cgs, torch.minimum(n_cgs, n_servers), n_racks,
            torch.ceil(n_servers / const(x))]
    msg_sizes = [torch.ceil(msg / subs[0])]
    for sub in subs[1:]:
        msg_sizes.append(torch.ceil(msg_sizes[-1] / sub))
    zero = const(0.0)
    comm = const(0.0)
    comp = const(0.0)
    for step, sub in enumerate(subs):
        live = sub > 1
        safe_sub = torch.where(live, sub, const(2.0))
        n_op = _ceil_log2(safe_sub)
        n_bytes = (safe_sub + 1) * const(bytes_per_comp)
        ai = n_op / n_bytes
        total_ops = n_op * (msg_sizes[step] * safe_sub / safe_sub) \
            / const(bytes_per_comp)
        add_t = total_ops / torch.minimum(const(mem_frequency) * ai,
                                          const(peak_flops))
        comp = comp + torch.where(live, add_t, zero)
        spare = torch.minimum(const(float(np.floor(x))),
                              torch.floor(const(x) / (safe_sub - 1))) - 1.0
        bw = (1.0 + spare) * const(data_per_tx)
        comm = comm + torch.where(live, const(prop_io)
                                  + msg_sizes[step] / bw, zero)
    return 2 * comm + comp


def _scatter_any(shape, index: torch.Tensor, src: torch.Tensor
                 ) -> torch.Tensor:
    """``zeros(shape, bool).at[index].max(src)`` along the last axis."""
    out = torch.zeros(shape, dtype=torch.uint8, device=src.device)
    return out.scatter_reduce(-1, index.long(), src.to(torch.uint8),
                              "amax").bool()


def _span_counts(present: torch.Tensor, st: ShapeTables, dtype):
    """Distinct (s, r, c) component counts among present servers;
    ``present`` [..., n_srv] bool."""
    C, R, S = st.ramp_shape
    codes = torch.arange(C * R * S, device=present.device)
    out = []
    for comp_of, n_comp in ((codes % S, S), ((codes // S) % R, R),
                            (codes // (R * S), C)):
        onehot = torch.nn.functional.one_hot(comp_of, n_comp).bool()
        hit = (present[..., :, None] & onehot).any(-2)
        out.append(hit.sum(-1).to(dtype))
    return out


def _fma64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """``a * b + c`` in float64 with (all but never) one rounding: the
    product's error from Dekker's split, the sum's from TwoSum. Where the
    product or ``c`` is not finite the fused result is the plain one (an
    infinity or NaN; the error terms would be NaN)."""
    p = a * b
    split = 134217729.0  # 2**27 + 1

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    ah, al = halves(a)
    bh, bl = halves(b)
    p_err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    s_err = (p - (s - bb)) + (c - bb)
    return torch.where(torch.isfinite(p) & torch.isfinite(c),
                       s + (s_err + p_err), s)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    if a.dtype == torch.float32:
        return lookahead_mod.fma32(a, b, c)
    return _fma64(a, b, c)


def _score(pri: torch.Tensor, n: torch.Tensor, rank: torch.Tensor):
    """``pri * (n + 1) + (n - rank)``, as the reference's XLA program
    computes it: in float32 one fused multiply-add (the product passes
    2**24 at M = 13,072 deps), in float64 a product and a sum."""
    if pri.dtype == torch.float32:
        return lookahead_mod.fma32(pri, n + 1, n - rank)
    return pri * (n + 1) + (n - rank)


def srpt_dep_ranks(times: torch.Tensor, dep_valid: torch.Tensor
                   ) -> torch.Tensor:
    """Each dep's place in one stable ascending sort of the key -time
    (+inf where not valid) over all M slots of its lane: the reference's
    SRPT order, descending cost, edge order breaking ties, -0.0 equal to
    0.0 and NaN last. ``times`` [B, M] (raw, before the mount), float
    ranks of its type."""
    lanes, m = times.shape
    key = torch.where(dep_valid, -times, torch.full_like(times, np.inf))
    order = torch.sort(key, dim=1, stable=True).indices
    return torch.zeros_like(times).scatter_(
        1, order, torch.arange(m, dtype=times.dtype,
                               device=times.device).expand(
            lanes, m).contiguous())


def dep_scores(times: torch.Tensor, dep_valid: torch.Tensor,
               is_flow: torch.Tensor, n_deps: torch.Tensor,
               sorted_rank: torch.Tensor) -> torch.Tensor:
    """The deps' SRPT lookahead scores ``pri * (m + 1) + (m - rank)``:
    ``pri`` the ``srpt_dep_ranks`` place of a flow (0 elsewhere), ``m``
    the lane's ``n_deps`` [B], ``rank`` the config's ``dep_sorted_rank``
    [B, M]."""
    zero = torch.zeros((), dtype=times.dtype, device=times.device)
    pri = torch.where(is_flow, srpt_dep_ranks(times, dep_valid), zero)
    m = n_deps.to(times.dtype)[:, None]
    return _score(pri, m, sorted_rank.to(times.dtype))


def price_and_score_plain(ots: torch.Tensor, cfg: torch.Tensor,
                          dev: DeviceTables):
    """K24's plain version: ``jax_price_and_score`` :606 for every lane at
    once."""
    st, pads = dev.st, dev.pads
    C, R, S = st.ramp_shape
    n_srv = C * R * S
    M = pads.n_deps
    lanes = ots.shape[0]
    device, dt = ots.device, dev.dtype
    T = dev.t
    cm = dev.comm
    c = cfg.long()
    inv_rate = float(1 / torch.tensor(cm["rate"], dtype=dt))
    codes = torch.arange(n_srv, device=device)
    c_of, r_of, s_of = codes // (R * S), (codes // S) % R, codes % S
    ar = torch.arange(lanes, device=device)[:, None]
    zero = torch.zeros((), dtype=dt, device=device)

    dep_valid, dep_size = T["dep_valid"][c], T["dep_size"][c]
    scp = ots.clamp(min=0).long()
    sc_src = scp.gather(1, T["dep_src"][c].clamp(min=0).long())
    sc_dst = scp.gather(1, T["dep_dst"][c].clamp(min=0).long())
    is_flow = dep_valid & (dep_size > 0) & (sc_src != sc_dst)
    times = torch.zeros((lanes, M + 1), dtype=dt, device=device)

    def o2o_time(same, size):
        # XLA turns ``prop + 2 io + size / rate`` into one fused
        # multiply-add by the constant's reciprocal, in float32 and float64
        return torch.where(same | (size == 0), zero,
                           _fma(size, torch.full_like(size, inv_rate),
                                torch.full_like(size, cm["prop_io"])))

    def reduce_time(msg, cnt_s, cnt_r, cnt_c):
        return all_reduce_time(msg, cnt_s, cnt_r, cnt_c, x=cm["x"],
                               rate=cm["rate"], prop_io=cm["prop_io"],
                               data_per_tx=cm["data_per_tx"])

    # candidate collective groups, symmetry-tested
    grp_edges, grp_ev = T["grp_edges"][c], T["grp_edge_valid"][c]
    lanes_, G, Eg = grp_edges.shape
    u_codes = scp.gather(1, T["grp_u"][c].clamp(min=0).reshape(
        lanes, -1).long()).reshape(lanes, G, Eg)
    v_codes = scp.gather(1, T["grp_v"][c].clamp(min=0).reshape(
        lanes, -1).long()).reshape(lanes, G, Eg)
    sentinel = n_srv + 1
    u_sorted = torch.where(grp_ev, u_codes, sentinel).sort(-1).values
    v_sorted = torch.where(grp_ev, v_codes, sentinel).sort(-1).values
    symmetric = (u_sorted == v_sorted).all(-1) & T["grp_valid"][c]
    both = torch.cat([u_codes, v_codes], -1)
    both_valid = torch.cat([grp_ev, grp_ev], -1)
    present = _scatter_any((lanes, G, n_srv), both.clamp(0, n_srv - 1),
                           both_valid)
    n_in_group = present.sum(-1)
    cnt_s, cnt_r, cnt_c = _span_counts(present, st, dt)
    one = torch.ones((), dtype=dt, device=device)
    grp_time = reduce_time(T["grp_msg"][c], torch.maximum(cnt_s, one),
                           torch.maximum(cnt_r, one),
                           torch.maximum(cnt_c, one))
    grp_time = torch.where(n_in_group <= 1, zero, grp_time)
    e_size = dep_size.gather(1, grp_edges.clamp(min=0).reshape(
        lanes, -1).long()).reshape(lanes, G, Eg)
    e_val = torch.where(symmetric[..., None], grp_time[..., None],
                        o2o_time(u_codes == v_codes, e_size))
    idx = torch.where(grp_ev, grp_edges, M).reshape(lanes, -1).long()
    times[ar, idx] = e_val.reshape(lanes, -1)

    # sync pairs: always collectives, 2 servers or same-server zero
    sync_edges = T["sync_edges"][c]
    su = scp.gather(1, T["sync_u"][c].clamp(min=0).long())
    sv_ = scp.gather(1, T["sync_v"][c].clamp(min=0).long())
    two = torch.full((), 2.0, dtype=dt, device=device)

    def cnt(of):
        return torch.where(of[su] == of[sv_], one, two)

    sync_time = reduce_time(T["sync_msg"][c], cnt(s_of), cnt(r_of),
                            cnt(c_of))
    sync_time = torch.where(su == sv_, zero, sync_time)
    sv = T["sync_valid"][c][..., None] & (sync_edges >= 0)
    idx = torch.where(sv, sync_edges, M).reshape(lanes, -1).long()
    times[ar, idx] = sync_time[..., None].expand(-1, -1, 2).reshape(
        lanes, -1)

    # static one-to-one edges
    o2o_edges = T["o2o_edges"][c].clamp(min=0).long()
    o_val = o2o_time(sc_src.gather(1, o2o_edges) == sc_dst.gather(
        1, o2o_edges), dep_size.gather(1, o2o_edges))
    idx = torch.where(T["o2o_valid"][c], T["o2o_edges"][c], M).long()
    times[ar, idx] = o_val
    times = times[:, :M]
    # the cluster zeroes non-flow dep run times at mount; SRPT ranks the
    # raw priced times (the schedulers run before the mount)
    mounted = torch.where(is_flow, times, zero)

    dep_score = dep_scores(times, dep_valid, is_flow, T["n_deps"][c],
                           T["dep_sorted_rank"][c])

    # SRPT op priorities: per worker, compute cost descending, insertion
    # order breaking ties
    op_valid, op_cost, ins = (T["op_valid"][c], T["op_compute"][c],
                              T["insertion_rank"][c])
    same = (ots[:, :, None] == ots[:, None, :]) & (ots[:, :, None] >= 0)
    before = (op_cost[:, None, :] > op_cost[:, :, None]) | (
        (op_cost[:, None, :] == op_cost[:, :, None])
        & (ins[:, None, :] < ins[:, :, None]))
    op_pri = (same & before & op_valid[:, None, :]).sum(2).to(dt)
    n = T["n_ops"][c].to(dt)[:, None]
    op_score = _score(op_pri, n, T["op_sorted_rank"][c].to(dt))

    # channels (single-channel complete topology: the direct link)
    chan = torch.where(is_flow, dev.pair_channel[sc_src, sc_dst], -1)
    finite_ok = torch.isfinite(mounted).all(1)
    return (mounted, is_flow, chan.to(torch.int32), op_score, dep_score,
            finite_ok)


def price_cluster(lanes: int, dev: DeviceTables) -> int:
    """The cluster size K24 takes for ``lanes`` lanes of ``dev``'s tables
    on the current card (``kernels.choose_cluster`` over its SMs and the
    clusters of each size it runs at once)."""
    pads = dev.pads
    C, R, S = dev.st.ramp_shape
    f64 = int(dev.dtype == torch.float64)
    return kernels.choose_cluster(
        lanes, kernels.sm_count(),
        lambda g: kernels.cached_query(
            "pricing", "ddls_price_and_score_clusters", pads.n_ops,
            pads.n_deps, pads.n_groups, pads.group_edges, pads.n_sync,
            pads.n_o2o, C, R, S, g, f64))


def price_and_score(ots: torch.Tensor, cfg: torch.Tensor,
                    dev: DeviceTables, cluster: Optional[int] = None):
    """K24: price every dep of each lane's placed job and build the SRPT
    lookahead scores. ``ots`` [B, N] int32 server codes (-1 unplaced),
    ``cfg`` [B] int32. Returns ``(times [B, M] (zero where not a flow),
    is_flow [B, M] bool, chan [B, M] int32 (-1 where not a flow),
    op_score [B, N], dep_score [B, M], finite_ok [B] bool)``. On the card
    each lane runs on a cluster of ``price_cluster`` CTAs, or of
    ``cluster`` (1-16) where given; the answer is the same at every
    size. The kernel prices and ranks each lane's valid prefixes
    ([0, n_deps), [0, n_ops) of its config: ``stack_config_tables``'s
    layout)."""
    if kernels.on_cpu(ots, cfg):
        return price_and_score_plain(ots, cfg, dev)
    pads = dev.pads
    lanes = ots.shape[0]
    N, M = pads.n_ops, pads.n_deps
    kernels.check_cuda("ots", ots, torch.int32, (lanes, N))
    kernels.check_cuda("cfg", cfg, torch.int32, (lanes,))
    device, dt = ots.device, dev.dtype
    times = torch.empty((lanes, M), dtype=dt, device=device)
    is_flow = torch.empty((lanes, M), dtype=torch.bool, device=device)
    chan = torch.empty((lanes, M), dtype=torch.int32, device=device)
    op_score = torch.empty((lanes, N), dtype=dt, device=device)
    dep_score = torch.empty((lanes, M), dtype=dt, device=device)
    finite_ok = torch.empty(lanes, dtype=torch.bool, device=device)
    T, cm = dev.t, dev.comm
    C, R, S = dev.st.ramp_shape
    if lanes:
        g = cluster if cluster is not None else price_cluster(lanes, dev)
        if not 1 <= g <= kernels.MAX_CLUSTER:
            raise ValueError(f"cluster must be 1-{kernels.MAX_CLUSTER}, "
                             f"got {g}")
        kernels.launch(
            "price_and_score", ots.data_ptr(), cfg.data_ptr(),
            *(T[k].data_ptr() for k in PRICING_TABLES),
            dev.pair_channel.data_ptr(), times.data_ptr(),
            is_flow.data_ptr(), chan.data_ptr(), op_score.data_ptr(),
            dep_score.data_ptr(), finite_ok.data_ptr(), lanes, N, M,
            pads.n_groups, pads.group_edges, pads.n_sync, pads.n_o2o, C, R,
            S, g, ctypes.c_double(cm["x"]), ctypes.c_double(cm["rate"]),
            ctypes.c_double(cm["prop_io"]),
            ctypes.c_double(cm["data_per_tx"]),
            int(dt == torch.float64))
    return times, is_flow, chan, op_score, dep_score, finite_ok


# the tables K24 reads, in its argument order
PRICING_TABLES = ("n_ops", "n_deps", "op_valid", "op_compute",
                  "op_sorted_rank", "insertion_rank", "dep_valid", "dep_src",
                  "dep_dst", "dep_size", "dep_sorted_rank", "grp_valid",
                  "grp_edges", "grp_u", "grp_v", "grp_edge_valid", "grp_msg",
                  "sync_valid", "sync_edges", "sync_u", "sync_v", "sync_msg",
                  "o2o_valid", "o2o_edges")


# =========================================================================
# The episode: decisions, the commit and the event clock (K25).
# =========================================================================

# the per-lane state, in K25's argument order (dtypes: None = the float
# type); the trace buffers follow it
STATE_FIELDS = (
    ("t", None), ("mem", None), ("srv_job", torch.int32),
    ("chan_occ", torch.int32), ("slot_valid", torch.bool),
    ("slot_t_done", None), ("slot_mem", None), ("slot_servers", torch.bool),
    ("slot_chan", torch.bool), ("queue_row", torch.int32),
    ("ptr", torch.int32), ("next_arrival", None), ("done", torch.bool),
    ("completed", torch.int32), ("accepted", torch.int32),
    ("blocked", torch.int32), ("ret", None), ("cfg", torch.int32),
    ("active", torch.bool), ("ticks", torch.int32))
TRACE_FIELDS = (("reward", None), ("accept", torch.bool),
                ("cause", torch.int32), ("jct", None), ("t", None),
                ("has_job", torch.bool))
BANK_FIELDS = (("type", torch.int32), ("steps", None), ("sla_frac", None),
               ("arrival_t", None))
_INF = float("inf")


# the failure walk's branches ``scenario_adjusted`` counts: per affected
# window, one that ended by the start or the current completion, one that
# begins at or after the completion, a preemption's push, a straggler that
# fits or spills; per lane ``r0 != 1``, an empty server mask (``r0 =
# inf``) and a zero or infinite nominal
WALK_BRANCHES = ("preempt_push", "straggle_fit", "straggle_spill",
                 "window_before", "window_after", "r0_not_1", "empty_mask",
                 "zero_nominal", "infinite_nominal")


def _count(branches: dict, **masks) -> None:
    for name, mask in masks.items():
        branches[name] = branches.get(name, 0) + mask.sum()


def scenario_adjusted(sc: dict, t: torch.Tensor, jct: torch.Tensor,
                      srv_mask: torch.Tensor, chan_mask: torch.Tensor,
                      branches: Optional[dict] = None) -> torch.Tensor:
    """The failure walk (K25's scenario mode, plain): each lane's
    completion time under the scenario ``sc`` (``DeviceTables.scenario``)
    for a job of nominal duration ``jct`` [B] starting at ``t`` [B] on the
    servers ``srv_mask`` [B, n_srv] and channels ``chan_mask`` [B,
    n_chan] (reference: ``scenario_adjusted`` :1014 over
    ``inflate_duration_jax``, the same expressions in the same order).
    ``r0`` is the slowest mounted server's speed (inf on an empty mask);
    then, over the t0-sorted windows, an affected window that overlaps the
    remaining run either holds it to its rate (a preemption pushes it
    past the window; a straggler's run fits inside it or spills past its
    end). The divisor guard repeats the reference's ``where(r > 0, r,
    1)``, so the branch not taken makes no NaN. Given ``branches``, adds
    to it, from the walk's own masks, how many lanes or windows took each
    of ``WALK_BRANCHES`` (0-d tensors on the lanes' device)."""
    inf = torch.full_like(sc["speeds"], _INF)
    r0 = torch.where(srv_mask, sc["speeds"], inf).amin(1)
    t_done = t + jct / r0
    if branches is not None:
        _count(branches, r0_not_1=torch.isfinite(r0) & (r0 != 1),
               empty_mask=torch.isinf(r0), zero_nominal=jct == 0,
               infinite_nominal=torch.isinf(jct))
    one = torch.ones((), dtype=t.dtype, device=t.device)
    for i, (kind, res) in enumerate(sc["windows"]):
        w0, w1, r = sc["t0"][i], sc["t1"][i], sc["rate"][i]
        lo = torch.maximum(w0, t)
        affects = (srv_mask[:, res] if kind == FAILURE_WORKER_PREEMPT
                   else chan_mask[:, res])
        overlap = affects & (lo < w1) & (t_done > lo)
        remaining = t_done - lo
        span = w1 - lo
        cap = r * span
        fits = (r > 0) & (remaining <= cap)
        t_new = torch.where(fits,
                            lo + remaining / torch.where(r > 0, r, one),
                            w1 + (remaining - cap))
        if branches is not None:
            _count(branches, window_before=affects & ~(lo < w1),
                   window_after=affects & (lo < w1) & ~(t_done > lo),
                   preempt_push=overlap & (r == 0),
                   straggle_fit=overlap & fits,
                   straggle_spill=overlap & ~fits & (r > 0))
        t_done = torch.where(overlap, t_new, t_done)
    return t_done - t


def _ordered_sum(mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``mask.astype(dt) @ rows`` over the slot axis, summed in slot order
    (the masked rows only; ``mask`` [B, R] bool, ``rows`` [B, R, n]). Any
    order gives XLA's bits: a server belongs to at most one slot, so a
    column sums at most one nonzero row (held on a recorded tick of four
    completions, ``scenario_recorded.npz`` ``c1/``)."""
    acc = torch.zeros_like(rows[:, 0])
    for r in range(rows.shape[1]):
        acc = acc + torch.where(mask[:, r, None], rows[:, r],
                                torch.zeros_like(acc))
    return acc


class EpisodeKernels:
    """The decision, the event clock and the initial state of the device
    episode on ``dev``'s device (reference: ``_episode_kernels`` :974),
    for a batch of lanes. Every function takes and updates the lane-batched
    ``state`` dict (``STATE_FIELDS``) and the ``bank`` dict of [B, J]
    tensors (``BANK_FIELDS``; ``arrival_t`` [B, J + 1])."""

    def __init__(self, dev: DeviceTables):
        self.dev = dev
        et = dev.et
        self.R = et.n_srv  # max concurrent jobs: each owns >= 1 server

    # ---- the state -----------------------------------------------------
    def init_state(self, bank: dict,
                   actions: Optional[torch.Tensor] = None) -> dict:
        """Job 0 queued at t = 0 and every server free (the reference's
        ``init_state``), then, given ``actions`` [B, D], decision 0's
        config row."""
        lanes = bank["type"].shape[0]
        kw = dict(device=self.dev.device)
        state = self.fresh_state(bank)
        for name in ("cfg", "ticks"):
            state[name] = torch.zeros(lanes, dtype=torch.int32, **kw)
        state["active"] = torch.zeros(lanes, dtype=torch.bool, **kw)
        if actions is not None:
            self.prepare(state, bank, actions[:, 0])
        return {name: state[name] for name, _ in STATE_FIELDS}

    def prepare(self, state: dict, bank: dict, action: torch.Tensor):
        """The next decision's config row ``cfg = type[row] * n_deg +
        deg_col[action]`` and whether it evaluates one (``active``: a job
        is queued and the action is a degree of the table), on the device
        (clamped into the table for the other lanes)."""
        dev = self.dev
        has_job = (state["queue_row"] >= 0) & ~state["done"]
        row = state["queue_row"].clamp(min=0).long()
        col = dev.deg_col[action.clamp(0, dev.deg_col.shape[0] - 1).long()]
        jtype = bank["type"].gather(1, row[:, None])[:, 0]
        state["cfg"] = (jtype * dev.n_deg + col).clamp(
            0, dev.n_cfg - 1).to(torch.int32)
        state["active"] = has_job & (action > 0) & (col >= 0)

    # ---- one candidate ---------------------------------------------------
    def evaluate(self, state: dict, memo: Optional[dict] = None,
                 memo_trace: Optional[dict] = None, d: int = 0) -> dict:
        """Placement (K23), pricing (K24) and the lookahead (K21, lanes
        that decide nothing skipped) of each lane's ``cfg`` against its
        cluster state: the kernels' raw outputs. With ``memo`` (a
        ``device_memo.memo_init`` table) the lookahead runs under the memo
        (reference: ``eval_cfg`` :1064-1070): K27 probes before K21 and
        skips its hit lanes, K28 serves them and inserts the misses (and,
        with ``memo_trace``, writes the memo counters into column
        ``d``)."""
        dev = self.dev
        cfg = state["cfg"]
        ots, new_mem, ok_place = allocate_job(
            state["mem"], state["srv_job"] < 0, cfg, dev)
        times, is_flow, chan, op_score, dep_score, finite_ok = \
            price_and_score(ots, cfg, dev)
        ticks = torch.empty(cfg.shape[0], dtype=torch.int32,
                            device=cfg.device)

        def compute(skip):
            return lookahead_mod.lookahead_indexed(
                cfg, ots, op_score, times, is_flow, dep_score, chan, dev.t,
                num_workers=dev.et.n_srv, num_channels=dev.et.n_chan,
                ticks=ticks, skip=skip)

        if memo is None:
            t_step, _, _, _, ok_la = compute(~state["active"])
        else:
            t_step, _, _, _, ok_la = device_memo.memo_lookahead(
                memo, cfg, state["active"], ots, dev.t["op_valid"], times,
                dev.et.n_srv, compute, memo_trace, d)
        return {"ots": ots, "new_mem": new_mem, "ok_place": ok_place,
                "times": times, "is_flow": is_flow, "chan": chan,
                "op_score": op_score, "dep_score": dep_score,
                "finite_ok": finite_ok, "t_step": t_step, "ok_la": ok_la,
                "ticks": ticks}

    def price_rows(self, state: dict, bank: dict) -> dict:
        """``price_all`` up to K29: every degree column ``j`` of each
        lane's queued job (config ``type * n_deg + j``) evaluated against
        that lane's live state with no commit, as B * n_deg rows: K23
        (each row reading its lane's memory and occupancy through the
        state-lane index), K24 and K21 without the memo (the reference's
        pricing is memo-less; the rows of lanes with no queued job
        skipped). Returns K23's inputs (``cfg``, ``state_lane``, ``free``)
        and outputs (``alloc``) and K29's row inputs (``reduce``)."""
        dev = self.dev
        n_deg = dev.n_deg
        lanes = state["queue_row"].shape[0]
        state_lane = dev.price_lanes.get(lanes)
        if state_lane is None:
            state_lane = dev.price_lanes[lanes] = torch.arange(
                lanes * n_deg, dtype=torch.int32,
                device=dev.device) // n_deg
        row = state["queue_row"].clamp(min=0).long()[:, None]
        cfg = (bank["type"].gather(1, row) * n_deg
               + dev.deg_arange).reshape(-1)
        free = state["srv_job"] < 0
        ots, new_mem, ok_place = allocate_job(state["mem"], free, cfg, dev,
                                              state_lane)
        times, is_flow, chan, op_score, dep_score, finite_ok = \
            price_and_score(ots, cfg, dev)
        has_job = (state["queue_row"] >= 0) & ~state["done"]
        t_step, _, _, _, ok_la = lookahead_mod.lookahead_indexed(
            cfg, ots, op_score, times, is_flow, dep_score, chan, dev.t,
            num_workers=dev.et.n_srv, num_channels=dev.et.n_chan,
            skip=~has_job.repeat_interleave(n_deg))
        return {"cfg": cfg, "state_lane": state_lane, "free": free,
                "alloc": (ots, new_mem, ok_place),
                "reduce": (is_flow, chan, ok_place, finite_ok, t_step,
                           ok_la)}

    def price_all(self, state: dict, bank: dict, hold=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """In-kernel candidate pricing (reference: ``price_all`` :1085):
        ``price_rows``, then K29. Returns ``(ok [B, n_deg] bool, jct [B,
        n_deg])``: ok where the candidate places, finds free channels,
        converges and prices finitely; jct its lookahead time times the
        job's training steps (ok False and jct 0 on lanes with no queued
        job). ``hold(name, got, kernel, plain)``, where given, is called
        with K23's (``"allocate_job_indexed"``) and K29's outputs and
        callables of the kernel and of its plain version on the call's own
        inputs (``functools.partial`` objects: ``kernel.args`` are the
        call's arguments)."""
        rows = self.price_rows(state, bank)
        args = rows["reduce"] + (state, bank)
        prefix = (rows["cfg"], self.dev.t["n_deps"])
        ok, jct = price_reduce(*args, *prefix)
        if hold is not None:
            alloc = (state["mem"], rows["free"], rows["cfg"], self.dev,
                     rows["state_lane"])
            hold("allocate_job_indexed", rows["alloc"],
                 functools.partial(allocate_job, *alloc),
                 functools.partial(allocate_job_plain, *alloc))
            hold("price_reduce", (ok, jct),
                 functools.partial(price_reduce, *args, *prefix),
                 functools.partial(price_reduce_plain, *args))
        return ok, jct

    def eval_cfg(self, state: dict, bank: dict, raw: dict) -> dict:
        """The reference's ``eval_cfg`` outputs from ``evaluate``'s: the
        channel check, the SLA gate and the masks a commit writes."""
        dev = self.dev
        c = state["cfg"].long()
        row = state["queue_row"].clamp(min=0).long()[:, None]
        steps = bank["steps"].gather(1, row)[:, 0]
        sla = bank["sla_frac"].gather(1, row)[:, 0]
        is_flow, chan, ots = raw["is_flow"], raw["chan"], raw["ots"]
        occ = state["chan_occ"].gather(1, chan.clamp(min=0).long())
        ok_chan = (~is_flow | (occ < 0)).all(1)
        jct = raw["t_step"] * steps
        max_jct = sla * dev.t["seq_compute"][c] * steps
        sla_ok = ~(jct > max_jct)
        placed = dev.t["op_valid"][c] & (ots >= 0)
        srv_mask = _scatter_any(state["srv_job"].shape,
                                ots.clamp(min=0).long(), placed)
        chan_mask = _scatter_any(state["chan_occ"].shape,
                                 chan.clamp(min=0).long(), is_flow)
        return {"ok_place": raw["ok_place"], "ok_chan": ok_chan,
                "engine_ok": raw["ok_la"] & raw["finite_ok"],
                "sla_ok": sla_ok, "jct": jct, "new_mem": raw["new_mem"],
                "srv_mask": srv_mask, "chan_mask": chan_mask}

    # ---- the commit and the event clock (K25's plain halves) ----------
    def decision(self, state: dict, bank: dict, raw: dict,
                 trace: dict, d: int,
                 branches: Optional[dict] = None) -> None:
        """The SLA gate, the cause code and the masked commit into the
        first free slot (reference: ``decision`` :1105 and the episode's
        ``scan_body`` :1269); writes decision ``d`` of ``trace``. With a
        scenario, ``branches`` (if given) counts the failure walk's
        branches (``scenario_adjusted``)."""
        dev, et = self.dev, self.dev.et
        dt = dev.dtype
        ev = self.eval_cfg(state, bank, raw)
        has_job = (state["queue_row"] >= 0) & ~state["done"]
        # the reference's action_ok (and a queued job: the rest is gated
        # by has_job below)
        action_ok = state["active"]
        accept = (ev["ok_place"] & ev["ok_chan"] & ev["sla_ok"]
                  & ev["engine_ok"])
        cause = torch.where(
            ~ev["ok_place"], CAUSE_OP_PLACEMENT,
            torch.where(~ev["ok_chan"], CAUSE_DEP_PLACEMENT,
                        torch.where(~ev["engine_ok"], CAUSE_ENGINE,
                                    torch.where(~ev["sla_ok"], CAUSE_SLA,
                                                CAUSE_ACCEPTED))))
        zero = torch.zeros((), dtype=dt, device=dev.device)
        accept = accept & action_ok
        cause = torch.where(action_ok, cause, CAUSE_NOT_HANDLED)
        jct = torch.where(action_ok, ev["jct"], zero)
        mem = state["mem"]
        new_mem = torch.where(action_ok[:, None], ev["new_mem"], mem)
        srv_mask = ev["srv_mask"] & action_ok[:, None]
        chan_mask = ev["chan_mask"] & action_ok[:, None]
        t = state["t"]
        if dev.scenario is not None:
            # inflate AFTER the accept/cause decision: admission is
            # failure-blind (reference: :1138-1141)
            jct = scenario_adjusted(dev.scenario, t, jct, srv_mask,
                                    chan_mask, branches)

        slot_valid = state["slot_valid"]
        slot = slot_valid.to(torch.int8).argmin(1)  # the first free slot
        accept = accept & ~slot_valid.all(1) & has_job
        ar = torch.arange(slot.shape[0], device=dev.device)
        delta = mem - new_mem
        a1 = accept[:, None]
        state["mem"] = torch.where(a1, new_mem, mem)
        state["srv_job"] = torch.where(a1 & srv_mask, slot[:, None].int(),
                                       state["srv_job"])
        state["chan_occ"] = torch.where(a1 & chan_mask,
                                        slot[:, None].int(),
                                        state["chan_occ"])
        state["slot_valid"][ar, slot] |= accept
        state["slot_t_done"][ar, slot] = torch.where(
            accept, t + jct, state["slot_t_done"][ar, slot])
        state["slot_mem"][ar, slot] = torch.where(
            a1, delta, state["slot_mem"][ar, slot])
        state["slot_servers"][ar, slot] = torch.where(
            a1, srv_mask, state["slot_servers"][ar, slot])
        state["slot_chan"][ar, slot] = torch.where(
            a1, chan_mask, state["slot_chan"][ar, slot])
        reward = torch.where(accept, et.success_reward,
                             et.fail_reward).to(dt)
        reward = torch.where(has_job, reward, zero)
        state["accepted"] += (has_job & accept).int()
        state["blocked"] += (has_job & ~accept).int()
        state["ret"] = state["ret"] + reward
        state["queue_row"] = torch.where(has_job, -1, state["queue_row"])
        state["ticks"] += torch.where(state["active"], raw["ticks"], 0)
        trace["reward"][:, d] = reward
        trace["accept"][:, d] = accept
        trace["cause"][:, d] = torch.where(has_job, cause, -1)
        trace["jct"][:, d] = torch.where(has_job, jct, zero)
        trace["t"][:, d] = t
        trace["has_job"][:, d] = has_job

    def advance(self, state: dict, bank: dict) -> None:
        """Tick the event clock until a job queues or the episode ends
        (reference: ``advance`` :1165): completions free memory, servers
        and channels; arrivals queue the next job."""
        dev, et = self.dev, self.dev.et
        dt = dev.dtype
        kw = dict(dtype=dt, device=dev.device)
        J = bank["type"].shape[1]
        sim_end = torch.tensor(et.sim_end, **kw)
        eps = torch.tensor(et.eps, **kw)
        inf = torch.tensor(_INF, **kw)
        zero = torch.zeros((), **kw)
        while True:
            live = (state["queue_row"] < 0) & ~state["done"]
            if not bool(live.any()):
                return
            t = state["t"]
            slot_valid, slot_t_done = state["slot_valid"], state["slot_t_done"]
            remaining = torch.where(slot_valid, slot_t_done - t[:, None], inf)
            tick = torch.minimum(torch.minimum(state["next_arrival"] - t,
                                               sim_end - t),
                                 remaining.amin(1))
            tick = torch.maximum(tick, zero)
            t2 = t + tick
            completions = slot_valid & (slot_t_done - t2[:, None] - eps <= 0)
            completions &= live[:, None]
            mem2 = state["mem"] + _ordered_sum(completions,
                                               state["slot_mem"])
            freed_srv = (completions[:, :, None]
                         & state["slot_servers"]).any(1)
            freed_chan = (completions[:, :, None]
                          & state["slot_chan"]).any(1)
            ptr, queue_row = state["ptr"], state["queue_row"]
            arrived = live & (ptr < J) & (t2 + eps >= state["next_arrival"])
            queue_row2 = torch.where(arrived, ptr, queue_row)
            ptr2 = ptr + arrived.int()
            nxt = bank["arrival_t"].gather(
                1, ptr2.clamp(0, J).long()[:, None])[:, 0]
            slot_valid2 = slot_valid & ~completions
            done2 = (t2 >= sim_end) | ((ptr2 >= J) & ~slot_valid2.any(1)
                                       & (queue_row2 < 0))
            state["t"] = torch.where(live, t2, t)
            state["mem"] = torch.where(live[:, None], mem2, state["mem"])
            state["srv_job"] = torch.where(freed_srv, -1, state["srv_job"])
            state["chan_occ"] = torch.where(freed_chan, -1,
                                            state["chan_occ"])
            state["slot_valid"] = slot_valid2
            state["completed"] = state["completed"] + completions.sum(
                1).int()
            state["queue_row"] = queue_row2
            state["ptr"] = ptr2
            state["next_arrival"] = torch.where(arrived, nxt,
                                                state["next_arrival"])
            state["done"] = torch.where(live, done2, state["done"])

    def finish(self, state: dict, bank: dict, d: int,
               seg_trace: Optional[dict], fields: Optional[dict],
               reset: bool) -> None:
        """After the event clock (reference: the segment's ``scan_body``
        :1690-1724): the episode counters into column ``d`` of
        ``seg_trace`` (``SEGMENT_TRACE_FIELDS``; ``ep_blocked`` counts the
        jobs still running where the episode ended), with ``reset`` an
        ended lane's state replaced by its fresh one (the memo is not part
        of the state), then the next step's observation fields into
        column ``d + 1`` of ``fields`` (``OBS_FIELDS``)."""
        ended = state["done"].clone()
        if seg_trace is not None:
            running = state["slot_valid"].sum(1).to(torch.int32)
            seg_trace["done"][:, d] = ended
            seg_trace["ep_accepted"][:, d] = state["accepted"]
            seg_trace["ep_blocked"][:, d] = state["blocked"] + torch.where(
                ended, running, 0)
            seg_trace["ep_return"][:, d] = state["ret"]
            seg_trace["ep_completed"][:, d] = state["completed"]
            seg_trace["ep_arrived"][:, d] = state["ptr"]
        if reset:
            fresh = self.fresh_state(bank)
            for name in RESET_FIELDS:
                x = state[name]
                cond = ended.reshape((-1,) + (1,) * (x.dim() - 1))
                state[name] = torch.where(cond, fresh[name], x)
        if fields is not None:
            for name, value in obs_fields(state, bank).items():
                fields[name][:, d + 1] = value

    def fresh_state(self, bank: dict) -> dict:
        """Every lane's initial state (``RESET_FIELDS``): job 0 queued at
        t = 0, every server free, the counters zero."""
        dev, et = self.dev, self.dev.et
        lanes = bank["type"].shape[0]
        kw = dict(device=dev.device)
        dt = dev.dtype
        R = self.R
        state = {
            "t": torch.zeros(lanes, dtype=dt, **kw),
            "mem": torch.full((lanes, et.n_srv), et.worker_mem, dtype=dt,
                              **kw),
            "srv_job": torch.full((lanes, et.n_srv), -1, dtype=torch.int32,
                                  **kw),
            "chan_occ": torch.full((lanes, et.n_chan), -1,
                                   dtype=torch.int32, **kw),
            "slot_valid": torch.zeros((lanes, R), dtype=torch.bool, **kw),
            "slot_t_done": torch.zeros((lanes, R), dtype=dt, **kw),
            "slot_mem": torch.zeros((lanes, R, et.n_srv), dtype=dt, **kw),
            "slot_servers": torch.zeros((lanes, R, et.n_srv),
                                        dtype=torch.bool, **kw),
            "slot_chan": torch.zeros((lanes, R, et.n_chan),
                                     dtype=torch.bool, **kw),
            "queue_row": torch.zeros(lanes, dtype=torch.int32, **kw),
            "ptr": torch.ones(lanes, dtype=torch.int32, **kw),
            "next_arrival": bank["arrival_t"][:, 1].clone(),
            "done": torch.zeros(lanes, dtype=torch.bool, **kw),
        }
        for name in ("completed", "accepted", "blocked"):
            state[name] = torch.zeros(lanes, dtype=torch.int32, **kw)
        state["ret"] = torch.zeros(lanes, dtype=dt, **kw)
        return state


def episode_step_plain(ek: EpisodeKernels, state: dict, bank: dict,
                       actions: Optional[torch.Tensor], raw: dict,
                       trace: dict, d: int, *,
                       seg_trace: Optional[dict] = None,
                       fields: Optional[dict] = None,
                       reset: bool = False,
                       branches: Optional[dict] = None) -> None:
    """K25's plain version: decision ``d``'s commit, the event clock to
    the next decision, the segment's counters, reset and fields
    (``EpisodeKernels.finish``) and, given ``actions``, the next
    decision's config row; ``branches`` as ``EpisodeKernels.decision``
    takes it."""
    ek.decision(state, bank, raw, trace, d, branches)
    ek.advance(state, bank)
    ek.finish(state, bank, d, seg_trace, fields, reset)
    if actions is not None and d + 1 < actions.shape[1]:
        ek.prepare(state, bank, actions[:, d + 1])


# K25's forms (episode.cu): the lane's channel occupancy read from global
# memory instead of staged, and the commit without the shared channel mask
# (the kernel takes each where the surface's shared memory needs it);
# warp 0's slots in memory instead of registers (past 1,024 slots:
# ``episode_slots_a_lane``). A test forces them through
# ``kernels._forcing("episode_step", names)`` (the same bits)
EPISODE_FORMS = {"occ_global": 1, "mask_free": 2, "slot_memory": 0}
# the register blocks of warp 0's slots a lane
EPISODE_SLOT_BLOCKS = (4, 8, 16, 32)


def episode_slots_a_lane(slots: int, memory: bool = False) -> int:
    """K25's warp-0 slots a lane for ``slots`` slots (one a server): lane
    ``i`` owns ``[i K, i K + K)``, K = ceil(slots / 32), held in registers
    in a block of the least of ``EPISODE_SLOT_BLOCKS`` >= K; 0 (the slots
    kept in the lane's state in memory) past 32 x 32 = 1,024 slots or with
    ``memory``."""
    k = -(-slots // 32)
    return 0 if memory else next((b for b in EPISODE_SLOT_BLOCKS if b >= k),
                                 0)
# the scenario's tables K25's scenario mode reads, in its order
SCENARIO_FIELDS = ("speeds", "t0", "t1", "rate", "kind", "res")
# the outputs of EpisodeKernels.evaluate that K25 reads, in its order
_RAW_FIELDS = ("ots", "new_mem", "ok_place", "is_flow", "chan", "finite_ok",
               "t_step", "ok_la", "ticks")
# the segment's per-step episode counters (K25 writes them; dtypes: None =
# the float type) and the state an in-kernel reset restores
SEGMENT_TRACE_FIELDS = (("done", torch.bool), ("ep_accepted", torch.int32),
                        ("ep_blocked", torch.int32), ("ep_return", None),
                        ("ep_completed", torch.int32),
                        ("ep_arrived", torch.int32))
RESET_FIELDS = ("t", "mem", "srv_job", "chan_occ", "slot_valid",
                "slot_t_done", "slot_mem", "slot_servers", "slot_chan",
                "queue_row", "ptr", "next_arrival", "done", "completed",
                "accepted", "blocked", "ret")
# a step's compact observation fields (the reference's ``obs_fields``
# :1656), K26's inputs
OBS_FIELDS = (("jtype", torch.int32), ("frac", None), ("steps", None),
              ("n_occupied", torch.int32), ("n_running", torch.int32))


def obs_fields(state: dict, bank: dict) -> Dict[str, torch.Tensor]:
    """Each lane's observation fields of its queued job and cluster
    (``OBS_FIELDS``, each [B]; reference: ``obs_fields`` :1656)."""
    row = state["queue_row"].clamp(min=0).long()[:, None]
    return {"jtype": bank["type"].gather(1, row)[:, 0],
            "frac": bank["sla_frac"].gather(1, row)[:, 0],
            "steps": bank["steps"].gather(1, row)[:, 0],
            "n_occupied": (state["srv_job"] >= 0).sum(1).to(torch.int32),
            "n_running": state["slot_valid"].sum(1).to(torch.int32)}


def episode_step(ek: EpisodeKernels, state: dict, bank: dict,
                 actions: Optional[torch.Tensor], raw: dict, trace: dict,
                 d: int, *, seg_trace: Optional[dict] = None,
                 fields: Optional[dict] = None, reset: bool = False
                 ) -> None:
    """K25: decision ``d``'s SLA gate, cause code and commit, the event
    clock to the next decision, for every lane, updating ``state`` in
    place and writing decision ``d`` of ``trace`` (tensors as
    ``STATE_FIELDS``, ``TRACE_FIELDS``, ``BANK_FIELDS``; ``raw`` from
    ``EpisodeKernels.evaluate``). Then, for the segment and policy
    episodes: the episode counters into column ``d`` of ``seg_trace``
    (``SEGMENT_TRACE_FIELDS``, [B, D]), with ``reset`` an ended lane's
    state back to its fresh one (the in-kernel reset), and the next step's
    observation fields into column ``d + 1`` of ``fields``
    (``OBS_FIELDS``, [B, D + 1]). Given ``actions`` [B, D] (the replay),
    the next decision's config row; without them the caller runs
    ``episode_prepare`` once the next action is known. With a scenario
    (``DeviceTables.scenario``) the launch is K25's scenario mode, counted
    as ``episode_step_scenario``: the failure walk inflates each deciding
    lane's jct after the gate, before the trace and the commit
    (``scenario_adjusted``). The kernel reads each lane's deps ``[0,
    n_deps[cfg])`` and ops ``[0, n_ops[cfg])`` only: K24 writes every dep
    past the prefix as no flow, and ``op_valid`` is the prefix. It takes
    any number of slots and channels, in the forms (``EPISODE_FORMS``)
    the surface needs."""
    if kernels.on_cpu(state["mem"], raw["ots"]):
        return episode_step_plain(ek, state, bank, actions, raw, trace, d,
                                  seg_trace=seg_trace, fields=fields,
                                  reset=reset)
    dev, et = ek.dev, ek.dev.et
    dt = dev.dtype
    lanes = state["t"].shape[0]
    forms = set(kernels.forced("episode_step", ()))
    J = bank["type"].shape[1]
    D = trace["reward"].shape[1]
    for name, want in STATE_FIELDS:
        kernels.check_cuda(name, state[name], want or dt)
    for name, want in TRACE_FIELDS:
        kernels.check_cuda(f"trace {name}", trace[name], want or dt,
                           (lanes, D))
    for name, want in BANK_FIELDS:
        kernels.check_cuda(f"bank {name}", bank[name], want or dt,
                           (lanes, J + (name == "arrival_t")))
    if actions is not None:
        kernels.check_cuda("actions", actions, torch.int32, (lanes, D))
    if seg_trace is not None:
        for name, want in SEGMENT_TRACE_FIELDS:
            kernels.check_cuda(f"segment trace {name}", seg_trace[name],
                               want or dt, (lanes, D))
    if fields is not None:
        for name, want in OBS_FIELDS:
            kernels.check_cuda(f"fields {name}", fields[name], want or dt,
                               (lanes, D + 1))
    t_step = raw["t_step"]
    if t_step.dtype != dt or t_step.shape != (lanes,):
        raise ValueError("t_step must be the lookahead's [B] times")
    for name in _RAW_FIELDS:
        if name != "t_step":
            kernels.check_cuda(name, raw[name], raw[name].dtype)
    if dev.scenario is not None:
        n_win = len(dev.scenario["windows"])
        for name in SCENARIO_FIELDS:
            want = torch.int32 if name in ("kind", "res") else dt
            kernels.check_cuda(f"scenario {name}", dev.scenario[name], want,
                               (et.n_srv,) if name == "speeds" else (n_win,))
    if not lanes:
        return
    sc = dev.scenario
    kernels.launch(
        "episode_step" if sc is None else "episode_step_scenario",
        *(state[name].data_ptr() for name, _ in STATE_FIELDS),
        *(trace[name].data_ptr() for name, _ in TRACE_FIELDS),
        *(bank[name].data_ptr() for name, _ in BANK_FIELDS),
        kernels.ptr(actions), *(raw[name].data_ptr() for name in _RAW_FIELDS),
        dev.t["op_valid"].data_ptr(), dev.t["seq_compute"].data_ptr(),
        dev.deg_col.data_ptr(), dev.t["n_deps"].data_ptr(),
        dev.t["n_ops"].data_ptr(),
        *(kernels.ptr(seg_trace[name]) if seg_trace is not None else None
          for name, _ in SEGMENT_TRACE_FIELDS),
        *(kernels.ptr(fields[name]) if fields is not None else None
          for name, _ in OBS_FIELDS),
        lanes, et.n_srv, et.n_chan, ek.R,
        dev.pads.n_ops, dev.pads.n_deps, J, D, d, dev.n_deg, dev.n_cfg,
        dev.deg_col.shape[0], t_step.stride(0), int(actions is not None),
        int(reset), ctypes.c_double(et.sim_end),
        ctypes.c_double(et.eps), ctypes.c_double(et.success_reward),
        ctypes.c_double(et.fail_reward), ctypes.c_double(et.worker_mem),
        int(dt == torch.float64),
        *(kernels.ptr(None if sc is None else sc[name])
          for name in SCENARIO_FIELDS),
        0 if sc is None else len(sc["windows"]),
        sum(EPISODE_FORMS[f] for f in forms),
        episode_slots_a_lane(ek.R, "slot_memory" in forms))


def episode_prepare(ek: EpisodeKernels, state: dict, bank: dict,
                    action: torch.Tensor) -> None:
    """K25's prepare half as its own launch: each lane's config row and
    ``active`` flag for ``action`` [B] int32 (the step's sampled action,
    on the device), as ``EpisodeKernels.prepare``."""
    if kernels.on_cpu(state["cfg"], action):
        return ek.prepare(state, bank, action)
    dev = ek.dev
    lanes = state["cfg"].shape[0]
    J = bank["type"].shape[1]
    kernels.check_cuda("action", action, torch.int32, (lanes,))
    for name in ("queue_row", "done", "cfg", "active"):
        kernels.check_cuda(name, state[name], dict(STATE_FIELDS)[name],
                           (lanes,))
    kernels.check_cuda("bank type", bank["type"], torch.int32, (lanes, J))
    if lanes:
        kernels.launch(
            "episode_prepare", state["queue_row"].data_ptr(),
            state["done"].data_ptr(), bank["type"].data_ptr(),
            action.data_ptr(), dev.deg_col.data_ptr(),
            state["cfg"].data_ptr(), state["active"].data_ptr(), lanes, J,
            dev.n_deg, dev.n_cfg, dev.deg_col.shape[0])


# =========================================================================
# In-kernel candidate pricing and the OracleJCT choice (B13 oracle): K29,
# K30.
# =========================================================================

def price_reduce_plain(is_flow: torch.Tensor, chan: torch.Tensor,
                       ok_place: torch.Tensor, finite_ok: torch.Tensor,
                       t_step: torch.Tensor, ok_la: torch.Tensor,
                       state: dict, bank: dict
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K29's plain version (see ``price_reduce``)."""
    queue_row, done = state["queue_row"], state["done"]
    lanes = queue_row.shape[0]
    n_deg = is_flow.shape[0] // lanes
    lane = torch.arange(lanes * n_deg, device=is_flow.device) // n_deg
    occ = state["chan_occ"][lane].gather(1, chan.clamp(min=0).long())
    ok_chan = (~is_flow | (occ < 0)).all(1)
    has_job = ((queue_row >= 0) & ~done)[lane]
    steps = bank["steps"].gather(1, queue_row.clamp(min=0).long()[:, None])
    ok = ok_place & ok_chan & ok_la & finite_ok & has_job
    jct = torch.where(has_job, t_step * steps[lane, 0],
                      torch.zeros_like(t_step))
    return ok.reshape(lanes, n_deg), jct.reshape(lanes, n_deg)


def price_reduce(is_flow: torch.Tensor, chan: torch.Tensor,
                 ok_place: torch.Tensor, finite_ok: torch.Tensor,
                 t_step: torch.Tensor, ok_la: torch.Tensor, state: dict,
                 bank: dict, cfg: torch.Tensor, n_deps: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K29: candidate pricing's verdicts and prices (reference: the end of
    ``price_all`` :1085 over ``eval_cfg`` :1023) from K23's, K24's and
    K21's outputs on B * n_deg rows (row ``r`` prices lane ``r // n_deg``'s
    queued job at degree column ``r % n_deg``): ``ok = ok_place & ok_chan
    & ok_la & finite_ok`` (``ok_chan``: no flow's channel is occupied in
    the lane's ``chan_occ``) and ``jct = t_step * steps``, each [B,
    n_deg]; ok False and jct 0 for lanes with no queued job. ``t_step``
    may be strided (K21's output column). ``cfg`` [B * n_deg] int32 is
    each row's configuration and ``n_deps`` [K] int32 the table of valid
    dep prefixes: the kernel reads a row's deps ``[0, n_deps[cfg])``
    only, as K24 writes every dep past them as no flow (the plain version
    reads the whole row and takes neither). The kernel stages each lane's
    channel occupancy in shared memory where it fits, else reads it from
    global memory (the same answer)."""
    if kernels.on_cpu(is_flow, chan, t_step, state["chan_occ"]):
        return price_reduce_plain(is_flow, chan, ok_place, finite_ok,
                                  t_step, ok_la, state, bank)
    queue_row = state["queue_row"]
    lanes = queue_row.shape[0]
    rows, m = is_flow.shape
    if not lanes or rows % lanes:
        raise ValueError(f"{rows} price rows for {lanes} lanes")
    n_deg = rows // lanes
    dt = t_step.dtype
    kernels.check_cuda("is_flow", is_flow, torch.bool, (rows, m))
    kernels.check_cuda("chan", chan, torch.int32, (rows, m))
    for name, x in (("ok_place", ok_place), ("finite_ok", finite_ok),
                    ("ok_la", ok_la)):
        kernels.check_cuda(name, x, torch.bool, (rows,))
    if dt not in (torch.float32, torch.float64) or t_step.shape != (rows,) \
            or t_step.device != is_flow.device:
        raise ValueError(f"t_step must be [{rows}] float32 or float64 on "
                         f"{is_flow.device}")
    chan_occ = state["chan_occ"]
    kernels.check_cuda("chan_occ", chan_occ, torch.int32)
    kernels.check_cuda("queue_row", queue_row, torch.int32, (lanes,))
    kernels.check_cuda("done", state["done"], torch.bool, (lanes,))
    kernels.check_cuda("bank steps", bank["steps"], dt)
    kernels.check_cuda("cfg", cfg, torch.int32, (rows,))
    kernels.check_cuda("n_deps", n_deps, torch.int32)
    ok = torch.empty((lanes, n_deg), dtype=torch.bool, device=is_flow.device)
    jct = torch.empty((lanes, n_deg), dtype=dt, device=is_flow.device)
    kernels.launch(
        "price_reduce", is_flow.data_ptr(), chan.data_ptr(),
        ok_place.data_ptr(), finite_ok.data_ptr(), t_step.data_ptr(),
        ok_la.data_ptr(), chan_occ.data_ptr(), queue_row.data_ptr(),
        state["done"].data_ptr(), bank["steps"].data_ptr(), cfg.data_ptr(),
        n_deps.data_ptr(), ok.data_ptr(), jct.data_ptr(), lanes, n_deg, m,
        chan_occ.shape[1], bank["steps"].shape[1], t_step.stride(0),
        int(dt == torch.float64), int(bool(kernels.forced("price_reduce"))))
    return ok, jct


def oracle_select_plain(ok: torch.Tensor, jct: torch.Tensor, state: dict,
                        bank: dict, dobs: "DeviceObs") -> torch.Tensor:
    """K30's plain version (see ``oracle_select``)."""
    degrees = dobs.dev.degrees
    queue_row = state["queue_row"]
    n_occupied = (state["srv_job"] >= 0).sum(1)
    mask = kernel_action_mask(dobs, n_occupied)[:, degrees.long()]
    row = queue_row.clamp(min=0).long()[:, None]
    jtype = bank["type"].gather(1, row)[:, 0].long()
    steps = bank["steps"].gather(1, row)[:, 0]
    frac = bank["sla_frac"].gather(1, row)[:, 0]
    max_jct = frac * (dobs.orig_seq_sum[jtype] * steps)
    acceptable = mask & ok & (jct <= max_jct[:, None])
    placeable = mask & ok
    none = torch.full_like(queue_row, -1)
    first_acc = torch.where(acceptable.any(1), degrees[
        acceptable.to(torch.uint8).argmax(1)], none)
    best_jct = torch.full_like(max_jct, _INF)
    best_deg = none
    for j in range(degrees.shape[0]):
        take = placeable[:, j] & (jct[:, j] < best_jct)
        best_jct = torch.where(take, jct[:, j], best_jct)
        best_deg = torch.where(take, degrees[j], best_deg)
    first_valid = torch.where(mask.any(1), degrees[
        mask.to(torch.uint8).argmax(1)], torch.zeros_like(none))
    action = torch.where(first_acc >= 0, first_acc,
                         torch.where(best_deg >= 0, best_deg, first_valid))
    has_job = (queue_row >= 0) & ~state["done"]
    return torch.where(has_job, action, 0).to(torch.int32)


def oracle_select(ok: torch.Tensor, jct: torch.Tensor, state: dict,
                  bank: dict, dobs: "DeviceObs") -> torch.Tensor:
    """K30: the OracleJCT episode's action [B] int32 (reference:
    ``make_oracle_episode_fn`` :1831-1869; the host's
    ``envs/baselines.py`` ``OracleJCT``) from K29's ``ok`` and ``jct``
    [B, n_deg]: with the observation's action mask restricted to the
    degrees and the limit ``sla_frac * (orig_seq_sum[type] * steps)`` (the
    unpartitioned job's), the smallest degree that is allowed, ok and
    within the limit; else the smallest-JCT allowed ok degree (the first
    minimum in degree order); else the smallest allowed degree; else 0.
    Lanes with no queued job take action 0."""
    if kernels.on_cpu(ok, jct, state["srv_job"]):
        return oracle_select_plain(ok, jct, state, bank, dobs)
    dev = dobs.dev
    lanes, n_deg = ok.shape
    dt = dev.dtype
    J = bank["type"].shape[1]
    kernels.check_cuda("ok", ok, torch.bool, (lanes, dev.n_deg))
    kernels.check_cuda("jct", jct, dt, (lanes, n_deg))
    kernels.check_cuda("srv_job", state["srv_job"], torch.int32,
                       (lanes, dev.et.n_srv))
    kernels.check_cuda("queue_row", state["queue_row"], torch.int32,
                       (lanes,))
    kernels.check_cuda("done", state["done"], torch.bool, (lanes,))
    for name, want in BANK_FIELDS[:3]:
        kernels.check_cuda(f"bank {name}", bank[name], want or dt,
                           (lanes, J))
    action = torch.empty(lanes, dtype=torch.int32, device=ok.device)
    if lanes:
        kernels.launch(
            "oracle_select", ok.data_ptr(), jct.data_ptr(),
            state["srv_job"].data_ptr(), state["queue_row"].data_ptr(),
            state["done"].data_ptr(), bank["type"].data_ptr(),
            bank["steps"].data_ptr(), bank["sla_frac"].data_ptr(),
            dobs.orig_seq_sum.data_ptr(), dobs.shapes_exist.data_ptr(),
            dev.degrees.data_ptr(), action.data_ptr(), lanes, n_deg,
            dev.et.n_srv, J, int(dt == torch.float64))
    return action


def make_episode_fn(et: EpisodeTables,
                    memo_cfg: Optional[device_memo.MemoConfig] = None, *,
                    device="cuda", dtype: torch.dtype = torch.float32):
    """The device episode replay (reference: ``make_episode_fn`` :1240):
    ``episode(bank, actions)`` runs every decision of the action sequence
    on ``device`` and returns per-decision traces and the final counters.
    ``memo_cfg`` runs the lookahead under the memo (K27 and K28; a fresh
    table each call; the results are the same bit for bit) and adds the
    final ``memo_hits``, ``memo_misses`` and ``memo_evicts``; unlike the
    reference's, the default is no memo.

    ``bank`` is a job bank (``build_job_bank``: [J] arrays, ``arrival_t``
    [J + 1]) with ``actions`` [D], or a stack of banks ([B, J]) with
    ``actions`` [B, D]: one lane each, the counterpart of
    ``jax.vmap(make_episode_fn(et))``. Each decision is one launch of
    K23, K24, K21 (lanes without a decision skipped) and K25 over all
    lanes, with no host sync; on ``device="cpu"`` the plain versions run.
    Raises on ``"cuda"`` without a card.

    Returns the reference's keys: ``trace`` (reward, accept, cause, jct,
    t, has_job; each [D], or [B, D]), ``accepted``, ``blocked``, ``ret``,
    ``completed``, ``t``, ``done``, ``blocked_total`` (decision blocks
    plus the jobs still running at the end, as the host's episode stats
    count them), ``arrived``; and ``lookahead_ticks``, K21's ticks over
    the episode. Tensors on ``device``."""
    ek = episode_kernels(et, device=device, dtype=dtype)
    dev = ek.dev

    def tensor(x) -> torch.Tensor:
        return (x if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.ascontiguousarray(x)))

    def episode(bank: dict, actions) -> dict:
        actions = tensor(actions)
        single = actions.dim() == 1
        b = {}
        for name, want in BANK_FIELDS:
            x = tensor(bank[name])
            x = x[None] if single else x
            b[name] = x.to(device=dev.device, dtype=want or dtype
                           ).contiguous()
        acts = (actions[None] if single else actions).to(
            device=dev.device, dtype=torch.int32).contiguous()
        lanes, D = acts.shape
        if b["type"].shape[0] != lanes:
            raise ValueError(f"{b['type'].shape[0]} banks for {lanes} "
                             "action sequences")
        trace = {name: torch.zeros((lanes, D), dtype=want or dtype,
                                   device=dev.device)
                 for name, want in TRACE_FIELDS}
        state = ek.init_state(b, acts)
        memo = (None if memo_cfg is None else device_memo.memo_init(
            lanes, dev.pads.n_ops, dev.pads.n_deps, dtype, memo_cfg,
            dev.device))
        for d in range(D):
            raw = ek.evaluate(state, memo)
            episode_step(ek, state, b, acts, raw, trace, d)
        out = {"trace": tuple(trace[name] for name, _ in TRACE_FIELDS),
               "accepted": state["accepted"], "blocked": state["blocked"],
               "ret": state["ret"], "completed": state["completed"],
               "t": state["t"], "done": state["done"],
               "blocked_total": state["blocked"]
               + state["slot_valid"].sum(1).int(),
               "arrived": state["ptr"], "lookahead_ticks": state["ticks"]}
        if memo is not None:
            out.update(device_memo.memo_trace_counters(memo))
        if single:
            out = {k: (tuple(x[0] for x in v) if k == "trace" else v[0])
                   for k, v in out.items()}
        return out

    return episode


def episode_kernels(et: EpisodeTables, *, device="cuda",
                    dtype: torch.dtype = torch.float32) -> EpisodeKernels:
    """The episode's kernels on ``device`` in ``dtype``: ``evaluate`` and
    ``eval_cfg`` (the candidate, no memo), ``decision``, ``advance`` and
    ``init_state`` (reference: ``_episode_kernels`` :974)."""
    return EpisodeKernels(device_tables(et, device, dtype))


# =========================================================================
# The in-kernel observation (B12): K26; the forward's batch on the device.
# =========================================================================

# the static per-type rows of an observation, gathered by job type
STATIC_OBS_KEYS = ("node_features", "edge_features", "edges_src",
                   "edges_dst", "node_split", "edge_split")
# the normalisation bounds of the rebuilt entries 2, 3, 4 and 8
_BOUND_KEYS = ("seq_bounds", "jct_bounds", "frac_bounds", "steps_bounds")


def build_obs_tables(env, et: EpisodeTables) -> dict:
    """The static per-type observation rows and the constants the kernel
    rebuilds the job-specific entries from (reference: :1329): the host
    encoder's observation of each model's prototype, ``orig_seq_sum`` (the
    exact ``compute.sum()`` the host multiplies by the training steps;
    dividing it back out of ``seq_completion_time`` would cost an ulp),
    the normalisation bounds and ``shapes_exist`` per action."""
    gen = env.cluster.jobs_generator
    obs_fn = env.observation_function
    with_prices = bool(getattr(obs_fn, "include_candidate_prices", False))
    params = gen.jobs_params

    proto_by_model = {}
    for proto in gen.sampler.prototypes:
        proto_by_model.setdefault(proto.details["model"], proto)

    rows = []
    for model in et.types:
        obs = {k: np.asarray(v) for k, v in
               obs_fn.encode(proto_by_model[model], env).items()}
        if with_prices:
            # the template's price block is another job's decision-time
            # data: dropped
            obs["graph_features"] = obs["graph_features"][
                :-(et.max_action + 1)]
        rows.append(obs)

    def stack(key):
        return np.stack([r[key] for r in rows])

    def bounds(key):
        return (float(params[f"min_{key}"]), float(params[f"max_{key}"]))

    out = {key: stack(key) for key in STATIC_OBS_KEYS + ("graph_features",)}
    out.update({
        "orig_seq_sum": np.array(
            [float(proto_by_model[m].graph.finalize()["compute"].sum())
             for m in et.types], np.float64),
        "seq_bounds": bounds("job_sequential_completion_times"),
        "jct_bounds": bounds("max_acceptable_job_completion_times"),
        "frac_bounds": bounds("max_acceptable_job_completion_time_fracs"),
        "steps_bounds": bounds("job_num_training_steps"),
        "shapes_exist": np.array(
            [bool(block_shapes_for(factor_pairs(a), et.st.ramp_shape))
             for a in range(et.max_action + 1)], bool),
        "with_prices": with_prices,
    })
    return out


class DeviceObs:
    """``build_obs_tables``'s tables on the episode's device: the static
    graph-feature rows, ``orig_seq_sum`` in the episode's float type, the
    bounds (lo, hi - lo, and the float32 reciprocal of hi - lo), the
    static per-type rows at the env's pad (``rows``: what
    ``rebuild_obs_batch`` gathers) and the policy forward's per-type
    flattened-graph rows (``staged``: K20's input), built once."""

    def __init__(self, ot: dict, dev: DeviceTables):
        from ddls_tpu_torch.models.policy import sample_structure

        self.dev = dev
        # the observation ends in the candidate-price block (K26 appends
        # it from ``EpisodeKernels.price_all``'s verdicts and prices)
        self.with_prices = bool(ot.get("with_prices"))

        def put(x, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                dev.device, dtype)

        self.static_gf = put(ot["graph_features"], torch.float32)
        self.orig_seq_sum = put(ot["orig_seq_sum"], dev.dtype)
        self.shapes_exist = put(ot["shapes_exist"])
        self.bounds = []
        for key in _BOUND_KEYS:
            lo, hi = ot[key]
            span = hi - lo
            rc = float(np.float32(1) / np.float32(span)) if span else 0.0
            self.bounds.append((lo, span, rc))
        self.consts = put(np.array(self.bounds, np.float64))
        self.n_srv = dev.et.n_srv
        self.n_actions = len(ot["shapes_exist"])
        self.width = self.static_gf.shape[1] + (
            self.n_actions if self.with_prices else 0)
        self.rows = {k: put(ot[k]) for k in STATIC_OBS_KEYS}
        self.action_set = torch.arange(self.n_actions, dtype=torch.int32,
                                       device=dev.device)
        per_type = {k: np.asarray(ot[k]) for k in STATIC_OBS_KEYS}
        per_type["graph_features"] = np.asarray(ot["graph_features"],
                                                np.float32)
        per_type["action_mask"] = np.zeros(
            (len(dev.et.types), self.n_actions), np.int32)
        structure, node_mask = sample_structure(per_type)
        self.n_nodes = per_type["node_features"].shape[1]
        self.n_edges = per_type["edge_features"].shape[1]
        self.staged = {
            "node_features": put(per_type["node_features"], torch.float32),
            "edge_features": put(per_type["edge_features"], torch.float32),
            "graph_features": self.static_gf,
            "action_mask": put(per_type["action_mask"]),
            "structure": put(structure), "node_mask": put(node_mask,
                                                          torch.float32)}

    def forward_batch(self, jtype: torch.Tensor,
                      graph_features: torch.Tensor,
                      action_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The flattened graph of B observations of job types ``jtype``
        [B] (``GNNPolicy.flat_batched``'s batch, at the env's pad): K20
        gathers each type's rows and offsets the per-type CSRs by a prefix
        of the lanes' edge counts; the graph features and the mask are
        K26's ([B, G] float32, [B, A] int32)."""
        from ddls_tpu_torch.models.policy import minibatch_gather

        batch = minibatch_gather(self.staged, jtype.long(), self.n_nodes,
                                 self.n_edges)
        batch["graph_features"] = graph_features
        batch["action_mask"] = action_mask
        return batch


def device_obs(ot: dict, dev: DeviceTables) -> DeviceObs:
    """``ot`` on ``dev``'s device (built once per device and float type,
    and kept on ``dev``)."""
    if id(ot) not in dev.obs_tables:
        dev.obs_tables[id(ot)] = (ot, DeviceObs(ot, dev))
    return dev.obs_tables[id(ot)][1]


def kernel_action_mask(dobs: DeviceObs, n_occupied: torch.Tensor
                       ) -> torch.Tensor:
    """The observation's action mask [R, A] bool from each row's occupied
    server count (reference: ``_kernel_action_mask`` :1395): 0 always; 1
    needs a free server; an even a needs a <= free servers and a
    symmetric block shape of a servers."""
    free = dobs.n_srv - n_occupied.long()[:, None]
    a = torch.arange(dobs.n_actions, device=n_occupied.device)
    return ((a == 0) | ((a == 1) & (free >= 1))
            | ((a > 1) & (a % 2 == 0) & (a <= free) & dobs.shapes_exist))


def kernel_obs_plain(dobs: DeviceObs, jtype, frac, steps, n_occupied,
                     n_running, prices=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K26's plain version (see ``kernel_obs``)."""
    _check_prices(dobs, prices)
    dt = frac.dtype
    jt = jtype.long()
    gf = dobs.static_gf[jt].to(dt)
    seq = dobs.orig_seq_sum.to(dt)[jt] * steps

    def norm(i, val, product=None):
        lo, span, rc = dobs.bounds[i]
        if span == 0:
            return torch.ones_like(val)
        lo_t = torch.full_like(val, lo)
        if dt == torch.float32:
            diff = (val - lo_t if product is None
                    else lookahead_mod.fma32(product[0], product[1], -lo_t))
            return diff * torch.full_like(val, rc)
        return (val - lo_t) / torch.full_like(val, span)

    gf[:, 2] = norm(0, seq)
    gf[:, 3] = norm(1, frac * seq, (frac, seq))
    gf[:, 4] = norm(2, frac)
    gf[:, 5] = frac
    gf[:, 8] = norm(3, steps)
    n_srv = torch.full_like(frac, dobs.n_srv)
    gf[:, 15] = n_occupied.to(dt) / n_srv
    gf[:, 16] = n_running.to(dt) / n_srv
    mask = kernel_action_mask(dobs, n_occupied)
    a = mask.shape[1]
    parts = [gf[:, :-a].clamp(0.0, 1.0), mask.to(dt)]
    if prices is not None:
        # the host's limit frac * (sum * steps), floored at 1e-30
        ok, jct = prices
        degrees = dobs.dev.degrees.long()
        limit = torch.maximum(frac * seq, torch.full_like(frac, 1e-30))
        vals = torch.minimum(jct / limit[:, None],
                             torch.full_like(jct, 2.0)) * 0.5
        block = torch.ones((gf.shape[0], a), dtype=dt, device=gf.device)
        block[:, degrees] = torch.where(ok & mask[:, degrees], vals,
                                        torch.ones_like(vals))
        parts.append(block)
    gf = torch.cat(parts, 1)
    return gf.to(torch.float32), mask.to(torch.int32)


def _check_prices(dobs: DeviceObs, prices) -> None:
    if dobs.with_prices and prices is None:
        raise ValueError("the obs tables carry price features; pass prices "
                         "(EpisodeKernels.price_all's ok and jct; "
                         "envs/obs.py:_price_features)")
    if prices is not None and not dobs.with_prices:
        raise ValueError("prices given for obs tables without price "
                         "features")


def kernel_obs(dobs: DeviceObs, jtype: torch.Tensor, frac: torch.Tensor,
               steps: torch.Tensor, n_occupied: torch.Tensor,
               n_running: torch.Tensor,
               prices: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K26: the observation's graph features [R, G] float32 and action
    mask [R, A] int32 of R rows of compact fields (reference:
    ``_kernel_obs`` :1409 over ``rebuild_obs_batch``'s rows): ``jtype``,
    ``n_occupied`` and ``n_running`` int32, ``frac`` and ``steps`` of the
    episode's float type, each [R] (1-D; all with one stride, so a column
    of a [B, T + 1] field table is a valid input). The static entries are
    the type's row; entries 2, 3, 4, 5, 8, 15 and 16 are rebuilt, clipped
    to [0, 1] and cast to float32 last, then the mask follows as floats.
    In float64 the formulas are the host encoder's (``envs/obs.py``), bit
    for bit; in float32 they are XLA's float32 program of the reference
    (the bounds' differences a multiply by the float32 reciprocal, and
    ``frac * seq - lo`` one fused multiply-add).

    With price features (``dobs.with_prices``; reference: :1492-1512),
    ``prices`` is ``EpisodeKernels.price_all``'s ``(ok [R, n_deg] bool,
    jct [R, n_deg])`` and A entries follow the mask: for a degree the mask
    allows whose candidate is ok, ``min(jct / max(frac * seq, 1e-30), 2) /
    2`` (the host's ``envs/obs.py:_price_features``; in float32 each
    operation rounded to float32), 1.0 for every other action."""
    fields = (jtype, frac, steps, n_occupied, n_running)
    if kernels.on_cpu(*fields, *(prices or ())):
        return kernel_obs_plain(dobs, *fields, prices=prices)
    _check_prices(dobs, prices)
    dt = dobs.dev.dtype
    rows = jtype.shape[0]
    stride = jtype.stride(0) if rows else 1
    for name, x, want in zip(("jtype", "frac", "steps", "n_occupied",
                              "n_running"), fields,
                             (torch.int32, dt, dt, torch.int32,
                              torch.int32)):
        if x.dtype != want or x.dim() != 1 or x.shape[0] != rows or \
                (rows > 1 and x.stride(0) != stride) or \
                x.device != jtype.device:
            raise ValueError(f"{name} must be [{rows}] {want} on "
                             f"{jtype.device} with stride {stride}")
    if jtype.device.index != torch.cuda.current_device():
        raise ValueError(f"the fields must lie on the current CUDA device, "
                         f"got {jtype.device}")
    g, a = dobs.static_gf.shape[1], dobs.n_actions
    n_deg = dobs.dev.n_deg
    if prices is not None:
        kernels.check_cuda("price ok", prices[0], torch.bool, (rows, n_deg))
        kernels.check_cuda("price jct", prices[1], dt, (rows, n_deg))
    gf = torch.empty((rows, dobs.width), dtype=torch.float32,
                     device=jtype.device)
    mask = torch.empty((rows, a), dtype=torch.int32, device=jtype.device)
    if rows:
        kernels.launch(
            "kernel_obs" if prices is None else "kernel_obs_prices",
            *(x.data_ptr() for x in fields),
            dobs.static_gf.data_ptr(), dobs.orig_seq_sum.data_ptr(),
            dobs.shapes_exist.data_ptr(), dobs.consts.data_ptr(),
            *((prices[0].data_ptr(), prices[1].data_ptr(),
               dobs.dev.deg_col.data_ptr()) if prices is not None
              else (None, None, None)),
            gf.data_ptr(), mask.data_ptr(), rows, stride, g, a, dobs.n_srv,
            n_deg, int(dt == torch.float64))
    return gf, mask


def rebuild_obs_batch(dobs: DeviceObs, fields: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The exact observations the step forwards saw, from compact fields
    of any leading shape (reference: :1766): K26 over every row, the
    static rows gathered by type. Returns the ``envs/obs.py`` keys as
    tensors on the device, each of shape ``fields``' + its own."""
    if dobs.with_prices:
        raise ValueError(
            "rebuild_obs_batch does not support price-feature "
            "observations (the compact trace carries no pricing state)")
    shape = tuple(fields["jtype"].shape)
    flat = [fields[name].reshape(-1) for name, _ in OBS_FIELDS]
    gf, mask = kernel_obs(dobs, *flat)
    jt = flat[0].long()
    out = {k: dobs.rows[k].index_select(0, jt) for k in STATIC_OBS_KEYS}
    out["graph_features"] = gf
    out["action_mask"] = mask
    out["action_set"] = dobs.action_set.expand(jt.shape[0], -1)
    return {k: v.reshape(shape + tuple(v.shape[1:])) for k, v in out.items()}


# =========================================================================
# The policy and segment episodes (the rest of B13).
# =========================================================================

def device_bank(bank: dict, dev: DeviceTables) -> dict:
    """A job bank (``build_job_bank``'s [J] arrays) or a stack of banks
    ([B, J]) as [B, J] tensors on ``dev``'s device (``BANK_FIELDS``)."""
    out = {}
    for name, want in BANK_FIELDS:
        x = bank[name]
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        x = x[None] if x.dim() == 1 else x
        out[name] = x.to(device=dev.device, dtype=want or dev.dtype
                         ).contiguous()
    return out


def _step_uniforms(uniforms, generator, t_len: int, lanes: int, a: int,
                   device) -> torch.Tensor:
    """K9's uniforms [T, B, A] float32: handed in as [B, T, A] (the
    reference's per-lane key splits, recorded), or drawn from
    ``generator``."""
    from ddls_tpu_torch.models.policy import gumbel_uniforms

    if (uniforms is None) == (generator is None):
        raise ValueError("pass exactly one of uniforms, generator")
    if generator is not None:
        return gumbel_uniforms((t_len, lanes, a), generator, device)
    u = uniforms if isinstance(uniforms, torch.Tensor) else \
        torch.from_numpy(np.asarray(uniforms, np.float32))
    if tuple(u.shape) != (lanes, t_len, a):
        raise ValueError(f"uniforms must be [{lanes}, {t_len}, {a}], got "
                         f"{tuple(u.shape)}")
    return u.to(device, torch.float32).transpose(0, 1).contiguous()


def _policy_step(model, dobs: DeviceObs, fields: dict, d: int,
                 u: Optional[torch.Tensor], greedy: bool, prices=None,
                 hold=None):
    """One step's observation (K26, with the price block of ``prices``
    where the tables carry one), forward (K20, K1-K3, K17) and action: K9
    with the uniforms ``u`` [B, A], or greedy through K4. Returns (action
    [B] int32, logp [B], value [B]). ``hold`` as ``price_all``'s, called
    with K26's outputs where it appends prices
    (``"kernel_obs_prices"``)."""
    from ddls_tpu_torch.models.policy import (mask_logits_argmax,
                                              mask_sample_logp)

    f = [fields[name][:, d] for name, _ in OBS_FIELDS]
    gf, mask = kernel_obs(dobs, *f, prices=prices)
    if hold is not None and prices is not None:
        hold("kernel_obs_prices", (gf, mask),
             lambda: kernel_obs(dobs, *f, prices=prices),
             lambda: kernel_obs_plain(dobs, *f, prices=prices))
    logits, value = model.trunk(dobs.forward_batch(fields["jtype"][:, d],
                                                   gf, mask))
    if not model.apply_action_mask:
        mask = torch.ones_like(mask)
    if not greedy:
        action, logp = mask_sample_logp(logits, mask, u)
        return action, logp, value
    masked, action = mask_logits_argmax(logits, mask)
    logp = torch.log_softmax(masked, 1).gather(1, action[:, None])[:, 0]
    return action.to(torch.int32), logp, value


def segment_init(et: EpisodeTables, bank: dict,
                 memo_cfg: Optional[device_memo.MemoConfig] = None, *,
                 device="cuda", dtype: torch.dtype = torch.float32) -> dict:
    """The state ``make_segment_fn``'s segments carry (reference: :1585):
    ``{"env": each lane's initial episode state, "memo": a fresh table
    per lane or None}``; ``bank`` a stack of banks [B, J] (or one)."""
    ek = episode_kernels(et, device=device, dtype=dtype)
    b = device_bank(bank, ek.dev)
    lanes = b["type"].shape[0]
    memo = (None if memo_cfg is None else device_memo.memo_init(
        lanes, ek.dev.pads.n_ops, ek.dev.pads.n_deps, dtype, memo_cfg,
        ek.dev.device))
    return {"env": ek.init_state(b), "memo": memo}


def make_segment_fn(et: EpisodeTables, ot: dict, model, n_steps: int,
                    memo_cfg: Optional[device_memo.MemoConfig] = None, *,
                    device="cuda", dtype: torch.dtype = torch.float32):
    """``segment(bank, state, uniforms=None, generator=None, model=None)
    -> (trace, next_fields)`` (reference: ``make_segment_fn`` :1596):
    exactly ``n_steps`` policy decisions of every lane of the stacked
    banks, the state (``segment_init``'s, built with the same
    ``memo_cfg``) carried across calls and updated in place, an ended
    episode reset in place to a fresh run of its bank (``done`` marks the
    step). The memo outlives the reset.

    A step: K26 (the observation), K20 and the forward (K1-K3, K17), K9
    (the action, from ``uniforms`` [B, T, A] handed in or drawn from
    ``generator``), K25's prepare (the config row), K23, K24, with the
    memo K27, K21 (``skip``), with the memo K28, then K25 (the commit, the
    clock, the counters, the reset, the next step's fields). No host sync.
    ``model`` (default: the one given here) is the ``GNNPolicy`` that
    acts, on the device.

    The port's functions are lane-batched, so ``vmap_segment_fn`` (:1740)
    has no counterpart: a stack of banks is the lanes.

    ``trace`` ([B, T] tensors on the device): the reference's ``action``,
    ``logp``, ``value``, ``reward``, ``done``, ``ep_accepted``,
    ``ep_blocked``, ``ep_return``, ``ep_completed``, ``ep_arrived``, the
    compact fields (``OBS_FIELDS``) and with the memo ``memo_hits``,
    ``memo_misses``, ``memo_evicts``; also the decision's ``accept``,
    ``cause``, ``jct`` and ``t``. ``next_fields``: the fields after the
    segment, [B] each."""
    if ot.get("with_prices"):
        raise ValueError(
            "segment collection does not support price-feature "
            "observations (the compact PPO trace carries no pricing "
            "state); build obs tables from an env without "
            "obs_include_candidate_prices")
    ek = episode_kernels(et, device=device, dtype=dtype)
    dev = ek.dev
    dobs = device_obs(ot, dev)
    acting = model

    def segment(bank: dict, state: dict, uniforms=None, generator=None,
                model=None):
        model = acting if model is None else model
        b = device_bank(bank, dev)
        env, memo = state["env"], state["memo"]
        if (memo is None) != (memo_cfg is None):
            raise ValueError("the state's memo does not match memo_cfg")
        lanes, t_len = b["type"].shape[0], n_steps
        kw = dict(device=dev.device)
        u = _step_uniforms(uniforms, generator, t_len, lanes,
                           dobs.n_actions, dev.device)
        trace = {name: torch.zeros((lanes, t_len), dtype=want or dtype,
                                   **kw)
                 for name, want in TRACE_FIELDS + SEGMENT_TRACE_FIELDS}
        fields = {name: torch.empty((lanes, t_len + 1), dtype=want or dtype,
                                    **kw) for name, want in OBS_FIELDS}
        for name, value in obs_fields(env, b).items():
            fields[name][:, 0] = value
        memo_trace = (None if memo is None else
                      {k: torch.zeros((lanes, t_len), dtype=torch.int32,
                                      **kw)
                       for k in device_memo.MEMO_TRACE_KEYS})
        seg_trace = {name: trace[name] for name, _ in SEGMENT_TRACE_FIELDS}
        acts, logps, values = [], [], []
        with torch.no_grad():
            for d in range(t_len):
                action, logp, value = _policy_step(model, dobs, fields, d,
                                                   u[d], greedy=False)
                episode_prepare(ek, env, b, action)
                raw = ek.evaluate(env, memo, memo_trace, d)
                episode_step(ek, env, b, None, raw, trace, d,
                             seg_trace=seg_trace, fields=fields, reset=True)
                acts.append(action)
                logps.append(logp)
                values.append(value)
        trace.pop("has_job")
        trace.update(action=torch.stack(acts, 1), logp=torch.stack(logps, 1),
                     value=torch.stack(values, 1),
                     **{name: fields[name][:, :t_len]
                        for name, _ in OBS_FIELDS}, **(memo_trace or {}))
        return trace, {name: fields[name][:, t_len]
                       for name, _ in OBS_FIELDS}

    return segment


def make_policy_episode_fn(et: EpisodeTables, ot: dict, model,
                           greedy: bool = False,
                           memo_cfg: Optional[device_memo.MemoConfig]
                           = device_memo.MemoConfig(), *, device="cuda",
                           dtype: torch.dtype = torch.float32):
    """``episode(bank, uniforms=None, generator=None, steps=None,
    hold=None)`` (reference: ``make_policy_episode_fn`` :1457): the policy
    in the loop for one decision per bank job (J steps, or the first
    ``steps``), every lane at once: per step the
    ``make_segment_fn`` step without the reset, a lane whose episode ended
    deciding nothing (action 0, logp and value 0, cause -1). ``greedy``
    acts through K4 (argmax of the masked logits), else K9 samples from
    ``uniforms`` [B, J, A] or ``generator``. The memo is on by default, as
    the reference's (the results do not depend on it). Where ``ot``
    carries price features (an env with ``obs_include_candidate_prices``),
    each step first prices every degree of the queued job
    (``EpisodeKernels.price_all``: K23 indexed, K24, K21 without the memo,
    K29) and K26 appends the price block; ``hold(d, name, got, kernel,
    plain)``, where given, is called at step ``d`` with the outputs of
    K23 (indexed), K29 and K26 (prices) and callables of each kernel and
    its plain version on the call's own inputs.

    Returns the reference's keys: ``trace`` (action, logp, value, reward,
    accept, cause, jct, t, has_job; each [B, J], or [J] for one bank),
    ``accepted``, ``blocked``, ``ret``, ``completed``, ``t``, ``done``,
    ``blocked_total``, ``arrived``, and with the memo its counters."""
    ek = episode_kernels(et, device=device, dtype=dtype)
    dev = ek.dev
    dobs = device_obs(ot, dev)

    def episode(bank: dict, uniforms=None, generator=None, steps=None,
                hold=None) -> dict:
        single = np.ndim(bank["type"]) == 1
        b = device_bank(bank, dev)
        lanes, n_steps = b["type"].shape
        n_steps = n_steps if steps is None else steps
        kw = dict(device=dev.device)
        u = (None if greedy else _step_uniforms(
            uniforms[None] if single and uniforms is not None else uniforms,
            generator, n_steps, lanes, dobs.n_actions, dev.device))
        state = ek.init_state(b)
        memo = (None if memo_cfg is None else device_memo.memo_init(
            lanes, dev.pads.n_ops, dev.pads.n_deps, dtype, memo_cfg,
            dev.device))
        trace = {name: torch.zeros((lanes, n_steps), dtype=want or dtype,
                                   **kw) for name, want in TRACE_FIELDS}
        fields = {name: torch.empty((lanes, n_steps + 1),
                                    dtype=want or dtype, **kw)
                  for name, want in OBS_FIELDS}
        for name, value in obs_fields(state, b).items():
            fields[name][:, 0] = value
        acts, logps, values = [], [], []
        with torch.no_grad():
            for d in range(n_steps):
                has_job = (state["queue_row"] >= 0) & ~state["done"]
                at = None if hold is None else functools.partial(hold, d)
                prices = (ek.price_all(state, b, at) if dobs.with_prices
                          else None)
                action, logp, value = _policy_step(
                    model, dobs, fields, d, None if u is None else u[d],
                    greedy, prices, at)
                action = torch.where(has_job, action, 0).to(torch.int32)
                episode_prepare(ek, state, b, action)
                raw = ek.evaluate(state, memo)
                episode_step(ek, state, b, None, raw, trace, d,
                             fields=fields)
                acts.append(action)
                logps.append(torch.where(has_job, logp, 0.0))
                values.append(torch.where(has_job, value, 0.0))
        out = {"trace": (torch.stack(acts, 1), torch.stack(logps, 1),
                         torch.stack(values, 1), trace["reward"],
                         trace["accept"], trace["cause"], trace["jct"],
                         trace["t"], trace["has_job"]),
               "accepted": state["accepted"], "blocked": state["blocked"],
               "ret": state["ret"], "completed": state["completed"],
               "t": state["t"], "done": state["done"],
               "blocked_total": state["blocked"]
               + state["slot_valid"].sum(1).int(),
               "arrived": state["ptr"]}
        if memo is not None:
            out.update(device_memo.memo_trace_counters(memo))
        if single:
            out = {k: (tuple(x[0] for x in v) if k == "trace" else v[0])
                   for k, v in out.items()}
        return out

    return episode


def make_oracle_episode_fn(et: EpisodeTables, ot: dict,
                           memo_cfg: Optional[device_memo.MemoConfig]
                           = device_memo.MemoConfig(), *, device="cuda",
                           dtype: torch.dtype = torch.float32):
    """``episode(bank, steps=None, hold=None)`` (reference:
    ``make_oracle_episode_fn`` :1799): the OracleJCT heuristic in the loop
    for one decision per bank job (J steps, or the first ``steps``), every
    lane at once. A step prices every degree of each lane's
    queued job (``EpisodeKernels.price_all``: K23 indexed, K24, K21
    without the memo, K29), chooses the degree (K30, the host's
    ``envs/baselines.py`` ``OracleJCT``), then runs K25's prepare, the
    decision's own evaluation (K23, K24, with the memo K27, K21 and K28)
    and K25, with no host sync; on ``device="cpu"`` the plain versions. A
    lane whose episode ended decides nothing (action 0, cause -1). The
    memo serves the decision's lookahead only and is on by default, as the
    reference's (the results do not depend on it). ``ot`` is
    ``build_obs_tables``' (K30 reads its action-mask shapes and
    ``orig_seq_sum``). ``hold(d, name, got, kernel, plain)``, where given,
    is called at step ``d`` with the outputs of K23 (indexed), K29 and K30
    and callables of each kernel and its plain version on the call's own
    inputs.

    ``bank`` is a job bank ([J] arrays) or a stack of banks ([B, J]).
    Returns the reference's keys: ``trace`` (action, reward, accept,
    cause, jct, t, has_job; each [B, J], or [J] for one bank),
    ``accepted``, ``blocked``, ``ret``, ``completed``, ``t``, ``done``,
    ``blocked_total``, ``arrived``, and with the memo its counters."""
    ek = episode_kernels(et, device=device, dtype=dtype)
    dev = ek.dev
    dobs = device_obs(ot, dev)

    def episode(bank: dict, steps=None, hold=None) -> dict:
        single = np.ndim(bank["type"]) == 1
        b = device_bank(bank, dev)
        lanes, n_steps = b["type"].shape
        n_steps = n_steps if steps is None else steps
        state = ek.init_state(b)
        memo = (None if memo_cfg is None else device_memo.memo_init(
            lanes, dev.pads.n_ops, dev.pads.n_deps, dtype, memo_cfg,
            dev.device))
        trace = {name: torch.zeros((lanes, n_steps), dtype=want or dtype,
                                   device=dev.device)
                 for name, want in TRACE_FIELDS}
        acts = []
        for d in range(n_steps):
            ok, jct = ek.price_all(state, b, None if hold is None
                                   else functools.partial(hold, d))
            action = oracle_select(ok, jct, state, b, dobs)
            if hold is not None:
                hold(d, "oracle_select", (action,),
                     lambda: (oracle_select(ok, jct, state, b, dobs),),
                     lambda: (oracle_select_plain(ok, jct, state, b, dobs),))
            episode_prepare(ek, state, b, action)
            raw = ek.evaluate(state, memo)
            episode_step(ek, state, b, None, raw, trace, d)
            acts.append(action)
        out = {"trace": (torch.stack(acts, 1), trace["reward"],
                         trace["accept"], trace["cause"], trace["jct"],
                         trace["t"], trace["has_job"]),
               "accepted": state["accepted"], "blocked": state["blocked"],
               "ret": state["ret"], "completed": state["completed"],
               "t": state["t"], "done": state["done"],
               "blocked_total": state["blocked"]
               + state["slot_valid"].sum(1).int(),
               "arrived": state["ptr"]}
        if memo is not None:
            out.update(device_memo.memo_trace_counters(memo))
        if single:
            out = {k: (tuple(x[0] for x in v) if k == "trace" else v[0])
                   for k, v in out.items()}
        return out

    return episode
