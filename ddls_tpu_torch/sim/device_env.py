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

Left out: the in-kernel lookahead memo (B11), the in-kernel observation
and the policy, segment and oracle episodes (B12, the rest of B13), and
the scenario mirror (``scenario_adjusted``, ``inflate_duration_jax``):
``build_episode_tables`` raises on a non-nominal scenario.

Lanes are independent: a stacked run equals its lanes run one by one, bit
for bit. The episode updates its state tensors in place (the reference's
scan carries new arrays each decision).
"""
from __future__ import annotations

import copy
import ctypes
import dataclasses
import random as _random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.agents.block_search import (block_shapes_for,
                                                enumerate_block,
                                                factor_pairs)
from ddls_tpu_torch.agents.partitioners import build_partition_action
from ddls_tpu_torch.graphs.readers import backward_op_id
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
    return ShapeTables(ramp_shape=meta, shapes=distinct, row=row,
                       offsets=offsets, counts=counts, bases=bases,
                       spans=spans, diagonal=diagonal,
                       anchor_cells=anchor_cells, anchor_span=anchor_span)


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
    # the tables on each (device, float type) they were asked on
    on_device: dict = dataclasses.field(default_factory=dict, repr=False,
                                        compare=False)


def build_episode_tables(env, max_degree: Optional[int] = None,
                         quantum: Optional[float] = None) -> EpisodeTables:
    """The static side of the device episode, from a reset host env of the
    port (canonical RAMP single-channel complete topology, nominal
    scenario, the job_acceptance reward; reference: :827)."""
    from ddls_tpu_torch.envs.rewards import JobAcceptance

    topo = env.cluster.topology
    dense = topo.dense_tables()
    if dense["pair_channel"] is None:
        raise ValueError("the device episode needs a single-channel "
                         "complete topology (canonical RAMP)")
    if getattr(env.cluster, "scenario_runtime", None) is not None:
        raise ValueError("the device episode replays nominal scenarios "
                         "only; the failure walk is not ported")
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
        worker_mem=float(workers[0].memory_capacity))


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
        self.pair_channel = put(et.pair_channel)
        # action value -> cfg column (-1 for odd/invalid actions), sized by
        # the env's action bound so no action clamps onto a valid column
        deg_col = np.full(max(et.max_action, max(et.degrees)) + 1, -1,
                          np.int32)
        for i, d in enumerate(et.degrees):
            deg_col[d] = i
        self.deg_col = put(deg_col)
        self.n_deg = len(et.degrees)
        self.n_cfg = len(et.tables["n_ops"])
        comm = et.comm
        # the reference's Python-float constants, as its float type rounds
        # them: prop + 2 io is summed in double before it meets an array
        self.comm = {"x": float(comm["x"]), "rate": float(comm["rate"]),
                     "prop_io": float(comm["prop"] + 2 * comm["io"]),
                     "data_per_tx": float(comm["rate"] / float(comm["x"]))}


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
                       cfg: torch.Tensor, dev: DeviceTables):
    """K23's plain version: the reference's scan over the forward ops
    (``jax_allocate_job`` :450) for every lane at once."""
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


def allocate_job(mem: torch.Tensor, other_free: torch.Tensor,
                 cfg: torch.Tensor, dev: DeviceTables):
    """K23: place one job per lane. ``mem`` [B, n_srv] free memory (the
    episode's float type), ``other_free`` [B, n_srv] bool (not occupied by
    another job), ``cfg`` [B] int32 config rows. Returns ``(ots [B, N]
    int32 (-1 unplaced), new_mem [B, n_srv], ok [B] bool)``; where ok is
    False the outputs are partial, as the reference's."""
    if kernels.on_cpu(mem, other_free, cfg):
        return allocate_job_plain(mem, other_free, cfg, dev)
    lanes, n_srv = mem.shape
    kernels.check_cuda("mem", mem, dev.dtype, (lanes, dev.et.n_srv))
    kernels.check_cuda("other_free", other_free, torch.bool, (lanes, n_srv))
    kernels.check_cuda("cfg", cfg, torch.int32, (lanes,))
    pads = dev.pads
    ots = torch.empty((lanes, pads.n_ops), dtype=torch.int32,
                      device=mem.device)
    new_mem = torch.empty_like(mem)
    ok = torch.empty(lanes, dtype=torch.bool, device=mem.device)
    T = dev.t
    if lanes:
        kernels.launch(
            "allocate_job", mem.data_ptr(), other_free.data_ptr(),
            cfg.data_ptr(), T["f_valid"].data_ptr(),
            T["f_split"].data_ptr(), T["f_mem"].data_ptr(),
            T["f_parents"].data_ptr(), T["f_sub_fwd"].data_ptr(),
            T["f_sub_bwd"].data_ptr(), dev.row.data_ptr(),
            dev.anchor_cells.data_ptr(), dev.anchor_span.data_ptr(),
            ots.data_ptr(), new_mem.data_ptr(), ok.data_ptr(), lanes, n_srv,
            pads.n_ops, pads.n_fwd, pads.n_parents, pads.max_split,
            dev.row.shape[0], dev.row.shape[1], dev.anchor_cells.shape[0],
            dev.anchor_cells.shape[2], int(dev.dtype == torch.float64))
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
    product's error from Dekker's split, the sum's from TwoSum."""
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
    return s + (s_err + p_err)


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

    # SRPT dep priorities: one stable sort, descending cost, edge order
    # breaking ties (-0.0 equal to 0.0)
    key = torch.where(dep_valid, -times, torch.full_like(times, np.inf))
    order = torch.sort(key, dim=1, stable=True).indices
    dep_pri = torch.zeros_like(times).scatter_(
        1, order, torch.arange(M, dtype=dt, device=device).expand(
            lanes, M).contiguous())
    dep_pri = torch.where(is_flow, dep_pri, zero)
    m = T["n_deps"][c].to(dt)[:, None]
    dep_score = _score(dep_pri, m, T["dep_sorted_rank"][c].to(dt))

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


def price_and_score(ots: torch.Tensor, cfg: torch.Tensor,
                    dev: DeviceTables):
    """K24: price every dep of each lane's placed job and build the SRPT
    lookahead scores. ``ots`` [B, N] int32 server codes (-1 unplaced),
    ``cfg`` [B] int32. Returns ``(times [B, M] (zero where not a flow),
    is_flow [B, M] bool, chan [B, M] int32 (-1 where not a flow),
    op_score [B, N], dep_score [B, M], finite_ok [B] bool)``."""
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
        kernels.launch(
            "price_and_score", ots.data_ptr(), cfg.data_ptr(),
            *(T[k].data_ptr() for k in PRICING_TABLES),
            dev.pair_channel.data_ptr(), times.data_ptr(),
            is_flow.data_ptr(), chan.data_ptr(), op_score.data_ptr(),
            dep_score.data_ptr(), finite_ok.data_ptr(), lanes, N, M,
            pads.n_groups, pads.group_edges, pads.n_sync, pads.n_o2o, C, R,
            S, ctypes.c_double(cm["x"]), ctypes.c_double(cm["rate"]),
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


def _ordered_sum(mask: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``mask.astype(dt) @ rows`` over the slot axis, summed in slot order
    (the masked rows only; ``mask`` [B, R] bool, ``rows`` [B, R, n])."""
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
    def init_state(self, bank: dict, actions: torch.Tensor) -> dict:
        """Job 0 queued at t = 0 and every server free (the reference's
        ``init_state``), then decision 0's config row."""
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
        for name in ("completed", "accepted", "blocked", "cfg", "ticks"):
            state[name] = torch.zeros(lanes, dtype=torch.int32, **kw)
        state["ret"] = torch.zeros(lanes, dtype=dt, **kw)
        state["active"] = torch.zeros(lanes, dtype=torch.bool, **kw)
        self.prepare(state, bank, actions[:, 0])
        return state

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
    def evaluate(self, state: dict) -> dict:
        """Placement (K23), pricing (K24) and the lookahead (K21, lanes
        that decide nothing skipped) of each lane's ``cfg`` against its
        cluster state: the kernels' raw outputs."""
        dev = self.dev
        cfg = state["cfg"]
        ots, new_mem, ok_place = allocate_job(
            state["mem"], state["srv_job"] < 0, cfg, dev)
        times, is_flow, chan, op_score, dep_score, finite_ok = \
            price_and_score(ots, cfg, dev)
        T = dev.t
        c = cfg.long()
        op_valid = T["op_valid"][c]
        ticks = torch.empty(cfg.shape[0], dtype=torch.int32,
                            device=cfg.device)
        t_step, _, _, _, ok_la = lookahead_mod.lookahead(
            T["op_compute"][c], op_valid, torch.where(op_valid, ots, -1),
            op_score, T["num_parents"][c], times, T["dep_valid"][c],
            T["dep_src"][c], T["dep_dst"][c], T["dep_mutual"][c], is_flow,
            dep_score, chan[:, :, None], num_workers=dev.et.n_srv,
            num_channels=dev.et.n_chan, ticks=ticks,
            skip=~state["active"])
        return {"ots": ots, "new_mem": new_mem, "ok_place": ok_place,
                "times": times, "is_flow": is_flow, "chan": chan,
                "op_score": op_score, "dep_score": dep_score,
                "finite_ok": finite_ok, "t_step": t_step, "ok_la": ok_la,
                "ticks": ticks}

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
                 trace: dict, d: int) -> None:
        """The SLA gate, the cause code and the masked commit into the
        first free slot (reference: ``decision`` :1105 and the episode's
        ``scan_body`` :1269); writes decision ``d`` of ``trace``."""
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

        slot_valid = state["slot_valid"]
        slot = slot_valid.to(torch.int8).argmin(1)  # the first free slot
        accept = accept & ~slot_valid.all(1) & has_job
        ar = torch.arange(slot.shape[0], device=dev.device)
        delta = mem - new_mem
        t = state["t"]
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


def episode_step_plain(ek: EpisodeKernels, state: dict, bank: dict,
                       actions: torch.Tensor, raw: dict, trace: dict,
                       d: int) -> None:
    """K25's plain version: decision ``d``'s commit, the event clock to
    the next decision, and that decision's config row."""
    ek.decision(state, bank, raw, trace, d)
    ek.advance(state, bank)
    if d + 1 < actions.shape[1]:
        ek.prepare(state, bank, actions[:, d + 1])


# the outputs of EpisodeKernels.evaluate that K25 reads, in its order
_RAW_FIELDS = ("ots", "new_mem", "ok_place", "is_flow", "chan", "finite_ok",
               "t_step", "ok_la", "ticks")


def episode_step(ek: EpisodeKernels, state: dict, bank: dict,
                 actions: torch.Tensor, raw: dict, trace: dict,
                 d: int) -> None:
    """K25: decision ``d``'s SLA gate, cause code and commit, the event
    clock to the next decision, and that decision's config row, for every
    lane, updating ``state`` in place and writing decision ``d`` of
    ``trace`` (tensors as ``STATE_FIELDS``, ``TRACE_FIELDS``,
    ``BANK_FIELDS``; ``raw`` from ``EpisodeKernels.evaluate``)."""
    if kernels.on_cpu(state["mem"], raw["ots"]):
        return episode_step_plain(ek, state, bank, actions, raw, trace, d)
    dev, et = ek.dev, ek.dev.et
    dt = dev.dtype
    lanes = state["t"].shape[0]
    J, D = bank["type"].shape[1], actions.shape[1]
    for name, want in STATE_FIELDS:
        kernels.check_cuda(name, state[name], want or dt)
    for name, want in TRACE_FIELDS:
        kernels.check_cuda(f"trace {name}", trace[name], want or dt,
                           (lanes, D))
    for name, want in BANK_FIELDS:
        kernels.check_cuda(f"bank {name}", bank[name], want or dt,
                           (lanes, J + (name == "arrival_t")))
    kernels.check_cuda("actions", actions, torch.int32, (lanes, D))
    t_step = raw["t_step"]
    if t_step.dtype != dt or t_step.shape != (lanes,):
        raise ValueError("t_step must be the lookahead's [B] times")
    for name in _RAW_FIELDS:
        if name != "t_step":
            kernels.check_cuda(name, raw[name], raw[name].dtype)
    if not lanes:
        return
    kernels.launch(
        "episode_step", *(state[name].data_ptr() for name, _ in STATE_FIELDS),
        *(trace[name].data_ptr() for name, _ in TRACE_FIELDS),
        *(bank[name].data_ptr() for name, _ in BANK_FIELDS),
        actions.data_ptr(), *(raw[name].data_ptr() for name in _RAW_FIELDS),
        dev.t["op_valid"].data_ptr(), dev.t["seq_compute"].data_ptr(),
        dev.deg_col.data_ptr(), lanes, et.n_srv, et.n_chan, ek.R,
        dev.pads.n_ops, dev.pads.n_deps, J, D, d, dev.n_deg, dev.n_cfg,
        dev.deg_col.shape[0], t_step.stride(0), ctypes.c_double(et.sim_end),
        ctypes.c_double(et.eps), ctypes.c_double(et.success_reward),
        ctypes.c_double(et.fail_reward), int(dt == torch.float64))


def make_episode_fn(et: EpisodeTables, *, device="cuda",
                    dtype: torch.dtype = torch.float32):
    """The device episode replay (reference: ``make_episode_fn`` :1240,
    memo off): ``episode(bank, actions)`` runs every decision of the
    action sequence on ``device`` and returns per-decision traces and the
    final counters.

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
        for d in range(D):
            raw = ek.evaluate(state)
            episode_step(ek, state, b, acts, raw, trace, d)
        out = {"trace": tuple(trace[name] for name, _ in TRACE_FIELDS),
               "accepted": state["accepted"], "blocked": state["blocked"],
               "ret": state["ret"], "completed": state["completed"],
               "t": state["t"], "done": state["done"],
               "blocked_total": state["blocked"]
               + state["slot_valid"].sum(1).int(),
               "arrived": state["ptr"], "lookahead_ticks": state["ticks"]}
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
