"""DNN training jobs and their execution state.

A :class:`Job` wraps an :class:`~ddls_tpu_torch.graphs.op_graph.OpGraph` (one
forward+backward training step) to be executed ``num_training_steps`` times,
plus the job's SLA (max acceptable completion time as a fraction of its
sequential completion time). Mirrors the reference's
``ddls/demands/jobs/job.py:42`` but splits cleanly into:

* immutable per-model details (sequential JCT, totals, max-cost ops, depths)
  that are memoised across jobs of the same model;
* an :class:`ExecState` of flat numpy arrays (remaining run times, readiness
  masks, parent-dep counters) driven by the simulator's tick engine -- the
  array-native replacement for the reference's per-node attribute mutation
  (job.py:432-563).

Readiness semantics (identical to the reference):

* an op is ready when its count of completed incoming deps equals its number
  of *non-mutual* parents (mutual sync-edge pairs are children of both
  endpoints -- job.py:508-533);
* when an op completes, all its out-edges become ready deps (job.py:492-498);
* a training step is complete when every op *and* every dep has completed
  (job.py:549-551).

Port: a copy of ``ddls_tpu/demands/job.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ddls_tpu_torch.graphs.op_graph import EdgeId, OpGraph


def compute_immutable_details(graph: OpGraph, num_training_steps: int) -> dict:
    """Per-model statistics that never change over a job's lifetime
    (reference: job.py:192-325 _init_job_immutable_details)."""
    arrays = graph.finalize()
    compute, memory = arrays["compute"], arrays["memory"]
    sizes, depth = arrays["edge_size"], arrays["depth"]
    op_ids, edge_ids = arrays["op_ids"], arrays["edge_ids"]

    if len(compute):
        throughput = np.divide(memory, compute, out=np.zeros_like(memory),
                               where=compute > 0)
        max_op_compute_throughput = float(throughput.max())
    else:
        max_op_compute_throughput = 0.0

    i_max_compute = int(np.argmax(compute)) if len(compute) else 0
    i_max_memory = int(np.argmax(memory)) if len(memory) else 0
    i_max_depth = int(np.argmax(depth)) if len(depth) else 0
    e_max_size = int(np.argmax(sizes)) if len(sizes) else 0

    return {
        "job_sequential_completion_time": float(compute.sum()) * num_training_steps,
        "job_total_op_memory_cost": float(memory.sum()),
        "job_total_dep_size": float(sizes.sum()),
        "max_compute_node": op_ids[i_max_compute] if op_ids else None,
        "max_compute_cost": float(compute[i_max_compute]) if len(compute) else 0.0,
        "max_memory_node": op_ids[i_max_memory] if op_ids else None,
        "max_memory_cost": float(memory[i_max_memory]) if len(memory) else 0.0,
        "max_depth_node": op_ids[i_max_depth] if op_ids else None,
        "max_depth": int(depth[i_max_depth]) if len(depth) else 0,
        "max_dep_size_dep": edge_ids[e_max_size] if edge_ids else None,
        "max_dep_size": float(sizes[e_max_size]) if len(sizes) else 0.0,
        # per-op compute throughput = memory / compute (reference:
        # job.py:214-222); used to normalise throughput rewards
        "max_op_compute_throughput": max_op_compute_throughput,
    }


class ExecState:
    """Flat-array execution state of one training step."""

    def __init__(self, graph: OpGraph,
                 dep_init_run_times: Optional[Dict[EdgeId, float]] = None):
        arrays = graph.finalize()
        self.graph = graph
        self.op_index: Dict[str, int] = arrays["op_index"]
        self.edge_index: Dict[EdgeId, int] = arrays["edge_index"]
        self.op_ids: List[str] = arrays["op_ids"]
        self.edge_ids: List[EdgeId] = arrays["edge_ids"]
        self.out_edges: List[List[int]] = arrays["out_edges"]
        self.edge_dst: np.ndarray = arrays["edge_dst"]
        self.num_parents: np.ndarray = arrays["num_parents"]
        self.edge_mutual: np.ndarray = arrays["edge_mutual"]

        n, m = graph.n_ops, graph.n_deps
        self.remaining_op = arrays["compute"].copy()
        self.init_dep_run_time = np.zeros(m, dtype=np.float64)
        self.remaining_dep = np.zeros(m, dtype=np.float64)
        self.parent_deps_done = np.zeros(n, dtype=np.int64)
        self.op_completed = np.zeros(n, dtype=bool)
        self.dep_completed = np.zeros(m, dtype=bool)
        # ops with zero non-mutual parents are ready at the start of a step
        # (covers both true sources and ops whose only in-edges are mutual
        # sync edges)
        self.ops_ready: Set[int] = {
            i for i in range(n) if self.num_parents[i] == 0}
        self.deps_ready: Set[int] = set()
        self.n_ops_completed = 0
        self.n_deps_completed = 0
        if dep_init_run_times:
            for edge, t in dep_init_run_times.items():
                self.set_dep_init_run_time(edge, t)

    # ------------------------------------------------------------------ events
    def set_dep_init_run_time(self, edge: EdgeId, run_time: float) -> None:
        ei = self.edge_index[edge]
        self.init_dep_run_time[ei] = run_time
        self.remaining_dep[ei] = run_time

    def tick_op(self, op_i: int, tick: float) -> bool:
        """Advance one op; returns True if it completed this tick."""
        rem = self.remaining_op[op_i]
        self.remaining_op[op_i] = rem - min(tick, rem)
        if self.remaining_op[op_i] == 0 and not self.op_completed[op_i]:
            self._complete_op(op_i)
            return True
        return False

    def tick_dep(self, dep_i: int, tick: float) -> bool:
        rem = self.remaining_dep[dep_i]
        self.remaining_dep[dep_i] = rem - min(tick, rem)
        if self.remaining_dep[dep_i] == 0 and not self.dep_completed[dep_i]:
            self._complete_dep(dep_i)
            return True
        return False

    def _complete_op(self, op_i: int) -> None:
        self.op_completed[op_i] = True
        self.n_ops_completed += 1
        self.ops_ready.discard(op_i)
        for ei in self.out_edges[op_i]:
            if not self.dep_completed[ei]:
                self.deps_ready.add(ei)

    def _complete_dep(self, dep_i: int) -> None:
        self.dep_completed[dep_i] = True
        self.n_deps_completed += 1
        self.deps_ready.discard(dep_i)
        if self.edge_mutual[dep_i]:
            # sync edges never gate readiness of their destination op.
            # (The reference counts them into its completed-parent-deps set,
            # which can fire an op early when a sync dep beats a real parent
            # dep -- job.py:525-533; counting only non-mutual deps here
            # removes that race without changing well-ordered schedules.)
            return
        child = int(self.edge_dst[dep_i])
        self.parent_deps_done[child] += 1
        if self.parent_deps_done[child] == self.num_parents[child]:
            if not self.op_completed[child]:
                self.ops_ready.add(child)

    # ------------------------------------------------------------------ queries
    def is_training_step_complete(self) -> bool:
        return (self.n_ops_completed == len(self.op_ids)
                and self.n_deps_completed == len(self.edge_ids))


class Job:
    """A training job: graph + SLA + bookkeeping + (optional) exec state.

    ``original_job`` points at the unpartitioned job when this Job was built
    by a partitioning transform (reference: job.py:77-79,109-118).
    """

    _id_counter = 0

    def __init__(self,
                 graph: OpGraph,
                 num_training_steps: int,
                 max_acceptable_jct_frac: float,
                 job_id: Optional[int] = None,
                 details: Optional[dict] = None,
                 immutable_details: Optional[dict] = None,
                 original_job: Optional["Job"] = None):
        if not (0 < max_acceptable_jct_frac <= 1):
            raise ValueError(
                "max_acceptable_jct_frac must satisfy 0 < frac <= 1, got "
                f"{max_acceptable_jct_frac}")
        self.graph = graph
        self.num_training_steps = num_training_steps
        self.max_acceptable_jct_frac = max_acceptable_jct_frac
        if job_id is None:
            Job._id_counter += 1
            job_id = Job._id_counter
        self.job_id = job_id
        self.details: dict = dict(details or {})
        self.details.setdefault("model", graph.meta.get("model", "unknown"))

        if immutable_details is None:
            immutable_details = compute_immutable_details(graph, num_training_steps)
        self.immutable = immutable_details
        self.details.update(immutable_details)

        self.details["max_acceptable_job_completion_time"] = (
            self.max_acceptable_jct_frac
            * self.immutable["job_sequential_completion_time"])

        self.reset_mutable_details()
        self.state: Optional[ExecState] = None
        # per-edge placed communication times, set by the comm model after op
        # placement; survives training-step resets (the reference keeps
        # these as edge 'init_run_time' attributes, job.py:461-464). The
        # canonical store on the hot path is the aligned array
        # (graph.edge_ids order); the dict view is materialised lazily for
        # the fallback/host-engine readers
        self._dep_init_run_time: Optional[Dict[EdgeId, float]] = {}
        self.dep_init_run_time_arr = None
        self.training_step_counter = 0
        self.original_job = original_job if original_job is not None else self

    # ------------------------------------------------------------------ lifecycle
    def reset_mutable_details(self) -> None:
        """(reference: job.py:160-175 _init_job_mutable_details)"""
        self.details["communication_overhead_time"] = 0.0
        self.details["computation_overhead_time"] = 0.0
        self.details["mounted_workers"] = set()
        self.details["mounted_channels"] = set()

    def reset_training_step(self) -> ExecState:
        self.state = ExecState(self.graph, self.dep_init_run_time)
        return self.state

    @property
    def dep_init_run_time(self) -> Dict[EdgeId, float]:
        """Dict view of the placed per-dep times (lazy: the hot path keeps
        only the aligned array; fallback readers materialise this once)."""
        if self._dep_init_run_time is None:
            arr = self.dep_init_run_time_arr
            self._dep_init_run_time = (
                dict(zip(self.graph.edge_ids, arr.tolist()))
                if arr is not None else {})
        return self._dep_init_run_time

    def set_dep_init_run_time(self, edge: EdgeId, run_time: float) -> None:
        self.dep_init_run_time[edge] = float(run_time)
        self.dep_init_run_time_arr = None  # single-edge write: mirror stale
        if self.state is not None:
            self.state.set_dep_init_run_time(edge, run_time)

    def set_dep_init_run_times_bulk(self, times) -> None:
        """Set every dep's initial run time from an array aligned with
        ``graph.edge_ids`` order (the hot path prices all deps at once)."""
        self.dep_init_run_time_arr = np.asarray(times, np.float64).copy()
        self._dep_init_run_time = None  # dict view rebuilt on demand
        if self.state is not None:
            arr = self.dep_init_run_time_arr
            self.state.init_dep_run_time[:] = arr
            self.state.remaining_dep[:] = arr

    def register_arrived(self, time_arrived: float, job_idx: int) -> None:
        self.details["time_arrived"] = time_arrived
        self.details["time_started"] = None
        self.details["time_completed"] = None
        self.details["job_idx"] = job_idx
        if self.original_job is not self:
            self.original_job.details["job_idx"] = job_idx

    def register_running(self, time_started: float) -> None:
        self.details["time_started"] = time_started

    def register_completed(self, time_completed: float) -> None:
        self.details["time_completed"] = time_completed

    # ------------------------------------------------------------------ queries
    @property
    def seq_completion_time(self) -> float:
        return self.immutable["job_sequential_completion_time"]

    @property
    def max_acceptable_jct(self) -> float:
        return self.details["max_acceptable_job_completion_time"]

    def is_job_complete(self) -> bool:
        return self.training_step_counter == self.num_training_steps

    def clone_fresh(self, job_id: Optional[int] = None) -> "Job":
        """A fresh (unstarted) copy of this job sharing immutable details."""
        return Job(graph=self.graph,
                   num_training_steps=self.num_training_steps,
                   max_acceptable_jct_frac=self.max_acceptable_jct_frac,
                   job_id=job_id,
                   details={"model": self.details["model"]},
                   immutable_details=self.immutable)

    def __repr__(self) -> str:
        return (f"Job(id={self.job_id}, model={self.details.get('model')!r}, "
                f"n_ops={self.graph.n_ops}, n_deps={self.graph.n_deps}, "
                f"steps={self.num_training_steps}, "
                f"seq_jct={self.seq_completion_time:.3f}, "
                f"max_frac={self.max_acceptable_jct_frac})")
