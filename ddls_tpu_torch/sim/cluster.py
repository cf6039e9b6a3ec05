"""The RAMP cluster discrete-event simulator.

Counterpart of the reference's ``RampClusterEnvironment``
(ddls/environments/ramp_cluster/ramp_cluster_environment.py:74). Key design,
identical in spirit: because RAMP's validity rules guarantee no contention
(at most one job per worker and per channel), a job's completion time can be
computed *once* when it is mounted by an internal lookahead simulation of a
single training step (``_run_lookahead``, reference :379); the outer event
loop then only advances wall-clock time between {job arrival, job completion,
simulation end} events (reference step :894).

Lookahead tick semantics (reference :379-467):

1. on each worker holding the job, select the highest-priority *ready* op;
   the shortest remaining run time among selected ops bounds the tick;
2. ready deps that never became flows (zero size, or same source/destination
   server) complete at zero cost and suppress flow consideration this tick;
3. otherwise the highest-priority ready dep per channel is found, channel
   contention is resolved in favour of the highest priority contender, and
   the shortest remaining communication time bounds the tick;
4. tick = min(op bound, dep bound); selected ops are ticked, and -- matching
   the reference's documented simplification (:756) -- *all* ready flow deps
   are ticked in parallel regardless of schedule;
5. communication/computation overlap is accounted per tick (:777).

Memoisation: lookahead results and partitioned graphs are cached per
(model, max partition degree) -- this cache is what makes episodes cheap
(reference :269-277, :469-506).

Deviation from the reference (documented): channel-contention losers are
chosen against the best *contending* priority rather than the global maximum
of all priority deps (reference :642 takes a global argmax, which can delete
non-contending deps); this only affects tick granularity, never which deps
ultimately transfer.

Port: a copy of ``ddls_tpu/sim/cluster.py``. ``use_jax_lookahead=True``
keeps the reference's name and runs each cache-miss lookahead on the array
engine (``sim/lookahead.py``) on the cluster's ``device``: K21 on the CUDA
card (the default), its plain version with ``device="cpu"``. A
``scenario_runtime`` (``scenarios/failures.py``) inflates each registered
job's completion time as the reference's does. Left out: the
flight-recorder emits (off by default; they change no output), the
failure windows' crossing events among them; the window pointer advances
as the reference's. The host engine, the native (C++) engine and the memo
stay.
"""
from __future__ import annotations

import math
import pathlib
import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from ddls_tpu_torch import telemetry as _telemetry
from ddls_tpu_torch.demands.job import Job
from ddls_tpu_torch.demands.job_queue import JobQueue
from ddls_tpu_torch.demands.jobs_generator import JobsGenerator
from ddls_tpu_torch.hardware.topologies import build_topology
from ddls_tpu_torch.utils import Stopwatch, seed_everything, unique_experiment_dir
from ddls_tpu_torch.utils.common import save_logs_to_dir, snapshot_logs

EdgeId = Tuple[str, str]


class RampClusterEnvironment:
    def __init__(self,
                 topology_config: dict,
                 node_config: dict,
                 name: str = "ramp_cluster",
                 path_to_save: Optional[str] = None,
                 save_freq: int = 1,
                 use_sqlite_database: bool = False,
                 suppress_warnings: bool = True,
                 use_jax_lookahead: bool = False,
                 use_native_lookahead: str | bool = "auto",
                 machine_epsilon: float = 1e-7,
                 scenario_runtime=None,
                 device: str = "cuda"):
        self.name = name
        # scenario subsystem (ddls_tpu_torch/scenarios): deterministic
        # failure windows + device-speed multipliers, applied as
        # completion-time inflation at lookahead REGISTRATION — every
        # lookahead backend stays nominal; None (the default) keeps the
        # nominal path
        self.scenario_runtime = scenario_runtime
        # the array lookahead engine's device (use_jax_lookahead, and the
        # env's candidate_pricing="jax"): K21 on "cuda", the plain version
        # on "cpu"; without a card the opt-in raises here
        self.device = device
        if use_jax_lookahead:
            from ddls_tpu_torch.sim.lookahead import engine_device
            engine_device(device)
        self.use_jax_lookahead = bool(use_jax_lookahead)
        self.use_sqlite_database = use_sqlite_database
        # C++ lookahead engine (ddls_tpu_torch/native): bit-exact with the
        # host engine; "auto" enables it, and a failed build raises
        if use_native_lookahead == "auto":
            from ddls_tpu_torch.native import native_available
            use_native_lookahead = native_available()
        self.use_native_lookahead = bool(use_native_lookahead)
        self.machine_epsilon = machine_epsilon
        self.suppress_warnings = suppress_warnings
        self.save_freq = save_freq
        self.path_to_save = (unique_experiment_dir(path_to_save, name)
                             if path_to_save is not None else None)

        self.topology_config = topology_config
        self.node_config = node_config
        self.topology = build_topology(topology_config)
        self.topology.populate_workers(node_config)

        self.stopwatch = Stopwatch()
        self.reset_counter = 0
        self._save_thread: Optional[threading.Thread] = None
        # topology-lifetime pricing caches: server-id code tables and
        # per-server-set spans (populated lazily by sim.actions), and the
        # all-reduce pricing memo keyed by (message_size, servers, racks,
        # comm groups) — topology params are fixed for the cluster's life
        self._server_code_tables: Optional[tuple] = None
        self._span_cache: Dict[frozenset, tuple] = {}
        self.comm_time_cache: Dict[tuple, float] = {}

    # ------------------------------------------------------------------ reset
    def reset(self,
              jobs_config,
              max_simulation_run_time: float = float("inf"),
              job_queue_capacity: int = 10,
              seed: Optional[int] = None,
              verbose: bool = False):
        self.reset_counter += 1
        if seed is not None:
            seed_everything(seed)
        self.seed = seed
        self.stopwatch.reset()

        if isinstance(jobs_config, JobsGenerator):
            self.jobs_generator = jobs_config
        else:
            self.jobs_generator = JobsGenerator(**jobs_config)
        self.max_simulation_run_time = (
            float("inf") if max_simulation_run_time is None
            else max_simulation_run_time)

        self.topology.reset_devices()
        self.job_queue = JobQueue(queue_capacity=job_queue_capacity)

        self.num_jobs_arrived = 0
        # worker-seconds of demand that have ARRIVED (blocked arrivals
        # included): the numerator of the online per-server load estimate
        # rho = sum / elapsed / n_servers that AdaptiveDegreePacking reads
        # (envs/baselines.py). Accumulated at arrival, not at decision
        # time, so queue-capacity-blocked jobs still count — a
        # per-decision estimate is biased low exactly in overload
        # (ADVICE r5 item 2)
        self.sum_arrived_seq_completion_time = 0.0
        self.load_rates: List[float] = []
        self.mounted_workers: Set[str] = set()
        self.mounted_channels: Set[str] = set()
        self.jobs_running: Dict[int, Job] = {}
        self.jobs_completed: Dict[int, Job] = {}
        self.jobs_blocked: Dict[int, Job] = {}
        # job_idx -> {op_id -> worker_id}: nested per job so placement
        # lookups avoid tuple-key hashing and removal drops one entry
        self.job_op_to_worker: Dict[int, Dict[str, str]] = {}
        # values are shared frozensets (one per distinct channel tuple of a
        # dep placement) assigned wholesale in _place_deps — never mutated
        self.job_dep_to_channels: Dict[int, Dict[EdgeId, frozenset]] = {}
        # array dep pipeline (dense single-channel complete topologies):
        # per-channel occupancy (-1 free, else job_idx) + per-job DepArrays
        # payloads; the dict mirrors above stay empty on this path
        self.channel_occ = np.full(
            len(self.topology.channel_id_to_channel), -1, np.int32)
        self.job_dep_arrays: Dict[int, Any] = {}
        # per-op dense server codes per mounted job (stashed from the
        # pricing pass): lets the lookahead memo key canonicalise the
        # worker grouping with one vectorised pass instead of a dict walk
        self.job_server_codes: Dict[int, Any] = {}
        self.job_id_to_job_idx: Dict[int, int] = {}
        self.job_idx_to_job_id: Dict[int, int] = {}
        self.job_op_placement: Dict[int, Dict[str, str]] = {}
        # values are DepPlacement.action entries: dep -> channel-id tuple
        # (shared per server pair; (None,) for non-flows)
        self.job_dep_placement: Dict[int, Dict[EdgeId, tuple]] = {}
        self.step_counter = 0
        self.action = None
        self.op_partition = None
        # scenario bookkeeping: the next failure window whose t0 the clock
        # has not crossed yet, and the per-job ADJUSTED jct ledger (==
        # nominal when no scenario) that survives unmount — the env's
        # end-of-sim sweep reads it (envs/partitioning_env.py)
        self._scenario_emit_ptr = 0
        self.job_adjusted_jct: Dict[int, float] = {}

        # memo caches: partition_cache is keyed by (model, full split map)
        # and lookahead_cache by (model, split map, canonical worker
        # grouping, priced dep-time bytes) — see _lookahead_cache_key; both
        # key sets fully determine the cached outcomes, so the caches
        # persist across resets while the workload stays the same (training
        # episodes 2+ reuse all partition/lookahead work) and are dropped
        # when the dataset (or num_training_steps, which scales cached
        # lookahead results) changes.
        sig = self._workload_signature()
        if sig != getattr(self, "_cache_signature", object()):
            self._cache_signature = sig
            self.partition_cache: Dict[Tuple[str, int], dict] = {}
            self.lookahead_cache: Dict[Tuple[str, int], tuple] = {}

        self.steps_log = defaultdict(list)
        self.episode_stats = self._init_episode_stats()
        self.step_stats = self._init_step_stats()

        # first arrival at t=0
        self.time_next_job_to_arrive = 0.0
        self.job_queue.add(self._get_next_job())
        return None

    def _workload_signature(self) -> tuple:
        """Workload identity for memo-cache validity across resets.

        Cached partition/lookahead outcomes depend on the graph files (by
        model name) and on ``num_training_steps`` (which scales cached
        lookahead results); anything else in the jobs config (arrival
        process, SLA dists, sampling mode) never enters the caches. The
        fingerprint is computed by the generator at load time from the
        exact files it loaded (or the deterministic synthetic config), so
        later on-disk changes cannot alias two different datasets."""
        fingerprint = getattr(self.jobs_generator, "workload_fingerprint",
                              None)
        if fingerprint is None:
            # duck-typed generator stand-in with no fingerprint: a fresh
            # sentinel never matches, so the caches are always cleared
            # (id()-based identity could alias two workloads after GC)
            return ("no-fingerprint", object())
        return fingerprint

    def _init_step_stats(self) -> dict:
        s = defaultdict(float)
        s["step_counter"] = self.step_counter
        s["step_start_time"] = self.stopwatch.time()
        for key in ("mean_num_mounted_workers", "mean_num_mounted_channels",
                    "mean_num_jobs_running", "mean_compute_overhead_frac",
                    "mean_communication_overhead_frac",
                    "mean_mounted_worker_utilisation_frac",
                    "mean_cluster_worker_utilisation_frac"):
            s[key] = []
        for key in ("num_jobs_completed", "num_jobs_arrived",
                    "num_jobs_blocked"):
            s[key] = 0
        return s

    def _init_episode_stats(self) -> dict:
        e = defaultdict(list)
        e["num_jobs_arrived"] = 0
        e["num_jobs_completed"] = 0
        e["num_jobs_blocked"] = 0
        e["episode_start_time"] = self.stopwatch.time()
        return e

    # ---------------------------------------------------------------- arrivals
    def _get_next_job(self) -> Job:
        job = self.jobs_generator.sample_job()
        job_idx = self.num_jobs_arrived
        job.register_arrived(time_arrived=self.stopwatch.time(), job_idx=job_idx)
        time_last = self.stopwatch.time()
        self.time_next_job_to_arrive += self.jobs_generator.sample_interarrival_time()
        gap = self.time_next_job_to_arrive - time_last
        if gap > 0 and math.isfinite(gap):
            self.load_rates.append(
                (job.immutable["job_total_op_memory_cost"]
                 + job.immutable["job_total_dep_size"]) / gap)
        if job_idx in self.job_idx_to_job_id or job.job_id in self.job_id_to_job_idx:
            raise RuntimeError(
                f"duplicate job idx {job_idx} / id {job.job_id}; ids must be "
                "unique across the simulation")
        self.job_idx_to_job_id[job_idx] = job.job_id
        self.job_id_to_job_idx[job.job_id] = job_idx
        self.num_jobs_arrived += 1
        self.sum_arrived_seq_completion_time += float(
            job.seq_completion_time)
        self.last_job_arrived_job_idx = job_idx
        self.episode_stats["num_jobs_arrived"] += 1
        return job

    # ---------------------------------------------------------------- lookahead
    def _run_lookahead(self, job: Job):
        """Simulate one training step of a freshly mounted job; returns
        (jct, comm_overhead, comp_overhead, busy) where the first three are
        scaled by num_training_steps and ``busy`` is the worker-busy time
        integral (sum of active-worker count x tick) of the single
        simulated step."""
        job_idx = job.details["job_idx"]
        state = job.reset_training_step()
        graph = job.graph

        workers_with_job = [
            w for w in self.topology.workers.values()
            if job_idx in w.mounted_job_idx_to_ops]

        # precompute static per-tick structures (flow-ness, sorted op lists
        # per worker with op indices, per-channel sorted dep indices) --
        # these never change during the lookahead
        op_to_worker = self.job_op_to_worker[job_idx]
        is_flow = np.zeros(graph.n_deps, dtype=bool)
        for ei, (u, v) in enumerate(state.edge_ids):
            if graph.edge_size(u, v) == 0:
                continue
            src_w = op_to_worker[u]
            dst_w = op_to_worker[v]
            is_flow[ei] = (self.topology.worker_to_server[src_w]
                           != self.topology.worker_to_server[dst_w])
        worker_op_lists = []
        for w in workers_with_job:
            pri_map = w.op_priority.get(job_idx, {})
            worker_op_lists.append(
                [(state.op_index[op_id], pri_map.get(op_id, 0))
                 for op_id in sorted(w.mounted_job_idx_to_ops[job_idx])])
        payload = self.job_dep_arrays.get(job_idx)
        if payload is not None:
            # array pipeline: group flow deps per dense channel, each group
            # in sorted-edge-id order (edge_sorted_rank), priorities from
            # the payload — the same lists the dict path builds, read off
            # arrays. SRPT priorities are globally unique, so within- and
            # across-channel ordering can't change any tick outcome.
            rank = graph.finalize()["edge_sorted_rank"]
            chan = payload.chan
            pri_arr = (payload.pri if payload.pri is not None
                       else np.zeros(chan.shape[0], np.int64))
            flow_i = np.nonzero(chan >= 0)[0]
            order = flow_i[np.argsort(rank[flow_i], kind="stable")]
            by_ch: Dict[int, list] = {}
            chan_l = chan.tolist()
            pri_l = pri_arr.tolist()
            for i in order.tolist():
                by_ch.setdefault(chan_l[i], []).append((i, pri_l[i]))
            channel_dep_lists = list(by_ch.items())
        else:
            channels_with_job = [
                ch for ch in self.topology.channel_id_to_channel.values()
                if job_idx in ch.mounted_job_idx_to_deps]
            channel_dep_lists = []
            for ch in channels_with_job:
                pri_map = ch.dep_priority.get(job_idx, {})
                channel_dep_lists.append(
                    (ch.channel_id,
                     [(state.edge_index[dep], pri_map.get(dep, 0))
                      for dep in sorted(ch.mounted_job_idx_to_deps[job_idx])]))

        t = comm_oh = comp_oh = busy = 0.0
        guard = 0
        while True:
            guard += 1
            if guard > 1_000_000:
                raise RuntimeError("lookahead failed to converge (engine bug)")

            # 1. highest-priority ready op per worker
            selected_ops: List[int] = []
            for op_list in worker_op_lists:
                best_i, best_pri = None, None
                for oi, pri in op_list:
                    if oi in state.ops_ready and (
                            best_pri is None or pri > best_pri):
                        best_i, best_pri = oi, pri
                if best_i is not None:
                    selected_ops.append(best_i)
            shortest_op = min(
                (state.remaining_op[i] for i in selected_ops),
                default=float("inf"))

            # 2. ready non-flow deps (zero size or same server) are free
            non_flow = [ei for ei in state.deps_ready if not is_flow[ei]]

            # 3. flow bound via per-channel priority deps + contention
            if non_flow:
                shortest_comm = 0.0
            else:
                channel_to_pri_dep: Dict[str, int] = {}
                dep_to_pri: Dict[int, int] = {}
                dep_to_channels: Dict[int, Set[str]] = defaultdict(set)
                for ch_id, dep_list in channel_dep_lists:
                    best_dep, best_pri = None, None
                    for ei, pri in dep_list:
                        if ei in state.deps_ready and (
                                best_pri is None or pri > best_pri):
                            best_dep, best_pri = ei, pri
                    if best_dep is not None:
                        channel_to_pri_dep[ch_id] = best_dep
                        dep_to_pri[best_dep] = best_pri
                        dep_to_channels[best_dep].add(ch_id)
                # contention: among deps sharing a channel keep the highest
                # priority one
                for dep in list(dep_to_channels):
                    if dep not in dep_to_channels:
                        continue
                    contenders = {dep}
                    for ch_id in dep_to_channels[dep]:
                        other = channel_to_pri_dep.get(ch_id)
                        if other is not None and other != dep:
                            contenders.add(other)
                    if len(contenders) > 1:
                        winner = max(contenders, key=lambda d: dep_to_pri[d])
                        for loser in contenders - {winner}:
                            for ch_id in dep_to_channels.get(loser, ()):
                                channel_to_pri_dep.pop(ch_id, None)
                            dep_to_pri.pop(loser, None)
                            dep_to_channels.pop(loser, None)
                shortest_comm = min(
                    (state.remaining_dep[ei]
                     for ei in channel_to_pri_dep.values()),
                    default=float("inf"))

            tick = min(shortest_op, shortest_comm)
            if math.isinf(tick):
                raise RuntimeError(
                    f"infinite lookahead tick for job {job.job_id}: no ready "
                    "ops or deps can progress (engine bug)")

            # snapshot ready deps before op ticking so deps readied by op
            # completions this tick are not advanced a step early
            deps_snapshot = sorted(state.deps_ready,
                                   key=lambda ei: state.edge_ids[ei])

            ticked_ops = False
            active_workers = 0
            for oi in selected_ops:
                state.tick_op(oi, tick)
                ticked_ops = True
                active_workers += 1

            ticked_flows = False
            if non_flow:
                for ei in sorted(non_flow, key=lambda ei: state.edge_ids[ei]):
                    state.tick_dep(ei, tick)
            else:
                for ei in deps_snapshot:
                    state.tick_dep(ei, tick)
                    ticked_flows = True

            if ticked_ops and ticked_flows:
                comm_oh += tick
                comp_oh += tick
            elif ticked_flows:
                comm_oh += tick
            elif ticked_ops:
                comp_oh += tick

            busy += active_workers * tick
            t += tick

            if state.is_training_step_complete():
                break

        steps = job.num_training_steps
        return t * steps, comm_oh * steps, comp_oh * steps, busy

    def _lookahead_cache_key(self, job: Job, job_id: int) -> tuple:
        """A signature that fully determines the lookahead outcome.

        The reference memoises on (model, max partition degree) alone
        (:269-277), which silently reuses results across *different
        placements* of the same model. The outcome is exactly determined by
        (a) the split map (hence the partitioned graph and its costs),
        (b) which ops share a worker (canonicalised worker grouping -- all
        workers are identical and servers are symmetric), and (c) the placed
        per-dep communication times. Keying on those keeps the cache exact
        while still collapsing the common repeated-placement case.
        """
        job_idx = job.details["job_idx"]
        split = tuple(sorted(
            self.op_partition.job_id_to_split_forward_ops[job_id].items()))
        sc = self.job_server_codes.get(job_idx)
        if sc is not None and len(sc) == job.graph.n_ops:
            # worker grouping == server grouping (1 worker/server): the
            # canonical first-appearance renumbering of the code array,
            # fully vectorised. Identical tuple to the dict walk.
            _, first_idx, inv = np.unique(sc, return_index=True,
                                          return_inverse=True)
            rank = np.argsort(np.argsort(first_idx))
            return self._assemble_lookahead_key(job, split,
                                                tuple(rank[inv].tolist()))
        return self.lookahead_key_for(job, split,
                                      self.job_op_to_worker[job_idx])

    @staticmethod
    def lookahead_key_for(job: Job, split: tuple,
                          op_to_worker: Dict[str, str]) -> tuple:
        """The exact lookahead memo key from explicit placement inputs —
        shared by the mounted path (_lookahead_cache_key) and candidate
        pricing (which keys an UNMOUNTED hypothetical placement so the
        eventual real placement hits the same entry)."""
        worker_to_group: Dict[str, int] = {}
        groups = []
        for op in job.graph.op_ids:
            w = op_to_worker[op]
            groups.append(worker_to_group.setdefault(w, len(worker_to_group)))
        return RampClusterEnvironment._assemble_lookahead_key(
            job, split, tuple(groups))

    @staticmethod
    def _assemble_lookahead_key(job: Job, split: tuple,
                                groups: tuple) -> tuple:
        """Single assembly point for the memo key tuple: every key builder
        (dict walk, vectorised code-array path, candidate pricing) must
        come through here so the namespaces can never diverge."""
        # the placed per-dep times as raw bytes: equivalent to (and ~100x
        # cheaper than) a tuple of the same floats in edge order
        arr = getattr(job, "dep_init_run_time_arr", None)
        if arr is not None:
            dep_times = arr.tobytes()
        else:
            dep_times = tuple(job.dep_init_run_time.get(e, 0.0)
                              for e in job.graph.edge_ids)
        return (job.details["model"], split, groups, dep_times)

    def _perform_lookahead_job_completion_time(self, action) -> None:
        for job_id in sorted(action.job_ids):
            job_idx = self.job_id_to_job_idx[job_id]
            job = self.jobs_running[job_idx]
            key = self._lookahead_cache_key(job, job_id)
            cached = self.lookahead_cache.get(key)
            # which engine serves THIS decision's lookahead ("cache" on a
            # memo hit): telemetry counters
            backend = "cache"
            if cached is None:
                # the explicit array-engine opt-in outranks the
                # auto-enabled native engine; the host engine serves what
                # either leaves (and raises with diagnostics where the
                # engine is wrong)
                backend = "host"
                if self.use_jax_lookahead:
                    cached = self._run_jax_lookahead(job)
                    if cached is not None:
                        backend = "jax"
                if cached is None and self.use_native_lookahead:
                    cached = self._run_native_lookahead(job)
                    if cached is not None:
                        backend = "native"
                if cached is None:  # disabled, or the engine bailed
                    cached = self._run_lookahead(job)
                self.lookahead_cache[key] = cached
                if _telemetry.enabled():
                    _telemetry.inc("sim.lookahead_cache.miss")
                    _telemetry.inc(f"sim.lookahead.backend.{backend}")
            elif _telemetry.enabled():
                _telemetry.inc("sim.lookahead_cache.hit")
            # one simulated training step happened for this job, whichever
            # backend (host/native/jax) served it and whether or not the
            # memo cache did — keeps job.training_step_counter meaningful
            # independent of engine choice (RAMP-path completion itself is
            # event-driven off the lookahead JCT, not this counter)
            job.training_step_counter += 1
            jct, comm_oh, comp_oh, busy = cached
            self._register_completed_lookahead(job, jct, comm_oh, comp_oh,
                                               busy)

    def _run_native_lookahead(self, job: Job):
        """Cache-miss lookahead on the C++ engine (ddls_tpu_torch/native):
        identical semantics AND identical f64 arithmetic order to
        ``_run_lookahead``, so results are bit-exact with the host engine.
        Returns None when the engine bails (caller falls through to the
        host engine)."""
        from ddls_tpu_torch.native import run_lookahead
        from ddls_tpu_torch.sim.lookahead_arrays import \
            build_native_lookahead_arrays

        arrays = build_native_lookahead_arrays(cluster=self, job=job)
        result = run_lookahead(arrays)
        if result is None:
            return None
        t, comm, comp, busy = result
        steps = job.num_training_steps
        return t * steps, comm * steps, comp * steps, busy

    def _run_jax_lookahead(self, job: Job):
        """Cache-miss lookahead on the array engine (opt-in), on the
        cluster's device: one K21 launch on CUDA. Pads op/dep counts up to
        power-of-two buckets; returns None (the native, then the host
        engine serve it) when the job does not fit the padding (more
        channels per flow than ``pad_links``)."""
        from ddls_tpu_torch.sim.lookahead import bucket, run_lanes
        from ddls_tpu_torch.sim.lookahead_arrays import \
            build_lookahead_arrays

        try:
            arrays = build_lookahead_arrays(
                job=job, cluster=self,
                pad_ops=bucket(job.graph.n_ops),
                pad_deps=bucket(job.graph.n_deps),
                pad_links=2)
        except ValueError:
            # padding overflow only; bookkeeping errors (KeyError) must
            # crash as loudly as they would on the host path
            return None
        (result,) = run_lanes([arrays], self.device)
        if result is None:
            raise RuntimeError(
                f"array lookahead failed to converge for job {job.job_id} "
                "(engine bug)")
        t, comm, comp, busy = result
        steps = job.num_training_steps
        return t * steps, comm * steps, comp * steps, busy

    def _register_completed_lookahead(self, job: Job, jct: float,
                                      comm_oh: float, comp_oh: float,
                                      busy: float) -> None:
        """(reference: :793-892)"""
        if jct > job.max_acceptable_jct:
            # SLA violated: block the original job, unmount the partitioned one
            self._register_blocked_job(
                job.original_job,
                cause="max_acceptable_job_completion_time_exceeded")
            self._remove_job_from_cluster(job)
            return

        # busy covers ONE training step; normalise by the single-step
        # time (jct / num_training_steps), not the full scaled JCT
        n_mounted = max(len(job.details["mounted_workers"]), 1)
        step_time = jct / max(job.num_training_steps, 1)
        util = busy / (n_mounted * step_time) if step_time > 0 else 0.0

        # scenario inflation (scenarios/failures.py): the SLA gate above and
        # util stay NOMINAL (admission is failure-blind by design); only
        # the realized completion time is adjusted. The device episode's
        # decision applies the same walk (sim/device_env.py).
        job.details["nominal_lookahead_jct"] = jct
        sr = self.scenario_runtime
        if sr is not None and not sr.is_nominal:
            jct = self._scenario_adjusted_jct(job, jct)
        self.job_adjusted_jct[job.details["job_idx"]] = jct

        job.details["lookahead_job_completion_time"] = jct
        job.details["communication_overhead_time"] = comm_oh
        job.details["computation_overhead_time"] = comp_oh
        job.details["mean_mounted_worker_utilisation_frac"] = util

        # total size of deps that became flows (nonzero placed run time)
        arr = getattr(job, "dep_init_run_time_arr", None)
        if arr is not None:
            flow_size = float(
                job.graph.finalize()["edge_size"][arr != 0].sum())
        else:
            flow_size = 0.0
            for edge, run_time in job.dep_init_run_time.items():
                if run_time != 0:
                    flow_size += job.graph.edge_size(*edge)
        job.details["job_total_flow_size"] = flow_size

    def _scenario_adjusted_jct(self, job: Job, nominal: float) -> float:
        """Adjusted completion time under the attached ScenarioRuntime:
        progress gated at the slowest mounted server's speed, failure
        windows (on mounted servers/channels) multiplied on top — the
        shared formula in scenarios/failures.py, which the device
        episode's walk mirrors in the same op order (reference:
        :667-689)."""
        from ddls_tpu_torch.scenarios.failures import (
            FAILURE_WORKER_PREEMPT, inflate_duration)

        sr = self.scenario_runtime
        server_index = self.topology.dense_tables()["server_index"]
        w2s = self.topology.worker_to_server
        srv = {server_index[w2s[w]]
               for w in job.details["mounted_workers"]}
        r0 = min((float(sr.speeds[i]) for i in srv), default=1.0)
        chans = job.details["mounted_channels"]
        affects = [
            (w["resource"] in srv)
            if w["kind"] == FAILURE_WORKER_PREEMPT
            else (w["resource"] in chans)
            for w in sr.windows]
        return inflate_duration(job.details["time_started"], nominal, r0,
                                sr.win_t0, sr.win_t1, sr.win_rate, affects)

    # ------------------------------------------------------------------- step
    def step(self, action, verbose: bool = False):
        self.action = action
        self.step_stats = self._init_step_stats()

        # queued jobs not handled by every sub-action are blocked; the cause
        # is the first sub-action that dropped the job (reference:
        # action.py:36-48 surfaced into blocked stats)
        for job_id, job in list(self.job_queue.jobs.items()):
            if job_id not in action.job_ids:
                cause = action.job_id_to_cause_of_unsuccessful_handling.get(
                    job_id, "not_handled")
                self._register_blocked_job(job, cause=cause)

        if action.actions["op_partition"] is not None:
            self._partition_ops(action.actions["op_partition"])
        if action.actions["op_placement"] is not None:
            self._place_ops(action.actions["op_placement"])
        if action.actions["op_schedule"] is not None:
            self._schedule_ops(action.actions["op_schedule"])
        if action.actions["dep_placement"] is not None:
            self._place_deps(action.actions["dep_placement"])
        if action.actions["dep_schedule"] is not None:
            self._schedule_deps(action.actions["dep_schedule"])

        self._perform_lookahead_job_completion_time(action)

        # advance wall clock to the next event
        step_done = False
        while not step_done:
            tick = min(self.time_next_job_to_arrive - self.stopwatch.time(),
                       self.max_simulation_run_time - self.stopwatch.time())
            for job in self.jobs_running.values():
                elapsed = self.stopwatch.time() - job.details["time_started"]
                remaining = (job.details["lookahead_job_completion_time"]
                             - elapsed)
                tick = min(tick, remaining)
            tick = max(tick, 0.0)

            self._accumulate_tick_stats(tick)
            self.stopwatch.tick(tick)

            # scenario failure windows: the reference emits each window's
            # crossing event once when the clock first passes its t0 (the
            # port has no flight recorder); the pointer advances as its
            # does (reference: :736-760)
            sr = self.scenario_runtime
            if sr is not None and self._scenario_emit_ptr < len(sr.windows):
                now = self.stopwatch.time()
                while (self._scenario_emit_ptr < len(sr.windows)
                       and sr.windows[self._scenario_emit_ptr]["t0"] <= now):
                    self._scenario_emit_ptr += 1

            completed = []
            for job in self.jobs_running.values():
                elapsed = self.stopwatch.time() - job.details["time_started"]
                remaining = (job.details["lookahead_job_completion_time"]
                             - elapsed - self.machine_epsilon)
                if remaining <= 0:
                    completed.append(job)
                    step_done = True
            for job in completed:
                self._register_completed_job(job)

            if len(self.jobs_generator) > 0:
                if (self.stopwatch.time() + self.machine_epsilon
                        >= self.time_next_job_to_arrive):
                    nxt = self._get_next_job()
                    self.step_stats["num_jobs_arrived"] += 1
                    if self.job_queue.can_fit(nxt):
                        self.job_queue.add(nxt)
                    else:
                        self._register_blocked_job(
                            nxt, cause="job_queue_full")
                    step_done = True
            else:
                self.time_next_job_to_arrive = float("inf")

            if self.is_done():
                step_done = True

        self._finalise_step_stats()
        self.step_counter += 1
        if self.is_done():
            self._finalise_episode_stats()
        if self.path_to_save is not None and (
                self.step_counter % self.save_freq == 0 or self.is_done()):
            self.save()
            if self.is_done() and self._save_thread is not None:
                self._save_thread.join()
        return None, None, None, self.is_done(), None

    # ------------------------------------------------------------ sub-actions
    def _partition_ops(self, op_partition) -> None:
        self.op_partition = op_partition
        for job_id in op_partition.action:
            self.job_queue.jobs[job_id] = op_partition.partitioned_jobs[job_id]

    def _place_ops(self, op_placement) -> None:
        for job_id, op_to_worker in op_placement.action.items():
            job = self.job_queue.jobs[job_id]
            job_idx = job.details["job_idx"]
            by_worker: Dict[str, list] = {}
            for op_id, worker_id in op_to_worker.items():
                by_worker.setdefault(worker_id, []).append(op_id)
            mounted_workers = job.details["mounted_workers"]
            for worker_id, op_ids in by_worker.items():
                worker = self.topology.workers[worker_id]
                # RAMP rule 1: at most one job per worker
                if any(idx != job_idx
                       for idx in worker.mounted_job_idx_to_ops):
                    raise RuntimeError(
                        f"RAMP rule violation: worker {worker_id} already "
                        f"holds job idx(s) "
                        f"{set(worker.mounted_job_idx_to_ops) - {job_idx}}, "
                        f"cannot mount job idx {job_idx}")
                worker.mount_ops(job, op_ids)
                mounted_workers.add(worker_id)
            self.job_op_to_worker.setdefault(job_idx, {}).update(
                op_to_worker)
            sc = op_placement.job_server_codes.get(job_id)
            if sc is not None:
                self.job_server_codes[job_idx] = sc
            self._register_running_job(job)
            self.job_op_placement[job_id] = dict(op_to_worker)

    def _register_running_job(self, job: Job) -> None:
        job.register_running(time_started=self.stopwatch.time())
        self.jobs_running[job.details["job_idx"]] = job
        self.job_queue.remove(job)
        # zero out non-flow dep run times now that placement is known
        job_idx = job.details["job_idx"]
        arrays = job.graph.finalize()
        if getattr(job, "dep_init_run_time_arr", None) is not None:
            worker_to_server = self.topology.worker_to_server
            op_to_worker = self.job_op_to_worker[job_idx]
            _, is_flow = job.graph.flow_mask(
                [worker_to_server[op_to_worker[op_id]]
                 for op_id in arrays["op_ids"]])
            job.set_dep_init_run_times_bulk(
                np.where(is_flow, job.dep_init_run_time_arr, 0.0))
            return
        for u, v in job.graph.edge_ids:
            if job.graph.edge_size(u, v) == 0:
                job.set_dep_init_run_time((u, v), 0.0)
            else:
                src_w = self.job_op_to_worker[job_idx][u]
                dst_w = self.job_op_to_worker[job_idx][v]
                if (self.topology.worker_to_server[src_w]
                        == self.topology.worker_to_server[dst_w]):
                    job.set_dep_init_run_time((u, v), 0.0)
                else:
                    job.set_dep_init_run_time(
                        (u, v), job.dep_init_run_time.get((u, v), 0.0))

    def _schedule_ops(self, op_schedule) -> None:
        for worker_id, job_to_ops in op_schedule.action.items():
            worker = self.topology.workers[worker_id]
            for job_id, op_to_pri in job_to_ops.items():
                job_idx = self.job_id_to_job_idx[job_id]
                worker.op_priority.setdefault(job_idx, {}).update(op_to_pri)

    def _place_deps(self, dep_placement) -> None:
        from ddls_tpu_torch.sim.actions import DepArrays

        if any(isinstance(v, DepArrays)
               for v in dep_placement.action.values()):
            for job_id, payload in dep_placement.action.items():
                job_idx = self.job_id_to_job_idx[job_id]
                job = self.jobs_running[job_idx]
                occ_vals = self.channel_occ[payload.channels]
                bad = (occ_vals != -1) & (occ_vals != job_idx)
                if bad.any():
                    # RAMP rule 2: at most one job per channel
                    raise RuntimeError(
                        f"RAMP rule violation: channels "
                        f"{payload.channels[bad][:8].tolist()} already hold "
                        f"other job idxs "
                        f"{self.channel_occ[payload.channels[bad]][:8].tolist()}")
                self.channel_occ[payload.channels] = job_idx
                self.job_dep_arrays[job_idx] = payload
                job.details["mounted_channels"].update(
                    payload.channels.tolist())
                self.job_dep_placement[job_id] = payload
            return
        channel_lookup = self.topology.channel_id_to_channel
        # keep channel_occ the single occupancy truth on dense topologies
        # even when a dict-style placement mounts (e.g. hand-crafted test
        # actions): the array placer reads only channel_occ for validity
        chan_index = self.topology.dense_tables()["channel_index"]
        jobdep_views = dep_placement.jobdep_to_channels
        for job_id, dep_to_channels in dep_placement.action.items():
            job_idx = self.job_id_to_job_idx[job_id]
            job = self.jobs_running[job_idx]
            # one pass grouping deps per channel, then bulk channel mounts:
            # same outcome as per-dep Channel.mount at a fraction of the cost
            ch_to_deps: Dict[str, list] = {}
            for dep_id in dep_to_channels:
                real = jobdep_views[(job_id, dep_id)]
                if not real:
                    continue
                self.job_dep_to_channels.setdefault(
                    job_idx, {})[dep_id] = real
                for ch_id in real:
                    lst = ch_to_deps.get(ch_id)
                    if lst is None:
                        lst = ch_to_deps.setdefault(ch_id, [])
                    lst.append(dep_id)
            mounted_channels = job.details["mounted_channels"]
            for ch_id, deps in ch_to_deps.items():
                channel = channel_lookup[ch_id]
                # RAMP rule 2: at most one job per channel — checked
                # against BOTH stores (an array-path job marks only
                # channel_occ, a dict-path job only the channel dicts)
                ci = chan_index.get(ch_id)
                occ = (self.channel_occ[ci] if ci is not None else -1)
                holders = (set(channel.mounted_job_idx_to_deps)
                           | {int(occ)}) - {-1, job_idx}
                if holders:
                    raise RuntimeError(
                        f"RAMP rule violation: channel {ch_id} already "
                        f"holds job idx(s) {holders}")
                channel.mounted_job_idx_to_deps.setdefault(
                    job_idx, set()).update(deps)
                mounted_channels.add(ch_id)
                ci = chan_index.get(ch_id)
                if ci is not None:
                    self.channel_occ[ci] = job_idx
            self.job_dep_placement[job_id] = dep_to_channels

    def _schedule_deps(self, dep_schedule) -> None:
        for ch_id, job_to_deps in dep_schedule.action.items():
            if ch_id is None:
                continue
            if ch_id == "__arrays__":
                # array pipeline: priorities already live inside each job's
                # DepArrays payload (written by the scheduler, mounted by
                # _place_deps); nothing to copy into channel dicts
                continue
            channel = self.topology.channel_id_to_channel[ch_id]
            for job_id, dep_to_pri in job_to_deps.items():
                job_idx = self.job_id_to_job_idx[job_id]
                channel.dep_priority.setdefault(job_idx, {}).update(
                    dep_to_pri)

    # -------------------------------------------------------------- lifecycle
    def _remove_job_from_cluster(self, job: Job) -> None:
        job_idx = job.details["job_idx"]
        if job.job_id in self.job_queue.jobs:
            self.job_queue.remove(job)
        self.jobs_running.pop(job_idx, None)
        # bulk unmount: drop the whole job from each device it touched in
        # one call per device instead of per op / per dep
        if self.job_op_to_worker.pop(job_idx, None) is not None:
            workers = self.topology.workers
            for worker_id in job.details["mounted_workers"]:
                workers[worker_id].unmount_job(job)
        self.job_server_codes.pop(job_idx, None)
        payload = self.job_dep_arrays.pop(job_idx, None)
        if payload is not None:
            self.channel_occ[payload.channels] = -1
        elif self.job_dep_to_channels.pop(job_idx, None) is not None:
            channel_lookup = self.topology.channel_id_to_channel
            chan_index = self.topology.dense_tables()["channel_index"]
            for ch_id in job.details["mounted_channels"]:
                channel_lookup[ch_id].unmount_job(job_idx)
                ci = chan_index.get(ch_id)
                if ci is not None:
                    self.channel_occ[ci] = -1
        self.job_op_placement.pop(job.job_id, None)
        self.job_dep_placement.pop(job.job_id, None)

    def _register_completed_job(self, job: Job) -> None:
        job.register_completed(time_completed=self.stopwatch.time())
        job_idx = job.details["job_idx"]
        self.jobs_completed[job_idx] = job
        self.step_stats["num_jobs_completed"] += 1
        self.episode_stats["num_jobs_completed"] += 1

        jct = job.details["time_completed"] - job.details["time_arrived"]
        e = self.episode_stats
        e["job_completion_time"].append(jct)
        e["job_completion_time_speedup"].append(
            job.seq_completion_time / jct if jct > 0 else 0.0)
        e["job_communication_overhead_time"].append(
            job.details["communication_overhead_time"])
        e["job_computation_overhead_time"].append(
            job.details["computation_overhead_time"])
        e["jobs_completed_num_nodes"].append(job.graph.n_ops)
        e["jobs_completed_num_edges"].append(job.graph.n_deps)
        e["jobs_completed_total_operation_memory_cost"].append(
            job.immutable["job_total_op_memory_cost"])
        e["jobs_completed_total_dependency_size"].append(
            job.immutable["job_total_dep_size"])
        e["jobs_completed_max_partitions_per_op"].append(
            job.details.get("max_partitions_per_op", 1))
        e["jobs_completed_job_sequential_completion_time"].append(
            job.seq_completion_time)
        e["jobs_completed_max_acceptable_job_completion_time_frac"].append(
            job.max_acceptable_jct_frac)
        e["jobs_completed_max_acceptable_job_completion_time"].append(
            job.max_acceptable_jct)
        e["jobs_completed_num_mounted_workers"].append(
            len(job.details["mounted_workers"]))
        e["jobs_completed_num_mounted_channels"].append(
            len(job.details["mounted_channels"]))
        e["jobs_completed_mean_mounted_worker_utilisation_frac"].append(
            job.details.get("mean_mounted_worker_utilisation_frac", 0.0))
        orig = job.original_job
        e["jobs_completed_original_demand_num_nodes"].append(orig.graph.n_ops)
        e["jobs_completed_original_demand_num_edges"].append(orig.graph.n_deps)
        e["jobs_completed_original_demand_total_operation_memory_cost"].append(
            orig.immutable["job_total_op_memory_cost"])
        e["jobs_completed_original_demand_total_dependency_size"].append(
            orig.immutable["job_total_dep_size"])

        self._remove_job_from_cluster(job)

    def _register_blocked_job(self, job: Job,
                              cause: str = "not_handled") -> None:
        job_idx = job.details["job_idx"]
        if job.job_id in self.job_queue.jobs:
            self.job_queue.remove(job)
        self.jobs_running.pop(job_idx, None)
        if job_idx in self.jobs_blocked:
            return
        self.jobs_blocked[job_idx] = job
        self.step_stats["num_jobs_blocked"] += 1
        self.episode_stats["num_jobs_blocked"] += 1
        e = self.episode_stats
        e["jobs_blocked_cause_of_unsuccessful_handling"].append(cause)
        e["jobs_blocked_num_nodes"].append(job.graph.n_ops)
        e["jobs_blocked_num_edges"].append(job.graph.n_deps)
        e["jobs_blocked_total_operation_memory_cost"].append(
            job.immutable["job_total_op_memory_cost"])
        e["jobs_blocked_total_dependency_size"].append(
            job.immutable["job_total_dep_size"])
        e["jobs_blocked_job_sequential_completion_time"].append(
            job.seq_completion_time)
        e["jobs_blocked_max_acceptable_job_completion_time_frac"].append(
            job.max_acceptable_jct_frac)
        e["jobs_blocked_max_acceptable_job_completion_time"].append(
            job.max_acceptable_jct)
        orig = job.original_job
        e["jobs_blocked_original_demand_num_nodes"].append(orig.graph.n_ops)
        e["jobs_blocked_original_demand_num_edges"].append(orig.graph.n_deps)
        e["jobs_blocked_original_demand_total_operation_memory_cost"].append(
            orig.immutable["job_total_op_memory_cost"])
        e["jobs_blocked_original_demand_total_dependency_size"].append(
            orig.immutable["job_total_dep_size"])

    # ------------------------------------------------------------------ stats
    def _accumulate_tick_stats(self, tick: float) -> None:
        s = self.step_stats
        self.mounted_workers, self.mounted_channels = set(), set()
        utilisations = []
        for job in self.jobs_running.values():
            jct = job.details["lookahead_job_completion_time"]
            frac = tick / jct if jct > 0 else 0.0
            s["compute_info_processed"] += (
                job.immutable["job_total_op_memory_cost"] * frac)
            s["dep_info_processed"] += (
                job.immutable["job_total_dep_size"] * frac)
            s["flow_info_processed"] += (
                job.details.get("job_total_flow_size", 0.0) * frac)
            s["cluster_info_processed"] += (
                (job.immutable["job_total_op_memory_cost"]
                 + job.immutable["job_total_dep_size"]) * frac)
            orig = job.original_job
            s["demand_compute_info_processed"] += (
                orig.immutable["job_total_op_memory_cost"] * frac)
            s["demand_dep_info_processed"] += (
                orig.immutable["job_total_dep_size"] * frac)
            s["demand_total_info_processed"] += (
                (orig.immutable["job_total_op_memory_cost"]
                 + orig.immutable["job_total_dep_size"]) * frac)
            if jct > 0:
                s["mean_compute_overhead_frac"].append(
                    job.details["computation_overhead_time"] / jct)
                s["mean_communication_overhead_frac"].append(
                    job.details["communication_overhead_time"] / jct)
            self.mounted_workers.update(job.details["mounted_workers"])
            self.mounted_channels.update(job.details["mounted_channels"])
            utilisations.append(
                job.details.get("mean_mounted_worker_utilisation_frac", 0.0))
        s["mean_num_jobs_running"].append(len(self.jobs_running))
        s["mean_num_mounted_workers"].append(len(self.mounted_workers))
        s["mean_num_mounted_channels"].append(len(self.mounted_channels))
        if utilisations:
            s["mean_mounted_worker_utilisation_frac"].append(
                float(np.mean(utilisations)))
            s["mean_cluster_worker_utilisation_frac"].append(
                (len(self.mounted_workers) / self.topology.num_workers)
                * float(np.mean(utilisations)))
        else:
            s["mean_mounted_worker_utilisation_frac"].append(0.0)
            s["mean_cluster_worker_utilisation_frac"].append(0.0)

    def _finalise_step_stats(self) -> None:
        s = self.step_stats
        s["step_end_time"] = self.stopwatch.time()
        s["step_time"] = s["step_end_time"] - s["step_start_time"]
        for key in ("mean_num_jobs_running", "mean_num_mounted_workers",
                    "mean_num_mounted_channels", "mean_compute_overhead_frac",
                    "mean_communication_overhead_frac",
                    "mean_mounted_worker_utilisation_frac",
                    "mean_cluster_worker_utilisation_frac"):
            s[key] = float(np.mean(s[key])) if len(s[key]) else 0.0
        for tput, info in (
                ("mean_compute_throughput", "compute_info_processed"),
                ("mean_dep_throughput", "dep_info_processed"),
                ("mean_flow_throughput", "flow_info_processed"),
                ("mean_cluster_throughput", "cluster_info_processed"),
                ("mean_demand_compute_throughput", "demand_compute_info_processed"),
                ("mean_demand_dep_throughput", "demand_dep_info_processed"),
                ("mean_demand_total_throughput", "demand_total_info_processed")):
            s[tput] = (s[info] / s["step_time"]
                       if s[info] != 0 and s["step_time"] != 0 else 0.0)
        s["job_queue_length"] = len(self.job_queue)
        for key, val in s.items():
            self.steps_log[key].append(val)
        for key in ("compute_info_processed", "dep_info_processed",
                    "flow_info_processed", "cluster_info_processed",
                    "demand_compute_info_processed", "demand_dep_info_processed",
                    "demand_total_info_processed", "mean_compute_overhead_frac",
                    "mean_communication_overhead_frac", "mean_num_jobs_running",
                    "mean_num_mounted_workers",
                    "mean_mounted_worker_utilisation_frac",
                    "mean_cluster_worker_utilisation_frac"):
            self.episode_stats[key].append(s[key])

    def _finalise_episode_stats(self) -> None:
        # block anything still running at simulation end
        for job in list(self.jobs_running.values()):
            self._register_blocked_job(job.original_job,
                                       cause="simulation_ended")
            self._remove_job_from_cluster(job)
        e = self.episode_stats
        e["episode_end_time"] = self.stopwatch.time()
        e["episode_time"] = e["episode_end_time"] - e["episode_start_time"]
        e["mean_load_rate"] = (float(np.mean(self.load_rates))
                               if self.load_rates else 0.0)
        arrived = e["num_jobs_arrived"]
        e["blocking_rate"] = e["num_jobs_blocked"] / arrived if arrived else 0.0
        e["acceptance_rate"] = (e["num_jobs_completed"] / arrived
                                if arrived else 0.0)
        for tput, info in (
                ("mean_compute_throughput", "compute_info_processed"),
                ("mean_dep_throughput", "dep_info_processed"),
                ("mean_flow_throughput", "flow_info_processed"),
                ("mean_cluster_throughput", "cluster_info_processed"),
                ("mean_demand_compute_throughput", "demand_compute_info_processed"),
                ("mean_demand_dep_throughput", "demand_dep_info_processed"),
                ("mean_demand_total_throughput", "demand_total_info_processed")):
            total = float(np.sum(e[info])) if isinstance(e[info], list) else e[info]
            e[info] = total
            e[tput] = (total / e["episode_time"]
                       if total != 0 and e["episode_time"] != 0 else 0.0)
        for key in ("mean_compute_overhead_frac",
                    "mean_communication_overhead_frac", "mean_num_jobs_running",
                    "mean_num_mounted_workers",
                    "mean_mounted_worker_utilisation_frac",
                    "mean_cluster_worker_utilisation_frac"):
            e[key] = float(np.mean(e[key])) if len(e[key]) else 0.0

    def is_done(self, verbose: bool = False) -> bool:
        if (self.max_simulation_run_time is not None
                and self.stopwatch.time() >= self.max_simulation_run_time):
            return True
        return (len(self.jobs_generator) == 0 and not self.jobs_running
                and len(self.job_queue) == 0)

    # ------------------------------------------------------------------- save
    def _save_logs(self, logs: dict) -> None:
        # keys are overwritten with the latest accumulated state
        # (reference: ramp_cluster_environment.py:1570)
        save_logs_to_dir(
            pathlib.Path(self.path_to_save) / f"reset_{self.reset_counter}",
            logs, use_sqlite=self.use_sqlite_database)

    def save(self) -> None:
        if self._save_thread is not None:
            self._save_thread.join()
        snapshot = snapshot_logs({"steps_log": self.steps_log,
                                  "episode_stats": self.episode_stats})
        self._save_thread = threading.Thread(target=self._save_logs,
                                             args=(snapshot,))
        self._save_thread.start()

    # static metric catalogues (reference: :1181-1280), used by loaders/loggers
    @staticmethod
    def episode_metrics() -> set:
        return {
            "episode_start_time", "episode_end_time", "episode_time",
            "num_jobs_arrived", "num_jobs_completed", "num_jobs_blocked",
            "compute_info_processed", "dep_info_processed",
            "flow_info_processed", "cluster_info_processed",
            "demand_compute_info_processed", "demand_dep_info_processed",
            "demand_total_info_processed", "mean_compute_throughput",
            "mean_dep_throughput", "mean_cluster_throughput",
            "mean_load_rate", "blocking_rate", "acceptance_rate",
            "mean_flow_throughput", "mean_demand_compute_throughput",
            "mean_demand_dep_throughput", "mean_demand_total_throughput",
            "mean_compute_overhead_frac", "mean_communication_overhead_frac",
            "mean_num_jobs_running", "mean_num_mounted_workers",
            "mean_mounted_worker_utilisation_frac",
            "mean_cluster_worker_utilisation_frac",
            "return", "episode_reward", "run_time", "epoch_counter",
            "episode_counter", "actor_step_counter",
        }

    @staticmethod
    def step_metrics() -> set:
        return {"mean_num_mounted_workers", "mean_num_mounted_channels"}

    @staticmethod
    def episode_completion_metrics() -> set:
        return {
            "job_completion_time", "job_communication_overhead_time",
            "job_computation_overhead_time", "jobs_completed_num_nodes",
            "jobs_completed_num_edges",
            "jobs_completed_total_operation_memory_cost",
            "jobs_completed_total_dependency_size",
            "job_completion_time_speedup",
            "jobs_completed_max_partitions_per_op",
            "jobs_completed_job_sequential_completion_time",
            "jobs_completed_max_acceptable_job_completion_time_frac",
            "jobs_completed_max_acceptable_job_completion_time",
            "jobs_completed_num_mounted_workers",
            "jobs_completed_num_mounted_channels",
            "jobs_completed_mean_mounted_worker_utilisation_frac",
            "jobs_completed_original_demand_num_nodes",
            "jobs_completed_original_demand_num_edges",
            "jobs_completed_original_demand_total_operation_memory_cost",
            "jobs_completed_original_demand_total_dependency_size",
        }

    @staticmethod
    def episode_blocked_metrics() -> set:
        return {
            "jobs_blocked_num_nodes", "jobs_blocked_num_edges",
            "jobs_blocked_total_operation_memory_cost",
            "jobs_blocked_total_dependency_size",
            "jobs_blocked_job_sequential_completion_time",
            "jobs_blocked_max_acceptable_job_completion_time_frac",
            "jobs_blocked_max_acceptable_job_completion_time",
            "jobs_blocked_original_demand_num_nodes",
            "jobs_blocked_original_demand_num_edges",
            "jobs_blocked_original_demand_total_operation_memory_cost",
            "jobs_blocked_original_demand_total_dependency_size",
            "jobs_blocked_cause_of_unsuccessful_handling",
        }
