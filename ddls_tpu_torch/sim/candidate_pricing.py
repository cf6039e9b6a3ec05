"""Batched candidate-degree pricing: lookahead JCTs for EVERY valid
partition degree of the queued job, without mutating cluster state.

A policy or heuristic deciding a job's partition degree wants the
lookahead outcome of all ~16 candidate actions, not just the one it takes.
Here each candidate's control plane (partition -> first-fit placement ->
SRPT schedules -> pricing) runs on the host over the array pipeline, and
the C++ tick engine (bit-exact f64 with the host engine) evaluates each
candidate.

Every priced candidate is inserted into ``cluster.lookahead_cache`` under
its exact memo key, so the subsequent ``env.step`` with any priced action
is a guaranteed cache hit — pricing is also prefetching.

Requires the dense array dep pipeline (single-channel complete topology,
the canonical RAMP shape); returns {} on other topologies or when the
op placer is non-deterministic w.r.t. replays (RandomOpPlacer), where a
prefetched key could never be hit again.

Port: a copy of ``ddls_tpu/sim/candidate_pricing.py``. ``backend="jax"``
keeps the reference's name and prices all pending candidates in one call
of the array engine (``sim/lookahead.py``) on the cluster's ``device``:
one K21 launch per decision on the CUDA card, the plain version with
``device="cpu"`` (float32, like the reference's jax backend). ``"auto"``
is the native (C++) engine, as in the reference wherever that exists.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

PriceTuple = Tuple[float, float, float, float]  # scaled (jct, comm, comp, busy)


def price_candidate_degrees(env, degrees=None,
                            backend: str = "auto"
                            ) -> Dict[int, Optional[PriceTuple]]:
    """Price candidate max-partition degrees for the head-of-queue job.

    Returns {degree: (jct, comm_oh, comp_oh, busy) | None} where None
    means the candidate is unplaceable (no worker block / busy channels).
    Values are scaled by ``num_training_steps`` exactly like the cluster's
    own lookahead results.
    """
    from ddls_tpu_torch.agents.placers import RandomOpPlacer
    from ddls_tpu_torch.sim.actions import DepArrays, OpPartition

    cluster = env.cluster
    if len(cluster.job_queue) == 0:
        return {}
    if isinstance(env.op_placer, RandomOpPlacer):
        return {}
    job_id, job = next(iter(cluster.job_queue.jobs.items()))
    if degrees is None:
        # compute action validity directly: pricing now runs BEFORE the
        # observation is extracted (so price features can describe the
        # current job), and env.obs would be the PREVIOUS decision's mask
        from ddls_tpu_torch.envs.obs import action_is_valid

        degrees = [a for a in env.action_set
                   if a != 0 and action_is_valid(a, env)]

    results: Dict[int, Optional[PriceTuple]] = {}
    pending = []  # (degree, key, partitioned, context)
    for d in degrees:
        partition_map = {job_id: env._partition_action_for(job, d)}
        op_partition = OpPartition(partition_map, cluster=cluster)
        op_placement = env.op_placer.get(op_partition=op_partition,
                                         cluster=cluster)
        if job_id not in op_placement.action:
            results[d] = None
            continue
        op_schedule = env.op_scheduler.get(
            op_partition=op_partition, op_placement=op_placement,
            cluster=cluster)
        dep_placement = env.dep_placer.get(
            op_partition=op_partition, op_placement=op_placement,
            cluster=cluster)
        if job_id not in dep_placement.action:
            results[d] = None
            continue
        env.dep_scheduler.get(op_partition=op_partition,
                              dep_placement=dep_placement, cluster=cluster)
        payload = dep_placement.action[job_id]
        if not isinstance(payload, DepArrays):
            return {}  # dict pipeline: unsupported (see module docstring)
        partitioned = op_partition.partitioned_jobs[job_id]
        # register-time zeroing parity: the mounted path zeroes non-flow
        # dep times in _register_running_job before the memo key is built
        sc = op_placement.job_server_codes[job_id]
        is_flow = partitioned.graph.flow_mask_from_codes(sc)
        partitioned.set_dep_init_run_times_bulk(
            np.where(is_flow, partitioned.dep_init_run_time_arr, 0.0))

        split = tuple(sorted(
            op_partition.job_id_to_split_forward_ops[job_id].items()))
        key = cluster.lookahead_key_for(partitioned, split,
                                        op_placement.action[job_id])
        cached = cluster.lookahead_cache.get(key)
        if cached is not None:
            results[d] = cached
            continue
        op_pri: Dict[str, int] = {}
        for worker_id, job_map in op_schedule.action.items():
            op_pri.update(job_map.get(job_id, {}))
        context = {"op_to_worker": op_placement.action[job_id],
                   "op_pri": op_pri, "payload": payload}
        pending.append((d, key, partitioned, context))

    if pending:
        for (d, key, partitioned, _), res in zip(
                pending, _evaluate(cluster, pending, backend)):
            if res is None:
                results[d] = None
                continue
            t, comm, comp, busy = res
            steps = partitioned.num_training_steps
            scaled = (t * steps, comm * steps, comp * steps, busy)
            cluster.lookahead_cache[key] = scaled
            results[d] = scaled
    return results


def _evaluate(cluster, pending, backend: str):
    """Run the tick engine over the pending candidates; returns a list of
    per-step (t, comm, comp, busy) tuples (None = engine failed)."""
    from ddls_tpu_torch.sim.lookahead_arrays import (
        build_lookahead_arrays, build_native_lookahead_arrays)

    if backend in ("auto", "native"):
        from ddls_tpu_torch.native import run_lookahead

        out = []
        for _, _, partitioned, ctx in pending:
            arrays = build_native_lookahead_arrays(cluster, partitioned,
                                                   context=ctx)
            out.append(run_lookahead(arrays))
        return out
    if backend != "jax":
        raise ValueError(f"unknown candidate-pricing backend {backend!r}"
                         " (native | jax | auto)")
    from ddls_tpu_torch.sim.lookahead import bucket, engine_device, run_lanes

    device = engine_device(cluster.device)
    pad_ops = bucket(max(p.graph.n_ops for _, _, p, _ in pending))
    pad_deps = bucket(max(p.graph.n_deps for _, _, p, _ in pending))
    batch = [build_lookahead_arrays(cluster, p, pad_ops, pad_deps,
                                    context=ctx)
             for _, _, p, ctx in pending]
    return run_lanes(batch, device)
