"""SRPT op and dep schedulers.

Shortest-remaining-processing-time priorities: sort the new job's ops per
worker (resp. flow deps globally) by run time *descending* and assign
ascending priority indices, so the shortest item carries the highest priority
number; the lookahead engine picks the max-priority ready item
(reference: agents/schedulers/srpt_op_scheduler.py:14,
srpt_dep_scheduler.py:12).

Port: a copy of ``ddls_tpu/agents/schedulers.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np


class SRPTOpScheduler:
    def __init__(self, **kwargs):
        pass

    def get(self, op_partition, op_placement, cluster):
        from ddls_tpu_torch.sim.actions import OpSchedule

        action: Dict[str, Dict[int, Dict[str, int]]] = defaultdict(
            lambda: defaultdict(dict))
        if not op_placement.action:
            return OpSchedule({})
        for worker_id, ops in op_placement.worker_to_ops.items():
            costed = []
            for entry in ops:
                job = op_partition.partitioned_jobs[entry["job_id"]]
                cost = job.graph.compute_cost(entry["op_id"])
                costed.append((entry["job_id"], entry["op_id"], cost))
            costed.sort(key=lambda t: t[2], reverse=True)
            for priority, (job_id, op_id, _) in enumerate(costed):
                action[worker_id][job_id][op_id] = priority
        return OpSchedule({k: dict(v) for k, v in action.items()})


def _srpt_priorities(costs_list):
    """Global SRPT priorities over concatenated per-job cost arrays: one
    stable descending argsort, so every tie class (per-job edge order,
    jobs in action order) resolves identically wherever this is used —
    the single ranking shared by the dict and array scheduler paths."""
    all_costs = (np.concatenate(costs_list) if len(costs_list) > 1
                 else costs_list[0])
    order = np.argsort(-all_costs, kind="stable")
    pri = np.empty(len(order), np.int64)
    pri[order] = np.arange(len(order))
    return pri


class SRPTDepScheduler:
    def __init__(self, **kwargs):
        pass

    def get(self, op_partition, dep_placement, cluster):
        from ddls_tpu_torch.sim.actions import DepArrays, DepSchedule

        if not dep_placement.action:
            return DepSchedule({})
        if any(isinstance(v, DepArrays)
               for v in dep_placement.action.values()):
            return self._get_arrays(op_partition, dep_placement)
        # global SRPT ordering over all newly placed flow deps, priced by the
        # comm model (reference sorts all jobdeps together,
        # srpt_dep_scheduler.py:66-77). Costs come straight from the priced
        # array and the descending sort is one stable argsort. Both paths
        # visit deps in graph edge order (per job, jobs in action order), so
        # every tie class — including a flow priced exactly 0.0 — resolves
        # identically whether or not dep_init_run_time_arr is present.
        jobs, deps_lists, costs_list = [], [], []
        for job_id, dep_to_channels in dep_placement.action.items():
            job = op_partition.partitioned_jobs[job_id]
            arr = getattr(job, "dep_init_run_time_arr", None)
            edge_ids = job.graph.finalize()["edge_ids"]
            # FirstFitDepPlacer keys dep_to_channels with entries drawn
            # from graph.edge_ids (every edge gets a channel tuple or the
            # _NONFLOW marker), so equal length implies the key sets are
            # identical and edge order can stand in for action order
            if arr is not None and len(dep_to_channels) == len(edge_ids):
                deps, costs = edge_ids, arr
            else:
                # iterate in graph edge order so ties (e.g. a flow priced
                # exactly 0.0) land in the same position as the fast path;
                # any placer-added key outside the edge list goes last
                deps = [d for d in edge_ids if d in dep_to_channels]
                if len(deps) != len(dep_to_channels):
                    seen = set(deps)
                    deps += [d for d in dep_to_channels if d not in seen]
                costs = np.array(
                    [job.dep_init_run_time.get(d, 0.0) for d in deps],
                    np.float64)
            jobs.append(job_id)
            deps_lists.append(deps)
            costs_list.append(costs)
        pri = _srpt_priorities(costs_list)

        action: Dict[str, Dict[int, Dict[tuple, int]]] = defaultdict(
            lambda: defaultdict(dict))
        jobdep_to_channels = dep_placement.jobdep_to_channels
        offset = 0
        for job_id, deps in zip(jobs, deps_lists):
            for k, dep_id in enumerate(deps):
                priority = int(pri[offset + k])
                channels = jobdep_to_channels.get((job_id, dep_id), ())
                if not channels:
                    # non-flow dep: keep it under the None channel so the
                    # job still counts as handled by this sub-action (the
                    # reference schedules non-flows onto a None channel key,
                    # srpt_dep_scheduler.py:57-63 + cluster :1404-1415)
                    action[None][job_id][dep_id] = priority
                for ch_id in channels:
                    action[ch_id][job_id][dep_id] = priority
            offset += len(deps)
        return DepSchedule({k: dict(v) for k, v in action.items()})

    def _get_arrays(self, op_partition, dep_placement):
        """Array fast path: the same global stable argsort over the priced
        arrays (per-job edge order, jobs in action order — the identical
        tie classes as the dict path), with priorities written straight
        into each job's DepArrays payload instead of per-channel dicts."""
        from ddls_tpu_torch.sim.actions import DepSchedule

        jobs = list(dep_placement.action)
        costs_list = []
        for job_id in jobs:
            job = op_partition.partitioned_jobs[job_id]
            arr = job.dep_init_run_time_arr
            if arr is None:
                payload = dep_placement.action[job_id]
                arr = np.array([job.dep_init_run_time.get(d, 0.0)
                                for d in payload.edge_ids], np.float64)
            costs_list.append(arr)
        pri = _srpt_priorities(costs_list)
        offset = 0
        schedule_action: dict = {"__arrays__": {}}
        for job_id, costs in zip(jobs, costs_list):
            payload = dep_placement.action[job_id]
            payload.pri = pri[offset:offset + len(costs)]
            schedule_action["__arrays__"][job_id] = payload
            offset += len(costs)
        return DepSchedule(schedule_action)
