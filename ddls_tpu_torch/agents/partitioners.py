"""Heuristic op partitioners.

The SiP-ML rule (reference: agents/partitioners/sip_ml_op_partitioner.py:46):
partition each forward op into

    clamp(ceil(ceil(compute_cost / min_op_run_time_quantum) / 2) * 2,
          1, max_partitions_per_op)

i.e. the smallest even count that brings per-sub-op run time under the
quantum, capped at the allowed maximum; mirrored onto the backward op.

Port: a copy of ``ddls_tpu/agents/partitioners.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from ddls_tpu_torch.graphs.op_graph import OpGraph


def sip_ml_num_partitions(compute_cost: float,
                          min_op_run_time_quantum: float,
                          max_partitions_per_op: int) -> int:
    n = math.ceil(math.ceil(compute_cost / min_op_run_time_quantum) / 2) * 2
    return int(max(1, min(n, max_partitions_per_op)))


def build_partition_action(graph: OpGraph,
                           min_op_run_time_quantum: float,
                           max_partitions_per_op: int) -> Dict[str, int]:
    """op -> num_partitions for every fwd+bwd op of one job's graph."""
    action: Dict[str, int] = {}
    for f_op in graph.forward_op_ids():
        n = sip_ml_num_partitions(graph.compute_cost(f_op),
                                  min_op_run_time_quantum,
                                  max_partitions_per_op)
        action[str(int(f_op))] = n
        b_op = graph.counterpart(f_op)
        if b_op is not None:
            action[str(int(b_op))] = n
    return action


class SipMlOpPartitioner:
    def __init__(self, min_op_run_time_quantum: float = 10e-6, **kwargs):
        self.min_op_run_time_quantum = min_op_run_time_quantum

    def get(self, cluster, max_partitions_per_op: int = 2):
        from ddls_tpu_torch.sim.actions import OpPartition

        if max_partitions_per_op < 1 or (
                max_partitions_per_op > 1 and max_partitions_per_op % 2 != 0):
            raise ValueError(
                f"max_partitions_per_op must be 1 or even, got "
                f"{max_partitions_per_op}")
        action = {}
        for job_id, job in cluster.job_queue.jobs.items():
            action[job_id] = build_partition_action(
                job.graph, self.min_op_run_time_quantum, max_partitions_per_op)
        return OpPartition(action, cluster=cluster)


class RandomOpPartitioner:
    """Uniform random even partition count per op
    (reference: agents/partitioners/random_op_partitioner.py:9)."""

    def __init__(self, **kwargs):
        pass

    def get(self, cluster, max_partitions_per_op: int = 2):
        from ddls_tpu_torch.sim.actions import OpPartition

        choices = [1] + [n for n in range(2, max_partitions_per_op + 1, 2)]
        action = {}
        for job_id, job in cluster.job_queue.jobs.items():
            per_op = {}
            for f_op in job.graph.forward_op_ids():
                n = int(np.random.choice(choices))
                per_op[str(int(f_op))] = n
                b_op = job.graph.counterpart(f_op)
                if b_op is not None:
                    per_op[str(int(b_op))] = n
            action[job_id] = per_op
        return OpPartition(action, cluster=cluster)
