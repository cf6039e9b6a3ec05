"""Heuristic baseline actors (counterpart of
``ddls_tpu/envs/baselines.py``, trimmed to what the port runs: the
``BaselineActor`` interface :23-36, ``AcceptableJCT`` :94-121 and
``OracleJCT`` :123-158, the yardstick of the device's in-kernel oracle
episode, and ``FixedDegreePacking`` :161-207, the heuristic the server
answers from in degraded mode).

Every actor implements ``compute_action(obs, job_to_place=None)`` returning
an int from the env's action set.
"""
from __future__ import annotations

import math

import numpy as np


def _valid_actions(obs) -> np.ndarray:
    action_set = np.asarray(obs["action_set"])
    mask = np.asarray(obs["action_mask"]).astype(bool)
    return action_set[mask]


class BaselineActor:
    name = "baseline"

    def __init__(self, name: str = None, **kwargs):
        if name is not None:
            self.name = name

    def compute_action(self, obs, job_to_place=None, **kwargs) -> int:
        raise NotImplementedError

    def reset(self) -> None:
        """Episode boundary: stateful actors clear cross-decision state
        here."""


class AcceptableJCT(BaselineActor):
    """Partition just enough to (approximately) meet the job's maximum
    acceptable completion time: target = ceil(sequential / max
    acceptable), rounded up to the nearest valid action. Ignores
    communication overhead."""

    name = "acceptable_jct"

    def __init__(self, max_partitions_per_op: int = None, **kwargs):
        super().__init__(**kwargs)
        self.max_partitions_per_op = max_partitions_per_op

    def compute_action(self, obs, job_to_place=None, **kwargs) -> int:
        valid = _valid_actions(obs)
        if len(valid) <= 1 or job_to_place is None:
            return int(valid[0])
        target = math.ceil(job_to_place.seq_completion_time
                           / job_to_place.max_acceptable_jct)
        action = valid[-1]
        for a in valid:
            if a == 0:
                continue
            if a >= target:
                action = a
                break
        return int(action)


class OracleJCT(AcceptableJCT):
    """AcceptableJCT with the lookahead's own prices: the smallest
    partition degree whose priced JCT (communication included) meets the
    job's maximum acceptable JCT; else the smallest-JCT placeable degree
    (the first minimum in degree order); else the smallest valid degree.
    Falls back to AcceptableJCT where the env prices no candidate
    (``candidate_pricing`` off). The device's counterpart is
    ``sim/device_env.py`` ``make_oracle_episode_fn`` (K30)."""

    name = "oracle_jct"

    def compute_action(self, obs, job_to_place=None, env=None,
                       **kwargs) -> int:
        prices = getattr(env, "candidate_prices", None) if env else None
        if not prices:
            return super().compute_action(obs, job_to_place=job_to_place,
                                          **kwargs)
        valid = [a for a in _valid_actions(obs) if a != 0]
        if not valid or job_to_place is None:
            return super().compute_action(obs, job_to_place=job_to_place,
                                          **kwargs)
        limit = job_to_place.max_acceptable_jct
        acceptable = [a for a in valid
                      if prices.get(a) is not None and prices[a][0] <= limit]
        if acceptable:
            return int(min(acceptable))
        # no candidate meets the SLA: the job blocks regardless, so take
        # the smallest-JCT placeable candidate
        placeable = [a for a in valid if prices.get(a) is not None]
        if placeable:
            return int(min(placeable, key=lambda a: prices[a][0]))
        return int(valid[0])


class FixedDegreePacking:
    """Partition every job to one fixed degree ``d`` when a ``d``-server
    block is free (``d`` is a valid action), otherwise decline (action 0).

    The decision rule the shipped 32-server policies converged to: the
    JAX package's rule extraction (docs/results_round5/rule_extraction.md)
    found them all to be exactly this rule at d = 8, so degraded-mode
    answers agree with the policy at the extracted degree."""

    name = "fixed_degree_packing"

    def __init__(self, degree: int = 8):
        self.degree = degree

    def compute_action(self, obs, **kwargs) -> int:
        return self.degree if self.degree in _valid_actions(obs) else 0
