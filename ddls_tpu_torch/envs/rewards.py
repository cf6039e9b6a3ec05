"""Reward functions for the partitioning MDP
(reference: ddls/environments/ramp_job_partitioning/rewards/).

Port: a copy of ``ddls_tpu/envs/rewards.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np


def _log_transform(reward: float) -> float:
    return math.copysign(1, reward) * math.log(1 + abs(reward), 10)


def _find_placed_job(env, cluster, job_idx):
    """The placed partitioned job carrying the lookahead details.

    Normally in jobs_running (or jobs_completed if it finished during the
    auto-steps); when the EPISODE ends during the auto-steps, episode
    finalisation sweeps still-running jobs into jobs_blocked and out of
    every dict (cluster.py:1009-1014), so the env stashes the object as
    ``last_placed_job`` before auto-stepping."""
    job = (cluster.jobs_running.get(job_idx)
           or cluster.jobs_completed.get(job_idx))
    if job is None:
        stashed = getattr(env, "last_placed_job", None)
        if stashed is not None and stashed.details["job_idx"] == job_idx:
            job = stashed
    if job is None:
        raise RuntimeError(
            f"placed job idx {job_idx} is neither running, completed, "
            "nor stashed")
    return job


class RewardFunction:
    def reset(self, env=None, **kwargs) -> None:
        pass

    def extract(self, env, done: bool) -> float:
        raise NotImplementedError


class JobAcceptance(RewardFunction):
    """+success_reward if the arriving job was placed, else fail_reward
    (reference: rewards/job_acceptance.py:9)."""

    def __init__(self, fail_reward: float = -1, success_reward: float = 1,
                 **kwargs):
        self.fail_reward = fail_reward
        self.success_reward = success_reward

    def extract(self, env, done: bool) -> float:
        job_idx = env.last_job_arrived_job_idx
        return (self.success_reward if job_idx in env.placed_job_idxs
                else self.fail_reward)


class LookaheadJobCompletionTime(RewardFunction):
    """(signed/inverted/log/normalised) lookahead JCT; blocked jobs get a
    fail reward (optionally sequential JCT x factor)
    (reference: rewards/lookahead_job_completion_time.py:9)."""

    def __init__(self,
                 fail_reward: Union[int, float, str] = "job_sequential_completion_time",
                 fail_reward_factor: float = 1,
                 sign: int = -1,
                 inverse: bool = False,
                 transform_with_log: bool = False,
                 normaliser: Union[str, None] = None,
                 **kwargs):
        self.fail_reward = fail_reward
        self.fail_reward_factor = fail_reward_factor
        self.sign = sign
        self.inverse = inverse
        self.transform_with_log = transform_with_log
        self.normaliser = normaliser

    def _normalise(self, reward: float, job) -> float:
        if self.normaliser == "job_sequential_completion_time":
            return reward / job.seq_completion_time
        if self.normaliser == "job_sequential_completion_time_times_fail_reward_factor":
            return reward / (job.seq_completion_time * self.fail_reward_factor)
        raise ValueError(f"unrecognised normaliser {self.normaliser}")

    def extract(self, env, done: bool) -> float:
        job_idx = env.last_job_arrived_job_idx
        cluster = env.cluster
        if job_idx in env.placed_job_idxs:
            job = _find_placed_job(env, cluster, job_idx)
            reward = job.details["lookahead_job_completion_time"]
            if self.normaliser is not None and reward != 0:
                reward = self._normalise(reward, job)
        else:
            job = cluster.jobs_blocked[job_idx]
            if isinstance(self.fail_reward, str):
                if self.fail_reward != "job_sequential_completion_time":
                    raise ValueError(
                        f"unrecognised fail_reward {self.fail_reward}")
                reward = job.seq_completion_time * self.fail_reward_factor
            else:
                reward = self.fail_reward * self.fail_reward_factor
            if self.normaliser is not None and reward != 0:
                reward = self._normalise(reward, job)

        if self.inverse and reward != 0:
            reward = 1 / reward
        reward *= self.sign
        if self.transform_with_log:
            reward = _log_transform(reward)
        return reward


class _ThroughputReward(RewardFunction):
    """Mean of a cluster step-stats throughput metric over the cluster steps
    elapsed this env step (reference: rewards/mean_compute_throughput.py:9)."""

    metric = "mean_compute_throughput"

    def __init__(self, sign: int = 1, transform_with_log: bool = False,
                 normalise: bool = False, **kwargs):
        self.sign = sign
        self.transform_with_log = transform_with_log
        self.normalise = normalise
        self._max = None

    def reset(self, env=None, **kwargs) -> None:
        if env is None:
            return
        max_tp = env.cluster.jobs_generator.jobs_params[
            "max_job_max_op_compute_throughputs"]
        self._max = max_tp * env.cluster.topology.num_workers

    def extract(self, env, done: bool) -> float:
        throughputs = [stats[self.metric]
                       for stats in env.cluster_step_stats.values()]
        reward = float(np.mean(throughputs)) if throughputs else 0.0
        if self.normalise and self._max:
            reward = reward / self._max
        if reward != 0:
            reward *= self.sign
            if self.transform_with_log:
                reward = _log_transform(reward)
        return reward


class MeanComputeThroughput(_ThroughputReward):
    metric = "mean_compute_throughput"


class MeanClusterThroughput(_ThroughputReward):
    metric = "mean_cluster_throughput"


class MeanDemandTotalThroughput(_ThroughputReward):
    metric = "mean_demand_total_throughput"


class MultiObjectiveJCTBlocking(RewardFunction):
    """Accepted job: lookahead/sequential JCT ratio; blocked job:
    blocking_weight x (normalised sequential JCT + 1)
    (reference: rewards/multi_objective_jct_blocking.py:9)."""

    def __init__(self, blocking_weight: float = 1, sign: int = -1,
                 inverse: bool = False, transform_with_log: bool = False,
                 **kwargs):
        self.blocking_weight = blocking_weight
        self.sign = sign
        self.inverse = inverse
        self.transform_with_log = transform_with_log

    def extract(self, env, done: bool) -> float:
        job_idx = env.last_job_arrived_job_idx
        cluster = env.cluster
        if job_idx in env.placed_job_idxs:
            job = _find_placed_job(env, cluster, job_idx)
            reward = (job.details["lookahead_job_completion_time"]
                      / job.seq_completion_time)
        else:
            job = cluster.jobs_blocked[job_idx]
            params = cluster.jobs_generator.jobs_params
            lo = params["min_job_sequential_completion_times"]
            hi = params["max_job_sequential_completion_times"]
            norm = ((job.seq_completion_time - lo) / (hi - lo)
                    if hi - lo != 0 else 1.0)
            reward = self.blocking_weight * (norm + 1)

        if self.inverse and reward != 0:
            reward = 1 / reward
        reward *= self.sign
        if self.transform_with_log:
            reward = _log_transform(reward)
        return reward


REWARD_FUNCTIONS = {
    "job_acceptance": JobAcceptance,
    "lookahead_job_completion_time": LookaheadJobCompletionTime,
    "mean_compute_throughput": MeanComputeThroughput,
    "mean_cluster_throughput": MeanClusterThroughput,
    "mean_demand_total_throughput": MeanDemandTotalThroughput,
    "multi_objective_jct_blocking": MultiObjectiveJCTBlocking,
}


def make_reward_function(name: str, kwargs: dict = None) -> RewardFunction:
    if name not in REWARD_FUNCTIONS:
        raise ValueError(
            f"unrecognised reward_function {name!r}; known: "
            f"{sorted(REWARD_FUNCTIONS)}")
    return REWARD_FUNCTIONS[name](**(kwargs or {}))
