"""Formal environment plug-in interfaces.

Counterparts of the reference's abstract bases
(ddls/environments/ddls_observation_function.py:5,
ddls_reward_function.py:5, and the ``information_function`` hook every env
constructor accepts): observation functions encode cluster state into
padded arrays, reward functions score a step, information functions build
the ``info`` dict returned by ``step``. The concrete observation/reward
classes (envs/obs.py, envs/rewards.py, envs/shaping_obs.py) follow these
protocols; the ABCs exist so user-supplied plug-ins have a documented
contract to implement.

Port: a copy of ``ddls_tpu/envs/interfaces.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

from typing import Any, Dict


class DDLSObservationFunction:
    """Encodes an environment's state into the model-facing observation."""

    def reset(self, env) -> None:
        """(Re)build padding/normalisation state for a fresh episode; must
        set ``self.observation_space``."""
        raise NotImplementedError

    def extract(self, env, done: bool) -> Dict[str, Any]:
        """Encode the current state as a dict of padded arrays."""
        raise NotImplementedError


class DDLSRewardFunction:
    """Scores one environment step (same protocol as
    :class:`ddls_tpu_torch.envs.rewards.RewardFunction`)."""

    def reset(self, env=None, **kwargs) -> None:
        pass

    def extract(self, env, done: bool) -> float:
        raise NotImplementedError


class DDLSInformationFunction:
    """Builds the ``info`` dict returned by ``env.step``."""

    def reset(self, env) -> None:
        pass

    def extract(self, env, done: bool) -> Dict[str, Any]:
        raise NotImplementedError


class DefaultInformation(DDLSInformationFunction):
    """The reference's default information function is a no-op
    (job_placing_all_nodes_environment.py:117-121); this returns an empty
    info dict."""

    def extract(self, env, done: bool) -> Dict[str, Any]:
        return {}


class EpisodeStatsInformation(DDLSInformationFunction):
    """Surfaces headline cluster counters into ``info`` each step —
    useful for RL-framework callbacks that only see (obs, reward, done,
    info) tuples. Reads the live lifecycle tables both cluster simulators
    maintain (the legacy ClusterEnvironment has no episode_stats dict)."""

    def extract(self, env, done: bool) -> Dict[str, Any]:
        cluster = env.cluster
        return {
            "num_jobs_arrived": int(cluster.num_jobs_arrived),
            "num_jobs_completed": len(cluster.jobs_completed),
            "num_jobs_blocked": len(cluster.jobs_blocked),
        }


INFORMATION_FUNCTIONS = {
    "default": DefaultInformation,
    "episode_stats": EpisodeStatsInformation,
}


def make_information_function(name: str) -> DDLSInformationFunction:
    if name not in INFORMATION_FUNCTIONS:
        raise ValueError(
            f"unrecognised information_function {name!r}; available: "
            f"{sorted(INFORMATION_FUNCTIONS)}")
    return INFORMATION_FUNCTIONS[name]()
