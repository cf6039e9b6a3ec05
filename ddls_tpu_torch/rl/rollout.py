"""Vectorised rollout collection, sequential.

Counterpart of ``ddls_tpu/rl/rollout.py`` (``stack_obs`` :32,
``harvest_episode_record`` :37, ``VectorEnv`` :60-157 with its
``stacked_obs`` :73 and ``restart_episodes`` :141, and the plain path of
``RolloutCollector.collect`` :1185-1247): one host process steps B
environment instances, stacks their padded observations into [B, ...]
arrays and samples all B actions in one batched forward on the learner's
device (``PPOLearner.sample_actions``: K1-K3, the heads, then K9).
Environments auto-reset on episode end; completed-episode returns, lengths
and the cluster's episode stats are harvested for logging.

Randomness: each step's uniforms come from a ``torch.Generator`` on the
learner's device, or, for parity with the reference, from ``noise``: the
[T, B, A] uniforms the reference's sampler drew, handed over step by step.

Left out, waiting for their own slice: ``ParallelVectorEnv`` and its
shared-memory transport, the pipelined and deferred-fetch collection
schedules, and the fused per-step program.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ddls_tpu_torch.models.policy import gumbel_uniforms

OBS_KEYS = ("node_features", "edge_features", "graph_features",
            "edges_src", "edges_dst", "node_split", "edge_split",
            "action_mask")


def stack_obs(obs_list: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(o[k]) for o in obs_list])
            for k in OBS_KEYS}


def harvest_episode_record(env, env_index: int, episode_return: float,
                           episode_length: int) -> Dict[str, Any]:
    """Episode summary + the cluster's episode stats, mirroring what RLlib's
    callbacks collect (ddls/environments/ramp_cluster/utils.py:25-73)."""
    record = {"env_index": env_index,
              "episode_return": float(episode_return),
              "episode_length": int(episode_length)}
    cluster = getattr(env, "cluster", None)
    if cluster is not None and getattr(cluster, "episode_stats", None):
        stats = cluster.episode_stats
        for key in ("num_jobs_arrived", "num_jobs_completed",
                    "num_jobs_blocked", "blocking_rate",
                    "acceptance_rate"):
            if key in stats:
                record[key] = stats[key]
        for key in ("job_completion_time",
                    "job_completion_time_speedup"):
            vals = stats.get(key)
            if vals:
                record[f"mean_{key}"] = float(np.mean(vals))
    return record


class VectorEnv:
    """B independent environment instances with auto-reset. The env at
    index i is reset with ``seeds[i]``; each finished episode adds
    ``num_envs`` to that seed, so workload sampling differs per episode."""

    def __init__(self, env_fns: List[Callable[[], Any]],
                 seeds: Optional[List[int]] = None):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.seeds = seeds or list(range(self.num_envs))
        self.episode_returns = np.zeros(self.num_envs)
        self.episode_lengths = np.zeros(self.num_envs, dtype=np.int64)
        self.completed_episodes: List[Dict[str, Any]] = []
        self.obs: Optional[List[Dict[str, np.ndarray]]] = None

    def stacked_obs(self) -> Dict[str, np.ndarray]:
        """The current obs list as one [B, ...] batch."""
        return stack_obs(self.obs)

    def reset(self) -> List[Dict[str, np.ndarray]]:
        self.obs = [env.reset(seed=self.seeds[i])
                    for i, env in enumerate(self.envs)]
        self.episode_returns[:] = 0.0
        self.episode_lengths[:] = 0
        return self.obs

    def step(self, actions: np.ndarray):
        """Step every env with its action; returns (obs list, rewards [B]
        float32, dones [B] bool)."""
        rewards = np.zeros(self.num_envs, dtype=np.float32)
        dones = np.zeros(self.num_envs, dtype=bool)
        for i, env in enumerate(self.envs):
            obs, reward, done, _ = env.step(int(actions[i]))
            rewards[i] = reward
            dones[i] = done
            self.episode_returns[i] += reward
            self.episode_lengths[i] += 1
            if done:
                self.completed_episodes.append(harvest_episode_record(
                    env, i, self.episode_returns[i],
                    self.episode_lengths[i]))
                self.seeds[i] += self.num_envs
                obs = env.reset(seed=self.seeds[i])
                self.episode_returns[i] = 0.0
                self.episode_lengths[i] = 0
            self.obs[i] = obs
        return self.obs, rewards, dones

    def drain_completed_episodes(self) -> List[Dict[str, Any]]:
        out, self.completed_episodes = self.completed_episodes, []
        return out

    def restart_episodes(self) -> List[Dict[str, np.ndarray]]:
        """Abandon every in-progress episode and start fresh ones on
        advanced per-env seeds. Completed-episode records are kept; the
        abandoned partial returns and lengths are dropped (used after an
        off-policy interlude, such as ES's eval window, so its steps never
        leak into training episode stats)."""
        for i in range(self.num_envs):
            self.seeds[i] += self.num_envs
        self.obs = [env.reset(seed=self.seeds[i])
                    for i, env in enumerate(self.envs)]
        self.episode_returns[:] = 0.0
        self.episode_lengths[:] = 0
        return self.obs

    def close(self) -> None:
        pass


class RolloutCollector:
    """Collects [T, B] trajectory batches for the PPO learner from a
    ``VectorEnv`` that its owner has reset; each collect steps the envs on
    from where the last one left them."""

    def __init__(self, vec_env: VectorEnv, learner, rollout_length: int):
        self.vec_env = vec_env
        self.learner = learner
        self.rollout_length = int(rollout_length)

    def collect(self, generator: Optional[torch.Generator] = None,
                noise: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Run ``rollout_length`` steps in every env with the learner's
        current params; returns a trajectory dict of [T, B, ...] host
        arrays, the bootstrap values [B], the completed episodes, the env
        steps and ``timing``: the host wall of env stepping (``env_s``: the
        simulator and candidate pricing) and of sampling (``sample_s``:
        batch assembly, the forward, K9 and the read-back).

        Step t's uniforms are ``noise[t]`` ([T, B, A] float32 in [tiny, 1))
        when given, else drawn from ``generator`` (a ``torch.Generator`` on
        the learner's device)."""
        T, B = self.rollout_length, self.vec_env.num_envs
        if (noise is None) == (generator is None):
            raise ValueError("collect needs exactly one of generator, noise")
        if self.vec_env.obs is None:
            raise ValueError("collect needs a VectorEnv that has been reset")
        device = self.learner.device
        n_actions = np.asarray(self.vec_env.obs[0]["action_mask"]).shape[0]
        if noise is not None:
            noise = np.asarray(noise, np.float32)
            if noise.shape != (T, B, n_actions):
                raise ValueError(f"noise must be [{T}, {B}, {n_actions}], "
                                 f"got {noise.shape}")

        obs_buf: List[Dict[str, np.ndarray]] = []
        act_buf = np.zeros((T, B), dtype=np.int32)
        logp_buf = np.zeros((T, B), dtype=np.float32)
        val_buf = np.zeros((T, B), dtype=np.float32)
        rew_buf = np.zeros((T, B), dtype=np.float32)
        done_buf = np.zeros((T, B), dtype=bool)
        env_s = sample_s = 0.0
        for t in range(T):
            t0 = time.perf_counter()
            batched = stack_obs(self.vec_env.obs)
            u = (torch.from_numpy(noise[t]).to(device) if noise is not None
                 else gumbel_uniforms((B, n_actions), generator, device))
            actions, logp, values = self.learner.sample_actions(batched, u)
            t1 = time.perf_counter()
            obs_buf.append(batched)
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = values
            _, rewards, dones = self.vec_env.step(actions)
            rew_buf[t] = rewards
            done_buf[t] = dones
            env_s += time.perf_counter() - t1
            sample_s += t1 - t0

        t0 = time.perf_counter()
        last_values = self.learner.values(stack_obs(self.vec_env.obs))
        sample_s += time.perf_counter() - t0
        traj_obs = {k: np.stack([o[k] for o in obs_buf]) for k in OBS_KEYS}
        return {
            "traj": {"obs": traj_obs, "actions": act_buf, "logp": logp_buf,
                     "values": val_buf, "rewards": rew_buf,
                     "dones": done_buf},
            "last_values": np.asarray(last_values, np.float32),
            "episodes": self.vec_env.drain_completed_episodes(),
            "env_steps": T * B,
            "timing": {"env_s": env_s, "sample_s": sample_s},
        }
