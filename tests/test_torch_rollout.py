"""The port's rollout collector against the JAX one.

``RolloutCollector.collect`` over 8 of the port's env_load32_price_mixed
envs seeded 0-7 with the shipped policy and the uniforms the JAX sampler
drew (``ppo_rollout_price_mixed.npz``) reproduces the first steps of the
recorded JAX trajectory (``ppo_train_price_mixed.npz``): observations,
rewards and dones bit-equal, actions equal, logp within 1e-5 and values
within 5e-5 absolute (float32 sums in another order: values reach ~54,
where one float32 step is 3.8e-6; the largest difference measured is
1.53e-5, 4 steps, on the CPU and on the H100). The episode bookkeeping equals the JAX functions'; two collects
from one generator seed are bit-equal."""
import copy
import os

import numpy as np
import pytest
import torch

from ddls_tpu.rl.rollout import harvest_episode_record as jax_harvest
from ddls_tpu.train.loops import _episode_summary as jax_summary
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
from ddls_tpu_torch.rl.fixture import (load_rollout_fixture,
                                       load_train_config, load_train_fixture)
from ddls_tpu_torch.rl.ppo import PPOLearner
from ddls_tpu_torch.rl.rollout import (RolloutCollector, VectorEnv,
                                       harvest_episode_record)
from ddls_tpu_torch.serve.fixture import EXPORT_PATH
from ddls_tpu_torch.serve.server import load_export
from ddls_tpu_torch.train.loops import _episode_summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 16


def shipped_learner(fx):
    model, params, _ = load_export(EXPORT_PATH)
    learner = PPOLearner(model, fx["cfg"], device="cpu")
    learner.init_state(params)
    return learner


def vec_env(n_envs: int, env_config=None) -> VectorEnv:
    """``n_envs`` envs seeded 0..n_envs-1, reset."""
    cfg = env_config or load_train_config()["env_config"]
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(
        **copy.deepcopy(cfg)) for _ in range(n_envs)],
        seeds=list(range(n_envs)))
    vec.reset()
    return vec


@pytest.fixture(scope="module")
def fx():
    return load_train_fixture()


def test_collect_reproduces_the_recorded_rollout(fx):
    ref = fx["traj"]
    uniforms = load_rollout_fixture()["uniforms"]
    n_envs = ref["rewards"].shape[1]
    collector = RolloutCollector(vec_env(n_envs), shipped_learner(fx), STEPS)
    out = collector.collect(noise=uniforms[:STEPS])
    traj = out["traj"]
    assert sorted(traj["obs"]) == sorted(ref["obs"])
    for key, value in traj["obs"].items():
        want = ref["obs"][key][:STEPS]
        assert value.dtype == want.dtype, key
        np.testing.assert_array_equal(value, want, err_msg=key)
    for key in ("rewards", "dones", "actions"):
        np.testing.assert_array_equal(traj[key], ref[key][:STEPS],
                                      err_msg=key)
    np.testing.assert_allclose(traj["logp"], ref["logp"][:STEPS], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(traj["values"], ref["values"][:STEPS],
                               rtol=0, atol=5e-5)
    assert out["env_steps"] == STEPS * n_envs
    assert out["last_values"].shape == (n_envs,)
    assert set(out["timing"]) == {"env_s", "sample_s"}


def test_two_collects_from_one_seed_are_bit_equal(fx):
    outs = []
    for _ in range(2):
        collector = RolloutCollector(vec_env(2), shipped_learner(fx), 4)
        outs.append(collector.collect(
            generator=torch.Generator().manual_seed(11)))
    a, b = outs
    for key in ("actions", "logp", "values", "rewards", "dones"):
        np.testing.assert_array_equal(a["traj"][key], b["traj"][key])
    for key in a["traj"]["obs"]:
        np.testing.assert_array_equal(a["traj"]["obs"][key],
                                      b["traj"]["obs"][key])
    np.testing.assert_array_equal(a["last_values"], b["last_values"])


def test_collect_takes_one_noise_source(fx):
    collector = RolloutCollector(vec_env(2), shipped_learner(fx), 2)
    with pytest.raises(ValueError, match="exactly one"):
        collector.collect()
    with pytest.raises(ValueError, match="noise must be"):
        collector.collect(noise=np.full((3, 2, 17), 0.5, np.float32))


def test_collect_needs_a_reset_vector_env(fx):
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(
        **copy.deepcopy(load_train_config()["env_config"]))], seeds=[0])
    collector = RolloutCollector(vec, shipped_learner(fx), 1)
    with pytest.raises(ValueError, match="has been reset"):
        collector.collect(noise=np.full((1, 1, 17), 0.5, np.float32))


def last_valid(obs) -> int:
    return int(np.flatnonzero(obs["action_mask"])[-1])


def test_episode_bookkeeping_matches_jax():
    """Short env_small episodes stepped by a one-env vector env (two envs
    would interleave on the global random streams): the harvested record
    of its first episode equals both the port's and the JAX
    ``harvest_episode_record`` of that episode replayed on a fresh env,
    each finished episode advances the env's seed by num_envs, and the
    summary equals the JAX ``_episode_summary``."""
    from ddls_tpu.config import load_config

    cfg = load_config(os.path.join(REPO, "scripts",
                                   "ramp_job_partitioning_configs"),
                      "rllib_config", ["env_config=env_small",
                                       "env_config.max_simulation_run_time="
                                       "1500"])["env_config"]
    vec = vec_env(1, cfg)
    finished = 0
    for _ in range(20):
        _, _, dones = vec.step([last_valid(o) for o in vec.obs])
        finished += int(dones[0])
    drained = vec.drain_completed_episodes()
    assert len(drained) == finished >= 2
    assert vec.seeds == [finished]

    env = RampJobPartitioningEnvironment(**copy.deepcopy(cfg))
    obs, done, total, steps = env.reset(seed=0), False, 0.0, 0
    while not done:
        obs, reward, done, _ = env.step(last_valid(obs))
        total += reward
        steps += 1
    mine = harvest_episode_record(env, 0, total, steps)
    assert mine == jax_harvest(env, 0, total, steps)
    assert drained[0] == mine
    assert _episode_summary(drained) == jax_summary(drained)
    assert _episode_summary([]) == jax_summary([]) == {}
