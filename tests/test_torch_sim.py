"""The port's copy of the simulator against the JAX package's: the same
config, seed and action sequence give bit-equal observations (every key),
rewards, dones, candidate prices (the native engine's float64) and the
cluster's episode stats, on env_small and on env_load32_price_mixed (the
shipped policy's env, with candidate pricing and price features), for a
fixed cycle over the valid actions and for FixedDegreePacking(8); and a
scenario runtime, trimmed until the scenarios were ported, reaches the
cluster (``tests/test_torch_scenarios.py`` holds what it does).

The simulator draws from the global ``random`` and ``numpy.random``
streams, which ``env.reset(seed)`` reseeds: each side runs its whole
episode before the other starts, so the two streams never interleave."""
import copy
import os

import numpy as np
import pytest

from ddls_tpu.config import load_config
from ddls_tpu.envs import RampJobPartitioningEnvironment as JaxEnv
from ddls_tpu.envs.baselines import FixedDegreePacking as JaxPacking
from ddls_tpu_torch.envs import FixedDegreePacking
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
from ddls_tpu_torch.utils import get_class_from_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATH = os.path.join(REPO, "scripts", "ramp_job_partitioning_configs")
DECISIONS = 64


def env_config(name: str) -> dict:
    return load_config(CONFIG_PATH, "rllib_config",
                       [f"env_config={name}"])["env_config"]


def cycle_policy():
    state = {"i": 0}

    def act(obs):
        valid = np.flatnonzero(obs["action_mask"])
        state["i"] += 1
        return int(valid[state["i"] % len(valid)])
    return act


def episode(env_cls, cfg, policy, seed: int):
    """Up to DECISIONS decisions from ``reset(seed)``: the first
    observation, then per step (obs, reward, done, candidate prices), and
    the cluster's episode stats at the end."""
    env = env_cls(**copy.deepcopy(cfg))
    obs = env.reset(seed=seed)
    trace = [(dict(obs), None, None, dict(env.candidate_prices))]
    for _ in range(DECISIONS):
        obs, reward, done, _ = env.step(policy(obs))
        trace.append((dict(obs), reward, done, dict(env.candidate_prices)))
        if done:
            break
    return trace, copy.deepcopy(dict(env.cluster.episode_stats))


@pytest.mark.parametrize("name", ["env_small", "env_load32_price_mixed"])
@pytest.mark.parametrize("policy", ["cycle", "packing8"])
def test_simulator_copy_is_bit_equal(name, policy):
    cfg = env_config(name)

    def make(side):
        if policy == "cycle":
            return cycle_policy()
        heuristic = (FixedDegreePacking if side == "port" else JaxPacking)(8)
        return heuristic.compute_action

    port, port_stats = episode(PortEnv, cfg, make("port"), seed=3)
    ref, ref_stats = episode(JaxEnv, cfg, make("jax"), seed=3)
    assert len(port) == len(ref) > 1
    for (po, pr, pd, pp), (ro, rr, rd, rp) in zip(port, ref):
        assert sorted(po) == sorted(ro)
        for key in ro:
            assert po[key].dtype == ro[key].dtype, key
            np.testing.assert_array_equal(po[key], ro[key], err_msg=key)
        assert pr == rr and pd == rd
        assert pp == rp  # native prices: exact float64 tuples
    if name == "env_load32_price_mixed":
        assert any(p for _, _, _, p in ref), "no candidate was priced"
    assert sorted(port_stats) == sorted(ref_stats)
    for key, value in ref_stats.items():
        np.testing.assert_array_equal(np.asarray(port_stats[key]),
                                      np.asarray(value), err_msg=key)


def test_trimmed_features_raise():
    """The scenario runtime, once trimmed (a runtime raised), is ported:
    the failures spec's runtime on env_small's fabric reaches the cluster
    and inflates the registered completion times; an unported
    distribution still raises. (The array lookahead's options run:
    tests/test_torch_lookahead.py.)"""
    from ddls_tpu_torch.hardware.topologies import build_topology
    from ddls_tpu_torch.scenarios import build_runtime, failures_spec

    cfg = env_config("env_small")
    runtime = build_runtime(failures_spec(),
                            build_topology(cfg["topology_config"]))
    env = PortEnv(**cfg, scenario_runtime=runtime)
    assert env.cluster.scenario_runtime is runtime
    obs, done = env.reset(seed=0), False
    while not done:
        obs, _, done, _ = env.step(
            int(np.flatnonzero(obs["action_mask"])[-1]))
    cluster = env.cluster
    assert any(cluster.job_adjusted_jct[ji]
               != j.details["nominal_lookahead_jct"]
               for ji, j in cluster.jobs_completed.items())
    with pytest.raises(ValueError, match="names no class of the port"):
        get_class_from_path("ddls_tpu.serve.autoscale.Autoscaler")


def test_config_targets_map_onto_the_port():
    """The configs' ``_target_`` paths name the JAX package; the port maps
    each onto its own class and refuses what it has not ported."""
    from ddls_tpu_torch.demands import distributions

    assert (get_class_from_path("ddls_tpu.demands.distributions.Uniform")
            is distributions.Uniform)
    assert (get_class_from_path("ddls.distributions.fixed.Fixed")
            is distributions.Fixed)
    assert (get_class_from_path(
        "ddls_tpu.envs.partitioning_env.RampJobPartitioningEnvironment")
        is PortEnv)
    assert (get_class_from_path(
        "ddls_tpu.demands.distributions.LoadgenInterarrival")
        is distributions.LoadgenInterarrival)
    with pytest.raises(ValueError, match="names no class of the port"):
        get_class_from_path("ddls_tpu.serve.autoscale.Autoscaler")
