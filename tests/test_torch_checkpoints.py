"""All six shipped checkpoints through the port: each archive
(``ddls_tpu_torch/data/checkpoint_<name>.npz``) holds the restored orbax
params, and the port's policy on the port's own simulator makes the JAX
policy's recorded greedy decisions on the checkpoint's surface
(``tests/test_shipped_checkpoint.py``'s: 32 servers with price features
at ia-80 and at ia-50 with the JCT-blocking reward, 8/72/128 servers, the
plain observation of ``ppo_device_trained``); ``ppo_device_trained`` is
exactly ``FixedDegreePacking(8)`` over seed 7009's whole episode at ia-80
and scores above 0.2 a decision at seed 7005."""
import os
import sys

import numpy as np
import pytest
import torch

from ddls_tpu_torch.envs import FixedDegreePacking
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
from ddls_tpu_torch.models.convert import flatten_tree, params_from_flax
from ddls_tpu_torch.serve.fixture import (CHECKPOINT_NAMES, greedy_episode,
                                          load_checkpoint_fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import export_torch_checkpoints_fixture as ckpt_export  # noqa: E402

torch.set_num_threads(1)

F32_MIN = np.finfo(np.float32).min
GRAPH_WIDTH = {name: 51 for name in CHECKPOINT_NAMES}
GRAPH_WIDTH["ppo_device_trained"] = 34
SERVERS = {"ppo_price_ft8": 8, "ppo_price_ft72": 72, "ppo_price_ft128": 128}


@pytest.mark.parametrize("name", CHECKPOINT_NAMES)
def test_archive_is_the_restored_checkpoint(name):
    from ddls_tpu.serve import load_checkpoint_params

    fx = load_checkpoint_fixture(name)
    assert fx["graph_feature_dim"] == GRAPH_WIDTH[name]
    jparams = load_checkpoint_params(os.path.join(REPO, "checkpoints", name))
    restored = params_from_flax(
        flatten_tree({"params": jparams["params"]}), fx["model"])
    assert set(restored) == set(fx["params"])
    for key, value in restored.items():
        assert torch.equal(value, fx["params"][key]), key
    cfg = fx["env_config"]
    assert cfg["node_config"]["type_1"]["num_nodes"] == SERVERS.get(name, 32)
    assert bool(cfg.get("obs_include_candidate_prices")) == (
        name != "ppo_device_trained")


@pytest.mark.parametrize("name", CHECKPOINT_NAMES)
def test_port_makes_the_recorded_greedy_decisions(name):
    """The port's greedy episode prefix on its own env of the surface:
    every action equal, logits within 1e-5 (masked ones exactly the
    float32 floor), values within 1e-5 relative, rewards exact."""
    fx = load_checkpoint_fixture(name)
    rec = fx["recorded"]
    env = PortEnv(**fx["env_config"])
    got = greedy_episode(fx["model"].eval(), env, fx["seed"],
                         max_decisions=len(rec["jax_actions"]))
    np.testing.assert_array_equal(got["actions"], rec["jax_actions"])
    masked = rec["jax_logits"] == F32_MIN
    np.testing.assert_array_equal(got["logits"] == F32_MIN, masked)
    np.testing.assert_allclose(got["logits"][~masked],
                               rec["jax_logits"][~masked], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["values"], rec["jax_values"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got["rewards"], rec["rewards"])


def test_device_trained_is_fixed_degree_packing():
    """Seed 7009, ia-80, the whole episode: every greedy decision is
    FixedDegreePacking(8)'s (the reference pins the same,
    tests/test_shipped_checkpoint.py:150)."""
    fx = load_checkpoint_fixture("ppo_device_trained")
    env = PortEnv(**fx["env_config"])
    got = greedy_episode(fx["model"].eval(), env, 7009,
                         actor=FixedDegreePacking(8))
    assert len(got["actions"]) > 100
    np.testing.assert_array_equal(got["actions"], got["actor_actions"])


def test_device_trained_scores_above_the_floor():
    fx = load_checkpoint_fixture("ppo_device_trained")
    env = PortEnv(**fx["env_config"])
    got = greedy_episode(fx["model"].eval(), env, 7005)
    per_decision = got["rewards"].sum() / max(len(got["rewards"]), 1)
    assert np.isfinite(per_decision)
    assert per_decision > 0.2, (got["rewards"].sum(), len(got["rewards"]))


def test_surfaces_are_the_shipped_tests():
    """The exporter's surfaces name what tests/test_shipped_checkpoint.py
    restores each checkpoint on."""
    assert tuple(ckpt_export.NAMES) == CHECKPOINT_NAMES
    for name, n in SERVERS.items():
        assert f"env_config.node_config.type_1.num_nodes={n}" in \
            ckpt_export.SURFACES[name]
    assert ("env_config.reward_function=multi_objective_jct_blocking"
            in ckpt_export.SURFACES["ppo_jct_blocking"])
    assert ckpt_export.SURFACES["ppo_device_trained"][0] == \
        "env_config=env_load32"
