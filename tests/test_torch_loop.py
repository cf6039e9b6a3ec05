"""The port's sequential PPO epoch loop and its entry point on the CPU, at
a tiny size (env_small, 2 envs x 8 steps, minibatch 8, one SGD iteration,
episodes of ~7 decisions): one epoch trains (finite learner metrics,
params move) and reports the JAX loop's result keys, evaluation leaves
the global random streams as it found them, a checkpoint round-trips bit
for bit, and ``python -m ddls_tpu_torch.train --device cpu`` runs."""
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from ddls_tpu.config import load_config
from ddls_tpu.train.compat import apply_reference_compat
from ddls_tpu_torch.train import RLEpochLoop, make_epoch_loop
from ddls_tpu_torch.train.__main__ import build_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATH = os.path.join(REPO, "scripts", "ramp_job_partitioning_configs")
TINY = ["env_config=env_small", "algo=ppo", "epoch_loop=epoch_loop_default",
        "epoch_loop.num_envs=2", "epoch_loop.rollout_length=8",
        "algo.algo_config.sgd_minibatch_size=8",
        "algo.algo_config.num_sgd_iter=1",
        "algo.algo_config.train_batch_size=16",
        "env_config.max_simulation_run_time=2000"]


@pytest.fixture(scope="module")
def tiny_config():
    return apply_reference_compat(load_config(CONFIG_PATH, "rllib_config",
                                              list(TINY)))


def test_one_epoch_trains_and_reports_the_jax_keys(tiny_config):
    loop = build_loop(tiny_config, "cpu")
    before = {k: v.clone() for k, v in loop.state.state_dict().items()}
    results = loop.run()
    loop.close()
    learner = results["learner"]
    assert set(learner) == {"policy_loss", "vf_loss", "kl", "entropy",
                            "total_loss", "clip_frac", "kl_coeff"}
    assert all(np.isfinite(v) for v in learner.values())
    after = loop.state.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert results["epoch_counter"] == 1
    assert results["env_steps_this_iter"] == results["total_env_steps"] == 16
    # the episode block of the JAX loop (train/loops.py:149, 1350)
    assert results["episodes"], "no episode finished in the epoch"
    for key in ("episode_reward_mean", "episode_reward_min",
                "episode_reward_max", "episode_len_mean",
                "episodes_this_iter", "custom_metrics/acceptance_rate_mean",
                "epoch_time", "run_time"):
        assert key in results, key
    assert set(results["timing"]) == {"collect_s", "update_s", "env_s",
                                      "sample_s"}


def test_evaluate_isolates_the_global_rng(tiny_config):
    loop = build_loop(tiny_config, "cpu")
    np.random.seed(123)
    random.seed(123)
    np_state, py_state = np.random.get_state(), random.getstate()
    summary = loop.evaluate(2, seed=9)
    loop.close()
    after = np.random.get_state()
    assert all(np.array_equal(a, b) for a, b in zip(np_state, after))
    assert random.getstate() == py_state
    assert summary["episodes_this_iter"] == 2
    assert np.isfinite(summary["episode_reward_mean"])
    # reusing the cached eval envs replays the same episodes
    assert loop.evaluate(2, seed=9) == summary


def test_checkpoint_round_trip_is_bit_equal(tiny_config, tmp_path):
    loop = build_loop(tiny_config, "cpu")
    loop.run()
    path = loop.save_agent_checkpoint(str(tmp_path / "ckpt"))
    saved = loop.state
    snapshot = {"params": [p.detach().clone() for p in saved.params],
                "mu": [m.clone() for m in saved.mu],
                "nu": [n.clone() for n in saved.nu],
                "kl_coeff": saved.kl_coeff.clone(), "step": saved.step}
    loop.run()  # move every part of the state on
    assert any(not torch.equal(a, b) for a, b in
               zip(snapshot["params"], loop.state.params))
    loop.load_agent_checkpoint(path)
    loop.close()
    for key in ("params", "mu", "nu"):
        for a, b in zip(snapshot[key], getattr(loop.state, key)):
            assert torch.equal(a, b), key
    assert torch.equal(snapshot["kl_coeff"], loop.state.kl_coeff)
    assert loop.state.step == snapshot["step"]


def test_unported_modes_raise(tiny_config):
    """What the port's loop does not run raises before any env is built:
    the fused and sebulba modes, an unknown algorithm, stale collection
    outside IMPALA's pipelined loop, an unported option turned on, an
    option the reference does not have, and the card where there is
    none."""
    from ddls_tpu_torch.train.loops import build_epoch_loop_kwargs

    kwargs = build_epoch_loop_kwargs(tiny_config)
    kwargs.update(device="cpu")
    for mode in ("fused", "sebulba"):
        with pytest.raises(ValueError, match="loop_mode must be one of"):
            make_epoch_loop("ppo", **dict(kwargs, loop_mode=mode))
    with pytest.raises(ValueError, match="no epoch loop"):
        make_epoch_loop("apex_dqn_typo", **kwargs)
    with pytest.raises(ValueError, match="does not support pipeline_depth"):
        RLEpochLoop(**dict(kwargs, loop_mode="pipelined", pipeline_depth=2))
    with pytest.raises(ValueError, match="not ported"):
        RLEpochLoop(**dict(kwargs, param_sharding="fsdp"))
    with pytest.raises(ValueError, match="unknown epoch-loop option"):
        RLEpochLoop(**dict(kwargs, evaluation_intervall=1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_epoch_loop("ppo", **dict(kwargs, loop_mode="sequential",
                                          device="cuda"))


def test_entry_point_runs_on_the_cpu(tiny_config, tmp_path):
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(tiny_config))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "ddls_tpu_torch.train", "--config",
         str(cfg_path), "--device", "cpu", "--epochs", "1",
         "--eval-episodes", "1", "--checkpoint-dir", str(tmp_path / "run")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln]
    assert lines[0]["epoch_counter"] == 1
    assert all(np.isfinite(v) for v in lines[0]["learner"].values())
    assert lines[-1]["epochs"] == 1
    assert "episode_reward_mean" in lines[-1]["evaluation"]
    assert os.path.exists(os.path.join(lines[-1]["checkpoint"],
                                       "train_state.pt"))
