"""The port's evolution strategies (ddls_tpu_torch/rl/es.py, its loop in
ddls_tpu_torch/train/loops.py, and the VectorEnv methods it needs) against
the JAX ones (ddls_tpu/rl/es.py, ddls_tpu/train/loops.py,
ddls_tpu/rl/rollout.py), on the CPU, where K15 and K16 take their plain
versions.

Inputs come from numpy seeds or from the committed fixture (the JAX ES
learner's population window on 10 real envs and its updates,
ddls_tpu_torch/data). Tolerances, each with its reason:
* the centred ranks, every action, the window's fitness and the env
  observations: exactly equal;
* float64 against JAX under x64 (in this process, ``jax.enable_x64``):
  1e-12 on one update's gradient and its norm, 1e-9 on params, adam's
  moments and metrics after three updates - the same arithmetic, sums
  reordered; the fitness mean, max and std are float32 even under x64
  (the reference casts the fitness), so a sum of 10 in another order is
  held to two float32 steps;
* float32 against JAX: 1e-6 of the largest magnitude on the gradient;
  the recorded updates within 1e-6 of each leaf's largest magnitude
  (observed 1.3e-7 on the params, 3.5e-7 on the moments, once the
  gradient takes the jitted reference's arithmetic), metrics within 1e-6
  of max(1, |JAX|).
The reference's jitted update takes ``rank / (P - 1) - 0.5`` as one fused
multiply-add with the float32 reciprocal (its eager ``centered_ranks``
divides): for P = 10 the two differ by one float32 step on some ranks.
The port's update (``rank_weights``, K15) takes the jitted arithmetic,
and ``centered_ranks`` the eager one; each is held against its own.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ddls_tpu.config import load_config
from ddls_tpu.envs import RampJobPartitioningEnvironment as JaxEnv
from ddls_tpu.parallel.mesh import make_mesh
from ddls_tpu.rl import es as jes
from ddls_tpu.rl.rollout import VectorEnv as JaxVectorEnv
from ddls_tpu.rl.rollout import stack_obs as jax_stack_obs
from ddls_tpu.train import loops as jloops
from ddls_tpu.train.compat import apply_reference_compat
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
from ddls_tpu_torch.models.convert import params_from_flax, params_to_flax
from ddls_tpu_torch.rl import es as tes
from ddls_tpu_torch.rl.fixture import (ES_CONFIG_PATH, load_dqn_es_fixture,
                                       load_train_config)
from ddls_tpu_torch.rl.rollout import VectorEnv, stack_obs
from ddls_tpu_torch.serve import load_export
from ddls_tpu_torch.serve.fixture import EXPORT_PATH
from ddls_tpu_torch.train import loops as tloops
from ddls_tpu_torch.train.__main__ import build_loop

# The suite runs under pytest-xdist, one worker process per core: one
# intra-op thread per process keeps torch's pools from oversubscribing the
# cores (every worker imports this module when it collects).
torch.set_num_threads(1)
CONFIG_PATH = "scripts/ramp_job_partitioning_configs"
F32_MIN = np.finfo(np.float32).min


def _fitness_cases(p, seed):
    """Fitness vectors with ties, a NaN, signed zeros, all equal, and
    float64 values that tie only in float32."""
    rng = np.random.default_rng(seed)
    cases = [rng.integers(0, 4, p).astype(np.float64) for _ in range(20)]
    cases += [rng.normal(0, 1, p)]
    nan = rng.integers(0, 3, p).astype(np.float64)
    nan[p // 2] = np.nan
    cases.append(nan)
    zeros = np.zeros(p)
    zeros[0] = -0.0
    cases += [zeros, np.full(p, 2.5), 1.0 + np.arange(p) * 1e-12]
    return cases


# ------------------------------------------------------ centred ranks
@pytest.mark.parametrize("p", [2, 4, 6, 10])
def test_centered_ranks_equal_jax_exactly(p):
    for fit in _fitness_cases(p, p):
        f32 = fit.astype(np.float32)
        want = np.asarray(jes.centered_ranks(jnp.asarray(f32)))
        got = tes.centered_ranks(torch.from_numpy(f32))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------- K15: the ES gradient
def _record_adam(stepsize):
    """optax.adam behind a transformation that keeps the raw gradient."""
    return optax.chain(optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u)), optax.adam(stepsize))


def _update_case(p, seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 3), "b": (5,)}
    theta = {k: rng.normal(0, 1, s).astype(dtype) for k, s in shapes.items()}
    eps = {k: rng.normal(0, 1, (p // 2,) + s).astype(dtype)
           for k, s in shapes.items()}
    return theta, eps


@pytest.mark.parametrize("p", [4, 10])
def test_es_update_plain_matches_jax_update_x64(p):
    """K15's plain version (gradient and metrics) against the reference
    ``_update`` jitted, as the learner runs it (its rank weights a fused
    product with the float32 reciprocal), under x64, at 1e-12, on fitness
    with ties, a NaN and all-equal members."""
    cfg = jes.ESConfig()
    for k, fit in enumerate(_fitness_cases(p, 7)[18:]):
        theta, eps = _update_case(p, k, np.float64)
        with jax.enable_x64(True):
            learner = jes.ESLearner(None, cfg, make_mesh(1), population=p)
            learner.tx = _record_adam(cfg.stepsize)
            state = jes.ESState.create(
                {kk: jnp.asarray(v) for kk, v in theta.items()}, learner.tx)
            state, metrics = jax.jit(learner._update)(
                state, {kk: jnp.asarray(v) for kk, v in eps.items()},
                jnp.asarray(fit, jnp.float32))
            want = {kk: np.asarray(v) for kk, v in
                    state.opt_state[0].items()}
            j_metrics = {kk: float(v) for kk, v in metrics.items()}
        keys = sorted(theta)
        flat_theta = torch.from_numpy(np.concatenate(
            [theta[kk].reshape(-1) for kk in keys]))
        flat_eps = torch.from_numpy(np.concatenate(
            [eps[kk].reshape(p // 2, -1) for kk in keys], axis=1))
        g, got_metrics, _ = tes.es_update(
            torch.from_numpy(fit.astype(np.float32)), flat_eps, flat_theta,
            cfg.noise_stdev, cfg.l2_coeff)
        want_flat = np.concatenate([want[kk].reshape(-1) for kk in keys])
        np.testing.assert_allclose(g.numpy(), want_flat, rtol=0,
                                   atol=1e-12 * np.abs(want_flat).max())
        # the fitness metrics are float32 by the reference's own cast:
        # held to two float32 steps, the gradient's norm to 1e-12
        for key, value in zip(tes.ES_METRIC_KEYS, got_metrics.tolist()):
            want_v = j_metrics[key]
            tol = 1e-12 if key == "grad_norm" else 2.4e-7
            if np.isnan(want_v):
                assert np.isnan(value), key
            else:
                assert abs(value - want_v) <= tol * max(1.0, abs(want_v))


def test_es_update_plain_matches_jax_update_f32():
    """The same in float32 against the reference's jitted update (P = 10):
    the gradient within 1e-6 of its largest magnitude."""
    cfg = jes.ESConfig()
    learner = jes.ESLearner(None, cfg, make_mesh(1), population=10)
    learner.tx = _record_adam(cfg.stepsize)
    for k, fit in enumerate(_fitness_cases(10, 8)[18:]):
        theta, eps = _update_case(10, k, np.float32)
        state = learner.init_state({kk: jnp.asarray(v)
                                    for kk, v in theta.items()})
        state, _ = learner.update(state, {kk: jnp.asarray(v)
                                          for kk, v in eps.items()}, fit)
        keys = sorted(theta)
        want = np.concatenate([np.asarray(state.opt_state[0][kk]).reshape(-1)
                               for kk in keys])
        g, _, _ = tes.es_update(
            torch.from_numpy(fit.astype(np.float32)),
            torch.from_numpy(np.concatenate(
                [eps[kk].reshape(5, -1) for kk in keys], axis=1)),
            torch.from_numpy(np.concatenate(
                [theta[kk].reshape(-1) for kk in keys])),
            cfg.noise_stdev, cfg.l2_coeff)
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


# ------------------------------------------------ K16: the noisy argmax
@pytest.mark.parametrize("x64", [True, False])
def test_es_act_plain_matches_jax_pop_actions(x64):
    """K16's plain version against the reference ``_pop_actions`` (the
    apply_fn hands back each member's masked logits, as the policy's
    ``_mask_logits`` makes them) with the per-member noise rebuilt from
    its key: the same action for every member over 20 keys and two noise
    scales, a fully masked member included."""
    p, a = 10, 17
    rng = np.random.default_rng(9)
    dtype = np.float64 if x64 else np.float32
    logits = rng.normal(0, 0.02, (p, a)).astype(dtype)
    mask = (rng.random((p, a)) < 0.5).astype(np.int32)
    mask[:, 2] = 1
    mask[0] = 0
    cfg = jes.ESConfig()
    with jax.enable_x64(x64):
        learner = jes.ESLearner(
            lambda prm, o: (prm["l"][None] + jnp.maximum(
                jnp.log(o["action_mask"].astype(jnp.float32)), F32_MIN),
                jnp.zeros(1)), cfg, make_mesh(1), population=p)
        cases = []
        for k in range(20):
            key = jax.random.PRNGKey(k)
            for std in (0.01, 1.0):
                want = np.asarray(learner._pop_actions(
                    {"l": jnp.asarray(logits)},
                    {"action_mask": jnp.asarray(mask)}, key, std))
                noise = np.stack([np.asarray(jax.random.normal(
                    sub, (a,), logits.dtype))
                    for sub in jax.random.split(key, p)])
                cases.append((want, noise, std))
    for want, noise, std in cases:
        got = tes.es_act(torch.from_numpy(logits), torch.from_numpy(mask),
                         torch.from_numpy(noise), std)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got[0]) == 0  # the fully masked member
        assert mask[np.arange(1, p), got.numpy()[1:]].all()


# --------------------------------------------- whole updates, x64
def test_es_update_x64_matches_jax_over_three_updates():
    """Three whole updates of the shipped params at P = 4 (the port in
    float64): params, adam's moments and metrics within 1e-9 after each,
    on seeded noise and fitness with ties and all-equal members."""
    cfg = jes.ESConfig()
    model, params, _ = load_export(EXPORT_PATH)
    flax_params = params_to_flax(params)
    rng = np.random.default_rng(10)
    # float32 values (params_from_flax, which lays them out, is float32)
    noise = [{k: rng.normal(0, 1, (2,) + v.shape).astype(np.float32)
              for k, v in flax_params.items()} for _ in range(3)]
    fitness = [np.array([3.0, 1.0, 3.0, 2.0]), np.full(4, 2.0),
               rng.normal(30, 3, 4)]
    with jax.enable_x64(True):
        learner = jes.ESLearner(None, cfg, make_mesh(1), population=4)

        def nest(flat):
            tree = {}
            for path, value in flat.items():
                node = tree
                parts = path.split("/")
                for part in parts[:-1]:
                    node = node.setdefault(part, {})
                node[parts[-1]] = jnp.asarray(value, jnp.float64)
            return tree
        state = learner.init_state(nest(flax_params))
        want = []
        for eps, fit in zip(noise, fitness):
            state, metrics = learner.update(state, nest(eps), fit)
            adam = state.opt_state[0]
            want.append({"params": params_to_flax_tree(state.params),
                         "mu": params_to_flax_tree(adam.mu),
                         "nu": params_to_flax_tree(adam.nu),
                         "metrics": {k: float(v)
                                     for k, v in metrics.items()}})
    port = tes.ESLearner(model.double(), tes.ESConfig(), 4, device="cpu")
    tstate = port.init_state({k: v.double() for k, v in params.items()})
    for step, (eps, fit, ref) in enumerate(zip(noise, fitness, want)):
        flat_eps = torch.stack([port.flat(params_from_flax(
            {k: v[i] for k, v in eps.items()}, model)).double()
            for i in range(2)])
        tstate, metrics = port.update(tstate, flat_eps, fit)
        for key, ours in (("params", tstate.params), ("mu", tstate.mu),
                          ("nu", tstate.nu)):
            tree = params_to_flax(dict(zip(tstate.names,
                                           [x.detach() for x in ours])))
            for leaf, value in tree.items():
                np.testing.assert_allclose(value, ref[key][leaf], rtol=0,
                                           atol=1e-9, err_msg=f"{key} {leaf}")
        assert set(metrics) == set(ref["metrics"])
        for key, value in metrics.items():
            assert abs(value - ref["metrics"][key]) <= 1e-9, (step, key)
    assert tstate.step == 3


def params_to_flax_tree(tree):
    """A JAX params tree -> the flattened ``params/...`` paths, float64."""
    out = {}

    def walk(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}/")
            else:
                out[f"{prefix}{key}"] = np.asarray(value)
    walk(tree, "")
    return out


# -------------------------------------------- the recorded f32 fixture
def test_recorded_es_window_and_updates_f32_match_jax():
    """The recorded 32-step window on 10 of the port's envs (seeded 0-9),
    the shipped params perturbed by the recorded noise, the recorded
    action noise: every action equal and the fitness bit-equal; then the
    three recorded updates within 1e-6 (params and moments of each leaf's
    largest magnitude, metrics of max(1, |JAX|))."""
    fx = load_dqn_es_fixture()["es"]
    model, params, _ = load_export(EXPORT_PATH)
    learner = tes.ESLearner(model, fx["cfg"], 10, device="cpu")
    state = learner.init_state(params)

    def flat_eps(eps):
        return torch.stack([learner.flat(params_from_flax(
            {k: v[i] for k, v in eps.items()}, model)) for i in range(5)])

    stacked = learner.stack(learner.flat(state.params),
                            flat_eps(fx["window"]["eps"]))
    env_cfg = load_train_config()["env_config"]
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(**env_cfg)
                     for _ in range(10)], seeds=list(range(10)))
    vec.reset()
    fitness = np.zeros(10)
    for t, noise in enumerate(fx["window"]["noise"]):
        actions = learner.pop_actions(stacked, stack_obs(vec.obs),
                                      torch.from_numpy(noise),
                                      fx["cfg"].action_noise_std)
        np.testing.assert_array_equal(actions, fx["window"]["actions"][t])
        _, rewards, _ = vec.step(actions)
        fitness += rewards
    np.testing.assert_array_equal(fitness, fx["window"]["fitness"])
    for step, ref in enumerate(fx["updates"], start=1):
        state, metrics = learner.update(state, flat_eps(ref["eps"]),
                                        ref["fitness"])
        for key, ours in (("params", state.params), ("mu", state.mu),
                          ("nu", state.nu)):
            tree = params_to_flax(dict(zip(state.names,
                                           [x.detach() for x in ours])))
            for leaf, value in tree.items():
                want = ref[key][leaf]
                assert np.abs(value - want).max() <= \
                    1e-6 * np.abs(want).max(), (step, key, leaf)
        for key, want in ref["metrics"].items():
            assert abs(metrics[key] - want) <= 1e-6 * max(1.0, abs(want))


# ----------------------------------------------- the VectorEnv methods
def test_vector_env_stacked_obs_and_restart_match_the_reference():
    """``stacked_obs`` equals the reference's; ``restart_episodes``
    advances every seed by the env count and starts the same fresh
    episodes as the reference's, whose observations are bit-equal (the JAX
    envs run to the end first: both simulators reseed the global RNGs)."""
    cfg = apply_reference_compat(load_config(
        CONFIG_PATH, "rllib_config", ["env_config=env_small"]))
    env_cfg = cfg["env_config"]
    runs = []
    for vec_cls, env_cls in ((JaxVectorEnv, JaxEnv),
                             (VectorEnv, RampJobPartitioningEnvironment)):
        vec = vec_cls([lambda: env_cls(**env_cfg) for _ in range(2)],
                      seeds=[3, 4])
        vec.reset()
        vec.step(np.array([1, 2]))
        first = vec.stacked_obs()
        copy = {k: v.copy() for k, v in first.items()}
        vec.step(np.array([0, 1]))
        again = vec.stacked_obs()
        for key in again:
            np.testing.assert_array_equal(
                again[key], (jax_stack_obs if vec_cls is JaxVectorEnv
                             else stack_obs)(vec.obs)[key])
        obs = vec.restart_episodes()
        runs.append((copy, [dict(o) for o in obs], list(vec.seeds),
                     vec.episode_lengths.copy()))
    (c0, o0, s0, l0), (c1, o1, s1, l1) = runs
    assert s0 == s1 == [5, 6]
    assert not l0.any() and not l1.any()
    for key in c0:
        np.testing.assert_array_equal(c0[key], c1[key])
    for a, b in zip(o0, o1):
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))


# ------------------------------------------------ config, loop
def test_config_translator_and_sizes_match_the_reference():
    algo_cfg = apply_reference_compat(load_config(
        CONFIG_PATH, "rllib_config", ["algo=es"]))["algo"]["algo_config"]
    assert dataclasses.asdict(tloops.es_config_from_rllib(algo_cfg)) == \
        dataclasses.asdict(jloops.es_config_from_rllib(algo_cfg))
    assert dataclasses.asdict(tes.ESConfig()) == \
        dataclasses.asdict(jes.ESConfig())
    for bad in ("noise_size", "lr"):
        with pytest.raises(ValueError, match="not consumed"):
            jloops.es_config_from_rllib(dict(algo_cfg, **{bad: 1}))
        with pytest.raises(ValueError, match="not consumed"):
            tloops.es_config_from_rllib(dict(algo_cfg, **{bad: 1}))
    assert tloops.EPOCH_LOOPS["es"] is tloops.ESEpochLoop
    with open(ES_CONFIG_PATH) as fh:
        cfg = json.load(fh)
    loop = tloops.ESEpochLoop.__new__(tloops.ESEpochLoop)
    loop._configure_algo(cfg["algo"]["algo_config"], None, None)
    assert (loop.num_envs, loop.rollout_length) == (10, 200)
    loop._configure_algo(cfg["algo"]["algo_config"], 3, None)
    assert (loop.num_envs, loop.rollout_length) == (4, 500)
    model, _, _ = load_export(EXPORT_PATH)
    with pytest.raises(ValueError, match="even"):
        tes.ESLearner(model, tes.ESConfig(), 3, device="cpu")


TINY = ["algo=es", "env_config=env_small", "epoch_loop=epoch_loop_default",
        "epoch_loop.num_envs=2", "epoch_loop.rollout_length=8",
        "env_config.max_simulation_run_time=2000",
        "algo.algo_config.eval_prob=1.0"]


def test_one_cpu_epoch_trains_repeats_and_round_trips(tmp_path):
    """One epoch of the ES loop on the tiny config, forced through its
    eval_prob branch: the reference's metric keys with the unperturbed
    fitness, the eval window's steps reported and its episodes restarted;
    params moved; a second loop from the same seed gives the same bits; a
    checkpoint round-trips bit for bit."""
    cfg = apply_reference_compat(load_config(CONFIG_PATH, "rllib_config",
                                             TINY))
    # in-process envs: the seeds and episode lengths checked below are
    # VectorEnv's own (subprocess workers keep theirs)
    cfg["epoch_loop"]["use_parallel_envs"] = False
    runs = []
    for attempt in range(2):
        loop = build_loop(cfg, "cpu")
        before = {k: v.clone() for k, v in loop.state.state_dict().items()}
        seeds = list(loop.vec_env.seeds)
        results = loop.run()
        after = {k: v.clone() for k, v in loop.state.state_dict().items()}
        runs.append((results["learner"], after))
        assert results["eval_env_steps_this_iter"] == 16
        assert all(s >= s0 + 2 for s, s0 in zip(loop.vec_env.seeds, seeds))
        assert not loop.vec_env.episode_lengths.any()
        if attempt == 0:
            path = loop.save_agent_checkpoint(str(tmp_path / "ckpt"))
            saved = [[x.detach().clone() for x in getattr(loop.state, key)]
                     for key in ("params", "mu", "nu")]
            loop.run()
            loop.load_agent_checkpoint(path)
            for snap, key in zip(saved, ("params", "mu", "nu")):
                assert all(torch.equal(a, b) for a, b in
                           zip(snap, getattr(loop.state, key))), key
            assert loop.state.step == 1 and loop.state.target_params is None
        loop.close()
    learner, after = runs[0]
    assert list(learner) == list(tes.ES_METRIC_KEYS) + ["eval_fitness_mean"]
    assert all(np.isfinite(v) for v in learner.values())
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in after.items())
    assert results["env_steps_this_iter"] == 16
