"""The port's Ape-X DQN (ddls_tpu_torch/rl/dqn.py, its loop in
ddls_tpu_torch/train/loops.py) against the JAX one (ddls_tpu/rl/dqn.py,
ddls_tpu/train/loops.py), on the CPU, where K13 and K14 take their plain
versions.

Inputs come from numpy seeds or from the committed fixtures (a real
trajectory of the shipped policy and the JAX learner's acting and updates
on it, ddls_tpu_torch/data). Tolerances, each with its reason:
* the host parts (n-step folding, the replay buffer, the epsilon
  schedule) and every action: exactly equal, the same numpy arithmetic;
* float64 against JAX under x64: 1e-12 on the dueling Q and the TD loss,
  its metrics and its gradient (in this process, ``jax.enable_x64``), 1e-9
  on params, target params, adam's moments, metrics and |td| after three
  whole updates (in a JAX subprocess) - the same arithmetic, sums
  reordered;
* float32 against JAX: 1e-6 of the largest magnitude on the loss and its
  gradient; the recorded updates within 1e-5 of each leaf's largest
  magnitude (observed 2.3e-6 on the params, 1.8e-6 on the moments,
  1.0e-6 on the first gradient), metrics within 1e-5 of max(1, |JAX|).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ddls_tpu.config import load_config
from ddls_tpu.parallel.mesh import make_mesh
from ddls_tpu.rl import dqn as jdqn
from ddls_tpu.train import loops as jloops
from ddls_tpu.train.compat import apply_reference_compat
from ddls_tpu_torch.models.convert import params_from_flax, params_to_flax
from ddls_tpu_torch.models.policy import GNNPolicy
from ddls_tpu_torch.rl import dqn as tdqn
from ddls_tpu_torch.rl.fixture import (DQN_CONFIG_PATH, TRAIN_PATH,
                                       fixture_replay, load_dqn_es_fixture,
                                       load_train_fixture)
from ddls_tpu_torch.rl.learner import Learner
from ddls_tpu_torch.train import loops as tloops
from ddls_tpu_torch.train.__main__ import build_loop

# The suite runs under pytest-xdist, one worker process per core: one
# intra-op thread per process keeps torch's pools from oversubscribing the
# cores (every worker imports this module when it collects).
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_PATH = os.path.join(REPO, "scripts", "ramp_job_partitioning_configs")
F32_MIN = np.finfo(np.float32).min
TINY_F32 = np.finfo(np.float32).tiny


# ------------------------------------------------------ the host parts
@pytest.mark.parametrize("num_envs", [1, 8, 32])
def test_per_worker_epsilons_equal_the_reference(num_envs):
    for cfg_kwargs in ({}, {"epsilon_timesteps": 100, "final_epsilon": 0.1}):
        jcfg, tcfg = jdqn.DQNConfig(**cfg_kwargs), tdqn.DQNConfig(**cfg_kwargs)
        for env_steps in (0, 37, 400_000, 1_000_000, 5_000_000):
            want = jdqn.per_worker_epsilons(num_envs, env_steps, jcfg)
            got = tdqn.per_worker_epsilons(num_envs, env_steps, tcfg)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert dataclasses.asdict(tdqn.DQNConfig()) == \
        dataclasses.asdict(jdqn.DQNConfig())
    with pytest.raises(NotImplementedError):
        tdqn.DQNConfig(num_atoms=51)


def _steps(rng, n, p_done):
    return [{"obs": {"x": np.float32(i)}, "action": int(rng.integers(17)),
             "reward": float(rng.normal()), "done": bool(rng.random()
                                                          < p_done),
             "next_obs": {"x": np.float32(i + 1)}} for i in range(n)]


def _same_transitions(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["obs"] is w["obs"] and g["next_obs"] is w["next_obs"]
        for key in ("action", "reward", "discount"):
            assert type(g[key]) is type(w[key])
            assert g[key] == w[key], key


@pytest.mark.parametrize("flush", [False, True])
def test_nstep_transitions_equal_the_reference(flush):
    """Random queues with episode ends, folded by both, queue by queue:
    the same transitions bit for bit and the same tail left queued."""
    rng = np.random.default_rng(0)
    for trial in range(200):
        steps = _steps(rng, int(rng.integers(0, 9)), 0.2)
        ours, theirs = list(steps), list(steps)
        n_step = int(rng.integers(1, 5))
        got = tdqn.nstep_transitions(ours, n_step, 0.9, flush)
        want = jdqn.nstep_transitions(theirs, n_step, 0.9, flush)
        _same_transitions(got, want)
        assert ours == theirs


def test_nstep_pins_of_the_reference():
    """tests/test_dqn.py's hand-computed n-step cases on the port."""
    def step(i, reward, done=False):
        return {"obs": {"x": np.float32(i)}, "action": i % 3,
                "reward": reward, "done": done,
                "next_obs": {"x": np.float32(i + 1)}}

    steps = [step(0, 1.0), step(1, 2.0), step(2, 4.0), step(3, 8.0)]
    out = tdqn.nstep_transitions(steps, 3, 0.5, flush=False)
    assert len(out) == 2 and len(steps) == 2
    assert out[0]["reward"] == pytest.approx(1 + 0.5 * 2 + 0.25 * 4)
    assert out[0]["discount"] == pytest.approx(0.5 ** 3)
    assert out[0]["next_obs"]["x"] == 3.0
    steps = [step(0, 1.0), step(1, 2.0, done=True), step(2, 4.0)]
    out = tdqn.nstep_transitions(steps, 3, 0.5, flush=False)
    assert out[0]["reward"] == pytest.approx(2.0)
    assert out[0]["discount"] == 0.0
    steps = [step(0, 1.0), step(1, 2.0, done=True)]
    out = tdqn.nstep_transitions(steps, 3, 0.5, flush=True)
    assert len(out) == 2 and steps == []
    assert out[1]["reward"] == pytest.approx(2.0) and out[1]["discount"] == 0


def _replays(capacity, alpha, beta, seed=0):
    return (tdqn.PrioritizedReplayBuffer(capacity, alpha, beta, 1e-6, seed),
            jdqn.PrioritizedReplayBuffer(capacity, alpha, beta, 1e-6, seed))


def test_replay_samples_and_priorities_equal_the_reference():
    """The same adds (nested dicts, a ring that wraps) and priority updates
    in both buffers from one seed: the same indices, weights, batches and
    priorities at every round."""
    rng = np.random.default_rng(1)
    ours, theirs = _replays(24, 0.9, 0.1)
    for i in range(40):
        tr = {"obs": {"a": rng.normal(size=3).astype(np.float32),
                      "m": rng.integers(0, 2, 4).astype(np.int32)},
              "action": np.int32(i % 5), "reward": np.float32(i),
              "discount": np.float32(0.97)}
        ours.add(tr)
        theirs.add(tr)
        if i % 7 == 6:
            got, g_idx, g_w = ours.sample(16)
            want, w_idx, w_w = theirs.sample(16)
            np.testing.assert_array_equal(g_idx, w_idx)
            np.testing.assert_array_equal(g_w, w_w)
            assert g_w.dtype == np.float32
            np.testing.assert_array_equal(got["obs"]["a"], want["obs"]["a"])
            np.testing.assert_array_equal(got["reward"], want["reward"])
            td = rng.normal(0, 2, 16)
            ours.update_priorities(g_idx, td)
            theirs.update_priorities(w_idx, td)
            np.testing.assert_array_equal(ours.priorities, theirs.priorities)
            assert ours.max_priority == theirs.max_priority
    assert ours.size == theirs.size == 24
    assert ours.next_idx == theirs.next_idx


def test_replay_pins_of_the_reference():
    """tests/test_dqn.py's ring wrap and priority bias on the port."""
    buf = tdqn.PrioritizedReplayBuffer(4, 1.0, 0.5, 1e-6, seed=0)
    for i in range(6):
        buf.add({"v": np.float32(i)})
    batch, _, w = buf.sample(32)
    assert buf.size == 4
    assert set(np.asarray(batch["v"]).astype(int)) <= {2, 3, 4, 5}
    assert w.shape == (32,) and w.max() == pytest.approx(1.0)
    buf = tdqn.PrioritizedReplayBuffer(8, 1.0, 0.4, 1e-6, seed=0)
    for i in range(8):
        buf.add({"v": np.float32(i)})
    buf.update_priorities(np.arange(8), np.array([100.0] + [1e-3] * 7))
    batch, _, _ = buf.sample(256)
    assert float(np.mean(np.asarray(batch["v"]) == 0)) > 0.8


# ------------------------------------------------------ K13: acting
def _act_case(seed, rows=12, a=17):
    """Heads, a mask with a fully masked row and a one-valid-action row,
    epsilons spanning 0..1."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (rows, a))
    values = rng.normal(0, 3, rows)
    mask = (rng.random((rows, a)) < 0.5).astype(np.int32)
    mask[:, 3] = 1
    mask[0] = 0
    mask[1] = 0
    mask[1, 11] = 1
    eps = np.linspace(0, 1, rows).astype(np.float32)
    return logits, values, mask, eps


@pytest.mark.parametrize("x64", [True, False])
@pytest.mark.parametrize("dueling", [True, False])
def test_dqn_act_plain_matches_jax_sample_actions(x64, dueling):
    """K13's plain version against the reference ``_sample_actions`` (the
    apply_fn hands back the heads) with the uniforms it draws internally
    rebuilt from its key: the same action on every row, over 20 keys; and
    ``dueling_q_values`` against the reference's."""
    logits, values, mask, eps = _act_case(2)
    dtype = np.float64 if x64 else np.float32
    logits, values = logits.astype(dtype), values.astype(dtype)
    cfg = jdqn.DQNConfig(dueling=dueling)
    with jax.enable_x64(x64):
        learner = jdqn.ApexDQNLearner(lambda p, o: (p["l"], p["v"]), cfg,
                                      make_mesh(1))
        params = {"l": jnp.asarray(logits), "v": jnp.asarray(values)}
        q_ref = np.asarray(jdqn.dueling_q_values(
            (params["l"], params["v"]), dueling))
        cases = []
        for k in range(20):
            rng = jax.random.PRNGKey(k)
            want = np.asarray(learner._sample_actions(
                params, {"action_mask": jnp.asarray(mask)}, rng,
                jnp.asarray(eps)))
            explore_rng, pick_rng = jax.random.split(rng)
            u_explore = np.array(jax.random.uniform(explore_rng, (12,)))
            u_pick = np.array(jax.random.uniform(
                pick_rng, mask.shape, jnp.float32, minval=TINY_F32,
                maxval=1.0))
            cases.append((want, u_explore, u_pick))
    t = torch.from_numpy
    q = tdqn.dueling_q_values(t(logits), t(values), dueling)
    np.testing.assert_allclose(q.numpy(), q_ref, rtol=0,
                               atol=(1e-12 if x64 else 1e-6)
                               * np.abs(q_ref).max())
    explored = 0
    for want, u_explore, u_pick in cases:
        got = tdqn.dqn_act(t(logits), t(values), t(mask), t(eps),
                           t(u_explore), t(u_pick), dueling)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        greedy = (u_explore >= eps) & mask.any(axis=1)
        assert mask[greedy, got.numpy()[greedy]].all()
        explored += int((u_explore < eps).sum())
    assert 0 < explored < 20 * 12


# ------------------------------------------------------ K14: the TD loss
def _td_case(seed, rows=24, a=17):
    """The three forwards' heads [3, N, A] / [3, N], a next mask with a
    fully masked row and a one-valid-action row, |td| below, at and above
    1 (rows 2-4), a zero discount, importance weights."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1, (3, rows, a))
    values = rng.normal(0, 1, (3, rows))
    mask = (rng.random((rows, a)) < 0.6).astype(np.int32)
    mask[:, 0] = 1
    mask[5] = 0
    mask[6] = 0
    mask[6, 9] = 1
    actions = rng.integers(0, a, rows).astype(np.int32)
    rewards = rng.normal(0, 1, rows)
    discounts = np.full(rows, 0.999 ** 3)
    discounts[7] = 0.0
    weights = rng.uniform(0.2, 1.0, rows)
    return logits, values, mask, actions, rewards, discounts, weights


def _pin_td(logits, values, rewards, discounts, dueling):
    """Rows 2-4: zero logits and value 0.25 (q_sel = 0.25 with dueling, 0
    without), no bootstrap, and rewards that make td exactly -0.5, -1 and 2
    (dyadic, exact in every float type)."""
    for row, td in ((2, -0.5), (3, -1.0), (4, 2.0)):
        logits[0, row] = 0.0
        values[0, row] = 0.25
        discounts[row] = 0.0
        rewards[row] = (0.25 if dueling else 0.0) - td


def _jax_td(logits, values, mask, actions, rewards, discounts, weights,
            dueling, double_q):
    """The reference ``_train_step``'s loss: its metrics, |td| and the
    gradient with respect to the online forward on obs (the first of a
    recording chain: before any clip), with an apply_fn that hands back
    the heads (online forwards from the params, the target's from the
    target params)."""
    n = logits.shape[1]
    cfg = jdqn.DQNConfig(dueling=dueling, double_q=double_q,
                         train_batch_size=n,
                         target_network_update_freq=10 ** 9)
    learner = jdqn.ApexDQNLearner(
        lambda p, o: (p["l"][o["which"][0]], p["v"][o["which"][0]]), cfg,
        make_mesh(1))
    learner.tx = optax.chain(optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u)), optax.sgd(0.0))
    params = {"l": jnp.asarray(logits[:2]), "v": jnp.asarray(values[:2])}
    target = {"l": jnp.asarray(logits[1:]), "v": jnp.asarray(values[1:])}
    state = jdqn.DQNTrainState.create(params, learner.tx).replace(
        target_params=target)
    batch = {"obs": {"which": jnp.zeros(n, jnp.int32)},
             "next_obs": {"which": jnp.ones(n, jnp.int32),
                          "action_mask": jnp.asarray(mask)},
             "actions": jnp.asarray(actions), "rewards": jnp.asarray(rewards),
             "discounts": jnp.asarray(discounts),
             "weights": jnp.asarray(weights)}
    state, metrics, td = learner._train_step(state, batch)
    grads = state.opt_state[0]
    assert not np.asarray(grads["l"][1]).any()  # the online next forward
    return ({k: float(v) for k, v in metrics.items()}, np.asarray(td),
            np.asarray(grads["l"][0]), np.asarray(grads["v"][0]))


@pytest.mark.parametrize("dueling,double_q", [(True, True), (False, True),
                                              (True, False), (False, False)])
@pytest.mark.parametrize("x64", [True, False])
def test_dqn_td_loss_plain_matches_jax_loss_fn(x64, dueling, double_q):
    """K14's plain version (loss, metrics, |td| and its autograd gradient)
    against the reference ``loss_fn`` with its metrics and
    ``jax.value_and_grad``: 1e-12 under x64, 1e-6 of the largest magnitude
    in float32; the pinned rows' |td| (0.5, 1, 2) exactly."""
    case = list(_td_case(3))
    dtype = np.float64 if x64 else np.float32
    case = [x.astype(dtype) if x.dtype == np.float64 else x for x in case]
    logits, values, mask, actions, rewards, discounts, weights = case
    _pin_td(logits, values, rewards, discounts, dueling)
    with jax.enable_x64(x64):
        j_metrics, j_td, j_dl, j_dv = _jax_td(*case, dueling, double_q)
    t = torch.from_numpy
    loss, metrics, td_abs, dl, dv = tdqn.dqn_td_loss_grad_plain(
        t(logits[0]), t(values[0]), t(logits[1]), t(values[1]),
        t(logits[2]), t(values[2]), t(mask), t(actions), t(rewards),
        t(discounts), t(weights), double_q, dueling)
    tol = 1e-12 if x64 else 1e-6
    got = dict(zip(tdqn.DQN_METRIC_KEYS, metrics.tolist()))
    assert set(got) == set(j_metrics)
    for key, want in j_metrics.items():
        assert abs(got[key] - want) <= tol * max(1.0, abs(want)), key
    assert float(loss) == pytest.approx(j_metrics["loss"], abs=tol)
    np.testing.assert_allclose(td_abs.numpy(), j_td, rtol=0,
                               atol=tol * np.abs(j_td).max())
    assert td_abs.numpy()[2:5].tolist() == [0.5, 1.0, 2.0]
    for g, want in ((dl, j_dl), (dv, j_dv)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1e-30))
    if not dueling:
        assert not dv.any()
    # the plain wrapper's forward is the same loss
    loss2, metrics2, td2 = tdqn.dqn_td_loss(
        t(logits[0]), t(values[0]), t(logits[1]), t(values[1]),
        t(logits[2]), t(values[2]), t(mask), t(actions), t(rewards),
        t(discounts), t(weights), double_q, dueling)
    assert torch.equal(loss2, loss) and torch.equal(metrics2, metrics)


# --------------------------------------------- adam in float32 (optax)
def test_adam_bias_correction_is_optax_float32():
    """At DQN's tuned lr every step moves a parameter by ~lr, so the bias
    correction's own rounding shows: optax takes ``1 - 0.999**count`` in
    float32 (6e-6 of a step away from the float64 value). Three adam steps
    in float32 against optax's within 1e-6 of each leaf's largest
    magnitude (float64 ``1 - b**count`` missed by 6.9e-6)."""
    rng = np.random.default_rng(4)
    shapes = [(6, 3), (3,)]
    params = [np.zeros(s, np.float32) for s in shapes]
    grads = [[rng.normal(0, 1e-3, s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    cfg = tdqn.DQNConfig()
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.adam(cfg.lr))
    j_params = [jnp.asarray(p) for p in params]
    opt_state = tx.init(j_params)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
    model = torch.nn.Module()
    for i, p in enumerate(params):
        model.register_parameter(f"p{i}", torch.nn.Parameter(
            torch.from_numpy(p.copy())))
    learner = Learner(model, cfg, device="cpu")
    state = learner.init_state()
    with torch.no_grad():
        for g in grads:
            learner._apply_optimizer(state, [torch.from_numpy(x) for x in g])
            state.step += 1
    for p, want in zip(state.params, j_params):
        want = np.asarray(want)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


# -------------------------------------------- the recorded f32 fixture
def _fixture_learner(fx, dtype=torch.float32):
    model = GNNPolicy(**fx["arch"]).to(dtype)
    params = {k: v.to(dtype) for k, v in
              params_from_flax(fx["init"], model).items()}
    learner = tdqn.ApexDQNLearner(model, fx["cfg"], device="cpu")
    return learner, learner.init_state(params)


def _leaf_rel(tree, ref):
    return max(float(np.abs(tree[k] - ref[k]).max()
                     / max(np.abs(ref[k]).max(), 1e-30)) for k in ref)


def test_recorded_dqn_acting_matches_jax():
    """K13 on the recorded trajectory's observations with the recorded
    epsilons and uniforms: JAX's action on every 8th step's 8 decisions at
    each of the 3 schedule points (``chip_smoke.py`` holds all 1,536 on the
    card)."""
    fx = load_dqn_es_fixture()["dqn"]
    learner, _ = _fixture_learner(fx)
    obs = load_train_fixture()["traj"]["obs"]
    act = fx["act"]
    for k in range(len(act["env_steps"])):
        for t in range(0, obs["action_mask"].shape[0], 8):
            got = learner.eps_greedy_actions(
                {key: v[t] for key, v in obs.items()}, act["eps"][k],
                torch.from_numpy(act["u_explore"][k, t]),
                torch.from_numpy(act["u_pick"][k, t]))
            np.testing.assert_array_equal(got, act["actions"][k, t])


def test_recorded_dqn_updates_f32_match_jax():
    """The fixture's three JAX updates on the same replay rows and weights:
    the first gradient, params, target params and adam's moments within
    1e-5 of each leaf's largest magnitude after each update, metrics within
    1e-5 of max(1, |JAX|), |td| within 1e-5 of its largest, the port's own
    priorities within 1e-5 relative of the recorded ones; the target is
    the online params right after the update-2 sync and differs from them
    after update 3."""
    fx = load_dqn_es_fixture()["dqn"]
    learner, state = _fixture_learner(fx)
    replay = fixture_replay(fx["cfg"])
    assert replay.size == 488
    for step, ref in enumerate(fx["updates"], start=1):
        batch = tdqn.train_batch(replay.gather(ref["idx"]), ref["weights"])
        if step == 1:
            _, _, grads = learner.loss_and_grads(state,
                                                 learner.stage_batch(batch))
            tree = params_to_flax(dict(zip(state.names, grads)))
            assert _leaf_rel(tree, ref["grads"]) <= 1e-5
        state, metrics, td = learner.train_step(state, batch)
        replay.update_priorities(ref["idx"], td)
        for key, ours in (("params", state.params), ("mu", state.mu),
                          ("nu", state.nu),
                          ("target_params", state.target_params)):
            tree = params_to_flax(dict(zip(state.names,
                                           [x.detach() for x in ours])))
            assert _leaf_rel(tree, ref[key]) <= 1e-5, (step, key)
        for key, want in ref["metrics"].items():
            assert abs(metrics[key] - want) <= 1e-5 * max(1.0, abs(want))
        np.testing.assert_allclose(td, ref["td_abs"], rtol=0,
                                   atol=1e-5 * np.abs(ref["td_abs"]).max())
        np.testing.assert_allclose(replay.priorities[:488],
                                   ref["priorities"], rtol=1e-5, atol=0)
        synced = all(torch.equal(a, b) for a, b in
                     zip(state.target_params, state.params))
        assert synced == (step == 2)
    assert state.step == 3


# ------------------------------------------- whole updates, x64
X64_SCRIPT = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp

assert jax.config.read("jax_enable_x64")
args = json.loads(sys.argv[1])
sys.path.insert(0, args["scripts"])
import export_torch_dqn_es_fixture as dqn_export
import export_torch_serve_fixture as serve_export
import export_torch_train_config as config_export
from ddls_tpu.models.policy import batched_policy_apply
from ddls_tpu.parallel.mesh import make_mesh
from ddls_tpu.rl.dqn import ApexDQNLearner, DQNConfig

model, _ = dqn_export.dqn_model(config_export.composed_config("apex_dqn"))
with np.load(args["batch"]) as z:
    arrays = {k: z[k] for k in z.files}
def half(name):
    out = {k[len(name) + 1:]: v for k, v in arrays.items()
           if k.startswith(name + "/")}
    for k in ("node_features", "edge_features", "graph_features"):
        out[k] = out[k].astype(np.float64)
    return out
batch = {"obs": half("obs"), "next_obs": half("next_obs"),
         **{k: arrays[k] for k in ("actions", "rewards", "discounts",
                                   "weights")}}
params = model.init(jax.random.PRNGKey(0),
                    {k: v[0] for k, v in batch["obs"].items()})
params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                params)
out = {f"init/{k}": v for k, v in
       serve_export.flatten({"params": params["params"]}).items()}
for name, overrides in args["runs"].items():
    learner = ApexDQNLearner(lambda p, o: batched_policy_apply(model, p, o),
                             DQNConfig(**overrides), make_mesh(1))
    state = learner.init_state(params)
    for step in range(args["steps"]):
        state, metrics, td = learner.train_step(state, batch)
        host = jax.device_get(state)
        adam = host.opt_state[-1][0]
        prefix = f"{name}/{step}/"
        for key, tree in (("params", host.params),
                          ("target_params", host.target_params),
                          ("mu", adam.mu), ("nu", adam.nu)):
            out.update({prefix + key + "/" + k: np.asarray(v) for k, v in
                        serve_export.flatten(
                            {"params": tree["params"]}).items()})
        out.update({prefix + "metrics/" + k: np.asarray(v)
                    for k, v in metrics.items()})
        out[prefix + "td_abs"] = np.asarray(td)
np.savez(args["out"], **out)
print("X64_DQN_OK")
"""

ROWS = 16
X64_RUNS = {
    # sync every 2 updates (32 // 16), the tuned shape otherwise
    "double_dueling": {"lr": 1e-3, "train_batch_size": ROWS,
                       "target_network_update_freq": 2 * ROWS},
    "plain_clipped": {"lr": 1e-3, "train_batch_size": ROWS,
                      "target_network_update_freq": 2 * ROWS,
                      "double_q": False, "dueling": False, "grad_clip": 0.5},
}


def _x64_batch():
    """16 replay rows from the recorded trajectory (obs at step t, next obs
    at t + 1) with seeded actions, rewards, discounts (one 0) and weights,
    next row 0 fully masked and next row 1 with one valid action."""
    traj = load_train_fixture()["traj"]
    rng = np.random.default_rng(5)
    ts, bs = rng.integers(0, 63, ROWS), rng.integers(0, 8, ROWS)
    obs = {k: v[ts, bs] for k, v in traj["obs"].items()}
    nxt = {k: v[ts + 1, bs].copy() for k, v in traj["obs"].items()}
    nxt["action_mask"][0] = 0
    nxt["action_mask"][1] = 0
    nxt["action_mask"][1, 5] = 1
    discounts = np.full(ROWS, 0.999 ** 3, np.float64)
    discounts[3] = 0.0
    return {"obs": obs, "next_obs": nxt,
            "actions": rng.integers(0, 17, ROWS).astype(np.int32),
            "rewards": rng.normal(0, 1, ROWS),
            "discounts": discounts,
            "weights": rng.uniform(0.2, 1.0, ROWS)}


@pytest.fixture(scope="module")
def x64_reference(tmp_path_factory):
    """The JAX learner under x64 in a subprocess: 3 whole updates of each
    run of ``X64_RUNS`` on ``_x64_batch`` from flax's initialisation."""
    tmp = tmp_path_factory.mktemp("dqn_x64")
    batch = _x64_batch()
    arrays = {f"obs/{k}": v for k, v in batch["obs"].items()}
    arrays.update({f"next_obs/{k}": v for k, v in batch["next_obs"].items()})
    arrays.update({k: batch[k] for k in ("actions", "rewards", "discounts",
                                         "weights")})
    np.savez(tmp / "batch.npz", **arrays)
    args = {"scripts": os.path.join(REPO, "scripts"),
            "batch": str(tmp / "batch.npz"), "steps": 3, "runs": X64_RUNS,
            "out": str(tmp / "out.npz")}
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", X64_SCRIPT,
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert "X64_DQN_OK" in res.stdout
    return batch, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("run", sorted(X64_RUNS))
def test_train_step_x64_matches_jax_over_three_updates(x64_reference, run):
    """Three whole updates at the apex_dqn widths, the port in float64
    (trimmed to its bucket) against the JAX learner under x64 (at the env's
    pad): params, target params, adam's moments, metrics and |td| within
    1e-9 after each; the target syncs at update 2 only."""
    batch, ref = x64_reference
    arch = load_dqn_es_fixture()["dqn"]["arch"]
    model = GNNPolicy(**arch).double()
    init = {k[len("init/"):]: v for k, v in ref.items()
            if k.startswith("init/")}
    params = {k: v.double() for k, v in
              params_from_flax(init, model).items()}
    learner = tdqn.ApexDQNLearner(model, tdqn.DQNConfig(**X64_RUNS[run]),
                                  device="cpu")
    state = learner.init_state(params)
    for step in range(3):
        state, metrics, td = learner.train_step(state, batch)
        prefix = f"{run}/{step}/"
        for key, ours in (("params", state.params),
                          ("target_params", state.target_params),
                          ("mu", state.mu), ("nu", state.nu)):
            tree = params_to_flax(dict(zip(state.names,
                                           [x.detach() for x in ours])))
            for leaf, value in tree.items():
                assert value.dtype == np.float64
                np.testing.assert_allclose(
                    value, ref[f"{prefix}{key}/{leaf}"], rtol=0, atol=1e-9,
                    err_msg=f"{key} {leaf}")
        for key, value in metrics.items():
            assert abs(value - float(ref[prefix + "metrics/" + key])) <= \
                1e-9, key
        np.testing.assert_allclose(td, ref[prefix + "td_abs"], rtol=0,
                                   atol=1e-9)
        synced = all(torch.equal(a, b) for a, b in
                     zip(state.target_params, state.params))
        assert synced == (step == 1)
    moved = params_to_flax(state.state_dict())
    assert max(float(np.abs(moved[k] - init[k]).max()) for k in init) > 1e-4


# ------------------------------------------------ config, loop, CLI
def _algo_yaml():
    return apply_reference_compat(load_config(
        CONFIG_PATH, "rllib_config", ["algo=apex_dqn"]))["algo"]["algo_config"]


def test_config_translator_matches_the_reference():
    algo_cfg = _algo_yaml()
    assert dataclasses.asdict(tloops.dqn_config_from_rllib(algo_cfg)) == \
        dataclasses.asdict(jloops.dqn_config_from_rllib(algo_cfg))
    for bad in ("max_requests_in_flight_per_sampler_worker", "lambda"):
        with pytest.raises(ValueError, match="not consumed"):
            jloops.dqn_config_from_rllib(dict(algo_cfg, **{bad: 1}))
        with pytest.raises(ValueError, match="not consumed"):
            tloops.dqn_config_from_rllib(dict(algo_cfg, **{bad: 1}))
    assert tloops.EPOCH_LOOPS["apex_dqn"] is tloops.ApexDQNEpochLoop
    with open(DQN_CONFIG_PATH) as fh:
        cfg = json.load(fh)
    loop = tloops.ApexDQNEpochLoop.__new__(tloops.ApexDQNEpochLoop)
    loop._configure_algo(cfg["algo"]["algo_config"], None, None)
    assert (loop.num_envs, loop.rollout_length) == (32, 16)
    assert loop.algo_cfg.train_batch_size == 512


TINY = ["algo=apex_dqn", "env_config=env_small",
        "epoch_loop=epoch_loop_default", "epoch_loop.num_envs=2",
        "epoch_loop.rollout_length=8",
        "env_config.max_simulation_run_time=2000",
        "algo.algo_config.train_batch_size=8",
        "algo.algo_config.target_network_update_freq=16",
        "algo.algo_config.lr=1e-3",
        "algo.algo_config.replay_buffer_config.capacity=1000",
        "algo.algo_config.replay_buffer_config.learning_starts=0"]


def _tiny():
    return apply_reference_compat(load_config(CONFIG_PATH, "rllib_config",
                                              TINY))


def test_one_cpu_epoch_trains_repeats_and_round_trips(tmp_path):
    """One epoch of the DQN loop on the tiny config: the reference's metric
    keys, finite, params moved, the model unmasked; a second loop from the
    same seed gives the same bits; a checkpoint (with the target network)
    round-trips bit for bit."""
    runs = []
    for attempt in range(2):
        loop = build_loop(_tiny(), "cpu")
        assert not loop.model.apply_action_mask
        before = {k: v.clone() for k, v in loop.state.state_dict().items()}
        results = loop.run()
        after = {k: v.clone() for k, v in loop.state.state_dict().items()}
        runs.append((results["learner"], after))
        if attempt == 0:
            path = loop.save_agent_checkpoint(str(tmp_path / "ckpt"))
            saved = [[x.detach().clone() for x in getattr(loop.state, key)]
                     for key in ("params", "target_params", "mu", "nu")]
            loop.run()
            loop.load_agent_checkpoint(path)
            for snap, key in zip(saved, ("params", "target_params", "mu",
                                         "nu")):
                assert all(torch.equal(a, b) for a, b in
                           zip(snap, getattr(loop.state, key))), key
            assert loop.state.step == 2
            # the restored target network is the one the learner runs
            live = dict(loop.learner.target_model.named_parameters())
            assert all(torch.equal(live[n], t) for n, t in
                       zip(loop.state.names, saved[1]))
            assert loop.evaluate(1)["episodes_this_iter"] == 1
        loop.close()
    learner, after = runs[0]
    assert list(learner)[:4] == list(tdqn.DQN_METRIC_KEYS)
    # 16 steps less the n-step queues' tails (2 x 2 unless an episode end
    # flushed them)
    assert learner["num_updates"] == 2
    assert 12 <= learner["replay_size"] <= 16
    assert all(np.isfinite(v) for v in learner.values())
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in after.items())
    assert results["env_steps_this_iter"] == 16


def test_entry_point_trains_apex_dqn_on_the_cpu(tmp_path):
    """``python -m ddls_tpu_torch.train`` with the DQN config trains on the
    CPU when asked (``--device cpu``: two updates, a checkpoint with the
    target network) and otherwise asks for the card."""
    cfg_path = tmp_path / "tiny_dqn.json"
    cfg_path.write_text(json.dumps(_tiny()))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    if not torch.cuda.is_available():
        proc = subprocess.run(
            [sys.executable, "-m", "ddls_tpu_torch.train", "--config",
             str(cfg_path), "--epochs", "1"],
            capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "ddls_tpu_torch.train", "--config",
         str(cfg_path), "--device", "cpu", "--epochs", "1",
         "--checkpoint-dir", str(tmp_path / "run")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln]
    assert lines[0]["learner"]["num_updates"] == 2
    assert np.isfinite(lines[0]["learner"]["loss"])
    saved = torch.load(os.path.join(lines[-1]["checkpoint"],
                                    "train_state.pt"), weights_only=True)
    assert "target_params" in saved and "kl_coeff" not in saved
    assert os.path.getsize(TRAIN_PATH) > 0
