"""Export the JAX Ape-X DQN and ES learners' acting and updates, for the
PyTorch port.

    python scripts/export_torch_dqn_es_fixture.py [--out-dir DIR]

Writes ``dqn_es_train_price_mixed.npz`` (default directory:
``ddls_tpu_torch/data``) with three recordings, on the shipped
``env_load32_price_mixed`` configuration:

* **DQN acting.** ``dqn/arch``: the JSON of the apex_dqn Q-network
  (``algo/apex_dqn.yaml``: heads 24->256->17 and 24->256->1, no action
  masking); ``dqn/init/params/...``: its flax initialisation from
  ``PRNGKey(0)``. On the recorded PPO trajectory's observations
  (``ppo_train_price_mixed.npz``, 64 steps x 8 envs), at each of the
  schedule points ``EPS_STEPS`` (``dqn/act/env_steps``):
  ``dqn/act/eps`` [3, 8] from ``per_worker_epsilons(8, env_steps)``, and
  per step the explore and pick uniforms that
  ``ApexDQNLearner._sample_actions`` draws from its step key
  (``split(rng)``; ``uniform(explore_rng, [B])``;
  ``uniform(pick_rng, [B, A], minval=tiny, maxval=1)``, what
  ``categorical`` feeds its Gumbel noise): ``dqn/act/u_explore`` [3, 64,
  8], ``dqn/act/u_pick`` [3, 64, 8, 17] and the actions
  ``dqn/act/actions`` [3, 64, 8]. The script checks that its
  reconstruction reproduces every action of ``_sample_actions``.
* **DQN updates.** The trajectory folded into n-step transitions (per
  lane, t = 0..62 with ``next_obs = obs[t + 1]``, ``nstep_transitions``
  without flush: 61 x 8 = 488), added lane by lane per step to a
  ``PrioritizedReplayBuffer`` (seed 0), then ``UPDATES`` rounds of
  ``sample(512)`` -> ``train_step`` -> ``update_priorities`` under the
  tuned config (``dqn/config``) with two cuts: ``target_network_update_
  freq`` 1024 (a target sync every 2 updates, so update 2 syncs and update
  3 has target != online), and ``learning_starts`` not applied (the
  learner does not read it). Per update k: ``dqn/update<k>/idx`` and
  ``weights``; ``params/...``, adam's ``mu/...`` and ``nu/...``;
  ``metrics/<key>``; ``td_abs`` [512]; ``priorities`` [488] after the
  priority update; ``target_from``, the update whose params the target
  network holds (0: the initialisation), checked bit for bit here.
  ``dqn/update1/grads/...`` is the first update's gradient (before the
  clip). At the tuned lr an adam step moves a parameter by ~30 float32
  steps, so the gradient and the moments carry the check.
* **ES.** ``es/config`` (``algo/es.yaml``) and a population of 10 around
  the shipped params: ``ESLearner.perturb`` with ``PRNGKey(1)``
  (``es/window/eps/params/...``, [5, ...] per leaf), a window of
  ``WINDOW`` steps of 10 envs seeded 0-9 driven member by member
  (``evaluate_population``'s loop) with the per-step per-member action
  noise ``es/window/noise`` [32, 10, 17] (``normal(split(sub, 10)[p],
  [17])``), the actions ``es/window/actions`` and the fitness
  ``es/window/fitness`` [10] (float64); the script checks that the noise
  reproduces every action. Then 3 ``_update``s: update 1 on that fitness
  and eps, updates 2 and 3 on ``perturb`` eps of ``PRNGKey(2)`` and
  ``PRNGKey(3)`` (``es/update<k>/eps/...``) with the fitness vectors
  ``FITNESS`` (ties, a float64 pair that ties in float32, an antithetic
  pair with equal fitness; then all equal). Per update:
  ``es/update<k>/fitness``, ``params/...``, ``mu/...``, ``nu/...``,
  ``metrics/<key>``.

Deterministic: rerunning it reproduces every array bit for bit
(tests/test_torch_fixture.py checks that).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

import export_torch_serve_fixture as serve_export  # noqa: E402
import export_torch_train_config as config_export  # noqa: E402
import export_torch_train_fixture as train_export  # noqa: E402

OUT_NAME = "dqn_es_train_price_mixed.npz"
EPS_STEPS = (0, 400_000, 1_000_000)
ACT_SEED = 100
UPDATES = 3
TARGET_UPDATE_FREQ = 1024
POPULATION = 10
WINDOW = 32
NOISE_SEED = 11
FITNESS = {
    2: [3.0, 1.0, 3.0, 2.0, 1.0 + 1e-12, 1.0, 0.5, 3.0, 2.5, 4.0],
    3: [2.0] * POPULATION,
}


def _flat(prefix: str, tree) -> Dict[str, np.ndarray]:
    """``<prefix>/params/...``: a flax tree flattened, as float32."""
    return {f"{prefix}/{k}": np.asarray(v, np.float32) for k, v in
            serve_export.flatten({"params": tree["params"]}).items()}


def recorded_traj():
    path = os.path.join(serve_export.OUT_DIR, train_export.OUT_NAME)
    with np.load(path, allow_pickle=False) as data:
        obs = {k: data[f"obs/{k}"] for k in train_export.TRAJ_OBS_KEYS}
        return obs, data["actions"], data["rewards"], data["dones"]


# ------------------------------------------------------------------- DQN
def dqn_model(cfg):
    """(model, arch dict): the Q-network the apex_dqn loop builds."""
    from ddls_tpu.train.loops import build_policy_from_model_config
    from ddls_tpu.utils.common import recursive_update

    model_config = recursive_update(copy.deepcopy(cfg["model"]),
                                    copy.deepcopy(cfg["algo"]["model"]))
    model_config["custom_model_config"]["apply_action_mask"] = False
    model = build_policy_from_model_config(17, model_config)
    arch = {
        "n_actions": int(model.n_actions),
        "graph_feature_dim": 51,
        "out_features_msg": int(model.out_features_msg),
        "out_features_hidden": int(model.out_features_hidden),
        "out_features_node": int(model.out_features_node),
        "out_features_graph": int(model.out_features_graph),
        "num_rounds": int(model.num_rounds),
        "module_depth": int(model.module_depth),
        "activation": str(model.activation),
        "fcnet_hiddens": [int(h) for h in model.fcnet_hiddens],
        "fcnet_activation": str(model.fcnet_activation),
        "apply_action_mask": bool(model.apply_action_mask),
    }
    return model, arch


def _record_grads():
    """An optax transformation that passes the gradient on and keeps it
    as its state (the first of the chain: the raw gradient)."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def export_dqn(obs, actions, rewards, dones) -> Dict[str, np.ndarray]:
    import jax
    import jax.numpy as jnp
    import optax

    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu.parallel.mesh import make_mesh
    from ddls_tpu.rl.dqn import (ApexDQNLearner, PrioritizedReplayBuffer,
                                 per_worker_epsilons)
    from ddls_tpu.train.loops import dqn_config_from_rllib

    cfg = config_export.composed_config("apex_dqn")
    model, arch = dqn_model(cfg)
    dqn_cfg = dataclasses.replace(
        dqn_config_from_rllib(dict(cfg["algo"]["algo_config"])),
        target_network_update_freq=TARGET_UPDATE_FREQ)
    obs0 = {k: v[0, 0] for k, v in obs.items()}
    params = model.init(jax.random.PRNGKey(0), obs0)
    out = {"dqn/arch": np.array(json.dumps(arch, sort_keys=True)),
           "dqn/config": np.array(json.dumps(dataclasses.asdict(dqn_cfg),
                                             sort_keys=True))}
    out.update(_flat("dqn/init", params))

    apply = jax.jit(lambda p, o: batched_policy_apply(model, p, o))
    learner = ApexDQNLearner(lambda p, o: batched_policy_apply(model, p, o),
                             dqn_cfg, make_mesh(1))
    t_len, lanes = actions.shape
    tiny = jnp.finfo(jnp.float32).tiny
    eps_all, u_exp_all, u_pick_all, act_all = [], [], [], []
    for k, env_steps in enumerate(EPS_STEPS):
        eps = per_worker_epsilons(lanes, env_steps, dqn_cfg)
        rng = jax.random.PRNGKey(ACT_SEED + k)
        u_exp, u_pick, acts = [], [], []
        for t in range(t_len):
            rng, step_rng = jax.random.split(rng)
            step_obs = {key: jnp.asarray(v[t]) for key, v in obs.items()}
            got = np.asarray(learner.sample_actions(params, step_obs,
                                                    step_rng, eps))
            explore_rng, pick_rng = jax.random.split(step_rng)
            ue = np.asarray(jax.random.uniform(explore_rng, (lanes,)))
            up = np.asarray(jax.random.uniform(
                pick_rng, (lanes, arch["n_actions"]), jnp.float32,
                minval=tiny, maxval=1.0))
            # the reconstruction: the reference's own formulas on the
            # handed uniforms
            logits, values = apply(params, step_obs)
            q = values[:, None] + logits - logits.mean(axis=-1,
                                                       keepdims=True)
            mask = step_obs["action_mask"]
            greedy = jnp.argmax(jnp.where(mask.astype(bool), q,
                                          jnp.finfo(q.dtype).min), -1)
            drawn = jnp.argmax(jnp.log(mask.astype(jnp.float32) + 1e-30)
                               - jnp.log(-jnp.log(up)), -1)
            rebuilt = np.asarray(jnp.where(ue < eps, drawn, greedy))
            if not np.array_equal(rebuilt, got):
                raise RuntimeError(f"the handed uniforms do not reproduce "
                                   f"_sample_actions at point {k}, step {t}")
            u_exp.append(ue)
            u_pick.append(up)
            acts.append(got.astype(np.int32))
        eps_all.append(eps)
        u_exp_all.append(np.stack(u_exp))
        u_pick_all.append(np.stack(u_pick))
        act_all.append(np.stack(acts))
    out["dqn/act/env_steps"] = np.asarray(EPS_STEPS, np.int64)
    out["dqn/act/eps"] = np.stack(eps_all)
    out["dqn/act/u_explore"] = np.stack(u_exp_all)
    out["dqn/act/u_pick"] = np.stack(u_pick_all)
    out["dqn/act/actions"] = np.stack(act_all)

    # the updates
    replay = PrioritizedReplayBuffer(
        dqn_cfg.buffer_capacity, dqn_cfg.prioritized_replay_alpha,
        dqn_cfg.prioritized_replay_beta, dqn_cfg.prioritized_replay_eps,
        seed=0)
    for tr in replay_transitions(obs, actions, rewards, dones, dqn_cfg):
        replay.add(tr)
    learner.tx = optax.chain(_record_grads(), learner.tx)
    state = learner.init_state(params)
    snapshots = [jax.device_get(state.params)]
    for k in range(1, UPDATES + 1):
        batch, idx, weights = replay.sample(dqn_cfg.train_batch_size)
        state, metrics, td = learner.train_step(state, {
            "obs": batch["obs"], "actions": batch["action"],
            "rewards": batch["reward"], "next_obs": batch["next_obs"],
            "discounts": batch["discount"], "weights": weights})
        replay.update_priorities(idx, td)
        prefix = f"dqn/update{k}"
        host = jax.device_get(state)
        snapshots.append(host.params)
        # chain(record, chain(clip_by_global_norm, adam)): adam's state is
        # the first of the inner chain's adam pair
        record, (_, (adam, _)) = host.opt_state
        if k == 1:
            out.update(_flat(f"{prefix}/grads", record))
        out.update(_flat(prefix, host.params))
        out.update(_flat(f"{prefix}/mu", adam.mu))
        out.update(_flat(f"{prefix}/nu", adam.nu))
        for key, value in metrics.items():
            out[f"{prefix}/metrics/{key}"] = np.asarray(value, np.float32)
        out[f"{prefix}/idx"] = np.asarray(idx, np.int64)
        out[f"{prefix}/weights"] = np.asarray(weights, np.float32)
        out[f"{prefix}/td_abs"] = np.asarray(td, np.float32)
        out[f"{prefix}/priorities"] = replay.priorities[:replay.size].copy()
        sync_every = max(TARGET_UPDATE_FREQ // dqn_cfg.train_batch_size, 1)
        source = k if k % sync_every == 0 else int(
            out.get(f"dqn/update{k - 1}/target_from", 0))
        target = serve_export.flatten({"params": host.target_params[
            "params"]})
        held = serve_export.flatten({"params": snapshots[source]["params"]})
        if any(not np.array_equal(target[key], held[key]) for key in held):
            raise RuntimeError(f"update {k}: the target network is not the "
                               f"params of update {source}")
        out[f"{prefix}/target_from"] = np.asarray(source, np.int64)
    return out


def replay_transitions(obs, actions, rewards, dones, dqn_cfg) -> List[dict]:
    """The trajectory's n-step transitions in the loop's insertion order:
    per step t = 0..T-2, lane by lane, each lane's queue folded without
    flush (the reference's ``nstep_transitions``)."""
    from ddls_tpu.rl.dqn import nstep_transitions

    t_len, lanes = actions.shape
    queues: List[List[dict]] = [[] for _ in range(lanes)]
    out = []
    for t in range(t_len - 1):
        for b in range(lanes):
            queues[b].append({
                "obs": {k: v[t, b] for k, v in obs.items()},
                "action": int(actions[t, b]), "reward": float(rewards[t, b]),
                "done": bool(dones[t, b]),
                "next_obs": {k: v[t + 1, b] for k, v in obs.items()}})
            out += nstep_transitions(queues[b], dqn_cfg.n_step,
                                     dqn_cfg.gamma, flush=False)
    return out


# -------------------------------------------------------------------- ES
def export_es(policy_cfg, model, params) -> Dict[str, np.ndarray]:
    import jax
    import jax.numpy as jnp

    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu.parallel.mesh import make_mesh
    from ddls_tpu.rl import VectorEnv
    from ddls_tpu.rl.es import ESLearner
    from ddls_tpu.rl.rollout import stack_obs
    from ddls_tpu.train.loops import es_config_from_rllib

    cfg = config_export.composed_config("es")
    es_cfg = es_config_from_rllib(dict(cfg["algo"]["algo_config"]))
    apply = jax.jit(lambda p, o: batched_policy_apply(model, p, o)[0])
    learner = ESLearner(lambda p, o: batched_policy_apply(model, p, o),
                        es_cfg, make_mesh(1), population=POPULATION)
    out = {"es/config": np.array(json.dumps(dataclasses.asdict(es_cfg),
                                            sort_keys=True))}
    stacked, eps = learner.perturb(params, jax.random.PRNGKey(1))
    out.update(_flat("es/window/eps", eps))

    env_cfg = policy_cfg["env_config"]
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(**env_cfg)
                     for _ in range(POPULATION)],
                    seeds=list(range(POPULATION)))
    vec.reset()
    rng = jax.random.PRNGKey(NOISE_SEED)
    fitness = np.zeros(POPULATION, np.float64)
    noise_all, act_all = [], []
    for t in range(WINDOW):
        rng, sub = jax.random.split(rng)
        step_obs = stack_obs(vec.obs)
        got = np.asarray(learner.pop_actions(stacked, step_obs, sub))
        noise = np.stack([np.asarray(jax.random.normal(
            key, (17,), jnp.float32)) for key in
            jax.random.split(sub, POPULATION)])
        for p in range(POPULATION):
            member = jax.tree_util.tree_map(lambda x: x[p], stacked)
            logits = apply(member, {k: v[p:p + 1]
                                    for k, v in step_obs.items()})[0]
            pick = int(jnp.argmax(logits + es_cfg.action_noise_std
                                  * jnp.asarray(noise[p])))
            if pick != int(got[p]):
                raise RuntimeError(f"the recorded noise does not reproduce "
                                   f"member {p}'s action at step {t}")
        _, rewards, _ = vec.step(got)
        fitness += rewards
        noise_all.append(noise)
        act_all.append(got.astype(np.int32))
    out["es/window/noise"] = np.stack(noise_all)
    out["es/window/actions"] = np.stack(act_all)
    out["es/window/fitness"] = fitness

    state = learner.init_state(params)
    for k in range(1, UPDATES + 1):
        prefix = f"es/update{k}"
        if k == 1:
            fit = fitness
        else:
            _, eps = learner.perturb(state.params, jax.random.PRNGKey(k))
            out.update(_flat(f"{prefix}/eps", eps))
            fit = np.asarray(FITNESS[k], np.float64)
        out[f"{prefix}/fitness"] = fit
        state, metrics = learner.update(state, eps, fit)
        host = jax.device_get(state)
        adam = host.opt_state[0]
        out.update(_flat(prefix, host.params))
        out.update(_flat(f"{prefix}/mu", adam.mu))
        out.update(_flat(f"{prefix}/nu", adam.nu))
        for key, value in metrics.items():
            out[f"{prefix}/metrics/{key}"] = np.asarray(value, np.float32)
    return out


def export_dqn_es(cfg, model, params, graph_dim) -> Dict[str, np.ndarray]:
    del graph_dim
    obs, actions, rewards, dones = recorded_traj()
    arrays = export_dqn(obs, actions, rewards, dones)
    arrays.update(export_es(cfg, model, params))
    return arrays


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=serve_export.OUT_DIR)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(args.out_dir, exist_ok=True)
    arrays = export_dqn_es(*serve_export.load_policy())
    np.savez_compressed(os.path.join(args.out_dir, OUT_NAME), **arrays)
    print(json.dumps({"out_dir": args.out_dir, "updates": UPDATES,
                      "window": WINDOW}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
