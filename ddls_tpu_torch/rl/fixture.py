"""The shipped training fixtures: a real trajectory of the shipped
``ppo_price_mixed`` policy and the JAX learner's update of it
(``scripts/export_torch_train_fixture.py``); the JAX IMPALA and PG
learners' updates of the same trajectory
(``scripts/export_torch_ac_fixture.py``); the uniforms the JAX sampler
drew for that trajectory and a recorded greedy evaluation episode
(``scripts/export_torch_rollout_fixture.py``); the JAX Ape-X DQN
learner's acting and updates on that trajectory and the JAX ES learner's
population window and updates (``scripts/export_torch_dqn_es_fixture.py``);
and the composed training configs of the PPO, IMPALA, PG, Ape-X DQN and ES
runs as JSON (``scripts/export_torch_train_config.py``).

They travel with the port as numpy archives and JSON, so a machine with
neither JAX, orbax nor PyYAML can hold the port's rollout, update and
evaluation against the reference's.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

import numpy as np

from ddls_tpu_torch.rl.dqn import (DQNConfig, PrioritizedReplayBuffer,
                                   nstep_transitions)
from ddls_tpu_torch.rl.es import ESConfig
from ddls_tpu_torch.rl.impala import ImpalaConfig
from ddls_tpu_torch.rl.pg import PGConfig
from ddls_tpu_torch.rl.ppo import PPOConfig
from ddls_tpu_torch.serve.fixture import DATA_DIR

TRAIN_PATH = os.path.join(DATA_DIR, "ppo_train_price_mixed.npz")
AC_TRAIN_PATH = os.path.join(DATA_DIR, "ac_train_price_mixed.npz")
ROLLOUT_PATH = os.path.join(DATA_DIR, "ppo_rollout_price_mixed.npz")
TRAIN_CONFIG_PATH = os.path.join(DATA_DIR, "train_config_price_mixed.json")
IMPALA_CONFIG_PATH = os.path.join(DATA_DIR,
                                  "train_config_impala_price_mixed.json")
PG_CONFIG_PATH = os.path.join(DATA_DIR, "train_config_pg_price_mixed.json")
DQN_CONFIG_PATH = os.path.join(DATA_DIR,
                               "train_config_apex_dqn_price_mixed.json")
ES_CONFIG_PATH = os.path.join(DATA_DIR, "train_config_es_price_mixed.json")
DQN_ES_TRAIN_PATH = os.path.join(DATA_DIR, "dqn_es_train_price_mixed.npz")
PIPELINE_PATH = os.path.join(DATA_DIR, "ppo_pipeline_price_mixed.npz")
TRAJ_KEYS = ("actions", "logp", "values", "rewards", "dones")


def load_train_fixture(path: str = TRAIN_PATH) -> Dict[str, Any]:
    """``{"traj": {"obs": {...}, "actions", ...} [T, B, ...],
    "last_values" [B], "cfg": PPOConfig, "advantages", "value_targets"
    [T, B], "runs": {num_sgd_iter: {"perms" [I, T*B], "params"
    {flax path: array}, "metrics" {key: float}, "kl_coeff": float}},
    "mb0": {"grads" {flax path: array}, "metrics" {key: float}}}``: ``mb0``
    is the JAX loss's gradient and metrics at the initial params on the
    first minibatch of the 1-iteration update (``runs[1]["perms"][0]``'s
    first ``sgd_minibatch_size`` rows)."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    traj = {"obs": {k[len("obs/"):]: v for k, v in arrays.items()
                    if k.startswith("obs/")}}
    traj.update({k: arrays[k] for k in TRAJ_KEYS})
    runs: Dict[int, Dict[str, Any]] = {}
    mb0: Dict[str, Dict[str, Any]] = {"grads": {}, "metrics": {}}
    for key, value in arrays.items():
        if key.startswith("mb0/grads/"):
            mb0["grads"][key[len("mb0/grads/"):]] = value
        elif key.startswith("mb0/metrics/"):
            mb0["metrics"][key[len("mb0/metrics/"):]] = float(value)
        head, _, rest = key.partition("/")
        if not head.startswith("iter"):
            continue
        run = runs.setdefault(int(head[len("iter"):]),
                              {"params": {}, "metrics": {}})
        if rest.startswith("params/"):
            run["params"][rest] = value
        elif rest.startswith("metrics/"):
            run["metrics"][rest[len("metrics/"):]] = float(value)
        elif rest == "kl_coeff":
            run["kl_coeff"] = float(value)
        else:
            run[rest] = value
    return {"traj": traj, "last_values": arrays["last_values"],
            "cfg": PPOConfig(**json.loads(str(arrays["ppo_config"]))),
            "advantages": arrays["advantages"],
            "value_targets": arrays["value_targets"], "runs": runs,
            "mb0": mb0}


def load_ac_fixture(path: str = AC_TRAIN_PATH) -> Dict[str, Any]:
    """``{"impala": {"cfg": ImpalaConfig, "steps": [...]}, "pg": {"cfg":
    PGConfig, "returns" [T, B], "steps": [...]}}``: the JAX learners'
    successive updates of the training fixture's trajectory from the
    shipped params. Step k (the list's item k - 1) holds ``params`` {flax
    path: array} after update k and its ``metrics`` {key: float}; IMPALA's
    also ``target_logp``, ``vs`` and ``pg_adv`` [T, B], V-trace's at the
    params before update k."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    out: Dict[str, Any] = {}
    for algo, cls in (("impala", ImpalaConfig), ("pg", PGConfig)):
        steps: Dict[int, Dict[str, Any]] = {}
        for key, value in arrays.items():
            head, _, rest = key.partition("/")
            step, _, rest = rest.partition("/")
            if head != algo or not step.startswith("step"):
                continue
            entry = steps.setdefault(int(step[len("step"):]),
                                     {"params": {}, "metrics": {}})
            if rest.startswith("params/"):
                entry["params"][rest] = value
            elif rest.startswith("metrics/"):
                entry["metrics"][rest[len("metrics/"):]] = float(value)
            else:
                entry[rest] = value
        out[algo] = {"cfg": cls(**json.loads(str(arrays[f"{algo}/config"]))),
                     "steps": [steps[k] for k in sorted(steps)]}
    out["pg"]["returns"] = arrays["pg/returns"]
    return out


def load_rollout_fixture(path: str = ROLLOUT_PATH) -> Dict[str, Any]:
    """``{"uniforms" [T, B, A] float32, "eval": {"record": {...}, "seed":
    int, "interarrival": float}}``: the uniforms behind the training
    fixture's sampled actions, and the JAX greedy episode of the shipped
    policy at a fixed interarrival time from ``seed``."""
    with np.load(path, allow_pickle=False) as data:
        return {"uniforms": data["uniforms"],
                "eval": {"record": json.loads(str(data["eval/record"])),
                         "seed": int(data["eval/seed"]),
                         "interarrival": float(data["eval/interarrival"])}}


def load_pipeline_fixture(path: str = PIPELINE_PATH) -> Dict[str, Any]:
    """``{"traj": {"obs": {...}, "actions", ...} [T, B, ...],
    "last_values" [B]}``: the JAX collect of the shipped policy over 8
    subprocess envs on the shm transport, on the deferred-fetch schedule
    (``scripts/export_torch_pipeline_fixture.py``); its sampler drew
    ``load_rollout_fixture``'s uniforms."""
    with np.load(path, allow_pickle=False) as data:
        traj = {"obs": {k[len("obs/"):]: data[k] for k in data.files
                        if k.startswith("obs/")}}
        traj.update({k: data[k] for k in TRAJ_KEYS})
        return {"traj": traj, "last_values": data["last_values"]}


def load_train_config(path: str = TRAIN_CONFIG_PATH) -> Dict[str, Any]:
    """A composed training config (a fresh dict each call); by default
    the PPO run's."""
    with open(path) as fh:
        return json.load(fh)


def load_dqn_es_fixture(path: str = DQN_ES_TRAIN_PATH) -> Dict[str, Any]:
    """The JAX Ape-X DQN and ES recordings
    (``scripts/export_torch_dqn_es_fixture.py``)::

        {"dqn": {"arch": GNNPolicy kwargs, "cfg": DQNConfig,
                 "init": {flax path: array},
                 "act": {"env_steps" [3], "eps" [3, B], "u_explore"
                         [3, T, B], "u_pick" [3, T, B, A], "actions"
                         [3, T, B]},
                 "updates": [{"idx", "weights", "params", "mu", "nu",
                              "target_params", "metrics", "td_abs",
                              "priorities"} x 3]},
         "es": {"cfg": ESConfig, "window": {"eps", "noise" [T, P, A],
                                            "actions" [T, P], "fitness" [P]},
                "updates": [{"eps", "fitness", "params", "mu", "nu",
                             "metrics"} x 3]}}

    The DQN act recordings run on the training fixture's observations;
    the first DQN update also holds ``grads``, its gradient before the
    clip. ``target_params`` is the target network after the update (the
    params of the update it last synced at, or the initialisation). Every
    ``eps`` is ``{flax path: [P/2, ...]}``; ES update 1 runs on the
    window's ``eps`` and ``fitness``."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}

    def tree(prefix: str) -> Dict[str, np.ndarray]:
        return {k[len(prefix) + 1:]: v for k, v in arrays.items()
                if k.startswith(prefix + "/params/")}

    def metrics(prefix: str) -> Dict[str, float]:
        return {k[len(prefix) + len("/metrics/"):]: float(v)
                for k, v in arrays.items()
                if k.startswith(prefix + "/metrics/")}

    dqn_updates = []
    for k in range(1, 4):
        prefix = f"dqn/update{k}"
        entry = {key: tree(f"{prefix}/{key}")
                 for key in ("mu", "nu", "grads")}
        entry["params"] = tree(prefix)
        entry.update({key: arrays[f"{prefix}/{key}"] for key in
                      ("idx", "weights", "td_abs", "priorities")})
        entry["metrics"] = metrics(prefix)
        dqn_updates.append(entry)
        source = int(arrays[f"{prefix}/target_from"])
        entry["target_params"] = (tree("dqn/init") if source == 0
                                  else dqn_updates[source - 1]["params"])
    es_window = {"eps": tree("es/window/eps"),
                 **{key: arrays[f"es/window/{key}"]
                    for key in ("noise", "actions", "fitness")}}
    es_updates = []
    for k in range(1, 4):
        prefix = f"es/update{k}"
        entry = {key: tree(f"{prefix}/{key}") for key in ("mu", "nu")}
        entry["params"] = tree(prefix)
        entry["eps"] = tree(f"{prefix}/eps") or es_window["eps"]
        entry["fitness"] = arrays[f"{prefix}/fitness"]
        entry["metrics"] = metrics(prefix)
        es_updates.append(entry)
    return {
        "dqn": {"arch": json.loads(str(arrays["dqn/arch"])),
                "cfg": DQNConfig(**json.loads(str(arrays["dqn/config"]))),
                "init": tree("dqn/init"),
                "act": {key: arrays[f"dqn/act/{key}"] for key in
                        ("env_steps", "eps", "u_explore", "u_pick",
                         "actions")},
                "updates": dqn_updates},
        "es": {"cfg": ESConfig(**json.loads(str(arrays["es/config"]))),
               "window": es_window, "updates": es_updates},
    }


def fixture_replay(cfg: DQNConfig, path: str = TRAIN_PATH
                   ) -> PrioritizedReplayBuffer:
    """A replay buffer (seed 0) holding the training fixture's trajectory
    as n-step transitions, in the reference loop's insertion order: per
    step t = 0..T-2, lane by lane, each lane's queue (``next_obs =
    obs[t + 1]``) folded without flush, as
    ``scripts/export_torch_dqn_es_fixture.py`` builds it."""
    traj = load_train_fixture(path)["traj"]
    obs, actions = traj["obs"], traj["actions"]
    t_len, lanes = actions.shape
    replay = PrioritizedReplayBuffer(
        cfg.buffer_capacity, cfg.prioritized_replay_alpha,
        cfg.prioritized_replay_beta, cfg.prioritized_replay_eps, seed=0)
    queues: List[List[dict]] = [[] for _ in range(lanes)]
    for t in range(t_len - 1):
        for b in range(lanes):
            queues[b].append({
                "obs": {k: v[t, b] for k, v in obs.items()},
                "action": int(actions[t, b]),
                "reward": float(traj["rewards"][t, b]),
                "done": bool(traj["dones"][t, b]),
                "next_obs": {k: v[t + 1, b] for k, v in obs.items()}})
            for tr in nstep_transitions(queues[b], cfg.n_step, cfg.gamma,
                                        flush=False):
                replay.add(tr)
    return replay
