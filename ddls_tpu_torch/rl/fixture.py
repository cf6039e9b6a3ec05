"""The shipped training fixtures: a real trajectory of the shipped
``ppo_price_mixed`` policy and the JAX learner's update of it
(``scripts/export_torch_train_fixture.py``); the JAX IMPALA and PG
learners' updates of the same trajectory
(``scripts/export_torch_ac_fixture.py``); the uniforms the JAX sampler
drew for that trajectory and a recorded greedy evaluation episode
(``scripts/export_torch_rollout_fixture.py``); and the composed training
configs of the PPO, IMPALA and PG runs as JSON
(``scripts/export_torch_train_config.py``).

They travel with the port as numpy archives and JSON, so a machine with
neither JAX, orbax nor PyYAML can hold the port's rollout, update and
evaluation against the reference's.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

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


def load_train_config(path: str = TRAIN_CONFIG_PATH) -> Dict[str, Any]:
    """A composed training config (a fresh dict each call); by default
    the PPO run's."""
    with open(path) as fh:
        return json.load(fh)
