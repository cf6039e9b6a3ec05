"""Export all six shipped checkpoints, each with its environment surface
and the JAX policy's greedy decisions on it, for the PyTorch port.

    python scripts/export_torch_checkpoints_fixture.py [--out-dir DIR]
        [--only NAME ...]

Writes one ``np.savez_compressed`` archive per checkpoint,
``checkpoint_<name>.npz`` (default directory: ``ddls_tpu_torch/data``),
holding what the port needs on a machine that has neither JAX nor orbax:

* ``params/...``: the restored parameter tree, flattened to ``/``-joined
  keys, and ``arch``: the JSON of the architecture the checkpoint was
  trained with (its graph width: 51 with price features, 34 on the plain
  observation), the pad bounds and the checkpoint's name;
* ``env_config``: the JSON of the composed environment config of the
  surface that ``tests/test_shipped_checkpoint.py`` restores it on (the
  ``_target_`` paths as the configs name them; the port maps them);
* ``seed``, and over the first ``N_DECISIONS`` decisions of the greedy
  episode from ``reset(seed)`` on that surface: ``jax_actions`` [K],
  ``jax_logits`` [K, A] (masked, as the policy returns them),
  ``jax_values`` [K] and ``rewards`` [K]. Pricing stays on each surface's
  own ``auto`` (the C++ engine, float64), as the reference evaluates.

The greedy action is the argmax of the JAX ``batched_policy_apply`` over
the one-observation batch (the reference's ``_greedy_actions``).
Deterministic: rerunning it reproduces every array bit for bit
(``tests/test_torch_fixture.py`` checks the committed files that way).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import Dict, List, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

import export_torch_serve_fixture as serve_export  # noqa: E402

CONFIG_PATH = serve_export.CONFIG_PATH
OUT_DIR = serve_export.OUT_DIR
N_DECISIONS = 64
SEED = 7005

_FIXED_IA = ("env_config.jobs_config.job_interarrival_time_dist._target_="
             "ddls_tpu.demands.distributions.Fixed")


def _topology(cg: int, rk: int, sr: int, n: int) -> List[str]:
    kw = "env_config.topology_config.kwargs"
    return [f"{kw}.num_communication_groups={cg}",
            f"{kw}.num_racks_per_communication_group={rk}",
            f"{kw}.num_servers_per_rack={sr}",
            f"env_config.node_config.type_1.num_nodes={n}"]


# each checkpoint's surface, as tests/test_shipped_checkpoint.py restores it
SURFACES: Dict[str, List[str]] = {
    "ppo_price_mixed": ["env_config=env_load32_price_mixed", _FIXED_IA,
                        "env_config.jobs_config.job_interarrival_time_dist"
                        ".val=80.0"],
    "ppo_price_ft8": ["env_config=env_load32_price_mixed",
                      *_topology(2, 2, 2, 8)],
    "ppo_price_ft72": ["env_config=env_load32_price_mixed",
                       *_topology(6, 6, 2, 72)],
    "ppo_price_ft128": ["env_config=env_load32_price_mixed",
                        *_topology(8, 8, 2, 128)],
    "ppo_jct_blocking": [
        "env_config=env_load32_price_mixed", _FIXED_IA,
        "env_config.jobs_config.job_interarrival_time_dist.val=50.0",
        "env_config.reward_function=multi_objective_jct_blocking",
        "env_config.reward_function_kwargs.fail_reward=null",
        "env_config.reward_function_kwargs.success_reward=null"],
    "ppo_device_trained": [
        "env_config=env_load32", _FIXED_IA,
        "env_config.jobs_config.job_interarrival_time_dist.val=80.0"],
}
NAMES: Tuple[str, ...] = tuple(SURFACES)


def archive_name(name: str) -> str:
    return f"checkpoint_{name}.npz"


def load_policy(name: str):
    """(config, flax model, restored params, graph width) of checkpoint
    ``name`` under its surface's config."""
    from ddls_tpu.config import load_config
    from ddls_tpu.serve import (build_model_from_config,
                                checkpoint_graph_feature_dim,
                                load_checkpoint_params)

    overrides = SURFACES[name]
    cfg = load_config(CONFIG_PATH, "rllib_config", overrides)
    model, _n_actions, graph_dim = build_model_from_config(
        CONFIG_PATH, "rllib_config", overrides)
    params = load_checkpoint_params(os.path.join(REPO, "checkpoints", name))
    if checkpoint_graph_feature_dim(params) != graph_dim:
        raise ValueError(f"{name}: checkpoint and surface disagree on the "
                         "graph feature width")
    return cfg, model, params, graph_dim


def export_params(name: str, cfg, model, params, graph_dim
                  ) -> Dict[str, np.ndarray]:
    pad = cfg["env_config"]["pad_obs_kwargs"]
    arch = {
        "n_actions": int(model.n_actions),
        "graph_feature_dim": int(graph_dim),
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
        "checkpoint": f"checkpoints/{name}",
        "env_config": " ".join(SURFACES[name]),
        "pad_max_nodes": int(pad["max_nodes"]),
        "pad_max_edges": int(pad["max_edges"]),
    }
    out = {k: v.astype(np.float32) for k, v in serve_export.flatten(
        {"params": params["params"]}).items()}
    out["arch"] = np.array(json.dumps(arch, sort_keys=True))
    return out


def greedy_prefix(cfg, model, params, seed: int = SEED,
                  n_decisions: int = N_DECISIONS) -> Dict[str, np.ndarray]:
    """The JAX greedy episode's first ``n_decisions`` decisions (fewer if
    it ends) on the JAX env of ``cfg["env_config"]``."""
    import jax

    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu.rl.rollout import stack_obs

    apply = jax.jit(lambda o: batched_policy_apply(model, params, o))
    env = RampJobPartitioningEnvironment(**copy.deepcopy(cfg["env_config"]))
    obs = env.reset(seed=seed)
    actions, logits, values, rewards = [], [], [], []
    for _ in range(n_decisions):
        lo, va = (np.asarray(x)[0] for x in apply(stack_obs([obs])))
        action = int(np.argmax(lo))
        obs, reward, done, _ = env.step(action)
        actions.append(action)
        logits.append(lo)
        values.append(va)
        rewards.append(reward)
        if done:
            break
    return {"jax_actions": np.array(actions, np.int64),
            "jax_logits": np.stack(logits).astype(np.float32),
            "jax_values": np.array(values, np.float32),
            "rewards": np.array(rewards, np.float64)}


def export_checkpoint(name: str) -> Dict[str, np.ndarray]:
    cfg, model, params, graph_dim = load_policy(name)
    out = export_params(name, cfg, model, params, graph_dim)
    out["env_config"] = np.array(json.dumps(cfg["env_config"],
                                            sort_keys=True))
    out["seed"] = np.array(SEED, np.int64)
    out.update(greedy_prefix(cfg, model, params))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=OUT_DIR)
    parser.add_argument("--only", nargs="*", choices=NAMES, default=None)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(args.out_dir, exist_ok=True)
    written = {}
    for name in args.only or NAMES:
        arrays = export_checkpoint(name)
        np.savez_compressed(os.path.join(args.out_dir, archive_name(name)),
                            **arrays)
        written[name] = int(arrays["jax_actions"].shape[0])
    print(json.dumps({"out_dir": args.out_dir, "decisions": written}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
