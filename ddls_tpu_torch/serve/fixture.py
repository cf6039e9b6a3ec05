"""The shipped serving fixture: the exported ``ppo_price_mixed`` policy and
a pool of real requests with the JAX policy's answers to them.

Both files are made from the JAX package by
``scripts/export_torch_serve_fixture.py`` and travel with the port as
numpy archives, so a machine with neither JAX nor orbax can load the
shipped policy and check the port's answers against the reference's. So
do all six shipped checkpoints, each with the JAX policy's greedy
decisions on its own environment surface
(``scripts/export_torch_checkpoints_fixture.py``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
EXPORT_PATH = os.path.join(DATA_DIR, "ppo_price_mixed.npz")
REQUESTS_PATH = os.path.join(DATA_DIR, "serve_requests_price_mixed.npz")

# the encoded-observation keys of each request, stacked [n_requests, ...]
OBS_KEYS = ("node_features", "edge_features", "graph_features", "edges_src",
            "edges_dst", "node_split", "edge_split", "action_set",
            "action_mask")
# the reference's answers, recorded beside the requests
RECORDED_KEYS = ("jax_logits", "jax_values", "jax_actions")


def load_requests(path: str = REQUESTS_PATH
                  ) -> Tuple[List[Dict[str, np.ndarray]],
                             Dict[str, np.ndarray]]:
    """``(requests, recorded)``: one encoded obs dict per request and the
    JAX policy's ``jax_logits`` [n, A], ``jax_values`` [n] and
    ``jax_actions`` [n] for them."""
    with np.load(path, allow_pickle=False) as data:
        stacked = {k: data[k] for k in OBS_KEYS}
        recorded = {k: data[k] for k in RECORDED_KEYS}
    n = stacked["node_features"].shape[0]
    requests = [{k: np.ascontiguousarray(v[i]) for k, v in stacked.items()}
                for i in range(n)]
    return requests, recorded


# ------------------------------------------------ the six shipped checkpoints
# ``scripts/export_torch_checkpoints_fixture.py`` writes one archive each:
# the params and arch (as ``ppo_price_mixed.npz``), the JSON of the env
# config of the surface the checkpoint is evaluated on, a seed, and the JAX
# policy's greedy decisions over the first decisions from ``reset(seed)``
CHECKPOINT_NAMES = ("ppo_price_mixed", "ppo_price_ft8", "ppo_price_ft72",
                    "ppo_price_ft128", "ppo_jct_blocking",
                    "ppo_device_trained")
CHECKPOINT_RECORDED = ("jax_actions", "jax_logits", "jax_values", "rewards")


def checkpoint_path(name: str) -> str:
    return os.path.join(DATA_DIR, f"checkpoint_{name}.npz")


def load_checkpoint_fixture(name: str) -> Dict[str, object]:
    """``{"model", "params", "graph_feature_dim", "env_config", "seed",
    "recorded"}`` of shipped checkpoint ``name`` (the model on the CPU,
    holding the params; ``recorded``: the arrays of
    ``CHECKPOINT_RECORDED``)."""
    import json

    from ddls_tpu_torch.serve.server import load_export

    path = checkpoint_path(name)
    model, params, graph_dim = load_export(path)
    with np.load(path, allow_pickle=False) as data:
        env_config = json.loads(str(data["env_config"]))
        seed = int(data["seed"])
        recorded = {k: data[k] for k in CHECKPOINT_RECORDED}
    return {"model": model, "params": params, "graph_feature_dim": graph_dim,
            "env_config": env_config, "seed": seed, "recorded": recorded}


def greedy_episode(model, env, seed: int, max_decisions=None,
                   actor=None) -> Dict[str, np.ndarray]:
    """The policy's greedy episode on ``env`` from ``reset(seed)``, up to
    ``max_decisions`` decisions (None: to the end), one observation per
    forward on the model's device: ``actions``, ``logits`` (masked),
    ``values``, ``rewards``. With ``actor`` (an object with
    ``compute_action(obs)``), also ``actor_actions``: its answer to each
    of the same observations."""
    import torch

    from ddls_tpu_torch.models.policy import (batch_to_device,
                                              prepare_flat_batch)
    from ddls_tpu_torch.rl.rollout import stack_obs

    device = next(model.parameters()).device
    obs = env.reset(seed=seed)
    out = {"actions": [], "logits": [], "values": [], "rewards": [],
           "actor_actions": []}
    done = False
    while not done and (max_decisions is None
                        or len(out["actions"]) < max_decisions):
        with torch.no_grad():
            logits, values, actions = model.flat_batched(batch_to_device(
                prepare_flat_batch(stack_obs([obs])), device))
        action = int(actions[0])
        if actor is not None:
            out["actor_actions"].append(int(actor.compute_action(obs)))
        obs, reward, done, _ = env.step(action)
        out["actions"].append(action)
        out["logits"].append(logits[0].cpu().numpy())
        out["values"].append(float(values[0]))
        out["rewards"].append(reward)
    return {"actions": np.array(out["actions"], np.int64),
            "logits": np.stack(out["logits"]),
            "values": np.array(out["values"], np.float32),
            "rewards": np.array(out["rewards"], np.float64),
            "actor_actions": np.array(out["actor_actions"], np.int64)}
