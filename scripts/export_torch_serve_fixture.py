"""Export the shipped ``ppo_price_mixed`` policy and a pool of real serving
requests, with the JAX policy's answers, for the PyTorch port.

    python scripts/export_torch_serve_fixture.py [--out-dir DIR]

Writes two ``np.savez_compressed`` archives (default directory:
``ddls_tpu_torch/data``), which carry what the port needs on a machine
that has neither JAX nor orbax:

* ``ppo_price_mixed.npz`` — the restored parameter tree, flattened to
  ``/``-joined keys (``params/gnn/round_0/node_module/Dense_0/kernel``,
  ...), plus an ``arch`` entry: the JSON of the architecture the
  checkpoint was trained with (read from its training config) and the
  environment's pad bounds;
* ``serve_requests_price_mixed.npz`` — ``N_REQUESTS`` encoded observations
  from stepping ``env_load32_price_mixed`` with seeded random valid
  actions (the arrival population a deployed server sees), stacked per
  key, with the JAX policy's masked logits, values and greedy actions for
  each. Those are computed through the JAX serving stack: the actions
  come from ``PolicyServer`` at max_batch 8 on the default bucket ladder,
  the logits and values from the same bucketed batched forward.

The export is deterministic: rerunning it reproduces every array bit for
bit (tests/test_torch_fixture.py checks the committed files that way).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

CONFIG_PATH = os.path.join(REPO, "scripts", "ramp_job_partitioning_configs")
ENV_CONFIG = "env_load32_price_mixed"
CHECKPOINT = os.path.join(REPO, "checkpoints", "ppo_price_mixed")
OUT_DIR = os.path.join(REPO, "ddls_tpu_torch", "data")
N_REQUESTS = 64
MAX_BATCH = 8
OBS_KEYS = ("node_features", "edge_features", "graph_features", "edges_src",
            "edges_dst", "node_split", "edge_split", "action_set",
            "action_mask")


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten(value, f"{path}/"))
        else:
            out[path] = np.asarray(value)
    return out


def load_policy():
    """(config, model, params, graph_feature_dim) of the shipped
    checkpoint under the config it was trained with."""
    from ddls_tpu.config import load_config
    from ddls_tpu.serve import (build_model_from_config,
                                checkpoint_graph_feature_dim,
                                load_checkpoint_params)

    overrides = [f"env_config={ENV_CONFIG}"]
    cfg = load_config(CONFIG_PATH, "rllib_config", overrides)
    model, _n_actions, graph_dim = build_model_from_config(
        CONFIG_PATH, "rllib_config", overrides)
    params = load_checkpoint_params(CHECKPOINT)
    if checkpoint_graph_feature_dim(params) != graph_dim:
        raise ValueError("checkpoint and config disagree on the graph "
                         "feature width")
    return cfg, model, params, graph_dim


def export_params(cfg, model, params, graph_dim) -> Dict[str, np.ndarray]:
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
        "checkpoint": "checkpoints/ppo_price_mixed",
        "env_config": ENV_CONFIG,
        "pad_max_nodes": int(pad["max_nodes"]),
        "pad_max_edges": int(pad["max_edges"]),
    }
    out = {k: v.astype(np.float32)
           for k, v in flatten({"params": params["params"]}).items()}
    out["arch"] = np.array(json.dumps(arch, sort_keys=True))
    return out


def request_pool(cfg, n_requests: int) -> List[Dict[str, np.ndarray]]:
    """Step the env with random valid actions (np.random.RandomState(0))
    and keep each decision's observation, resetting with the pool size as
    the seed when an episode ends."""
    from ddls_tpu.envs import RampJobPartitioningEnvironment

    env = RampJobPartitioningEnvironment(**cfg["env_config"])
    obs = env.reset(seed=0)
    rng = np.random.RandomState(0)
    pool = []
    while len(pool) < n_requests:
        pool.append({k: np.copy(obs[k]) for k in OBS_KEYS})
        valid = np.flatnonzero(np.asarray(obs["action_mask"]))
        obs, _, done, _ = env.step(int(rng.choice(valid)))
        if done:
            obs = env.reset(seed=len(pool))
    return pool


def jax_answers(cfg, model, params, graph_dim, pool
                ) -> Dict[str, np.ndarray]:
    """The JAX serving stack's answers on ``pool`` at max_batch 8 on the
    default ladder of the env's pad bounds."""
    from ddls_tpu.serve import (BucketForward, ObsBucketer, PolicyServer,
                                default_buckets)

    pad = cfg["env_config"]["pad_obs_kwargs"]
    buckets = default_buckets(int(pad["max_nodes"]), int(pad["max_edges"]))
    server = PolicyServer(model, params, buckets=buckets,
                          max_batch=MAX_BATCH, max_queue=len(pool),
                          graph_feature_dim=graph_dim)
    ids = [server.submit(o, now=0.0) for o in pool]
    served = {r.request_id: r for r in server.drain(now=0.0)}
    if any(served[i].source != "policy" for i in ids):
        raise RuntimeError("the JAX server answered a fixture request "
                           "from its fallback")
    actions = np.array([served[i].action for i in ids], np.int64)

    bucketer = ObsBucketer(buckets)
    forward = BucketForward(model, params, max_batch=MAX_BATCH)
    by_bucket: Dict[int, List[int]] = {}
    padded = {}
    for i, obs in enumerate(pool):
        idx, padded[i] = bucketer.bucket_obs(obs)
        by_bucket.setdefault(idx, []).append(i)
    logits = np.zeros((len(pool), int(model.n_actions)), np.float32)
    values = np.zeros(len(pool), np.float32)
    for members in by_bucket.values():
        for start in range(0, len(members), MAX_BATCH):
            chunk = members[start:start + MAX_BATCH]
            lo, va = forward.forward([padded[i] for i in chunk])
            logits[chunk] = lo
            values[chunk] = va
    if not np.array_equal(np.argmax(logits, axis=1), actions):
        raise RuntimeError("served actions disagree with the argmax of the "
                           "batched forward's logits")
    return {"jax_logits": logits, "jax_values": values,
            "jax_actions": actions}


def export_requests(cfg, model, params, graph_dim,
                    n_requests: int = N_REQUESTS) -> Dict[str, np.ndarray]:
    pool = request_pool(cfg, n_requests)
    out = {k: np.stack([o[k] for o in pool]) for k in OBS_KEYS}
    out.update(jax_answers(cfg, model, params, graph_dim, pool))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=OUT_DIR)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    cfg, model, params, graph_dim = load_policy()
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(args.out_dir, "ppo_price_mixed.npz"),
                        **export_params(cfg, model, params, graph_dim))
    np.savez_compressed(
        os.path.join(args.out_dir, "serve_requests_price_mixed.npz"),
        **export_requests(cfg, model, params, graph_dim))
    print(json.dumps({"out_dir": args.out_dir, "n_requests": N_REQUESTS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
