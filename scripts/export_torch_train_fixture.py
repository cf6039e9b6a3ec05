"""Export a real PPO trajectory of the shipped ``ppo_price_mixed`` policy
and the JAX learner's update of it, for the PyTorch port.

    python scripts/export_torch_train_fixture.py [--out-dir DIR]

Writes ``ppo_train_price_mixed.npz`` (default directory:
``ddls_tpu_torch/data``), which carries what the port's learner is held
against on a machine that has neither JAX nor orbax:

* a real trajectory: ``N_ENVS`` ``env_load32_price_mixed`` envs stepped
  ``ROLLOUT_LENGTH`` times by the JAX ``RolloutCollector`` with the
  shipped policy (``obs/<key>`` [T, B, ...] at the env's pad, ``actions``,
  ``logp``, ``values``, ``rewards``, ``dones``, ``last_values``);
* ``ppo_config``: the JSON of the ``PPOConfig`` that
  ``scripts/ramp_job_partitioning_configs/algo/ppo.yaml`` translates to;
* ``advantages`` and ``value_targets``: the JAX GAE (normalised
  advantages, targets from the raw ones);
* per number of SGD iterations I in ``SGD_ITERS``: ``iter<I>/perms``
  [I, T*B], the per-epoch minibatch permutations that ``_train_step``
  draws on a 1-device mesh from ``UPDATE_SEED``; ``iter<I>/params/...``,
  the flattened params after one ``PPOLearner.train_step``;
  ``iter<I>/metrics/<key>`` and ``iter<I>/kl_coeff``;
* ``mb0/grads/...`` and ``mb0/metrics/<key>``: the gradient of the PPO
  loss, leaf for leaf, and its metrics, at the shipped params on the first
  minibatch of the 1-iteration update (rows ``iter1/perms[0][:minibatch]``
  of the B-major flattening, the initial ``kl_coeff``), the step before
  any optimiser arithmetic.

The batch is T*B = 512 samples, cut from the canonical 4000
(``train_batch_size``) so that the archive stays small. The export is
deterministic: rerunning it reproduces every array bit for bit
(tests/test_torch_fixture.py checks the committed file that way).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

import export_torch_serve_fixture as serve_export  # noqa: E402

OUT_NAME = "ppo_train_price_mixed.npz"
N_ENVS = 8
ROLLOUT_LENGTH = 64
COLLECT_SEED = 0
UPDATE_SEED = 1
SGD_ITERS = (1, 50)
TRAJ_OBS_KEYS = ("node_features", "edge_features", "graph_features",
                 "edges_src", "edges_dst", "node_split", "edge_split",
                 "action_mask")


def ppo_config(cfg):
    from ddls_tpu.train.loops import ppo_config_from_rllib

    return ppo_config_from_rllib(dict(cfg["algo"]["algo_config"]))


def make_learner(model, ppo_cfg):
    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu.parallel.mesh import make_mesh
    from ddls_tpu.rl import PPOLearner

    return PPOLearner(lambda p, o: batched_policy_apply(model, p, o),
                      ppo_cfg, make_mesh(1))


def collect(cfg, model, params, ppo_cfg) -> Dict[str, np.ndarray]:
    """One ``RolloutCollector.collect`` of ROLLOUT_LENGTH steps over
    N_ENVS envs seeded 0..N_ENVS-1."""
    import jax

    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.rl import RolloutCollector, VectorEnv

    env_cfg = cfg["env_config"]
    vec = VectorEnv([lambda: RampJobPartitioningEnvironment(**env_cfg)
                     for _ in range(N_ENVS)], seeds=list(range(N_ENVS)))
    collector = RolloutCollector(vec, make_learner(model, ppo_cfg),
                                 ROLLOUT_LENGTH, pipeline=False)
    out = collector.collect(params, jax.random.PRNGKey(COLLECT_SEED))
    traj = out["traj"]
    arrays = {f"obs/{k}": np.asarray(traj["obs"][k]) for k in TRAJ_OBS_KEYS}
    for key in ("actions", "logp", "values", "rewards", "dones"):
        arrays[key] = np.asarray(traj[key])
    arrays["last_values"] = np.asarray(out["last_values"])
    return arrays


def epoch_permutations(rng, num_sgd_iter: int, n: int) -> np.ndarray:
    """The permutations ``PPOLearner._train_step`` draws on a 1-device mesh
    (``ddls_tpu/rl/ppo.py``: one key per epoch from ``split(rng,
    num_sgd_iter)``, then ``split(erng, D)`` and a vmapped permutation)."""
    import jax

    perms = [jax.vmap(lambda k: jax.random.permutation(k, n))(
        jax.random.split(erng, 1))[0]
        for erng in jax.random.split(rng, num_sgd_iter)]
    return np.stack([np.asarray(p) for p in perms]).astype(np.int64)


def reference_gae(arrays, ppo_cfg):
    import jax
    import jax.numpy as jnp

    from ddls_tpu.rl.ppo import compute_gae

    @jax.jit
    def gae(rewards, values, dones, last_values):
        advs, targets = compute_gae(rewards, values, dones, last_values,
                                    ppo_cfg.gamma, ppo_cfg.gae_lambda)
        if ppo_cfg.normalize_advantages:
            advs = (advs - advs.mean()) / (advs.std() + 1e-8)
        return advs, targets

    advs, targets = gae(*(jnp.asarray(arrays[k]) for k in (
        "rewards", "values", "dones", "last_values")))
    return np.asarray(advs), np.asarray(targets)


def train(model, params, ppo_cfg, arrays, num_sgd_iter: int
          ) -> Dict[str, np.ndarray]:
    """One JAX ``train_step`` from the shipped params at ``num_sgd_iter``
    SGD iterations, on a 1-device mesh, with ``PRNGKey(UPDATE_SEED)``."""
    import jax

    cfg = dataclasses.replace(ppo_cfg, num_sgd_iter=num_sgd_iter)
    learner = make_learner(model, cfg)
    traj = {"obs": {k: arrays[f"obs/{k}"] for k in TRAJ_OBS_KEYS}}
    for key in ("actions", "logp", "values", "rewards", "dones"):
        traj[key] = arrays[key]
    straj, slv = learner.shard_traj(traj, arrays["last_values"])
    rng = jax.random.PRNGKey(UPDATE_SEED)
    state, metrics = learner.train_step(learner.init_state(params), straj,
                                        slv, rng)
    prefix = f"iter{num_sgd_iter}"
    out = {f"{prefix}/{k}": np.asarray(v, np.float32) for k, v in
           serve_export.flatten({"params": state.params["params"]}).items()}
    for key, value in metrics.items():
        out[f"{prefix}/metrics/{key}"] = np.asarray(value, np.float32)
    out[f"{prefix}/kl_coeff"] = np.asarray(state.kl_coeff, np.float32)
    out[f"{prefix}/perms"] = epoch_permutations(
        rng, num_sgd_iter, arrays["rewards"].size)
    return out


def first_minibatch_grads(model, params, ppo_cfg, arrays
                          ) -> Dict[str, np.ndarray]:
    """``jax.value_and_grad`` of the JAX ``ppo_loss`` at ``params`` on the
    first minibatch of the 1-iteration update."""
    import jax
    import jax.numpy as jnp

    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu.rl.ppo import ppo_loss

    rows = arrays["iter1/perms"][0][:ppo_cfg.sgd_minibatch_size]

    def pick(x):  # the reference's to_rows: row = b * T + t
        x = np.swapaxes(np.asarray(x), 0, 1)
        return x.reshape((-1,) + x.shape[2:])[rows]

    mb = {"obs": {k: pick(arrays[f"obs/{k}"]) for k in TRAJ_OBS_KEYS},
          "actions": pick(arrays["actions"]),
          "old_logp": pick(arrays["logp"]),
          "old_values": pick(arrays["values"]),
          "advantages": pick(arrays["advantages"]),
          "value_targets": pick(arrays["value_targets"])}

    @jax.jit
    def grad_fn(p, batch, kl_coeff):
        return jax.value_and_grad(ppo_loss, has_aux=True)(
            p, lambda q, o: batched_policy_apply(model, q, o), batch,
            kl_coeff, ppo_cfg)

    (_, metrics), grads = grad_fn(params, mb,
                                  jnp.asarray(ppo_cfg.kl_coeff, jnp.float32))
    out = {f"mb0/grads/{k}": np.asarray(v, np.float32) for k, v in
           serve_export.flatten({"params": grads["params"]}).items()}
    for key, value in metrics.items():
        out[f"mb0/metrics/{key}"] = np.asarray(value, np.float32)
    return out


def export_train(cfg, model, params, graph_dim) -> Dict[str, np.ndarray]:
    del graph_dim
    ppo_cfg = ppo_config(cfg)
    arrays = collect(cfg, model, params, ppo_cfg)
    arrays["ppo_config"] = np.array(json.dumps(dataclasses.asdict(ppo_cfg),
                                               sort_keys=True))
    arrays["advantages"], arrays["value_targets"] = reference_gae(
        arrays, ppo_cfg)
    for num_sgd_iter in SGD_ITERS:
        arrays.update(train(model, params, ppo_cfg, arrays, num_sgd_iter))
    arrays.update(first_minibatch_grads(model, params, ppo_cfg, arrays))
    return arrays


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=serve_export.OUT_DIR)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(args.out_dir, exist_ok=True)
    arrays = export_train(*serve_export.load_policy())
    np.savez_compressed(os.path.join(args.out_dir, OUT_NAME), **arrays)
    print(json.dumps({"out_dir": args.out_dir, "samples":
                      int(arrays["rewards"].size)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
