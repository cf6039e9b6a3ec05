"""Export the JAX IMPALA and PG learners' updates of the recorded PPO
trajectory, for the PyTorch port.

    python scripts/export_torch_ac_fixture.py [--out-dir DIR]

Reads the real trajectory of the shipped ``ppo_price_mixed`` policy that
``ddls_tpu_torch/data/ppo_train_price_mixed.npz`` carries (8
``env_load32_price_mixed`` envs x 64 steps, collected by the JAX
``RolloutCollector``; ``scripts/export_torch_train_fixture.py``) and the
shipped params, and applies ``STEPS`` successive ``_train_step``s of the
JAX ``ImpalaLearner`` and, from the shipped params again, of the JAX
``PGLearner`` to it, on a 1-device mesh, under the shipped
``algo/impala.yaml`` and ``algo/pg.yaml`` configs. Writes
``ac_train_price_mixed.npz`` (default directory: ``ddls_tpu_torch/data``)
with, for ``<algo>`` in ``impala`` and ``pg``:

* ``<algo>/config``: the JSON of the translated config;
* ``<algo>/step<k>/params/...``: the flattened params after update k;
* ``<algo>/step<k>/metrics/<key>``: update k's metrics;
* ``impala/step<k>/{target_logp,vs,pg_adv}`` [T, B]: the V-trace inputs
  and outputs of update k (at the params before it), from the reference's
  own ``vtrace`` on the reference's forward;
* ``pg/returns`` [T, B]: ``reward_to_go`` of the trajectory (the same at
  every update).

Several updates, because at the first the params are the behaviour
policy's: every importance weight is 1 to within float32 rounding, and
the clip (``rho > 1``) is a coin flip between two correct forwards; from
the second on the clip engages. Deterministic: rerunning it reproduces
every array bit for bit (tests/test_torch_fixture.py checks that).
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
import export_torch_train_config as config_export  # noqa: E402
import export_torch_train_fixture as train_export  # noqa: E402

OUT_NAME = "ac_train_price_mixed.npz"
STEPS = 3


def recorded_traj():
    """(traj with [T, B, ...] obs, last_values) of the PPO train fixture."""
    path = os.path.join(serve_export.OUT_DIR, train_export.OUT_NAME)
    with np.load(path, allow_pickle=False) as data:
        traj = {"obs": {k: data[f"obs/{k}"]
                        for k in train_export.TRAJ_OBS_KEYS}}
        for key in ("actions", "logp", "values", "rewards", "dones"):
            traj[key] = data[key]
        return traj, data["last_values"]


def algo_config(algo: str):
    from ddls_tpu.train.loops import (impala_config_from_rllib,
                                      pg_config_from_rllib)

    algo_cfg = dict(config_export.composed_config(algo)["algo"]
                    ["algo_config"])
    return (impala_config_from_rllib if algo == "impala"
            else pg_config_from_rllib)(algo_cfg)


def _flat_params(prefix: str, params) -> Dict[str, np.ndarray]:
    return {f"{prefix}/{k}": np.asarray(v, np.float32) for k, v in
            serve_export.flatten({"params": params["params"]}).items()}


def impala_vtrace_fn(model, cfg):
    """The first part of ``ImpalaLearner._loss``: the forward of every
    sample, the actions' log-probabilities and ``vtrace`` -> (target_logp,
    vs, pg_adv), each [T, B]."""
    import jax
    import jax.numpy as jnp

    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu.rl.impala import vtrace

    @jax.jit
    def fn(params, traj, last_values):
        t_len, lanes = traj["rewards"].shape
        flat = jax.tree_util.tree_map(
            lambda x: x.reshape((t_len * lanes,) + x.shape[2:]), traj["obs"])
        logits, values = batched_policy_apply(model, params, flat)
        logp_all = jax.nn.log_softmax(logits.reshape(t_len, lanes, -1), -1)
        target_logp = jnp.take_along_axis(
            logp_all, traj["actions"][..., None].astype(jnp.int32),
            axis=-1)[..., 0]
        vs, pg_adv = vtrace(traj["logp"], target_logp, traj["rewards"],
                            values.reshape(t_len, lanes), traj["dones"],
                            last_values, cfg.gamma,
                            cfg.vtrace_clip_rho_threshold,
                            cfg.vtrace_clip_pg_rho_threshold)
        return target_logp, vs, pg_adv
    return fn


def run_updates(algo: str, model, params, traj, last_values
                ) -> Dict[str, np.ndarray]:
    """``STEPS`` successive JAX updates of ``algo`` from ``params``."""
    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu.parallel.mesh import make_mesh
    from ddls_tpu.rl.impala import ImpalaLearner
    from ddls_tpu.rl.pg import PGLearner, reward_to_go

    cfg = algo_config(algo)
    cls = ImpalaLearner if algo == "impala" else PGLearner
    learner = cls(lambda p, o: batched_policy_apply(model, p, o), cfg,
                  make_mesh(1))
    out = {f"{algo}/config": np.array(json.dumps(dataclasses.asdict(cfg),
                                                 sort_keys=True))}
    if algo == "pg":
        out["pg/returns"] = np.asarray(reward_to_go(
            traj["rewards"], traj["dones"], cfg.gamma), np.float32)
    else:
        scan = impala_vtrace_fn(model, cfg)
    state = learner.init_state(params)
    for step in range(1, STEPS + 1):
        prefix = f"{algo}/step{step}"
        if algo == "impala":
            for key, value in zip(("target_logp", "vs", "pg_adv"),
                                  scan(state.params, traj, last_values)):
                out[f"{prefix}/{key}"] = np.asarray(value, np.float32)
        straj, slv = learner.shard_traj(traj, last_values)
        state, metrics = learner.train_step(state, straj, slv)
        out.update(_flat_params(prefix, state.params))
        for key, value in metrics.items():
            out[f"{prefix}/metrics/{key}"] = np.asarray(value, np.float32)
    return out


def export_ac(cfg, model, params, graph_dim) -> Dict[str, np.ndarray]:
    del cfg, graph_dim
    traj, last_values = recorded_traj()
    arrays = {}
    for algo in ("impala", "pg"):
        arrays.update(run_updates(algo, model, params, traj, last_values))
    return arrays


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=serve_export.OUT_DIR)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(args.out_dir, exist_ok=True)
    arrays = export_ac(*serve_export.load_policy())
    np.savez_compressed(os.path.join(args.out_dir, OUT_NAME), **arrays)
    print(json.dumps({"out_dir": args.out_dir, "steps": STEPS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
