"""Export the shipped policy's collect over subprocess envs on the
shared-memory transport, as the pipelined training loop runs it, for the
PyTorch port.

    python scripts/export_torch_pipeline_fixture.py [--out-dir DIR]

Writes ``ppo_pipeline_price_mixed.npz`` (default directory:
``ddls_tpu_torch/data``): ``N_ENVS`` ``env_load32_price_mixed`` envs,
seeded 0..N_ENVS-1, each in its own worker process of the JAX
``ParallelVectorEnv(backend="shm")``, stepped ``ROLLOUT_LENGTH`` times by
the JAX ``RolloutCollector`` on the deferred-fetch schedule (the pipelined
loop's) with the shipped policy from ``PRNGKey(COLLECT_SEED)``:
``obs/<key>`` [T, B, ...] at the env's pad, ``actions``, ``logp``,
``values``, ``rewards``, ``dones`` and ``last_values``. Its sampler draws
the uniforms of ``ppo_rollout_price_mixed.npz``, which therefore drive
the port's collect to the same actions.

Why a second trajectory: the simulator draws its workloads from the
process's global numpy stream. In-process envs share one stream (the
trajectory of ``ppo_train_price_mixed.npz``); subprocess envs each have
their own, so the two collects differ from the first arrival on.

Deterministic: rerunning it reproduces every array bit for bit
(``tests/test_torch_fixture.py`` checks the committed file that way).
"""
from __future__ import annotations

import argparse
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
import export_torch_train_fixture as train_export  # noqa: E402

OUT_NAME = "ppo_pipeline_price_mixed.npz"
N_ENVS = train_export.N_ENVS
ROLLOUT_LENGTH = train_export.ROLLOUT_LENGTH
COLLECT_SEED = train_export.COLLECT_SEED


def collect_subprocess(cfg, model, params) -> Dict[str, np.ndarray]:
    """One deferred-fetch ``RolloutCollector.collect`` over a shm
    ``ParallelVectorEnv``."""
    import jax

    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.rl import RolloutCollector
    from ddls_tpu.rl.rollout import ParallelVectorEnv

    learner = train_export.make_learner(model,
                                        train_export.ppo_config(cfg))
    vec = ParallelVectorEnv(RampJobPartitioningEnvironment,
                            cfg["env_config"], N_ENVS,
                            seeds=list(range(N_ENVS)), backend="shm")
    try:
        vec.reset()
        collector = RolloutCollector(vec, learner, ROLLOUT_LENGTH,
                                     deferred_fetch=True)
        collector._needs_reset = False
        out = collector.collect(params, jax.random.PRNGKey(COLLECT_SEED))
        traj = out["traj"]
        # the obs are views of a ring segment: copied before the envs close
        arrays = {f"obs/{k}": np.array(traj["obs"][k])
                  for k in train_export.TRAJ_OBS_KEYS}
        for key in ("actions", "logp", "values", "rewards", "dones"):
            arrays[key] = np.asarray(traj[key])
        arrays["last_values"] = np.asarray(out["last_values"])
    finally:
        vec.close()
    return arrays


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=serve_export.OUT_DIR)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    cfg, model, params, _ = serve_export.load_policy()
    arrays = collect_subprocess(cfg, model, params)
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(args.out_dir, OUT_NAME), **arrays)
    print(json.dumps({"out_dir": args.out_dir,
                      "episodes": int(arrays["dones"].sum())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
