"""Export the sampling noise of the shipped policy's recorded rollout and
a recorded greedy evaluation episode, for the PyTorch port.

    python scripts/export_torch_rollout_fixture.py [--out-dir DIR]

Writes ``ppo_rollout_price_mixed.npz`` (default directory:
``ddls_tpu_torch/data``), which holds the port's rollout path against the
JAX package on a machine that has neither JAX nor orbax:

* ``uniforms`` [T, B, A] float32: the uniforms that the JAX
  ``RolloutCollector.collect`` drew when ``export_torch_train_fixture.py``
  recorded its trajectory (``PRNGKey(COLLECT_SEED)``, ``pipeline=False``:
  each step splits ``rng, step_rng = split(rng)``, and
  ``jax.random.categorical`` draws ``uniform(step_rng, (B, A), float32,
  minval=finfo.tiny, maxval=1)`` for its Gumbel noise). The trajectory
  itself stays in ``ppo_train_price_mixed.npz``. Before writing, the
  script checks that ``argmax(masked logits - log(-log(u)))`` reproduces
  every recorded action;
* ``eval/record``: the JSON of the episode record of the JAX
  ``RLEvalLoop`` with the shipped checkpoint on ``env_load32_price_mixed``
  at a fixed interarrival time of ``EVAL_INTERARRIVAL`` from seed
  ``EVAL_SEED`` (as ``tests/test_shipped_checkpoint.py`` runs it), with
  ``eval/seed`` and ``eval/interarrival``.

Deterministic: rerunning it reproduces every array bit for bit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

import export_torch_serve_fixture as serve_export  # noqa: E402
import export_torch_train_fixture as train_export  # noqa: E402

OUT_NAME = "ppo_rollout_price_mixed.npz"
EVAL_SEED = 7005
EVAL_INTERARRIVAL = 80.0


def rollout_uniforms(n_actions: int) -> np.ndarray:
    """The [T, B, A] uniforms of the recorded collect's T sampling steps."""
    import jax
    import jax.numpy as jnp

    tiny = jnp.finfo(jnp.float32).tiny
    rng = jax.random.PRNGKey(train_export.COLLECT_SEED)
    out = []
    for _ in range(train_export.ROLLOUT_LENGTH):
        rng, step_rng = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(
            step_rng, (train_export.N_ENVS, n_actions), jnp.float32,
            minval=tiny, maxval=1.0)))
    return np.stack(out)


def check_actions(model, params, uniforms: np.ndarray) -> None:
    """Raise unless the uniforms reproduce every recorded action."""
    import jax
    import jax.numpy as jnp

    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu_torch.rl.fixture import load_train_fixture

    fx = load_train_fixture()
    apply = jax.jit(lambda o: batched_policy_apply(model, params, o)[0])
    for t in range(uniforms.shape[0]):
        obs = {k: jnp.asarray(v[t]) for k, v in fx["traj"]["obs"].items()}
        logits = apply(obs)
        actions = np.asarray(jnp.argmax(
            logits - jnp.log(-jnp.log(jnp.asarray(uniforms[t]))), axis=-1))
        if not np.array_equal(actions, fx["traj"]["actions"][t]):
            raise RuntimeError(f"step {t}: the recomputed uniforms give "
                               f"{actions}, the recorded actions are "
                               f"{fx['traj']['actions'][t]}")


def eval_record() -> dict:
    """The JAX greedy episode of the shipped checkpoint at a fixed
    interarrival time (``tests/test_shipped_checkpoint.py``'s run)."""
    from ddls_tpu.config import load_config
    from ddls_tpu.train import RLEvalLoop, make_epoch_loop
    from train_from_config import build_epoch_loop_kwargs

    cfg = load_config(serve_export.CONFIG_PATH, "rllib_config", [
        f"env_config={serve_export.ENV_CONFIG}",
        ("env_config.jobs_config.job_interarrival_time_dist._target_="
         "ddls_tpu.demands.distributions.Fixed"),
        f"env_config.jobs_config.job_interarrival_time_dist.val="
        f"{EVAL_INTERARRIVAL}"])
    kwargs = build_epoch_loop_kwargs(cfg)
    kwargs.update(num_envs=1, rollout_length=1, evaluation_interval=None)
    loop = make_epoch_loop("ppo", **kwargs)
    try:
        return RLEvalLoop(loop).run(checkpoint_path=serve_export.CHECKPOINT,
                                    seed=EVAL_SEED)["episode"]
    finally:
        loop.close()


def export_rollout(model, params) -> dict:
    uniforms = rollout_uniforms(int(model.n_actions))
    check_actions(model, params, uniforms)
    return {"uniforms": uniforms,
            "eval/record": np.array(json.dumps(eval_record(),
                                               sort_keys=True)),
            "eval/seed": np.array(EVAL_SEED, np.int64),
            "eval/interarrival": np.array(EVAL_INTERARRIVAL, np.float64)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out-dir", default=serve_export.OUT_DIR)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    _, model, params, _ = serve_export.load_policy()
    arrays = export_rollout(model, params)
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez_compressed(os.path.join(args.out_dir, OUT_NAME), **arrays)
    print(json.dumps({"out_dir": args.out_dir,
                      "eval": json.loads(str(arrays["eval/record"]))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
