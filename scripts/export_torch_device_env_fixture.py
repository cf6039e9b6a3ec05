"""Export the JAX device episode replay's recordings, for holding the
port's device env (``ddls_tpu_torch/sim/device_env.py``) on a machine that
has no JAX.

    python scripts/export_torch_device_env_fixture.py [--out-dir DIR]

Writes ``device_env_replay.npz`` (default directory:
``ddls_tpu_torch/data``; read by
``ddls_tpu_torch/sim/fixture.load_device_env_fixture``):

* on the shipped surface ``env_load32_price_mixed``
  (``export_torch_checkpoints_fixture.SURFACES["ppo_price_mixed"]``, reset
  from seed 0): ``bench.py``'s job-bank recipe (420 jobs arriving every
  50, models and SLA fractions drawn from ``RandomState(seed)``, 20
  training steps) for seeds 0-7 (``banks/*`` [8, J]), one action
  sequence of 400 degrees drawn from {0, 1, 2, 4, 8, 16}
  (``RandomState(0)``) and the JAX replay ``make_episode_fn(et,
  memo_cfg=None)`` of each bank in float32 (``f32/trace/*`` [8, 400],
  ``f32/counters/*`` [8]) and of bank 0 under x64 (``x64/...``);
* on the small surface of ``tests/test_jax_episode.py`` (profiles from
  seed 5, reset from seed 17): the host episode of the reference's
  mixed-action policy (``small/bank/*``, ``small/actions``, the host's
  decisions and stats ``small/host/*``) and the JAX x64 replay of it
  (``small/x64/...``).

``export_fixture(prefix=D)`` replays only the first ``D`` decisions of the
shipped banks and leaves their counters out: the replay is causal, so the
traces are the full archive's first ``D`` columns
(``tests/test_torch_fixture.py`` regenerates that way). Deterministic:
rerunning it reproduces every array bit for bit.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO, os.path.join(REPO, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

import numpy as np  # noqa: E402

import export_torch_checkpoints_fixture as ckpt_export  # noqa: E402
from ddls_tpu_torch.sim.fixture import (COUNTER_NAMES,  # noqa: E402
                                        DEVICE_ENV_PATH, TRACE_NAMES,
                                        mixed_action_episode,
                                        small_surface_kwargs)

SEEDS = tuple(range(8))
N_JOBS = 420
N_DECISIONS = 400
DEGREES = (0, 1, 2, 4, 8, 16)


def shipped_env():
    """The JAX package's env on the shipped surface, reset from seed 0."""
    from ddls_tpu.config import load_config
    from ddls_tpu.envs import RampJobPartitioningEnvironment

    cfg = load_config(ckpt_export.CONFIG_PATH, "rllib_config",
                      ckpt_export.SURFACES["ppo_price_mixed"])["env_config"]
    env = RampJobPartitioningEnvironment(**copy.deepcopy(dict(cfg)))
    env.reset(seed=0)
    return env


def bank_records(types, seed: int):
    """``bench.py``'s job bank (``run_jaxenv_bench``'s ``mk_bank``)."""
    r = np.random.RandomState(seed)
    return [{"model": types[int(r.randint(0, len(types)))],
             "num_training_steps": 20,
             "sla_frac": round(float(r.uniform(0.1, 1.0)), 2),
             "time_arrived": 50.0 * i} for i in range(N_JOBS)]


def shipped_actions(max_degree: int) -> np.ndarray:
    degrees = [d for d in DEGREES if d <= max_degree]
    return np.random.RandomState(0).choice(
        degrees, size=N_DECISIONS).astype(np.int32)


def _replay(out: Dict[str, np.ndarray], prefix: str, fn, banks, actions,
            counters: bool) -> None:
    import jax.numpy as jnp

    traces = {name: [] for name in TRACE_NAMES}
    finals = {name: [] for name in COUNTER_NAMES}
    for bank in banks:
        res = fn({k: jnp.asarray(v) for k, v in bank.items()},
                 jnp.asarray(actions))
        for name, x in zip(TRACE_NAMES, res["trace"]):
            traces[name].append(np.asarray(x))
        for name in COUNTER_NAMES:
            finals[name].append(np.asarray(res[name]))
    for name in TRACE_NAMES:
        out[f"{prefix}/trace/{name}"] = np.stack(traces[name])
    if counters:
        for name in COUNTER_NAMES:
            out[f"{prefix}/counters/{name}"] = np.stack(finals[name])


def export_fixture(prefix: Optional[int] = None) -> Dict[str, np.ndarray]:
    import jax
    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.graphs.synthetic import generate_pipedream_txt_files
    from ddls_tpu.sim import jax_env

    env = shipped_env()
    et = jax_env.build_episode_tables(env)
    records = [bank_records(et.types, s) for s in SEEDS]
    banks = [jax_env.build_job_bank(et, r) for r in records]
    actions = shipped_actions(int(env.max_partitions_per_op))
    n_dec = N_DECISIONS if prefix is None else prefix
    out: Dict[str, np.ndarray] = {
        "types": np.array(json.dumps(et.types)), "actions": actions}
    for name in banks[0]:
        out[f"banks/{name}"] = np.stack([b[name] for b in banks])
    full = prefix is None
    _replay(out, "f32", jax_env.make_episode_fn(et, memo_cfg=None), banks,
            actions[:n_dec], full)
    with jax.enable_x64(True):
        et64 = jax_env.build_episode_tables(env)
        _replay(out, "x64", jax_env.make_episode_fn(et64, memo_cfg=None),
                banks[:1], actions[:n_dec], full)

        with tempfile.TemporaryDirectory(prefix="device_env_") as d:
            generate_pipedream_txt_files(d, n_cnn=2, n_translation=1,
                                         seed=5)
            small = RampJobPartitioningEnvironment(**small_surface_kwargs(d))
            arrivals, decisions, stats = mixed_action_episode(small)
            set64 = jax_env.build_episode_tables(small)
        bank = jax_env.build_job_bank(set64, arrivals)
        small_actions = np.array([dec[0] for dec in decisions], np.int32)
        out["small/types"] = np.array(json.dumps(set64.types))
        for name, value in bank.items():
            out[f"small/bank/{name}"] = value
        out["small/actions"] = small_actions
        host = np.array([dec[1:] for dec in decisions], np.float64)
        for i, name in enumerate(("reward", "accept", "cause", "t", "jct")):
            out[f"small/host/{name}"] = host[:, i]
        for name, value in stats.items():
            out[f"small/host/{name}"] = np.array(value, np.int64)
        _replay(out, "small/x64",
                jax_env.make_episode_fn(set64, memo_cfg=None), [bank],
                small_actions, True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.dirname(DEVICE_ENV_PATH))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, os.path.basename(DEVICE_ENV_PATH))
    out = export_fixture()
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
