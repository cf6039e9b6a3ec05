"""Export the JAX device collection's recordings and the composed config of
``ppo_device_trained``'s training run, for the PyTorch port's device
collector (``ddls_tpu_torch/rl/ppo_device.py``).

    python scripts/export_torch_device_collect_fixture.py [--out-dir DIR]
        [--config-only]

Writes (default directory: ``ddls_tpu_torch/data``):

* ``device_collect_recorded.npz`` (read by
  ``ddls_tpu_torch/sim/fixture.load_device_collect_fixture``):
  - ``small/``: the reference memo test's surface
    (``fixture.memo_surface_kwargs``, reset from seed 0) and its tiny
    policy (flax initialisation from ``PRNGKey(0)``, ``small/params/``),
    2 lanes of ``fixture.memo_lane_records`` banks;
  - ``full/``: ``env_load32`` as the training config composes it (reset
    from seed 0) with ``ppo_device_trained``'s params, 2 lanes of
    ``rl/fused.py:stacked_job_banks(seed_base=0)`` sized by
    ``horizon_bank_jobs(env, 31)``;
  each 3 collects of the reference ``DevicePPOCollector`` (``memo_cfg=
  None``: the reference's memo pins are red, ROADMAP C0) of 24 (small) or
  128 (full) steps, from ``PRNGKey(7919)`` split once a collect, and on
  the full-width surface a fourth (``full/reset/``), steps 384-511, in
  which both lanes end their first 400-decision episode and reset: per
  collect the uniforms K9 needs to take its samples ([B, T, A]: per lane
  the segment's key splits, ``uniform(key, (A,), minval=tiny, maxval=1)``
  as ``jax.random.categorical`` draws its Gumbel noise; the script first
  checks that the argmax of the rebuilt observation's logits plus that
  noise gives every recorded action), the segment's trace and next
  fields, the rebuilt observations' graph features and masks, the
  bootstrap values and the episode records;
  - ``memo/float32``, ``memo/float64``: ``jax_memo.memo_lookahead``
    jitted and driven alone on a sequence of 48 keys drawn from 10 keys of
    the small surface's tables (one set of two ways per key's set among 4
    sets; equal groupings of other placements, a -0.0 twin), each call's
    compute returning its own value: the hit, the set, the served value
    and the counters after each call;
* ``train_config_ppo_device_load32.json``: the composed config of
  ``env_config=env_load32 algo=ppo epoch_loop=epoch_loop_default
  algo.algo_config.device_collector=true epoch_loop.num_envs=2
  epoch_loop.rollout_length=128`` (``checkpoints/README.md``), what
  ``python -m ddls_tpu_torch.train --config`` reads.

``export_fixture(prefix=D)`` records only the first collect of the
full-width surface, over D steps: the segment's step keys are a prefix of
the longer segment's, so its per-step arrays are the archive's first D
steps (``tests/test_torch_fixture.py`` regenerates that way; the small
surface and the memo in full). Deterministic.
"""
from __future__ import annotations

import argparse
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
import export_torch_train_config as config_export  # noqa: E402
from ddls_tpu_torch.sim.fixture import (DEVICE_COLLECT_PATH,  # noqa: E402
                                        memo_lane_records,
                                        memo_surface_kwargs)

LANES = 2
COLLECTS = 3
STEPS = {"small": 24, "full": 128}
COLLECT_SEED = 7919
CONFIG_NAME = "train_config_ppo_device_load32.json"
CONFIG_OVERRIDES = ["env_config=env_load32", "algo=ppo",
                    "epoch_loop=epoch_loop_default",
                    "algo.algo_config.device_collector=true",
                    "epoch_loop.num_envs=2", "epoch_loop.rollout_length=128"]
MEMO_KEYS, MEMO_CALLS = 10, 48


def composed_config() -> dict:
    from ddls_tpu.config import load_config
    from ddls_tpu.train.compat import apply_reference_compat

    return apply_reference_compat(load_config(
        config_export.CONFIG_PATH, "rllib_config", CONFIG_OVERRIDES))


def _small_surface(d: str):
    import jax
    import jax.numpy as jnp

    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.graphs.synthetic import generate_pipedream_txt_files
    from ddls_tpu.models.policy import GNNPolicy
    from ddls_tpu.sim import jax_env

    generate_pipedream_txt_files(d, n_cnn=1, n_translation=1, seed=9,
                                 min_ops=4, max_ops=6)
    env = RampJobPartitioningEnvironment(**memo_surface_kwargs(d))
    obs0 = env.reset(seed=0)
    et = jax_env.build_episode_tables(env)
    model = GNNPolicy(n_actions=5, out_features_msg=4,
                      out_features_hidden=8, out_features_node=4,
                      out_features_graph=4, fcnet_hiddens=(16,))
    # jitted: the same bits as the eager initialisation, in a seventh of
    # the time
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jax.tree_util.tree_map(jnp.asarray, obs0))
    banks = [jax_env.build_job_bank(et, memo_lane_records(et.types, lane))
             for lane in range(LANES)]
    banks = {k: np.stack([b[k] for b in banks]) for k in banks[0]}
    return env, et, model, params, banks


def _full_surface():
    import copy

    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.rl.fused import horizon_bank_jobs, stacked_job_banks
    from ddls_tpu.sim import jax_env

    cfg = composed_config()
    env = RampJobPartitioningEnvironment(**copy.deepcopy(cfg["env_config"]))
    env.reset(seed=0)
    et = jax_env.build_episode_tables(env)
    _, model, params, _ = ckpt_export.load_policy("ppo_device_trained")
    banks = stacked_job_banks(et, env, LANES, horizon_bank_jobs(env, 31),
                              seed_base=0)
    return env, et, model, params, {k: np.asarray(v)
                                    for k, v in banks.items()}


def lane_uniforms(sub, lanes: int, steps: int, n_actions: int):
    """The [B, T, A] uniforms the collect with key ``sub`` draws."""
    import jax
    import jax.numpy as jnp

    tiny = jnp.finfo(jnp.float32).tiny
    out = []
    for lane_rng in jax.random.split(sub, lanes):
        keys = jax.random.split(lane_rng, steps)
        out.append(np.stack([np.asarray(jax.random.uniform(
            k, (n_actions,), jnp.float32, minval=tiny, maxval=1.0))
            for k in keys]))
    return np.stack(out)


def record_collects(env, et, model, params, banks, steps: int,
                    n_collects: int) -> Dict[str, np.ndarray]:
    """``n_collects`` collects of the reference ``DevicePPOCollector``
    (memo off), its segment's outputs captured, each collect's actions
    checked against the recorded uniforms."""
    import jax
    import jax.numpy as jnp

    from ddls_tpu.models.policy import batched_policy_apply
    from ddls_tpu.rl.ppo_device import DevicePPOCollector
    from ddls_tpu.sim import jax_env

    ot = jax_env.build_obs_tables(env, et)
    col = DevicePPOCollector(et, ot, model,
                             {k: jnp.asarray(v) for k, v in banks.items()},
                             steps, memo_cfg=None)
    captured = []
    vseg = col._vseg

    def spy(*args):
        out = vseg(*args)
        captured.append(out)
        return out

    col._vseg = spy
    apply = jax.jit(lambda o: batched_policy_apply(model, params, o)[0])
    n_actions = int(model.n_actions)
    rng = jax.random.PRNGKey(COLLECT_SEED)
    out: Dict[str, np.ndarray] = {}
    for c in range(n_collects):
        rng, sub = jax.random.split(rng)
        res = col.collect(params, sub)
        _, trace, next_fields = captured[-1]
        u = lane_uniforms(sub, LANES, steps, n_actions)
        obs = res["traj"]["obs"]
        for t in range(steps):
            logits = np.asarray(apply({k: jnp.asarray(v[t])
                                       for k, v in obs.items()}))
            picked = np.argmax(logits - np.log(-np.log(u[:, t])), axis=-1)
            if not np.array_equal(picked, res["traj"]["actions"][t]):
                raise RuntimeError(f"collect {c} step {t}: the uniforms give "
                                   f"{picked}, the collect took "
                                   f"{res['traj']['actions'][t]}")
        p = f"c{c}/"
        out[p + "uniforms"] = u
        for k, v in trace.items():
            out[f"{p}trace/{k}"] = np.asarray(v)
        for k, v in next_fields.items():
            out[f"{p}next/{k}"] = np.asarray(v)
        out[p + "graph_features"] = np.asarray(obs["graph_features"])
        out[p + "action_mask"] = np.asarray(obs["action_mask"])
        out[p + "last_values"] = np.asarray(res["last_values"])
        out[p + "episodes"] = np.array(json.dumps(res["episodes"],
                                                  sort_keys=True))
    return out


def memo_keys(et, dtype, seed: int = 0):
    """``MEMO_KEYS`` keys of the small surface's tables (cfg, ots, times)
    and the call sequence over them: key 1 places key 0's ops on other
    servers in the same grouping (a hit), key 3 is key 2 with -0.0 where
    key 2 has 0.0 (a miss)."""
    r = np.random.RandomState(seed)
    tb = et.tables
    n_cfg, n = tb["op_valid"].shape
    m = tb["dep_valid"].shape[1]
    cfg = r.randint(0, n_cfg, MEMO_KEYS).astype(np.int32)
    ots = np.full((MEMO_KEYS, n), -1, np.int32)
    times = np.zeros((MEMO_KEYS, m), dtype)
    for k in range(MEMO_KEYS):
        valid = tb["op_valid"][cfg[k]]
        ots[k, valid] = r.randint(-1, et.n_srv, int(valid.sum()))
        dv = tb["dep_valid"][cfg[k]]
        times[k, dv] = np.where(r.rand(int(dv.sum())) < 0.3, 0.0,
                                r.rand(int(dv.sum())) * 1e-3).astype(dtype)
    cfg[1], times[1] = cfg[0], times[0]
    perm = r.permutation(et.n_srv).astype(np.int32)
    ots[1] = np.where(ots[0] >= 0, perm[np.maximum(ots[0], 0)], ots[0])
    cfg[3], ots[3] = cfg[2], ots[2]
    times[3] = np.where(times[2] == 0, -0.0, times[2]).astype(dtype)
    seq = r.randint(0, MEMO_KEYS, MEMO_CALLS).astype(np.int32)
    return cfg, ots, times, seq


def record_memo(et, dtype) -> Dict[str, np.ndarray]:
    """The reference memo's decisions on ``memo_keys``: per call the hit,
    the set, the value served and the counters after it."""
    import jax
    import jax.numpy as jnp

    from ddls_tpu.sim import jax_memo

    cfg_tab = jax_memo.MemoConfig(n_sets=4, n_ways=2)
    cfg, ots, times, seq = memo_keys(et, dtype)
    valid_tab = jnp.asarray(et.tables["op_valid"])
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32

    class _Et:
        pads = et.pads
        tables = {"dep_size": np.zeros(1, dtype)}

    def call(memo, c, o, t, value, ok):
        valid = valid_tab[c]
        groups = jax_memo.canonical_groups(jnp.where(valid, o, -1), valid)
        tbits = jax_memo._bits(t).reshape(-1)
        payload = jnp.concatenate([c.astype(jnp.uint32).reshape(1),
                                   groups.astype(jnp.uint32), tbits])
        weights = jnp.asarray(jax_memo._hash_weights(payload.shape[0]))
        set_idx = jnp.sum(payload * weights, dtype=jnp.uint32) % jnp.uint32(
            cfg_tab.n_sets)
        (t_out, ok_out), memo = jax_memo.memo_lookahead(
            memo, c, groups, t, lambda hit: (value, ok))
        return memo, (t_out, ok_out, set_idx.astype(jnp.int32))

    fn = jax.jit(call)
    memo = jax_memo.memo_init(_Et, cfg_tab)
    rec = {"t": [], "ok": [], "set": [], "hits": [], "misses": [],
           "evicts": []}
    for i, k in enumerate(seq):
        memo, (t_out, ok_out, set_idx) = fn(
            memo, jnp.int32(cfg[k]), jnp.asarray(ots[k]),
            jnp.asarray(times[k], jdt), jnp.asarray(i + 0.5, jdt),
            jnp.bool_(i % 3 != 0))
        rec["t"].append(np.asarray(t_out))
        rec["ok"].append(np.asarray(ok_out))
        rec["set"].append(np.asarray(set_idx))
        for key in ("hits", "misses", "evicts"):
            rec[key].append(np.asarray(memo[key]))
    out = {"cfg": cfg, "ots": ots, "times": times, "sequence": seq,
           "n_sets": np.array(cfg_tab.n_sets, np.int64),
           "n_ways": np.array(cfg_tab.n_ways, np.int64)}
    out.update({k: np.stack(v) for k, v in rec.items()})
    return out


def export_fixture(prefix: Optional[int] = None) -> Dict[str, np.ndarray]:
    import jax

    from ddls_tpu_torch.models.convert import flatten_tree

    out: Dict[str, np.ndarray] = {}
    with tempfile.TemporaryDirectory(prefix="device_collect_") as d:
        surfaces = {"small": _small_surface(d), "full": _full_surface()}
        for name, (env, et, model, params, banks) in surfaces.items():
            short = prefix is not None and name == "full"
            steps = prefix if short else STEPS[name]
            n = 1 if short else COLLECTS
            out[f"{name}/types"] = np.array(json.dumps(et.types))
            out[f"{name}/n_collects"] = np.array(n, np.int64)
            for k, v in banks.items():
                out[f"{name}/banks/{k}"] = v
            if name == "small":
                for k, v in flatten_tree({"params": params["params"]}
                                         ).items():
                    out[f"{name}/params/{k}"] = np.asarray(v, np.float32)
            extra = int(name == "full" and not short)
            for k, v in record_collects(env, et, model, params, banks, steps,
                                        n + extra).items():
                if k.startswith(f"c{n}/"):
                    k = "reset/" + k[len(f"c{n}/"):]
                out[f"{name}/{k}"] = v
        et_small = surfaces["small"][1]
        out.update({f"memo/float32/{k}": v for k, v in
                    record_memo(et_small, np.float32).items()})
        with jax.enable_x64(True):
            out.update({f"memo/float64/{k}": v for k, v in
                        record_memo(et_small, np.float64).items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.dirname(DEVICE_COLLECT_PATH))
    ap.add_argument("--config-only", action="store_true")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, CONFIG_NAME)
    with open(path, "w") as fh:
        fh.write(config_export.config_text(composed_config()))
    print(json.dumps({"out": path}))
    if args.config_only:
        return 0
    path = os.path.join(args.out_dir, os.path.basename(DEVICE_COLLECT_PATH))
    np.savez_compressed(path, **export_fixture())
    print(json.dumps({"out": path, "bytes": os.path.getsize(path)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
