"""Export the JAX in-kernel candidate pricing recordings: the OracleJCT
episode and the price-feature policy episode, for holding the port's
``price_all``, ``make_oracle_episode_fn`` and price-feature
``make_policy_episode_fn`` (``ddls_tpu_torch/sim/device_env.py``) on a
machine that has no JAX.

    python scripts/export_torch_oracle_fixture.py [--out-dir DIR]

Writes ``oracle_episode_recorded.npz`` (default directory:
``ddls_tpu_torch/data``; read by
``ddls_tpu_torch/sim/fixture.load_oracle_fixture``):

* ``small/oracle/``: the surface of ``tests/test_jax_oracle_episode.py``
  (``oracle_surface_kwargs``: 32 servers, a job every 45, max degree 8,
  native candidate pricing; profiles from seed 5, reset from seed 31): the
  host OracleJCT's episode (``bank/*``, ``host/*``), the JAX x64
  ``make_oracle_episode_fn`` trace and counters of its bank (``x64/*``)
  and ``price_all``'s ``(ok, jct)`` at every step (``x64/price_ok``,
  ``x64/price_jct`` [J, n_deg]);
* ``small/policy/``: the surface of ``tests/test_jax_policy_episode.py``
  with price features (a job every 40, reset from seed 17): its policy's
  params (``GNNPolicy`` initialised from ``PRNGKey(3)``, ``params/*``),
  the host env's greedy episode under that policy, the JAX x64
  ``make_policy_episode_fn(greedy=True)`` trace and counters, and each
  step's price block of the observation (``x64/price_block`` [J, A]);
* ``full/``: the shipped ``env_load32_price_mixed`` (reset from seed 0)
  with ``bench.py``'s job banks (``export_torch_device_env_fixture``'s
  seeds ``ORACLE_SEEDS``): the first ``PREFIX`` steps of the JAX float32
  OracleJCT episode of each bank (``oracle/f32/*`` [2, P]) with
  ``price_all``'s outputs, and of ``ppo_price_mixed``'s greedy float32
  policy episode of bank 0 (``policy/f32/*``) with each step's compact
  fields, ``price_all``'s outputs and the observation's price block.

Each trace is the reference function's own (``make_oracle_episode_fn``,
``make_policy_episode_fn``; at full width on the bank cut to its first
``PREFIX + 1`` jobs, which leaves the first ``PREFIX`` steps as they are:
a step reads no later arrival). The per-step pricing and price blocks
come from the same scan body run one jitted step at a time, whose trace
is asserted equal to the reference function's. ``PREFIX`` = 64 keeps the
export to a few minutes on one CPU core (a full-width ``price_all`` takes
about half a second there). ``export_fixture(prefix=P)`` records the
full-width parts over their first ``P`` steps
(``tests/test_torch_fixture.py`` regenerates that way). Deterministic:
rerunning it reproduces every array bit for bit.
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
import export_torch_device_env_fixture as device_env_export  # noqa: E402
from ddls_tpu_torch.sim.fixture import (COUNTER_NAMES,  # noqa: E402
                                        ORACLE_PATH, ORACLE_SURFACES,
                                        ORACLE_TRACE_NAMES,
                                        POLICY_ARCH, POLICY_TRACE_NAMES,
                                        mixed_action_episode,
                                        oracle_surface_kwargs)

PREFIX = 64
ORACLE_SEEDS = (0, 1)
POLICY_INIT_SEED = 3
# the compact observation fields of a policy step
FIELD_NAMES = ("jtype", "frac", "steps", "n_occupied", "n_running")


def _step_fns(et, ot, model=None):
    """One jitted step of the reference's OracleJCT scan body
    (``make_oracle_episode_fn`` :1821-1881, without the memo) or, with
    ``model``, of its greedy policy scan body (``make_policy_episode_fn``
    :1476-1554): ``step(bank, state[, params]) -> (state, trace row,
    extras)``, the extras the step's ``price_all`` verdicts and prices
    and, for the policy, its compact fields and price block."""
    import jax
    import jax.numpy as jnp

    from ddls_tpu.sim import jax_env

    k = jax_env._episode_kernels(et)
    degrees = jnp.asarray(np.array(et.degrees, np.int32))
    n_deg = len(et.degrees)
    A = et.max_action + 1

    def oracle_choice(bank, carry, row, ok, jcts, dt):
        srv_job = carry[2]
        mask = jax_env._kernel_action_mask(
            ot, et, (srv_job >= 0).sum())[degrees]
        steps = bank["steps"][row].astype(dt)
        max_jct = (bank["sla_frac"][row].astype(dt)
                   * (jnp.asarray(ot["orig_seq_sum"]).astype(dt)[
                       bank["type"][row]] * steps))
        acceptable = mask & ok & (jcts <= max_jct)
        placeable = mask & ok
        big = jnp.asarray(jnp.inf, dt)
        first_acc = jnp.where(acceptable.any(),
                              degrees[jnp.argmax(acceptable)], -1)
        best_jct = big
        best_deg = jnp.int32(-1)
        for d in range(n_deg):
            take = placeable[d] & (jcts[d] < best_jct)
            best_jct = jnp.where(take, jcts[d], best_jct)
            best_deg = jnp.where(take, degrees[d], best_deg)
        first_valid = jnp.where(mask.any(), degrees[jnp.argmax(mask)], 0)
        return jnp.where(first_acc >= 0, first_acc,
                         jnp.where(best_deg >= 0, best_deg, first_valid)
                         ).astype(jnp.int32)

    def price_block(bank, carry, row, ok, jcts):
        srv_job = carry[2]
        frac64 = bank["sla_frac"][row].astype(jnp.float64)
        steps64 = bank["steps"][row].astype(jnp.float64)
        limit = jnp.maximum(
            frac64 * (jnp.asarray(ot["orig_seq_sum"])[
                bank["type"][row]] * steps64), 1e-30)
        dmask = jax_env._kernel_action_mask(
            ot, et, (srv_job >= 0).sum())[degrees]
        vals = jnp.minimum(jcts.astype(jnp.float64) / limit, 2.0) / 2.0
        return jnp.ones((A,), jnp.float64).at[degrees].set(
            jnp.where(ok & dmask, vals, 1.0))

    def step(bank, state, params=None):
        dt = et.tables["dep_size"].dtype
        (carry, queue_row, ptr, next_arrival, done, completed,
         counters) = state
        t = carry[0]
        has_job = (queue_row >= 0) & ~done
        row = jnp.clip(queue_row, 0)
        zeros_price = (jnp.zeros((n_deg,), bool), jnp.zeros((n_deg,), dt))

        def run(_):
            ok, jcts = k.price_all(bank, carry, row)
            if model is None:
                action = oracle_choice(bank, carry, row, ok, jcts, dt)
                block = jnp.ones((A,), jnp.float64)
            else:
                block = price_block(bank, carry, row, ok, jcts)
                srv_job, slot_valid = carry[2], carry[4]
                obs = jax_env._kernel_obs(
                    ot, et, bank["type"][row],
                    bank["sla_frac"][row].astype(jnp.float64),
                    bank["steps"][row].astype(jnp.float64),
                    (srv_job >= 0).sum(), slot_valid.sum(),
                    price_feats=block)
                logits, _ = model.apply(params, obs)
                action = jnp.argmax(logits).astype(jnp.int32)
            new_carry, (reward, accept, cause, jct), _ = k.decision(
                bank, carry, action, row, None)
            return (new_carry, action, reward, accept, cause, jct, ok,
                    jcts.astype(dt), block.astype(jnp.float32))

        def skip(_):
            return (carry, jnp.int32(0), jnp.zeros((), dt),
                    jnp.bool_(False), jnp.int32(-1), jnp.zeros((), dt),
                    *zeros_price, jnp.ones((A,), jnp.float32))

        (new_carry, action, reward, accept, cause, jct, ok, jcts,
         block) = jax.lax.cond(has_job, run, skip, None)
        accepted, blocked, ret = counters
        counters2 = (accepted + (has_job & accept),
                     blocked + (has_job & ~accept),
                     ret + jnp.where(has_job, reward, 0.0))
        queue_row2 = jnp.where(has_job, -1, queue_row)
        (carry3, queue_row3, ptr3, next_arrival3, done3,
         completed3) = k.advance(bank, new_carry, queue_row2, ptr,
                                 next_arrival, done, completed)
        fields = {"jtype": bank["type"][row],
                  "frac": bank["sla_frac"][row].astype(dt),
                  "steps": bank["steps"][row].astype(dt),
                  "n_occupied": (carry[2] >= 0).sum().astype(jnp.int32),
                  "n_running": carry[4].sum().astype(jnp.int32)}
        out = {"action": action, "reward": reward, "accept": accept,
               "cause": cause, "jct": jct, "t": t, "has_job": has_job}
        extras = {"price_ok": ok, "price_jct": jcts, "price_block": block,
                  **fields}
        return ((carry3, queue_row3, ptr3, next_arrival3, done3,
                 completed3, counters2), out, extras)

    return k, jax.jit(step)


def _run_steps(et, ot, bank, n_steps, model=None, params=None):
    """``n_steps`` jitted steps from the initial state: ({name: [n]}
    trace, {name: [n, ...]} extras)."""
    import jax.numpy as jnp

    k, step = _step_fns(et, ot, model)
    b = {key: jnp.asarray(v) for key, v in bank.items()}
    state = k.init_state(b)
    trace, extras = {}, {}
    for _ in range(n_steps):
        args = (b, state) if model is None else (b, state, params)
        state, out, ext = step(*args)
        for key, v in out.items():
            trace.setdefault(key, []).append(np.asarray(v))
        for key, v in ext.items():
            extras.setdefault(key, []).append(np.asarray(v))
    return ({key: np.stack(v) for key, v in trace.items()},
            {key: np.stack(v) for key, v in extras.items()})


def _reference(fn, bank, names, n_steps=None):
    """The reference function's trace ({name: [n_steps]}) and counters
    of ``bank``."""
    import jax.numpy as jnp

    res = fn({key: jnp.asarray(v) for key, v in bank.items()})
    trace = {name: np.asarray(x)[:n_steps]
             for name, x in zip(names, res["trace"])}
    counters = {name: np.asarray(res[name]) for name in COUNTER_NAMES}
    return trace, counters


def _assert_same(loop, ref, names, what):
    for name in names:
        if not np.array_equal(loop[name], ref[name]):
            raise AssertionError(f"{what}: the stepped scan body's {name} "
                                 "differs from the reference function's")


def cut_bank(bank, n_jobs: int) -> dict:
    """``bank`` cut to its first ``n_jobs`` jobs (the arrival after the
    last one at infinity)."""
    out = {key: np.asarray(v)[:n_jobs].copy() for key, v in bank.items()
           if key != "arrival_t"}
    arrival = np.asarray(bank["arrival_t"])[:n_jobs + 1].copy()
    arrival[n_jobs] = np.inf
    out["arrival_t"] = arrival
    return out


def _small_oracle(out, d):
    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.envs.baselines import OracleJCT
    from ddls_tpu.sim import jax_env

    ia, prices, seed = ORACLE_SURFACES["oracle"]
    env = RampJobPartitioningEnvironment(**oracle_surface_kwargs(
        d, interarrival=ia, prices=prices))
    actor = OracleJCT()

    def policy(obs):
        job = next(iter(env.cluster.job_queue.jobs.values()))
        return actor.compute_action(obs, job_to_place=job, env=env)

    arrivals, decisions, stats = mixed_action_episode(env, seed=seed,
                                                      policy=policy)
    et = jax_env.build_episode_tables(env)
    ot = jax_env.build_obs_tables(env, et)
    bank = jax_env.build_job_bank(et, arrivals)
    p = "small/oracle/"
    out[p + "types"] = np.array(json.dumps(et.types))
    _host(out, p, bank, decisions, stats)
    ref, counters = _reference(jax_env.make_oracle_episode_fn(et, ot), bank,
                               ORACLE_TRACE_NAMES)
    loop, extras = _run_steps(et, ot, bank, len(bank["type"]))
    _assert_same(loop, ref, ORACLE_TRACE_NAMES, "small oracle")
    _put(out, p + "x64/", ref, counters)
    out[p + "x64/price_ok"] = extras["price_ok"]
    out[p + "x64/price_jct"] = extras["price_jct"]


def _small_policy(out, d):
    import jax
    import jax.numpy as jnp

    from ddls_tpu.envs import RampJobPartitioningEnvironment
    from ddls_tpu.models.policy import GNNPolicy
    from ddls_tpu.sim import jax_env
    from ddls_tpu_torch.models.convert import flatten_tree

    ia, prices, seed = ORACLE_SURFACES["policy"]
    env = RampJobPartitioningEnvironment(
        **oracle_surface_kwargs(d, interarrival=ia, prices=prices))
    obs0 = env.reset(seed=seed)
    et = jax_env.build_episode_tables(env)
    ot = jax_env.build_obs_tables(env, et)
    model = GNNPolicy(n_actions=env.max_partitions_per_op + 1,
                      **POLICY_ARCH)
    params = jax.jit(model.init)(jax.random.PRNGKey(POLICY_INIT_SEED),
                                 jax.tree_util.tree_map(jnp.asarray, obs0))
    apply = jax.jit(lambda o: model.apply(params, o)[0])

    def policy(obs):
        return int(np.argmax(np.asarray(apply(
            jax.tree_util.tree_map(jnp.asarray, obs)))))

    arrivals, decisions, stats = mixed_action_episode(env, seed=seed,
                                                      policy=policy)
    bank = jax_env.build_job_bank(et, arrivals)
    p = "small/policy/"
    out[p + "types"] = np.array(json.dumps(et.types))
    for key, v in flatten_tree({"params": params["params"]}).items():
        out[f"{p}params/{key}"] = np.asarray(v, np.float32)
    _host(out, p, bank, decisions, stats)
    fn = jax_env.make_policy_episode_fn(et, ot, model, greedy=True)
    res = fn({key: jnp.asarray(v) for key, v in bank.items()}, params,
             jax.random.PRNGKey(0))
    ref = {name: np.asarray(x) for name, x in zip(POLICY_TRACE_NAMES,
                                                  res["trace"])}
    counters = {name: np.asarray(res[name]) for name in COUNTER_NAMES}
    loop, extras = _run_steps(et, ot, bank, len(bank["type"]), model,
                              params)
    _assert_same(loop, ref, ORACLE_TRACE_NAMES, "small policy")
    _put(out, p + "x64/", {name: ref[name] for name in ORACLE_TRACE_NAMES},
         counters)
    out[p + "x64/price_block"] = extras["price_block"]


def _host(out, prefix, bank, decisions, stats):
    for name, value in bank.items():
        out[f"{prefix}bank/{name}"] = value
    host = np.array(decisions, np.float64)
    for i, name in enumerate(("action", "reward", "accept", "cause", "t",
                              "jct")):
        out[f"{prefix}host/{name}"] = host[:, i]
    for name, value in stats.items():
        out[f"{prefix}host/{name}"] = np.array(value, np.int64)


def _put(out, prefix, trace, counters=None):
    for name, value in trace.items():
        out[f"{prefix}trace/{name}"] = value
    for name, value in (counters or {}).items():
        out[f"{prefix}counters/{name}"] = value


def _full(out, n_steps: int):
    from ddls_tpu.sim import jax_env

    env = device_env_export.shipped_env()
    et = jax_env.build_episode_tables(env)
    ot = jax_env.build_obs_tables(env, et)
    out["full/types"] = np.array(json.dumps(et.types))
    out["full/seeds"] = np.array(ORACLE_SEEDS, np.int64)
    fn = jax_env.make_oracle_episode_fn(et, ot)
    traces, extras = [], []
    for seed in ORACLE_SEEDS:
        bank = jax_env.build_job_bank(
            et, device_env_export.bank_records(et.types, seed))
        ref, _ = _reference(fn, cut_bank(bank, n_steps + 1),
                            ORACLE_TRACE_NAMES, n_steps)
        loop, ext = _run_steps(et, ot, bank, n_steps)
        _assert_same(loop, ref, ORACLE_TRACE_NAMES, f"full oracle {seed}")
        traces.append(ref)
        extras.append(ext)
    _put(out, "full/oracle/f32/", {
        name: np.stack([tr[name] for tr in traces])
        for name in ORACLE_TRACE_NAMES})
    for name in ("price_ok", "price_jct"):
        out[f"full/oracle/f32/{name}"] = np.stack([e[name] for e in extras])

    import jax

    _, model, params, _ = ckpt_export.load_policy("ppo_price_mixed")
    bank = jax_env.build_job_bank(
        et, device_env_export.bank_records(et.types, ORACLE_SEEDS[0]))
    pfn = jax_env.make_policy_episode_fn(et, ot, model, greedy=True)
    import jax.numpy as jnp
    res = pfn({key: jnp.asarray(v) for key, v in
               cut_bank(bank, n_steps + 1).items()}, params,
              jax.random.PRNGKey(0))
    ref = {name: np.asarray(x)[:n_steps] for name, x in
           zip(POLICY_TRACE_NAMES, res["trace"])}
    loop, ext = _run_steps(et, ot, bank, n_steps, model, params)
    _assert_same(loop, ref, ORACLE_TRACE_NAMES, "full policy")
    _put(out, "full/policy/f32/", {name: ref[name]
                                   for name in ORACLE_TRACE_NAMES})
    for name in ("price_ok", "price_jct", "price_block") + FIELD_NAMES:
        out[f"full/policy/f32/{name}"] = ext[name]


def export_fixture(prefix: Optional[int] = None) -> Dict[str, np.ndarray]:
    import jax

    from ddls_tpu.graphs.synthetic import generate_pipedream_txt_files

    out: Dict[str, np.ndarray] = {"prefix": np.array(
        PREFIX if prefix is None else prefix, np.int64)}
    _full(out, int(out["prefix"]))
    with jax.enable_x64(True):
        with tempfile.TemporaryDirectory(prefix="oracle_") as d:
            generate_pipedream_txt_files(d, n_cnn=2, n_translation=1,
                                         seed=5)
            _small_oracle(out, d)
            _small_policy(out, d)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.dirname(ORACLE_PATH))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, os.path.basename(ORACLE_PATH))
    out = export_fixture()
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
