"""Export the JAX package's scenario recordings, for holding the port's
scenario subsystem (``ddls_tpu_torch/scenarios``) and the device episode's
failure walk (``sim/device_env.py`` ``scenario_adjusted``, K25's scenario
mode) on a machine that has no JAX.

    python scripts/export_torch_scenario_fixture.py [--out-dir DIR]

Writes ``scenario_recorded.npz`` (default directory:
``ddls_tpu_torch/data``; read by
``ddls_tpu_torch/sim/fixture.load_scenario_fixture``):

* ``spec/<name>/`` for each registry spec and for the full-width spec
  ``ddls_tpu_torch/data/scenario_failures_load32.json`` (which the
  reference's ``get_spec`` must load to the same fingerprint): the
  fingerprint, the resolved failure windows on the spec's topology, the
  built runtime (speeds and the windows' arrays; none for a nominal
  spec), the env kwargs as JSON with the ``_target_`` paths mapped to the
  port's, and for a loadgen arrival its trace fingerprint and gaps;
* ``fuzz/``: ``inflate_duration`` and ``jax.jit(inflate_duration_jax)``
  in float32 and under x64 on 512 fuzzed rows (16 window sets of 4
  windows, 32 rows each) that take every branch: a preemption's push, a
  straggler that fits and one that spills, a window before the start and
  one after the end, ``r0 != 1``, an empty server mask (``r0 = inf``), a
  zero and an infinite nominal (on an empty mask too: NaN); the script
  checks each branch is taken;
* ``failures/``: on the registry's ``failures`` spec (8 servers), the
  reference host episode of ``scenarios/conformance.py`` (seed 0, up to
  120 decisions): its arrivals as a job bank, its actions, its decision
  events and ``jitted_decision_events`` under x64;
* ``full/``: on the full-width spec (32 servers, reset from seed 0), two
  job banks from ``sample_job_bank`` (420 jobs, seeds 0 and 1), one
  action sequence of 400 degrees drawn from {0, 1, 2, 4, 8, 16}
  (``RandomState(0)``), the JAX float32 replay of each bank and the x64
  replay of bank 0 (``make_episode_fn(memo_cfg=None)``: traces and
  counters);
* ``c1/``: on the canonical spec, a bank of 12 jobs of one model, four
  arriving at each of t = 0, 1000 and 2000, all with 20 training steps
  and SLA fraction 1, each decided at degree 2: the four of a group fill
  the 8 servers and commit the same t + jct, so three ticks complete four
  slots each; its JAX float32 replay.

``export_fixture(prefix=D)`` replays only the first ``D`` decisions of the
full-width banks and leaves their counters out (the replay is causal, so
its traces are the archive's first ``D`` columns;
``tests/test_torch_scenario_fixture.py`` regenerates that way).
Deterministic: rerunning it reproduces every array bit for bit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

from ddls_tpu_torch.sim.fixture import (COUNTER_NAMES,  # noqa: E402
                                        FULL_SCENARIO_PATH, SCENARIO_PATH,
                                        TRACE_NAMES, branch_counts,
                                        fuzz_walk)

FULL_BANKS = (0, 1)
FULL_JOBS = 420
FULL_DECISIONS = 400
DEGREES = (0, 1, 2, 4, 8, 16)
FAILURES_DECISIONS = 120
FUZZ_GROUPS, FUZZ_WINDOWS, FUZZ_ROWS = 16, 4, 32


def spec_names():
    from ddls_tpu.scenarios import REGISTRY

    return sorted(REGISTRY) + ["failures_load32"]


def reference_spec(name: str):
    from ddls_tpu.scenarios import get_spec

    return get_spec(FULL_SCENARIO_PATH if name == "failures_load32"
                    else name)


def record_spec(name: str) -> Dict[str, np.ndarray]:
    """What the port's spec layer must reproduce for one spec."""
    from ddls_tpu.demands.distributions import LoadgenInterarrival
    from ddls_tpu.hardware.topologies import build_topology
    from ddls_tpu.scenarios import (build_runtime, env_kwargs,
                                    resolve_failure_windows,
                                    spec_fingerprint)

    spec = reference_spec(name)
    topo = build_topology(spec.topology)
    dense = topo.dense_tables()
    n_srv, n_chan = len(dense["server_index"]), len(dense["channel_ids"])
    p = f"spec/{name}/"
    out = {p + "fingerprint": np.array(spec_fingerprint(spec)),
           p + "n_servers": np.array(n_srv, np.int64),
           p + "n_channels": np.array(n_chan, np.int64),
           p + "env_kwargs": np.array(json.dumps(
               env_kwargs(spec), sort_keys=True).replace(
               '"ddls_tpu.', '"ddls_tpu_torch.'))}
    windows = resolve_failure_windows(spec, n_srv, n_chan)
    for key, dtype in (("kind", np.int64), ("resource", np.int64),
                       ("t0", np.float64), ("t1", np.float64),
                       ("rate", np.float64)):
        out[p + f"windows/{key}"] = np.array([w[key] for w in windows],
                                             dtype)
    out[p + "windows/event"] = np.array(json.dumps(
        [w["event"] for w in windows]))
    runtime = build_runtime(spec, topo)
    out[p + "nominal"] = np.array(runtime is None)
    if runtime is not None:
        for key in ("speeds", "win_t0", "win_t1", "win_rate"):
            out[p + f"runtime/{key}"] = np.asarray(getattr(runtime, key))
        for key in ("win_kind", "win_res"):
            out[p + f"runtime/{key}"] = np.asarray(getattr(runtime, key),
                                                   np.int64)
    if spec.arrival["kind"] == "loadgen":
        knobs = {k: v for k, v in spec.arrival.items() if k != "kind"}
        dist = LoadgenInterarrival(**knobs)
        out[p + "loadgen/fingerprint"] = np.array(dist.trace_fingerprint)
        out[p + "loadgen/gaps"] = dist._gaps
    return out


def fuzz_inputs(seed: int = 11) -> Dict[str, np.ndarray]:
    """The fuzzed walk rows: per group 4 t0-sorted, non-overlapping
    windows (kinds and rates mixed, one of them preemptive), per row a
    start, a nominal, ``r0`` and which windows touch the job. A row with
    ``r0 = inf`` has an empty server mask, so no preemption touches it."""
    rng = np.random.default_rng(seed)
    G, W, R = FUZZ_GROUPS, FUZZ_WINDOWS, FUZZ_ROWS
    t0 = np.zeros((G, W)); t1 = np.zeros((G, W))
    rate = np.zeros((G, W)); kind = np.zeros((G, W), np.int64)
    for g in range(G):
        edges = np.sort(rng.uniform(0.0, 1200.0, 2 * W))
        t0[g], t1[g] = edges[0::2], edges[1::2]
        kind[g] = rng.integers(0, 2, W)
        kind[g, rng.integers(W)] = 0
        rate[g] = np.where(kind[g] == 0, 0.0,
                           1.0 / rng.uniform(1.25, 6.0, W))
    n = G * R
    t = rng.uniform(0.0, 1000.0, n)
    nominal = rng.uniform(0.05, 600.0, n)
    r0 = rng.choice([0.8, 1.0, 1.25, 0.5, 0.7], n)
    affects = rng.random((n, W)) < 0.6
    # the edge rows: an empty mask, zero and infinite nominals, a start
    # inside a window and on a window's edge
    special = rng.choice(n, 64, replace=False)
    r0[special[:16]] = np.inf
    nominal[special[16:24]] = 0.0
    nominal[special[24:32]] = np.inf
    # an infinite nominal on an empty mask walks to NaN
    nominal[special[:4]] = np.inf
    g_of = np.arange(n) // R
    t[special[32:48]] = (t0[g_of[special[32:48]], 1]
                         + t1[g_of[special[32:48]], 1]) / 2
    t[special[48:56]] = t0[g_of[special[48:56]], 2]
    empty = ~np.isfinite(r0)
    affects &= ~(empty[:, None] & (kind[g_of] == 0))
    return {"t": t, "nominal": nominal, "r0": r0, "affects": affects,
            "t0": t0, "t1": t1, "rate": rate, "kind": kind}


def record_fuzz() -> Dict[str, np.ndarray]:
    import jax
    import jax.numpy as jnp
    import torch

    from ddls_tpu.scenarios.failures import (inflate_duration,
                                             inflate_duration_jax)

    fz = fuzz_inputs()
    R, W = FUZZ_ROWS, FUZZ_WINDOWS
    g_of = np.arange(len(fz["t"])) // R
    host = np.array([inflate_duration(
        float(fz["t"][i]), float(fz["nominal"][i]), float(fz["r0"][i]),
        fz["t0"][g], fz["t1"][g], fz["rate"][g],
        [bool(a) for a in fz["affects"][i]])
        for i, g in enumerate(g_of)])
    counted = {}
    fuzz_walk(fz, torch.float64, counted)
    branches = branch_counts(counted)
    missing = [k for k, v in branches.items() if not v]
    if missing:
        raise RuntimeError(f"the fuzzed rows miss the branches {missing}")

    def walk(t, nominal, r0, t0, t1, rate, affects):
        return inflate_duration_jax(t, nominal, r0, t0, t1, rate,
                                    [affects[i] for i in range(W)])

    def run(dtype):
        fn = jax.jit(jax.vmap(walk))
        return np.asarray(fn(*(jnp.asarray(fz[k], dtype) for k in
                               ("t", "nominal", "r0")),
                             *(jnp.asarray(fz[k][g_of], dtype) for k in
                               ("t0", "t1", "rate")),
                             jnp.asarray(fz["affects"])))

    out = {f"fuzz/{k}": v for k, v in fz.items()}
    out["fuzz/host"] = host
    out["fuzz/jit_f32"] = run(jnp.float32)
    with jax.enable_x64(True):
        out["fuzz/jit_x64"] = run(jnp.float64)
    out["fuzz/branches"] = np.array(json.dumps(branches, sort_keys=True))
    return out


def _bank_arrays(bank) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in bank.items()}


_DECISION_KEYS = ("t", "job_idx", "degree", "accepted", "cause", "jct")


def _decision_arrays(events) -> Dict[str, np.ndarray]:
    from ddls_tpu.sim.jax_env import CAUSE_STR_TO_CODE

    out = {k: np.array([e[k] for e in events],
                       np.float64 if k in ("t", "jct") else np.int64)
           for k in _DECISION_KEYS if k != "cause"}
    out["cause"] = np.array([0 if e["cause"] is None
                             else CAUSE_STR_TO_CODE[e["cause"]]
                             for e in events], np.int64)
    return out


def record_failures_episode() -> Dict[str, np.ndarray]:
    """The registry ``failures`` spec's reference host episode (the
    conformance CLI's seed and ``--max-decisions``) and its x64 jitted
    replay."""
    import jax

    from ddls_tpu.scenarios import get_spec
    from ddls_tpu.scenarios.conformance import (build_env, decision_events,
                                                jitted_decision_events,
                                                run_recorded_episode)
    from ddls_tpu.sim import jax_env

    env = build_env(get_spec("failures"), "host")
    events, actions = run_recorded_episode(
        env, 0, max_decisions=FAILURES_DECISIONS)
    arrivals = [{"model": e["model"],
                 "num_training_steps": e["num_training_steps"],
                 "sla_frac": e["sla_frac"], "time_arrived": e["t"]}
                for e in events if e["kind"] == "job_arrived"]
    et = jax_env.build_episode_tables(env)
    out = {"failures/types": np.array(json.dumps(et.types)),
           "failures/actions": np.asarray(actions, np.int32)}
    for k, v in _bank_arrays(jax_env.build_job_bank(et, arrivals)).items():
        out[f"failures/bank/{k}"] = v
    for k, v in _decision_arrays(decision_events(events)).items():
        out[f"failures/host/{k}"] = v
    with jax.enable_x64(True):
        jitted = jitted_decision_events(env, events, actions)
    for k, v in _decision_arrays(jitted).items():
        out[f"failures/jitted/{k}"] = v
    return out


def _replay(out, prefix, fn, banks, actions, counters: bool) -> None:
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


def full_env():
    """The reference env on the full-width spec, reset from seed 0."""
    from ddls_tpu.scenarios.conformance import build_env

    env = build_env(reference_spec("failures_load32"), "host")
    env.reset(seed=0)
    return env


def full_actions() -> np.ndarray:
    return np.random.RandomState(0).choice(
        DEGREES, size=FULL_DECISIONS).astype(np.int32)


def record_full(prefix: Optional[int]) -> Dict[str, np.ndarray]:
    import jax

    from ddls_tpu.sim import jax_env

    env = full_env()
    et = jax_env.build_episode_tables(env)
    banks = [_bank_arrays(jax_env.sample_job_bank(et, env, FULL_JOBS, s))
             for s in FULL_BANKS]
    actions = full_actions()
    n_dec = FULL_DECISIONS if prefix is None else prefix
    out = {"full/types": np.array(json.dumps(et.types)),
           "full/actions": actions}
    for name in banks[0]:
        out[f"full/banks/{name}"] = np.stack([b[name] for b in banks])
    full = prefix is None
    _replay(out, "full/f32", jax_env.make_episode_fn(et, memo_cfg=None),
            banks, actions[:n_dec], full)
    with jax.enable_x64(True):
        et64 = jax_env.build_episode_tables(env)
        _replay(out, "full/x64",
                jax_env.make_episode_fn(et64, memo_cfg=None), banks[:1],
                actions[:n_dec], full)
    return out


def c1_records(types):
    """C1's bank: four jobs at each of t = 0, 1000 and 2000, one model,
    one number of training steps, SLA fraction 1."""
    return [{"model": types[0], "num_training_steps": 20, "sla_frac": 1.0,
             "time_arrived": 1000.0 * (i // 4)} for i in range(12)]


C1_ACTIONS = np.full(12, 2, np.int32)


def record_c1() -> Dict[str, np.ndarray]:
    from ddls_tpu.scenarios import get_spec
    from ddls_tpu.scenarios.conformance import build_env
    from ddls_tpu.sim import jax_env

    env = build_env(get_spec("canonical"), "host")
    env.reset(seed=0)
    et = jax_env.build_episode_tables(env)
    bank = _bank_arrays(jax_env.build_job_bank(et, c1_records(et.types)))
    out = {"c1/types": np.array(json.dumps(et.types)),
           "c1/actions": C1_ACTIONS}
    for k, v in bank.items():
        out[f"c1/bank/{k}"] = v
    _replay(out, "c1/f32", jax_env.make_episode_fn(et, memo_cfg=None),
            [bank], C1_ACTIONS, True)
    completed = out["c1/f32/counters/completed"]
    if int(completed[0]) < 12:
        raise RuntimeError(f"C1's bank completed {completed} jobs, not 12")
    return out


def export_fixture(prefix: Optional[int] = None) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {
        "specs": np.array(json.dumps(spec_names()))}
    for name in spec_names():
        out.update(record_spec(name))
    out.update(record_fuzz())
    out.update(record_failures_episode())
    out.update(record_full(prefix))
    out.update(record_c1())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", default=os.path.dirname(SCENARIO_PATH))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, os.path.basename(SCENARIO_PATH))
    np.savez_compressed(path, **export_fixture())
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
