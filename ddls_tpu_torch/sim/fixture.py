"""The simulator's recorded fixtures, for holding its kernels on a machine
that has no JAX.

The recorded lookahead lanes: real inputs of the array lookahead engine
with the JAX engine's answers to them (K21).

``scripts/export_torch_lookahead_lanes.py`` writes the archive
(``ddls_tpu_torch/data/lookahead_lanes_recorded.npz``). Each group of lanes
is one batched engine call: the lanes' arrays are stored ragged (each
lane's ``n`` valid ops and ``m`` valid deps, concatenated; the valid slots
are a prefix) with the group's padded sizes, and ``load_lookahead_lanes``
pads them back as the builder does (op workers and channels -1, the rest
zero). The JAX outputs were computed on exactly those padded arrays.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
LANES_PATH = os.path.join(DATA_DIR, "lookahead_lanes_recorded.npz")
DEVICE_ENV_PATH = os.path.join(DATA_DIR, "device_env_replay.npz")

OP_FIELDS = ("op_remaining", "op_valid", "op_worker", "op_score",
             "num_parents")
DEP_FIELDS = ("dep_remaining", "dep_valid", "dep_src", "dep_dst",
              "dep_mutual", "dep_is_flow", "dep_score", "dep_channel")
JAX_OUTPUTS = ("jax_t", "jax_comm", "jax_comp", "jax_busy", "jax_ok")
_PAD_VALUE = {"op_worker": -1, "dep_channel": -1}


def pack_lanes(lanes: Sequence, num_workers: int, num_channels: int
               ) -> Dict[str, np.ndarray]:
    """The ragged form of ``lanes`` (objects with the engine's thirteen
    array fields, valid slots a prefix); the group's padded sizes are the
    largest of the lanes'."""
    n = np.array([int(a.op_valid.sum()) for a in lanes], np.int64)
    m = np.array([int(a.dep_valid.sum()) for a in lanes], np.int64)
    for a, nb, mb in zip(lanes, n, m):
        if not (a.op_valid[:nb].all() and a.dep_valid[:mb].all()):
            raise ValueError("the valid slots of a lane must be a prefix")
    out = {"n": n, "m": m,
           "pad": np.array([max(a.op_remaining.shape[0] for a in lanes),
                            max(a.dep_remaining.shape[0] for a in lanes),
                            max(a.dep_channel.shape[1] for a in lanes)],
                           np.int64),
           "num_workers": np.array(num_workers, np.int64),
           "num_channels": np.array(num_channels, np.int64)}
    for name in OP_FIELDS:
        out[name] = np.concatenate([getattr(a, name)[:nb]
                                    for a, nb in zip(lanes, n)])
    links = int(out["pad"][2])
    for name in DEP_FIELDS:
        parts = [getattr(a, name)[:mb] for a, mb in zip(lanes, m)]
        if name == "dep_channel":
            parts = [np.pad(p, ((0, 0), (0, links - p.shape[1])),
                            constant_values=-1) for p in parts]
        out[name] = np.concatenate(parts)
    return out


def unpack_lanes(packed) -> Dict[str, np.ndarray]:
    """The padded, stacked arrays of a packed group ([B, N], [B, E],
    [B, E, L]), keyed by field name."""
    n, m = np.asarray(packed["n"]), np.asarray(packed["m"])
    pad_n, pad_e, links = (int(x) for x in packed["pad"])
    lanes = len(n)
    out = {}
    for names, counts, size in ((OP_FIELDS, n, pad_n),
                                (DEP_FIELDS, m, pad_e)):
        starts = np.concatenate([[0], np.cumsum(counts)])
        for name in names:
            flat = np.asarray(packed[name])
            shape = (lanes, size) + ((links,) if name == "dep_channel"
                                     else ())
            arr = np.full(shape, _PAD_VALUE.get(name, 0), flat.dtype)
            for b in range(lanes):
                arr[b, :counts[b]] = flat[starts[b]:starts[b + 1]]
            out[name] = arr
    return out


def load_lookahead_lanes(path: str = LANES_PATH
                         ) -> Dict[str, Dict[str, object]]:
    """``{group: {"args": the thirteen padded arrays in the engine's
    order, "num_workers", "num_channels", "n" and "m" (each lane's valid
    ops and deps), "jax": (t, comm, comp, busy, ok)}}``."""
    from ddls_tpu_torch.sim.lookahead import ARG_NAMES

    groups: Dict[str, Dict[str, object]] = {}
    with np.load(path, allow_pickle=False) as data:
        names = sorted({k.split("/")[0] for k in data.files})
        for g in names:
            packed = {k.split("/", 1)[1]: data[k] for k in data.files
                      if k.startswith(f"{g}/")}
            arrays = unpack_lanes(packed)
            groups[g] = {
                "args": tuple(arrays[a] for a in ARG_NAMES),
                "num_workers": int(packed["num_workers"]),
                "num_channels": int(packed["num_channels"]),
                "n": packed["n"], "m": packed["m"],
                "jax": tuple(packed[k] for k in JAX_OUTPUTS)}
    return groups


# the recorded group whose lanes ``nan_lanes`` poisons, and its lanes:
# every flow dep's time, the first valid op's, every flow dep's as a NaN
# of the negative sign
NAN_GROUP = "mounted32"
NAN_DEPS, NAN_OP, NAN_NEG_DEPS = 2, 3, 6


def nan_lanes(group: str = NAN_GROUP) -> Dict[str, object]:
    """A recorded group of K21 lanes (``load_lookahead_lanes``) with NaN
    remaining times laid into three of its lanes (``NAN_DEPS``, ``NAN_OP``,
    ``NAN_NEG_DEPS``), the other lanes as recorded: ``{"args", "lanes"
    (the poisoned ones), "num_workers", "num_channels"}``. The reference's
    minima (``jnp.min``, ``jnp.minimum``) propagate a NaN of either sign,
    as the plain version's (``torch.amin``, ``torch.minimum``) and K21's
    do."""
    from ddls_tpu_torch.sim.lookahead import ARG_NAMES

    rec = load_lookahead_lanes()[group]
    args = [np.array(a) for a in rec["args"]]
    at = {name: args[i] for i, name in enumerate(ARG_NAMES)}
    flow, rem = at["dep_is_flow"], at["dep_remaining"]
    rem[NAN_DEPS][flow[NAN_DEPS]] = np.nan
    rem[NAN_NEG_DEPS][flow[NAN_NEG_DEPS]] = -np.nan
    at["op_remaining"][NAN_OP, 0] = np.nan
    assert rec["n"][NAN_OP] > 0
    assert flow[NAN_DEPS].any() and flow[NAN_NEG_DEPS].any()
    return {"args": tuple(args), "lanes": (NAN_DEPS, NAN_OP, NAN_NEG_DEPS),
            "num_workers": rec["num_workers"],
            "num_channels": rec["num_channels"]}


# ---------------------------------------------------------------- replays
# The device episode replay's recordings
# (scripts/export_torch_device_env_fixture.py writes them): on the shipped
# surface, eight job banks, one action sequence and the JAX replay's trace
# and counters of each bank (float32) and of bank 0 (x64); on the small
# surface of the reference's episode test, the host episode's arrivals and
# actions and the JAX x64 replay of them.
TRACE_NAMES = ("reward", "accept", "cause", "jct", "t", "has_job")
COUNTER_NAMES = ("accepted", "blocked", "ret", "completed", "t", "done",
                 "blocked_total", "arrived")
BANK_NAMES = ("type", "steps", "sla_frac", "arrival_t")


def load_device_env_fixture(path: str = DEVICE_ENV_PATH) -> Dict[str, object]:
    """``{"types", "banks" ({name: [8, J] arrays}), "actions" [D],
    "f32" and "x64" ({"trace": {name: [lanes, D]}, "counters": {name:
    [lanes]}}), "small" ({"types", "bank", "actions", "x64", "host"})}``."""
    import json

    with np.load(path, allow_pickle=False) as data:
        def group(prefix):
            return {k[len(prefix):]: data[k] for k in data.files
                    if k.startswith(prefix)}

        def replay(prefix):
            return {"trace": group(f"{prefix}/trace/"),
                    "counters": group(f"{prefix}/counters/")}

        return {"types": json.loads(str(data["types"])),
                "banks": group("banks/"), "actions": data["actions"],
                "f32": replay("f32"), "x64": replay("x64"),
                "small": {"types": json.loads(str(data["small/types"])),
                          "bank": group("small/bank/"),
                          "actions": data["small/actions"],
                          "x64": replay("small/x64"),
                          "host": group("small/host/")}}


def mixed_action_episode(env, seed: int = 17, rng_seed: int = 23,
                         before_step=None, policy=None):
    """One host episode of the reference's mixed-action policy
    (``tests/test_jax_episode.py:61-108``: 15% action 0, 40% the largest
    valid action, else a uniform valid one), or of ``policy`` (a callable
    of the observation) when given, from ``env.reset(seed)``. Works on the
    JAX package's env and on the port's.

    Returns ``(arrivals, decisions, stats)``: one record per arrived job
    (``build_job_bank``'s), per decision ``(action, reward, accepted,
    cause code, t, jct)`` (``sim/device_env.py`` ``CAUSE_*``; jct NaN for
    a job accepted at the last decision and blocked by the episode's end,
    whose record keeps no lookahead time), and the
    cluster's episode stats ``arrived``, ``blocked_total`` and
    ``completed``."""
    from ddls_tpu_torch.sim.device_env import (CAUSE_ACCEPTED,
                                               CAUSE_STR_TO_CODE)

    cluster = env.cluster
    obs = env.reset(seed=seed)
    rng = np.random.RandomState(rng_seed)
    arrivals, decisions, seen = [], [], set()

    def record(job):
        arrivals.append({"model": job.details["model"],
                         "num_training_steps": job.num_training_steps,
                         "sla_frac": job.max_acceptable_jct_frac,
                         "time_arrived": job.details["time_arrived"]})

    done = False
    while not done:
        job = next(iter(env.cluster.job_queue.jobs.values()))
        ji = env.cluster.job_id_to_job_idx[job.job_id]
        if ji not in seen:
            assert ji == len(arrivals), (ji, len(arrivals))
            seen.add(ji)
            record(job)
        t_dec = env.cluster.stopwatch.time()
        valid = np.nonzero(np.asarray(obs["action_mask"]))[0]
        r = rng.rand()
        if policy is not None:
            action = int(policy(obs))
        elif r < 0.15:
            action = 0
        elif r < 0.55:
            action = int(valid[-1])
        else:
            action = int(rng.choice(valid))
        causes = env.cluster.episode_stats[
            "jobs_blocked_cause_of_unsuccessful_handling"]
        n_before = len(causes)
        if before_step is not None:
            before_step(env, ji)
        obs, reward, done, _ = env.step(action)
        cluster = env.cluster
        new_causes = cluster.episode_stats[
            "jobs_blocked_cause_of_unsuccessful_handling"][n_before:]
        # the decided job's cause is the first one this step appended; the
        # episode's end blocks every job still running, the decided one
        # too if it was accepted at the last decision
        ended = bool(new_causes) and new_causes[0] == "simulation_ended"
        accepted = (ended or ji in cluster.jobs_running
                    or ji in cluster.jobs_completed)
        if accepted:
            pj = (cluster.jobs_running.get(ji)
                  or cluster.jobs_completed.get(ji)
                  or cluster.jobs_blocked.get(ji))
            # (NaN: the end's block kept no lookahead time of its own)
            jct = pj.details.get("lookahead_job_completion_time", np.nan)
            cause = CAUSE_ACCEPTED
        else:
            jct = 0.0
            cause = CAUSE_STR_TO_CODE[new_causes[0]]
        decisions.append((action, float(reward), bool(accepted), cause,
                          float(t_dec), float(jct)))
    # the bank needs every arrival (the last may still be queued)
    for ji in range(len(arrivals), cluster.num_jobs_arrived):
        j = (cluster.jobs_running.get(ji) or cluster.jobs_completed.get(ji)
             or cluster.jobs_blocked.get(ji)
             or cluster.job_queue.jobs.get(cluster.job_idx_to_job_id[ji]))
        record(j.original_job if j.original_job is not j else j)
    er = cluster.episode_stats
    stats = {"arrived": int(er["num_jobs_arrived"]),
             "blocked_total": int(er["num_jobs_blocked"]),
             "completed": len(cluster.jobs_completed)}
    return arrivals, decisions, stats


EPISODE_KERNELS = ("allocate_job", "price_and_score", "lookahead",
                   "episode_step")


def max_difference(got, want) -> float:
    """The largest |got - want| over a pair of float tensors (equal
    infinities and NaNs count 0), the number of differing entries over
    any other pair."""
    import torch

    if not got.numel():
        return 0.0
    if got.is_floating_point():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        return float(torch.where(same, 0.0, (got - want).abs()).max())
    return float((got != want).sum())


def episode_kernel_diffs(ek, bank: dict, actions, decisions: int,
                         lookahead_at: Sequence[int]):
    """The first ``decisions`` of a device episode (``ek`` from
    ``device_env.episode_kernels``; ``bank`` [B, J] and ``actions``
    [B, D] tensors on its device), each kernel call against its plain
    version on the decision's own inputs: K23, K24 and K25 every decision,
    K21 (with ``skip``) at the decisions ``lookahead_at`` (its plain
    version takes tens of launches a tick). The episode goes on with the
    kernels' outputs.

    Returns ``(diffs, held, trace)``: the largest ``max_difference`` per
    kernel (0: bit-equal floats and equal integers), the number of calls
    held per kernel, and the trace of those decisions."""
    import torch

    from ddls_tpu_torch.sim import device_env
    from ddls_tpu_torch.sim import lookahead as lookahead_mod

    dev = ek.dev
    tb = dev.t
    trace = {name: torch.zeros(actions.shape, dtype=want or dev.dtype,
                               device=dev.device)
             for name, want in device_env.TRACE_FIELDS}
    state = ek.init_state(bank, actions)
    diffs = dict.fromkeys(EPISODE_KERNELS, 0.0)
    held = dict.fromkeys(EPISODE_KERNELS, 0)

    def hold(name, got, want):
        diffs[name] = max(diffs[name], *(max_difference(g, w)
                                         for g, w in zip(got, want)))
        held[name] += 1

    for d in range(decisions):
        free = state["srv_job"] < 0
        got = device_env.allocate_job(state["mem"], free, state["cfg"], dev)
        want = device_env.allocate_job_plain(state["mem"], free,
                                             state["cfg"], dev)
        hold("allocate_job", got, want)
        hold("price_and_score",
             device_env.price_and_score(got[0], state["cfg"], dev),
             device_env.price_and_score_plain(want[0], state["cfg"], dev))
        raw = ek.evaluate(state)
        if d in lookahead_at:
            plain = lookahead_mod.lookahead_plain(
                *lookahead_mod.gather_indexed(
                    state["cfg"], raw["ots"], raw["op_score"], raw["times"],
                    raw["is_flow"], raw["dep_score"], raw["chan"], tb),
                num_workers=dev.et.n_srv, num_channels=dev.et.n_chan,
                skip=~state["active"])
            hold("lookahead", (raw["t_step"], raw["ok_la"], raw["ticks"]),
                 (plain[0], plain[4], plain[5]))
        state2 = {k: v.clone() for k, v in state.items()}
        trace2 = {k: v.clone() for k, v in trace.items()}
        device_env.episode_step(ek, state, bank, actions, raw, trace, d)
        device_env.episode_step_plain(ek, state2, bank, actions, raw,
                                      trace2, d)
        hold("episode_step", [state[k] for k in state]
             + [trace[k] for k in trace], [state2[k] for k in state]
             + [trace2[k] for k in trace])
    return diffs, held, trace


# a ramp of 64 servers: K23's occupancy masks take two 32-bit words
MULTI_WORD_RAMP = (4, 4, 4)


def multi_word_tables(et, ramp_shape=MULTI_WORD_RAMP):
    """``et``'s config tables over the shape tables of ``ramp_shape`` (its
    blocks at most ``et``'s largest split), for holding K23 where the
    occupancy masks span several words. Only placement reads it: the
    channels and the pair table stay ``et``'s."""
    import dataclasses

    from ddls_tpu_torch.sim import device_env

    st = device_env.build_shape_tables(tuple(ramp_shape), et.pads.max_split)
    if int(st.counts.max()) != et.pads.max_split:
        raise ValueError(f"ramp {ramp_shape} has no block of "
                         f"{et.pads.max_split} servers")
    return dataclasses.replace(et, st=st, n_srv=int(np.prod(ramp_shape)),
                               on_device={})


def wide_episode_tables(servers_per_rack: int, device="cpu"):
    """The episode tables of the shipped surface's env (``ppo_price_mixed``:
    its jobs, 45 configurations, reset from seed 0) on a ramp of 4 x 4 x
    ``servers_per_rack`` servers of one worker each: 64 servers at 4, 128
    at 8. Each server is a slot of the episode, so these hold K25 where a
    lane of its warp owns several slots (``ceil(n_srv / 32)``)."""
    import copy

    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
    from ddls_tpu_torch.sim import device_env

    cfg = copy.deepcopy(load_checkpoint_fixture("ppo_price_mixed")
                        ["env_config"])
    ramp = cfg["topology_config"]["kwargs"]
    ramp["num_servers_per_rack"] = servers_per_rack
    cfg["node_config"]["type_1"]["num_nodes"] = (
        ramp["num_communication_groups"]
        * ramp["num_racks_per_communication_group"] * servers_per_rack)
    env = RampJobPartitioningEnvironment(**cfg, device=device)
    env.reset(seed=0)
    return device_env.build_episode_tables(env)


def fuzzed_placements(et, dev, rows: int, seed: int, indexed: bool):
    """K23's inputs for ``rows`` config rows on fuzzed states: free memory
    at the capacity or a fraction of it, servers taken by other jobs, the
    configs drawn at random; with ``indexed``, ``max(1, rows // 9)`` state
    lanes and each row's lane drawn (candidate pricing's form). Returns
    ``(mem, other_free, cfg, state_lane or None)`` on ``dev``'s device, the
    memory in its float type."""
    import torch

    rng = np.random.RandomState(seed)
    states = max(1, rows // 9) if indexed else rows
    mem = np.full((states, et.n_srv), et.worker_mem)
    used = rng.rand(states, et.n_srv) < rng.uniform(0, 0.8, (states, 1))
    mem[used] *= rng.choice([0.5, 0.25, 0.1, 0.02, 0.001],
                            size=int(used.sum()))
    other = rng.rand(states, et.n_srv) >= rng.uniform(0, 0.6, (states, 1))
    cfg = rng.randint(0, dev.n_cfg, rows).astype(np.int32)
    lane = (rng.randint(0, states, rows).astype(np.int32) if indexed
            else None)

    def put(x, dtype=None):
        return torch.from_numpy(x).to(dev.device, dtype)

    return (put(mem, dev.dtype), put(other), put(cfg),
            None if lane is None else put(lane))


def small_surface_kwargs(path_to_files: str) -> dict:
    """The env of the reference's episode test
    (``tests/test_jax_episode.py:29-49``: 32 servers, the profiles of
    ``generate_pipedream_txt_files(path, n_cnn=2, n_translation=1,
    seed=5)``, max degree 8, simulation end 5e3)."""
    return dict(
        topology_config={"type": "ramp", "kwargs": {
            "num_communication_groups": 4,
            "num_racks_per_communication_group": 4,
            "num_servers_per_rack": 2, "num_channels": 1,
            "total_node_bandwidth": 1.6e12,
            "intra_gpu_propagation_latency": 50e-9,
            "worker_io_latency": 100e-9}},
        node_config={"type_1": {"num_nodes": 32, "workers_config": [
            {"num_workers": 1, "worker": "A100"}]}},
        jobs_config={
            "path_to_files": path_to_files,
            "job_interarrival_time_dist": {
                "_target_": "ddls_tpu.demands.distributions.Fixed",
                "val": 40.0},
            "max_acceptable_job_completion_time_frac_dist": {
                "_target_": "ddls_tpu.demands.distributions.Uniform",
                "min_val": 0.1, "max_val": 1.0, "decimals": 2},
            "replication_factor": 40,
            "job_sampling_mode": "remove_and_repeat",
            "num_training_steps": 20},
        max_partitions_per_op=8, min_op_run_time_quantum=0.01,
        reward_function="job_acceptance", max_simulation_run_time=5e3,
        pad_obs_kwargs={"max_nodes": 150, "max_edges": 512})


def oracle_surface_kwargs(path_to_files: str, interarrival: float = 45.0,
                          prices: bool = False) -> dict:
    """The env of the reference's in-kernel OracleJCT test
    (``tests/test_jax_oracle_episode.py``: the small surface's topology
    and profiles, a job every ``interarrival``, 30 replicas, simulation end
    4e3, native candidate pricing) or, with ``prices`` and interarrival
    40, of its price-feature policy test
    (``tests/test_jax_policy_episode.py``'s price variant: the
    observation carries the price block)."""
    kw = small_surface_kwargs(path_to_files)
    kw["jobs_config"]["job_interarrival_time_dist"]["val"] = interarrival
    kw["jobs_config"]["replication_factor"] = 30
    kw.update(max_simulation_run_time=4e3, candidate_pricing="native",
              obs_include_candidate_prices=prices)
    return kw


def oracle_episode(env, seed: int):
    """The host OracleJCT's episode on ``env`` (native candidate pricing)
    from ``reset(seed)``: ``mixed_action_episode``'s ``(arrivals,
    decisions, stats)`` with the actor choosing from the env's prices."""
    from ddls_tpu_torch.envs.baselines import OracleJCT

    actor = OracleJCT()

    def policy(obs):
        job = next(iter(env.cluster.job_queue.jobs.values()))
        return actor.compute_action(obs, job_to_place=job, env=env)

    return mixed_action_episode(env, seed=seed, policy=policy)


# The in-kernel candidate pricing recordings
# (scripts/export_torch_oracle_fixture.py writes them): on the small
# surfaces of the reference's oracle and price-feature policy tests, the
# host episodes, the JAX x64 traces and each step's pricing and price
# block; at full width on the shipped surface, the first steps of the
# JAX float32 oracle episodes of two banks and of ppo_price_mixed's
# greedy policy episode.
ORACLE_PATH = os.path.join(DATA_DIR, "oracle_episode_recorded.npz")
ORACLE_TRACE_NAMES = ("action", "reward", "accept", "cause", "jct", "t",
                      "has_job")
POLICY_TRACE_NAMES = ("action", "logp", "value", "reward", "accept",
                      "cause", "jct", "t", "has_job")
# the random-init policy of the reference's price-feature policy test
POLICY_ARCH = {"out_features_msg": 8, "out_features_hidden": 16,
               "out_features_node": 8, "out_features_graph": 4,
               "fcnet_hiddens": (32,)}
# the small surfaces' episodes: (interarrival, price features, reset seed)
ORACLE_SURFACES = {"oracle": (45.0, False, 31), "policy": (40.0, True, 17)}


def load_oracle_fixture(path: str = ORACLE_PATH) -> Dict[str, object]:
    """``{"small": {"oracle", "policy": {"types", "bank", "host",
    "params" (policy only: the flax tree, flattened), "x64": {"trace",
    "counters", and "price_ok", "price_jct" (oracle) or "price_block"
    (policy)}}}, "full": {"types", "seeds", "prefix", "oracle": {"trace",
    "price_ok", "price_jct"}, "policy": {"trace", "price_ok",
    "price_jct", "price_block", and the compact fields}}}``."""
    import json

    with np.load(path, allow_pickle=False) as data:
        def group(prefix, nested=False):
            return {k[len(prefix):]: data[k] for k in data.files
                    if k.startswith(prefix)
                    and (nested or "/" not in k[len(prefix):])}

        def run(prefix):
            out = group(prefix)
            out["trace"] = group(prefix + "trace/")
            out["counters"] = group(prefix + "counters/")
            return out

        small = {}
        for name in ORACLE_SURFACES:
            p = f"small/{name}/"
            small[name] = {"types": json.loads(str(data[p + "types"])),
                           "bank": group(p + "bank/"),
                           "host": group(p + "host/"),
                           "params": group(p + "params/", nested=True),
                           "x64": run(p + "x64/")}
        full = {"types": json.loads(str(data["full/types"])),
                "seeds": data["full/seeds"],
                "prefix": int(data["prefix"]),
                "oracle": run("full/oracle/f32/"),
                "policy": run("full/policy/f32/")}
        return {"small": small, "full": full}


# ---------------------------------------------------------------- scenarios
# The scenario recordings (scripts/export_torch_scenario_fixture.py writes
# them): per spec what the spec layer derives, the failure walk on fuzzed
# rows, the registry failures spec's host episode and its x64 jitted
# replay, the full-width spec's JAX replays, and C1's bank.
SCENARIO_PATH = os.path.join(DATA_DIR, "scenario_recorded.npz")
# the full-width failure spec (32 servers, env_load32_price_mixed's fabric
# and workload, loadgen arrivals)
FULL_SCENARIO_PATH = os.path.join(DATA_DIR, "scenario_failures_load32.json")
# the speed levels the fuzzed walk rows' r0 takes; the servers of their
# preemptive windows run at FUZZ_FAST, above every level, so a row's r0
# stays its own
FUZZ_LEVELS = (0.5, 0.7, 0.8, 1.0, 1.25)
FUZZ_FAST = 1e30


def load_scenario_fixture(path: str = SCENARIO_PATH) -> Dict[str, object]:
    """``{"specs": {name: {"fingerprint", "n_servers", "n_channels",
    "env_kwargs" (JSON), "windows" {kind, resource, t0, t1, rate, event},
    "nominal", "runtime" {speeds, win_*}, "loadgen" {fingerprint, gaps}}},
    "fuzz": {inputs, "host", "jit_f32", "jit_x64", "branches"},
    "failures": {"types", "bank", "actions", "host", "jitted"}, "full":
    {"types", "banks", "actions", "f32", "x64" ({"trace", "counters"})},
    "c1": {"types", "bank", "actions", "f32"}}``."""
    import json

    with np.load(path, allow_pickle=False) as data:
        def group(prefix):
            return {k[len(prefix):]: data[k] for k in data.files
                    if k.startswith(prefix) and "/" not in k[len(prefix):]}

        def replay(prefix):
            return {"trace": group(f"{prefix}/trace/"),
                    "counters": group(f"{prefix}/counters/")}

        specs = {}
        for name in json.loads(str(data["specs"])):
            p = f"spec/{name}/"
            spec = {k: (str(v) if v.dtype.kind == "U" else v)
                    for k, v in group(p).items()}
            spec["nominal"] = bool(spec["nominal"])
            spec["windows"] = group(p + "windows/")
            spec["windows"]["event"] = json.loads(
                str(spec["windows"]["event"]))
            spec["runtime"] = group(p + "runtime/")
            lg = group(p + "loadgen/")
            spec["loadgen"] = ({"fingerprint": str(lg["fingerprint"]),
                                "gaps": lg["gaps"]} if lg else None)
            specs[name] = spec
        fuzz = group("fuzz/")
        fuzz["branches"] = json.loads(str(fuzz["branches"]))
        return {
            "specs": specs, "fuzz": fuzz,
            "failures": {"types": json.loads(str(data["failures/types"])),
                         "bank": group("failures/bank/"),
                         "actions": data["failures/actions"],
                         "host": group("failures/host/"),
                         "jitted": group("failures/jitted/")},
            "full": {"types": json.loads(str(data["full/types"])),
                     "banks": group("full/banks/"),
                     "actions": data["full/actions"],
                     "f32": replay("full/f32"), "x64": replay("full/x64")},
            "c1": {"types": json.loads(str(data["c1/types"])),
                   "bank": group("c1/bank/"), "actions": data["c1/actions"],
                   "f32": replay("c1/f32")}}


def fuzz_walk(fz: dict, dtype, branches: Optional[dict] = None
              ) -> np.ndarray:
    """``device_env.scenario_adjusted`` on the recorded fuzzed walk rows
    (``load_scenario_fixture()["fuzz"]``): per window group a scenario
    whose speeds hold every r0 level (``FUZZ_LEVELS``), each row's server
    mask the server of its r0 (none for r0 = inf) and those of the
    preemptions that touch it, its channel mask the stragglers that do.
    ``branches`` as ``scenario_adjusted`` takes it."""
    import torch

    from ddls_tpu_torch.sim import device_env

    levels = np.asarray(FUZZ_LEVELS)
    G, W = fz["t0"].shape
    R = len(fz["t"]) // G
    speeds = np.concatenate([levels, np.full(W, FUZZ_FAST)])
    out = []
    for g in range(G):
        rows = slice(g * R, (g + 1) * R)
        kind = fz["kind"][g]
        res = [len(levels) + i if k == 0 else i for i, k in enumerate(kind)]
        r0, aff = fz["r0"][rows], fz["affects"][rows]
        srv = np.zeros((R, len(speeds)), bool)
        chan = np.zeros((R, W), bool)
        fin = np.isfinite(r0)
        srv[np.flatnonzero(fin), np.searchsorted(levels, r0[fin])] = True
        for i, k in enumerate(kind):
            if k == 0:
                srv[:, res[i]] |= aff[:, i]
            else:
                chan[:, i] = aff[:, i]

        def t(x):
            return torch.tensor(x, dtype=dtype)

        sc = {"speeds": t(speeds), "t0": t(fz["t0"][g]),
              "t1": t(fz["t1"][g]), "rate": t(fz["rate"][g]),
              "windows": list(zip(kind.tolist(), res))}
        out.append(device_env.scenario_adjusted(
            sc, t(fz["t"][rows]), t(fz["nominal"][rows]),
            torch.from_numpy(srv), torch.from_numpy(chan),
            branches).numpy())
    return np.concatenate(out)


def fuzzed_scenario(et, horizon: float, seed: int = 1,
                    windows: int = 24) -> dict:
    """A fuzzed scenario in ``EpisodeTables.scenario``'s form on ``et``'s
    servers and channels: ``windows`` t0-sorted, non-overlapping windows
    over [0, horizon], preemptions (rate 0) and stragglers (rate 1/U(1.05,
    1.5), so a short job can fit inside one) mixed, speeds U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0.0, horizon, 2 * windows))
    kind = rng.integers(0, 2, windows)
    return {"speeds": rng.uniform(0.5, 1.5, et.n_srv),
            "t0": edges[0::2], "t1": edges[1::2],
            "rate": np.where(kind == 0, 0.0,
                             1.0 / rng.uniform(1.05, 1.5, windows)),
            "kind": [int(k) for k in kind],
            "res": [int(rng.integers(et.n_srv if k == 0 else et.n_chan))
                    for k in kind]}


def branch_counts(branches: dict) -> Dict[str, int]:
    """``scenario_adjusted``'s branch counts as ints, every branch of
    ``WALK_BRANCHES`` present."""
    from ddls_tpu_torch.sim.device_env import WALK_BRANCHES

    return {k: int(branches.get(k, 0)) for k in WALK_BRANCHES}


def scenario_episode_diffs(ek, bank: dict, actions, decisions: int):
    """A device episode with a scenario (``ek.dev.scenario``), decision by
    decision as ``make_episode_fn`` runs it, each call of K25 (scenario
    mode) held against its plain version on the decision's own inputs
    (the episode goes on with the kernel's outputs). Returns ``(diff,
    held, trace, branches)``: the largest ``max_difference``, the calls
    held, the trace, and the failure walk's branch counts over every
    lane's walk, counted by the plain version's own walk
    (``branch_counts``)."""
    import torch

    from ddls_tpu_torch.sim import device_env

    dev = ek.dev
    trace = {name: torch.zeros(actions.shape, dtype=want or dev.dtype,
                               device=dev.device)
             for name, want in device_env.TRACE_FIELDS}
    state = ek.init_state(bank, actions)
    diff, held, branches = 0.0, 0, {}
    for d in range(decisions):
        raw = ek.evaluate(state)
        state2 = {k: v.clone() for k, v in state.items()}
        trace2 = {k: v.clone() for k, v in trace.items()}
        device_env.episode_step(ek, state, bank, actions, raw, trace, d)
        device_env.episode_step_plain(ek, state2, bank, actions, raw,
                                      trace2, d, branches=branches)
        diff = max(diff, *(max_difference(state[k], state2[k])
                           for k in state),
                   *(max_difference(trace[k], trace2[k]) for k in trace))
        held += 1
    return diff, held, trace, branch_counts(branches)


# ------------------------------------------------------- device collection
# The reference's device collection recorded
# (scripts/export_torch_device_collect_fixture.py writes it): on the small
# surface of the reference's memo test and at full width on env_load32
# with ppo_device_trained, 2 lanes x 3 segments of its DevicePPOCollector
# (memo off) with the uniforms its key splits drew, the segments' traces,
# next fields, rebuilt observations, bootstrap values and episode records;
# and the reference memo's decisions on a key sequence of the small
# surface, in float32 and float64.
DEVICE_COLLECT_PATH = os.path.join(DATA_DIR, "device_collect_recorded.npz")
DEVICE_COLLECT_SURFACES = ("small", "full")
# the tiny policy of the reference's memo test
MEMO_TINY_ARCH = {"out_features_msg": 4, "out_features_hidden": 8,
                  "out_features_node": 4, "out_features_graph": 4,
                  "fcnet_hiddens": (16,)}


def memo_surface_kwargs(path_to_files: str) -> dict:
    """The env of the reference's memo test (``tests/test_jax_memo.py``
    ``memo_env``: 8 servers, the profiles of
    ``generate_pipedream_txt_files(path, n_cnn=1, n_translation=1, seed=9,
    min_ops=4, max_ops=6)``, pads 32/64, max degree 4)."""
    return dict(
        topology_config={"type": "ramp", "kwargs": {
            "num_communication_groups": 2,
            "num_racks_per_communication_group": 2,
            "num_servers_per_rack": 2, "num_channels": 1,
            "total_node_bandwidth": 1.6e12,
            "intra_gpu_propagation_latency": 50e-9,
            "worker_io_latency": 100e-9}},
        node_config={"type_1": {"num_nodes": 8, "workers_config": [
            {"num_workers": 1, "worker": "A100"}]}},
        jobs_config={"path_to_files": path_to_files,
                     "job_interarrival_time_dist": {
                         "_target_":
                             "ddls_tpu.demands.distributions.Fixed",
                         "val": 60.0},
                     "max_acceptable_job_completion_time_frac_dist": {
                         "_target_":
                             "ddls_tpu.demands.distributions.Uniform",
                         "min_val": 0.2, "max_val": 1.0, "decimals": 2},
                     "replication_factor": 10,
                     "job_sampling_mode": "remove_and_repeat",
                     "num_training_steps": 10},
        max_partitions_per_op=4, min_op_run_time_quantum=0.01,
        reward_function="job_acceptance", max_simulation_run_time=6e2,
        pad_obs_kwargs={"max_nodes": 32, "max_edges": 64})


def memo_lane_records(types: Sequence[str], lane: int, n_jobs: int = 12):
    """Lane ``lane``'s job bank of the reference's memo test
    (``_lane_banks``: models and SLA fractions from ``RandomState(100 +
    lane)``, 10 steps, a job every 60)."""
    r = np.random.RandomState(100 + lane)
    return [{"model": types[int(r.randint(0, len(types)))],
             "num_training_steps": 10,
             "sla_frac": round(float(r.uniform(0.2, 1.0)), 2),
             "time_arrived": 60.0 * i} for i in range(n_jobs)]


def load_device_collect_fixture(path: str = DEVICE_COLLECT_PATH
                                ) -> Dict[str, object]:
    """``{surface: {"types", "banks" {name: [B, J]}, "params" (the flax
    tree, flattened; small only), "collects": [{"uniforms" [B, T, A],
    "trace" {key: [B, T]}, "next" {key: [B]}, "graph_features" [T, B, G],
    "action_mask" [T, B, A], "last_values" [B], "episodes" [records]},
    ...], "reset": the collect after them, in which the lanes' first
    episodes end (full width only; else None)}, "memo": {dtype:
    {...}}}``."""
    import json

    with np.load(path, allow_pickle=False) as data:
        def group(prefix):
            return {k[len(prefix):]: data[k] for k in data.files
                    if k.startswith(prefix)}

        out: Dict[str, object] = {}
        for s in DEVICE_COLLECT_SURFACES:
            def collect(p):
                return {
                    "uniforms": data[p + "uniforms"],
                    "trace": group(p + "trace/"), "next": group(p + "next/"),
                    "graph_features": data[p + "graph_features"],
                    "action_mask": data[p + "action_mask"],
                    "last_values": data[p + "last_values"],
                    "episodes": json.loads(str(data[p + "episodes"]))}

            n = int(data[f"{s}/n_collects"])
            out[s] = {"types": json.loads(str(data[f"{s}/types"])),
                      "banks": group(f"{s}/banks/"),
                      "params": group(f"{s}/params/"),
                      "collects": [collect(f"{s}/c{c}/") for c in range(n)],
                      "reset": (collect(f"{s}/reset/")
                                if f"{s}/reset/uniforms" in data.files
                                else None)}
        out["memo"] = {dt: group(f"memo/{dt}/")
                       for dt in ("float32", "float64")}
        return out


# a collect against its recording: the keys that must be equal, and the
# limits of logp and of the values and bootstrap values (the rollout's: the
# forward's float32 reductions run in another order than XLA's)
COLLECT_EXACT_KEYS = ("action", "reward", "done", "ep_accepted",
                      "ep_blocked", "ep_return", "ep_completed",
                      "ep_arrived", "jtype", "frac", "steps", "n_occupied",
                      "n_running")
LOGP_TOL, VALUES_TOL = 1e-5, 5e-5


def hold_collect(out, rec, steps: Optional[int] = None):
    """A port collect (``DevicePPOCollector.collect``'s output, [T, B]
    host arrays) against a recorded one (``load_device_collect_fixture``'s,
    its trace [B, T]) over the first ``steps`` steps (all by default): the
    exact keys and the actions equal, the rebuilt graph features and masks
    bit-equal, logp within ``LOGP_TOL``, the values within ``VALUES_TOL``;
    over a whole collect also the bootstrap values within ``VALUES_TOL``
    and the episode records equal.

    Returns ``(faults, errs)``: what differs (empty when the collect
    holds) and the largest logp, value and bootstrap differences (the
    last None over a part)."""
    import json

    t = steps or rec["uniforms"].shape[1]
    whole = t == rec["uniforms"].shape[1]
    tb = {k: np.swapaxes(v, 0, 1)[:t] for k, v in rec["trace"].items()}
    faults = [key for key in COLLECT_EXACT_KEYS
              if not np.array_equal(out["trace"][key][:t],
                                    tb[key].astype(out["trace"][key].dtype))]
    if not np.array_equal(out["traj"]["actions"][:t], tb["action"]):
        faults.append("actions")
    for key in ("graph_features", "action_mask"):
        got = out["traj"]["obs"][key][:t]
        if got.dtype != rec[key].dtype or not np.array_equal(
                got, rec[key][:t]):
            faults.append(key)
    errs = [float(np.abs(out["traj"]["logp"][:t] - tb["logp"]).max()),
            float(np.abs(out["traj"]["values"][:t] - tb["value"]).max()),
            None]
    if whole:
        errs[2] = float(np.abs(out["last_values"]
                               - rec["last_values"]).max())
        if json.loads(json.dumps(out["episodes"], sort_keys=True)) \
                != rec["episodes"]:
            faults.append("episodes")
    for name, err, tol in zip(("logp", "values", "last_values"), errs,
                              (LOGP_TOL, VALUES_TOL, VALUES_TOL)):
        if err is not None and not err <= tol:
            faults.append(f"{name} off by {err}")
    return faults, tuple(errs)


# what a step decides besides the exact keys (a collector's trace holds it)
DECISION_KEYS = ("accept", "cause", "jct", "t")


def ended_episode_records(traces: Sequence[dict]) -> Tuple[List[dict],
                                                          List[str]]:
    """The records of the episodes that ended in the last of ``traces``
    (a collector's ``trace`` of every collect from its first, [T, B] host
    arrays), each built from the steps alone: the length counted since
    the lane's previous end, the return the float32 sum of the step
    rewards in step order, with the episode counters at the end step for
    the jobs and the host's denominators (``DevicePPOCollector``'s record).
    Returns ``(records, faults)``: the records in the collector's order,
    and where an episode's counters disagree with its steps (``ep_return``
    against the summed rewards, ``ep_accepted`` against the accepted
    decisions)."""
    done = np.concatenate([tr["done"] for tr in traces])
    reward = np.concatenate([tr["reward"] for tr in traces])
    accept = np.concatenate([tr["accept"] for tr in traces])
    first = len(done) - len(traces[-1]["done"])
    last = traces[-1]
    lanes = done.shape[1]
    begin = np.zeros(lanes, np.int64)
    ret = np.zeros(lanes, np.float32)
    n_acc = np.zeros(lanes, np.int64)
    records, faults = [], []
    for t in range(len(done)):
        ret = (ret + reward[t]).astype(np.float32)
        n_acc += accept[t]
        for b in np.nonzero(done[t])[0]:
            if t >= first:
                s = t - first
                arr = int(last["ep_arrived"][s, b])
                com = int(last["ep_completed"][s, b])
                blk = int(last["ep_blocked"][s, b])
                records.append({
                    "env_index": int(b), "episode_return": float(ret[b]),
                    "episode_length": int(t - begin[b] + 1),
                    "num_jobs_arrived": arr, "num_jobs_completed": com,
                    "num_jobs_blocked": blk,
                    "acceptance_rate": com / arr if arr else 0.0,
                    "blocking_rate": blk / arr if arr else 0.0})
                if last["ep_return"][s, b] != ret[b]:
                    faults.append(f"lane {b} step {s}: ep_return")
                if last["ep_accepted"][s, b] != n_acc[b]:
                    faults.append(f"lane {b} step {s}: ep_accepted")
            begin[b], ret[b], n_acc[b] = t + 1, 0, 0
    return records, faults


def restart_uniforms(uniforms, done) -> Tuple[np.ndarray, np.ndarray]:
    """For a collect's ``uniforms`` [B, T, A] and its ``done`` [T, B]:
    each lane's first end step (-1 where none), and uniforms [B, T, A]
    whose first steps are, for each lane that ended, the lane's uniforms
    after that end (0.5 elsewhere), so that a fresh collector takes the
    steps that those lanes take after their reset."""
    u = np.asarray(uniforms, np.float32)
    d = np.asarray(done)
    out = np.full_like(u, 0.5)
    ends = np.full(u.shape[0], -1, np.int64)
    for b in range(u.shape[0]):
        hit = np.nonzero(d[:, b])[0]
        if len(hit):
            ends[b] = hit[0]
            out[b, :u.shape[1] - hit[0] - 1] = u[b, hit[0] + 1:]
    return ends, out


def restart_faults(trace, fresh_trace, ends) -> Tuple[int, List[str]]:
    """The steps that each lane takes after its first end (``ends``, from
    ``restart_uniforms``) in a collect's ``trace`` against a fresh
    collector's first steps under ``restart_uniforms``' uniforms
    (``fresh_trace``), key by key: the exact keys and the decisions, equal.
    Returns ``(steps compared, what differs)``."""
    steps, faults = 0, []
    T = len(trace["done"])
    for b, s in enumerate(ends):
        k = T - int(s) - 1 if s >= 0 else 0
        steps += k
        for key in COLLECT_EXACT_KEYS + DECISION_KEYS:
            if k and not np.array_equal(trace[key][s + 1:, b],
                                        fresh_trace[key][:k, b],
                                        equal_nan=True):
                faults.append(f"lane {b}: {key}")
    return steps, faults


# the kernels a device-collection step launches besides the replay's
SEGMENT_KERNELS = ("kernel_obs", "episode_prepare", "memo_probe",
                   "memo_insert", "episode_step")


def segment_kernel_diffs(et, ot, model, bank: dict, uniforms, steps: int,
                         memo_cfg=None, *, device="cuda", dtype=None,
                         start: Optional[dict] = None):
    """The first ``steps`` steps of a device-collection segment of the
    stacked ``bank`` with the handed-in ``uniforms`` [B, T, A] (as
    ``device_env.make_segment_fn`` runs them), each call of K26, K25's
    prepare, K27, K28 (with a memo) and K25 with the reset held against
    its plain version on the step's own inputs. The segment goes on with
    the kernels' outputs. It starts from a fresh state and, with
    ``memo_cfg``, an empty memo; or from ``start``, a segment state
    (``segment_init``'s or a collector's ``state``, in ``dtype``: its
    episodes and its memo), which it copies and leaves as it was.

    Returns ``(diffs, held, trace)``: the largest ``max_difference`` per
    kernel (0: bit-equal floats and equal integers), the calls held per
    kernel, and the segment's trace (action, reward, done, the episode
    counters, the fields)."""
    import torch

    from ddls_tpu_torch.models.policy import mask_sample_logp
    from ddls_tpu_torch.sim import device_env as de
    from ddls_tpu_torch.sim import device_memo
    from ddls_tpu_torch.sim import lookahead as lookahead_mod

    dtype = dtype or torch.float32
    ek = de.episode_kernels(et, device=device, dtype=dtype)
    dev = ek.dev
    dobs = de.device_obs(ot, dev)
    b = de.device_bank(bank, dev)
    lanes = b["type"].shape[0]
    if start is None:
        state = ek.init_state(b)
        memo = (None if memo_cfg is None else device_memo.memo_init(
            lanes, dev.pads.n_ops, dev.pads.n_deps, dtype, memo_cfg,
            dev.device))
    else:
        state = {k: v.clone() for k, v in start["env"].items()}
        memo = (None if start["memo"] is None else
                {k: v.clone() for k, v in start["memo"].items()})
    u = de._step_uniforms(uniforms, None, steps, lanes, dobs.n_actions,
                          dev.device)
    kw = dict(device=dev.device)
    trace = {name: torch.zeros((lanes, steps), dtype=want or dtype, **kw)
             for name, want in de.TRACE_FIELDS + de.SEGMENT_TRACE_FIELDS}
    seg_trace = {name: trace[name] for name, _ in de.SEGMENT_TRACE_FIELDS}
    fields = {name: torch.zeros((lanes, steps + 1), dtype=want or dtype,
                                **kw) for name, want in de.OBS_FIELDS}
    for name, value in de.obs_fields(state, b).items():
        fields[name][:, 0] = value
    diffs = dict.fromkeys(SEGMENT_KERNELS, 0.0)
    held = dict.fromkeys(SEGMENT_KERNELS, 0)
    actions = []

    def hold(name, got, want):
        diffs[name] = max(diffs[name], *(max_difference(g, w)
                                         for g, w in zip(got, want)))
        held[name] += 1

    def clone(d):
        return {k: v.clone() for k, v in d.items()}

    tb = dev.t
    with torch.no_grad():
        for d in range(steps):
            f = [fields[name][:, d] for name, _ in de.OBS_FIELDS]
            gf, mask = de.kernel_obs(dobs, *f)
            hold("kernel_obs", (gf, mask), de.kernel_obs_plain(dobs, *f))
            logits, _ = model.trunk(dobs.forward_batch(f[0], gf, mask))
            action, _ = mask_sample_logp(logits, mask, u[d])
            actions.append(action)
            s2 = clone(state)
            de.episode_prepare(ek, state, b, action)
            ek.prepare(s2, b, action)
            hold("episode_prepare", (state["cfg"], state["active"]),
                 (s2["cfg"], s2["active"]))
            cfg, active = state["cfg"], state["active"]
            ots, new_mem, ok_place = de.allocate_job(
                state["mem"], state["srv_job"] < 0, cfg, dev)
            times, is_flow, chan, op_score, dep_score, finite_ok = \
                de.price_and_score(ots, cfg, dev)
            skip = ~active
            if memo is not None:
                probe = device_memo.memo_probe(memo, cfg, active, ots,
                                               tb["op_valid"], times,
                                               et.n_srv)
                want = device_memo.memo_probe_plain(
                    memo, cfg, active, ots, tb["op_valid"], times, et.n_srv)
                hold("memo_probe", [probe[k] for k in sorted(probe)],
                     [want[k] for k in sorted(want)])
                skip = probe["skip"]
            ticks = torch.empty(lanes, dtype=torch.int32, **kw)
            t_step, _, _, _, ok_la = lookahead_mod.lookahead_indexed(
                cfg, ots, op_score, times, is_flow, dep_score, chan, tb,
                num_workers=et.n_srv, num_channels=et.n_chan, ticks=ticks,
                skip=skip)
            if memo is not None:
                memo2, t2, ok2 = clone(memo), t_step.clone(), ok_la.clone()
                device_memo.memo_insert(memo, probe, cfg, active, times,
                                        t_step, ok_la)
                device_memo.memo_insert_plain(memo2, probe, cfg, active,
                                              times, t2, ok2)
                hold("memo_insert", [memo[k] for k in sorted(memo)]
                     + [t_step, ok_la], [memo2[k] for k in sorted(memo2)]
                     + [t2, ok2])
            raw = {"ots": ots, "new_mem": new_mem, "ok_place": ok_place,
                   "is_flow": is_flow, "chan": chan, "finite_ok": finite_ok,
                   "t_step": t_step, "ok_la": ok_la, "ticks": ticks}
            s2, tr2, f2 = clone(state), clone(trace), clone(fields)
            de.episode_step(ek, state, b, None, raw, trace, d,
                            seg_trace=seg_trace, fields=fields, reset=True)
            de.episode_step_plain(
                ek, s2, b, None, raw, tr2, d,
                seg_trace={k: tr2[k] for k in seg_trace}, fields=f2,
                reset=True)
            hold("episode_step",
                 [state[k] for k in sorted(state)]
                 + [trace[k] for k in sorted(trace)]
                 + [fields[k] for k in sorted(fields)],
                 [s2[k] for k in sorted(state)] + [tr2[k] for k in
                                                   sorted(trace)]
                 + [f2[k] for k in sorted(fields)])
    out = {k: v for k, v in trace.items()}
    out["action"] = torch.stack(actions, 1)
    out.update({name: fields[name][:, :steps] for name, _ in de.OBS_FIELDS})
    return diffs, held, out


def fuzzed_price_lanes(et, ot, rng, lanes: int = 96):
    """K30's inputs on lanes of random occupancy, queued jobs and K29
    outputs (numpy, float64), with its edge cases laid out in the first
    lanes: 0 no placeable degree, 1 every degree acceptable, 2 none
    acceptable and every jct tied, 3 one jct equal to the limit, 4 no
    queued job, 5 an ended episode, 6 no free server. Returns ``(state
    {srv_job, queue_row, done}, bank {type, steps, sla_frac}, ok, jct,
    limit)``, ``limit`` the host's ``frac * (sum * steps)`` of each
    lane's queued job."""
    n_deg, n_srv, J = len(et.degrees), et.n_srv, 6
    srv_job = np.where(rng.rand(lanes, n_srv) < rng.uniform(
        0, 0.9, (lanes, 1)), 0, -1).astype(np.int32)
    bank = {"type": rng.randint(0, len(et.types), (lanes, J)).astype(
                np.int32),
            "steps": rng.choice([10.0, 20.0, 37.0], (lanes, J)),
            "sla_frac": np.round(rng.uniform(0.1, 1.0, (lanes, J)), 2)}
    queue_row = rng.randint(0, J, lanes).astype(np.int32)
    done = np.zeros(lanes, bool)
    row = (np.arange(lanes), queue_row)
    limit = bank["sla_frac"][row] * (np.asarray(ot["orig_seq_sum"])[
        bank["type"][row]] * bank["steps"][row])
    ok = rng.rand(lanes, n_deg) < 0.7
    jct = limit[:, None] * rng.choice([0.3, 0.8, 1.0, 1.2, 2.5],
                                      (lanes, n_deg))
    srv_job[:8] = -1                          # every degree allowed
    ok[0] = False                             # no placeable degree
    ok[1], jct[1] = True, limit[1] * 0.5      # every degree acceptable
    ok[2], jct[2] = True, limit[2] * 3.0      # none acceptable, all tied
    ok[3], jct[3, :] = True, limit[3] * 2.0   # ... and the limit exactly
    jct[3, 1] = limit[3]
    queue_row[4] = -1                         # no queued job
    done[5] = True                            # the episode ended
    srv_job[6] = 0                            # no free server
    return ({"srv_job": srv_job, "queue_row": queue_row, "done": done},
            bank, ok, jct, limit)


# the kernels in-kernel candidate pricing adds, by their launch-count
# names: K23 with the state-lane index, K29, and K30 (the oracle) or K26
# with the price block (the price-feature policy)
PRICED_KERNELS = ("allocate_job_indexed", "price_reduce", "oracle_select",
                  "kernel_obs_prices")


def priced_episode_diffs(et, ot, bank: dict, steps: int, model=None,
                         memo_cfg=None, *, device="cuda", dtype=None,
                         at_call=None):
    """The first ``steps`` steps of the OracleJCT episode of the stacked
    ``bank`` (``model`` None, ``device_env.make_oracle_episode_fn``) or of
    ``model``'s greedy price-feature policy episode
    (``make_policy_episode_fn``), with ``memo_cfg`` the decision's memo,
    each call of K23 with the state-lane index, K29, and K30 or K26 with
    the price block held against its plain version on the call's own
    inputs through the episode's ``hold``. On the CPU the wrappers are the
    plain versions, so nothing is held there. ``at_call(d, name, kernel,
    plain)``, where given, is called with each held call's callables at
    step ``d`` before the episode goes on.

    Returns ``(diffs, held, out)``: the largest ``max_difference`` per
    kernel (0: bit-equal floats and equal integers), the calls held per
    kernel, and ``out``: the trace (``ORACLE_TRACE_NAMES``, and for the
    policy ``logp`` and ``value``; [B, steps]), each step's ``price_ok``
    and ``price_jct`` [B, steps, n_deg] and, for the policy, its
    ``price_block`` [B, steps, A] (the observation's last A graph
    features)."""
    import torch

    from ddls_tpu_torch.sim import device_env as de

    dtype = dtype or torch.float32
    bank = {k: v[None] if v.ndim == 1 else v for k, v in bank.items()}
    if model is None:
        fn = de.make_oracle_episode_fn(et, ot, memo_cfg, device=device,
                                       dtype=dtype)
        names = ORACLE_TRACE_NAMES
    else:
        fn = de.make_policy_episode_fn(et, ot, model, greedy=True,
                                       memo_cfg=memo_cfg, device=device,
                                       dtype=dtype)
        names = POLICY_TRACE_NAMES
    n_actions = et.max_action + 1
    compare = torch.device(device).type != "cpu"
    diffs = dict.fromkeys(PRICED_KERNELS, 0.0)
    held = dict.fromkeys(PRICED_KERNELS, 0)
    oks, jcts, blocks = [], [], []

    def hold(d, name, got, kernel, plain):
        if name == "price_reduce":
            oks.append(got[0])
            jcts.append(got[1])
        elif name == "kernel_obs_prices":
            blocks.append(got[0][:, -n_actions:])
        if compare:
            diffs[name] = max(diffs[name], *(max_difference(g, w)
                                             for g, w in zip(got, plain())))
            held[name] += 1
        if at_call is not None:
            at_call(d, name, kernel, plain)

    run = fn(bank, steps=steps, hold=hold)
    out = dict(zip(names, run["trace"]))
    out["price_ok"] = torch.stack(oks, 1)
    out["price_jct"] = torch.stack(jcts, 1)
    if blocks:
        out["price_block"] = torch.stack(blocks, 1)
    return diffs, held, out
