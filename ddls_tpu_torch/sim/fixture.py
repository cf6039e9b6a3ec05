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
from typing import Dict, Sequence

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
                         before_step=None):
    """One host episode of the reference's mixed-action policy
    (``tests/test_jax_episode.py:61-108``: 15% action 0, 40% the largest
    valid action, else a uniform valid one), from ``env.reset(seed)``.
    Works on the JAX package's env and on the port's.

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
        if r < 0.15:
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
            c = state["cfg"].long()
            valid = tb["op_valid"][c]
            plain = lookahead_mod.lookahead_plain(
                tb["op_compute"][c], valid,
                torch.where(valid, raw["ots"], -1), raw["op_score"],
                tb["num_parents"][c], raw["times"], tb["dep_valid"][c],
                tb["dep_src"][c], tb["dep_dst"][c], tb["dep_mutual"][c],
                raw["is_flow"], raw["dep_score"], raw["chan"][:, :, None],
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
