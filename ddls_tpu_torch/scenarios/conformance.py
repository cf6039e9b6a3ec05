"""Backend conformance: drive one ScenarioSpec through the port's simulator
backends and hold them to each other.

Counterpart of ``ddls_tpu/scenarios/conformance.py`` (``build_env`` :40,
``run_recorded_episode`` :59, ``jitted_decision_events`` :120,
``golden_stats_leg`` :174, ``run_conformance`` :268) and of
``scripts/conformance.py``'s command line. The port has no flight
recorder, so an episode's record is its arrivals (model, training steps,
SLA fraction, time) and one record a decision: the time, the degree,
whether the job was accepted, its canonical cause (``sim/device_env.py``
``CAUSE_CODE_TO_STR``) and its adjusted jct (0 when blocked).

Legs (per spec):

- ``host_native``: the seeded host-engine episode against the C++
  lookahead engine replaying the same actions, rtol 0.
- ``host_jax``: the host against the array lookahead engine
  (``use_jax_lookahead``: K21 on the card, its plain version on the CPU),
  rtol 1e-4 (the reference's tolerance for its array engine).
- ``host_jitted``: the host's decisions against the device episode
  (``sim/device_env.py`` ``make_episode_fn``, float64) replaying the host's
  actions on a bank of the host's arrivals: decisions equal, t and jct
  within rel 1e-9. Skipped, with the reference's reason, off the dense
  single-channel complete topology.
- ``golden``: the spec's fabric reproduces the hand-computed golden stats
  exactly on a single-op job.
- ``lint``: reported unavailable (the lint engine is not ported).

    python -m ddls_tpu_torch.scenarios.conformance --json \\
        [--spec NAME_OR_PATH ...] [--device cpu|cuda]

Exit codes: 0 every leg ok (skipped and unavailable legs are reported and
pass unless ``--strict``), 1 a divergence, 2 a usage error.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ddls_tpu_torch.scenarios.spec import (REGISTRY, ScenarioSpec,
                                           build_runtime, env_kwargs,
                                           get_spec, spec_fingerprint)

HOST_BACKENDS = ("host", "native", "jax")
DEFAULT_LEGS = ("host_native", "host_jax", "host_jitted", "golden", "lint")
# the reference's tolerances: its array engine (f32 packing) and its
# jitted episode under x64
JAX_RTOL = 1e-4
JITTED_RTOL = 1e-9


def build_env(spec: ScenarioSpec, backend: str = "host",
              sim_seconds: Optional[float] = None, device: str = "cuda"):
    """A RampJobPartitioningEnvironment for the spec with the requested
    lookahead backend (``"jax"``: the array engine on ``device``) and the
    spec's ScenarioRuntime attached (None when the spec is nominal)."""
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.hardware.topologies import build_topology

    if backend not in HOST_BACKENDS:
        raise ValueError(f"backend must be one of {HOST_BACKENDS}")
    runtime = build_runtime(spec, build_topology(spec.topology))
    return RampJobPartitioningEnvironment(
        **env_kwargs(spec, sim_seconds=sim_seconds),
        use_jax_lookahead=(backend == "jax"),
        use_native_lookahead=(backend == "native"),
        scenario_runtime=runtime, device=device)


def _decided(cluster, ji: int) -> Tuple[bool, Optional[str], float]:
    """(accepted, canonical cause, adjusted jct) of job ``ji`` once its
    decision's steps ran: accepted when its lookahead was registered (the
    cluster's adjusted-jct ledger holds it, also for a job the episode's
    end swept), else the cause the cluster blocked it with."""
    from ddls_tpu_torch.sim.device_env import (CAUSE_CODE_TO_STR,
                                               CAUSE_STR_TO_CODE)

    if ji in cluster.job_adjusted_jct:
        return True, None, float(cluster.job_adjusted_jct[ji])
    cause = cluster.episode_stats[
        "jobs_blocked_cause_of_unsuccessful_handling"][
        list(cluster.jobs_blocked).index(ji)]
    code = CAUSE_STR_TO_CODE.get(cause)
    return False, (cause if code is None else CAUSE_CODE_TO_STR[code]), 0.0


def _arrival(job) -> dict:
    return {"model": job.details["model"],
            "num_training_steps": int(job.num_training_steps),
            "sla_frac": float(job.max_acceptable_jct_frac),
            "time_arrived": float(job.details["time_arrived"])}


def run_recorded_episode(env, seed: int, actions=None,
                         max_decisions: int = 500) -> Tuple[dict, List[int]]:
    """One seeded episode (reference: :59): the actions drawn uniformly
    from the valid ones by ``RandomState(seed)``, or ``actions`` replayed
    (truncated where the episode ends early or a replayed action is
    invalid). Returns ``({"arrivals", "decisions", "stats"}, actions
    taken)``: the arrivals in order, the decision records and the
    cluster's final ``arrived``, ``blocked`` and ``completed``."""
    obs = env.reset(seed=seed)
    rng = np.random.RandomState(seed)
    cluster = env.cluster
    taken, decisions = [], []
    done = False
    while not done and len(taken) < max_decisions:
        if actions is not None:
            if len(taken) >= len(actions):
                break
            action = int(actions[len(taken)])
        else:
            valid = np.flatnonzero(np.asarray(obs["action_mask"]))
            action = int(rng.choice(valid))
        job = next(iter(cluster.job_queue.jobs.values()))
        ji = cluster.job_id_to_job_idx[job.job_id]
        t_dec = float(cluster.stopwatch.time())
        try:
            obs, _, done, _ = env.step(action)
        except ValueError:
            break  # replayed action invalid here: past a divergence
        cluster = env.cluster
        accepted, cause, jct = _decided(cluster, ji)
        decisions.append({"t": t_dec, "job_idx": ji, "degree": action,
                          "accepted": accepted, "cause": cause, "jct": jct})
        taken.append(action)
    arrivals = []
    for ji in range(cluster.num_jobs_arrived):
        j = (cluster.jobs_running.get(ji) or cluster.jobs_completed.get(ji)
             or cluster.jobs_blocked.get(ji)
             or cluster.job_queue.jobs.get(cluster.job_idx_to_job_id[ji]))
        arrivals.append(_arrival(j.original_job
                                 if j.original_job is not j else j))
    er = cluster.episode_stats
    stats = {"arrived": int(er["num_jobs_arrived"]),
             "blocked": int(er["num_jobs_blocked"]),
             "completed": len(cluster.jobs_completed)}
    return ({"arrivals": arrivals, "decisions": decisions, "stats": stats},
            taken)


def jitted_decision_events(env, record: dict, actions: Sequence[int],
                           device: str = "cuda") -> List[dict]:
    """The host's action sequence replayed through the device episode in
    float64 (reference: :120), its trace as decision records; the bank is
    the host record's own arrivals."""
    import torch

    from ddls_tpu_torch.sim.device_env import (CAUSE_CODE_TO_STR,
                                               build_episode_tables,
                                               build_job_bank,
                                               make_episode_fn)

    et = build_episode_tables(env)
    bank = build_job_bank(et, record["arrivals"])
    out = make_episode_fn(et, device=device, dtype=torch.float64)(
        bank, np.asarray(actions, np.int32))
    reward, accept, cause, jct, t, has_job = (x.cpu().numpy()
                                              for x in out["trace"])
    events = []
    for i, action in enumerate(actions):
        if not has_job[i]:
            break  # the replay ran out of queued jobs (past a divergence)
        accepted = bool(accept[i])
        events.append({"t": float(t[i]), "job_idx": i,
                       "degree": int(action), "accepted": accepted,
                       "cause": CAUSE_CODE_TO_STR[int(cause[i])],
                       "jct": float(jct[i]) if accepted else 0.0})
    return events


def _close(a, b, rtol: float) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))
    return a == b


def first_divergence(a: Sequence[dict], b: Sequence[dict],
                     rtol: float = 0.0) -> Optional[dict]:
    """The first record where two record lists differ (floats within
    ``rtol``, everything else equal), or a length mismatch; None when they
    agree."""
    for i, (x, y) in enumerate(zip(a, b)):
        for key in sorted(set(x) | set(y)):
            if not _close(x.get(key), y.get(key), rtol):
                return {"index": i, "key": key, "a": x, "b": y}
    if len(a) != len(b):
        return {"index": min(len(a), len(b)), "key": "length",
                "a": len(a), "b": len(b)}
    return None


def _jitted_supported(spec: ScenarioSpec):
    from ddls_tpu_torch.hardware.topologies import build_topology

    dense = build_topology(spec.topology).dense_tables()
    if dense["pair_channel"] is None:
        return False, ("jitted episode backend exists only on the dense "
                       "single-channel complete topology")
    return True, None


def golden_stats_leg(spec: ScenarioSpec) -> dict:
    """The spec's fabric must reproduce the hand-computed golden stats
    exactly (reference: :174): one single-op job (fwd 2, bwd 4,
    activation 100, parameter 10) x 5 steps on one worker. The scenario
    runtime is not attached: this leg pins the fabric."""
    from ddls_tpu_torch.agents import (FirstFitDepPlacer,
                                       RampFirstFitOpPlacer,
                                       SRPTDepScheduler, SRPTOpScheduler)
    from ddls_tpu_torch.agents.partitioners import build_partition_action
    from ddls_tpu_torch.sim import (Action, OpPartition,
                                    RampClusterEnvironment)

    fixed = "ddls_tpu_torch.demands.distributions.Fixed"
    with tempfile.TemporaryDirectory() as td:
        with open(os.path.join(td, "tiny.txt"), "w") as fh:
            fh.write("node1 -- Linear(id=1) -- forward_compute_time=2.0, "
                     "backward_compute_time=4.0, activation_size=100.0, "
                     "parameter_size=10.0\n")
        cluster = RampClusterEnvironment(topology_config=spec.topology,
                                         node_config=spec.node_config)
        cluster.reset({
            "path_to_files": td,
            "job_interarrival_time_dist": {"_target_": fixed, "val": 1e6},
            "max_acceptable_job_completion_time_frac_dist": {
                "_target_": fixed, "val": 1.0},
            "replication_factor": 1,
            "num_training_steps": 5,
            "job_sampling_mode": "remove",
        }, max_simulation_run_time=None, seed=0)
        action_map = {}
        for job_id, job in cluster.job_queue.jobs.items():
            action_map[job_id] = build_partition_action(
                job.graph, min_op_run_time_quantum=0.01,
                max_partitions_per_op=1)
        op_partition = OpPartition(action_map, cluster=cluster)
        op_placement = RampFirstFitOpPlacer().get(op_partition, cluster)
        op_schedule = SRPTOpScheduler().get(op_partition, op_placement,
                                            cluster)
        dep_placement = FirstFitDepPlacer().get(op_partition, op_placement,
                                                cluster)
        dep_schedule = SRPTDepScheduler().get(op_partition, dep_placement,
                                              cluster)
        cluster.step(Action(op_partition=op_partition,
                            op_placement=op_placement,
                            op_schedule=op_schedule,
                            dep_placement=dep_placement,
                            dep_schedule=dep_schedule))
        e = cluster.episode_stats
        n_workers = len(cluster.topology.worker_to_server)
        expect = {
            "num_jobs_completed": 1,
            "job_completion_time": [30.0],
            "jobs_completed_total_operation_memory_cost": [220.0],
            "jobs_completed_total_dependency_size": [110.0],
            "jobs_completed_mean_mounted_worker_utilisation_frac": [1.0],
            "episode_time": 30.0,
            "cluster_info_processed": 330.0,
            "demand_total_info_processed": 320.0,
            "mean_cluster_worker_utilisation_frac": 1.0 / n_workers,
        }
        mismatches = {k: {"got": e[k], "want": v}
                      for k, v in expect.items() if e[k] != v}
    leg = {"leg": "golden",
           "status": "ok" if not mismatches else "divergence"}
    if mismatches:
        leg["mismatches"] = mismatches
    return leg


def lint_leg() -> dict:
    return {"leg": "lint", "status": "unavailable",
            "reason": "the lint engine (ddls_tpu/lint) is not ported"}


def run_conformance(spec: ScenarioSpec, seed: int = 0,
                    max_decisions: int = 500,
                    sim_seconds: Optional[float] = None,
                    legs: Optional[Sequence[str]] = None,
                    device: str = "cuda") -> dict:
    """Run the requested legs for one spec (reference: :268); returns a
    JSON-able report whose ``ok`` is True iff no leg diverged (skipped and
    unavailable legs are reported but do not fail). ``device`` is where
    the array engine and the device episode run."""
    legs = tuple(legs) if legs else DEFAULT_LEGS
    unknown = sorted(set(legs) - set(DEFAULT_LEGS))
    if unknown:
        raise ValueError(f"unknown conformance legs {unknown} "
                         f"(choose from {DEFAULT_LEGS})")
    report: dict = {"spec": {"name": spec.name,
                             "fingerprint": spec_fingerprint(spec)},
                    "seed": seed, "device": device, "legs": []}
    host = actions = host_env = None
    if any(l in legs for l in ("host_native", "host_jax", "host_jitted")):
        host_env = build_env(spec, "host", sim_seconds=sim_seconds,
                             device=device)
        host, actions = run_recorded_episode(host_env, seed,
                                             max_decisions=max_decisions)

    def flat(record):
        return ([{"arrival": i, **a} for i, a in
                 enumerate(record["arrivals"])] + record["decisions"]
                + [record["stats"]])

    def trace_leg(name: str, backend: str, rtol: float) -> dict:
        env_b = build_env(spec, backend, sim_seconds=sim_seconds,
                          device=device)
        other, _ = run_recorded_episode(env_b, seed, actions=actions,
                                        max_decisions=max_decisions)
        a, b = flat(host), flat(other)
        div = first_divergence(a, b, rtol)
        leg = {"leg": name, "status": "ok" if div is None
               else "divergence", "rtol": rtol, "events_a": len(a),
               "events_b": len(b), "decisions": len(actions)}
        if div is not None:
            leg["divergence"] = div
        return leg

    for name in legs:
        if name == "host_native":
            from ddls_tpu_torch.native import native_available

            if not native_available():
                report["legs"].append({
                    "leg": name, "status": "unavailable",
                    "reason": "C++ lookahead engine did not build/load"})
            else:
                report["legs"].append(trace_leg(name, "native", 0.0))
        elif name == "host_jax":
            report["legs"].append(trace_leg(name, "jax", JAX_RTOL))
        elif name == "host_jitted":
            supported, reason = _jitted_supported(spec)
            if not supported:
                report["legs"].append({"leg": name, "status": "skipped",
                                       "reason": reason})
                continue
            a = host["decisions"]
            b = jitted_decision_events(host_env, host, actions, device)
            div = first_divergence(a, b, JITTED_RTOL)
            leg = {"leg": name, "status": "ok" if div is None
                   else "divergence", "rtol": JITTED_RTOL,
                   "events_a": len(a), "events_b": len(b),
                   "decisions": len(actions)}
            if div is not None:
                leg["divergence"] = div
            report["legs"].append(leg)
        elif name == "golden":
            report["legs"].append(golden_stats_leg(spec))
        elif name == "lint":
            report["legs"].append(lint_leg())
    report["ok"] = all(l["status"] in ("ok", "skipped", "unavailable")
                       for l in report["legs"])
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="run scenario conformance across the port's simulator "
                    "backends")
    parser.add_argument("--spec", nargs="*", default=None,
                        help="registry names or spec-JSON paths "
                             f"(default: all of {sorted(REGISTRY)})")
    parser.add_argument("--legs", nargs="*", default=None,
                        choices=list(DEFAULT_LEGS),
                        help="restrict to these legs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-decisions", type=int, default=500)
    parser.add_argument("--sim-seconds", type=float, default=None,
                        help="override the spec's episode horizon")
    parser.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                        help="where the array engine and the device "
                             "episode run (default: the card)")
    parser.add_argument("--json", action="store_true",
                        help="emit one machine-readable JSON document")
    parser.add_argument("--strict", action="store_true",
                        help="treat skipped/unavailable legs as failures")
    args = parser.parse_args(argv)

    names = args.spec if args.spec else sorted(REGISTRY)
    reports = []
    for name in names:
        try:
            spec = get_spec(name)
        except Exception as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        reports.append(run_conformance(
            spec, seed=args.seed, max_decisions=args.max_decisions,
            sim_seconds=args.sim_seconds, legs=args.legs,
            device=args.device))
    passing = ("ok",) if args.strict else ("ok", "skipped", "unavailable")
    ok = all(leg["status"] in passing
             for r in reports for leg in r["legs"])
    doc = {"ok": ok, "specs": reports}
    if args.json:
        print(json.dumps(doc, indent=2, default=str))
    else:
        for r in reports:
            print(f"spec {r['spec']['name']} "
                  f"(fp {r['spec']['fingerprint']}):")
            for leg in r["legs"]:
                line = f"  {leg['leg']:<12} {leg['status']}"
                if leg.get("reason"):
                    line += f" ({leg['reason']})"
                if "events_a" in leg:
                    line += (f" [{leg['events_a']} vs {leg['events_b']} "
                             f"records, {leg['decisions']} decisions, "
                             f"rtol={leg['rtol']}]")
                print(line)
                if leg.get("divergence"):
                    print(f"    {leg['divergence']}")
                for k, v in leg.get("mismatches", {}).items():
                    print(f"    {k}: got {v['got']} want {v['want']}")
        print("CONFORMANCE " + ("OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
