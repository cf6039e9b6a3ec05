"""Declarative, seeded, fingerprinted scenario specs.

Port: a copy of ``ddls_tpu/scenarios/spec.py``. The ``_target_`` paths of
the env kwargs name the port's distributions; the fingerprints hash the
spec's fields only, so they equal the reference's.

One ``ScenarioSpec`` names everything the simulator backends need to
agree on: the fabric (any ``hardware/topologies.py`` ``build_topology``
config), the workload (synthetic graph knobs, arrival process, SLA
distribution), per-server device-speed multipliers and a deterministic
failure schedule.
Everything derived from a spec is a pure function of ``(spec.seed,
fingerprint(spec))``: the failure-window generator is seeded with exactly
that pair, so schedules are bit-reproducible and any spec edit re-keys
them. The arrival process can be the loadgen trace
(``serve/loadgen.py``) via ``arrival={"kind": "loadgen", ...}``.
``scenarios/conformance.py`` drives a spec through the port's backends.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional

import numpy as np

from ddls_tpu_torch.scenarios.failures import (FAILURE_KIND_NAMES,
                                         FAILURE_KIND_TO_EVENT,
                                         ScenarioRuntime)


class ScenarioError(ValueError):
    """A spec failed validation (bad field, overlapping windows, unknown
    resource, scenario features on an unsupported topology)."""


def _canonical_topology() -> dict:
    # the golden-stats shape (tests/test_stats_parity.py): 8 servers,
    # single-channel complete RAMP
    return {"type": "ramp", "kwargs": {
        "num_communication_groups": 2,
        "num_racks_per_communication_group": 2,
        "num_servers_per_rack": 2,
        "num_channels": 1,
        "total_node_bandwidth": 1.6e12,
        "intra_gpu_propagation_latency": 50e-9,
        "worker_io_latency": 100e-9}}


def _canonical_nodes() -> dict:
    return {"type_1": {"num_nodes": 8, "workers_config": [
        {"num_workers": 1, "worker": "A100"}]}}


@dataclasses.dataclass
class ScenarioSpec:
    """The declarative scenario contract. All fields are plain JSON-able
    values; the fingerprint hashes the canonical JSON form, so field
    ORDER never matters but every VALUE does."""

    name: str = "canonical"
    seed: int = 0
    # fabric: any hardware/topologies.py build_topology config
    topology: dict = dataclasses.field(default_factory=_canonical_topology)
    node_config: dict = dataclasses.field(default_factory=_canonical_nodes)
    # workload: graphs/synthetic.py generate_pipedream_txt_files knobs
    jobs: dict = dataclasses.field(default_factory=lambda: {
        "n_cnn": 2, "n_translation": 1, "seed": 0,
        "min_ops": 4, "max_ops": 6})
    # arrival process: {"kind": "fixed", "interarrival": s} or
    # {"kind": "loadgen", <generate_trace knobs>, "time_scale": s}
    arrival: dict = dataclasses.field(default_factory=lambda: {
        "kind": "fixed", "interarrival": 1000.0})
    # SLA (max acceptable JCT frac) distribution
    sla: dict = dataclasses.field(default_factory=lambda: {
        "kind": "uniform", "min": 0.1, "max": 1.0, "decimals": 2})
    replication_factor: int = 10
    num_training_steps: int = 50
    job_sampling_mode: str = "remove_and_repeat"
    # server id -> speed multiplier (1.0 = nominal; <1 slower)
    device_speeds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # either {"windows": [explicit window dicts]} or generator knobs —
    # see resolve_failure_windows
    failures: dict = dataclasses.field(default_factory=dict)
    max_partitions_per_op: int = 8
    min_op_run_time_quantum: float = 0.01
    sim_seconds: float = 2e4
    pad_obs: dict = dataclasses.field(default_factory=lambda: {
        "max_nodes": 64, "max_edges": 256})

    # ------------------------------------------------------------- json
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True,
                          indent=2)

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ScenarioError(f"unknown ScenarioSpec fields: {unknown}")
        return cls(**data)


def spec_fingerprint(spec: ScenarioSpec) -> str:
    """16-hex content fingerprint over the canonical JSON form (same
    convention as serve/loadgen.py trace_fingerprint)."""
    payload = json.dumps(dataclasses.asdict(spec), sort_keys=True,
                         separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


# ---------------------------------------------------------------- validate
_ARRIVAL_KINDS = ("fixed", "loadgen")
_SLA_KINDS = ("uniform", "fixed")
_SAMPLING_MODES = ("replace", "remove", "remove_and_repeat")


def validate_spec(spec: ScenarioSpec) -> None:
    """Static (topology-free) validation; raises ScenarioError. The
    topology-dependent checks (resource ranges, dense-path gating,
    window overlap after generation) live in build_runtime."""
    if not spec.name:
        raise ScenarioError("spec.name must be non-empty")
    if spec.arrival.get("kind") not in _ARRIVAL_KINDS:
        raise ScenarioError(
            f"arrival.kind must be one of {_ARRIVAL_KINDS}, got "
            f"{spec.arrival.get('kind')!r}")
    if spec.sla.get("kind") not in _SLA_KINDS:
        raise ScenarioError(
            f"sla.kind must be one of {_SLA_KINDS}, got "
            f"{spec.sla.get('kind')!r}")
    if spec.job_sampling_mode not in _SAMPLING_MODES:
        raise ScenarioError(
            f"job_sampling_mode must be one of {_SAMPLING_MODES}")
    for sid, mult in spec.device_speeds.items():
        if not (float(mult) > 0.0):
            raise ScenarioError(
                f"device_speeds[{sid!r}] must be > 0, got {mult}")
    if spec.failures:
        known = {"windows", "n_preempt", "n_straggle", "horizon",
                 "preempt_duration", "straggle_duration",
                 "straggle_slowdown"}
        unknown = sorted(set(spec.failures) - known)
        if unknown:
            raise ScenarioError(f"unknown failures keys: {unknown}")
        for w in spec.failures.get("windows", ()):
            if w.get("kind") not in FAILURE_KIND_NAMES:
                raise ScenarioError(
                    f"window kind must be one of "
                    f"{sorted(FAILURE_KIND_NAMES)}, got {w.get('kind')!r}")
            if not (0.0 <= float(w["t0"]) < float(w["t1"])):
                raise ScenarioError(
                    f"window needs 0 <= t0 < t1, got {w}")


# --------------------------------------------------------- failure windows
def resolve_failure_windows(spec: ScenarioSpec, n_servers: int,
                            n_channels: int) -> List[dict]:
    """The deterministic failure schedule: normalized, t0-sorted,
    globally non-overlapping windows ``{"kind": int, "resource": int,
    "t0": f, "t1": f, "rate": f, "event": str}``.

    Explicit form (``failures["windows"]``) is normalized and checked
    for overlap. Generated form partitions ``horizon`` into one slot
    per window and jitters start/duration/resource INSIDE each slot, so
    non-overlap holds by construction; the rng seed is exactly
    ``(spec.seed, fingerprint(spec))`` — bit-reproducible, re-keyed by
    any spec edit.
    """
    f = spec.failures
    if not f:
        return []
    fp = spec_fingerprint(spec)
    out: List[dict] = []
    if "windows" in f:
        for w in f["windows"]:
            kind = FAILURE_KIND_NAMES[w["kind"]]
            if kind == 0:  # worker_preempt
                rate = float(w.get("rate", 0.0))
            else:
                rate = float(w.get("rate", 1.0 / float(w["slowdown"])))
            out.append({"kind": kind, "resource": int(w["resource"]),
                        "t0": float(w["t0"]), "t1": float(w["t1"]),
                        "rate": rate,
                        "event": FAILURE_KIND_TO_EVENT[kind]})
    else:
        n_pre = int(f.get("n_preempt", 0))
        n_str = int(f.get("n_straggle", 0))
        n = n_pre + n_str
        if n == 0:
            return []
        t_lo, t_hi = (float(t) for t in f.get("horizon", (0.0, 1e4)))
        if not (0.0 <= t_lo < t_hi):
            raise ScenarioError(f"failures.horizon needs 0 <= lo < hi, "
                                f"got {(t_lo, t_hi)}")
        rng = np.random.default_rng([int(spec.seed), int(fp[:8], 16)])
        kinds = ([0] * n_pre) + ([1] * n_str)
        kinds = [kinds[i] for i in rng.permutation(n)]
        slot = (t_hi - t_lo) / n
        for i, kind in enumerate(kinds):
            dur_lo, dur_hi = (f.get("preempt_duration", (30.0, 90.0))
                              if kind == 0
                              else f.get("straggle_duration", (60.0, 240.0)))
            dur = min(float(rng.uniform(dur_lo, dur_hi)), 0.9 * slot)
            t0 = t_lo + i * slot + float(rng.uniform(0.0, slot - dur))
            if kind == 0:
                res, rate = int(rng.integers(n_servers)), 0.0
            else:
                s_lo, s_hi = f.get("straggle_slowdown", (2.0, 6.0))
                res = int(rng.integers(n_channels)) if n_channels else 0
                rate = 1.0 / float(rng.uniform(s_lo, s_hi))
            out.append({"kind": kind, "resource": res, "t0": t0,
                        "t1": t0 + dur, "rate": rate,
                        "event": FAILURE_KIND_TO_EVENT[kind]})
    out.sort(key=lambda w: w["t0"])
    for a, b in zip(out, out[1:]):
        if b["t0"] < a["t1"]:
            raise ScenarioError(
                "failure windows must be globally non-overlapping (the "
                f"inflation walk is exact only then): {a} vs {b}")
    return out


# ------------------------------------------------------------ env plumbing
def arrival_dist_config(spec: ScenarioSpec) -> dict:
    a = spec.arrival
    if a["kind"] == "fixed":
        return {"_target_": "ddls_tpu_torch.demands.distributions.Fixed",
                "val": float(a["interarrival"])}
    knobs = {k: v for k, v in a.items() if k != "kind"}
    knobs["_target_"] = ("ddls_tpu_torch.demands.distributions."
                         "LoadgenInterarrival")
    return knobs


def sla_dist_config(spec: ScenarioSpec) -> dict:
    s = spec.sla
    if s["kind"] == "fixed":
        return {"_target_": "ddls_tpu_torch.demands.distributions.Fixed",
                "val": float(s["frac"])}
    return {"_target_": "ddls_tpu_torch.demands.distributions.Uniform",
            "min_val": float(s["min"]), "max_val": float(s["max"]),
            "decimals": s.get("decimals")}


def jobs_config(spec: ScenarioSpec, dataset_dir: Optional[str] = None) -> dict:
    """JobsGenerator config for the spec. Default: the deterministic
    ``synthetic`` path (JobsGenerator generates the graph files itself
    and fingerprints the knobs); ``dataset_dir`` overrides with a
    pre-generated directory."""
    cfg: dict = {
        "job_interarrival_time_dist": arrival_dist_config(spec),
        "max_acceptable_job_completion_time_frac_dist":
            sla_dist_config(spec),
        "replication_factor": int(spec.replication_factor),
        "job_sampling_mode": spec.job_sampling_mode,
        "num_training_steps": int(spec.num_training_steps),
    }
    if dataset_dir is not None:
        cfg["path_to_files"] = dataset_dir
    else:
        cfg["synthetic"] = dict(spec.jobs)
    return cfg


def env_kwargs(spec: ScenarioSpec, dataset_dir: Optional[str] = None,
               sim_seconds: Optional[float] = None) -> dict:
    """RampJobPartitioningEnvironment kwargs for the spec (backend
    selection flags and the scenario runtime are layered on top by
    conformance.build_env)."""
    validate_spec(spec)
    return dict(
        topology_config=spec.topology,
        node_config=spec.node_config,
        jobs_config=jobs_config(spec, dataset_dir=dataset_dir),
        max_partitions_per_op=int(spec.max_partitions_per_op),
        min_op_run_time_quantum=float(spec.min_op_run_time_quantum),
        reward_function="job_acceptance",
        reward_function_kwargs={"fail_reward": -1, "success_reward": 1},
        max_simulation_run_time=(float(sim_seconds) if sim_seconds
                                 is not None else float(spec.sim_seconds)),
        pad_obs_kwargs=dict(spec.pad_obs))


def build_runtime(spec: ScenarioSpec, topology) -> Optional[ScenarioRuntime]:
    """Build the ScenarioRuntime for an instantiated topology — dense
    per-server speeds + resolved windows — or None when the spec is
    nominal (no failure windows, unit speeds), keeping the default hot
    path byte-identical.

    Failure schedules and non-unit speeds are gated to the dense
    single-channel complete topologies (``dense_tables()['pair_channel']
    is not None``): that is where the device episode exists and where
    mounted channels are dense ints, so all four backends can agree on
    resource indexing.
    """
    validate_spec(spec)
    dense = topology.dense_tables()
    server_index = dense["server_index"]
    n_srv = len(server_index)
    n_chan = len(dense["channel_ids"])
    speeds = np.ones(n_srv, dtype=np.float64)
    for sid, mult in spec.device_speeds.items():
        if sid not in server_index:
            raise ScenarioError(
                f"device_speeds names unknown server {sid!r} "
                f"(topology has {sorted(server_index)[:4]}...)")
        speeds[server_index[sid]] = float(mult)
    windows = resolve_failure_windows(spec, n_srv, n_chan)
    if not windows and bool(np.all(speeds == 1.0)):
        return None
    if dense["pair_channel"] is None:
        raise ScenarioError(
            "failure windows / device speeds require the dense single-"
            "channel complete topology (scenario inflation indexes "
            "dense server/channel ids; see docs/scenarios.md)")
    for w in windows:
        bound = n_srv if w["kind"] == 0 else n_chan
        if not (0 <= w["resource"] < bound):
            raise ScenarioError(
                f"window resource out of range for this topology: {w} "
                f"(bound {bound})")
    return ScenarioRuntime(spec.name, spec_fingerprint(spec), speeds,
                           windows)


# ----------------------------------------------------------------- registry
def canonical_spec() -> ScenarioSpec:
    """The single-channel complete-topology RAMP setup every existing
    parity/golden test pins — byte-for-byte the trace_diff defaults."""
    return ScenarioSpec(name="canonical")


def multi_channel_spec() -> ScenarioSpec:
    """Canonical fabric with num_channels=2: exercises the dict-mirror
    dep path (host + C++ + array lookahead); the device episode backend
    does not exist off the dense path, so conformance excludes that
    leg with a reason."""
    spec = ScenarioSpec(name="multi_channel")
    spec.topology["kwargs"]["num_channels"] = 2
    return spec


def failures_spec() -> ScenarioSpec:
    """Canonical fabric + heterogeneous speeds + a generated preempt/
    straggler schedule + the serving loadgen arrival process."""
    return ScenarioSpec(
        name="failures",
        seed=1,
        arrival={"kind": "loadgen", "n_requests": 64, "base_rps": 1.0,
                 "seed": 7, "time_scale": 600.0},
        device_speeds={"0-0-0": 0.8, "1-1-1": 1.25},
        failures={"n_preempt": 2, "n_straggle": 2,
                  "horizon": [1500.0, 15000.0],
                  "preempt_duration": [40.0, 120.0],
                  "straggle_duration": [80.0, 300.0],
                  "straggle_slowdown": [2.0, 6.0]})


REGISTRY = {
    "canonical": canonical_spec,
    "multi_channel": multi_channel_spec,
    "failures": failures_spec,
}


def get_spec(name_or_path: str) -> ScenarioSpec:
    """Resolve a registry name or a spec-JSON file path."""
    if name_or_path in REGISTRY:
        return REGISTRY[name_or_path]()
    import os

    if os.path.exists(name_or_path):
        with open(name_or_path) as fh:
            return ScenarioSpec.from_json(fh.read())
    raise ScenarioError(
        f"unknown scenario {name_or_path!r} — not a registry name "
        f"({sorted(REGISTRY)}) and not a spec-JSON path")
