"""The port's scenario subsystem (``ddls_tpu_torch/scenarios``, the loadgen
trace, ``LoadgenInterarrival``, the cluster's inflation, the loop's
``scenario`` option and the device episode's failure walk) against the JAX
package, in process, on the CPU:

(a) fingerprints, JSON round trips, the validator's rejections, the
    failure schedules and the loadgen traces equal the reference's (and
    the recording of ``scripts/export_torch_scenario_fixture.py``) bit for
    bit; overlapping explicit windows are refused;
(b) ``inflate_duration`` hand-computed and equal to the reference's on the
    recorded fuzz; the device walk's plain version (``sim/device_env.py``
    ``scenario_adjusted``) bit-equal to ``jax.jit(inflate_duration_jax)``
    in float32 and to the host walk in float64 on the same rows;
(c) the host failure episode deterministic, its adjusted jcts equal to the
    reference env's and its decisions to the reference's recorded ones;
    ``build_episode_tables`` keeps the scenario as the reference's does;
(d) the port's conformance harness: ``host_native``, ``host_jax`` (the
    array engine's plain version), ``host_jitted`` (the device episode's
    plain versions, float64) and ``golden`` ok on the three registry
    specs, ``multi_channel``'s jitted leg skipped with the reason, lint
    unavailable; the device replay of the recorded failures episode equal
    to the recorded x64 ``jitted_decision_events``;
(e) the loop: the canonical spec's env config equals the hand-built one
    (no runtime), a failure spec carries its runtime into every env, the
    subprocess workers' episodes included;
(f) C1's bank (three ticks of four completions) and the full-width
    recording's first decisions through the plain versions, bit-equal in
    float32 to the recorded JAX replays.
"""
import copy
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ddls_tpu.scenarios as ref
from ddls_tpu.hardware.topologies import build_topology as ref_topology
from ddls_tpu.scenarios.conformance import build_env as ref_build_env
from ddls_tpu.sim import jax_env
from ddls_tpu_torch import scenarios as port
from ddls_tpu_torch.demands.distributions import LoadgenInterarrival
from ddls_tpu_torch.hardware.topologies import build_topology
from ddls_tpu_torch.scenarios import conformance
from ddls_tpu_torch.scenarios.failures import inflate_duration
from ddls_tpu_torch.serve import loadgen
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.fixture import (FULL_SCENARIO_PATH, TRACE_NAMES,
                                        branch_counts, fuzz_walk,
                                        load_scenario_fixture)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import export_torch_scenario_fixture as scenario_export  # noqa: E402

SPECS = ("canonical", "failures", "multi_channel", "failures_load32")
# the float64 replay against the host and the recorded x64 replay
EPISODE_REL = 1e-9
# the full-width recording's decisions replayed on the CPU
FULL_PREFIX = 12


@pytest.fixture(scope="module")
def fx():
    return load_scenario_fixture()


def _spec(lib, name):
    return lib.get_spec(FULL_SCENARIO_PATH if name == "failures_load32"
                        else name)


# ------------------------------------------------------------ (a) specs
@pytest.mark.parametrize("name", SPECS)
def test_fingerprint_windows_runtime_equal_reference(fx, name):
    spec, want = _spec(port, name), _spec(ref, name)
    rec = fx["specs"][name]
    assert port.spec_fingerprint(spec) == ref.spec_fingerprint(want) \
        == rec["fingerprint"]
    again = port.ScenarioSpec.from_json(spec.to_json())
    assert again == spec and spec.to_json() == want.to_json()
    n_srv, n_chan = int(rec["n_servers"]), int(rec["n_channels"])
    windows = port.resolve_failure_windows(spec, n_srv, n_chan)
    assert windows == ref.resolve_failure_windows(want, n_srv, n_chan)
    for key in ("kind", "resource", "t0", "t1", "rate"):
        np.testing.assert_array_equal(
            np.array([w[key] for w in windows]).reshape(-1),
            rec["windows"][key])
    assert [w["event"] for w in windows] == rec["windows"]["event"]
    runtime = port.build_runtime(spec, build_topology(spec.topology))
    assert (runtime is None) == rec["nominal"]
    if runtime is not None:
        for key, value in rec["runtime"].items():
            np.testing.assert_array_equal(np.asarray(getattr(runtime, key)),
                                          value)
        # the spawned env workers receive it through pickle
        back = pickle.loads(pickle.dumps(runtime))
        assert back.windows == runtime.windows
        np.testing.assert_array_equal(back.speeds, runtime.speeds)
    got = json.dumps(port.env_kwargs(spec), sort_keys=True)
    assert got == rec["env_kwargs"]


def test_fingerprint_sensitive_and_registry_resolution(tmp_path):
    base = port.spec_fingerprint(port.canonical_spec())
    edited = port.canonical_spec()
    edited.topology["kwargs"]["num_channels"] = 2
    assert port.spec_fingerprint(edited) != base
    edited = port.canonical_spec()
    edited.seed = 1
    assert port.spec_fingerprint(edited) != base
    assert sorted(port.REGISTRY) == ["canonical", "failures",
                                     "multi_channel"]
    path = tmp_path / "spec.json"
    path.write_text(port.failures_spec().to_json())
    assert port.get_spec(str(path)) == port.failures_spec()
    with pytest.raises(port.ScenarioError, match="unknown scenario"):
        port.get_spec("no_such_scenario")
    data = json.loads(port.canonical_spec().to_json())
    data["surprise"] = 1
    with pytest.raises(port.ScenarioError, match="unknown ScenarioSpec"):
        port.ScenarioSpec.from_json(json.dumps(data))


@pytest.mark.parametrize("mutate, match", [
    (lambda s: s.arrival.update(kind="bursty"), "arrival.kind"),
    (lambda s: s.sla.update(kind="exotic"), "sla.kind"),
    (lambda s: setattr(s, "job_sampling_mode", "remove_twice"),
     "job_sampling_mode"),
    (lambda s: s.device_speeds.update({"0-0-0": 0.0}), "must be > 0"),
    (lambda s: s.failures.update({"n_preempt": 1, "surprise": 2}),
     "unknown failures keys"),
    (lambda s: s.failures.update(
        {"windows": [{"kind": "meteor", "resource": 0,
                      "t0": 1.0, "t1": 2.0}]}), "window kind"),
    (lambda s: s.failures.update(
        {"windows": [{"kind": "worker_preempt", "resource": 0,
                      "t0": 5.0, "t1": 2.0}]}), "t0 < t1"),
])
def test_validator_rejections(mutate, match):
    spec = port.canonical_spec()
    mutate(spec)
    with pytest.raises(port.ScenarioError, match=match):
        port.validate_spec(spec)


def test_failure_schedule_bit_reproducible_and_rekeyed():
    spec = port.failures_spec()
    a = port.resolve_failure_windows(spec, 8, 28)
    assert a == port.resolve_failure_windows(copy.deepcopy(spec), 8, 28)
    assert len(a) == 4
    for w, nxt in zip(a, a[1:]):
        assert w["t1"] <= nxt["t0"]
    rekeyed = port.failures_spec()
    rekeyed.seed = 2
    assert port.resolve_failure_windows(rekeyed, 8, 28) != a
    assert port.resolve_failure_windows(rekeyed, 8, 28) == \
        ref.resolve_failure_windows(
            ref.ScenarioSpec.from_json(rekeyed.to_json()), 8, 28)


def test_explicit_overlapping_windows_rejected():
    spec = port.canonical_spec()
    spec.failures = {"windows": [
        {"kind": "worker_preempt", "resource": 0, "t0": 10.0, "t1": 50.0},
        {"kind": "channel_straggle", "resource": 1, "t0": 40.0,
         "t1": 80.0, "slowdown": 2.0}]}
    with pytest.raises(port.ScenarioError, match="non-overlapping"):
        port.resolve_failure_windows(spec, 8, 28)


def test_loadgen_traces_and_gaps_equal_reference(fx):
    from ddls_tpu.demands.distributions import \
        LoadgenInterarrival as RefLoadgen
    from ddls_tpu.serve import loadgen as ref_loadgen

    for kw in ({"n_requests": 64, "base_rps": 1.0, "seed": 7},
               {"n_requests": 300, "base_rps": 2.5, "seed": 3,
                "diurnal_amplitude": 0.0, "burst_factor": 1.0}):
        got = loadgen.generate_trace(**kw)
        want = ref_loadgen.generate_trace(**kw)
        loadgen.validate_trace(got)
        assert got["meta"] == want["meta"] and got["tenant"] == \
            want["tenant"]
        for key in ("arrival_s", "size_frac"):
            np.testing.assert_array_equal(got[key], want[key])
        assert loadgen.trace_fingerprint(got) == \
            ref_loadgen.trace_fingerprint(want)
    bad = loadgen.generate_trace(8, 1.0)
    bad["arrival_s"] = bad["arrival_s"][::-1]
    with pytest.raises(ValueError, match="non-decreasing"):
        loadgen.validate_trace(bad)
    for name, rec in fx["specs"].items():
        if rec["loadgen"] is None:
            continue
        spec = _spec(port, name)
        knobs = {k: v for k, v in spec.arrival.items() if k != "kind"}
        a, b = LoadgenInterarrival(**knobs), RefLoadgen(**knobs)
        assert a.trace_fingerprint == b.trace_fingerprint == \
            rec["loadgen"]["fingerprint"]
        np.testing.assert_array_equal(a._gaps, rec["loadgen"]["gaps"])
        n = len(a._gaps) * 2 + 3                     # cycles past the end
        assert [a.sample() for _ in range(n)] == \
            [b.sample() for _ in range(n)]
    kw = dict(n_requests=64, base_rps=1.0, seed=7, time_scale=600.0)
    assert LoadgenInterarrival(**{**kw, "seed": 8}).trace_fingerprint != \
        LoadgenInterarrival(**kw).trace_fingerprint


# ------------------------------------------------------ (b) the walk
def test_inflate_duration_hand_computed():
    t0, t1 = np.asarray([10.0]), np.asarray([20.0])
    rate = np.asarray([0.0])
    assert inflate_duration(0.0, 15.0, 1.0, t0, t1, rate,
                            [True]) == pytest.approx(25.0)
    assert inflate_duration(0.0, 5.0, 1.0, t0, t1, rate, [True]) == 5.0
    assert inflate_duration(0.0, 15.0, 1.0, t0, t1, rate, [False]) == 15.0
    rate = np.asarray([0.5])
    assert inflate_duration(0.0, 20.0, 1.0, t0, t1, rate,
                            [True]) == pytest.approx(25.0)
    assert inflate_duration(0.0, 4.0, 0.5, t0[:0], t1[:0], rate[:0],
                            []) == pytest.approx(8.0)


def _fuzz_rows(fz):
    G = fz["t0"].shape[0]
    return G, len(fz["t"]) // G, np.arange(len(fz["t"])) // (
        len(fz["t"]) // G)


def test_inflate_duration_equals_reference_on_fuzz(fx):
    from ddls_tpu.scenarios.failures import \
        inflate_duration as ref_inflate

    fz = fx["fuzz"]
    _, _, g_of = _fuzz_rows(fz)
    got, want = [], []
    for i, g in enumerate(g_of):
        args = (float(fz["t"][i]), float(fz["nominal"][i]),
                float(fz["r0"][i]), fz["t0"][g], fz["t1"][g],
                fz["rate"][g], [bool(a) for a in fz["affects"][i]])
        got.append(inflate_duration(*args))
        want.append(ref_inflate(*args))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, fz["host"])
    assert all(v > 0 for k, v in fz["branches"].items()), fz["branches"]


def test_plain_walk_bit_equal_to_jitted_reference(fx):
    """float32: the jitted reference walk, bit for bit (XLA fuses none of
    its expressions); float64: the host walk, bit for bit, and the x64
    jitted walk; the walk's own branch counts in float64 equal the
    recorded ones."""
    fz = fx["fuzz"]
    got32 = fuzz_walk(fz, torch.float32)
    assert got32.dtype == fz["jit_f32"].dtype
    np.testing.assert_array_equal(got32, fz["jit_f32"])
    assert np.isnan(got32).any() and np.isinf(got32).any()
    counted = {}
    got64 = fuzz_walk(fz, torch.float64, counted)
    assert branch_counts(counted) == fz["branches"]
    np.testing.assert_array_equal(got64, fz["host"])
    np.testing.assert_array_equal(got64, fz["jit_x64"])


def test_plain_walk_matches_a_fresh_jax_jit_on_new_rows():
    """Rows the recording does not hold: the plain walk against
    ``jax.jit(inflate_duration_jax)`` in float32, in process."""
    from ddls_tpu.scenarios.failures import inflate_duration_jax

    fz = scenario_export.fuzz_inputs(seed=29)
    _, _, g_of = _fuzz_rows(fz)
    W = fz["t0"].shape[1]
    fn = jax.jit(jax.vmap(lambda t, n, r0, a, b, c, aff: inflate_duration_jax(
        t, n, r0, a, b, c, [aff[i] for i in range(W)])))
    want = np.asarray(fn(*(jnp.asarray(fz[k], jnp.float32)
                           for k in ("t", "nominal", "r0")),
                         *(jnp.asarray(fz[k][g_of], jnp.float32)
                           for k in ("t0", "t1", "rate")),
                         jnp.asarray(fz["affects"])))
    np.testing.assert_array_equal(fuzz_walk(fz, torch.float32), want)


# ------------------------------------------------- (c) host episode
def _port_failures_env(**kw):
    spec = port.failures_spec()
    return conformance.build_env(spec, "host", device="cpu", **kw)


def test_host_failure_episode_deterministic_and_equal_reference(fx):
    from ddls_tpu.scenarios.conformance import run_recorded_episode as \
        ref_episode

    rec = fx["failures"]
    env_a, env_b = _port_failures_env(), _port_failures_env()
    a, acts_a = conformance.run_recorded_episode(env_a, 0, max_decisions=120)
    b, acts_b = conformance.run_recorded_episode(env_b, 0, max_decisions=120)
    assert a == b and acts_a == acts_b
    np.testing.assert_array_equal(acts_a, rec["actions"])
    host = rec["host"]
    d = a["decisions"]
    for key in ("t", "jct"):
        np.testing.assert_array_equal([x[key] for x in d], host[key])
    for key in ("job_idx", "degree", "accepted"):
        np.testing.assert_array_equal([int(x[key]) for x in d], host[key])
    np.testing.assert_array_equal(
        [device_env.CAUSE_STR_TO_CODE.get(x["cause"], 0) for x in d],
        host["cause"])
    ref_env = ref_build_env(ref.failures_spec(), "host")
    ref_episode(ref_env, 0, max_decisions=120)
    assert env_a.cluster.job_adjusted_jct == ref_env.cluster.job_adjusted_jct
    nominal = {ji: j.details["nominal_lookahead_jct"]
               for ji, j in env_a.cluster.jobs_completed.items()}
    inflated = [ji for ji, v in nominal.items()
                if env_a.cluster.job_adjusted_jct[ji] != v]
    assert len(inflated) > len(nominal) // 2
    # the tables keep the scenario as the reference's do
    et = device_env.build_episode_tables(env_a)
    want = jax_env.build_episode_tables(ref_env).scenario
    for key in ("speeds", "t0", "t1", "rate"):
        np.testing.assert_array_equal(et.scenario[key], want[key])
        assert et.scenario[key].dtype == want[key].dtype
    assert et.scenario["kind"] == want["kind"]
    assert et.scenario["res"] == want["res"]
    nominal_env = conformance.build_env(port.canonical_spec(), "host",
                                        device="cpu")
    nominal_env.reset(seed=0)
    assert device_env.build_episode_tables(nominal_env).scenario is None


# ------------------------------------------------- (d) conformance
@pytest.mark.parametrize("name", ("canonical", "failures", "multi_channel"))
def test_conformance_legs(name):
    report = conformance.run_conformance(port.get_spec(name), seed=0,
                                         max_decisions=120, device="cpu")
    assert report["ok"], report
    status = {l["leg"]: l for l in report["legs"]}
    for leg in ("host_native", "host_jax", "golden"):
        assert status[leg]["status"] == "ok", status[leg]
    assert status["lint"]["status"] == "unavailable"
    if name == "multi_channel":
        assert status["host_jitted"]["status"] == "skipped"
        assert "single-channel" in status["host_jitted"]["reason"]
    else:
        assert status["host_jitted"]["status"] == "ok"
        assert status["host_jitted"]["decisions"] > 10


def test_conformance_cli_exit_codes(capsys):
    assert conformance.main(["--spec", "canonical", "--legs", "golden",
                             "lint", "--device", "cpu", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["specs"][0]["spec"]["name"] == "canonical"
    assert conformance.main(["--spec", "canonical", "--legs", "lint",
                             "--device", "cpu", "--strict"]) == 1
    capsys.readouterr()
    assert conformance.main(["--spec", "no_such_spec", "--device",
                             "cpu"]) == 2


def test_first_divergence_names_the_record():
    a = [{"t": 1.0, "accepted": True}, {"t": 2.0, "accepted": False}]
    b = [{"t": 1.0, "accepted": True}, {"t": 2.0 * (1 + 1e-6),
                                        "accepted": False}]
    assert conformance.first_divergence(a, a) is None
    assert conformance.first_divergence(a, b, 1e-5) is None
    div = conformance.first_divergence(a, b, 1e-9)
    assert div["index"] == 1 and div["key"] == "t"
    assert conformance.first_divergence(a, a[:1])["key"] == "length"


def test_failures_device_replay_equals_recorded_jitted(fx):
    rec = fx["failures"]
    env = _port_failures_env()
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    assert et.types == rec["types"]
    out = device_env.make_episode_fn(et, device="cpu",
                                     dtype=torch.float64)(
        rec["bank"], rec["actions"])
    reward, accept, cause, jct, t, has_job = (x.numpy()
                                              for x in out["trace"])
    want = rec["jitted"]
    n = len(want["t"])
    assert has_job[:n].all()
    np.testing.assert_array_equal(accept[:n], want["accepted"])
    np.testing.assert_array_equal(cause[:n], want["cause"])
    np.testing.assert_allclose(t[:n], want["t"], rtol=EPISODE_REL, atol=0)
    got_jct = np.where(accept[:n], jct[:n], 0.0)
    np.testing.assert_allclose(got_jct, want["jct"], rtol=EPISODE_REL,
                               atol=0)
    np.testing.assert_allclose(want["jct"], rec["host"]["jct"],
                               rtol=EPISODE_REL, atol=0)


# ------------------------------------------------------------ (e) loop
_ENV_CLS = ("ddls_tpu_torch.envs.partitioning_env."
            "RampJobPartitioningEnvironment")
_TINY_MODEL = {"fcnet_hiddens": [16],
               "custom_model_config": {"out_features_msg": 4,
                                       "out_features_hidden": 8,
                                       "out_features_node": 4,
                                       "out_features_graph": 4}}


def _overrides(dataset_dir):
    """Each key REPLACES the spec's top-level key wholesale."""
    return dict(
        jobs_config={
            "path_to_files": dataset_dir,
            "job_interarrival_time_dist": {
                "_target_": "ddls_tpu.demands.distributions.Fixed",
                "val": 100.0},
            "replication_factor": 4,
            "job_sampling_mode": "remove_and_repeat",
            "num_training_steps": 2},
        max_partitions_per_op=4,
        max_simulation_run_time=5e4,
        pad_obs_kwargs={"max_nodes": 32, "max_edges": 64})


def _loop(scenario, env_config, parallel=False, loop_mode="pipelined"):
    from ddls_tpu_torch.train.loops import make_epoch_loop

    return make_epoch_loop(
        "ppo", path_to_env_cls=_ENV_CLS, env_config=env_config,
        model=_TINY_MODEL,
        algo_config={"train_batch_size": 4, "sgd_minibatch_size": 2,
                     "num_sgd_iter": 1, "num_workers": 2},
        num_envs=2, rollout_length=2, n_devices=1,
        use_parallel_envs=parallel, evaluation_interval=None, seed=0,
        loop_mode=loop_mode, scenario=scenario, device="cpu")


def test_loop_canonical_scenario_equals_hand_built_config(dataset_dir):
    spec = port.canonical_spec()
    loop = _loop("canonical", _overrides(dataset_dir),
                 loop_mode="sequential")
    try:
        expected = dict(port.env_kwargs(spec))
        expected.update(_overrides(dataset_dir))
        assert loop.env_config == expected
        assert json.dumps(loop.env_config, sort_keys=True) == \
            json.dumps(expected, sort_keys=True)
        assert "scenario_runtime" not in loop.env_config
        assert loop.scenario_fingerprint == port.spec_fingerprint(spec)
    finally:
        loop.close()


def _episode_records(vec, steps: int):
    vec.reset()
    for _ in range(steps):
        masks = vec.stacked_obs()["action_mask"]
        vec.step(np.array([np.flatnonzero(m)[-1] for m in masks]))
    return vec.drain_completed_episodes()


def _first_episodes(records):
    """Each env's first episode record, without its env index."""
    first = {}
    for r in records:
        first.setdefault(r["env_index"], {k: v for k, v in r.items()
                                          if k != "env_index"})
    return [first[i] for i in sorted(first)]


def test_loop_failure_scenario_carries_runtime(dataset_dir):
    """A spec instance, a registry name and a spec-JSON path each give the
    loop the runtime (an explicit env_config key replaces the spec's); the
    in-process env holds it, and the loop's spawned workers run the
    episodes of in-process envs with it, not those without it."""
    from ddls_tpu_torch.rl.rollout import ParallelVectorEnv, VectorEnv
    from ddls_tpu_torch.utils.common import get_class_from_path

    spec = port.failures_spec()
    loop = _loop(spec, _overrides(dataset_dir))
    try:
        rt = loop.env_config["scenario_runtime"]
        assert rt.fingerprint == port.spec_fingerprint(spec)
        assert loop.vec_env.envs[0].cluster.scenario_runtime is rt
        assert loop.scenario_fingerprint == port.spec_fingerprint(spec)
        assert loop.env_config["jobs_config"] == \
            _overrides(dataset_dir)["jobs_config"]
    finally:
        loop.close()
    loop = _loop(FULL_SCENARIO_PATH, _overrides(dataset_dir))
    try:
        assert loop.env_config["scenario_runtime"].fingerprint == \
            port.spec_fingerprint(port.get_spec(FULL_SCENARIO_PATH))
    finally:
        loop.close()
    loop = _loop("failures", {}, parallel=True)
    try:
        assert isinstance(loop.vec_env, ParallelVectorEnv)
        workers = _episode_records(loop.vec_env, 120)
        cfg = loop.env_config
    finally:
        loop.close()
    # one in-process env a seed (in-process envs share the global random
    # streams; each worker has its own)
    env_cls = get_class_from_path(_ENV_CLS)
    nominal_cfg = {k: v for k, v in cfg.items() if k != "scenario_runtime"}
    inproc, nominal = [], []
    for seed in (0, 1):
        inproc += _first_episodes(_episode_records(VectorEnv(
            [lambda: env_cls(**cfg)], seeds=[seed]), 60))
        nominal += _first_episodes(_episode_records(VectorEnv(
            [lambda: env_cls(**nominal_cfg)], seeds=[seed]), 60))
    assert len(inproc) == 2 and _first_episodes(workers) == inproc
    assert inproc != nominal


def test_device_collector_loop_takes_the_scenario():
    """The sequential host loop and ``device_collector: true`` under the
    failures spec: the host env and the collector's tables carry the
    runtime, the collection steps the walk (the plain K25 on the CPU), and
    an epoch trains."""
    from ddls_tpu_torch.rl.ppo_device import DevicePPOCollector
    from ddls_tpu_torch.train.loops import make_epoch_loop

    loop = _loop("failures", {}, loop_mode="sequential")
    try:
        assert loop.vec_env.envs[0].cluster.scenario_runtime is \
            loop.env_config["scenario_runtime"]
    finally:
        loop.close()

    loop = make_epoch_loop(
        "ppo", path_to_env_cls=_ENV_CLS, env_config={}, model=_TINY_MODEL,
        algo_config={"device_collector": True, "train_batch_size": 16,
                     "sgd_minibatch_size": 8, "num_sgd_iter": 1},
        num_envs=2, rollout_length=8, evaluation_interval=None, seed=0,
        loop_mode="sequential", scenario="failures", device="cpu")
    try:
        col = loop.collector
        assert isinstance(col, DevicePPOCollector)
        assert col.et.scenario is not None
        rt = loop.env_config["scenario_runtime"]
        np.testing.assert_array_equal(col.et.scenario["t0"], rt.win_t0)
        res = loop.run()
        assert res["env_steps_this_iter"] == 16
        assert np.isfinite(res["learner"]["total_loss"])
    finally:
        loop.close()


# ----------------------------------------- (f) C1 and the full width
def _trace_equal(out, want, rows=None, prefix=None):
    for name, got in zip(TRACE_NAMES, out["trace"]):
        ref_arr = want["trace"][name]
        ref_arr = ref_arr if rows is None else ref_arr[rows]
        ref_arr = ref_arr if prefix is None else ref_arr[..., :prefix]
        np.testing.assert_array_equal(got.numpy(), ref_arr, err_msg=name)


def test_c1_bank_bit_equal_to_recording(fx):
    """Three ticks of four completions each: the freed memory summed in
    slot order equals XLA's ``completions @ slot_mem`` (each server is
    held by at most one slot, so a column never sums two nonzero
    terms)."""
    rec = fx["c1"]
    env = conformance.build_env(port.canonical_spec(), "host",
                                device="cpu")
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    assert et.types == rec["types"]
    ek = device_env.episode_kernels(et, device="cpu", dtype=torch.float32)
    bank = {k: torch.from_numpy(np.ascontiguousarray(rec["bank"][k][None]))
            .to(want or torch.float32) for k, want in device_env.BANK_FIELDS}
    acts = torch.from_numpy(rec["actions"][None].astype(np.int32))
    state = ek.init_state(bank, acts)
    trace = {name: torch.zeros(acts.shape, dtype=want or torch.float32)
             for name, want in device_env.TRACE_FIELDS}
    ticks = []
    for d in range(acts.shape[1]):
        before = int(state["completed"][0])
        raw = ek.evaluate(state)
        device_env.episode_step(ek, state, bank, acts, raw, trace, d)
        ticks.append(int(state["completed"][0]) - before)
    assert ticks.count(4) == 3, ticks
    for name in TRACE_NAMES:
        np.testing.assert_array_equal(trace[name][0].numpy(),
                                      rec["f32"]["trace"][name][0],
                                      err_msg=name)
    for name in ("accepted", "blocked", "completed", "ret", "t", "done"):
        np.testing.assert_array_equal(state[name].numpy(),
                                      rec["f32"]["counters"][name],
                                      err_msg=name)
    assert int(state["completed"][0]) == 12


def _full_env():
    env = conformance.build_env(port.get_spec(FULL_SCENARIO_PATH), "host",
                                device="cpu")
    env.reset(seed=0)
    return env


def test_full_width_prefix_bit_equal_to_recording(fx):
    """The full-width spec's first decisions of both banks at 2 lanes
    (float32, bit-equal to the recorded JAX replays) and of bank 0 in
    float64 (within 1e-9 of the recorded x64 replay); each plain K25 call
    of the float32 lanes equal to the recording's trace as it goes."""
    rec = fx["full"]
    et = device_env.build_episode_tables(_full_env())
    assert et.types == rec["types"]
    assert et.scenario is not None and len(et.scenario["kind"]) == 32
    acts = rec["actions"][:FULL_PREFIX]
    f32 = device_env.make_episode_fn(et, device="cpu", dtype=torch.float32)
    out = f32(rec["banks"], np.stack([acts, acts]))
    _trace_equal(out, rec["f32"], prefix=FULL_PREFIX)
    f64 = device_env.make_episode_fn(et, device="cpu", dtype=torch.float64)
    out = f64({k: v[0] for k, v in rec["banks"].items()}, acts)
    for name, got in zip(TRACE_NAMES, out["trace"]):
        want = rec["x64"]["trace"][name][0, :FULL_PREFIX]
        if name in ("t", "jct"):
            np.testing.assert_allclose(got.numpy(), want, rtol=EPISODE_REL,
                                       atol=0)
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_banks_equal_reference_sample_job_bank(fx):
    env = _full_env()
    et = device_env.build_episode_tables(env)
    for lane in range(2):
        bank = device_env.sample_job_bank(et, env, 420, lane)
        for k, v in bank.items():
            np.testing.assert_array_equal(v, fx["full"]["banks"][k][lane])
