"""The port's array lookahead engine (K21's plain version,
``ddls_tpu_torch/sim/lookahead.py``) and its two entry points against the
JAX package's ``jax_lookahead``:

(a) the port's padded ``build_lookahead_arrays`` equals the reference's,
    array for array, on the lookaheads of the same episode and on the
    candidates of pricing decisions;
(b) in float32 the plain engine equals ``batched_lookahead_fn`` bit for bit
    on those lanes, on the recorded lanes' edge cases (a stuck lane, zero
    durations, tied scores on a worker and on a channel, L = 2, no deps,
    all padding, random DAGs) and on the recorded pricing lanes at 32, 72
    and 128 servers. Bit equality needs the reference's one fused
    multiply-add (XLA contracts busy + tick * count): rounded twice, busy
    is one float32 step off on the pricing lanes;
(c) in float64 it equals the C++ engine (``native.run_lookahead``) within
    1e-9 relative;
(d) on ``device="cpu"``, ``candidate_pricing="jax"`` prices equal the
    reference's jax backend exactly and agree with the native engine at
    the reference's rel=2e-4, abs=1e-5; a ``use_jax_lookahead=True``
    episode's stats equal the reference's exactly and the host engine's
    at rel 1e-4;
(e) without a card, the default ``device="cuda"`` raises.

The simulator draws from the global random streams: each side runs its
whole episode before the other starts."""
import copy
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from ddls_tpu.envs import RampJobPartitioningEnvironment as JaxEnv
from ddls_tpu.graphs.synthetic import generate_pipedream_txt_files
from ddls_tpu.sim import jax_lookahead as jl
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
from ddls_tpu_torch.native import run_lookahead
from ddls_tpu_torch.sim import candidate_pricing
from ddls_tpu_torch.sim import lookahead_arrays as port_arrays
from ddls_tpu_torch.sim.fixture import load_lookahead_lanes, unpack_lanes
from ddls_tpu_torch.sim.lookahead import ARG_NAMES, bucket, lookahead

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import export_torch_lookahead_lanes as lanes_export  # noqa: E402
from ddls_tpu_torch.sim.fixture import pack_lanes  # noqa: E402

torch.set_num_threads(1)

FIELDS = ARG_NAMES + ("num_workers", "num_channels")


def _lookahead_env_kwargs(dataset_dir):
    """``tests/test_jax_lookahead.py``'s env (8 servers); the native engine
    off, so that every cache miss reaches the engines under test."""
    return dict(
        use_native_lookahead=False,
        topology_config={"type": "ramp", "kwargs": {
            "num_communication_groups": 2,
            "num_racks_per_communication_group": 2,
            "num_servers_per_rack": 2,
            "num_channels": 1,
            "total_node_bandwidth": 1.6e12}},
        node_config={"type_1": {"num_nodes": 8, "workers_config": [
            {"num_workers": 1, "worker": "A100"}]}},
        jobs_config={
            "path_to_files": dataset_dir,
            "job_interarrival_time_dist": {
                "_target_": "ddls_tpu.demands.distributions.Fixed",
                "val": 100.0},
            "replication_factor": 4,
            "job_sampling_mode": "remove_and_repeat",
            "num_training_steps": 3},
        max_partitions_per_op=4,
        reward_function="job_acceptance",
        max_simulation_run_time=1e5,
        pad_obs_kwargs={"max_nodes": 64, "max_edges": 256})


def _spied_lanes(env, builders, n_cases: int = 8):
    """Step ``env`` with random valid actions (RandomState(0)) and, at each
    host-engine lookahead, call every ``builders[name](cluster, job)``:
    {name: [built, ...]} (``tests/test_jax_lookahead.py``'s capture)."""
    cluster = env.cluster
    orig = cluster._run_lookahead
    out = {name: [] for name in builders}

    def spy(job):
        for name, build in builders.items():
            out[name].append(build(cluster, job))
        return orig(job)

    cluster._run_lookahead = spy
    obs = env.reset(seed=0)
    rng = np.random.RandomState(0)
    try:
        i = 0
        while len(out[next(iter(builders))]) < n_cases:
            valid = np.nonzero(np.asarray(obs["action_mask"]))[0]
            obs, _, done, _ = env.step(int(rng.choice(valid)))
            i += 1
            if done or i > 200:
                obs = env.reset(seed=i)
                cluster.lookahead_cache.clear()
    finally:
        cluster._run_lookahead = orig
    return out


def _padded(builder):
    return lambda cluster, job: builder(cluster, job, pad_ops=160,
                                        pad_deps=520, pad_links=2)


@pytest.fixture(scope="module")
def spied(dataset_dir):
    """The same episode's lookaheads on each side: the port's padded and
    native arrays and the reference's padded arrays."""
    kwargs = _lookahead_env_kwargs(dataset_dir)
    port = _spied_lanes(PortEnv(device="cpu", **copy.deepcopy(kwargs)), {
        "padded": _padded(port_arrays.build_lookahead_arrays),
        "native": lambda c, j: port_arrays.build_native_lookahead_arrays(
            c, j)})
    ref = _spied_lanes(JaxEnv(**copy.deepcopy(kwargs)), {
        "padded": _padded(jl.build_lookahead_arrays)})
    return port, ref


def _assert_same_arrays(p, r):
    for name in FIELDS:
        got, want = getattr(p, name), getattr(r, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_builder_equals_reference(spied):
    port, ref = spied
    assert len(port["padded"]) == len(ref["padded"]) == 8
    for p, r in zip(port["padded"], ref["padded"]):
        _assert_same_arrays(p, r)


def _stack(lanes):
    return [np.stack([getattr(a, n) for a in lanes]) for n in ARG_NAMES]


def _assert_plain_is_jax(args, num_workers, num_channels, jax_out=None):
    if jax_out is None:
        jax_out = jl.batched_lookahead_fn(num_workers, num_channels)(*args)
    ticks = torch.zeros(args[0].shape[0], dtype=torch.int32)
    got = lookahead(*(torch.from_numpy(np.asarray(a)) for a in args),
                    num_workers=num_workers, num_channels=num_channels,
                    ticks=ticks)
    for name, g, w in zip(("t", "comm", "comp", "busy", "ok"), got,
                          jax_out):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    return ticks


def test_plain_engine_is_jax_on_spied_lanes(spied):
    lanes = spied[0]["padded"]
    ticks = _assert_plain_is_jax(
        _stack(lanes), max(a.num_workers for a in lanes),
        max(a.num_channels for a in lanes))
    assert (ticks > 0).all()


def test_plain_engine_is_jax_on_edge_cases():
    lanes, w, c = lanes_export.edge_case_lanes()
    args = _stack(lanes)
    ticks = _assert_plain_is_jax(args, w, c)
    ok = jl.batched_lookahead_fn(w, c)(*args)[4]
    # the stuck lanes fail, the all-padding lane finishes without a tick
    assert not ok[0] and not ok[1] and ok[7] and int(ticks[7]) == 0
    # a lane with holes in its valid masks (not a prefix)
    holed = copy.deepcopy(lanes[5])
    holed.op_valid[1] = False
    holed.dep_valid[0] = False
    _assert_plain_is_jax(_stack([holed, lanes[3]]), w, c)


@pytest.mark.parametrize("group", ["price32", "price72", "price128",
                                   "mounted32", "edge"])
def test_plain_engine_is_jax_on_recorded_lanes(group):
    rec = load_lookahead_lanes()[group]
    _assert_plain_is_jax(rec["args"], rec["num_workers"],
                         rec["num_channels"], rec["jax"])


def test_float64_engine_is_the_cpp_engine(spied):
    """The plain engine in float64 on the C++ engine's own exact-size
    arrays, one lane at a time, within 1e-9 relative."""
    for arrays in spied[0]["native"]:
        want = run_lookahead(arrays)
        args = [torch.from_numpy(np.asarray(a))[None]
                for a in port_arrays.arrays_as_args(arrays)]
        args = [a.to(torch.float64) if a.is_floating_point() else a
                for a in args]
        args = [a.to(torch.int32) if a.dtype == torch.int64 else a
                for a in args]
        *got, ok = lookahead(*args, num_workers=arrays.num_workers,
                             num_channels=arrays.num_channels)
        assert bool(ok[0])
        for g, w in zip(got, want):
            assert float(g[0]) == pytest.approx(w, rel=1e-9, abs=1e-12)


def test_recorded_lanes_pack_round_trip():
    """The archive format: packing the unpacked lanes gives the packed
    arrays back."""
    lanes, w, c = lanes_export.edge_case_lanes()
    packed = pack_lanes(lanes, w, c)
    arrays = unpack_lanes(packed)
    for name in ARG_NAMES:
        np.testing.assert_array_equal(arrays[name], _stack(lanes)[
            ARG_NAMES.index(name)], err_msg=name)


# ------------------------------------------------------------ entry points
@pytest.fixture(scope="module")
def pricing_dataset():
    d = tempfile.mkdtemp(prefix="torch_lookahead_pricing_")
    generate_pipedream_txt_files(d, n_cnn=2, n_translation=1, seed=11)
    return d


def _pricing_kwargs(dataset_dir):
    """``tests/test_candidate_pricing.py``'s env (8 servers)."""
    return dict(
        topology_config={"type": "ramp", "kwargs": {
            "num_communication_groups": 2,
            "num_racks_per_communication_group": 2,
            "num_servers_per_rack": 2,
            "num_channels": 1,
            "total_node_bandwidth": 1.6e12,
            "intra_gpu_propagation_latency": 50e-9,
            "worker_io_latency": 100e-9}},
        node_config={"type_1": {"num_nodes": 8, "workers_config": [
            {"num_workers": 1, "worker": "A100"}]}},
        jobs_config={
            "path_to_files": dataset_dir,
            "job_interarrival_time_dist": {
                "_target_": "ddls_tpu.demands.distributions.Fixed",
                "val": 100.0},
            "max_acceptable_job_completion_time_frac_dist": {
                "_target_": "ddls_tpu.demands.distributions.Uniform",
                "min_val": 0.2, "max_val": 1.0, "decimals": 2},
            "replication_factor": 15,
            "job_sampling_mode": "remove_and_repeat",
            "num_training_steps": 10},
        max_partitions_per_op=8,
        min_op_run_time_quantum=0.01,
        reward_function="job_acceptance",
        max_simulation_run_time=1.5e4,
        pad_obs_kwargs={"max_nodes": 150, "max_edges": 512})


def _priced_decisions(env, backend: str, n_decisions: int = 4):
    """The prices of ``n_decisions`` successive decisions from reset(5),
    each taking the largest valid degree; the memo is emptied before each
    pricing so every candidate reaches the engine."""
    obs = env.reset(seed=5)
    out = []
    for _ in range(n_decisions):
        saved = env.cluster.lookahead_cache
        env.cluster.lookahead_cache = {}
        out.append(env.price_candidate_degrees(backend=backend))
        env.cluster.lookahead_cache = saved
        valid = np.flatnonzero(np.asarray(obs["action_mask"]))
        obs, _, done, _ = env.step(int(valid[-1]))
        if done:
            break
    return out


def test_jax_pricing_is_the_reference_and_near_native(pricing_dataset):
    kwargs = _pricing_kwargs(pricing_dataset)
    port = _priced_decisions(PortEnv(device="cpu", **copy.deepcopy(kwargs)),
                             "jax")
    ref = _priced_decisions(JaxEnv(**copy.deepcopy(kwargs)), "jax")
    native = _priced_decisions(PortEnv(**copy.deepcopy(kwargs)), "native")
    assert port == ref  # float32 results as Python floats: exact
    compared = 0
    for p, n in zip(port, native):
        assert set(p) == set(n)
        for a in n:
            if n[a] is None:
                assert p[a] is None
                continue
            for lhs, rhs in zip(n[a], p[a]):
                assert rhs == pytest.approx(lhs, rel=2e-4, abs=1e-5)
            compared += 1
    assert compared >= 3


def test_builder_equals_reference_on_pricing_candidates(pricing_dataset,
                                                       monkeypatch):
    """The padded builder on the candidates of four pricing decisions
    (unmounted placements, given as ``context``), and on each with its
    workers relabelled in reverse so that their order of first use is not
    their sorted order: equal, array for array, to the reference's
    builder on the same inputs."""
    env = PortEnv(device="cpu",
                  **copy.deepcopy(_pricing_kwargs(pricing_dataset)))
    pending = []
    evaluate = candidate_pricing._evaluate

    def spy(cluster, batch, backend):
        pending.extend(batch)
        return evaluate(cluster, batch, backend)

    monkeypatch.setattr(candidate_pricing, "_evaluate", spy)
    _priced_decisions(env, "jax")
    workers = sorted(env.cluster.topology.workers)
    flip = dict(zip(workers, workers[::-1]))
    assert len(pending) >= 3
    for _, _, job, ctx in pending:
        flipped = dict(ctx, op_to_worker={
            op: flip[w] for op, w in ctx["op_to_worker"].items()})
        pad = dict(pad_ops=bucket(job.graph.n_ops),
                   pad_deps=bucket(job.graph.n_deps), pad_links=2)
        for context in (ctx, flipped):
            _assert_same_arrays(
                port_arrays.build_lookahead_arrays(
                    env.cluster, job, context=context, **pad),
                jl.build_lookahead_arrays(env.cluster, job,
                                          context=context, **pad))


def test_jax_pricing_env_option_runs_the_episode(pricing_dataset):
    """``candidate_pricing="jax"`` as an env option: each decision's
    prices (and so the price features and the memo it prefetches) equal
    the reference env's with the same option."""
    kwargs = dict(_pricing_kwargs(pricing_dataset), candidate_pricing="jax",
                  obs_include_candidate_prices=True)

    def run(env):
        obs = env.reset(seed=2)
        trace = [(dict(env.candidate_prices), obs["graph_features"])]
        for _ in range(8):
            valid = np.flatnonzero(np.asarray(obs["action_mask"]))
            obs, reward, done, _ = env.step(int(valid[len(valid) // 2]))
            trace.append((dict(env.candidate_prices),
                          obs["graph_features"], reward))
            if done:
                break
        return trace

    port = run(PortEnv(device="cpu", **copy.deepcopy(kwargs)))
    ref = run(JaxEnv(**copy.deepcopy(kwargs)))
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p[0] == r[0]
        np.testing.assert_array_equal(p[1], r[1])
        assert p[2:] == r[2:]
    assert any(p[0] for p in port)


def _max_parallel_episode(env, steps: int = 60):
    obs = env.reset(seed=0)
    done, i = False, 0
    while not done and i < steps:
        valid = np.nonzero(np.asarray(obs["action_mask"]))[0]
        obs, _, done, _ = env.step(int(valid[-1]))
        i += 1
    return copy.deepcopy(dict(env.cluster.episode_stats))


def test_use_jax_lookahead_episode_is_the_reference(dataset_dir):
    kwargs = _lookahead_env_kwargs(dataset_dir)
    port = _max_parallel_episode(PortEnv(
        device="cpu", use_jax_lookahead=True, **copy.deepcopy(kwargs)))
    ref_env = JaxEnv(**copy.deepcopy(kwargs))
    ref_env.cluster.use_jax_lookahead = True
    ref = _max_parallel_episode(ref_env)
    host = _max_parallel_episode(PortEnv(**copy.deepcopy(kwargs)))
    assert sorted(port) == sorted(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(np.asarray(port[key]),
                                      np.asarray(value), err_msg=key)
    assert port["num_jobs_completed"] == host["num_jobs_completed"]
    assert port["num_jobs_blocked"] == host["num_jobs_blocked"]
    assert port["job_completion_time"] == pytest.approx(
        host["job_completion_time"], rel=1e-4)
    assert port["job_communication_overhead_time"] == pytest.approx(
        host["job_communication_overhead_time"], rel=1e-4, abs=1e-6)


def test_cuda_default_raises_without_a_card(pricing_dataset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    kwargs = _pricing_kwargs(pricing_dataset)
    with pytest.raises(RuntimeError, match="CUDA"):
        PortEnv(use_jax_lookahead=True, **copy.deepcopy(kwargs))
    with pytest.raises(RuntimeError, match="CUDA"):
        PortEnv(candidate_pricing="jax", **copy.deepcopy(kwargs))
    env = PortEnv(**copy.deepcopy(kwargs))
    env.reset(seed=5)
    with pytest.raises(RuntimeError, match="CUDA"):
        env.price_candidate_degrees(backend="jax")
