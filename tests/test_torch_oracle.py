"""In-kernel candidate pricing in the port (``ddls_tpu_torch/sim/
device_env.py``: ``EpisodeKernels.price_all``, K29 ``price_reduce``, K30
``oracle_select``, K23 with the state-lane index, K26 with the price
block; ``make_oracle_episode_fn`` and the price-feature
``make_policy_episode_fn``) and the host OracleJCT
(``ddls_tpu_torch/envs/baselines.py``), on the CPU through the plain
versions, against the JAX package and the port's own host env:

(a) the port's ``AcceptableJCT`` and ``OracleJCT`` answer as the
    reference's on the same observation, job and prices, in every branch;
    K30's plain version answers as the host ``OracleJCT`` on fuzzed lanes
    and on its edge cases (no placeable degree, every degree acceptable,
    ties in jct, a jct equal to the limit, lanes without a job);
(b) on the small surface of ``tests/test_jax_oracle_episode.py`` (the
    recording ``ddls_tpu_torch/data/oracle_episode_recorded.npz``): the
    port's host OracleJCT episode equals the recorded JAX host's; the
    float64 ``make_oracle_episode_fn`` equals the recorded JAX x64 trace
    and the host's decisions (t and jct within rel 1e-9,
    ``tests/test_jax_episode.py``'s limit); ``price_all``'s verdicts and
    prices equal the recorded JAX x64 ones at every step, bit for bit;
(c) on the price-feature surface of ``tests/test_jax_policy_episode.py``
    with its recorded random-init policy: the port's host env driven by
    the greedy policy equals the recorded JAX host episode; the float64
    price-feature policy episode equals the recorded JAX x64 trace and
    the host's; the price block of the first steps equals the recorded
    one bit for bit;
(d) in float32, K26's price block (plain version) equals the recorded
    JAX float32 rows of ppo_price_mixed's full-width episode and
    ``jax.jit`` of the reference's expression on fuzzed rows, bit for bit;
(e) ``make_segment_fn`` and ``rebuild_obs_batch`` refuse price features.

One intra-op thread, as the other torch test modules."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddls_tpu.envs import baselines as ref_baselines
from ddls_tpu.graphs.synthetic import generate_pipedream_txt_files
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
from ddls_tpu_torch.envs import baselines
from ddls_tpu_torch.models.convert import params_from_flax
from ddls_tpu_torch.models.policy import (GNNPolicy, batch_to_device,
                                          prepare_flat_batch)
from ddls_tpu_torch.rl.rollout import stack_obs
from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.fixture import (ORACLE_SURFACES, ORACLE_TRACE_NAMES,
                                        POLICY_ARCH, fuzzed_price_lanes,
                                        load_oracle_fixture,
                                        mixed_action_episode, oracle_episode,
                                        oracle_surface_kwargs,
                                        priced_episode_diffs)

torch.set_num_threads(1)

REL = 1e-9
# the price-feature policy's steps whose price blocks are held
BLOCK_STEPS = 12


@pytest.fixture(scope="module")
def fx():
    return load_oracle_fixture()


@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("oracle_profiles"))
    generate_pipedream_txt_files(d, n_cnn=2, n_translation=1, seed=5)
    return d


# ----------------------------------------------------------- (a) actors
class _Job:
    def __init__(self, seq, limit):
        self.seq_completion_time = seq
        self.max_acceptable_jct = limit


class _Env:
    def __init__(self, prices):
        self.candidate_prices = prices


def _obs(valid, n_actions=9):
    mask = np.zeros(n_actions, np.int32)
    mask[list(valid)] = 1
    return {"action_set": np.arange(n_actions), "action_mask": mask}


# name: (valid actions, prices, seq, limit, with env, with job, expected)
ACTOR_CASES = {
    "acceptable": ((0, 1, 2, 4, 8), {1: (100.0,), 2: (60.0,), 4: (30.0,),
                                     8: (20.0,)}, 400.0, 50.0, True, True,
                   4),
    "jct_equals_limit": ((0, 1, 2, 4), {1: (90.0,), 2: (50.0,),
                                        4: (30.0,)}, 400.0, 50.0, True,
                         True, 2),
    "every_degree_acceptable": ((0, 1, 2, 4), {1: (9.0,), 2: (5.0,),
                                               4: (3.0,)}, 40.0, 50.0, True,
                                True, 1),
    "none_acceptable_min_jct": ((0, 1, 2, 4, 6), {1: (90.0,), 2: (70.0,),
                                                  4: (60.0,), 6: (65.0,)},
                                400.0, 50.0, True, True, 4),
    "jct_tie_first_wins": ((0, 2, 4, 6), {2: (70.0,), 4: (60.0,),
                                          6: (60.0,)}, 400.0, 50.0, True,
                           True, 4),
    "unplaceable_skipped": ((0, 1, 2, 4), {1: None, 2: (70.0,), 4: None},
                            400.0, 50.0, True, True, 2),
    "none_placeable": ((0, 2, 4), {2: None, 4: None}, 400.0, 50.0, True,
                       True, 2),
    "unpriced_degree": ((0, 2, 4), {4: (10.0,)}, 400.0, 50.0, True, True,
                        4),
    "no_prices_acceptable_jct": ((0, 1, 2, 4, 8), {}, 400.0, 50.0, True,
                                 True, 8),
    "no_env": ((0, 1, 2, 4), None, 150.0, 50.0, False, True, 4),
    "target_above_every_degree": ((0, 1, 2), {}, 400.0, 50.0, True, True,
                                  2),
    "no_job": ((0, 2, 4), {2: (1.0,)}, 400.0, 50.0, True, False, 0),
    "only_action_zero": ((0,), {}, 400.0, 50.0, True, True, 0),
}


@pytest.mark.parametrize("case", sorted(ACTOR_CASES))
def test_oracle_actors_equal_reference(case):
    valid, prices, seq, limit, with_env, with_job, want = ACTOR_CASES[case]
    obs = _obs(valid)
    job = _Job(seq, limit) if with_job else None
    env = _Env(prices) if with_env else None
    got = baselines.OracleJCT().compute_action(obs, job_to_place=job,
                                               env=env)
    ref = ref_baselines.OracleJCT().compute_action(obs, job_to_place=job,
                                                   env=env)
    assert got == ref == want
    assert baselines.AcceptableJCT().compute_action(obs, job_to_place=job) \
        == ref_baselines.AcceptableJCT().compute_action(obs,
                                                        job_to_place=job)


@pytest.fixture(scope="module")
def oracle_env(profiles):
    env = PortEnv(**oracle_surface_kwargs(profiles))
    env.reset(seed=31)
    et = device_env.build_episode_tables(env)
    return env, et, device_env.build_obs_tables(env, et)


def test_oracle_select_plain_equals_the_host_oracle(oracle_env):
    """K30's plain version answers every fuzzed lane as the host
    ``OracleJCT`` does with the same mask, limit and prices (the host
    prices the mask's degrees only; an unplaceable one is None)."""
    env, et, ot = oracle_env
    dev = device_env.device_tables(et, "cpu", torch.float64)
    dobs = device_env.device_obs(ot, dev)
    state, bank, ok, jct, limit = fuzzed_price_lanes(
        et, ot, np.random.RandomState(5))
    t = {k: torch.from_numpy(v) for k, v in state.items()}
    b = {k: torch.from_numpy(v) for k, v in bank.items()}
    got = device_env.oracle_select_plain(
        torch.from_numpy(ok), torch.from_numpy(jct), t, b, dobs).numpy()
    mask = device_env.kernel_action_mask(
        dobs, (t["srv_job"] >= 0).sum(1)).numpy()
    actor = baselines.OracleJCT()
    for lane in range(len(got)):
        if state["queue_row"][lane] < 0 or state["done"][lane]:
            assert got[lane] == 0
            continue
        prices = {d: ((jct[lane, j],) if ok[lane, j] else None)
                  for j, d in enumerate(et.degrees) if mask[lane, d]}
        want = actor.compute_action(
            _obs(np.nonzero(mask[lane])[0], mask.shape[1]),
            job_to_place=_Job(1.0, limit[lane]), env=_Env(prices))
        assert got[lane] == want, lane
    assert got[0] == 1 and got[1] == 1 and got[2] == 1 and got[3] == 2
    assert got[6] == 0


# --------------------------------------------------- (b) the oracle episode
@pytest.fixture(scope="module")
def oracle_runs(fx, oracle_env):
    """The port's host OracleJCT episode, its bank's float64
    ``make_oracle_episode_fn`` run and the same steps through
    ``priced_episode_diffs``, on the CPU."""
    env, et, ot = oracle_env
    small = fx["small"]["oracle"]
    arrivals, decisions, stats = oracle_episode(env, ORACLE_SURFACES[
        "oracle"][2])
    bank = device_env.build_job_bank(et, arrivals)
    fn = device_env.make_oracle_episode_fn(et, ot, device="cpu",
                                           dtype=torch.float64)
    out = fn(bank)
    steps = len(bank["type"])
    diffs, held, stepped = priced_episode_diffs(
        et, ot, bank, steps, device="cpu", dtype=torch.float64)
    return small, et, arrivals, decisions, stats, bank, out, (diffs, held,
                                                             stepped)


def test_host_oracle_episode_equals_the_recorded_reference(oracle_runs):
    small, et, _, decisions, stats, bank, _, _ = oracle_runs
    got = np.array(decisions, np.float64)
    for i, name in enumerate(("action", "reward", "accept", "cause", "t",
                              "jct")):
        np.testing.assert_array_equal(got[:, i], small["host"][name],
                                      err_msg=name)
    for name, value in stats.items():
        assert value == int(small["host"][name]), name
    assert et.types == small["types"]
    for name, value in small["bank"].items():
        np.testing.assert_array_equal(bank[name], value, err_msg=name)


def _assert_trace(trace, want, n=None):
    for name in ORACLE_TRACE_NAMES:
        got, ref = trace[name][:n], want[name][:n]
        if name in ("t", "jct"):
            np.testing.assert_allclose(got, ref, rtol=REL, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)


def test_oracle_episode_x64_equals_reference_and_host(oracle_runs):
    small, _, _, decisions, stats, _, out, _ = oracle_runs
    trace = {name: x.numpy() for name, x in zip(ORACLE_TRACE_NAMES,
                                                out["trace"])}
    _assert_trace(trace, small["x64"]["trace"])
    for name, value in small["x64"]["counters"].items():
        got = out[name].numpy()
        if name in ("ret", "t"):
            np.testing.assert_allclose(got, value, rtol=REL, atol=0)
        else:
            np.testing.assert_array_equal(got, value, err_msg=name)
    host = np.array(decisions, np.float64)
    n = len(host)
    assert trace["has_job"][:n].all() and not trace["has_job"][n:].any()
    np.testing.assert_array_equal(trace["action"][:n], host[:, 0])
    np.testing.assert_array_equal(trace["reward"][:n], host[:, 1])
    np.testing.assert_array_equal(trace["accept"][:n], host[:, 2] > 0)
    np.testing.assert_array_equal(trace["cause"][:n], host[:, 3])
    np.testing.assert_allclose(trace["t"][:n], host[:, 4], rtol=REL, atol=0)
    acc = (host[:, 2] > 0) & np.isfinite(host[:, 5])
    np.testing.assert_allclose(trace["jct"][:n][acc], host[acc, 5],
                               rtol=REL, atol=0)
    for key in ("arrived", "blocked_total", "completed"):
        assert int(out[key]) == stats[key], key
    assert len(set(trace["action"][:n].tolist())) > 2


def test_price_all_equals_the_recorded_reference_x64(oracle_runs):
    """Every step's ``price_all`` (through ``priced_episode_diffs``, whose
    steps are ``make_oracle_episode_fn``'s) against the recorded JAX x64
    ``price_all`` of the same state: the verdicts and the prices equal,
    bit for bit. On the CPU the wrappers are their plain versions, so no
    call is held against them."""
    small, _, _, _, _, _, out, (diffs, held, stepped) = oracle_runs
    assert diffs == dict.fromkeys(diffs, 0.0)
    assert held == dict.fromkeys(held, 0)
    for name, x in zip(ORACLE_TRACE_NAMES, out["trace"]):
        assert torch.equal(stepped[name][0], x), name
    want_ok = small["x64"]["price_ok"]
    want_jct = small["x64"]["price_jct"]
    np.testing.assert_array_equal(stepped["price_ok"][0].numpy(), want_ok)
    np.testing.assert_array_equal(stepped["price_jct"][0].numpy(),
                                  want_jct)
    assert want_ok.any() and not want_ok.all()


# ----------------------------------------- (c) the price-feature policy
@pytest.fixture(scope="module")
def policy_runs(fx, profiles):
    small = fx["small"]["policy"]
    ia, _, seed = ORACLE_SURFACES["policy"]
    env = PortEnv(**oracle_surface_kwargs(profiles, interarrival=ia,
                                          prices=True))
    obs0 = env.reset(seed=seed)
    et = device_env.build_episode_tables(env)
    ot = device_env.build_obs_tables(env, et)
    model = GNNPolicy(n_actions=env.max_partitions_per_op + 1,
                      graph_feature_dim=obs0["graph_features"].shape[0],
                      **POLICY_ARCH)
    model.load_state_dict(params_from_flax(small["params"], model))
    model.eval()

    def greedy(obs):
        with torch.no_grad():
            batch = batch_to_device(prepare_flat_batch(stack_obs([obs])),
                                    "cpu")
            return int(model.flat_batched(batch)[2][0])

    arrivals, decisions, stats = mixed_action_episode(env, seed=seed,
                                                      policy=greedy)
    bank = device_env.build_job_bank(et, arrivals)
    fn = device_env.make_policy_episode_fn(et, ot, model, greedy=True,
                                           device="cpu",
                                           dtype=torch.float64)
    out = fn(bank)
    stepped = priced_episode_diffs(et, ot, bank, BLOCK_STEPS, model,
                                   device="cpu", dtype=torch.float64)
    return small, et, ot, decisions, stats, bank, out, stepped


def test_host_price_policy_episode_equals_the_recorded_reference(
        policy_runs):
    small, _, _, decisions, stats, bank, _, _ = policy_runs
    got = np.array(decisions, np.float64)
    for i, name in enumerate(("action", "reward", "accept", "cause", "t",
                              "jct")):
        np.testing.assert_array_equal(got[:, i], small["host"][name],
                                      err_msg=name)
    for name, value in stats.items():
        assert value == int(small["host"][name]), name
    for name, value in small["bank"].items():
        np.testing.assert_array_equal(bank[name], value, err_msg=name)


def test_price_policy_episode_x64_equals_reference_and_host(policy_runs):
    small, _, _, decisions, stats, _, out, _ = policy_runs
    names = ("action", "logp", "value") + ORACLE_TRACE_NAMES[1:]
    trace = {name: x.numpy() for name, x in zip(names, out["trace"])}
    _assert_trace(trace, small["x64"]["trace"])
    host = np.array(decisions, np.float64)
    n = len(host)
    assert trace["has_job"][:n].all()
    np.testing.assert_array_equal(trace["action"][:n], host[:, 0])
    np.testing.assert_array_equal(trace["reward"][:n], host[:, 1])
    np.testing.assert_array_equal(trace["cause"][:n], host[:, 3])
    for key in ("arrived", "blocked_total", "completed"):
        assert int(out[key]) == stats[key], key
    assert len(set(trace["action"][:n].tolist())) > 1


def test_price_block_x64_equals_the_recorded_reference(policy_runs):
    """The observation's price block over the first steps (K26's plain
    version with ``price_all``'s outputs, through ``priced_episode_diffs``)
    equals the recorded JAX x64 one bit for bit, and the stepped episode
    is the policy episode's."""
    small, _, _, _, _, _, out, (diffs, held, stepped) = policy_runs
    assert diffs == dict.fromkeys(diffs, 0.0)
    assert held == dict.fromkeys(held, 0)
    block = stepped["price_block"][0].numpy()
    want = small["x64"]["price_block"][:BLOCK_STEPS]
    np.testing.assert_array_equal(block, want)
    assert (want < 1.0).any()
    for name, x in zip(("action",) + ORACLE_TRACE_NAMES[1:],
                       (out["trace"][0],) + out["trace"][3:]):
        assert torch.equal(stepped[name][0], x[:BLOCK_STEPS]), name


# -------------------------------------------------- (d) float32 price block
@pytest.fixture(scope="module")
def shipped():
    cfg = load_checkpoint_fixture("ppo_price_mixed")["env_config"]
    env = PortEnv(**cfg, device="cpu")
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    return et, device_env.build_obs_tables(env, et)


def _reference_block(ot, et):
    """The reference's price block (``make_policy_episode_fn``
    :1492-1512) of one row, as ``jax.jit`` compiles it without x64."""
    degs = jnp.asarray(np.array(et.degrees, np.int32))
    shapes = jnp.asarray(ot["shapes_exist"])
    a = jnp.arange(et.max_action + 1)

    def block(jtype, frac, steps, n_occupied, ok, jcts):
        free = et.n_srv - n_occupied
        mask = ((a == 0) | ((a == 1) & (free >= 1))
                | ((a > 1) & (a % 2 == 0) & (a <= free) & shapes))
        limit = jnp.maximum(frac.astype(jnp.float64) * (jnp.asarray(
            ot["orig_seq_sum"])[jtype] * steps.astype(jnp.float64)), 1e-30)
        vals = jnp.minimum(jcts.astype(jnp.float64) / limit, 2.0) / 2.0
        return jnp.ones((et.max_action + 1,), jnp.float64).at[degs].set(
            jnp.where(ok & mask[degs], vals, 1.0)).astype(jnp.float32)

    return jax.jit(jax.vmap(block))


def test_price_block_f32_equals_recorded_and_jitted_reference(fx, shipped):
    et, ot = shipped
    rec = fx["full"]["policy"]
    dev = device_env.device_tables(et, "cpu", torch.float32)
    dobs = device_env.device_obs(ot, dev)
    rng = np.random.RandomState(3)
    n = 4000
    n_deg = len(et.degrees)
    fuzz = {"jtype": rng.randint(0, len(et.types), n).astype(np.int32),
            "frac": np.round(rng.uniform(0.1, 1.0, n), 2).astype(
                np.float32),
            "steps": rng.choice([1.0, 20.0, 37.0], n).astype(np.float32),
            "n_occupied": rng.randint(0, et.n_srv + 1, n).astype(np.int32),
            "n_running": rng.randint(0, 9, n).astype(np.int32),
            "price_ok": rng.rand(n, n_deg) < 0.8,
            "price_jct": (rng.lognormal(7.0, 1.5, (n, n_deg))).astype(
                np.float32)}
    want_fuzz = np.asarray(_reference_block(ot, et)(
        fuzz["jtype"], fuzz["frac"], fuzz["steps"], fuzz["n_occupied"],
        fuzz["price_ok"], fuzz["price_jct"]))
    a = et.max_action + 1
    for rows, want in ((rec, rec["price_block"]), (fuzz, want_fuzz)):
        t = {k: torch.from_numpy(np.ascontiguousarray(rows[k])) for k in
             ("jtype", "frac", "steps", "n_occupied", "n_running",
              "price_ok", "price_jct")}
        gf, _ = device_env.kernel_obs_plain(
            dobs, t["jtype"], t["frac"], t["steps"], t["n_occupied"],
            t["n_running"], prices=(t["price_ok"], t["price_jct"]))
        np.testing.assert_array_equal(gf[:, -a:].numpy(), want)
        assert gf.shape[1] == dobs.width == ot["graph_features"].shape[1] + a
    assert (rec["price_block"] < 1.0).any() and (want_fuzz == 1.0).any()
    assert (want_fuzz == 1.0).mean() < 0.9


# ---------------------------------------------------------- (e) refusals
def test_segment_and_rebuild_refuse_price_features(policy_runs):
    _, et, ot, _, _, _, _, _ = policy_runs
    with pytest.raises(ValueError, match="segment collection does not "
                                         "support price-feature"):
        device_env.make_segment_fn(et, ot, None, 4, device="cpu")
    dobs = device_env.device_obs(ot, device_env.device_tables(
        et, "cpu", torch.float32))
    fields = {name: torch.zeros(2, dtype=want or torch.float32)
              for name, want in device_env.OBS_FIELDS}
    with pytest.raises(ValueError, match="rebuild_obs_batch does not "
                                         "support price-feature"):
        device_env.rebuild_obs_batch(dobs, fields)
    with pytest.raises(ValueError, match="pass prices"):
        device_env.kernel_obs(dobs, *fields.values())
