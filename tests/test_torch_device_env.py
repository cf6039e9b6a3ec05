"""The port's device episode replay (``ddls_tpu_torch/sim/device_env.py``,
``sim/device_block_search.py``: the plain versions of K22-K25 and K21 with
``skip``) against the JAX package's ``jax_env`` and ``jax_block_search``:

(a) ``build_episode_tables``, ``build_job_bank`` and ``sample_job_bank``
    equal the reference's array for array, dtype for dtype (float64 as
    built; float32 as the episode casts them and ``jnp.asarray`` leaves
    them without x64), on the reference episode test's small surface and
    on the shipped ``env_load32_price_mixed``;
(b) ``first_fit_block`` equals ``first_fit_block_jax`` on fuzzed grids;
    ``allocate_job`` equals ``jax_allocate_job`` on fuzzed memory and
    occupancy; ``price_and_score`` equals ``jax_price_and_score`` on the
    placed jobs, bit for bit in float32 (the stated limit: 0) and in
    float64 within 1e-9 in an x64 subprocess;
(c) ``lookahead_plain`` with ``skip`` runs no tick on skipped lanes and
    leaves the others bit-equal;
(d) the port's float64 replay of the small surface's host episode (the
    reference's mixed-action policy) equals the recorded JAX x64
    ``make_episode_fn(memo_cfg=None)`` (accept, cause and reward exactly,
    t and jct within rel 1e-9, the counters exactly) and the port's own
    host env on the same episode; the float32 replay of the shipped
    banks' first decisions equals the recorded JAX float32 trace bit for
    bit; a 2-lane stacked run equals two 1-lane runs bit for bit;
(e) the cause codes the recordings reach; an env that was never reset
    is refused; without a card the default ``device="cuda"`` raises.

The simulator draws from the global random streams: each side runs its
whole episode before the other starts."""
import copy
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddls_tpu.envs import RampJobPartitioningEnvironment as JaxEnv
from ddls_tpu.graphs.synthetic import generate_pipedream_txt_files
from ddls_tpu.sim import jax_block_search, jax_env
from ddls_tpu_torch.agents.block_search import block_shapes_for, factor_pairs
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
from ddls_tpu_torch.sim import device_env, lookahead as lookahead_mod
from ddls_tpu_torch.sim.device_block_search import first_fit_block
from ddls_tpu_torch.sim.fixture import (TRACE_NAMES, episode_kernel_diffs,
                                        load_device_env_fixture,
                                        load_lookahead_lanes, max_difference,
                                        mixed_action_episode,
                                        small_surface_kwargs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import export_torch_device_env_fixture as fixture_export  # noqa: E402

torch.set_num_threads(1)

REL = 1e-9


@pytest.fixture(scope="module")
def fx():
    return load_device_env_fixture()


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("device_env_profiles"))
    generate_pipedream_txt_files(d, n_cnn=2, n_translation=1, seed=5)
    return d


@pytest.fixture(scope="module")
def surfaces(small_dir):
    """(JAX env, port env) per surface, each reset once."""
    cfg = load_checkpoint_fixture("ppo_price_mixed")["env_config"]
    out = {"small": (JaxEnv(**small_surface_kwargs(small_dir)),
                     PortEnv(**small_surface_kwargs(small_dir))),
           "shipped": (fixture_export.shipped_env(),
                       PortEnv(**copy.deepcopy(cfg), device="cpu"))}
    out["shipped"][1].reset(seed=0)
    out["small"][0].reset(seed=17)
    out["small"][1].reset(seed=17)
    return out


@pytest.fixture(scope="module")
def tables(surfaces):
    """(JAX f32 tables, port tables) per surface."""
    return {name: (jax_env.build_episode_tables(j),
                   device_env.build_episode_tables(p))
            for name, (j, p) in surfaces.items()}


@pytest.mark.parametrize("surface", ["small", "shipped"])
def test_tables_equal_reference(surfaces, tables, surface):
    jenv, _ = surfaces[surface]
    jet, pet = tables[surface]
    # float64, as built (the reference under x64)
    with jax.enable_x64(True):
        jet64 = jax_env.build_episode_tables(jenv)
        for name, value in jet64.tables.items():
            want = np.asarray(value)
            got = pet.tables[name]
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    # as the float32 episode casts them, against jnp.asarray without x64
    dev = device_env.device_tables(pet, "cpu", torch.float32)
    for name, value in jet.tables.items():
        want = np.asarray(value)
        got = dev.t[name].numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("row", "offsets", "counts", "bases", "spans", "diagonal"):
        np.testing.assert_array_equal(getattr(pet.st, name),
                                      getattr(jet.st, name), err_msg=name)
    assert pet.st.shapes == jet.st.shapes
    assert pet.pads == device_env.ConfigPads(**vars(jet.pads))
    np.testing.assert_array_equal(pet.pair_channel,
                                  np.asarray(jet.pair_channel))
    for name in ("types", "degrees", "comm", "n_chan", "n_srv", "max_action",
                 "sim_end", "eps", "success_reward", "fail_reward",
                 "worker_mem"):
        assert getattr(pet, name) == getattr(jet, name), name
    records = fixture_export.bank_records(jet.types, 3)
    for want, got in ((jax_env.build_job_bank(jet, records),
                       device_env.build_job_bank(pet, records)),
                      (jax_env.sample_job_bank(jet, jenv, 40, 5),
                       device_env.sample_job_bank(pet, surfaces[surface][1],
                                                  40, 5))):
        for name, value in want.items():
            assert got[name].dtype == value.dtype, name
            np.testing.assert_array_equal(got[name], value, err_msg=name)


@pytest.mark.parametrize("ramp_shape", [(2, 2, 2), (4, 4, 2), (3, 2, 2)])
def test_first_fit_block_matches_reference(ramp_shape):
    rng = np.random.RandomState(sum(ramp_shape))
    n_srv = int(np.prod(ramp_shape))
    grids = rng.rand(96, *ramp_shape) < rng.uniform(0.2, 0.95, (96, 1, 1, 1))
    for split in (1, 2, 4, 8):
        if split > n_srv:
            continue
        shapes = block_shapes_for(factor_pairs(split), ramp_shape)
        shapes += [(split, split, -1), (split, 1, 1)]
        fn = jax_block_search.jitted_first_fit(tuple(shapes), ramp_shape)
        got = first_fit_block(torch.from_numpy(grids), shapes, ramp_shape)
        for g in range(len(grids)):
            want = fn(jnp.asarray(grids[g]))
            for w, x in zip(want, got):
                assert int(w) == int(x[g]), (split, g)


def _fuzzed_states(rng, lanes, n_srv, n_cfg, worker_mem):
    mem = np.full((lanes, n_srv), worker_mem)
    used = rng.rand(lanes, n_srv) < rng.uniform(0, 0.8, (lanes, 1))
    mem[used] *= rng.choice([0.5, 0.25, 0.1, 0.02, 0.001],
                            size=int(used.sum()))
    other = rng.rand(lanes, n_srv) >= rng.uniform(0, 0.6, (lanes, 1))
    cfg = rng.randint(0, n_cfg, size=lanes).astype(np.int32)
    return mem, other, cfg


@pytest.mark.parametrize("surface", ["small", "shipped"])
def test_allocate_and_price_match_reference_f32(tables, surface):
    """Float32, bit for bit: placement on fuzzed memory and occupancy,
    then pricing and scores of the placements."""
    jet, pet = tables[surface]
    dev = device_env.device_tables(pet, "cpu", torch.float32)
    rng = np.random.RandomState(7)
    mem, other, cfg = _fuzzed_states(rng, 24, pet.n_srv, dev.n_cfg,
                                     pet.worker_mem)
    alloc = jax.jit(lambda m, o, c: jax_env.jax_allocate_job(
        m, o, c, jet.tables, jet.st, jet.pads))
    price = jax.jit(lambda sc, c: jax_env.jax_price_and_score(
        sc, c, jet.tables, jet.st, jet.pads, jet.comm, jet.pair_channel))
    ots, new_mem, ok = device_env.allocate_job(
        torch.tensor(mem, dtype=torch.float32), torch.from_numpy(other),
        torch.from_numpy(cfg), dev)
    priced = device_env.price_and_score(ots, torch.from_numpy(cfg), dev)
    assert 0 < int(ok.sum()) < len(cfg)
    for b in range(len(cfg)):
        want = alloc(jnp.asarray(mem[b], jnp.float32),
                     jnp.asarray(other[b]), jnp.int32(cfg[b]))
        for w, g in zip(want, (ots[b], new_mem[b], ok[b])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        want = price(jnp.asarray(ots[b].numpy()), jnp.int32(cfg[b]))
        for name, w, g in zip(("times", "is_flow", "chan", "op_score",
                               "dep_score", "finite_ok"), want, priced):
            assert g.numpy().dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w),
                                          err_msg=f"{name} lane {b}")


_X64_SCRIPT = textwrap.dedent("""
    import sys, tempfile
    sys.path.insert(0, {repo!r})
    import numpy as np, torch, jax, jax.numpy as jnp
    assert jax.config.read("jax_enable_x64")
    from ddls_tpu.envs import RampJobPartitioningEnvironment as JaxEnv
    from ddls_tpu.graphs.synthetic import generate_pipedream_txt_files
    from ddls_tpu.sim import jax_env
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
    from ddls_tpu_torch.sim import device_env
    from ddls_tpu_torch.sim.fixture import small_surface_kwargs

    d = tempfile.mkdtemp(prefix="device_env_x64_")
    generate_pipedream_txt_files(d, n_cnn=2, n_translation=1, seed=5)
    jenv, penv = (JaxEnv(**small_surface_kwargs(d)),
                  PortEnv(**small_surface_kwargs(d)))
    jenv.reset(seed=17)
    penv.reset(seed=17)
    jet = jax_env.build_episode_tables(jenv)
    pet = device_env.build_episode_tables(penv)
    dev = device_env.device_tables(pet, "cpu", torch.float64)
    rng = np.random.RandomState(11)
    lanes = 24
    mem = np.full((lanes, pet.n_srv), pet.worker_mem)
    mem *= rng.choice([1.0, 0.3, 0.01], size=mem.shape)
    other = rng.rand(lanes, pet.n_srv) >= 0.3
    cfg = rng.randint(0, dev.n_cfg, size=lanes).astype(np.int32)
    ots, new_mem, ok = device_env.allocate_job(
        torch.tensor(mem), torch.from_numpy(other), torch.from_numpy(cfg),
        dev)
    priced = device_env.price_and_score(ots, torch.from_numpy(cfg), dev)
    price = jax.jit(lambda sc, c: jax_env.jax_price_and_score(
        sc, c, jet.tables, jet.st, jet.pads, jet.comm, jet.pair_channel))
    worst = 0.0
    for b in range(lanes):
        if not bool(ok[b]):
            continue
        want = price(jnp.asarray(ots[b].numpy()), jnp.int32(cfg[b]))
        for w, g in zip(want, priced):
            w, g = np.asarray(w), g[b].numpy()
            if w.dtype.kind == "f":
                worst = max(worst, float(np.max(
                    np.abs(g - w) / np.maximum(np.abs(w), 1e-300))))
            else:
                assert np.array_equal(w, g)
    assert worst <= {rel!r}, worst
    print("X64_PRICING_OK", int(ok.sum()), worst)
""")


def test_price_and_score_matches_reference_x64():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", _X64_SCRIPT.format(repo=REPO, rel=REL)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert "X64_PRICING_OK" in res.stdout


def test_lookahead_skip_runs_no_tick():
    group = load_lookahead_lanes()["price32"]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in group["args"]]
    kw = dict(num_workers=group["num_workers"],
              num_channels=group["num_channels"])
    lanes = args[0].shape[0]
    skip = torch.arange(lanes) % 2 == 1
    full = lookahead_mod.lookahead_plain(*args, **kw)
    got = lookahead_mod.lookahead_plain(*args, **kw, skip=skip)
    ticks = torch.empty(lanes, dtype=torch.int32)
    wrapped = lookahead_mod.lookahead(*args, **kw, skip=skip, ticks=ticks)
    for f, g, w in zip(full, got, (*wrapped, ticks)):
        assert torch.equal(g[~skip], f[~skip])
        assert torch.equal(w, g)
    for g in got[:4]:
        assert torch.equal(g[skip], torch.zeros_like(g[skip]))
    assert not got[4][skip].any()        # valid ops left undone
    assert torch.equal(got[5][skip], torch.zeros_like(got[5][skip]))
    assert bool((full[5][skip] > 0).all())
    # without a mask, and with an all-False one, nothing changes
    none = lookahead_mod.lookahead_plain(
        *args, **kw, skip=torch.zeros(lanes, dtype=torch.bool))
    for f, g in zip(full, none):
        assert torch.equal(f, g)


def _trace_np(out):
    return {name: x.numpy() for name, x in zip(TRACE_NAMES, out["trace"])}


def _assert_replay(trace, want, counters=None, want_counters=None):
    for name in ("reward", "accept", "cause", "has_job"):
        np.testing.assert_array_equal(trace[name], want[name], err_msg=name)
    for name in ("t", "jct"):
        np.testing.assert_allclose(trace[name], want[name], rtol=REL,
                                   atol=0, err_msg=name)
    if counters is not None:
        for name, value in want_counters.items():
            got = counters[name]
            if name in ("ret", "t"):
                np.testing.assert_allclose(got, value, rtol=REL, atol=0)
            else:
                np.testing.assert_array_equal(got, value, err_msg=name)


def test_small_surface_replay_x64_equals_reference_and_host(fx, small_dir):
    """The port's host env replays the recorded host episode, and the
    port's float64 device replay of it equals the JAX x64 one and the
    host's decisions."""
    small = fx["small"]
    env = PortEnv(**small_surface_kwargs(small_dir))
    arrivals, decisions, stats = mixed_action_episode(env)
    host = small["host"]
    actions = np.array([d[0] for d in decisions], np.int32)
    np.testing.assert_array_equal(actions, small["actions"])
    got = np.array([d[1:] for d in decisions], np.float64)
    for i, name in enumerate(("reward", "accept", "cause", "t", "jct")):
        np.testing.assert_array_equal(got[:, i], host[name], err_msg=name)
    for name, value in stats.items():
        assert value == int(host[name]), name
    et = device_env.build_episode_tables(env)
    assert et.types == small["types"]
    bank = device_env.build_job_bank(et, arrivals)
    for name, value in small["bank"].items():
        np.testing.assert_array_equal(bank[name], value, err_msg=name)
    fn = device_env.make_episode_fn(et, device="cpu", dtype=torch.float64)
    out = fn(bank, actions)
    trace = _trace_np(out)
    counters = {k: out[k].numpy() for k in small["x64"]["counters"]}
    want = {k: v[0] for k, v in small["x64"]["trace"].items()}
    _assert_replay(trace, want, counters,
                   {k: v[0] for k, v in small["x64"]["counters"].items()})
    # the host's decisions and episode stats
    assert trace["has_job"].all()
    np.testing.assert_array_equal(trace["accept"], host["accept"] > 0)
    np.testing.assert_array_equal(trace["cause"], host["cause"])
    np.testing.assert_array_equal(trace["reward"], host["reward"])
    np.testing.assert_allclose(trace["t"], host["t"], rtol=REL, atol=0)
    accepted = (host["accept"] > 0) & np.isfinite(host["jct"])
    np.testing.assert_allclose(trace["jct"][accepted], host["jct"][accepted],
                               rtol=REL, atol=0)
    assert int(out["arrived"]) == stats["arrived"]
    assert int(out["blocked_total"]) == stats["blocked_total"]
    assert int(out["completed"]) == stats["completed"]


def test_shipped_banks_f32_prefix_equals_reference(fx, tables):
    """The float32 replay of the first decisions of two shipped banks at
    full width (45 configs, N = 480, M = 13,072), bit-equal to the
    recorded JAX float32 trace."""
    _, pet = tables["shipped"]
    assert pet.types == fx["types"]
    n_dec = 16
    fn = device_env.make_episode_fn(pet, device="cpu", dtype=torch.float32)
    lanes = [0, 5]
    bank = {k: v[lanes] for k, v in fx["banks"].items()}
    acts = np.stack([fx["actions"][:n_dec]] * len(lanes))
    out = fn(bank, acts)
    for name, x in zip(TRACE_NAMES, out["trace"]):
        np.testing.assert_array_equal(
            x.numpy(), fx["f32"]["trace"][name][lanes, :n_dec], err_msg=name)


def test_stacked_lanes_equal_single_lanes(fx, tables):
    """Two lanes stacked equal each lane run alone, bit for bit (small
    surface, the recorded bank and a sampled one, float32)."""
    _, pet = tables["small"]
    small = fx["small"]
    n_dec = 40
    other = device_env.build_job_bank(
        pet, [dict(model=pet.types[int(t)], num_training_steps=20,
                   sla_frac=s, time_arrived=a)
              for t, s, a in zip(small["bank"]["type"][::-1],
                                 small["bank"]["sla_frac"],
                                 small["bank"]["arrival_t"][:-1])])
    banks = [small["bank"], other]
    acts = [small["actions"][:n_dec], small["actions"][::-1][:n_dec]]
    fn = device_env.make_episode_fn(pet, device="cpu", dtype=torch.float32)
    stacked = fn({k: np.stack([b[k] for b in banks]) for k in banks[0]},
                 np.stack(acts))
    for lane in range(2):
        alone = fn(banks[lane], acts[lane])
        for s, a in zip(stacked["trace"], alone["trace"]):
            assert torch.equal(s[lane], a)
        for key in ("accepted", "blocked", "ret", "completed", "t", "done",
                    "blocked_total", "arrived", "lookahead_ticks"):
            assert torch.equal(stacked[key][lane], alone[key]), key


def test_episode_kernel_diffs_drive_the_replay(fx, tables):
    """The helper that holds each kernel call against its plain version
    (chip_smoke's ``[episode]`` and the card's kernel test) drives the same
    decisions as ``make_episode_fn``: on the CPU both sides are the plain
    versions, so every difference is 0, and its trace is the replay's."""
    _, pet = tables["small"]
    small = fx["small"]
    n_dec = 12
    ek = device_env.episode_kernels(pet, device="cpu", dtype=torch.float32)
    bank = {name: torch.from_numpy(np.stack([small["bank"][name]] * 2)).to(
        want or torch.float32) for name, want in device_env.BANK_FIELDS}
    acts = torch.from_numpy(np.stack([small["actions"][:n_dec]] * 2)).to(
        torch.int32)
    diffs, held, trace = episode_kernel_diffs(ek, bank, acts, n_dec, (0, 3))
    assert diffs == dict.fromkeys(diffs, 0.0)
    assert held == {"allocate_job": n_dec, "price_and_score": n_dec,
                    "lookahead": 2, "episode_step": n_dec}
    out = device_env.make_episode_fn(pet, device="cpu",
                                     dtype=torch.float32)(bank, acts)
    for (name, _), x in zip(device_env.TRACE_FIELDS, out["trace"]):
        assert torch.equal(trace[name], x), name


@pytest.mark.parametrize("got,want,diff", [
    ([1.0, np.inf, np.nan], [1.5, np.inf, np.nan], 0.5),
    ([1.0, -np.inf], [1.0, np.inf], np.inf),
    ([3, 4, 5], [3, 0, 0], 2.0),
    ([True, False], [True, False], 0.0),
])
def test_max_difference(got, want, diff):
    assert max_difference(torch.tensor(got), torch.tensor(want)) == diff


def test_recorded_cause_codes(fx):
    """The recordings reach acceptance, action 0, op placement and the SLA
    gate; neither records a dep-placement block or an engine failure (the
    single-channel complete topology always finds a free direct link for
    a placed job's flows, and the engine converges)."""
    shipped = set(np.unique(fx["f32"]["trace"]["cause"]).tolist())
    small = set(np.unique(fx["small"]["x64"]["trace"]["cause"]).tolist())
    reached = {device_env.CAUSE_ACCEPTED, device_env.CAUSE_NOT_HANDLED,
               device_env.CAUSE_OP_PLACEMENT, device_env.CAUSE_SLA}
    assert shipped - {-1} == reached
    assert small - {-1} == reached
    assert device_env.CAUSE_DEP_PLACEMENT not in shipped | small
    assert device_env.CAUSE_ENGINE not in shipped | small


def test_tables_need_a_reset_env(small_dir):
    with pytest.raises(ValueError, match="reset"):
        device_env.build_episode_tables(
            PortEnv(**small_surface_kwargs(small_dir)))


def test_cuda_by_default(tables):
    _, pet = tables["small"]
    if torch.cuda.is_available():
        device_env.make_episode_fn(pet)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            device_env.make_episode_fn(pet)
