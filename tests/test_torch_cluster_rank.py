"""K24's ranking as a thread-block cluster computes it, mirrored in numpy
and held against the plain version's SRPT ranks and scores
(``device_env.srpt_dep_ranks`` and ``dep_scores``, which
``price_and_score_plain`` uses); K24's cluster-size choice and the
per-lane extents of K21 and K24 as plain functions; the float64 plain
pricing against the reference's under x64 on non-finite tables.

The mirror follows ``kernels/csrc/pricing.cu``: a lane's valid prefix
[0, m_c) cut into G chunks of ceil(m_c / G) deps; each chunk sorted by
(order-preserving key of -time, index); a dep's rank its place in its own
chunk plus, in every other chunk, the keys below it (a lower chunk's equal
keys counted, a higher one's not); a NaN time's rank plus the M - m_c
invalid tail slots, which sort before it in the reference's sort over all
M slots. Exact integers throughout: the ranks and scores are held bit for
bit, at G = 1, 2, 3, 8 and 16, in float32 and float64.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.lookahead import cluster_chunks, lane_extents

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAN_KEY = 0xfffffffffffffffe
PAD_KEY = 0xffffffffffffffff
CLUSTERS = (1, 2, 3, 8, 16)


def order_keys(times: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """pricing.cu's ``Fp<T>::key`` of -time (+inf's key where not valid):
    order-preserving unsigned 64-bit keys, -0.0 read as 0.0, NaN after
    +inf."""
    x = np.where(valid, -times, np.inf).astype(times.dtype)
    nan = np.isnan(x)
    x = np.where(x == 0, np.zeros_like(x), x)
    if times.dtype == np.float32:
        b = x.view(np.uint32).astype(np.uint64)
        sign, ones = np.uint64(1 << 31), np.uint64(0xffffffff)
    else:
        b = x.view(np.uint64)
        sign, ones = np.uint64(1 << 63), np.uint64(PAD_KEY)
    key = np.where(b & sign, ~b & ones, b | sign)
    return np.where(nan, np.uint64(NAN_KEY), key)


def cluster_ranks(keys: np.ndarray, m_c: int, g: int) -> np.ndarray:
    """Each prefix dep's rank among all ``len(keys)`` slots, as a cluster
    of ``g`` CTAs finds it."""
    m = len(keys)
    chunks = cluster_chunks(m_c, g)
    local = []
    for lo, n in chunks:
        k = keys[lo:lo + n]
        order = np.lexsort((np.arange(n), k))
        local.append((order, k[order]))
    ranks = np.zeros(m_c, np.int64)
    for r, (lo, _) in enumerate(chunks):
        order, sorted_keys = local[r]
        rank = np.arange(len(order), dtype=np.int64)
        for q, (_, other) in enumerate(local):
            if q != r:
                rank += np.searchsorted(other, sorted_keys,
                                        side="right" if q < r else "left")
        rank += np.where(sorted_keys == np.uint64(NAN_KEY), m - m_c, 0)
        ranks[lo + order] = rank
    return ranks


def fuzzed_lanes(rng, m: int, dtype):
    """Lanes of M slots whose valid deps are a prefix: random times with
    ties, zeros of both signs, NaN, +inf and -inf; m_c = 1, m_c = M, an
    all-invalid lane and invalid slots inside a prefix among them.
    Returns (times, valid, n_deps, is_flow, sorted_rank)."""
    m_cs = [1, m, 0, m // 2, 3, m - 1, m // 3, m, m // 5, 2]
    lanes = len(m_cs)
    times = rng.choice([0.0, -0.0, 1.0, 2.5, 1e-3, 7.0],
                       (lanes, m)).astype(dtype)
    spread = rng.rand(lanes, m) < 0.5
    times[spread] = rng.exponential(1.0, spread.sum()).astype(dtype)
    valid = np.zeros((lanes, m), bool)
    for b, m_c in enumerate(m_cs):
        valid[b, :m_c] = True
    times[3, 5], times[3, 9] = np.nan, np.inf          # NaN and +inf
    times[6, 1], times[6, 4] = -np.inf, np.nan
    times[7, :] = np.nan                               # every time NaN
    times[5, :] = 1.5                                  # all tied
    valid[8, 2] = valid[8, 7] = False                  # holes in a prefix
    is_flow = valid & (rng.rand(lanes, m) < 0.8)
    sorted_rank = np.where(valid, rng.randint(0, m, (lanes, m)), 0)
    return (times, valid, np.array(m_cs), is_flow,
            sorted_rank.astype(np.int32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [37, 300, 1031])
def test_cluster_ranks_and_scores_equal_the_plain_version(dtype, m):
    rng = np.random.RandomState(m)
    times, valid, m_cs, is_flow, sorted_rank = fuzzed_lanes(rng, m, dtype)
    t = torch.from_numpy(times)
    want_rank = device_env.srpt_dep_ranks(t, torch.from_numpy(valid))
    want_score = device_env.dep_scores(
        t, torch.from_numpy(valid), torch.from_numpy(is_flow),
        torch.from_numpy(m_cs.astype(np.int32)), torch.from_numpy(sorted_rank))
    keys = order_keys(times, valid)
    for g in CLUSTERS:
        pri = np.zeros_like(times)
        for b, m_c in enumerate(m_cs):
            ranks = cluster_ranks(keys[b], int(m_c), g)
            np.testing.assert_array_equal(
                ranks, want_rank[b, :m_c].numpy().astype(np.int64),
                err_msg=f"lane {b} at G={g}")
            pri[b, :m_c] = ranks
        pri = np.where(is_flow, pri, 0).astype(dtype)
        m_t = torch.from_numpy(m_cs.astype(dtype))[:, None]
        got = device_env._score(torch.from_numpy(pri), m_t,
                                torch.from_numpy(sorted_rank.astype(dtype)))
        assert torch.equal(got, want_score), f"scores at G={g}"


def test_nan_rank_counts_the_invalid_tail():
    times = np.array([1.0, np.nan, 2.0, 0.0, 0.0], np.float32)
    valid = np.array([True, True, True, False, False])
    want = device_env.srpt_dep_ranks(torch.from_numpy(times)[None],
                                     torch.from_numpy(valid)[None])[0]
    # ascending -time: 2.0 (index 2), 1.0 (0), the two invalid slots, NaN
    assert want[:3].tolist() == [1.0, 4.0, 0.0]
    for g in CLUSTERS:
        assert cluster_ranks(order_keys(times, valid), 3, g).tolist() == \
            [1, 4, 0]


def test_order_keys_order_like_the_sort():
    vals = np.array([-np.inf, -3.0, -0.0, 0.0, 1e-30, 2.0, np.inf, np.nan],
                    np.float64)
    for dtype in (np.float32, np.float64):
        x = vals.astype(dtype)
        keys = order_keys(-x, np.ones(len(x), bool))   # keys of x itself
        assert (np.diff(keys.astype(object)) >= 0).all()
        assert keys[2] == keys[3]                       # -0.0 == 0.0
        inf_key = order_keys(np.zeros(1, dtype), np.zeros(1, bool))[0]
        assert keys[6] == inf_key < keys[7] == NAN_KEY


@pytest.mark.parametrize("lanes,want", [(1, 16), (2, 16), (8, 16), (9, 16),
                                        (10, 8), (16, 8), (33, 4), (37, 4),
                                        (38, 2), (72, 2), (74, 2), (75, 1),
                                        (132, 1), (500, 1)])
def test_choose_cluster_fills_the_card_in_about_one_wave(lanes, want):
    assert kernels.choose_cluster(lanes, 132) == want
    # at most an eighth of the clusters wait for a second wave
    assert lanes * want <= 132 * 9 // 8 or want == 1


def test_choose_cluster_respects_what_the_card_runs_at_once():
    # the H100's count: seven clusters of 16 at once, fifteen of 8 (its
    # GPCs do not all hold 16 SMs)
    fits = {2: 66, 4: 30, 8: 15, 16: 7}.get
    assert kernels.choose_cluster(8, 132, fits) == 8
    assert kernels.choose_cluster(7, 132, fits) == 16
    assert kernels.choose_cluster(72, 132, fits) == 2
    assert kernels.choose_cluster(75, 132, fits) == 1
    assert kernels.choose_cluster(8, 132, lambda g: 0) == 1


@pytest.mark.parametrize("extent", [0, 1, 2, 5, 16, 17, 480, 13072])
def test_cluster_chunks_cover_the_extent_once(extent):
    for g in range(1, 17):
        chunks = cluster_chunks(extent, g)
        assert len(chunks) == g
        covered = [i for lo, n in chunks for i in range(lo, lo + n)]
        assert covered == list(range(extent))
        assert max(n for _, n in chunks) == -(-extent // g)


def test_lane_extents_are_one_past_the_last_valid_slot():
    rng = np.random.RandomState(4)
    valid = rng.rand(64, 40) < rng.uniform(0, 0.3, (64, 1))
    valid[0] = False
    valid[1, -1] = True
    got = lane_extents(torch.from_numpy(valid)).tolist()
    want = [int(np.flatnonzero(v).max()) + 1 if v.any() else 0
            for v in valid]
    assert got == want
    assert got[0] == 0 and got[1] == 40
    assert lane_extents(torch.zeros((3, 0), dtype=torch.bool)).tolist() == \
        [0, 0, 0]


def test_shipped_tables_keep_the_valid_slots_as_prefixes():
    """K24 prices and ranks only [0, n_deps) and [0, n_ops) of a lane's
    config, and K21 walks to the last valid slot: the shipped surface's
    tables hold every valid dep and op in those prefixes."""
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture

    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    tb = device_env.build_episode_tables(env).tables
    for k in range(len(tb["n_deps"])):
        m_c, n_c = tb["n_deps"][k], tb["n_ops"][k]
        assert tb["dep_valid"][k, :m_c].all()
        assert not tb["dep_valid"][k, m_c:].any()
        assert tb["op_valid"][k, :n_c].all()
        assert not tb["op_valid"][k, n_c:].any()
    extents = lane_extents(torch.from_numpy(tb["dep_valid"]))
    assert extents.tolist() == tb["n_deps"].tolist()


def test_plain_fma64_is_fused_and_keeps_infinities():
    """K24's float64 plain version fuses ``a * b + c`` (Dekker and TwoSum
    error terms); with a non-finite product or addend it gives IEEE's
    fused result, an infinity or NaN, as the kernel's ``__fma_rn`` does
    (the error terms alone would be NaN)."""
    from fractions import Fraction

    rng = np.random.RandomState(5)
    a, b, c = (rng.randn(200) * 10.0 ** rng.randint(-12, 12, 200)
               for _ in range(3))
    got = device_env._fma64(*(torch.from_numpy(x) for x in (a, b, c)))
    want = [float(Fraction(x) * Fraction(y) + Fraction(z))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got.numpy(), want)
    inf, nan = np.inf, np.nan
    cases = [((inf, 2.0, 1.0), inf), ((-inf, 2.0, 1.0), -inf),
             ((2.0, 3.0, inf), inf), ((inf, 1.0, -inf), nan),
             ((nan, 1.0, 1.0), nan), ((0.0, inf, 1.0), nan)]
    for args, want in cases:
        got = device_env._fma64(*(torch.tensor([x], dtype=torch.float64)
                                  for x in args))
        np.testing.assert_array_equal(got.numpy(), [want], err_msg=args)


_X64_POISON_SCRIPT = textwrap.dedent("""
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

    d = tempfile.mkdtemp(prefix="cluster_rank_x64_")
    generate_pipedream_txt_files(d, n_cnn=2, n_translation=1, seed=5)
    jenv, penv = (JaxEnv(**small_surface_kwargs(d)),
                  PortEnv(**small_surface_kwargs(d)))
    jenv.reset(seed=17)
    penv.reset(seed=17)
    jet = jax_env.build_episode_tables(jenv)
    pet = device_env.build_episode_tables(penv)
    dev = device_env.DeviceTables(pet, "cpu", torch.float64)
    rng = np.random.RandomState(11)
    size = pet.tables["dep_size"].copy()
    for k in range(len(size)):
        m_c = int(pet.tables["n_deps"][k])
        hit = rng.choice(m_c, max(1, m_c // 4), replace=False)
        size[k, hit] = rng.choice([np.nan, np.inf, -np.inf], len(hit))
    msg = {{}}
    for poison, grp, sync in (("nan", np.nan, np.nan),
                              ("inf", np.inf, -np.inf)):
        msg[poison] = {{k: pet.tables[k].copy()
                       for k in ("grp_msg", "sync_msg")}}
        msg[poison]["grp_msg"][::3] = grp
        msg[poison]["sync_msg"][1::3] = sync
    # every config twice, each valid op on a random server (the rest -1):
    # one-to-one edges and asymmetric groups cross servers
    cfg = np.tile(np.arange(dev.n_cfg, dtype=np.int32), 2)
    valid = pet.tables["op_valid"][cfg]
    ots = torch.from_numpy(np.where(
        valid, rng.randint(0, pet.n_srv, valid.shape), -1).astype(np.int32))
    seen = set()
    for poison in ("nan", "inf"):
        tables = {{"dep_size": size if poison == "nan" else
                   np.where(np.isnan(size), np.inf, size), **msg[poison]}}
        for k, v in tables.items():
            jet.tables[k] = jnp.asarray(v)
            dev.t[k] = torch.from_numpy(v)
        priced = device_env.price_and_score_plain(
            ots, torch.from_numpy(cfg), dev)
        price = jax.jit(lambda sc, c: jax_env.jax_price_and_score(
            sc, c, jet.tables, jet.st, jet.pads, jet.comm,
            jet.pair_channel))
        for b in range(len(cfg)):
            want = price(jnp.asarray(ots[b].numpy()), jnp.int32(cfg[b]))
            for name, w, g in zip(("times", "is_flow", "chan", "op_score",
                                   "dep_score", "finite_ok"), want, priced):
                w, g = np.asarray(w), g[b].numpy()
                what = (poison, name, b)
                if w.dtype.kind != "f":
                    assert np.array_equal(w, g), what
                    continue
                assert np.array_equal(np.isnan(w), np.isnan(g)), what
                assert np.array_equal(np.isinf(w) & (w > 0),
                                      np.isinf(g) & (g > 0)), what
                assert np.array_equal(np.isinf(w) & (w < 0),
                                      np.isinf(g) & (g < 0)), what
                fin = np.isfinite(w)
                assert np.all(np.abs(g[fin] - w[fin]) <= {rel!r} *
                              np.maximum(np.abs(w[fin]), 1e-300)), what
                if name == "times":
                    seen.update(x for x, hit in (
                        ("nan", np.isnan(w).any()),
                        ("+inf", np.isposinf(w).any()),
                        ("-inf", np.isneginf(w).any())) if hit)
            seen.add("not finite_ok" if not bool(want[5]) else "finite_ok")
    assert {{"nan", "+inf", "-inf", "not finite_ok"}} <= seen, seen
    print("X64_POISON_OK", sorted(seen))
""")


def test_plain_pricing_equals_reference_on_non_finite_tables_x64():
    """``price_and_score_plain`` (whose float64 ``_fma64`` keeps a
    non-finite product or addend) against the reference's
    ``jax_price_and_score`` under x64, on random placements of every
    config of the small surface, with the tables' dep sizes poisoned to
    NaN, +inf and -inf and collective messages to NaN (then the NaN sizes
    as +inf, messages to +inf and -inf): NaN and each sign of infinity in
    the same slots, integers and masks equal, finite values within rel
    1e-9 (the stated float64 limit of the pricing tests)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
    res = subprocess.run(
        [sys.executable, "-c",
         _X64_POISON_SCRIPT.format(repo=REPO, rel=1e-9)],
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    assert "X64_POISON_OK" in res.stdout
