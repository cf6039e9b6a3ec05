"""The port's lookahead memo (``ddls_tpu_torch/sim/device_memo.py``: the
plain versions of K27 ``memo_probe`` and K28 ``memo_insert``) against the
JAX package's ``sim/jax_memo.py``:

(a) ``canonical_groups`` equals the reference's and the host's
    ``np.unique`` canonicalisation; the hash weights are the reference's;
(b) the recorded decisions of the reference memo (``memo_lookahead``
    jitted, driven alone on 48 keys of the small surface's tables through
    a 4-set, 2-way table; ``device_collect_recorded.npz``): the value
    served, the set, the counters after every call, equal in float32 and
    in float64 (whose times are two key words, low word first);
(c) the counterparts of the reference's unit pins
    (``tests/test_jax_memo.py:70,90,119,134``): a forced collision
    recomputes and never serves the colliding entry, eviction is
    round-robin and deterministic, -0.0 never aliases 0.0, the knob
    resolves as the reference's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddls_tpu.sim import jax_memo
from ddls_tpu_torch.sim import device_memo
from ddls_tpu_torch.sim.fixture import load_device_collect_fixture

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def recorded():
    return load_device_collect_fixture()["memo"]


def test_canonical_groups_match_reference_and_host():
    canonical = jax.jit(jax_memo.canonical_groups)
    r = np.random.RandomState(7)
    for case in range(40):
        n = (1, 6, 13)[case % 3]        # three shapes: one compile each
        sc = r.randint(-1, 5, n).astype(np.int32)
        n_valid = int(r.randint(1, n + 1))
        valid = np.zeros(n, bool)
        valid[:n_valid] = True
        _, first_idx, inv = np.unique(sc[:n_valid], return_index=True,
                                      return_inverse=True)
        host = np.full(n, -1, np.int32)
        host[:n_valid] = np.argsort(np.argsort(first_idx))[inv]
        want = np.asarray(canonical(jnp.asarray(sc), jnp.asarray(valid)))
        got = device_memo.canonical_groups(
            torch.from_numpy(sc)[None], torch.from_numpy(valid)[None])[0]
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, host)


def test_hash_weights_and_knob_are_the_reference_ones():
    for n in (1, 17, 13553):
        np.testing.assert_array_equal(device_memo._hash_weights(n),
                                      jax_memo._hash_weights(n))
    cfg = device_memo.MemoConfig()
    assert (cfg.n_sets, cfg.n_ways) == (64, 2)
    assert device_memo.resolve_memo_cfg("auto", 1) == cfg
    assert device_memo.resolve_memo_cfg("auto", 8) == cfg
    assert device_memo.resolve_memo_cfg(None, 8) is None
    small = device_memo.MemoConfig(4, 1)
    assert device_memo.resolve_memo_cfg(small, 2) is small
    with pytest.raises(ValueError, match="memo_cfg"):
        device_memo.resolve_memo_cfg(True, 1)
    with pytest.raises(ValueError, match="n_lanes"):
        device_memo.resolve_memo_cfg("auto", 0)


def _probe(memo, op_valid, cfg, ots, times, value, ok=True):
    """One memo_lookahead call of one lane whose compute returns
    ``value``: (the value served, the probe)."""
    seen = {}

    def compute(skip):
        seen["skip"] = bool(skip[0])
        return (torch.tensor([value], dtype=times.dtype),
                torch.tensor([ok]))

    probe = device_memo.memo_probe(
        memo, torch.tensor([cfg], dtype=torch.int32), torch.tensor([True]),
        torch.as_tensor(ots, dtype=torch.int32)[None], op_valid,
        times[None], 8)
    t, ok_la = compute(probe["skip"])
    device_memo.memo_insert(memo, probe, torch.tensor([cfg],
                                                      dtype=torch.int32),
                            torch.tensor([True]), times[None], t, ok_la)
    assert seen["skip"] == bool(probe["hit"][0])
    return float(t[0]), probe


@pytest.fixture(scope="module")
def op_valid(tmp_path_factory):
    """The small surface's op-valid table (the recorded keys' config rows
    index it), from the port's own tables."""
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.graphs.synthetic import generate_pipedream_txt_files
    from ddls_tpu_torch.sim import device_env
    from ddls_tpu_torch.sim.fixture import memo_surface_kwargs

    d = str(tmp_path_factory.mktemp("memo_profiles"))
    generate_pipedream_txt_files(d, n_cnn=1, n_translation=1, seed=9,
                                 min_ops=4, max_ops=6)
    env = RampJobPartitioningEnvironment(**memo_surface_kwargs(d))
    env.reset(seed=0)
    return torch.from_numpy(
        device_env.build_episode_tables(env).tables["op_valid"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_recorded_memo_decisions(recorded, op_valid, dtype):
    rec = recorded[dtype]
    tdt = torch.float32 if dtype == "float32" else torch.float64
    n, m = rec["ots"].shape[1], rec["times"].shape[1]
    cfg_tab = device_memo.MemoConfig(int(rec["n_sets"]), int(rec["n_ways"]))
    memo = device_memo.memo_init(1, n, m, tdt, cfg_tab, "cpu")
    active = torch.tensor([True])
    for i, k in enumerate(rec["sequence"]):
        cfg = torch.tensor([rec["cfg"][k]], dtype=torch.int32)
        times = torch.from_numpy(rec["times"][k])[None]
        probe = device_memo.memo_probe(
            memo, cfg, active, torch.from_numpy(rec["ots"][k])[None],
            op_valid, times, 8)
        t = torch.tensor([i + 0.5], dtype=tdt)
        ok = torch.tensor([i % 3 != 0])
        device_memo.memo_insert(memo, probe, cfg, active, times, t, ok)
        assert int(probe["set"][0]) == int(rec["set"][i]), i
        assert t.numpy()[0] == rec["t"][i] and bool(ok[0]) == rec["ok"][i]
        for key in ("hits", "misses", "evicts"):
            assert int(memo[key][0]) == int(rec[key][i]), (i, key)
    assert int(memo["hits"][0]) > 0 and int(memo["evicts"][0]) > 0


def _unit_key(seed, n=4, m=6):
    r = np.random.RandomState(seed)
    return r.randint(0, 3, n), torch.from_numpy(r.rand(m).astype(np.float32))


def test_forced_collision_recomputes():
    memo = device_memo.memo_init(1, 4, 6, torch.float32,
                                 device_memo.MemoConfig(1, 1), "cpu")
    valid = torch.ones((1, 4), dtype=torch.bool)
    (oa, ta), (ob, tb) = _unit_key(1), _unit_key(2)
    t, _ = _probe(memo, valid, 0, oa, ta, 1.5)
    assert t == 1.5
    t, _ = _probe(memo, valid, 0, ob, tb, 2.5)
    assert t == 2.5, "a collision served the colliding entry"
    assert [int(memo[k][0]) for k in ("hits", "misses", "evicts")] == [0, 2,
                                                                       1]
    t, probe = _probe(memo, valid, 0, ob, tb, 9.5)
    assert t == 2.5 and bool(probe["hit"][0])
    t, _ = _probe(memo, valid, 0, oa, ta, 7.25)
    assert t == 7.25


def test_eviction_is_round_robin_and_deterministic():
    valid = torch.ones((1, 4), dtype=torch.bool)
    keys = [_unit_key(s) for s in (1, 2, 3)]

    def drive():
        memo = device_memo.memo_init(1, 4, 6, torch.float32,
                                     device_memo.MemoConfig(1, 2), "cpu")
        for i, (o, t) in enumerate(keys):
            _probe(memo, valid, 0, o, t, float(i))
        return memo

    m1, m2 = drive(), drive()
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    assert _probe(m1, valid, 0, *keys[1], 8.0)[0] == 1.0
    assert _probe(m1, valid, 0, *keys[2], 8.0)[0] == 2.0
    assert _probe(m1, valid, 0, *keys[0], 8.0)[0] == 8.0


def test_zero_and_negative_zero_never_alias():
    memo = device_memo.memo_init(1, 4, 6, torch.float64,
                                 device_memo.MemoConfig(1, 2), "cpu")
    valid = torch.ones((1, 4), dtype=torch.bool)
    o, _ = _unit_key(1)
    tz = torch.zeros(6, dtype=torch.float64)
    _probe(memo, valid, 0, o, tz, 1.0)
    t, probe = _probe(memo, valid, 0, o, -tz, 2.0)
    assert t == 2.0 and int(memo["hits"][0]) == 0
    # another placement with the same grouping is the same key
    t, probe = _probe(memo, valid, 0, (o + 1) % 3 + 3, tz, 3.0)
    assert t == 1.0 and bool(probe["hit"][0])


def test_inactive_lanes_probe_nothing():
    memo = device_memo.memo_init(2, 4, 6, torch.float32,
                                 device_memo.MemoConfig(2, 2), "cpu")
    cfg = torch.zeros(2, dtype=torch.int32)
    active = torch.tensor([True, False])
    ots = torch.tensor([[0, 1, 1, 2], [3, 3, 0, 1]], dtype=torch.int32)
    times = torch.rand(2, 6, generator=torch.Generator().manual_seed(0))
    valid = torch.ones((1, 4), dtype=torch.bool)
    probe = device_memo.memo_probe(memo, cfg, active, ots, valid, times, 8)
    assert probe["skip"].tolist() == [False, True]
    assert probe["groups"][1].tolist() == [-1] * 4
    t, ok = torch.tensor([1.0, 5.0]), torch.tensor([True, True])
    device_memo.memo_insert(memo, probe, cfg, active, times, t, ok)
    assert t.tolist() == [1.0, 5.0]
    assert memo["misses"].tolist() == [1, 0]
    assert int((memo["key_cfg"][1] >= 0).sum()) == 0
    summary = device_memo.summarize_counters(memo)
    assert summary == {"hits": 0, "misses": 1, "evicts": 0, "hit_rate": 0.0}
