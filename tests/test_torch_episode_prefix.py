"""What the redesigned K25 (``episode_step``) and K29 (``price_reduce``)
rely on, and K21's NaN minimum, held on the CPU:

(a) on all 45 configurations of the shipped surface, in float32 and
    float64: ``price_and_score_plain`` writes no flow past the
    configuration's ``n_deps`` (``chan`` -1 there) and ``op_valid`` is the
    prefix ``[0, n_ops)``; ``episode_step_plain`` and
    ``price_reduce_plain`` give the same outputs on recorded states with
    each lane's dep tail cut off and its op tail unplaced;
(b) a numpy mirror of K25's event clock in the kernel's order (warp 0's
    slots in registers, the least remaining time as a tree over the warp
    that takes the upper half's value only when strictly less, the
    completions as ballots, the launch's completed slots freed once after
    the loop) bit-equal to ``EpisodeKernels.advance`` on every decision of
    the recorded replays (``device_env_replay.npz``: the eight float32
    banks and the x64 bank, driven by their recorded decisions) and of
    C1's bank (three ticks of four completions) in float32 and float64,
    and of plain episodes on 64 and 128 servers, where a lane of the warp
    owns 2 and 4 slots;
    and the freeing's condition, that the completed slots of one launch
    share no server with a nonzero freed memory, on every one of them;
(c) the JAX engine (``jax_lookahead``, as the JAX package's tests run it
    on the CPU) and ``lookahead_plain`` on recorded lanes with NaN
    remaining times of either sign: both propagate the NaN, bit for bit
    the same answers.
"""
import copy

import numpy as np
import pytest
import torch

from ddls_tpu.sim import jax_lookahead as jl
from ddls_tpu_torch import scenarios
from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
from ddls_tpu_torch.scenarios import conformance
from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim import lookahead as lookahead_mod
from ddls_tpu_torch.sim.fixture import (load_device_env_fixture,
                                        load_scenario_fixture, nan_lanes,
                                        wide_episode_tables)

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)
# the recorded replays' decisions whose states (a) cuts
CUT_DECISIONS = (0, 60)
# the decisions of the plain episodes on 64 and 128 servers in (b)
WIDE_DECISIONS = 12
WARP = 32


@pytest.fixture(scope="module")
def shipped():
    env = RampJobPartitioningEnvironment(**copy.deepcopy(
        load_checkpoint_fixture("ppo_price_mixed")["env_config"]),
        device="cpu")
    env.reset(seed=0)
    return device_env.build_episode_tables(env)


@pytest.fixture(scope="module")
def replay():
    return load_device_env_fixture()


def _bank(banks, lanes, dtype):
    return {name: torch.from_numpy(np.ascontiguousarray(banks[name][lanes]))
            .to(want or dtype) for name, want in device_env.BANK_FIELDS}


def _trace(rec, dtype):
    """A recorded trace's arrays as tensors, the floats in ``dtype``."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
           rec.items()}
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in out.items()}


# ----------------------------------------------------------------- (a)
@pytest.mark.parametrize("dtype", DTYPES)
def test_pricing_writes_no_flow_past_the_prefix(shipped, dtype):
    et = shipped
    dev = device_env.device_tables(et, "cpu", dtype)
    n_ops, n_deps = et.tables["n_ops"], et.tables["n_deps"]
    assert n_deps.min() == 21 and n_deps.max() == dev.pads.n_deps
    cols = np.arange(dev.pads.n_ops)
    np.testing.assert_array_equal(et.tables["op_valid"],
                                  cols[None] < n_ops[:, None])
    rng = np.random.RandomState(3)
    cfg = np.arange(dev.n_cfg)
    ots = np.where(et.tables["op_valid"][cfg],
                   rng.randint(0, et.n_srv, (len(cfg), len(cols))), -1)
    _, is_flow, chan, _, _, _ = device_env.price_and_score_plain(
        torch.from_numpy(ots.astype(np.int32)),
        torch.from_numpy(cfg.astype(np.int32)), dev)
    tail = np.arange(dev.pads.n_deps)[None] >= n_deps[cfg][:, None]
    assert not is_flow.numpy()[tail].any()
    assert (chan.numpy()[tail] == -1).all()
    assert is_flow.any(1).sum() > dev.n_cfg // 2


def _recorded_raw(ek, state, bank, jct):
    """The decision's placement and pricing of each lane's config (the
    plain versions), its lookahead time ``jct`` [B] (the recorded one)
    over the job's steps."""
    dev = ek.dev
    free = state["srv_job"] < 0
    ots, new_mem, ok_place = device_env.allocate_job_plain(
        state["mem"], free, state["cfg"], dev)
    _, is_flow, chan, _, _, finite_ok = device_env.price_and_score_plain(
        ots, state["cfg"], dev)
    row = state["queue_row"].clamp(min=0).long()[:, None]
    steps = bank["steps"].gather(1, row)[:, 0]
    lanes = ots.shape[0]
    return {"ots": ots, "new_mem": new_mem, "ok_place": ok_place,
            "is_flow": is_flow, "chan": chan, "finite_ok": finite_ok,
            "t_step": jct / steps,
            "ok_la": torch.ones(lanes, dtype=torch.bool),
            "ticks": torch.zeros(lanes, dtype=torch.int32)}


def _price_rows(ek, state, bank, rng):
    """K29's row inputs for every degree of each lane's queued job
    (``EpisodeKernels.price_rows`` without the lookahead: its time and
    verdict random): ``(cfg, (is_flow, chan, ok_place, finite_ok,
    t_step, ok_la))``."""
    dev = ek.dev
    lanes = state["queue_row"].shape[0]
    row = state["queue_row"].clamp(min=0).long()[:, None]
    cfg = (bank["type"].gather(1, row) * dev.n_deg
           + dev.deg_arange).reshape(-1).to(torch.int32)
    lane = torch.arange(lanes * dev.n_deg, dtype=torch.int32) // dev.n_deg
    ots, _, ok_place = device_env.allocate_job_plain(
        state["mem"], state["srv_job"] < 0, cfg, dev, lane)
    _, is_flow, chan, _, _, finite_ok = device_env.price_and_score_plain(
        ots, cfg, dev)
    rows = len(cfg)
    t_step = torch.from_numpy(rng.uniform(1, 50, rows)).to(dev.dtype)
    ok_la = torch.from_numpy(rng.rand(rows) < 0.9)
    return cfg, (is_flow, chan, ok_place, finite_ok, t_step, ok_la)


def _cut(raw, lane, n_deps, n_ops):
    """Lane ``lane`` of ``raw`` alone, its deps cut to ``[0, n_deps)`` and
    its ops past ``n_ops`` unplaced."""
    one = {k: v[lane:lane + 1].clone() for k, v in raw.items()}
    one["is_flow"] = one["is_flow"][:, :n_deps].contiguous()
    one["chan"] = one["chan"][:, :n_deps].contiguous()
    one["ots"][:, n_ops:] = -1
    return one


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_step_and_reduce_ignore_the_tails(shipped, replay, dtype):
    """On recorded states of the eight shipped banks: K25's and K29's plain
    versions give each lane's (row's) outputs bit for bit from its
    prefixes alone."""
    et = shipped
    ek = device_env.episode_kernels(et, device="cpu", dtype=dtype)
    dev = ek.dev
    lanes = list(range(8))
    bank = _bank(replay["banks"], lanes, dtype)
    trace_rec = _trace(replay["f32"]["trace"], dtype)
    acts = torch.from_numpy(np.stack([replay["actions"]] * 8)).to(
        torch.int32)
    state = ek.init_state(bank, acts)
    n_deps, n_ops = et.tables["n_deps"], et.tables["n_ops"]
    rng = np.random.RandomState(5)
    checked = 0
    for d in range(max(CUT_DECISIONS) + 1):
        raw = _recorded_raw(ek, state, bank, trace_rec["jct"][:, d])
        if d in CUT_DECISIONS:
            # K29 on every degree of each lane's queued job
            cfg, reduce = _price_rows(ek, state, bank, rng)
            is_flow, chan, ok_place, finite_ok, t_step, ok_la = reduce
            whole = device_env.price_reduce_plain(*reduce, state, bank)
            assert bool(whole[0].any()) and not bool(whole[0].all())
            for r, c in enumerate(cfg.tolist()):
                lane, j = divmod(r, dev.n_deg)
                one = {k: v[lane:lane + 1] for k, v in state.items()}
                sl = slice(r, r + 1)
                got = device_env.price_reduce_plain(
                    is_flow[sl, :n_deps[c]], chan[sl, :n_deps[c]],
                    ok_place[sl], finite_ok[sl], t_step[sl], ok_la[sl], one,
                    {k: v[lane:lane + 1] for k, v in bank.items()})
                for g, w in zip(got, whole):
                    assert torch.equal(g[0, 0], w[lane, j]), (d, r)
            # K25 on each lane alone, cut
            after = {k: v.clone() for k, v in state.items()}
            tr = {k: torch.zeros_like(v) for k, v in trace_rec.items()}
            device_env.episode_step_plain(ek, after, bank, acts, raw, tr, d)
            for lane in lanes:
                c = int(state["cfg"][lane])
                one = {k: v[lane:lane + 1].clone() for k, v in state.items()}
                tr1 = {k: torch.zeros_like(v[lane:lane + 1])
                       for k, v in trace_rec.items()}
                device_env.episode_step_plain(
                    ek, one, {k: v[lane:lane + 1] for k, v in bank.items()},
                    acts[lane:lane + 1], _cut(raw, lane, n_deps[c],
                                              n_ops[c]), tr1, d)
                for k in state:
                    assert torch.equal(one[k][0], after[k][lane]), (d, k)
                for k in tr:
                    assert torch.equal(tr1[k][0], tr[k][lane]), (d, k)
            checked += 1
        device_env.episode_step_plain(ek, state, bank, acts, raw,
                                      {k: torch.zeros_like(v)
                                       for k, v in trace_rec.items()}, d)
    assert checked == len(CUT_DECISIONS)


# ----------------------------------------------------------------- (b)
def _warp_first_min(v):
    """common.cuh warp_first_min: after the step of distance d lane i
    holds the least of lanes [i, i + 2d); the upper half's value wins only
    when strictly less. ``v`` a list of 32 numpy scalars."""
    v = list(v)
    d = 1
    while d < WARP:
        v = [v[i + d] if i + d < WARP and v[i + d] < v[i] else v[i]
             for i in range(WARP)]
        d *= 2
    return v[0]


def mirror_advance(s, arrival_t, et, dt):
    """K25's event clock and its freeing for one lane, in the kernel's
    order (``episode.cu``): ``s`` the lane's state as numpy arrays and
    scalars, updated in place. Returns the completed slots in slot order
    (empty when the lane ran no tick)."""
    R = len(s["slot_valid"])
    K = -(-R // WARP)
    J = len(arrival_t) - 1
    sim_end, eps = dt(et.sim_end), dt(et.eps)
    inf = dt(np.inf)
    valid = s["slot_valid"].copy()
    t_done = s["slot_t_done"]
    t, nxt = s["t"], s["next_arrival"]
    ptr, q_row, done = s["ptr"], s["queue_row"], s["done"]
    freed, ticked = [], False
    while q_row < 0 and not done:
        ticked = True
        per_lane = []
        for ln in range(WARP):
            rem = inf
            for r in range(ln * K, min(ln * K + K, R)):
                if valid[r]:
                    left = t_done[r] - t
                    rem = left if left < rem else rem
            per_lane.append(rem)
        rem = _warp_first_min(per_lane)
        to_arrival, to_end = nxt - t, sim_end - t
        tick = to_end if to_end < to_arrival else to_arrival
        tick = rem if rem < tick else tick
        tick = tick if tick > 0 else dt(0)
        t2 = t + tick
        comp = valid & ((t_done - t2) - eps <= 0)
        n_done = int(comp.sum())           # the ballots' popcounts
        valid &= ~comp
        freed += [int(r) for r in np.flatnonzero(comp)]
        s["completed"] += n_done
        arrived = ptr < J and t2 + eps >= nxt
        q_row2 = ptr if arrived else q_row
        ptr2 = ptr + int(arrived)
        if arrived:
            nxt = arrival_t[min(max(ptr2, 0), J)]
        q_row, ptr = q_row2, ptr2
        done = bool(t2 >= sim_end or (ptr2 >= J and not valid.any()
                                      and q_row2 < 0))
        t = t2
    s.update(slot_valid=valid, t=t, next_arrival=nxt, ptr=ptr,
             queue_row=q_row, done=done)
    if ticked:
        # the launch's completions freed once, summed in slot order: the
        # kernel lists lane ln's [ln K, ln K + K) after the lanes before it
        freed = [r for ln in range(WARP)
                 for r in range(ln * K, min(ln * K + K, R)) if r in freed]
        add = np.zeros_like(s["mem"])
        srv = np.zeros(len(s["mem"]), bool)
        chan = np.zeros(len(s["chan_occ"]), bool)
        for r in freed:
            add = add + s["slot_mem"][r]
            srv |= s["slot_servers"][r]
            chan |= s["slot_chan"][r]
        s["mem"] = s["mem"] + add
        s["srv_job"][srv] = -1
        s["chan_occ"][chan] = -1
    return freed


MIRRORED = ("t", "mem", "srv_job", "chan_occ", "slot_valid", "slot_t_done",
            "queue_row", "ptr", "next_arrival", "done", "completed")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32 if x.dtype == np.float32 else np.uint64) \
        if x.dtype.kind == "f" else x


class Mirror:
    """Holds ``mirror_advance`` against ``EpisodeKernels.advance`` on each
    state it is handed, lane by lane, and the freeing's condition: the
    completed slots of one launch hold disjoint nonzero memory columns."""

    def __init__(self, et, dtype):
        self.et = et
        self.dt = np.float32 if dtype == torch.float32 else np.float64
        self.launches = self.multi = self.completions = 0
        # clocks that found two running slots in one warp lane's block,
        # and the highest running slot seen
        self.shared, self.top = 0, -1

    def advance(self, ek, state, bank):
        before = {k: v.numpy().copy() for k, v in state.items()}
        ek.advance(state, bank)
        arrival = bank["arrival_t"].numpy()
        for lane in range(before["t"].shape[0]):
            s = {k: (v[lane].copy() if v.ndim > 1 else v[lane].item())
                 for k, v in before.items()}
            for k in ("t", "next_arrival"):
                s[k] = self.dt(s[k])
            running = np.flatnonzero(s["slot_valid"])
            K = -(-len(s["slot_valid"]) // WARP)
            self.shared += bool(len(running)) and \
                np.bincount(running // K).max() >= 2
            self.top = max(self.top, *running, -1)
            freed = mirror_advance(s, arrival[lane], self.et, self.dt)
            for k in MIRRORED:
                want = state[k][lane].numpy()
                got = np.asarray(s[k], dtype=want.dtype)
                assert np.array_equal(_bits(got), _bits(want)), (lane, k)
            nonzero = before["slot_mem"][lane][freed] != 0
            assert (nonzero.sum(0) <= 1).all(), (lane, freed)
            self.launches += 1
            self.completions += len(freed)
            self.multi += len(freed) > 1


def _commit(ek, state, bank, raw, jct):
    """The commit of lanes that the recording accepted with ``jct`` [B]:
    ``EpisodeKernels.decision``'s masks and first free slot, done at
    ``t + jct``."""
    ev = ek.eval_cfg(state, bank, raw)
    assert bool(ev["ok_place"].all() & ev["ok_chan"].all())
    assert not bool(state["slot_valid"].all(1).any())
    slot = state["slot_valid"].to(torch.int8).argmin(1)
    for lane in range(len(jct)):
        r = int(slot[lane])
        state["slot_valid"][lane, r] = True
        state["slot_t_done"][lane, r] = state["t"][lane] + jct[lane]
        state["slot_mem"][lane, r] = state["mem"][lane] - \
            ev["new_mem"][lane]
        state["slot_servers"][lane, r] = ev["srv_mask"][lane]
        state["slot_chan"][lane, r] = ev["chan_mask"][lane]
        state["srv_job"][lane, ev["srv_mask"][lane]] = r
        state["chan_occ"][lane, ev["chan_mask"][lane]] = r
        state["mem"][lane] = ev["new_mem"][lane]


@pytest.mark.parametrize("which", ["f32", "x64"])
def test_mirror_is_the_plain_clock_on_the_recorded_replays(shipped, replay,
                                                           which):
    """Every decision of the recorded replays (float32: 8 banks; x64: bank
    0), each driven by its recorded accepts and jcts over the plain
    placement's and pricing's masks; the state after each clock equals the
    recording's next decision time."""
    dtype = torch.float32 if which == "f32" else torch.float64
    trace = _trace(replay[which]["trace"], dtype)
    lanes = list(range(trace["t"].shape[0]))
    ek = device_env.episode_kernels(shipped, device="cpu", dtype=dtype)
    bank = _bank(replay["banks"], lanes, dtype)
    D = trace["t"].shape[1]
    acts = torch.from_numpy(np.stack([replay["actions"][:D]] * len(lanes)))
    state = ek.init_state(bank, acts.to(torch.int32))
    mirror = Mirror(shipped, dtype)
    for d in range(D):
        ek.prepare(state, bank, acts[:, d].to(torch.int32))
        accept = trace["accept"][:, d]
        if bool(accept.any()):
            sub = torch.from_numpy(np.flatnonzero(accept.numpy()))
            part = {k: v[sub].clone() for k, v in state.items()}
            part_bank = {k: v[sub] for k, v in bank.items()}
            jct = trace["jct"][sub, d]
            raw = _recorded_raw(ek, part, part_bank, jct)
            _commit(ek, part, part_bank, raw, jct)
            for k in state:
                state[k][sub] = part[k]
        state["queue_row"] = torch.where(trace["has_job"][:, d], -1,
                                         state["queue_row"])
        mirror.advance(ek, state, bank)
        if d + 1 < D:
            nxt = trace["has_job"][:, d + 1]
            assert torch.equal(state["t"][nxt], trace["t"][nxt, d + 1]), d
    assert mirror.multi > 0 and mirror.completions > 100


@pytest.mark.parametrize("dtype", DTYPES)
def test_mirror_is_the_plain_clock_on_c1(dtype):
    """C1's bank through the plain versions (placement, pricing, the
    lookahead), each clock held against the mirror: three ticks of four
    completions; in float32 the recording's trace."""
    rec = load_scenario_fixture()["c1"]
    env = conformance.build_env(scenarios.canonical_spec(), "host",
                                device="cpu")
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    ek = device_env.episode_kernels(et, device="cpu", dtype=dtype)
    bank = {k: torch.from_numpy(np.ascontiguousarray(rec["bank"][k][None]))
            .to(want or dtype) for k, want in device_env.BANK_FIELDS}
    acts = torch.from_numpy(rec["actions"][None].astype(np.int32))
    state = ek.init_state(bank, acts)
    trace = {name: torch.zeros(acts.shape, dtype=want or dtype)
             for name, want in device_env.TRACE_FIELDS}
    mirror = Mirror(et, dtype)
    fours = 0
    for d in range(acts.shape[1]):
        raw = ek.evaluate(state)
        ek.decision(state, bank, raw, trace, d)
        before = int(state["completed"][0])
        mirror.advance(ek, state, bank)
        fours += int(state["completed"][0]) - before == 4
        if d + 1 < acts.shape[1]:
            ek.prepare(state, bank, acts[:, d + 1])
    assert fours == 3 and mirror.multi >= 3
    if dtype == torch.float32:
        for name in ("t", "jct", "accept"):
            np.testing.assert_array_equal(trace[name][0].numpy(),
                                          rec["f32"]["trace"][name][0],
                                          err_msg=name)


@pytest.fixture(scope="module", params=[4, 8], ids=["64srv", "128srv"])
def wide(request):
    return wide_episode_tables(request.param)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mirror_is_the_plain_clock_with_several_slots_a_lane(wide, replay,
                                                            dtype):
    """On 64 and 128 servers, where each lane of the warp owns K = 2 and 4
    slots: the plain episode of two recorded banks under random degrees
    (placement, pricing, the lookahead and the decision), each clock held
    against the mirror; some clock finds two running slots in one lane's
    block, and some slot past lane 0's block runs."""
    et = wide
    K = -(-et.n_srv // WARP)
    assert K in (2, 4)
    ek = device_env.episode_kernels(et, device="cpu", dtype=dtype)
    bank = _bank(replay["banks"], [0, 1], dtype)
    D = WIDE_DECISIONS
    acts = torch.from_numpy(np.random.RandomState(K).choice(
        [1, 2, 4, 8, 16], (2, D)).astype(np.int32))
    state = ek.init_state(bank, acts)
    trace = {name: torch.zeros(acts.shape, dtype=want or dtype)
             for name, want in device_env.TRACE_FIELDS}
    mirror = Mirror(et, dtype)
    for d in range(D):
        raw = ek.evaluate(state)
        ek.decision(state, bank, raw, trace, d)
        mirror.advance(ek, state, bank)
        if d + 1 < D:
            ek.prepare(state, bank, acts[:, d + 1])
    assert mirror.shared > 0 and mirror.top >= K, (mirror.shared,
                                                   mirror.top)
    assert mirror.completions > 0


# ----------------------------------------------------------------- (c)
def test_jax_and_plain_engines_propagate_nan_alike():
    """Recorded lanes with NaN remaining times (every flow dep's, of
    either sign, or one op's): the JAX engine's t is NaN on each poisoned
    lane, and the plain engine gives the same five answers bit for bit
    (NaN where JAX has NaN) on every lane, its tick counts running to the
    cap on the poisoned ones."""
    g = nan_lanes()
    args, w, c = g["args"], g["num_workers"], g["num_channels"]
    want = [np.asarray(x) for x in jl.batched_lookahead_fn(w, c)(*args)]
    got = lookahead_mod.lookahead_plain(
        *(torch.from_numpy(np.asarray(a)) for a in args), num_workers=w,
        num_channels=c)
    ticks = got[5]
    for name, gv, wv in zip(("t", "comm", "comp", "busy", "ok"), got, want):
        assert gv.numpy().dtype == wv.dtype, name
        np.testing.assert_array_equal(gv.numpy(), wv, err_msg=name)
    poisoned = list(g["lanes"])
    assert np.isnan(want[0][poisoned]).all()
    assert not want[4][poisoned].any()
    clean = [i for i in range(len(want[0])) if i not in poisoned]
    assert np.isfinite(want[0][clean]).all()
    cap = args[0].shape[1] + args[5].shape[1] + 4
    assert (ticks[poisoned] == cap).all()
