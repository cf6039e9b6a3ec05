"""The port's serving stack (ddls_tpu_torch/serve) on device="cpu",
mirroring tests/test_serve.py and held against the JAX server.

The load-bearing pin is the same as the JAX stack's: BATCHING NEVER
CHANGES AN ANSWER. Every bucket runs one program shape (``flat_batched``
at ``max_batch`` rows, partial flushes padded with replicas), and every
step of the port's forward computes a row, node or graph from that item's
own inputs in a fixed order (the segment mean walks a destination-sorted
CSR; the Dense sums run feature by feature), so a request served in a full
mixed batch is bit-equal to the same request served alone. Across program
shapes, and against the JAX server, the pin is masked-pattern equality,
1e-5 closeness and identical decisions.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from ddls_tpu.models.policy import GNNPolicy as JaxPolicy
from ddls_tpu.serve import PolicyServer as JaxServer
from ddls_tpu_torch import telemetry
from ddls_tpu_torch.envs.baselines import FixedDegreePacking
from ddls_tpu_torch.models.convert import flatten_tree, params_from_flax
from ddls_tpu_torch.models.policy import GNNPolicy
from ddls_tpu_torch.serve import (DEFAULT_FALLBACK_DEGREE, BucketForward,
                                  BucketOverflowError, MicrobatchEngine,
                                  ObsBucketer, PendingRequest, PolicyServer,
                                  build_fleet, default_buckets)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_ACTIONS = 9
GRAPH_DIM = 17 + N_ACTIONS
BUCKETS = [(8, 12), (16, 28)]
MAX_BATCH = 4
ARCH = dict(out_features_msg=4, out_features_hidden=8, out_features_node=4,
            out_features_graph=4, fcnet_hiddens=(16,))
F32_MIN = np.finfo(np.float32).min


def _rand_obs(rng, n, m, max_nodes, max_edges, mask_valid=(0, 1, 2, 4, 8)):
    node_features = np.zeros((max_nodes, 5), np.float32)
    node_features[:n] = rng.uniform(0, 1, (n, 5))
    edge_features = np.zeros((max_edges, 2), np.float32)
    edge_features[:m] = rng.uniform(0, 1, (m, 2))
    src = np.zeros(max_edges, np.int32)
    dst = np.zeros(max_edges, np.int32)
    src[:m] = rng.integers(0, n, m)
    dst[:m] = rng.integers(0, n, m)
    mask = np.zeros(N_ACTIONS, np.int32)
    mask[list(mask_valid)] = 1
    return {
        "action_set": np.arange(N_ACTIONS, dtype=np.int32),
        "action_mask": mask,
        "node_features": node_features,
        "edge_features": edge_features,
        "graph_features": rng.uniform(0, 1, (GRAPH_DIM,)).astype(
            np.float32),
        "edges_src": src,
        "edges_dst": dst,
        "node_split": np.array([n], np.int32),
        "edge_split": np.array([m], np.int32),
    }


@pytest.fixture(scope="module")
def policies():
    """(jax model, flax params, port model, port params): one flax init
    carried across by the weight bridge."""
    jm = JaxPolicy(n_actions=N_ACTIONS, **ARCH)
    obs = _rand_obs(np.random.default_rng(0), 6, 8, *BUCKETS[-1])
    jparams = jm.init(jax.random.PRNGKey(0), obs)
    model = GNNPolicy(N_ACTIONS, GRAPH_DIM, device="cpu", **ARCH)
    params = params_from_flax(flatten_tree({"params": jparams["params"]}),
                              model)
    model.load_state_dict(params)
    return jm, jparams, model, params


def _make_server(policies, clock=None, **kwargs):
    _, _, model, params = policies
    defaults = dict(buckets=BUCKETS, max_batch=MAX_BATCH, deadline_s=0.01,
                    device="cpu")
    defaults.update(kwargs)
    if clock is not None:
        defaults["clock"] = clock
    return PolicyServer(model, params, **defaults)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# --------------------------------------------------------------- bucketing
class TestBucketing:
    def test_default_buckets_halving_ladder(self):
        b = default_buckets(32, 60, n_buckets=3)
        assert b[-1] == (32, 60)
        assert b == sorted(set(b))
        assert len(b) == 3
        assert default_buckets(8)[-1] == (8, 28)
        # the shipped policy's env pads to (150, 512)
        assert default_buckets(150, 512) == [(38, 128), (75, 256),
                                             (150, 512)]

    def test_smallest_fit_and_pad(self):
        bk = ObsBucketer(BUCKETS)
        obs = _rand_obs(np.random.default_rng(1), 5, 6, 20, 40)
        idx, padded = bk.bucket_obs(obs)
        assert idx == 0
        assert padded["node_features"].shape == (8, 5)
        assert padded["edge_features"].shape == (12, 2)
        np.testing.assert_array_equal(padded["node_features"][:5],
                                      obs["node_features"][:5])
        np.testing.assert_array_equal(padded["node_features"][5:], 0.0)
        np.testing.assert_array_equal(padded["edges_src"][:6],
                                      obs["edges_src"][:6])
        assert bk.bucket_index(5, 20) == 1
        with pytest.raises(BucketOverflowError):
            bk.bucket_index(17, 4)

    def test_arena_reuse_is_bit_identical(self):
        rng = np.random.default_rng(3)
        fresh, reuse = ObsBucketer(BUCKETS), ObsBucketer(BUCKETS,
                                                         reuse_arenas=True)
        for _ in range(6):
            obs = _rand_obs(rng, int(rng.integers(1, 9)),
                            int(rng.integers(0, 13)), 16, 28)
            i, a = fresh.bucket_obs(obs)
            j, b = reuse.bucket_obs(obs)
            assert i == j
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            reuse.release(j, b)

    def test_repad_is_forward_invariant(self, policies):
        from ddls_tpu_torch.envs.obs import pad_obs_to

        _, _, model, _ = policies
        obs = _rand_obs(np.random.default_rng(2), 6, 9, 20, 40)
        with torch.no_grad():
            lo_a, va_a = model(obs)
            lo_b, va_b = model(pad_obs_to(obs, 16, 28))
        np.testing.assert_allclose(lo_a.numpy(), lo_b.numpy(), atol=1e-5)
        np.testing.assert_allclose(va_a.numpy(), va_b.numpy(), atol=1e-5)


# -------------------------------------------------------------- microbatch
class TestMicrobatch:
    def _req(self, rid, bucket, t):
        return PendingRequest(request_id=rid, bucket_idx=bucket, obs={},
                              enqueue_time=t)

    def test_full_batch_flushes_immediately(self):
        eng = MicrobatchEngine(2, max_batch=3, deadline_s=10.0)
        for i in range(3):
            eng.submit(self._req(i, 0, 0.0))
        batches = eng.due_batches(now=0.0)
        assert len(batches) == 1 and batches[0][0] == 0
        assert [r.request_id for r in batches[0][1]] == [0, 1, 2]
        assert eng.queued() == 0

    def test_deadline_flushes_partial_and_never_mixes_buckets(self):
        eng = MicrobatchEngine(2, max_batch=4, deadline_s=0.01)
        eng.submit(self._req(0, 0, 0.0))
        eng.submit(self._req(1, 1, 0.0))
        assert eng.due_batches(now=0.005) == []
        assert eng.next_deadline() == pytest.approx(0.01)
        batches = eng.due_batches(now=0.011)
        assert sorted(b[0] for b in batches) == [0, 1]
        assert all(len(b[1]) == 1 for b in batches)

    def test_force_drains(self):
        eng = MicrobatchEngine(1, max_batch=4, deadline_s=100.0)
        eng.submit(self._req(0, 0, 0.0))
        assert eng.due_batches(now=0.0) == []
        assert len(eng.due_batches(now=0.0, force=True)) == 1

    def test_next_deadline_reports_full_batch_due_now(self):
        eng = MicrobatchEngine(2, max_batch=2, deadline_s=10.0)
        eng.submit(self._req(0, 0, 1.0))
        assert eng.next_deadline() == pytest.approx(11.0)
        eng.submit(self._req(1, 0, 2.0))
        assert eng.next_deadline() == pytest.approx(1.0)
        eng.due_batches(now=2.0)
        assert eng.next_deadline() is None


# ------------------------------------------------------------ bit-equality
class TestBatchedForwardParity:
    @pytest.mark.parametrize("bucket", list(range(len(BUCKETS))))
    def test_batched_bit_equal_to_unbatched(self, policies, bucket):
        """For every bucket, a request's logits, value and action from a
        full mixed batch are bit-equal to serving it alone through the
        same program shape."""
        _, _, model, params = policies
        bn, be = BUCKETS[bucket]
        rng = np.random.default_rng(10 + bucket)
        reqs = [_rand_obs(rng, int(rng.integers(2, bn + 1)),
                          int(rng.integers(1, be + 1)), bn, be)
                for _ in range(MAX_BATCH)]
        bf = BucketForward(model, params, max_batch=MAX_BATCH, device="cpu")
        lo_batch, va_batch, ac_batch = bf.forward(reqs)
        for i, req in enumerate(reqs):
            lo_solo, va_solo, ac_solo = bf.forward([req])
            np.testing.assert_array_equal(lo_batch[i], lo_solo[0])
            np.testing.assert_array_equal(va_batch[i], va_solo[0])
            assert ac_batch[i] == ac_solo[0]

    @pytest.mark.parametrize("bucket", list(range(len(BUCKETS))))
    def test_agrees_with_jax_single_graph_forward(self, policies, bucket):
        jm, jparams, model, params = policies
        bn, be = BUCKETS[bucket]
        rng = np.random.default_rng(20 + bucket)
        reqs = [_rand_obs(rng, int(rng.integers(2, bn + 1)),
                          int(rng.integers(1, be + 1)), bn, be)
                for _ in range(MAX_BATCH)]
        bf = BucketForward(model, params, max_batch=MAX_BATCH, device="cpu")
        lo_batch, va_batch, ac_batch = bf.forward(reqs)
        for i, req in enumerate(reqs):
            lo_s, va_s = jm.apply(jparams, req)
            lo_s, va_s = np.asarray(lo_s), np.asarray(va_s)
            np.testing.assert_array_equal(lo_batch[i] == F32_MIN,
                                          lo_s == F32_MIN)
            np.testing.assert_allclose(lo_batch[i], lo_s, atol=1e-5)
            np.testing.assert_allclose(va_batch[i], va_s, atol=1e-5)
            assert int(ac_batch[i]) == int(np.argmax(lo_s))

    def test_each_bucket_runs_one_program_shape(self, policies):
        server = _make_server(policies, clock=_FakeClock())
        rng = np.random.default_rng(3)
        for t in range(10):
            bn, be = BUCKETS[t % 2]
            server.submit(_rand_obs(rng, bn - 1, be - 2, bn, be), now=0.0)
        server.drain(now=0.0)
        assert server.stats.n_compiles == len(BUCKETS)

    def test_server_batched_decisions_match_serve_one(self, policies):
        rng = np.random.default_rng(4)
        bn, be = BUCKETS[0]
        reqs = [_rand_obs(rng, int(rng.integers(2, bn + 1)),
                          int(rng.integers(1, be + 1)), bn, be)
                for _ in range(MAX_BATCH)]
        server = _make_server(policies, clock=_FakeClock())
        for o in reqs:
            server.submit(o, now=0.0)
        batched = {r.request_id: r.action for r in server.poll(now=0.0)}
        assert len(batched) == MAX_BATCH
        solo_server = _make_server(policies, clock=_FakeClock())
        for i, o in enumerate(reqs):
            assert solo_server.serve_one(o).action == batched[i]


# ------------------------------------------------------- deadlines/fallback
class TestServerBehaviour:
    def test_deadline_flush_fires_under_partial_batch(self, policies):
        clock = _FakeClock()
        server = _make_server(policies, clock=clock, deadline_s=0.01)
        rng = np.random.default_rng(5)
        bn, be = BUCKETS[1]
        for _ in range(MAX_BATCH - 1):
            server.submit(_rand_obs(rng, 10, 14, bn, be), now=0.0)
        assert server.poll(now=0.005) == []
        out = server.poll(now=0.012)
        assert len(out) == MAX_BATCH - 1
        assert all(r.source == "policy" and r.batch_fill == MAX_BATCH - 1
                   for r in out)
        assert list(server.stats.occupancies) == [
            pytest.approx((MAX_BATCH - 1) / MAX_BATCH)]
        assert all(r.latency_s == pytest.approx(0.012) for r in out)
        assert server.stats.summary()["flush_causes"] == {"deadline": 1}

    def test_saturation_falls_back_without_dropping(self, policies):
        server = _make_server(policies, clock=_FakeClock(), max_queue=4,
                              deadline_s=100.0,
                              fallback=FixedDegreePacking(degree=4))
        rng = np.random.default_rng(6)
        bn, be = BUCKETS[0]
        reqs = [_rand_obs(rng, 5, 6, bn, be) for _ in range(10)]
        ids = [server.submit(o, now=0.0) for o in reqs]
        immediate = server.poll(now=0.0)
        fallback = [r for r in immediate if r.source == "fallback"]
        assert len(fallback) == 6
        assert all(r.reason == "saturated" for r in fallback)
        rule = FixedDegreePacking(degree=4)
        assert all(r.action == rule.compute_action(reqs[r.request_id])
                   for r in fallback)
        rest = server.drain(now=0.0)
        answered = {r.request_id for r in immediate} | {
            r.request_id for r in rest}
        assert answered == set(ids)
        assert server.stats.summary()["fallback_rate"] == pytest.approx(0.6)

    def test_dead_backend_degrades_to_heuristic(self, policies):
        """A forward that raises latches degraded mode: every request
        (in-flight and later) is answered by FixedDegreePacking, none
        dropped, and the transition is recorded as a telemetry event."""
        def broken_apply(model, batch):
            raise RuntimeError("device lost")

        clock = _FakeClock()
        server = _make_server(policies, clock=clock, apply_fn=broken_apply,
                              fallback=FixedDegreePacking(degree=4))
        assert DEFAULT_FALLBACK_DEGREE == 8
        rng = np.random.default_rng(7)
        bn, be = BUCKETS[0]
        reqs = [_rand_obs(rng, 5, 6, bn, be) for _ in range(MAX_BATCH + 2)]
        for o in reqs:
            server.submit(o, now=0.0)
        telemetry.registry().reset()
        telemetry.enable()
        try:
            out = server.drain(now=0.0)
            events = dict(telemetry.registry().counter_items())
        finally:
            telemetry.disable()
            telemetry.registry().reset()
        assert events.get("event.serve_degraded") == 1
        assert len(out) == MAX_BATCH + 2
        assert all(r.source == "fallback" for r in out)
        assert server.degraded
        rule = FixedDegreePacking(degree=4)
        assert all(r.action == rule.compute_action(reqs[r.request_id])
                   for r in out)
        clock.t = 1.0
        rid = server.submit(reqs[0], now=1.0)
        out2 = server.poll(now=1.0)
        assert [r.request_id for r in out2] == [rid]
        assert out2[0].reason == "degraded"
        assert server.stats.degraded_transitions == 1

    def test_serve_one_matches_id_with_prior_queue(self, policies):
        server = _make_server(policies, clock=_FakeClock(), deadline_s=100.0)
        rng = np.random.default_rng(9)
        bn, be = BUCKETS[0]
        first = _rand_obs(rng, 5, 6, bn, be)
        second = _rand_obs(rng, 6, 7, bn, be)
        rid_first = server.submit(first, now=0.0)
        resp = server.serve_one(second)
        assert resp.request_id != rid_first
        solo = _make_server(policies, clock=_FakeClock())
        assert resp.action == solo.serve_one(second).action
        rest = server.poll(now=0.0)
        assert [r.request_id for r in rest] == [rid_first]

    def test_oversized_graph_falls_back(self, policies):
        server = _make_server(policies, clock=_FakeClock())
        big = _rand_obs(np.random.default_rng(8), 20, 24, 24, 30)
        server.submit(big, now=0.0)
        out = server.poll(now=0.0)
        assert len(out) == 1 and out[0].reason == "overflow"

    def test_malformed_obs_rejected_at_submit_not_batch(self, policies):
        server = _make_server(policies, clock=_FakeClock())
        rng = np.random.default_rng(11)
        bn, be = BUCKETS[0]
        good = _rand_obs(rng, 5, 6, bn, be)
        rid = server.submit(good, now=0.0)
        missing = {k: v for k, v in good.items() if k != "action_set"}
        with pytest.raises(ValueError, match="missing"):
            server.submit(missing, now=0.0)
        bad_width = dict(good, node_features=np.zeros((bn, 4), np.float32))
        with pytest.raises(ValueError, match="node_features"):
            server.submit(bad_width, now=0.0)
        bad_graph = dict(good, graph_features=np.zeros(3, np.float32))
        with pytest.raises(ValueError, match="graph_features"):
            server.submit(bad_graph, now=0.0)
        bad_set = dict(good, action_set=np.arange(3, dtype=np.int32))
        with pytest.raises(ValueError, match="action_set"):
            server.submit(bad_set, now=0.0)
        out = server.drain(now=0.0)
        assert [r.request_id for r in out] == [rid]
        assert out[0].source == "policy"
        assert server.stats.n_requests == 1

    def test_inconsistent_splits_rejected_at_submit(self, policies):
        server = _make_server(policies, clock=_FakeClock())
        good = _rand_obs(np.random.default_rng(13), 5, 6, *BUCKETS[0])
        inflated = dict(good, node_split=np.array(
            [good["node_features"].shape[0] + 3], np.int32))
        with pytest.raises(ValueError, match="node_split"):
            server.submit(inflated, now=0.0)
        with pytest.raises(ValueError, match="edge_split"):
            server.submit(dict(good, edge_split=np.array([-2], np.int32)),
                          now=0.0)
        with pytest.raises(ValueError, match="edges_src"):
            server.submit(dict(good, edges_src=good["edges_src"][:2]),
                          now=0.0)
        dst = good["edges_dst"].copy()
        dst[0] = int(good["node_split"][0])
        with pytest.raises(ValueError, match="edges_dst"):
            server.submit(dict(good, edges_dst=dst), now=0.0)
        src = good["edges_src"].copy()
        src[0] = -1
        with pytest.raises(ValueError, match="edges_src"):
            server.submit(dict(good, edges_src=src), now=0.0)
        resp = server.serve_one(good)
        assert resp.source == "policy"
        assert not server.degraded

    def test_width_contract_comes_from_the_model(self, policies):
        server = _make_server(policies, clock=_FakeClock())
        good = _rand_obs(np.random.default_rng(12), 5, 6, *BUCKETS[0])
        with pytest.raises(ValueError, match="action_mask"):
            server.submit(dict(good, action_mask=np.ones(N_ACTIONS + 3,
                                                         np.int32)), now=0.0)
        with pytest.raises(ValueError, match="graph_features"):
            server.submit(dict(good, graph_features=np.zeros(
                GRAPH_DIM + 9, np.float32)), now=0.0)
        assert server.serve_one(good).source == "policy"
        assert not server.degraded

    def test_malformed_batch_data_answers_invalid_without_degrading(
            self, policies):
        """A dtype the stacker cannot take reaches the batch (submit
        checks shapes, not dtypes): that batch is answered from the
        heuristic as ``invalid`` and the healthy backend is not
        latched."""
        server = _make_server(policies, clock=_FakeClock())
        good = _rand_obs(np.random.default_rng(14), 5, 6, *BUCKETS[0])
        odd = dict(good, graph_features=good["graph_features"].astype(
            np.complex64))
        server.submit(odd, now=0.0)
        out = server.drain(now=0.0)
        assert [r.reason for r in out] == ["invalid"]
        assert not server.degraded
        assert server.serve_one(good).source == "policy"


def test_cuda_device_without_cuda_raises(policies, monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    where CUDA is unavailable, asking for it raises instead of quietly
    serving on the host."""
    _, _, model, params = policies
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PolicyServer(model, params, buckets=BUCKETS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BucketForward(model, params, MAX_BATCH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_fleet(model, params, buckets=BUCKETS)


def test_port_decisions_equal_jax_server_decisions(policies):
    """The same request stream (two buckets, an oversized graph, a queue
    that saturates) through the JAX server and the port's: the same
    responses, in the same order, with the same actions and reasons."""
    jm, jparams, model, params = policies
    rng = np.random.default_rng(15)
    stream = []
    for k in range(23):
        bn, be = BUCKETS[k % 2]
        stream.append(_rand_obs(rng, int(rng.integers(1, bn + 1)),
                                int(rng.integers(0, be + 1)), bn, be,
                                mask_valid=sorted(rng.choice(
                                    N_ACTIONS, 4, replace=False))))
    stream[7] = _rand_obs(rng, 20, 24, 24, 30)  # fits no bucket
    kw = dict(buckets=BUCKETS, max_batch=MAX_BATCH, deadline_s=0.01,
              max_queue=9)

    def run(server):
        out = []
        for i, obs in enumerate(stream):
            server.submit(obs, now=i * 0.004)
            out += server.poll(now=i * 0.004)
        out += server.drain(now=1.0)
        return [(r.request_id, r.action, r.source, r.reason, r.bucket_idx)
                for r in out]

    jax_out = run(JaxServer(jm, jparams, clock=_FakeClock(), **kw))
    port_out = run(PolicyServer(model, params, clock=_FakeClock(),
                                device="cpu", **kw))
    assert port_out == jax_out
    assert {r[2] for r in port_out} == {"policy", "fallback"}


# ------------------------------------------------------------------- fleet
def test_fleet_answers_equal_single_server_and_quota_sheds(policies):
    _, _, model, params = policies
    rng = np.random.default_rng(16)
    reqs = [_rand_obs(rng, int(rng.integers(2, 9)), int(rng.integers(1, 13)),
                      *BUCKETS[0]) for _ in range(10)]
    single = _make_server(policies, clock=_FakeClock())
    ref = {}
    for i, o in enumerate(reqs):
        ref[i] = single.serve_one(o).action
    fleet = build_fleet(model, params, n_replicas=3, routing="round_robin",
                        clock=_FakeClock(), device="cpu", buckets=BUCKETS,
                        max_batch=MAX_BATCH)
    ids = [fleet.submit(o, now=0.0) for o in reqs]
    out = {r.request_id: r for r in fleet.drain(now=0.0)}
    assert [out[i].action for i in ids] == [ref[i] for i in range(10)]
    assert {out[i].replica for i in ids} == {0, 1, 2}
    agg = fleet.registry_snapshots()["aggregate"]["counters"]
    assert agg["serve.requests"] == 10 and agg["serve.policy"] == 10

    quota = build_fleet(model, params, quota_rps=1.0, quota_burst=2.0,
                        shed_enabled=True, clock=_FakeClock(), device="cpu",
                        buckets=BUCKETS, max_batch=MAX_BATCH)
    for o in reqs[:4]:
        quota.submit(o, now=0.0, tenant="a")
    got = quota.drain(now=0.0)
    assert sorted(r.source for r in got) == ["policy", "policy", "shed",
                                             "shed"]
    assert all(r.action is None for r in got if r.source == "shed")


def test_fleet_hot_swap_answers_admitted_requests_with_old_params(policies):
    _, _, model, params = policies
    rng = np.random.default_rng(17)
    obs = _rand_obs(rng, 6, 8, *BUCKETS[0])
    fleet = build_fleet(model, params, clock=_FakeClock(), device="cpu",
                        buckets=BUCKETS, max_batch=MAX_BATCH,
                        deadline_s=100.0)
    before = _make_server(policies, clock=_FakeClock()).serve_one(obs)
    fid = fleet.submit(obs, now=0.0)
    flipped = {k: (-v if k.startswith("logit_head") else v)
               for k, v in params.items()}
    fleet.hot_swap(flipped, now=0.0)
    swapped = fleet.poll(now=0.0)
    assert [(r.request_id, r.action) for r in swapped] == [(fid,
                                                            before.action)]
    after = fleet.replica_set.replicas[0].server.serve_one(obs)
    assert after.source == "policy"


def test_fleet_scale_and_refit_drain_without_dropping(policies):
    """Scale-down drains the retired replica (its answers surface on the
    next poll, its stats stay in the aggregate) and a ladder re-fit from
    the observed sizes answers everything admitted under the old ladder."""
    _, _, model, params = policies
    rng = np.random.default_rng(18)
    fleet = build_fleet(model, params, n_replicas=1, routing="round_robin",
                        clock=_FakeClock(), device="cpu", buckets=BUCKETS,
                        max_batch=MAX_BATCH, deadline_s=100.0)
    assert fleet.scale_to(2) == 2
    ids = [fleet.submit(_rand_obs(rng, 5, 6, *BUCKETS[0]), now=0.0)
           for _ in range(4)]
    assert fleet.scale_to(1, now=0.0) == 1
    specs = fleet.refit_buckets(n_buckets=2, now=0.0)
    assert specs == [(5, 6)]
    out = fleet.poll(now=0.0) + fleet.drain(now=0.0)
    assert sorted(r.request_id for r in out) == ids
    assert all(r.source == "policy" for r in out)
    agg = fleet.registry_snapshots()["aggregate"]["counters"]
    assert agg["serve.requests"] == 4


# --------------------------------------------------------------------- CLI
def test_line_assembler_handles_bursts():
    from ddls_tpu_torch.serve.__main__ import LineAssembler

    la = LineAssembler()
    assert la.feed(b'{"a": 1}\n{"b"') == ['{"a": 1}']
    assert la.feed(b': 2}\n\n{"c": 3}') == ['{"b": 2}', ""]
    assert la.flush() == ['{"c": 3}']
    assert la.flush() == []


def _run_cli(args, stdin=""):
    return subprocess.run(
        [sys.executable, "-m", "ddls_tpu_torch.serve", *args], input=stdin,
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_cli_selftest_on_cpu():
    proc = _run_cli(["--selftest", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["selftest"] == "ok"
    assert line["n_requests"] == 64 and line["n_fallback_saturated"] > 0


def test_cli_stdin_protocol_on_cpu():
    """JSON lines in, one decision line per request out (the shipped
    policy on fixture requests: the recorded JAX action), a malformed line
    answered with an error, and the stats summary on stderr."""
    from ddls_tpu_torch.serve.fixture import load_requests

    requests, recorded = load_requests()
    lines = [json.dumps({"id": f"r{i}", "obs": {
        k: v.tolist() for k, v in requests[i].items()}}) for i in range(3)]
    lines.insert(1, '{"id": "bad", "obs": {"node_features": [[1]]}}')
    proc = _run_cli(["--device", "cpu", "--deadline-ms", "1"],
                    "\n".join(lines) + "\n")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = {d["id"]: d for d in map(json.loads,
                                   proc.stdout.strip().splitlines())}
    assert "error" in out["bad"]
    for i in range(3):
        assert out[f"r{i}"]["source"] == "policy"
        assert out[f"r{i}"]["action"] == int(recorded["jax_actions"][i])
    stats = json.loads(proc.stderr.strip().splitlines()[-1])["serve_stats"]
    # the malformed line errored at submit and was never admitted
    assert stats["n_requests"] == 3 and stats["n_shed"] == 0


def test_cli_cuda_device_without_cuda_fails():
    proc = _run_cli(["--selftest"])
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
