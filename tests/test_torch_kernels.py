"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; whether
there is one is decided inside the fixture, never at import or collection,
so every worker of a parallel run collects the same tests.

On a machine with the card (this file imports neither JAX nor the JAX
package, so the repo's JAX conftest is skipped):

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels.py

Tolerance: abs and rel 1e-5 for the forward kernels (float32; the
plain versions repeat the kernels' roundings except in the activations'
transcendental functions); K1 is also held within 1e-5 of each output's
largest magnitude and bitwise across two runs at its tile edges, widths
and activations, and K8 over row counts that take one pass, two and a
cluster of CTAs and every group width. The backward kernels K5–K8 and
the IMPALA and PG update's kernels K10–K12 are held at abs 1e-5 of each
output's own
largest magnitude (exactly where that is 0):
their parameter gradients are float32 sums over up to 16,384 rows in
another order than the plain versions' matrix products. K5's plain
version takes relu's kink decisions from K1's output on the same inputs,
as K5, which recomputes K1's pre-activations, does. K2, K4, K5–K8 and K10–K12
are also held bitwise across two runs. K5 sums its parameter gradients
over the CTAs inside its one launch: it is held at the main path's
widths, at ragged row counts and across a CUDA graph's replays. The Ape-X DQN and ES kernels: K13
(acting) and K16 (the population's noisy argmax) equal their plain
versions exactly, as K15's centred ranks do; K14 (the TD loss and its
gradient) and K15's gradient within 1e-5 of each output's largest
magnitude; all four bitwise across two runs. The heads, optimiser and
minibatch kernels: K17 (both heads) and K18 (their backward) within 1e-5
of each output's largest magnitude, each row's K17 answer bit-equal
whatever shares its batch, K18 bitwise across two runs; K19 within 1e-6
of each leaf's largest after five steps (its norm sums in another order
than the plain version's per-leaf norms), at a tie too; K20 exactly. The
array lookahead engine K21 equals its plain version bit for bit, tick
counts included, in float32 and float64, on every recorded group of lanes
(and in float32 the recorded JAX answers), and bitwise across two runs,
and with ``skip`` too. The device env's kernels K22-K25 equal their plain
versions exactly (integers) and bit for bit (floats), in float32 and
float64, on the calls of the first decisions of two recorded shipped
banks, whose float32 trace is the recorded JAX one; K23 (both entries)
also on fuzzed states at 1, 8 and 72 rows, on the shipped surface and on
a 64-server ramp whose occupancy masks take two words. K25's scenario mode
(the failure walk) equals its plain version on every call of the recorded
full-width scenario replay (whose float32 trace is the recorded JAX one)
and of episodes under fuzzed scenarios that take each of the walk's
branches; C1's bank holds; a nominal episode launches the nominal K25 and
no scenario mode. K24 and both K21 entries (per lane and indexed) run
each lane over a thread-block cluster: they equal their plain versions
bit for bit at every cluster size 1-16 and at the wrappers' own choice,
at 1, 2, 8 and 72 lanes, on all 45 configs of the shipped surface at full
width, with skipped lanes, on lanes priced NaN or infinite, and on every
recorded group of K21 lanes, in float32 and float64. K2 equals its plain
version bit for bit at widths 1-1,100, on misaligned inputs, a 100-edge
node and the update's forward; its C entry's plan is
``segment.csr_segment_mean_plan``'s. K20 equals its plain version and
``prepare_flat_batch`` array for array at 1 to 1,500 samples at both
buckets, and its C entry's plan is ``policy.minibatch_gather_plan``'s.
K6's three entries
equal their plain versions bit for bit at widths 1-64, in the vector and
scalar forms; K17 equals its arithmetic done exactly in PyTorch
(``_heads_fma_chain``) at every tile; K23 equals its plain version on
128, 160 and 256 servers and in its global form forced on the shipped
and a 64-server surface.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.agents.block_search import block_shapes_for, factor_pairs
from ddls_tpu_torch.models import gnn, policy
from ddls_tpu_torch.ops import segment
from ddls_tpu_torch.rl import actor_critic, dqn, es, impala, pg, ppo
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim import lookahead as lookahead_mod
from ddls_tpu_torch.sim.device_block_search import (first_fit_block,
                                                    first_fit_block_plain)
from ddls_tpu_torch.sim.fixture import (TRACE_NAMES, episode_kernel_diffs,
                                        load_device_env_fixture,
                                        load_lookahead_lanes)

pytestmark = pytest.mark.gpu

TOL = 1e-5
FORWARD_KERNELS = ("ln_linear_act", "csr_segment_mean",
                   "masked_mean_pool_concat", "mask_logits_argmax",
                   "mlp_heads")
# the IMPALA and PG updates' kernels (K10-K12), which PPO never launches
AC_KERNELS = ("vtrace", "reward_to_go", "ac_logp", "ac_loss")
# the Ape-X DQN and ES kernels (K13-K16), which PPO never launches either
DQN_ES_KERNELS = ("dqn_act", "dqn_td_loss", "es_update", "es_act")
# the simulator's kernels (K21-K30), which no learner's update launches
SIM_KERNELS = ("lookahead", "first_fit_block", "allocate_job",
               "allocate_job_indexed", "price_and_score", "episode_step",
               "episode_prepare", "kernel_obs", "kernel_obs_prices",
               "memo_probe", "memo_insert", "price_reduce", "oracle_select",
               "episode_step_scenario")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.testing.assert_close(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("activation", sorted(gnn.ACTIVATIONS))
@pytest.mark.parametrize("form", ["plain", "gather_concat", "zero_half"])
def test_ln_linear_act_matches_plain(cuda, activation, form):
    g = torch.Generator(device="cpu").manual_seed(1)
    rows, fa, fb, fo = 4096, 16, 16, 64
    a = torch.rand(1200, fa, generator=g).to(cuda)
    ln_w = torch.randn(fa + fb, generator=g).to(cuda)
    ln_b = torch.randn(fa + fb, generator=g).to(cuda)
    w = (torch.randn(fo, fa + fb, generator=g) / 4).to(cuda)
    bias = torch.randn(fo, generator=g).to(cuda)
    kwargs = {}
    if form == "gather_concat":
        kwargs = dict(idx=torch.randint(0, 1200, (rows,), generator=g,
                                        dtype=torch.int32).to(cuda),
                      b=torch.rand(rows, fb, generator=g).to(cuda))
    elif form == "zero_half":
        kwargs = dict(b_width=fb)
    else:
        a = torch.rand(rows, fa + fb, generator=g).to(cuda) + 3.0
    before = kernels.launch_counts()["ln_linear_act"]
    out = gnn.ln_linear_act(a, ln_w, ln_b, w, bias, activation, **kwargs)
    assert kernels.launch_counts()["ln_linear_act"] == before + 1
    _close(out, gnn.ln_linear_act_plain(a, ln_w, ln_b, w, bias, activation,
                                        **kwargs))


def test_ln_linear_act_rejects_what_it_cannot_take(cuda):
    a = torch.rand(8, 4, device=cuda)
    ln = torch.ones(4, device=cuda)
    w = torch.rand(6, 4, device=cuda)
    bias = torch.zeros(6, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        gnn.ln_linear_act(a.double(), ln, ln, w, bias, "relu")
    with pytest.raises(ValueError, match="contiguous"):
        gnn.ln_linear_act(torch.rand(4, 8, device=cuda).t(), ln, ln, w,
                          bias, "relu")
    with pytest.raises(ValueError, match="64"):
        gnn.ln_linear_act(torch.rand(8, 65, device=cuda),
                          torch.ones(65, device=cuda),
                          torch.ones(65, device=cuda),
                          torch.rand(6, 65, device=cuda), bias, "relu")


# K1's row counts: 1 and the edges of its 16-, 32- and 64-row tiles
# (ln_tile.cuh; one tile a CTA up to 16,384 rows, several past it),
# serving's and the update's counts; its widths, where the float4 copies
# and stores do (64) and do not (5, 17, 51) apply
K1_ROWS = [1, 15, 16, 17, 63, 64, 65, 4864, 16384, 65536]
K1_WIDTHS = [5, 17, 51, 64]


def _k1_case(cuda, g, rows, form, k_in, fo):
    """K1's inputs: ``a`` [rows, K] (plain), a gathered left half and a
    given right half (gather_concat), or a left half and a zero right
    half (zero_half)."""
    fb = k_in // 2 if form != "plain" else 0
    fa = k_in - fb
    kwargs = {}
    if form == "gather_concat":
        src = max(rows // 3, 1)
        a = torch.randn(src, fa, generator=g) * 2 + 1
        kwargs = dict(idx=torch.randint(0, src, (rows,), generator=g,
                                        dtype=torch.int32).to(cuda),
                      b=torch.rand(rows, fb, generator=g).to(cuda))
    else:
        a = torch.randn(rows, fa, generator=g) * 2 + 1
        if form == "zero_half":
            kwargs = dict(b_width=fb)
    params = [torch.randn(k_in, generator=g).to(cuda),
              torch.randn(k_in, generator=g).to(cuda),
              (torch.randn(fo, k_in, generator=g) / 4).to(cuda),
              torch.randn(fo, generator=g).to(cuda)]
    return a.to(cuda), params, kwargs


@pytest.mark.parametrize("rows", K1_ROWS)
@pytest.mark.parametrize("form", ["plain", "gather_concat", "zero_half"])
def test_ln_linear_act_tiles_match_plain_and_repeat_bitwise(cuda, rows,
                                                            form):
    """K1 at every width pair of K1_WIDTHS and every activation: one
    launch a call, within 1e-5 of each output's largest against its plain
    version, bit-equal across two runs."""
    g = torch.Generator(device="cpu").manual_seed(rows)
    for k_in in K1_WIDTHS:
        for fo in K1_WIDTHS:
            a, (ln_w, ln_b, w, bias), kwargs = _k1_case(cuda, g, rows, form,
                                                        k_in, fo)
            for activation in sorted(gnn.ACTIVATIONS):
                before = kernels.launch_counts()
                out = gnn.ln_linear_act(a, ln_w, ln_b, w, bias, activation,
                                        **kwargs)
                assert _launched_since(before) == {"ln_linear_act": 1}
                again = gnn.ln_linear_act(a, ln_w, ln_b, w, bias,
                                          activation, **kwargs)
                _close_scaled(out, gnn.ln_linear_act_plain(
                    a, ln_w, ln_b, w, bias, activation, **kwargs))
                assert torch.equal(out, again)


def _csr_case(cuda, n_graphs=8, n=150, e=512, real_edges=37):
    rng = np.random.default_rng(3)
    dst = np.zeros(n_graphs * e, np.int64)
    mask = np.zeros(n_graphs * e, bool)
    n_real = rng.integers(0, 31, n_graphs)
    n_real[-1] = 0   # a graph with zero real nodes
    for b in range(n_graphs):
        m = real_edges if n_real[b] else 0
        dst[b * e:b * e + m] = b * n + rng.integers(0, n_real[b] or 1, m)
        mask[b * e:b * e + m] = True
    node_mask = (np.arange(n)[None] < n_real[:, None]).reshape(-1)
    row_ptr, col = segment.build_csr(dst, mask, n_graphs * n)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    return (t(row_ptr), t(col), t(node_mask.astype(np.float32)),
            n_graphs * n, n_graphs * e)


@pytest.mark.parametrize("f", [64, 16, 5])
def test_csr_segment_mean_matches_plain_and_repeats_bitwise(cuda, f):
    row_ptr, col, node_mask, v, e = _csr_case(cuda)
    g = torch.Generator(device="cpu").manual_seed(f)
    msg = torch.randn(e, f, generator=g).to(cuda)
    self_msg = torch.randn(v, f, generator=g).to(cuda)
    out = segment.csr_segment_mean(msg, self_msg, row_ptr, col, node_mask)
    again = segment.csr_segment_mean(msg, self_msg, row_ptr, col, node_mask)
    _close(out, segment.csr_segment_mean_plain(msg, self_msg, row_ptr, col,
                                               node_mask))
    assert torch.equal(out, again)


# K2's widths: the scalar form (1, 3, 5, 17), the vector form at one unit
# a lane (4), the update's message widths (16, 64), a whole warp (128),
# chunks held in registers (260: 65 units, 4 a lane) and two walks of the
# CSR (1100: 275 units, 8 a lane a walk)
K2_WIDTHS = (1, 3, 4, 5, 16, 17, 64, 128, 260, 1100)


def _hub_case(cuda, f, seed):
    """K2's inputs on 40 nodes of 0-9 in-edges each but node 3's 100 (past
    any batch of edges a lane has in flight) and node 7's 0, the edges in
    random order, about a fifth of the nodes masked."""
    rng = np.random.default_rng(seed)
    nodes = 40
    deg = rng.integers(0, 10, nodes)
    deg[3], deg[7] = 100, 0
    dst = rng.permutation(np.repeat(np.arange(nodes), deg))
    row_ptr, col = segment.build_csr(dst, np.ones(dst.size, bool), nodes)
    node_mask = (rng.random(nodes) > 0.2).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    msg = torch.from_numpy(rng.normal(size=(dst.size, f)).astype(
        np.float32)).to(cuda)
    self_msg = torch.from_numpy(rng.normal(size=(nodes, f)).astype(
        np.float32)).to(cuda)
    return msg, self_msg, t(row_ptr), t(col), t(node_mask)


def _k2_bits(args, what):
    """K2 on ``args`` as given, with msg and with self_msg misaligned (a
    view offset by one float): each bit-equal to the plain version,
    bitwise across two runs, one launch a call."""
    want = segment.csr_segment_mean_plain(*args)
    msg, self_msg = args[:2]
    for form in ("as given", "misaligned_msg", "misaligned_self"):
        a = args
        if form == "misaligned_msg":
            a = (_misaligned(msg),) + args[1:]
        elif form == "misaligned_self":
            a = (msg, _misaligned(self_msg)) + args[2:]
        runs = []
        for _ in range(2):
            before = kernels.launch_counts()
            runs.append(segment.csr_segment_mean(*a))
            assert _launched_since(before) == {"csr_segment_mean": 1}
        torch.cuda.synchronize()
        assert runs[0].shape == want.shape and runs[0].dtype == want.dtype
        assert torch.equal(runs[0].view(torch.int32),
                           want.view(torch.int32)), (what, form)
        assert torch.equal(runs[0].view(torch.int32),
                           runs[1].view(torch.int32)), (what, form)


@pytest.mark.parametrize("f", K2_WIDTHS)
def test_csr_segment_mean_bit_equal_at_every_width(cuda, f):
    """K2 bit-equal to its plain version at widths 1-1100, on misaligned
    messages and self messages, on nodes with no in-edges, masked nodes, a
    graph with no real node and a node with 100 in-edges."""
    row_ptr, col, node_mask, v, e = _csr_case(cuda)
    g = torch.Generator(device="cpu").manual_seed(f)
    msg = torch.randn(e, f, generator=g).to(cuda)
    self_msg = torch.randn(v, f, generator=g).to(cuda)
    _k2_bits((msg, self_msg, row_ptr, col, node_mask), f"batch f={f}")
    _k2_bits(_hub_case(cuda, f, f), f"hub f={f}")


def _fixture_minibatch(cuda):
    """The training fixture's learner, staged trajectory and first
    minibatch (128 samples at the (38, 128) bucket), on the card."""
    from ddls_tpu_torch.rl.fixture import load_train_fixture
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    fx = load_train_fixture()
    model, params, _ = load_export(EXPORT_PATH)
    learner = ppo.PPOLearner(model, fx["cfg"])
    learner.init_state({k: v.to(cuda) for k, v in params.items()})
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    idx = torch.as_tensor(
        fx["runs"][1]["perms"][0][:fx["cfg"].sgd_minibatch_size],
        device=cuda)
    return fx, learner, staged, idx


def test_csr_segment_mean_bit_equal_on_the_update_forward(cuda, monkeypatch):
    """Both K2 calls of the training fixture's first minibatch forward
    (4,864 nodes at widths 64 and 16), as given and misaligned, bit-equal
    to the plain version."""
    _, learner, staged, idx = _fixture_minibatch(cuda)
    batch = learner.minibatch(staged, idx)
    calls = []
    real = gnn.csr_segment_mean

    def record(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(gnn, "csr_segment_mean", record)
    with torch.no_grad():
        learner.model.flat_batched(batch)
    monkeypatch.undo()
    assert [a[1].shape for a in calls] == [(4864, 64), (4864, 16)]
    for k, args in enumerate(calls):
        _k2_bits(args, f"update call {k}")


def test_csr_segment_mean_plan_is_the_mirror(cuda):
    """K2's C entry plans (``ddls_csr_segment_mean_plan``, the plan it
    launches) as ``segment.csr_segment_mean_plan`` does at widths 1-300 and
    a few past, node counts up to the update's and beyond."""
    for f in (*range(1, 301), 512, 1023, 1024, 1100, 4096):
        for n_nodes in (0, 1, 7, 255, 1200, 4864, 21248):
            want = segment.csr_segment_mean_plan(f, n_nodes)
            got = kernels.query("csr_segment_mean",
                                "ddls_csr_segment_mean_plan", f, n_nodes)
            assert got == want.packed(), (f, n_nodes)


@pytest.mark.parametrize("n", [150, 38])
def test_masked_mean_pool_concat_matches_plain(cuda, n):
    g = torch.Generator(device="cpu").manual_seed(n)
    emb = torch.randn(8, n, 16, generator=g).to(cuda)
    n_real = torch.tensor([30, 0, 1, n, 20, 26, 24, 30])
    mask = (torch.arange(n)[None] < n_real[:, None]).float().to(cuda)
    graph_emb = torch.randn(8, 8, generator=g).to(cuda)
    out = segment.masked_mean_pool_concat(emb, mask, graph_emb)
    _close(out, segment.masked_mean_pool_concat_plain(emb, mask, graph_emb))
    assert torch.equal(out[1, :16], torch.zeros(16, device=cuda))


def test_mask_logits_argmax_matches_plain_and_repeats_bitwise(cuda):
    g = torch.Generator(device="cpu").manual_seed(4)
    logits = torch.randn(8, 17, generator=g)
    logits[0, 3] = logits[0, 9] = logits[0].max() + 1.0   # a tie
    mask = (torch.rand(8, 17, generator=g) > 0.4).to(torch.int32)
    mask[0, 3] = mask[0, 9] = 1
    mask[5] = 0                                           # fully masked
    logits, mask = logits.to(cuda), mask.to(cuda)
    masked, actions = policy.mask_logits_argmax(logits, mask)
    masked2, actions2 = policy.mask_logits_argmax(logits, mask)
    ref_masked, ref_actions = policy.mask_logits_argmax_plain(logits, mask)
    torch.cuda.synchronize()
    assert torch.equal(masked, ref_masked)
    assert torch.equal(actions, ref_actions)
    assert int(actions[0]) == 3
    assert torch.equal(masked, masked2) and torch.equal(actions, actions2)


def test_mask_sample_logp_matches_plain_and_repeats_bitwise(cuda):
    g = torch.Generator(device="cpu").manual_seed(5)
    logits = torch.randn(12, 17, generator=g) * 3
    mask = (torch.rand(12, 17, generator=g) > 0.4).to(torch.int32)
    u = policy.gumbel_uniforms((12, 17), g)
    mask[5] = 0                                           # fully masked
    mask[6] = 0
    mask[6, 4] = 1                                        # one valid action
    logits[7] = -20.0
    logits[7, 2] = logits[7, 9] = 4.0                     # an exact tie
    mask[7] = 1
    u[7, 2] = u[7, 9] = 0.75
    logits, mask, u = logits.to(cuda), mask.to(cuda), u.to(cuda)
    actions, logp = policy.mask_sample_logp(logits, mask, u)
    actions2, logp2 = policy.mask_sample_logp(logits, mask, u)
    ref_actions, ref_logp = policy.mask_sample_logp_plain(logits, mask, u)
    torch.cuda.synchronize()
    assert torch.equal(actions, ref_actions)
    _close(logp, ref_logp)
    assert int(actions[5]) == 0 and int(actions[6]) == 4
    assert float(logp[6]) == 0.0 and int(actions[7]) == 2
    assert torch.equal(actions, actions2) and torch.equal(logp, logp2)
    with pytest.raises(TypeError):
        policy.mask_sample_logp(logits, mask.float(), u)
    with pytest.raises(ValueError):
        policy.mask_sample_logp(logits[:, :16], mask[:, :16], u)


def test_served_fixture_on_the_card_equals_the_recorded_jax_actions(cuda):
    """The main path on the card: the shipped policy through the server,
    every answer the policy's and equal to the recorded JAX action, each
    kernel launched, and batched answers bit-equal to one-at-a-time."""
    from ddls_tpu_torch.serve import (BucketForward, PolicyServer,
                                      default_buckets, load_export)
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH, load_requests

    model, params, _ = load_export(EXPORT_PATH)
    requests, recorded = load_requests()
    server = PolicyServer(model, params, buckets=default_buckets(150, 512),
                          max_batch=8, max_queue=64, device="cuda")
    kernels.reset_launch_counts()
    ids = [server.submit(o, now=0.0) for o in requests]
    by_id = {r.request_id: r for r in server.drain(now=0.0)}
    assert all(by_id[i].source == "policy" for i in ids)
    np.testing.assert_array_equal([by_id[i].action for i in ids],
                                  recorded["jax_actions"])
    launched = kernels.launch_counts()
    assert all(launched[n] > 0 for n in FORWARD_KERNELS)
    assert not any(launched[n] for n in launched if n not in FORWARD_KERNELS)
    forward = BucketForward(model, params, 8, device="cuda")
    padded = [server.bucketer.bucket_obs(o)[1] for o in requests[:8]]
    lo, va, ac = forward.forward(padded)
    for k, obs in enumerate(padded):
        lo1, va1, ac1 = forward.forward([obs])
        assert np.array_equal(lo1[0], lo[k]) and va1[0] == va[k]
        assert ac1[0] == ac[k]


# ----------------------------------------------- K5–K8: the PPO update
def _close_scaled(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    torch.testing.assert_close(out, ref, rtol=0, atol=TOL * scale)


def _equal_all(a, b):
    return all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(a, b))


@pytest.mark.parametrize("activation", sorted(gnn.ACTIVATIONS))
@pytest.mark.parametrize("form", ["rows", "gather_concat", "zero_half"])
def test_ln_linear_act_bwd_matches_plain(cuda, activation, form):
    """K5 (with its block-order reduce) against its plain version given
    K1's output, at the reduce-on-messages shape, with a tie row (all
    features equal: the variance clamps at exactly 0), bitwise across two
    runs."""
    g = torch.Generator(device="cpu").manual_seed(11)
    rows, fa, fb, fo = 16384, 16, 16, 64
    a = torch.rand(4864, fa, generator=g)
    kwargs = {}
    if form == "gather_concat":
        kwargs = dict(idx=torch.randint(0, 4864, (rows,), generator=g,
                                        dtype=torch.int32).to(cuda),
                      b=torch.rand(rows, fb, generator=g).to(cuda))
    elif form == "zero_half":
        kwargs = dict(b_width=fb)
        rows = 4864
        a[7] = 0.0
    else:
        a = torch.rand(rows, fa + fb, generator=g) + 3.0
        a[5] = 2.0
    a = a.to(cuda)
    k_in = fa + fb
    ln_w = torch.randn(k_in, generator=g).to(cuda)
    ln_b = torch.randn(k_in, generator=g).to(cuda)
    w = (torch.randn(fo, k_in, generator=g) / 4).to(cuda)
    bias = torch.randn(fo, generator=g).to(cuda)
    dout = torch.randn(rows, fo, generator=g).to(cuda)
    before = kernels.launch_counts()
    out = gnn.ln_linear_act_bwd(a, ln_w, ln_b, w, bias, activation, dout,
                                **kwargs)
    assert _launched_since(before) == {"ln_linear_act_bwd": 1}
    again = gnn.ln_linear_act_bwd(a, ln_w, ln_b, w, bias, activation, dout,
                                  **kwargs)
    k1_out = gnn.ln_linear_act(a, ln_w, ln_b, w, bias, activation, **kwargs)
    ref = gnn.ln_linear_act_bwd_plain(a, ln_w, ln_b, w, bias, activation,
                                      dout, out=k1_out, **kwargs)
    for o, r in zip(out, ref):
        assert (o is None) == (r is None)
        if o is not None:
            _close_scaled(o, r)
    assert _equal_all(out, again)


def _launched_since(before):
    after = kernels.launch_counts()
    return {k: v - before[k] for k, v in after.items() if v != before[k]}


# K5's calls in one minibatch step of the shipped policy: (rows, fa, fb
# given or a zero half, gathered, fo, dx wanted); the calls on the data's
# features (graph 51, edges 2, nodes 5) want no dx, as on the main path
K5_MAIN_PATH = [(128, 51, 0, False, False, 8, False),
                (4864, 16, 16, False, False, 16, True),
                (16384, 16, 16, True, True, 16, True),
                (16384, 2, 0, False, False, 16, False),
                (4864, 64, 0, False, False, 16, True),
                (4864, 16, 16, False, False, 64, True),
                (16384, 16, 16, True, True, 64, True),
                (4864, 5, 0, False, False, 16, False)]


def _k5_inputs(cuda, rows, fa, fb, b_given, gathered, fo, seed):
    """K5's inputs at one call's widths. Column j of ``a`` lies in [j, j +
    0.5), so no row's variance is near 0: there float32's LayerNorm
    backward keeps no digits in any two summation orders (K5's first
    design and its plain version part the same way on such rows; the
    variance tie itself is held by test_ln_linear_act_bwd_matches_plain)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    src = max(rows // 3, 1) if gathered else rows
    a = (torch.rand(src, fa, generator=g) * 0.5
         + torch.arange(fa, dtype=torch.float32)).to(cuda)
    kwargs = {}
    if gathered:
        kwargs["idx"] = torch.randint(0, src, (rows,), generator=g,
                                      dtype=torch.int32).to(cuda)
    if b_given:
        kwargs["b"] = torch.rand(rows, fb, generator=g).to(cuda)
    elif fb:
        kwargs["b_width"] = fb
    k_in = fa + fb
    params = [torch.randn(k_in, generator=g).to(cuda),
              torch.randn(k_in, generator=g).to(cuda),
              (torch.randn(fo, k_in, generator=g) / 4).to(cuda),
              torch.randn(fo, generator=g).to(cuda)]
    dout = torch.randn(rows, fo, generator=g).to(cuda)
    return a, params, dout, kwargs


@pytest.mark.parametrize("shape", K5_MAIN_PATH + [
    (1, 16, 16, True, True, 64, True), (63, 64, 0, False, False, 64, True),
    (65, 5, 0, False, False, 16, True), (16897, 16, 16, True, True, 64, True),
    (40000, 32, 0, False, False, 17, True)])
def test_ln_linear_act_bwd_main_path_shapes_one_launch_repeatable(cuda,
                                                                  shape):
    """K5 at the main path's shapes and at ragged row counts (a row, part
    of a tile, more tiles than CTAs): within 1e-5 of each output's largest
    against its plain version given K1's output, one launch a call (the
    reduce inside it), bit-equal across two runs and across a CUDA
    graph's replays (the reduce's counters go back to 0)."""
    rows, fa, fb, b_given, gathered, fo, want_dx = shape
    a, (ln_w, ln_b, w, bias), dout, kwargs = _k5_inputs(
        cuda, rows, fa, fb, b_given, gathered, fo, rows + fo)

    def run():
        return gnn.ln_linear_act_bwd(a, ln_w, ln_b, w, bias, "relu", dout,
                                     want_dx=want_dx, **kwargs)

    before = kernels.launch_counts()
    out = run()
    assert _launched_since(before) == {"ln_linear_act_bwd": 1}
    again = run()
    k1_out = gnn.ln_linear_act(a, ln_w, ln_b, w, bias, "relu", **kwargs)
    ref = gnn.ln_linear_act_bwd_plain(a, ln_w, ln_b, w, bias, "relu", dout,
                                      out=k1_out, **kwargs)
    assert (out[0] is None) == (not want_dx)
    for o, r in zip(out, ref):
        if o is not None:
            _close_scaled(o, r)
    assert _equal_all(out, again)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph, stream=side):
        captured = run()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert _equal_all(captured, out)


def test_ln_linear_act_bwd_overlapping_streams_keep_their_reduces(cuda):
    """K5 launched on two streams at once, each call's reduce on its own
    stream's counters: every call gives the bits of a call made alone."""
    a, (ln_w, ln_b, w, bias), dout, kwargs = _k5_inputs(
        cuda, 16384, 16, 16, True, True, 64, 7)

    def run():
        return gnn.ln_linear_act_bwd(a, ln_w, ln_b, w, bias, "relu", dout,
                                     **kwargs)

    alone = run()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(4):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(run())
    for st in streams:
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for out in outs:
        assert _equal_all(out, alone)


@pytest.mark.parametrize("f", [64, 16])
def test_segment_backwards_match_plain_and_repeat_bitwise(cuda, f):
    """K6's three entries at the batch shapes, on the edge cases: nodes
    with no in-edges, padded edges, a graph with zero real nodes."""
    row_ptr, col, node_mask, v, e = _csr_case(cuda)
    g = torch.Generator(device="cpu").manual_seed(f)
    dout = torch.randn(v, f, generator=g).to(cuda)
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    edge_dst = torch.full((e,), -1, dtype=torch.int32, device=cuda)
    edge_dst[col[:int(row_ptr[-1])].long()] = torch.repeat_interleave(
        torch.arange(v, device=cuda), deg).to(torch.int32)
    out = segment.csr_segment_mean_bwd(dout, row_ptr, edge_dst, node_mask)
    again = segment.csr_segment_mean_bwd(dout, row_ptr, edge_dst, node_mask)
    ref = segment.csr_segment_mean_bwd_plain(dout, row_ptr, edge_dst,
                                             node_mask)
    for o, r in zip(out, ref):
        _close_scaled(o, r)
    assert _equal_all(out, again)
    msg = torch.randn(e, f, generator=g).to(cuda)
    summed = segment.csr_segment_sum(msg, row_ptr, col)
    torch.cuda.synchronize()
    assert torch.equal(summed, segment.csr_segment_sum_plain(msg, row_ptr,
                                                             col))
    n_graphs = 8
    pool_dout = torch.randn(n_graphs, f + 8, generator=g).to(cuda)
    mask = node_mask.view(n_graphs, -1)
    d_emb, d_graph = segment.masked_mean_pool_concat_bwd(pool_dout, mask, f)
    r_emb, r_graph = segment.masked_mean_pool_concat_bwd_plain(pool_dout,
                                                               mask, f)
    _close_scaled(d_emb, r_emb)
    assert torch.equal(d_graph, r_graph)
    assert torch.equal(d_emb[-1], torch.zeros_like(d_emb[-1]))


# K6's fuzzed widths: the scalar form (1, 3, 17), the vector form at one
# unit a row (4), the message and node widths of the update (16, 64)
K6_WIDTHS = (1, 3, 4, 16, 17, 64)
K6_ENTRIES = ("csr_segment_mean_bwd", "csr_segment_sum",
              "masked_mean_pool_concat_bwd")


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary (a view into a larger buffer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


def _k6_calls(cuda, f, seed):
    """K6's three entries' inputs at width ``f`` on the batch shapes of
    ``_csr_case`` (nodes without in-edges, padded edges, a graph with no
    real node), the CSR sum over the source CSR of the same edges, and a
    CSR whose slices are empty for all but its last node."""
    row_ptr, col, node_mask, v, e = _csr_case(cuda)
    g = torch.Generator(device="cpu").manual_seed(seed)
    deg = (row_ptr[1:] - row_ptr[:-1]).long()
    edge_dst = torch.full((e,), -1, dtype=torch.int32, device=cuda)
    edge_dst[col[:int(row_ptr[-1])].long()] = torch.repeat_interleave(
        torch.arange(v, device=cuda), deg).to(torch.int32)
    dout = torch.randn(v, f, generator=g).to(cuda)
    msg = torch.randn(e, f, generator=g).to(cuda)
    tail_ptr = torch.zeros(v + 1, dtype=torch.int32, device=cuda)
    tail_ptr[-1] = 9
    pool_dout = torch.randn(8, f + 8, generator=g).to(cuda)
    mask = node_mask.view(8, -1)
    return {"csr_segment_mean_bwd": [(dout, row_ptr, edge_dst, node_mask)],
            "csr_segment_sum": [(msg, row_ptr, col), (msg, tail_ptr, col)],
            "masked_mean_pool_concat_bwd": [(pool_dout, mask, f)]}


@pytest.mark.parametrize("f", K6_WIDTHS)
def test_segment_backwards_bit_equal_on_fuzzed_widths(cuda, f):
    """K6's three entries bit-equal to their plain versions at widths 1,
    3, 4, 16, 17 and 64 (the vector and scalar forms), on contiguous and
    misaligned first inputs (the mean backward then takes the scalar
    form; the pooling backward reads dout by the float, so it keeps its
    form), with the scalar form forced too (the CSR sum has one form), on
    nodes with no in-edges, padded edges, empty CSR slices and a graph
    with no real node; bitwise across two runs; one launch a call."""
    plain = {"csr_segment_mean_bwd": segment.csr_segment_mean_bwd_plain,
             "csr_segment_sum": segment.csr_segment_sum_plain,
             "masked_mean_pool_concat_bwd":
                 segment.masked_mean_pool_concat_bwd_plain}
    for name, calls in _k6_calls(cuda, f, f).items():
        fn = getattr(segment, name)
        for args in calls:
            want = plain[name](*args)
            want = want if isinstance(want, tuple) else (want,)
            first = args[0]
            forms = ("plain", "misaligned") + (
                () if name == "csr_segment_sum" else ("scalar",))
            for form in forms:
                a = ((_misaligned(first),) + args[1:] if form == "misaligned"
                     else args)
                runs = []
                for _ in range(2):
                    before = kernels.launch_counts()
                    if form == "scalar":
                        with kernels._forcing(name, "scalar"):
                            got = fn(*a)
                    else:
                        got = fn(*a)
                    assert _launched_since(before) == {name: 1}
                    runs.append(got if isinstance(got, tuple) else (got,))
                torch.cuda.synchronize()
                for g, w in zip(runs[0], want):
                    assert g.dtype == w.dtype and g.shape == w.shape
                    assert torch.equal(g.view(torch.int32),
                                       w.contiguous().view(torch.int32)), \
                        (name, form, f)
                assert _equal_all(runs[0], runs[1]), (name, form, f)


def test_segment_backward_plans_take_the_vector_form_on_the_update(cuda):
    """Each K6 C entry's plan (``ddls_segment_bwd_plan``, the plan the
    entry launches) is ``segment.segment_bwd_plan``'s for widths 1-64,
    row counts up to the update's, aligned or not and forced scalar or
    not; at the update's widths (16 and 64) fresh tensors are aligned, a
    misaligned view is not."""
    for entry, name in enumerate(segment.SEGMENT_ENTRIES):
        pool = name == "masked_mean_pool_concat_bwd"
        for f in range(1, 65):
            for rows in ((1, 8, 128, 1000) if pool else
                         (0, 1, 7, 255, 4864, 21248)):
                for n_nodes in ((1, 5, 38, 150) if pool else (0,)):
                    for aligned in (0, 1):
                        want = segment.segment_bwd_plan(name, f, rows,
                                                        n_nodes, aligned)
                        for force in (0, 1):
                            got = kernels.query(
                                "segment_bwd", "ddls_segment_bwd_plan",
                                entry, f, rows, n_nodes, aligned, force)
                            w = want if not force else \
                                segment.segment_bwd_plan(name, f, rows,
                                                         n_nodes, False)
                            assert got == w.packed(), (name, f, rows,
                                                       n_nodes, aligned,
                                                       force)
    for f in (16, 64):
        x = torch.empty(8, f, device=cuda)
        assert x.data_ptr() % 16 == 0
        assert _misaligned(x).data_ptr() % 16 != 0


@pytest.mark.parametrize("t_len", [64, 500])
def test_gae_normalize_matches_plain_and_repeats_bitwise(cuda, t_len):
    g = torch.Generator(device="cpu").manual_seed(t_len)
    rewards = torch.randn(t_len, 8, generator=g).to(cuda)
    values = (torch.randn(t_len, 8, generator=g) * 3 + 50).to(cuda)
    dones = (torch.rand(t_len, 8, generator=g) < 0.05).float().to(cuda)
    last = (torch.randn(8, generator=g) + 50).to(cuda)
    for normalize in (True, False):
        out = ppo.gae_normalize(rewards, values, dones, last, 0.997, 0.95,
                                normalize)
        again = ppo.gae_normalize(rewards, values, dones, last, 0.997, 0.95,
                                  normalize)
        ref = ppo.gae_normalize_plain(rewards, values, dones, last, 0.997,
                                      0.95, normalize)
        for o, r in zip(out, ref):
            _close_scaled(o, r)
        assert _equal_all(out, again)


def test_ppo_loss_matches_plain_autograd_at_the_ties(cuda):
    """K8 (loss, metrics, d loss / d logits and values in one launch)
    against autograd of the plain loss, on a minibatch with masked
    actions, a fully masked row, and rows exactly on the clip and vf-clip
    ties; through autograd the gradient is K8's, scaled."""
    rng = np.random.default_rng(9)
    m, a = 128, 17
    logits = rng.normal(0, 2, (m, a)).astype(np.float32)
    mask = rng.uniform(0, 1, (m, a)) < 0.6
    mask[:, 0] = True
    mask[5] = False
    actions = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0
                        for r in mask], np.int32)
    mask[0] = False
    mask[0, actions[0]] = True
    masked = np.where(mask, logits, logits + np.finfo(np.float32).min)
    old_logp = rng.normal(-1.5, 0.3, m).astype(np.float32)
    old_logp[0] = -np.float32(np.log(1.25))
    while float(torch.exp(torch.tensor(-old_logp[0], device=cuda))) != 1.25:
        old_logp[0] = np.nextafter(old_logp[0], np.float32(-np.inf))
    values = rng.normal(50, 2, m).astype(np.float32)
    old_values = (values + rng.normal(0, 0.6, m)).astype(np.float32)
    old_values[2], values[2] = 2.0, 2.5
    cfg = ppo.PPOConfig(clip_param=0.25, vf_clip_param=0.5,
                        vf_loss_coeff=0.5, entropy_coeff=0.01)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    args = (t(masked.astype(np.float32)), t(values), t(actions),
            t(old_logp), t(old_values),
            t(rng.normal(0, 1, m).astype(np.float32)),
            t(rng.normal(50, 2, m).astype(np.float32)),
            torch.tensor(0.2, device=cuda), cfg)
    out = ppo._ppo_loss_cuda(*args)
    again = ppo._ppo_loss_cuda(*args)
    ref = ppo.ppo_loss_grad_plain(*args)
    for o, r in zip(out, ref):
        _close_scaled(o, r)
    assert _equal_all(out, again)
    lo = args[0].clone().requires_grad_(True)
    with torch.enable_grad():
        total, _ = ppo.ppo_loss(lo, *args[1:])
        (grad,) = torch.autograd.grad(total * 2.0, lo)
    assert torch.equal(grad, out[2] * 2.0)


@pytest.mark.parametrize("m", [1, 31, 128, 129, 1000, 4000])
@pytest.mark.parametrize("a", [1, 2, 17, 32, 33, 64])
def test_ppo_loss_matches_plain_at_every_width_and_repeats_bitwise(cuda, m,
                                                                   a):
    """K8 over row counts that take one pass, two, and a cluster of CTAs,
    and action counts at and around its group widths (1-32 lanes a row),
    with masked actions and (from two rows) a fully masked row: one
    launch, every output within 1e-5 of its largest against autograd of
    the plain loss, bit-equal across two runs."""
    rng = np.random.default_rng(m * 100 + a)
    logits = rng.normal(0, 2, (m, a)).astype(np.float32)
    mask = rng.uniform(0, 1, (m, a)) < 0.6
    mask[:, 0] = True
    actions = np.array([rng.choice(np.flatnonzero(r)) for r in mask],
                       np.int32)
    if m > 1:
        mask[m // 2] = False
    masked = np.where(mask, logits, logits + np.finfo(np.float32).min)
    t = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, dtype=x.dtype)).to(cuda)
    f32 = lambda x: t(np.asarray(x, np.float32))  # noqa: E731
    cfg = ppo.PPOConfig(clip_param=0.25, vf_clip_param=0.5,
                        vf_loss_coeff=0.5, entropy_coeff=0.01)
    values = rng.normal(50, 2, m)
    args = (f32(masked), f32(values), t(actions),
            f32(rng.normal(-1.5, 0.5, m)),
            f32(values + rng.normal(0, 0.6, m)), f32(rng.normal(0, 1, m)),
            f32(rng.normal(50, 2, m)), torch.tensor(0.2, device=cuda), cfg)
    before = kernels.launch_counts()
    out = ppo._ppo_loss_cuda(*args)
    assert _launched_since(before) == {"ppo_loss": 1}
    again = ppo._ppo_loss_cuda(*args)
    ref = ppo.ppo_loss_grad_plain(*args)
    for o, r in zip(out, ref):
        _close_scaled(o, r)
    assert _equal_all(out, again)


def test_policy_backward_on_the_card_matches_the_plain_autograd(cuda):
    """The whole policy's parameter gradients through K1–K6 (and K4's
    pass-through) on the edge-case batch against the plain autograd path
    on the same inputs, on the card."""
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH, load_requests
    from ddls_tpu_torch.envs.obs import pad_obs_to

    model, _, _ = load_export(EXPORT_PATH)
    model = model.to(cuda)
    requests, _ = load_requests()
    obs = [pad_obs_to(r, 150, 512) for r in requests[:8]]
    obs[6] = dict(obs[6], action_mask=np.zeros_like(obs[6]["action_mask"]))
    stacked = {k: np.stack([o[k] for o in obs]) for k in obs[0]}
    batch = policy.batch_to_device(policy.prepare_flat_batch(stacked), cuda)
    w = torch.randn(8, 17, generator=torch.Generator(
        device="cpu").manual_seed(1)).to(cuda)
    params = list(model.parameters())
    with torch.enable_grad():
        kernels.reset_launch_counts()
        lo, va, _ = model.flat_batched(batch)
        valid = batch["action_mask"] > 0
        scalar = (torch.where(valid, lo, 0.0) * w).sum() + va.sum()
        grads = torch.autograd.grad(scalar, params)
        launched = kernels.launch_counts()
        assert all(launched[n] > 0 for n in (
            "ln_linear_act_bwd", "csr_segment_mean_bwd", "csr_segment_sum",
            "masked_mean_pool_concat_bwd"))
        cpu_model = model.to("cpu")
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        lo_c, va_c, _ = cpu_model.flat_batched(cpu_batch)
        scalar_c = (torch.where(valid.cpu(), lo_c, 0.0) * w.cpu()).sum() \
            + va_c.sum()
        ref = torch.autograd.grad(scalar_c, list(cpu_model.parameters()))
    for g_, r in zip(grads, ref):
        _close_scaled(g_.cpu(), r)


def test_fixture_update_on_the_card_matches_the_recorded_jax(cuda):
    """One train_step of the fixture at 1 SGD iteration on the card, the
    recorded JAX permutation handed over: params within 1e-5 of the JAX
    update (observed 1.2e-7), every kernel K1–K8 launched."""
    import dataclasses

    from ddls_tpu_torch.models.convert import params_to_flax
    from ddls_tpu_torch.rl.fixture import load_train_fixture
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    fx = load_train_fixture()
    model, params, _ = load_export(EXPORT_PATH)
    run = fx["runs"][1]
    learner = ppo.PPOLearner(model, dataclasses.replace(fx["cfg"],
                                                        num_sgd_iter=1))
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    state = learner.init_state({k: v.to(cuda) for k, v in params.items()})
    kernels.reset_launch_counts()
    state, metrics = learner.train_step(state, staged, perms=run["perms"])
    torch.cuda.synchronize()
    # K9 samples rollouts, K10-K16 belong to the other learners and
    # K21-K30 to the simulator: the PPO update never launches them
    assert all(n > 0 for name, n in kernels.launch_counts().items()
               if name not in ("mask_sample_logp", *AC_KERNELS,
                               *DQN_ES_KERNELS, *SIM_KERNELS))
    tree = params_to_flax(state.state_dict())
    for key, value in tree.items():
        np.testing.assert_allclose(value, run["params"][key], rtol=0,
                                   atol=1e-5, err_msg=key)
    assert float(state.kl_coeff) == run["kl_coeff"]


def test_first_minibatch_gradients_on_the_card_match_recorded_jax(cuda):
    """The loss gradient through K1–K8 at the shipped params on the first
    minibatch of the fixture's update, before any optimiser arithmetic:
    each leaf within 1e-5 of its largest recorded JAX gradient."""
    from ddls_tpu_torch.models.convert import params_to_flax
    from ddls_tpu_torch.rl.fixture import load_train_fixture
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    fx = load_train_fixture()
    model, params, _ = load_export(EXPORT_PATH)
    learner = ppo.PPOLearner(model, fx["cfg"])
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    state = learner.init_state({k: v.to(cuda) for k, v in params.items()})
    advs, targets = learner.flat_advantages(staged)
    idx = torch.as_tensor(
        fx["runs"][1]["perms"][0][:fx["cfg"].sgd_minibatch_size],
        device=cuda)
    _, grads = learner.loss_and_grads(state, staged, idx, advs, targets)
    got = params_to_flax(dict(zip(state.names, grads)))
    for key, ref in fx["mb0"]["grads"].items():
        np.testing.assert_allclose(got[key], ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=key)


# ------------------------------------- K10–K12: the IMPALA and PG updates
def _scan_case(cuda, t_len, lanes=8, seed=0):
    """[T, B] scan inputs: episode ends at t = 0, mid-way and T - 1 (lane
    0) and on every step (lane 1), importance weights far above and below
    both clips."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    behavior = torch.randn(t_len, lanes, generator=g) * 0.5 - 1.5
    target = behavior + torch.randn(t_len, lanes, generator=g) * 3.0
    rewards = torch.randn(t_len, lanes, generator=g)
    values = torch.randn(t_len, lanes, generator=g) * 3 + 50
    dones = (torch.rand(t_len, lanes, generator=g) < 0.05).float()
    dones[[0, t_len // 2, t_len - 1], 0] = 1.0
    dones[:, 1] = 1.0
    last = torch.randn(lanes, generator=g) + 50
    return [x.to(cuda) for x in (behavior, target, rewards, values, dones,
                                 last)]


@pytest.mark.parametrize("t_len,lanes", [(64, 8), (15, 32), (25, 8), (1, 8)])
def test_vtrace_and_reward_to_go_match_plain_and_repeat_bitwise(cuda, t_len,
                                                                lanes):
    args = _scan_case(cuda, t_len, lanes)
    rho = torch.exp(args[1] - args[0])
    assert bool((rho > 4).any()) and bool((rho < 0.25).any())
    before = kernels.launch_counts()
    out = impala.vtrace(*args, 0.99, 1.0, 0.8)
    again = impala.vtrace(*args, 0.99, 1.0, 0.8)
    ref = impala.vtrace_plain(*args, 0.99, 1.0, 0.8)
    for o, r in zip(out, ref):
        _close_scaled(o, r)
    assert _equal_all(out, again)
    ret = pg.reward_to_go(args[2], args[4], 0.99)
    _close_scaled(ret, pg.reward_to_go_plain(args[2], args[4], 0.99))
    assert torch.equal(ret, pg.reward_to_go(args[2], args[4], 0.99))
    after = kernels.launch_counts()
    assert after["vtrace"] == before["vtrace"] + 2
    assert after["reward_to_go"] == before["reward_to_go"] + 2


def _ac_case(cuda, t_len=16, lanes=8, a=17, seed=5):
    """B-major rows of masked logits with a fully masked row and a row with
    one valid action, and the loss's other inputs."""
    rng = np.random.default_rng(seed)
    rows = t_len * lanes
    logits = rng.normal(0, 2, (rows, a)).astype(np.float32)
    mask = rng.uniform(0, 1, (rows, a)) < 0.6
    mask[:, 0] = True
    mask[5] = False
    mask[9] = False
    mask[9, 3] = True
    actions = np.array([rng.choice(np.flatnonzero(r)) if r.any() else 0
                        for r in mask], np.int32)
    masked = np.where(mask, logits, logits + np.finfo(np.float32).min)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(cuda)
    return (t(masked.astype(np.float32)),
            t(rng.normal(50, 2, rows).astype(np.float32)), t(actions),
            t(rng.normal(0, 3, rows).astype(np.float32)),
            t(rng.normal(50, 2, rows).astype(np.float32)),
            t(rng.normal(-1.5, 0.5, rows).astype(np.float32)))


@pytest.mark.parametrize("drop_last", [True, False])
def test_ac_loss_matches_plain_autograd(cuda, drop_last):
    """K12 (loss, seven metrics, d loss / d logits and values in one
    launch) against autograd of the plain loss, with masked actions, a
    fully masked row, a one-valid-action row, the IMPALA coefficients and
    each setting of the dropped last step; through autograd the gradient is
    K12's, scaled; ``ac_logp`` equals its plain version."""
    logits, values, actions, weights, vs, behavior = _ac_case(cuda)
    args = (logits, values, actions, weights, vs, behavior, 16, drop_last,
            0.5, 0.01, 1.0)
    out = actor_critic._ac_loss_cuda(*args)
    again = actor_critic._ac_loss_cuda(*args)
    ref = actor_critic.ac_loss_grad_plain(*args)
    for o, r in zip(out, ref):
        _close_scaled(o, r)
    assert _equal_all(out, again)
    dropped = out[2].reshape(8, 16, -1)[:, -1]
    assert bool((dropped == 0).all()) == drop_last
    lo = logits.clone().requires_grad_(True)
    with torch.enable_grad():
        total, _ = actor_critic.ac_loss(lo, *args[1:])
        (grad,) = torch.autograd.grad(total * 2.0, lo)
    assert torch.equal(grad, out[2] * 2.0)
    lp = actor_critic.ac_logp(logits, actions)
    _close_scaled(lp, actor_critic.ac_logp_plain(logits, actions))
    assert float(lp[9]) == 0.0  # the one valid action


@pytest.mark.parametrize("algo", ["impala", "pg"])
def test_ac_update_on_the_card_matches_the_recorded_jax(cuda, algo):
    """The first recorded JAX update of each learner on the fixture
    trajectory, on the card: params within 1e-5 of each leaf's largest
    magnitude, and the update's kernels launched (IMPALA: K10 and K12,
    PG: K11 and K12, both through the policy's backward)."""
    from ddls_tpu_torch.models.convert import params_to_flax
    from ddls_tpu_torch.rl.fixture import load_ac_fixture, load_train_fixture
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    fx = load_ac_fixture()[algo]
    train = load_train_fixture()
    model, params, _ = load_export(EXPORT_PATH)
    cls = impala.ImpalaLearner if algo == "impala" else pg.PGLearner
    learner = cls(model, fx["cfg"])
    staged = learner.stage_traj(train["traj"], train["last_values"])
    state = learner.init_state({k: v.to(cuda) for k, v in params.items()})
    kernels.reset_launch_counts()
    state, _ = learner.train_step(state, staged)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    scan = "vtrace" if algo == "impala" else "reward_to_go"
    assert launched[scan] == 1 and launched["ac_loss"] == 1
    assert launched["ln_linear_act_bwd"] > 0
    tree = params_to_flax(state.state_dict())
    for key, value in tree.items():
        ref = fx["steps"][0]["params"][key]
        np.testing.assert_allclose(value, ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()),
                                   err_msg=key)


def test_ac_wrappers_reject_what_they_cannot_take(cuda):
    logits, values, actions, weights, vs, behavior = _ac_case(cuda)
    with pytest.raises(ValueError, match="whole lanes"):
        actor_critic._ac_loss_cuda(logits, values, actions, weights, vs,
                                   behavior, 15, True, 0.5, 0.01, 1.0)
    with pytest.raises(ValueError, match="A <= 64"):
        actor_critic.ac_logp(torch.rand(4, 65, device=cuda),
                             actions[:4])
    with pytest.raises(TypeError, match="float32"):
        impala.vtrace(*[x.double() for x in _scan_case(cuda, 4)], 0.99)


def test_backward_wrappers_reject_what_they_cannot_take(cuda):
    dout = torch.rand(4, 3, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        segment.csr_segment_mean_bwd(
            dout.double(), torch.zeros(5, dtype=torch.int32, device=cuda),
            torch.zeros(2, dtype=torch.int32, device=cuda),
            torch.ones(4, device=cuda))
    with pytest.raises(ValueError, match="A <= 64"):
        ppo._ppo_loss_cuda(torch.rand(4, 65, device=cuda),
                           torch.rand(4, device=cuda),
                           torch.zeros(4, dtype=torch.int32, device=cuda),
                           *(torch.rand(4, device=cuda),) * 4,
                           torch.tensor(0.2, device=cuda), ppo.PPOConfig())
    with pytest.raises(ValueError, match="src_csr"):
        with torch.enable_grad():
            gnn.ln_linear_act(
                torch.rand(4, 2, device=cuda, requires_grad=True),
                torch.ones(4, device=cuda), torch.zeros(4, device=cuda),
                torch.rand(5, 4, device=cuda), torch.zeros(5, device=cuda),
                "relu", idx=torch.zeros(3, dtype=torch.int32, device=cuda),
                b=torch.rand(3, 2, device=cuda))


# ------------------------------------------ K13-K16: Ape-X DQN and ES
def _dqn_case(cuda, rows=64, a=17, seed=12):
    """Heads of three forwards, a mask with a fully masked row and a
    one-valid-action row, actions, rewards (rows 3-5 pinned to td -0.5, -1,
    2 under dueling), discounts with a zero, weights, epsilons and
    uniforms."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(0, 1, shape).astype(np.float32)).to(cuda)
    logits, values = f(3, rows, a), f(3, rows)
    mask = (rng.random((rows, a)) < 0.5).astype(np.int32)
    mask[:, 1] = 1
    mask[0] = 0
    mask[2] = 0
    mask[2, 7] = 1
    mask = torch.from_numpy(mask).to(cuda)
    rewards, discounts = f(rows), torch.full((rows,), 0.997, device=cuda)
    discounts[1] = 0.0
    for row, td in ((3, -0.5), (4, -1.0), (5, 2.0)):
        logits[0, row] = 0.0
        values[0, row] = 0.25
        discounts[row] = 0.0
        rewards[row] = 0.25 - td
    actions = torch.from_numpy(rng.integers(0, a, rows).astype(
        np.int32)).to(cuda)
    weights = torch.from_numpy(rng.uniform(0.2, 1, rows).astype(
        np.float32)).to(cuda)
    eps = torch.linspace(0, 1, rows, device=cuda)
    u_explore = torch.from_numpy(rng.random(rows).astype(np.float32)).to(
        cuda)
    u_pick = torch.from_numpy(rng.uniform(1e-6, 1, (rows, a)).astype(
        np.float32)).to(cuda)
    return (logits, values, mask, actions, rewards, discounts, weights, eps,
            u_explore, u_pick)


@pytest.mark.parametrize("dueling", [True, False])
def test_dqn_act_matches_plain_and_repeats_bitwise(cuda, dueling):
    (logits, values, mask, _, _, _, _, eps, u_explore,
     u_pick) = _dqn_case(cuda)
    args = (logits[0], values[0], mask, eps, u_explore, u_pick, dueling)
    before = kernels.launch_counts()["dqn_act"]
    out = dqn.dqn_act(*args)
    again = dqn.dqn_act(*args)
    assert kernels.launch_counts()["dqn_act"] == before + 2
    assert torch.equal(out, dqn.dqn_act_plain(*args))
    assert torch.equal(out, again) and out.dtype == torch.int32
    greedy = dqn.dqn_act(logits[0], values[0], mask, torch.zeros_like(eps),
                         u_explore, u_pick, dueling).cpu().numpy()
    assert greedy[0] == 0 and greedy[2] == 7  # fully masked, one valid


@pytest.mark.parametrize("double_q,dueling", [(True, True), (False, True),
                                              (True, False), (False, False)])
def test_dqn_td_loss_matches_plain_autograd(cuda, double_q, dueling):
    """K14 (loss, metrics, |td| and the online forward's gradient in one
    entry) against autograd of the plain loss; the pinned rows' |td| 0.5,
    1 and 2 exactly; through autograd the gradient is K14's, scaled."""
    (logits, values, mask, actions, rewards, discounts, weights, _, _,
     _) = _dqn_case(cuda)
    if not dueling:
        rewards[3:6] -= 0.25
    args = (logits[0], values[0], logits[1], values[1], logits[2],
            values[2], mask, actions, rewards, discounts, weights,
            double_q, dueling)
    out = dqn._dqn_td_loss_cuda(*args)
    again = dqn._dqn_td_loss_cuda(*args)
    ref = dqn.dqn_td_loss_grad_plain(*args)
    for o, r in zip(out, ref):
        _close_scaled(o, r)
    assert _equal_all(out, again)
    assert out[2][3:6].tolist() == [0.5, 1.0, 2.0]
    lo = logits[0].clone().requires_grad_(True)
    with torch.enable_grad():
        loss, _, _ = dqn.dqn_td_loss(lo, *args[1:])
        (grad,) = torch.autograd.grad(loss * 2.0, lo)
    assert torch.equal(grad, out[3] * 2.0)


@pytest.mark.parametrize("p", [2, 10, 64])
def test_es_update_matches_plain_and_repeats_bitwise(cuda, p):
    """K15 at populations 2, 10 and 64 over 6,000 parameters, on fitness
    with ties, every member equal and a NaN: the centred ranks exactly the
    plain version's, the gradient and its norm within 1e-5 of their
    largest magnitude, bitwise across two runs."""
    rng = np.random.default_rng(p)
    eps = torch.from_numpy(rng.normal(0, 1, (p // 2, 6000)).astype(
        np.float32)).to(cuda)
    theta = torch.from_numpy(rng.normal(0, 1, 6000).astype(
        np.float32)).to(cuda)
    nan = rng.integers(0, 3, p).astype(np.float32)
    nan[p // 2] = np.nan
    for fit in (rng.integers(0, 3, p).astype(np.float32),
                np.full(p, 2.0, np.float32), nan):
        fitness = torch.from_numpy(fit).to(cuda)
        out = es.es_update(fitness, eps, theta, 0.02, 0.005)
        again = es.es_update(fitness, eps, theta, 0.02, 0.005)
        ref = es.es_update_plain(fitness, eps, theta, 0.02, 0.005)
        torch.cuda.synchronize()
        assert torch.equal(out[2], ref[2])
        _close_scaled(out[0], ref[0])
        finite = ~torch.isnan(ref[1])
        assert torch.equal(torch.isnan(out[1]), ~finite)
        _close_scaled(out[1][finite], ref[1][finite])
        assert torch.equal(out[0], again[0]) and torch.equal(out[2],
                                                             again[2])


def test_es_act_matches_plain_and_repeats_bitwise(cuda):
    rng = np.random.default_rng(13)
    logits = torch.from_numpy(rng.normal(0, 0.02, (10, 17)).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy((rng.random((10, 17)) < 0.5).astype(
        np.int32)).to(cuda)
    mask[:, 4] = 1
    mask[0] = 0
    noise = torch.from_numpy(rng.normal(0, 1, (10, 17)).astype(
        np.float32)).to(cuda)
    for std in (0.0, 0.01, 1.0):
        out = es.es_act(logits, mask, noise, std)
        assert torch.equal(out, es.es_act_plain(logits, mask, noise, std))
        assert torch.equal(out, es.es_act(logits, mask, noise, std))
        assert int(out[0]) == 0  # the fully masked member


def test_dqn_es_wrappers_reject_what_they_cannot_take(cuda):
    (logits, values, mask, _, _, _, _, eps, u_explore,
     u_pick) = _dqn_case(cuda, a=33)
    with pytest.raises(ValueError, match="A <= 32"):
        dqn.dqn_act(logits[0], values[0], mask, eps, u_explore, u_pick, True)
    with pytest.raises(ValueError, match="even"):
        es.es_update(torch.zeros(3, device=cuda),
                     torch.zeros(1, 5, device=cuda),
                     torch.zeros(5, device=cuda), 0.02, 0.005)
    with pytest.raises(TypeError, match="float32"):
        es.es_act(logits[0, :4, :17].double(), mask[:4, :17],
                  u_pick[:4, :17], 0.01)


def test_dqn_and_es_updates_on_the_card_match_the_recorded_jax(cuda):
    """The first recorded JAX DQN update (512 replay rows) and ES update
    (P = 10), on the card: params within 1e-5 of each leaf's largest
    magnitude, and K14 and K15 each launched once."""
    from ddls_tpu_torch.models.convert import (params_from_flax,
                                               params_to_flax)
    from ddls_tpu_torch.rl.fixture import (fixture_replay,
                                           load_dqn_es_fixture)
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    fx = load_dqn_es_fixture()
    dqn_fx, es_fx = fx["dqn"], fx["es"]
    model = policy.GNNPolicy(**dqn_fx["arch"])
    learner = dqn.ApexDQNLearner(model, dqn_fx["cfg"])
    state = learner.init_state({k: v.to(cuda) for k, v in params_from_flax(
        dqn_fx["init"], model).items()})
    ref = dqn_fx["updates"][0]
    replay = fixture_replay(dqn_fx["cfg"])
    kernels.reset_launch_counts()
    state, _, _ = learner.train_step(state, dqn.train_batch(
        replay.gather(ref["idx"]), ref["weights"]))
    es_model, params, _ = load_export(EXPORT_PATH)
    es_learner = es.ESLearner(es_model, es_fx["cfg"], 10)
    es_state = es_learner.init_state({k: v.to(cuda)
                                      for k, v in params.items()})
    eps = torch.stack([es_learner.flat(params_from_flax(
        {k: v[i] for k, v in es_fx["window"]["eps"].items()}, es_model))
        for i in range(5)]).to(cuda)
    es_state, _ = es_learner.update(es_state, eps, es_fx["window"][
        "fitness"])
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    assert launched["dqn_td_loss"] == 1 and launched["es_update"] == 1
    for st, want in ((state, ref["params"]),
                     (es_state, es_fx["updates"][0]["params"])):
        tree = params_to_flax(st.state_dict())
        for key, value in tree.items():
            np.testing.assert_allclose(
                value, want[key], rtol=0,
                atol=1e-5 * float(np.abs(want[key]).max()), err_msg=key)


# ------------------------------------- K17-K20: heads, optimiser, minibatch
HEAD_CASES = [((17,), "relu"), ((256,), "relu"), ((256, 256), "relu"),
              ((), "relu"), ((17,), "tanh"), ((32, 16), "gelu")]


def _head_layers(cuda, hiddens, n_actions=17, k_in=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for final in (n_actions, 1):
        widths = [k_in, *hiddens, final]
        out.append([((torch.randn(widths[i + 1], widths[i], generator=g)
                      / widths[i] ** 0.5).to(cuda),
                     (torch.randn(widths[i + 1], generator=g) * 0.1).to(cuda))
                    for i in range(len(widths) - 1)])
    return out


@pytest.mark.parametrize("hiddens,activation", HEAD_CASES)
def test_mlp_heads_matches_plain_and_is_row_independent(cuda, hiddens,
                                                        activation):
    """K17 against the plain heads (F.linear) within 1e-5 of each output's
    largest magnitude, at 1, 8, 128 and 515 rows (a ragged last tile); each
    row's answer bit-equal whatever else shares the batch (the serving
    invariant); one launch per call."""
    logit_layers, value_layers = _head_layers(cuda, hiddens)
    x = torch.randn(515, 24, generator=torch.Generator().manual_seed(1)
                    ).to(cuda)
    for rows in (1, 8, 128, 515):
        before = kernels.launch_counts()["mlp_heads"]
        logits, values = policy.mlp_heads(x[:rows], logit_layers,
                                          value_layers, activation)
        assert kernels.launch_counts()["mlp_heads"] == before + 1
        ref = policy.mlp_heads_plain(x[:rows], logit_layers, value_layers,
                                     activation)
        _close_scaled(logits, ref[0])
        _close_scaled(values, ref[1])
    full = policy.mlp_heads(x, logit_layers, value_layers, activation)
    for r in (0, 7, 300, 514):
        one = policy.mlp_heads(x[r:r + 1], logit_layers, value_layers,
                               activation)
        assert torch.equal(one[0][0], full[0][r])
        assert torch.equal(one[1][0], full[1][r])


# K17's row counts: serving's (one CTA up to 8), a 16-row tile and past it,
# the update's minibatch, past the grid's 132 CTAs, the canonical batch
K17_ROWS = (1, 7, 8, 16, 17, 128, 500, 4000)


def _heads_fma_chain(x, layers):
    """One relu head as K17 computes it, exactly: each output an fmaf chain
    over the inputs in order from 0 (``lookahead.fma32``: one rounding),
    then the bias added; relu as ``fmaxf(z, 0)``."""
    h = x
    for i, (w, b) in enumerate(layers):
        acc = torch.zeros((h.shape[0], w.shape[0]), device=h.device)
        for k in range(w.shape[1]):
            acc = lookahead_mod.fma32(h[:, k, None].expand_as(acc),
                                      w[None, :, k].expand_as(acc), acc)
        h = acc + b
        if i < len(layers) - 1:
            h = torch.maximum(h, torch.zeros_like(h))
    return h


@pytest.mark.parametrize("hiddens", [(17,), (256,), (256, 256)],
                         ids=["shipped", "dqn", "default"])
def test_mlp_heads_bit_equal_at_every_tile(cuda, hiddens):
    """K17 on the shipped heads (staged whole), the Ape-X DQN's 256-wide
    ones and the default (256, 256) ones (streamed) at every row count of
    ``K17_ROWS``: bit-equal to its arithmetic done exactly in PyTorch
    (``_heads_fma_chain``), within 1e-5 of ``mlp_heads_plain`` (F.linear
    adds in cuBLAS's order), the same bits at the plan's tile and at tiles
    of 1, 4 and 16 rows forced, bitwise across two runs, one launch a
    call."""
    logit_layers, value_layers = _head_layers(cuda, hiddens, seed=11)
    g = torch.Generator().manual_seed(12)
    for rows in K17_ROWS:
        x = torch.randn(rows, 24, generator=g).to(cuda)
        want = (_heads_fma_chain(x, logit_layers),
                _heads_fma_chain(x, value_layers)[:, 0])
        ref = policy.mlp_heads_plain(x, logit_layers, value_layers, "relu")
        runs = []
        for tile in (None, None, 1, 4, 16):
            before = kernels.launch_counts()
            if tile is None:
                got = policy.mlp_heads(x, logit_layers, value_layers, "relu")
            else:
                with kernels._forcing("mlp_heads", tile):
                    got = policy.mlp_heads(x, logit_layers, value_layers,
                                           "relu")
            assert _launched_since(before) == {"mlp_heads": 1}
            runs.append(got)
        torch.cuda.synchronize()
        for got in runs:
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.int32),
                                   b.contiguous().view(torch.int32)), \
                    (hiddens, rows)
        _close_scaled(runs[0][0], ref[0])
        _close_scaled(runs[0][1], ref[1])


@pytest.mark.parametrize("hiddens,activation", HEAD_CASES)
def test_mlp_heads_bwd_matches_plain_autograd(cuda, hiddens, activation):
    """K18 (through K17's autograd function) against autograd of the plain
    heads: dx and every weight and bias gradient within 1e-5 of its
    largest magnitude, at 128 and 1,000 rows (past K18's 16-CTA cluster);
    bitwise across two runs; one K18 launch a backward, its reduce inside;
    a head the loss does not reach gets zero gradients."""
    logit_layers, value_layers = _head_layers(cuda, hiddens)
    g = torch.Generator().manual_seed(2)
    for rows in (128, 1000):
        x = torch.randn(rows, 24, generator=g).to(cuda)
        dlogits = torch.randn(rows, 17, generator=g).to(cuda)
        dvalue = torch.randn(rows, generator=g).to(cuda)
        leaves = [t.detach().clone().requires_grad_() for t in
                  [x] + [t for layer in logit_layers + value_layers
                         for t in layer]]
        pairs = list(zip(leaves[1::2], leaves[2::2]))
        n = len(logit_layers)
        runs = []
        for _ in range(2):
            before = kernels.launch_counts()
            logits, values = policy.mlp_heads(leaves[0], pairs[:n],
                                              pairs[n:], activation)
            grads = torch.autograd.grad((logits, values), leaves,
                                        (dlogits, dvalue))
            after = kernels.launch_counts()
            assert {k: after[k] - before[k] for k in after
                    if after[k] != before[k]} == {"mlp_heads": 1,
                                                  "mlp_heads_bwd": 1}
            runs.append(grads)
        dx, ref = policy.mlp_heads_bwd_plain(x, logit_layers, value_layers,
                                             activation, dlogits, dvalue)
        for got, want in zip(runs[0], [dx, *ref]):
            _close_scaled(got, want)
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        # PG's value head: no gradient reaches it
        logits, _ = policy.mlp_heads(leaves[0], pairs[:n], pairs[n:],
                                     activation)
        grads = torch.autograd.grad(logits, leaves, dlogits,
                                    allow_unused=True,
                                    materialize_grads=True)
        assert all(not t.any() for t in grads[1 + 2 * n:])


# K18's row counts: one tile, a ragged one, the update's minibatch (one
# 16-CTA cluster), past the cluster (a ticket), the 132-CTA cap and past
# it (CTAs taking several tiles), the canonical full batch
K18_ROWS = (1, 7, 8, 128, 500, 512, 1056, 1057, 4000)


@pytest.mark.parametrize("hiddens", [(17,), (256,), (256, 256)],
                         ids=["shipped", "dqn", "default"])
def test_mlp_heads_bwd_one_launch_at_every_row_count(cuda, hiddens):
    """K18 called directly at every row count of ``K18_ROWS`` on the
    shipped heads (24 -> 17 -> {17, 1}, staged whole), the Ape-X DQN's (24
    -> 256 -> {17, 1}) and the default (256, 256) ones (streamed in
    chunks): dx and every gradient within 1e-5 of its largest magnitude
    of autograd of the plain heads, bitwise across two runs, one launch a
    call (its reduce inside: one cluster up to 16 CTAs, else clusters of 8
    and a ticket);
    then the cluster and ticket paths again on a second stream, whose
    ticket counter is its own."""
    logit_layers, value_layers = _head_layers(cuda, hiddens, seed=5)
    g = torch.Generator().manual_seed(6)
    for rows in K18_ROWS:
        x = torch.randn(rows, 24, generator=g).to(cuda)
        dlogits = torch.randn(rows, 17, generator=g).to(cuda)
        dvalue = torch.randn(rows, generator=g).to(cuda)
        args = (x, logit_layers, value_layers, "relu", dlogits, dvalue)
        runs = []
        for _ in range(2):
            before = kernels.launch_counts()["mlp_heads_bwd"]
            dx, grads = policy.mlp_heads_bwd(*args)
            assert kernels.launch_counts()["mlp_heads_bwd"] == before + 1
            runs.append([dx, *grads])
        ref_dx, ref = policy.mlp_heads_bwd_plain(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs)), rows
        for got, want in zip(runs[0], [ref_dx, *ref]):
            _close_scaled(got, want)
        if rows in (128, 4000):
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                again = policy.mlp_heads_bwd(*args)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in
                       zip(runs[0], [again[0], *again[1]])), rows


def test_mlp_heads_bwd_captures_on_a_fresh_stream(cuda):
    """K18 at the update's 128 rows (one cluster, no ticket) captured in a
    CUDA graph as the first call on a fresh stream: the capture takes no
    ticket counter, one launch is counted, and the replay gives the bits
    of an eager call."""
    logit_layers, value_layers = _head_layers(cuda, (17,), seed=7)
    g = torch.Generator().manual_seed(8)
    x = torch.randn(128, 24, generator=g).to(cuda)
    dlogits = torch.randn(128, 17, generator=g).to(cuda)
    dvalue = torch.randn(128, generator=g).to(cuda)
    args = (x, logit_layers, value_layers, "relu", dlogits, dvalue)
    eager_dx, eager = policy.mlp_heads_bwd(*args)
    assert policy.heads_bwd_plan(128)[3] == 1
    graph, fresh = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    before = kernels.launch_counts()["mlp_heads_bwd"]
    with torch.cuda.graph(graph, stream=fresh):
        dx, grads = policy.mlp_heads_bwd(*args)
    assert kernels.launch_counts()["mlp_heads_bwd"] == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(dx, eager_dx)
    assert all(torch.equal(a, b) for a, b in zip(grads, eager))


def _opt_state(cuda, rule, seed=0):
    from ddls_tpu_torch.rl.learner import TrainState

    g = torch.Generator().manual_seed(seed)
    shapes = [(16, 5), (16,), (64, 32), (64,), (17, 24), (17,), (1, 17),
              (1,), (3000,)]
    params = [torch.randn(s, generator=g).to(cuda) for s in shapes]
    mu = None if rule == "rmsprop" else [torch.zeros_like(p)
                                          for p in params]
    return TrainState(names=[str(i) for i in range(len(shapes))],
                      params=params, mu=mu,
                      nu=[torch.zeros_like(p) for p in params]), g


@pytest.mark.parametrize("rule", ["adam", "rmsprop", "rmsprop_momentum"])
@pytest.mark.parametrize("clip", [None, 1e6, 0.5])
def test_clip_adam_matches_plain_over_steps(cuda, rule, clip):
    """K19 against the plain optimiser over 5 steps (clip absent, never
    firing, always firing): params, mu and nu within 1e-6 of each leaf's
    largest magnitude; one launch a step; the leaf table built once."""
    from ddls_tpu_torch.rl.learner import (OptimizerStep, clip_adam,
                                           clip_adam_plain)

    state, g = _opt_state(cuda, rule)
    ref_params = [p.clone() for p in state.params]
    ref_mu = None if state.mu is None else [m.clone() for m in state.mu]
    ref_nu = [v.clone() for v in state.nu]
    tables = set()
    for step in range(1, 6):
        hp = (OptimizerStep("adam", 1e-3, clip, 0.9, 0.999, 1e-8,
                            1 - 0.9 ** step, 1 - 0.999 ** step)
              if rule == "adam" else
              OptimizerStep(rule, 1e-3, clip, 0.5, 0.99, 0.1))
        grads = [torch.randn(p.shape, generator=g).to(cuda)
                 for p in state.params]
        before = kernels.launch_counts()
        clip_adam(state, grads, hp)
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {"clip_adam": 1}
        tables.add(id(state.opt_table))
        clip_adam_plain(ref_params, grads, ref_mu, ref_nu, hp)
    assert len(tables) == 1
    for got, want in ((state.params, ref_params), (state.nu, ref_nu),
                      (state.mu or [], ref_mu or [])):
        for a, b in zip(got, want):
            torch.cuda.synchronize()
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))


def test_clip_adam_at_the_clip_tie(cuda):
    """A global norm within rounding of grad_clip: K19's fixed-order norm
    and the plain version's per-leaf norms may fall on either side of the
    comparison, and the two results then differ by that rounding only
    (within 1e-6 of each leaf's largest magnitude); the kernel's step is
    one of its two candidates (kept or clipped gradient)."""
    from ddls_tpu_torch.rl.learner import (OptimizerStep, clip_adam,
                                           clip_adam_plain)

    for seed in range(4):
        state, g = _opt_state(cuda, "adam", seed)
        grads = [torch.randn(p.shape, generator=g).to(cuda)
                 for p in state.params]
        norm = float(np.sqrt(sum(float((x.double() ** 2).sum())
                                 for x in grads)))
        clip = float(np.float32(norm))
        hp = OptimizerStep("adam", 1e-3, clip, 0.9, 0.999, 1e-8, 0.1,
                           1e-3)
        ref = [p.clone() for p in state.params]
        clip_adam_plain(ref, grads, [torch.zeros_like(p) for p in ref],
                        [torch.zeros_like(p) for p in ref], hp)
        candidates = []
        for scale in (1.0, clip / norm):  # the gradient kept, or clipped
            alt = [p.clone() for p in state.params]
            clip_adam_plain(alt, [x * scale for x in grads],
                            [torch.zeros_like(p) for p in alt],
                            [torch.zeros_like(p) for p in alt],
                            dataclasses.replace(hp, grad_clip=None))
            candidates.append(alt)
        clip_adam(state, grads, hp)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(state.params, ref)):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-6 * float(b.abs().max()))
            assert any(torch.allclose(a, c[i], rtol=0,
                                      atol=1e-6 * float(c[i].abs().max()))
                       for c in candidates)


@pytest.mark.parametrize("rule", ["adam", "rmsprop", "rmsprop_momentum"])
def test_clip_adam_one_launch_repeatable_at_every_cluster(cuda, rule):
    """K19 over 4 steps at the clip tie (grad_clip the float32 of the
    float64 norm) and with the clip firing, on the test leaves and on
    Ape-X DQN-sized ones (24 -> 256 heads: more than one CTA by default),
    at 1 to 4 CTAs (forced) and the plan's own count: params, mu and nu
    bit-equal across the cluster sizes and across two runs (the norm's
    order of sums does not depend on the CTAs), within 1e-6 of each leaf's
    largest magnitude of the plain optimiser; one launch a step."""
    from ddls_tpu_torch.rl.learner import (OptimizerStep, TrainState,
                                           clip_adam, clip_adam_plain)

    def leaves(big):
        state, g = _opt_state(cuda, rule, seed=3)
        if big:
            shapes = [(256, 24), (256,), (17, 256), (17,), (256, 24),
                      (256,), (1, 256), (1,), (3000,)]
            params = [torch.randn(s, generator=g).to(cuda) for s in shapes]
            state = TrainState(
                names=[str(i) for i in range(len(shapes))], params=params,
                mu=None if rule == "rmsprop" else
                [torch.zeros_like(p) for p in params],
                nu=[torch.zeros_like(p) for p in params])
        return state, g

    for big in (False, True):
        results = {}
        for ctas in (None, 1, 2, 3, 4):
            for attempt in range(2):
                state, g = leaves(big)
                ref_p = [p.clone() for p in state.params]
                ref_mu = (None if state.mu is None
                          else [m.clone() for m in state.mu])
                ref_nu = [v.clone() for v in state.nu]
                for step in range(1, 5):
                    grads = [torch.randn(p.shape, generator=g).to(cuda)
                             for p in state.params]
                    norm = float(np.sqrt(sum(float((x.double() ** 2).sum())
                                             for x in grads)))
                    clip = float(np.float32(norm)) if step % 2 else 0.5
                    hp = (OptimizerStep("adam", 1e-3, clip, 0.9, 0.999,
                                        1e-8, 1 - 0.9 ** step,
                                        1 - 0.999 ** step)
                          if rule == "adam" else
                          OptimizerStep(rule, 1e-3, clip, 0.5, 0.99, 0.1))
                    before = kernels.launch_counts()["clip_adam"]
                    if ctas is None:
                        clip_adam(state, grads, hp)
                    else:
                        with kernels._forcing("clip_adam", ctas):
                            clip_adam(state, grads, hp)
                    assert kernels.launch_counts()["clip_adam"] == before + 1
                    clip_adam_plain(ref_p, grads, ref_mu, ref_nu, hp)
                torch.cuda.synchronize()
                got = [t.clone() for t in
                       state.params + (state.mu or []) + state.nu]
                for a, b in zip(got, ref_p + (ref_mu or []) + ref_nu):
                    torch.testing.assert_close(
                        a, b, rtol=0, atol=1e-6 * float(b.abs().max()))
                results[(ctas, attempt)] = got
        first = results[(None, 0)]
        for key, got in results.items():
            assert all(torch.equal(a, b) for a, b in zip(got, first)), key


def test_minibatch_gather_equals_plain_and_the_host_batch(cuda):
    """K20 on the staged training fixture (8 x 64 samples at the (38, 128)
    bucket): a permutation's minibatch of 128, a minibatch with repeated
    samples, one sample, and the full batch in row order, each equal array
    for array to the plain version and to ``prepare_flat_batch`` of the
    same samples on the host; one launch a call."""
    from ddls_tpu_torch.rl.fixture import load_train_fixture
    from ddls_tpu_torch.models.policy import minibatch_gather_plain
    from ddls_tpu_torch.rl.learner import TRAJ_OBS_KEYS
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    fx = load_train_fixture()
    model, _, _ = load_export(EXPORT_PATH)
    learner = ppo.PPOLearner(model, fx["cfg"])
    staged = learner.stage_traj(fx["traj"], fx["last_values"])
    n = staged.t_len * staged.lanes
    obs = fx["traj"]["obs"]
    rows = {k: np.swapaxes(np.asarray(obs[k]), 0, 1).reshape(
        (n,) + np.shape(obs[k])[2:]) for k in TRAJ_OBS_KEYS}
    rng = np.random.default_rng(5)
    for idx in (rng.permutation(n)[:128], rng.integers(0, n, 128),
                np.array([17]), np.arange(n)):
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(cuda)
        before = kernels.launch_counts()["minibatch_gather"]
        got = learner.minibatch(staged, idx_t)
        assert kernels.launch_counts()["minibatch_gather"] == before + 1
        plain = minibatch_gather_plain(staged.tensors, idx_t,
                                       staged.n_nodes, staged.n_edges)
        sel = {k: v[idx] for k, v in rows.items()}
        sel["node_features"] = sel["node_features"][:, :staged.n_nodes]
        for key in ("edge_features", "edges_src", "edges_dst"):
            sel[key] = sel[key][:, :staged.n_edges]
        host = policy.prepare_flat_batch(sel)
        torch.cuda.synchronize()
        assert set(got) == set(plain) == set(host)
        for key in got:
            assert torch.equal(got[key], plain[key]), key
            assert np.array_equal(got[key].cpu().numpy(), host[key]), key


def _staged_rows(rows, n, e, device):
    """Host rows (the obs keys, [S, ...] at the env's pad) staged at the
    bucket (n, e) as ``Learner.row_arrays`` stages them, without its trim
    to the smallest bucket."""
    from ddls_tpu_torch.rl.learner import pack_to_device

    rows = dict(rows)
    rows["node_features"] = rows["node_features"][:, :n]
    for key in ("edge_features", "edges_src", "edges_dst"):
        rows[key] = rows[key][:, :e]
    structure, node_mask = policy.sample_structure(rows)
    return pack_to_device({
        "node_features": rows["node_features"].astype(np.float32),
        "edge_features": rows["edge_features"].astype(np.float32),
        "graph_features": rows["graph_features"].astype(np.float32),
        "action_mask": rows["action_mask"].astype(np.int32),
        "structure": structure,
        "node_mask": node_mask.astype(np.float32)}, device), rows


@pytest.mark.parametrize("bucket", [(38, 128), (150, 512)])
def test_minibatch_gather_at_every_size_and_both_buckets(cuda, bucket):
    """K20 on the training fixture's 512 samples staged at the update's
    (38, 128) bucket and at the env's (150, 512) pad: one sample, 128 with
    repeats, 512 drawn with repeats (the Ape-X DQN's minibatch), 2 (a
    device-collection step's lanes), the full batch in row order and
    1,500 with repeats: each equal array for array to the plain version
    and to ``prepare_flat_batch`` of the same samples, bitwise across two
    runs, one launch a call."""
    from ddls_tpu_torch.models.policy import minibatch_gather_plain
    from ddls_tpu_torch.rl.fixture import load_train_fixture
    from ddls_tpu_torch.rl.learner import TRAJ_OBS_KEYS

    n, e = bucket
    fx = load_train_fixture()
    obs = fx["traj"]["obs"]
    s_rows = int(np.prod(np.shape(obs["node_split"])[:2]))
    rows = {k: np.swapaxes(np.asarray(obs[k]), 0, 1).reshape(
        (s_rows,) + np.shape(obs[k])[2:]) for k in TRAJ_OBS_KEYS}
    staged, trimmed = _staged_rows(rows, n, e, torch.device(cuda))
    rng = np.random.default_rng(n)
    for idx in (np.array([s_rows - 1]), rng.integers(0, s_rows, 128),
                rng.integers(0, s_rows, 512), rng.integers(0, s_rows, 2),
                np.arange(s_rows), rng.integers(0, s_rows, 1500)):
        idx_t = torch.from_numpy(idx.astype(np.int64)).to(cuda)
        plain = minibatch_gather_plain(staged, idx_t, n, e)
        host = policy.prepare_flat_batch({k: v[idx]
                                          for k, v in trimmed.items()})
        runs = []
        for _ in range(2):
            before = kernels.launch_counts()
            runs.append(policy.minibatch_gather(staged, idx_t, n, e))
            assert _launched_since(before) == {"minibatch_gather": 1}
        torch.cuda.synchronize()
        assert set(runs[0]) == set(plain) == set(host)
        for key in runs[0]:
            what = (bucket, idx.size, key)
            assert torch.equal(runs[0][key], runs[1][key]), what
            assert torch.equal(runs[0][key], plain[key]), what
            assert np.array_equal(runs[0][key].cpu().numpy(), host[key]), \
                what


def test_minibatch_gather_plan_is_the_mirror(cuda):
    """K20's C entry plans (``ddls_minibatch_gather_plan``, the plan it
    launches) as ``policy.minibatch_gather_plan`` does, for 1 to 8,192
    samples at both buckets and other sizes."""
    for m in (1, 2, 127, 128, 256, 257, 512, 1023, 1024, 1025, 4000, 8192):
        for n, e, fn, fe, g, a in ((38, 128, 5, 2, 51, 17),
                                   (150, 512, 5, 2, 51, 17),
                                   (1, 1, 1, 1, 0, 1), (7, 3, 3, 5, 2, 9),
                                   (600, 2048, 16, 8, 64, 64)):
            want = policy.minibatch_gather_plan(m, n, e, fn, fe, g, a)
            got = kernels.query("minibatch_gather",
                                "ddls_minibatch_gather_plan", m, n, e, fn,
                                fe, g, a)
            assert got == want.packed(), (m, n, e)


def test_heads_optimiser_wrappers_reject_what_they_cannot_take(cuda):
    from ddls_tpu_torch.rl.learner import OptimizerStep, clip_adam

    logit_layers, value_layers = _head_layers(cuda, (256, 256, 256))
    x = torch.zeros(4, 24, device=cuda)
    with pytest.raises(ValueError, match="1 to 3 layers"):
        policy.mlp_heads(x, logit_layers, value_layers, "relu")
    logit_layers, value_layers = _head_layers(cuda, (300,))
    with pytest.raises(ValueError, match="outputs"):
        policy.mlp_heads(x, logit_layers, value_layers, "relu")
    logit_layers, value_layers = _head_layers(cuda, (17,))
    with pytest.raises(TypeError, match="float32"):
        policy.mlp_heads(x.double(), logit_layers, value_layers, "relu")
    state, _ = _opt_state(cuda, "adam")
    with pytest.raises(TypeError, match="float32"):
        clip_adam(state, [p.double() for p in state.params],
                  OptimizerStep("adam", 1e-3, None, 0.9, 0.999, 1e-8))
    hp = OptimizerStep("adam", 1e-3, 1.0, 0.9, 0.999, 1e-8)
    grads = [torch.ones_like(p) for p in state.params]
    for ctas in (0, 17):
        with pytest.raises(ValueError, match="CTAs"), \
                kernels._forcing("clip_adam", ctas):
            clip_adam(state, grads, hp)
    # the one C entry checks its plan and leaves itself (a refused launch
    # raises and is not counted)
    import ctypes

    from ddls_tpu_torch.rl import learner as learner_mod

    n = len(state.params)
    opt = learner_mod._optimizer_table(state)
    table = list(opt.table)
    grad_table = (ctypes.c_int64 * n)(*(x.data_ptr() for x in grads))
    for bad in ([*table[:4 * n], 0, n * opt.plan.chunks - 1],  # bounds
                [*table[:3 * n], *[1 << 20] * n, *table[4 * n:]]):  # sizes
        bad_table = (ctypes.c_int64 * len(bad))(*bad)
        before = kernels.launch_counts()["clip_adam"]
        with pytest.raises(RuntimeError, match="clip_adam"):
            kernels.launch("clip_adam", ctypes.addressof(grad_table),
                           ctypes.addressof(bad_table), n, opt.plan.chunks,
                           1, 1, 0, 1.0, 1e-3, 0.9, 0.1, 0.999, 0.001,
                           1e-8, 1.0, 1.0)
        assert kernels.launch_counts()["clip_adam"] == before
    # K18's entry: a grid smaller than its parts
    table, _ = policy._heads_table(x, logit_layers, value_layers, "relu")
    dx = torch.empty_like(x)
    grads = torch.empty(1174, device=cuda)
    partial = torch.empty(4, 1174, device=cuda)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="mlp_heads_bwd"):
        kernels.launch("mlp_heads_bwd", x.data_ptr(), ctypes.addressof(table),
                       torch.zeros(4, 17, device=cuda).data_ptr(),
                       torch.zeros(4, device=cuda).data_ptr(), dx.data_ptr(),
                       grads.data_ptr(), partial.data_ptr(),
                       counter.data_ptr(), 4, 0, 2, 1, 1, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lookahead_equals_plain_on_recorded_lanes(cuda, dtype):
    for name, group in load_lookahead_lanes().items():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                for a in group["args"]]
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        kw = dict(num_workers=group["num_workers"],
                  num_channels=group["num_channels"])
        ticks = torch.empty(args[0].shape[0], dtype=torch.int32,
                            device=cuda)
        got = lookahead_mod.lookahead(*args, ticks=ticks, **kw)
        again = lookahead_mod.lookahead(*args, **kw)
        plain = lookahead_mod.lookahead_plain(*args, **kw)
        for g, a, p in zip(got, again, plain):
            assert torch.equal(g, p), name
            assert torch.equal(g, a), name
        assert torch.equal(ticks, plain[5]), name
        if dtype == torch.float32:
            for g, want in zip(got, group["jax"]):
                np.testing.assert_array_equal(g.cpu().numpy(), want,
                                              err_msg=name)


def test_lookahead_wrapper_rejects_what_it_cannot_take(cuda):
    group = load_lookahead_lanes()["edge"]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in group["args"]]
    kw = dict(num_workers=group["num_workers"],
              num_channels=group["num_channels"])
    bad = list(args)
    bad[2] = bad[2].long()  # op_worker must be int32
    with pytest.raises(TypeError):
        lookahead_mod.lookahead(*bad, **kw)
    bad = list(args)
    bad[0] = bad[0].half()
    with pytest.raises(TypeError):
        lookahead_mod.lookahead(*bad, **kw)
    with pytest.raises(ValueError):
        lookahead_mod.lookahead(*args, num_workers=0, num_channels=1)


def test_lookahead_skip_equals_plain(cuda):
    group = load_lookahead_lanes()["price32"]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in group["args"]]
    kw = dict(num_workers=group["num_workers"],
              num_channels=group["num_channels"])
    lanes = args[0].shape[0]
    skip = (torch.arange(lanes) % 2 == 1).to(cuda)
    ticks = torch.empty(lanes, dtype=torch.int32, device=cuda)
    got = lookahead_mod.lookahead(*args, ticks=ticks, skip=skip, **kw)
    full = lookahead_mod.lookahead(*args, **kw)
    plain = lookahead_mod.lookahead_plain(*args, skip=skip, **kw)
    for g, f, p in zip(got, full, plain):
        assert torch.equal(g, p)
        assert torch.equal(g[~skip], f[~skip])
    assert torch.equal(ticks, plain[5])
    assert not bool(ticks[skip].any())


def test_first_fit_block_equals_plain(cuda):
    rng = np.random.RandomState(3)
    for ramp in ((4, 4, 2), (2, 2, 2), (8, 8, 2)):
        grids = torch.from_numpy(rng.rand(256, *ramp) < 0.7).to(cuda)
        for split in (1, 2, 4, 8, 16):
            shapes = block_shapes_for(factor_pairs(split), ramp)
            shapes += [(split, split, -1), (split, 1, 1)]
            got = first_fit_block(grids, shapes, ramp)
            want = first_fit_block_plain(grids, shapes, ramp)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (ramp, split)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_env_kernels_equal_plain(cuda, dtype):
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture

    fx = load_device_env_fixture()
    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    ek = device_env.episode_kernels(et, device=cuda, dtype=dtype)
    lanes, n_dec = [0, 3], 12
    bank = {name: torch.from_numpy(fx["banks"][name][lanes]).to(
        cuda, want or dtype).contiguous()
        for name, want in device_env.BANK_FIELDS}
    acts = torch.from_numpy(np.stack([fx["actions"][:n_dec]] * 2)).to(
        cuda, torch.int32).contiguous()
    diffs, held, trace = episode_kernel_diffs(ek, bank, acts, n_dec, (0, 5))
    assert diffs == dict.fromkeys(diffs, 0.0), diffs
    assert held == {"allocate_job": n_dec, "price_and_score": n_dec,
                    "lookahead": 2, "episode_step": n_dec}
    if dtype == torch.float32:
        for name in TRACE_NAMES:
            np.testing.assert_array_equal(
                trace[name].cpu().numpy(),
                fx["f32"]["trace"][name][lanes, :n_dec], err_msg=name)


def _memo_surface(cuda, tmp_path):
    """The reference memo test's surface in the port (profiles from the
    port's generator) with the recorded tiny policy and banks."""
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.graphs.synthetic import generate_pipedream_txt_files
    from ddls_tpu_torch.models.convert import params_from_flax
    from ddls_tpu_torch.sim.fixture import (MEMO_TINY_ARCH,
                                            load_device_collect_fixture,
                                            memo_surface_kwargs)

    fx = load_device_collect_fixture()["small"]
    generate_pipedream_txt_files(str(tmp_path), n_cnn=1, n_translation=1,
                                 seed=9, min_ops=4, max_ops=6)
    env = RampJobPartitioningEnvironment(**memo_surface_kwargs(
        str(tmp_path)))
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    ot = device_env.build_obs_tables(env, et)
    model = policy.GNNPolicy(n_actions=5, graph_feature_dim=22,
                             **MEMO_TINY_ARCH)
    model.load_state_dict(params_from_flax(fx["params"], model))
    return fx, et, ot, model.to(cuda).eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_collect_kernels_equal_plain(cuda, dtype, tmp_path):
    """K26, K25's prepare, K27, K28 and K25 with the reset against their
    plain versions on every call of the small surface's first recorded
    segment (24 steps, 2 lanes, episodes ending and resetting), with the
    memo; in float32 the segment is the recorded JAX one."""
    from ddls_tpu_torch.sim.device_memo import MemoConfig
    from ddls_tpu_torch.sim.fixture import segment_kernel_diffs

    fx, et, ot, model = _memo_surface(cuda, tmp_path)
    rec = fx["collects"][0]
    steps = rec["uniforms"].shape[1]
    diffs, held, trace = segment_kernel_diffs(
        et, ot, model, fx["banks"], rec["uniforms"], steps,
        MemoConfig(n_sets=16, n_ways=2), device=cuda, dtype=dtype)
    assert diffs == dict.fromkeys(diffs, 0.0), diffs
    assert held == dict.fromkeys(held, steps)
    assert bool(trace["done"].any())
    if dtype == torch.float32:
        for key in ("action", "reward", "done", "ep_accepted", "ep_blocked",
                    "ep_completed", "ep_arrived", "jtype", "n_occupied",
                    "n_running"):
            np.testing.assert_array_equal(
                trace[key].cpu().numpy(),
                rec["trace"][key].astype(trace[key].cpu().numpy().dtype),
                err_msg=key)


def test_segment_memo_on_equals_off(cuda, tmp_path):
    """The segment with the memo equals it without, bit for bit, over the
    small surface's three recorded segments on the card; the memo
    hits."""
    from ddls_tpu_torch.sim.device_memo import MemoConfig

    fx, et, ot, model = _memo_surface(cuda, tmp_path)
    out = {}
    for memo_cfg in (None, MemoConfig(n_sets=16, n_ways=2)):
        seg = device_env.make_segment_fn(et, ot, model, 24, memo_cfg,
                                         device=cuda)
        state = device_env.segment_init(et, fx["banks"], memo_cfg,
                                        device=cuda)
        out[memo_cfg is None] = [seg(fx["banks"], state,
                                     uniforms=rec["uniforms"])
                                 for rec in fx["collects"]]
    for (on, nf_on), (off, nf_off) in zip(out[False], out[True]):
        for key in off:
            assert torch.equal(on[key], off[key]), key
        for key in nf_off:
            assert torch.equal(nf_on[key], nf_off[key]), key
    assert int(out[False][-1][0]["memo_hits"][:, -1].sum()) > 0


def _priced_surface():
    """env_load32_price_mixed (a job every 80, the price block in the
    observation), reset from seed 0, its tables, and the recordings."""
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
    from ddls_tpu_torch.sim.fixture import load_oracle_fixture

    ck = load_checkpoint_fixture("ppo_price_mixed")
    env = RampJobPartitioningEnvironment(**ck["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    ot = device_env.build_obs_tables(env, et)
    return (et, ot, ck["model"], load_device_env_fixture()["banks"],
            load_oracle_fixture()["full"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_oracle_kernels_equal_plain(cuda, dtype):
    """K23 with the state-lane index, K29 and K30 against their plain
    versions on every call of the first 12 steps of the OracleJCT episode
    of the two recorded shipped banks at full width (72 pricing rows); in
    float32 the steps, the verdicts and the prices are the recorded JAX
    ones."""
    from ddls_tpu_torch.sim.fixture import (ORACLE_TRACE_NAMES,
                                            priced_episode_diffs)

    et, ot, _, banks, rec = _priced_surface()
    lanes = [int(s) for s in rec["seeds"]]
    steps = 12
    bank = {k: v[lanes] for k, v in banks.items()}
    diffs, held, out = priced_episode_diffs(et, ot, bank, steps,
                                            device=cuda, dtype=dtype)
    assert diffs == dict.fromkeys(diffs, 0.0), diffs
    assert held == {"allocate_job_indexed": steps, "price_reduce": steps,
                    "oracle_select": steps, "kernel_obs_prices": 0}
    if dtype == torch.float32:
        for name in ORACLE_TRACE_NAMES:
            np.testing.assert_array_equal(
                out[name].cpu().numpy(),
                rec["oracle"]["trace"][name][:, :steps], err_msg=name)
        for name in ("price_ok", "price_jct"):
            np.testing.assert_array_equal(
                out[name].cpu().numpy(), rec["oracle"][name][:, :steps],
                err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_price_policy_kernels_equal_plain(cuda, dtype):
    """K26 with the price block, K23 (indexed) and K29 against their
    plain versions on every call of the first 8 steps of ppo_price_mixed's
    greedy price-feature episode of bank 0 at full width; in float32 the
    actions and the price block are the recorded JAX ones."""
    from ddls_tpu_torch.sim.fixture import priced_episode_diffs

    et, ot, model, banks, rec = _priced_surface()
    steps = 8
    bank = {k: v[[int(rec["seeds"][0])]] for k, v in banks.items()}
    diffs, held, out = priced_episode_diffs(
        et, ot, bank, steps, model.to(cuda).eval(), device=cuda,
        dtype=dtype)
    assert diffs == dict.fromkeys(diffs, 0.0), diffs
    assert held["kernel_obs_prices"] == steps
    if dtype == torch.float32:
        np.testing.assert_array_equal(out["action"][0].cpu().numpy(),
                                      rec["policy"]["trace"]["action"][
                                          :steps])
        np.testing.assert_array_equal(out["price_block"][0].cpu().numpy(),
                                      rec["policy"]["price_block"][:steps])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_price_kernels_on_their_edge_cases(cuda, dtype):
    """On fuzzed inputs with the edge cases laid out: K30 with no
    placeable degree, every degree acceptable, ties in jct, a jct equal
    to the limit, lanes without a job or a free server; K29 with lanes
    without a job, occupied and free channels, a strided time; K23 with
    a state-lane index that repeats and skips lanes, and without one; K26
    with prices of every verdict, past twice the limit and at zero. Each
    equal to its plain version."""
    from ddls_tpu_torch.sim.fixture import fuzzed_price_lanes

    et, ot, _, _, _ = _priced_surface()
    dev = device_env.device_tables(et, cuda, dtype)
    dobs = device_env.device_obs(ot, dev)
    rng = np.random.RandomState(9)
    state, bank, ok, jct, _ = fuzzed_price_lanes(et, ot, rng)
    lanes, n_deg = ok.shape
    s = {k: torch.from_numpy(v).to(cuda) for k, v in state.items()}
    b = {k: torch.from_numpy(v).to(cuda, want or dtype) for k, v in
         bank.items() for want in [dict(device_env.BANK_FIELDS)[k]]}
    okt = torch.from_numpy(ok).to(cuda)
    jctt = torch.from_numpy(jct).to(cuda, dtype)
    got = device_env.oracle_select(okt, jctt, s, b, dobs)
    want = device_env.oracle_select_plain(okt, jctt, s, b, dobs)
    assert torch.equal(got, want)
    assert got[4] == 0 and got[5] == 0 and got[6] == 0
    # K29: lanes x n_deg rows over a short dep axis, each row's flows
    # inside its configuration's valid prefix (K24 writes none past it)
    m, n_chan = 300, et.n_chan
    rows = lanes * n_deg
    flow = rng.rand(rows, m) < 0.1
    chan_np = rng.randint(0, n_chan, (rows, m))
    s["chan_occ"] = torch.from_numpy(np.where(
        rng.rand(lanes, n_chan) < 0.002, 0, -1).astype(np.int32)).to(cuda)
    flags = [torch.from_numpy(rng.rand(rows) < 0.8).to(cuda)
             for _ in range(3)]
    t4 = torch.from_numpy(rng.uniform(0, 50, (rows, 4))).to(cuda, dtype)
    cfg29 = rng.randint(0, dev.n_cfg, rows)
    flow &= np.arange(m)[None] < et.tables["n_deps"][cfg29][:, None]
    is_flow = torch.from_numpy(flow).to(cuda)
    chan = torch.from_numpy(np.where(flow, chan_np, -1).astype(
        np.int32)).to(cuda)
    prefix = (torch.from_numpy(cfg29.astype(np.int32)).to(cuda),
              dev.t["n_deps"])
    args = (is_flow, chan, flags[0], flags[1], t4[:, 0], flags[2], s, b)
    for g, w in zip(device_env.price_reduce(*args, *prefix),
                    device_env.price_reduce_plain(*args)):
        assert torch.equal(g, w)
    ok29, _ = device_env.price_reduce(*args, *prefix)
    assert not ok29[4].any() and not ok29[5].any() and ok29.any()
    # K23 with and without the state-lane index
    mem = torch.full((lanes, et.n_srv), et.worker_mem, dtype=dtype,
                     device=cuda) * torch.from_numpy(rng.choice(
                         [1.0, 0.5, 0.01], (lanes, et.n_srv))).to(cuda,
                                                                  dtype)
    free = s["srv_job"] < 0
    idx = torch.from_numpy(rng.randint(0, 8, 40).astype(np.int32)).to(cuda)
    cfg = torch.from_numpy(rng.randint(0, dev.n_cfg, 40).astype(
        np.int32)).to(cuda)
    for g, w in zip(device_env.allocate_job(mem, free, cfg, dev, idx),
                    device_env.allocate_job_plain(mem, free, cfg, dev, idx)):
        assert torch.equal(g, w)
    ident = torch.arange(lanes, dtype=torch.int32, device=cuda)
    cfg_all = torch.from_numpy(rng.randint(0, dev.n_cfg, lanes).astype(
        np.int32)).to(cuda)
    for g, w in zip(device_env.allocate_job(mem, free, cfg_all, dev),
                    device_env.allocate_job(mem, free, cfg_all, dev, ident)):
        assert torch.equal(g, w)
    # K26 with prices: verdicts of every kind, jct past twice the limit
    # and at zero
    jct26 = jctt.clone()
    jct26[:, 0] = 0
    fields = (b["type"][:, 0].contiguous(), b["sla_frac"][:, 0].contiguous(),
              b["steps"][:, 0].contiguous(),
              (s["srv_job"] >= 0).sum(1).to(torch.int32),
              torch.from_numpy(rng.randint(0, 9, lanes).astype(
                  np.int32)).to(cuda))
    gf, mask = device_env.kernel_obs(dobs, *fields, prices=(okt, jct26))
    gf_p, mask_p = device_env.kernel_obs_plain(dobs, *fields,
                                               prices=(okt, jct26))
    assert torch.equal(gf, gf_p) and torch.equal(mask, mask_p)
    block = gf[:, -dobs.n_actions:]
    assert (block == 1.0).any() and (block == 0.0).any() and \
        ((block > 0) & (block < 1)).any()


def test_price_wrappers_reject_what_they_cannot_take(cuda):
    et, ot, _, _, _ = _priced_surface()
    dev = device_env.device_tables(et, cuda, torch.float32)
    dobs = device_env.device_obs(ot, dev)
    lanes = 2
    mem = torch.zeros((lanes, et.n_srv), device=cuda)
    free = torch.ones((lanes, et.n_srv), dtype=torch.bool, device=cuda)
    cfg = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="state_lane"):
        device_env.allocate_job(mem, free, cfg, dev)
    fields = (torch.zeros(lanes, dtype=torch.int32, device=cuda),
              torch.ones(lanes, device=cuda), torch.ones(lanes, device=cuda),
              torch.zeros(lanes, dtype=torch.int32, device=cuda),
              torch.zeros(lanes, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="pass prices"):
        device_env.kernel_obs(dobs, *fields)
    bad = (torch.zeros((lanes, 3), dtype=torch.bool, device=cuda),
           torch.zeros((lanes, 3), device=cuda))
    with pytest.raises(ValueError, match="shape"):
        device_env.kernel_obs(dobs, *fields, prices=bad)


# ------------------------------------------------- the failure walk (K25)
def _scenario_env(cuda, path):
    from ddls_tpu_torch import scenarios
    from ddls_tpu_torch.scenarios import conformance

    env = conformance.build_env(scenarios.get_spec(path), "host",
                                device=str(cuda))
    env.reset(seed=0)
    return env


def _lanes(banks, rows, dtype, cuda):
    return {name: torch.from_numpy(np.ascontiguousarray(banks[name][rows]))
            .to(cuda, want or dtype) for name, want in device_env.BANK_FIELDS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scenario_step_equals_plain_on_the_recorded_replay(cuda, dtype):
    from ddls_tpu_torch.sim.fixture import (FULL_SCENARIO_PATH,
                                            load_scenario_fixture,
                                            scenario_episode_diffs)

    full = load_scenario_fixture()["full"]
    et = device_env.build_episode_tables(_scenario_env(cuda,
                                                       FULL_SCENARIO_PATH))
    ek = device_env.episode_kernels(et, device=cuda, dtype=dtype)
    acts = torch.from_numpy(np.stack([full["actions"]] * 2)).to(
        cuda, torch.int32)
    kernels.reset_launch_counts()
    diff, held, trace, branches = scenario_episode_diffs(
        ek, _lanes(full["banks"], [0, 1], dtype, cuda), acts,
        acts.shape[1])
    counts = kernels.launch_counts()
    assert diff == 0 and held == acts.shape[1]
    assert counts["episode_step_scenario"] == held
    assert counts["episode_step"] == 0
    for name in ("preempt_push", "straggle_fit", "straggle_spill"):
        assert branches[name] > 0, branches
    if dtype == torch.float32:
        for name in TRACE_NAMES:
            np.testing.assert_array_equal(trace[name].cpu().numpy(),
                                          full["f32"]["trace"][name],
                                          err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scenario_step_equals_plain_under_fuzzed_scenarios(cuda, seed):
    """The failures spec's 8-server surface with a fuzzed scenario: dense,
    short and long windows of both kinds over the episode, speeds between
    0.5 and 1.5; 8 lanes of sampled banks in float32 and float64, every
    K25 call against its plain version, a preemption's push, a straggler
    that fits and one that spills each taken (and the empty masks of the
    lanes that decide nothing)."""
    import dataclasses

    from ddls_tpu_torch.sim.fixture import scenario_episode_diffs

    env = _scenario_env(cuda, "failures")
    et = device_env.build_episode_tables(env)
    rng = np.random.default_rng(seed)
    W = 48
    edges = np.sort(rng.uniform(0.0, 1.6e4, 2 * W))
    kind = rng.integers(0, 2, W)
    scenario = {
        "speeds": rng.uniform(0.5, 1.5, et.n_srv),
        "t0": edges[0::2], "t1": edges[1::2],
        "rate": np.where(kind == 0, 0.0, 1.0 / rng.uniform(1.1, 4.0, W)),
        "kind": [int(k) for k in kind],
        "res": [int(rng.integers(et.n_srv if k == 0 else et.n_chan))
                for k in kind]}
    et = dataclasses.replace(et, scenario=scenario, on_device={})
    banks = [device_env.sample_job_bank(et, env, 80, s) for s in range(8)]
    banks = {k: np.stack([b[k] for b in banks]) for k in banks[0]}
    actions = np.random.RandomState(seed).choice(
        [0, 1, 2, 4, 6, 8], size=(8, 60)).astype(np.int32)
    taken = dict.fromkeys(("preempt_push", "straggle_fit",
                           "straggle_spill"), 0)
    for dtype in (torch.float32, torch.float64):
        ek = device_env.episode_kernels(et, device=cuda, dtype=dtype)
        diff, held, _, branches = scenario_episode_diffs(
            ek, _lanes(banks, list(range(8)), dtype, cuda),
            torch.from_numpy(actions).to(cuda), actions.shape[1])
        assert diff == 0 and held == actions.shape[1], dtype
        for name in taken:
            taken[name] += branches[name]
    assert all(v > 0 for v in taken.values()), taken


def _priced_scenario_surface(device):
    """The failures spec's 8-server surface with the price block in the
    observation (native candidate pricing), a 60-job bank from it and
    ``fuzzed_scenario`` over the bank's arrivals in place of the spec's
    four windows."""
    from ddls_tpu_torch import scenarios
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.hardware.topologies import build_topology
    from ddls_tpu_torch.sim.fixture import fuzzed_scenario

    spec = scenarios.failures_spec()
    env = RampJobPartitioningEnvironment(
        **scenarios.env_kwargs(spec), candidate_pricing="native",
        obs_include_candidate_prices=True, device=str(device),
        scenario_runtime=scenarios.build_runtime(
            spec, build_topology(spec.topology)))
    obs = env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    ot = device_env.build_obs_tables(env, et)
    bank = device_env.sample_job_bank(et, env, 60, 3)
    arr = bank["arrival_t"]
    et = dataclasses.replace(et, on_device={}, scenario=fuzzed_scenario(
        et, float(arr[np.isfinite(arr)][-1]) + 2000.0))
    return env, obs, et, ot, bank


@pytest.mark.parametrize("priced", ["oracle", "price_policy"])
def test_scenario_step_in_priced_episodes_equals_plain(cuda, priced):
    """The oracle episode and the price-feature policy episode (greedy, a
    seeded random init, its forward in float32 as the kernels take it)
    under a fuzzed scenario in float64: on the card
    they launch K25's scenario mode and never the nominal one; their
    decisions equal the same episode's on the CPU (the plain versions), t
    and jct within rel 1e-9; a replay of the card episode's actions holds
    every K25 call against its plain version, gives the episode's jct and
    accepts bit for bit, and takes the walk's three branches."""
    from ddls_tpu_torch.sim.fixture import (POLICY_ARCH,
                                            scenario_episode_diffs)

    env, obs, et, ot, bank = _priced_scenario_surface(cuda)
    names = ("action", "reward", "accept", "cause", "jct", "t", "has_job")
    if priced == "price_policy":
        names = ("action", "logp", "value") + names[1:]
    runs, counts = {}, None
    for device in ("cpu", cuda):
        if priced == "oracle":
            fn = device_env.make_oracle_episode_fn(et, ot, device=device,
                                                   dtype=torch.float64)
        else:
            torch.manual_seed(7)
            model = policy.GNNPolicy(
                n_actions=env.max_partitions_per_op + 1,
                graph_feature_dim=obs["graph_features"].shape[0],
                **POLICY_ARCH).eval().to(device)
            fn = device_env.make_policy_episode_fn(
                et, ot, model, greedy=True, device=device,
                dtype=torch.float64)
        kernels.reset_launch_counts()
        out = fn(bank)
        counts = kernels.launch_counts()
        runs[device] = {n: x.cpu().numpy() for n, x in zip(names,
                                                           out["trace"])}
    assert counts["episode_step_scenario"] == len(bank["type"]), counts
    assert counts["episode_step"] == 0
    got, want = runs[cuda], runs["cpu"]
    for name in ("action", "reward", "accept", "cause", "has_job"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("t", "jct"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-9,
                                   atol=0, err_msg=name)
    ek = device_env.episode_kernels(et, device=cuda, dtype=torch.float64)
    acts = torch.from_numpy(got["action"][None].astype(np.int32)).to(cuda)
    diff, held, trace, branches = scenario_episode_diffs(
        ek, _lanes({k: v[None] for k, v in bank.items()}, [0],
                   torch.float64, cuda), acts, acts.shape[1])
    assert diff == 0 and held == acts.shape[1]
    np.testing.assert_array_equal(trace["jct"][0].cpu().numpy(), got["jct"])
    np.testing.assert_array_equal(trace["accept"][0].cpu().numpy(),
                                  got["accept"])
    for name in ("preempt_push", "straggle_fit", "straggle_spill"):
        assert branches[name] > 0, branches


def test_c1_bank_equals_plain_and_the_recording(cuda):
    from ddls_tpu_torch.sim.fixture import load_scenario_fixture

    c1 = load_scenario_fixture()["c1"]
    et = device_env.build_episode_tables(_scenario_env(cuda, "canonical"))
    ek = device_env.episode_kernels(et, device=cuda, dtype=torch.float32)
    acts = torch.from_numpy(c1["actions"][None]).to(cuda, torch.int32)
    bank = {k: v[None] for k, v in c1["bank"].items()}
    diffs, held, trace = episode_kernel_diffs(
        ek, _lanes(bank, [0], torch.float32, cuda), acts, acts.shape[1],
        (0, 4))
    assert diffs == dict.fromkeys(diffs, 0.0), diffs
    for name in TRACE_NAMES:
        np.testing.assert_array_equal(trace[name].cpu().numpy(),
                                      c1["f32"]["trace"][name],
                                      err_msg=name)


def test_null_scenario_launches_the_nominal_kernel(cuda):
    """No scenario: K25's nominal instance, as before the failure walk,
    whose float32 trace is the recorded JAX one."""
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture

    fx = load_device_env_fixture()
    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    et = device_env.build_episode_tables(env)
    assert et.scenario is None
    fn = device_env.make_episode_fn(et, device=cuda)
    n_dec = 24
    kernels.reset_launch_counts()
    out = fn({k: v[:2] for k, v in fx["banks"].items()},
             np.stack([fx["actions"][:n_dec]] * 2))
    counts = kernels.launch_counts()
    assert counts["episode_step"] == n_dec
    assert counts["episode_step_scenario"] == 0
    for name, got in zip(TRACE_NAMES, out["trace"]):
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      fx["f32"]["trace"][name][:2, :n_dec],
                                      err_msg=name)


# ------------------------------ K21 and K24 over thread-block clusters
CLUSTER_SIZES = tuple(range(1, kernels.MAX_CLUSTER + 1))


def _shipped_tables():
    from ddls_tpu_torch.envs import RampJobPartitioningEnvironment
    from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture

    env = RampJobPartitioningEnvironment(
        **load_checkpoint_fixture("ppo_price_mixed")["env_config"])
    env.reset(seed=0)
    return device_env.build_episode_tables(env)


def _fuzzed_calls(et, dev, cfg, seed):
    """K24's inputs for the configs ``cfg`` (each valid op on a random
    server, the rest -1) and K21's from K24's plain outputs, with a third
    of the lanes skipped."""
    rng = np.random.RandomState(seed)
    valid = et.tables["op_valid"][cfg]
    ots = np.where(valid, rng.randint(0, et.n_srv, valid.shape), -1)
    cfg_t = torch.from_numpy(np.asarray(cfg, np.int32)).to(dev.device)
    ots_t = torch.from_numpy(ots.astype(np.int32)).to(dev.device)
    skip = torch.from_numpy(rng.rand(len(cfg)) < 1 / 3).to(dev.device)
    return cfg_t, ots_t, skip


def _equal_all_sizes(run, want, what):
    for g in (None,) + CLUSTER_SIZES:
        got = run(g)
        torch.cuda.synchronize()
        for i, (o, w) in enumerate(zip(got, want)):
            same = (o == w) | (torch.isnan(o) & torch.isnan(w)) \
                if o.is_floating_point() else o == w
            assert bool(same.all()), f"{what}: output {i} at cluster {g}"


def _hold_k24_and_k21(dev, cfg, ots, skip, what):
    """K24 and the indexed K21 at every cluster size (and the wrappers'
    own choice) against their plain versions, bit for bit; the per-lane
    K21 on the same inputs gathered at every size too."""
    _equal_all_sizes(lambda g: device_env.price_and_score(ots, cfg, dev, g),
                     device_env.price_and_score_plain(ots, cfg, dev),
                     f"K24 {what}")
    times, is_flow, chan, op_score, dep_score, _ = \
        device_env.price_and_score_plain(ots, cfg, dev)
    kw = dict(num_workers=dev.et.n_srv, num_channels=dev.et.n_chan)
    args = lookahead_mod.gather_indexed(cfg, ots, op_score, times, is_flow,
                                        dep_score, chan, dev.t)
    plain = lookahead_mod.lookahead_plain(*args, skip=skip, **kw)

    def indexed(g):
        ticks = torch.empty(cfg.shape[0], dtype=torch.int32,
                            device=cfg.device)
        return lookahead_mod.lookahead_indexed(
            cfg, ots, op_score, times, is_flow, dep_score, chan, dev.t,
            ticks=ticks, skip=skip, cluster=g, **kw) + (ticks,)

    def per_lane(g):
        ticks = torch.empty(cfg.shape[0], dtype=torch.int32,
                            device=cfg.device)
        return lookahead_mod.lookahead(*args, ticks=ticks, skip=skip,
                                       cluster=g, **kw) + (ticks,)

    _equal_all_sizes(indexed, plain, f"K21 indexed {what}")
    _equal_all_sizes(per_lane, plain, f"K21 {what}")
    assert not bool(plain[5][skip].any())
    return plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes", [1, 2, 8, 72])
def test_cluster_kernels_equal_plain_at_every_size(cuda, dtype, lanes):
    """K24 and both K21 entries at full width (the shipped surface: N 480,
    M 13,072) at every forced cluster size 1-16 and the wrappers' choice,
    on random placements of random configs with skipped lanes, bit for
    bit against their plain versions (tick counts too)."""
    et = _shipped_tables()
    dev = device_env.device_tables(et, device=cuda, dtype=dtype)
    rng = np.random.RandomState(lanes)
    cfg = rng.randint(0, dev.n_cfg, lanes)
    cfg[0] = dev.n_cfg - 1          # the largest config: M = 13,072
    _hold_k24_and_k21(dev, *_fuzzed_calls(et, dev, cfg, lanes),
                      f"{lanes} lanes {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_kernels_equal_plain_on_every_config(cuda, dtype):
    """All 45 configs of the shipped surface, one a lane (m_c from 21 to
    13,072), at every cluster size."""
    et = _shipped_tables()
    dev = device_env.device_tables(et, device=cuda, dtype=dtype)
    cfg = np.arange(dev.n_cfg)
    _hold_k24_and_k21(dev, *_fuzzed_calls(et, dev, cfg, 7),
                      f"every config {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_k24_non_finite_lanes_equal_plain(cuda, dtype):
    """K24 on lanes whose priced times are NaN, +inf or -inf (dep sizes
    and collective messages poisoned in a copy of the tables) at every
    cluster size: a NaN time's rank counts the invalid tail (the
    reference sorts all M slots); finite_ok false. Both K21 entries on
    the same lanes at every cluster size, ticks too: their minima over
    remaining times propagate a NaN as the plain version's (and the
    reference's) do, so a lane whose tick takes a NaN time ends with t
    NaN, not ok, at the tick cap."""
    et = _shipped_tables()
    dev = device_env.DeviceTables(et, cuda, dtype)
    rng = np.random.RandomState(11)
    size = dev.t["dep_size"].clone()
    msg = {k: dev.t[k].clone() for k in ("grp_msg", "sync_msg")}
    for k in range(dev.n_cfg):
        m_c = int(et.tables["n_deps"][k])
        hit = rng.choice(m_c, max(1, m_c // 50), replace=False)
        size[k, hit] = torch.from_numpy(rng.choice(
            [np.nan, np.inf, -np.inf], len(hit))).to(size)
    # NaN collectives: priced NaN on flows (a NaN size is never a flow)
    msg["grp_msg"][::3] = float("nan")
    msg["sync_msg"][1::3] = float("nan")
    clean = {k: dev.t[k] for k in msg}
    cfg = np.arange(dev.n_cfg)
    for poison in ("nan", "inf"):
        dev.t["dep_size"] = size if poison == "nan" else torch.where(
            torch.isnan(size), torch.full_like(size, float("inf")), size)
        dev.t.update(msg if poison == "nan" else clean)
        cfg_t, ots, skip = _fuzzed_calls(et, dev, cfg, 13)
        want = device_env.price_and_score_plain(ots, cfg_t, dev)
        assert not bool(want[5].all())
        bad = torch.isnan(want[0]) if poison == "nan" else \
            torch.isinf(want[0])
        assert bool(bad.any())
        plain = _hold_k24_and_k21(dev, cfg_t, ots, skip,
                                  f"{poison} lanes {dtype}")
        if poison == "nan":
            assert bool(torch.isnan(plain[0]).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_lookahead_equals_plain_on_recorded_lanes(cuda, dtype):
    """The per-lane K21 on every recorded group of lanes at every cluster
    size, bit for bit against its plain version (tick counts too)."""
    for name, group in load_lookahead_lanes().items():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                for a in group["args"]]
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        kw = dict(num_workers=group["num_workers"],
                  num_channels=group["num_channels"])

        def run(g):
            ticks = torch.empty(args[0].shape[0], dtype=torch.int32,
                                device=cuda)
            return lookahead_mod.lookahead(*args, ticks=ticks, cluster=g,
                                           **kw) + (ticks,)

        _equal_all_sizes(run, lookahead_mod.lookahead_plain(*args, **kw),
                         name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_lookahead_equals_plain_on_nan_lanes(cuda, dtype):
    """The per-lane K21 on recorded lanes with NaN remaining times of
    either sign (``nan_lanes``; the CPU tests hold the JAX engine and the
    plain version to the same answers on them) at every cluster size, bit
    for bit against its plain version, NaN for NaN, ticks too."""
    from ddls_tpu_torch.sim.fixture import nan_lanes

    group = nan_lanes()
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in group["args"]]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    kw = dict(num_workers=group["num_workers"],
              num_channels=group["num_channels"])

    def run(g):
        ticks = torch.empty(args[0].shape[0], dtype=torch.int32,
                            device=cuda)
        return lookahead_mod.lookahead(*args, ticks=ticks, cluster=g,
                                       **kw) + (ticks,)

    plain = lookahead_mod.lookahead_plain(*args, **kw)
    assert bool(torch.isnan(plain[0][list(group["lanes"])]).all())
    _equal_all_sizes(run, plain, f"NaN lanes {dtype}")


def test_cluster_wrappers_reject_what_they_cannot_take(cuda):
    et = _shipped_tables()
    dev = device_env.device_tables(et, device=cuda)
    cfg, ots, skip = _fuzzed_calls(et, dev, np.arange(4), 1)
    for g in (0, kernels.MAX_CLUSTER + 1):
        with pytest.raises(ValueError, match="cluster"):
            device_env.price_and_score(ots, cfg, dev, g)
    times, is_flow, chan, op_score, dep_score, _ = \
        device_env.price_and_score(ots, cfg, dev)
    kw = dict(num_workers=et.n_srv, num_channels=et.n_chan)
    with pytest.raises(ValueError, match="cluster"):
        lookahead_mod.lookahead_indexed(cfg, ots, op_score, times, is_flow,
                                        dep_score, chan, dev.t, cluster=17,
                                        **kw)
    with pytest.raises(TypeError):
        lookahead_mod.lookahead_indexed(cfg.long(), ots, op_score, times,
                                        is_flow, dep_score, chan, dev.t,
                                        **kw)
    with pytest.raises(ValueError):
        lookahead_mod.lookahead_indexed(cfg, ots, op_score, times, is_flow,
                                        dep_score, chan[:, :-1], dev.t,
                                        **kw)


# ------------------------------------------- K23 on fuzzed states
@pytest.mark.parametrize("surface", ["shipped", "multi_word"])
@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", [1, 8, 72])
def test_allocate_job_equals_plain_on_fuzzed_states(cuda, rows, dtype,
                                                    indexed, surface):
    """K23 (plain entry and with the state-lane index) bit-equal to its
    plain version, at 1, 8 and 72 rows, float32 and float64, on the
    shipped 32-server surface and on a 64-server ramp (two mask words);
    one launch of the entry a call."""
    from ddls_tpu_torch.sim.fixture import (fuzzed_placements,
                                            multi_word_tables)

    et = _shipped_tables()
    if surface == "multi_word":
        et = multi_word_tables(et)
    dev = device_env.device_tables(et, cuda, dtype)
    placed = 0
    for seed in range(4):
        mem, free, cfg, lane = fuzzed_placements(et, dev, rows, seed,
                                                 indexed)
        before = kernels.launch_counts()
        got = device_env.allocate_job(mem, free, cfg, dev, lane)
        name = "allocate_job_indexed" if indexed else "allocate_job"
        assert _launched_since(before) == {name: 1}
        want = device_env.allocate_job_plain(mem, free, cfg, dev, lane)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        placed += int(got[2].sum())
    assert placed > 0


def _hold_allocate(et, cuda, dtype, indexed, rows=8, seeds=3):
    """K23 (the entry ``indexed`` names) against its plain version on
    fuzzed states of ``et``: every output bit-equal, one launch a call;
    returns the rows placed."""
    from ddls_tpu_torch.sim.fixture import fuzzed_placements

    dev = device_env.device_tables(et, cuda, dtype)
    placed = 0
    for seed in range(seeds):
        mem, free, cfg, lane = fuzzed_placements(et, dev, rows, seed,
                                                 indexed)
        before = kernels.launch_counts()
        got = device_env.allocate_job(mem, free, cfg, dev, lane)
        name = "allocate_job_indexed" if indexed else "allocate_job"
        assert _launched_since(before) == {name: 1}
        want = device_env.allocate_job_plain(mem, free, cfg, dev, lane)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        placed += int(got[2].sum())
    return placed


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_allocate_job_equals_plain_on_wide_surfaces(cuda, wide_et, dtype,
                                                    indexed):
    """K23, both entries, float32 and float64, bit-equal to its plain
    version on 128, 160 and 256 servers at 8 and 72 rows; the C entry's
    plan (``ddls_allocate_job_smem``) is the Python mirror's
    (``device_env.allocate_job_plan``): the shared form up to 160 servers,
    the tables from global memory at 256 (their 355,888 bytes a CTA in
    float32 pass the card's opt-in)."""
    dev = device_env.device_tables(wide_et, cuda, dtype)
    sizes = device_env.allocate_job_sizes(dev)
    is_f64 = dtype == torch.float64
    optin = kernels.cached_query("placement", "ddls_smem_optin")
    plan = device_env.allocate_job_plan(sizes, is_f64, optin)
    assert kernels.query("placement", "ddls_allocate_job_smem", *sizes,
                         int(is_f64), 0) == plan.packed()
    assert device_env.ALLOC_FORMS[plan.form] == (
        "global_tables" if wide_et.n_srv == 256 else "shared")
    placed = sum(_hold_allocate(wide_et, cuda, dtype, indexed, rows)
                 for rows in (8, 72))
    assert placed > 0


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_allocate_job_global_forms_equal_plain(cuda, dtype, indexed):
    """K23's global form forced on the shipped 32-server surface and a
    64-server ramp (two mask words), at 1, 8 and 72 rows: bit-equal to the
    plain version; the C entry reports the forced form."""
    form = 1
    from ddls_tpu_torch.sim.fixture import multi_word_tables

    et = _shipped_tables()
    for tables in (et, multi_word_tables(et)):
        dev = device_env.device_tables(tables, cuda, dtype)
        sizes = device_env.allocate_job_sizes(dev)
        packed = kernels.query("placement", "ddls_allocate_job_smem",
                               *sizes, int(dtype == torch.float64), form)
        assert packed & 3 == form
        with kernels._forcing("allocate_job", form):
            placed = sum(_hold_allocate(tables, cuda, dtype, indexed, rows)
                         for rows in (1, 8, 72))
        assert placed > 0


# ------------------------------------ K25 and K29 on fuzzed states
EPISODE_MODES = ("nominal", "reset", "walk")
# the fuzzed episodes: jobs a bank (each lane ends within the decisions,
# and with the reset starts again), decisions
FUZZ_JOBS, FUZZ_DECISIONS = 12, 24


def _short_banks(et, lanes, dtype, cuda, jobs=FUZZ_JOBS):
    """The recorded shipped banks cut to ``jobs`` jobs (no arrival after
    the last), lane i on bank i % 8."""
    banks = load_device_env_fixture()["banks"]
    rows = [i % 8 for i in range(lanes)]
    out = {k: np.ascontiguousarray(banks[k][rows, :jobs])
           for k in ("type", "steps", "sla_frac")}
    out["arrival_t"] = np.concatenate(
        [banks["arrival_t"][rows, :jobs], np.full((lanes, 1), np.inf)], 1)
    return {name: torch.from_numpy(np.ascontiguousarray(out[name])).to(
        cuda, want or dtype) for name, want in device_env.BANK_FIELDS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lanes", [1, 8, 72])
@pytest.mark.parametrize("mode", EPISODE_MODES)
def test_episode_step_equals_plain_on_fuzzed_states(cuda, mode, lanes,
                                                    dtype):
    """K25 in each mode (the replay's, with the reset, counters and
    fields, with the failure walk under a fuzzed scenario) bit-equal to
    its plain version on every call of fuzzed episodes at full width:
    random actions (0 too) per lane, banks of a few jobs so that lanes
    end (and, with the reset, start again) and decide with no job, and
    lanes forced onto the smallest configuration (21 deps) and the
    largest (13,072); one launch of the mode's entry a call."""
    _hold_fuzzed_episode(_shipped_tables(), cuda, mode, lanes, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", EPISODE_MODES)
@pytest.mark.parametrize("servers_per_rack", [4, 8])
def test_episode_step_equals_plain_with_several_slots_a_lane(
        cuda, servers_per_rack, mode, dtype):
    """The fuzzed episodes of ``test_episode_step_equals_plain_on_fuzzed_
    states`` at 8 lanes on 64 and 128 servers (``wide_episode_tables``),
    where each lane of K25's warp 0 owns K = 2 and 4 slots: bit-equal to
    the plain version, with two running slots in one warp lane's block
    (the in-lane minimum and first free slot) and a running slot past
    lane 0's block; at 128 servers the staged channel occupancy takes
    more than the default 48 KB of shared memory. K25's inputs come from
    the plain placement, pricing and lookahead (``_plain_evaluate``)."""
    from ddls_tpu_torch.sim.fixture import wide_episode_tables

    et = wide_episode_tables(servers_per_rack)
    seen = _hold_fuzzed_episode(et, cuda, mode, 8, dtype,
                                evaluate=_plain_evaluate)
    K = et.n_srv // 32
    assert seen["shared"] > 0 and seen["top"] >= K, seen


# the wide surfaces of the repairs: 128, 160 and 256 servers (ramps of 4 x
# 4 x 8 | 10 | 16; 16,256, 25,440 and 65,280 channels), and the jobs a bank
# their fuzzed episodes take: enough jobs running at once to pass lane
# 0's block of K slots (K = 8 at 256 servers)
WIDE_RACKS = (8, 10, 16)
WIDE_JOBS = {128: FUZZ_JOBS, 160: FUZZ_JOBS, 256: 3 * FUZZ_JOBS}


@pytest.fixture(scope="module", params=WIDE_RACKS,
                ids=[f"{16 * r}srv" for r in WIDE_RACKS])
def wide_et(request):
    from ddls_tpu_torch.sim.fixture import wide_episode_tables

    return wide_episode_tables(request.param)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", EPISODE_MODES)
def test_episode_step_equals_plain_on_wide_surfaces(cuda, wide_et, mode,
                                                    dtype):
    """The fuzzed episodes of ``test_episode_step_equals_plain_on_fuzzed_
    states`` at 8 lanes on 128, 160 and 256 servers, where each lane of
    K25's warp 0 owns K = 4, 5 and 8 slots (register blocks of 4 and 8;
    no raise above 128 slots) and, at 256, the channel occupancy (65,280
    channels) no longer fits shared memory and is read from global memory:
    bit-equal to the plain version in every mode, with two running slots
    in one warp lane's block and a running slot past lane 0's. K25's
    inputs come from the device env's own evaluation: K23 (its tables from
    global memory at 256 servers), K24 and K21."""
    et = wide_et
    seen = _hold_fuzzed_episode(et, cuda, mode, 8, dtype,
                                jobs=WIDE_JOBS[et.n_srv])
    K = -(-et.n_srv // 32)
    assert seen["shared"] > 0 and seen["top"] >= K, seen


@pytest.mark.parametrize("forms", [("occ_global",), ("mask_free",),
                                   ("slot_memory",),
                                   ("occ_global", "mask_free",
                                    "slot_memory")],
                         ids=["occ_global", "mask_free", "slot_memory",
                              "all"])
@pytest.mark.parametrize("mode", EPISODE_MODES)
@pytest.mark.parametrize("servers_per_rack", [2, 4])
def test_episode_step_forms_equal_plain(cuda, servers_per_rack, mode,
                                        forms):
    """K25's forms for the surfaces the shared memory or the registers do
    not hold (the occupancy read from global memory, the commit without
    the channel mask and the walk's per-window channel flags, warp 0's
    slots in the lanes' state past 1,024 slots), forced on the shipped 32-
    and a 64-server surface in float64: bit-equal to the plain version in
    every mode, one launch of the mode's entry a call."""
    from ddls_tpu_torch.sim.fixture import wide_episode_tables

    et = (_shipped_tables() if servers_per_rack == 2
          else wide_episode_tables(servers_per_rack))
    with kernels._forcing("episode_step", forms):
        _hold_fuzzed_episode(et, cuda, mode, 8, torch.float64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lookahead_equals_plain_on_wide_surfaces(cuda, wide_et, dtype):
    """Both K21 entries, with a third of the lanes skipped, at every
    cluster size 1-16 on 8 lanes of random placements of random
    configurations (the largest among them) on 128, 160 and 256 servers,
    bit-equal to the plain version, ticks too: a lane on one CTA cannot
    hold these surfaces' two-row channel table (float64 at 128 servers:
    260 KB) in shared memory, so the table lives in the lane's workspace
    (at 128 servers in float32 the plan keeps it in shared memory). The
    inputs are K24's plain outputs."""
    _hold_wide_k21(wide_et, cuda, dtype, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lookahead_workspace_table_equals_plain(cuda, dtype):
    """K21 with its channel table forced into the workspace on the shipped
    surface (72 lanes of random configurations, the largest among them)
    and on the recorded lanes, at every cluster size, bit-equal to the
    plain version, ticks too."""
    with kernels._forcing("lookahead", True):
        _hold_wide_k21(_shipped_tables(), cuda, dtype, 72)
    for name, group in load_lookahead_lanes().items():
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                for a in group["args"]]
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        kw = dict(num_workers=group["num_workers"],
                  num_channels=group["num_channels"])

        def run(g):
            ticks = torch.empty(args[0].shape[0], dtype=torch.int32,
                                device=cuda)
            with kernels._forcing("lookahead", True):
                return lookahead_mod.lookahead(
                    *args, ticks=ticks, cluster=g, **kw) + (ticks,)

        _equal_all_sizes(run, lookahead_mod.lookahead_plain(*args, **kw),
                         name)


def _hold_wide_k21(et, cuda, dtype, lanes):
    dev = device_env.device_tables(et, device=cuda, dtype=dtype)
    rng = np.random.RandomState(et.n_srv + lanes)
    cfg = rng.randint(0, dev.n_cfg, lanes)
    cfg[0] = int(np.argmax(et.tables["n_deps"]))
    cfg_t, ots, skip = _fuzzed_calls(et, dev, cfg, lanes)
    times, is_flow, chan, op_score, dep_score, _ = \
        device_env.price_and_score_plain(ots, cfg_t, dev)
    kw = dict(num_workers=et.n_srv, num_channels=et.n_chan)
    args = lookahead_mod.gather_indexed(cfg_t, ots, op_score, times,
                                        is_flow, dep_score, chan, dev.t)
    plain = lookahead_mod.lookahead_plain(
        *args, skip=skip, num_workers=et.n_srv, num_channels=et.n_chan)
    assert bool(plain[4][~skip].any())

    def indexed(g):
        ticks = torch.empty(lanes, dtype=torch.int32, device=cuda)
        return lookahead_mod.lookahead_indexed(
            cfg_t, ots, op_score, times, is_flow, dep_score, chan, dev.t,
            ticks=ticks, skip=skip, cluster=g, **kw) + (ticks,)

    def per_lane(g):
        ticks = torch.empty(lanes, dtype=torch.int32, device=cuda)
        return lookahead_mod.lookahead(*args, ticks=ticks, skip=skip,
                                       cluster=g, **kw) + (ticks,)

    _equal_all_sizes(indexed, plain, f"K21 indexed {et.n_srv} servers")
    _equal_all_sizes(per_lane, plain, f"K21 {et.n_srv} servers")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_price_reduce_equals_plain_on_wide_surfaces(cuda, wide_et, dtype):
    """``test_price_reduce_equals_plain_on_fuzzed_rows`` at 72 rows on 128,
    160 and 256 servers (at 256 the 65,280 channels' occupancy does not
    fit shared memory and is read from global memory), K24's outputs from
    its plain version."""
    _hold_price_reduce(wide_et, cuda, 72, dtype, plain_pricing=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", [1, 72])
def test_price_reduce_global_occupancy_equals_plain(cuda, rows, dtype):
    """K29 with the occupancy read from global memory (forced) on the
    shipped surface, bit-equal to its plain version."""
    with kernels._forcing("price_reduce", True):
        _hold_price_reduce(_shipped_tables(), cuda, rows, dtype)


def test_wide_surfaces_place_and_price_or_say_why(cuda, wide_et):
    """K23 and K24 on the wide surfaces at 8 lanes, each bit-equal to its
    plain version: K23 places on every one of them (its tables from global
    memory where they do not fit shared memory; no wrapper refuses a
    surface any more)."""
    dev = device_env.device_tables(wide_et, cuda, torch.float32)
    from ddls_tpu_torch.sim.fixture import fuzzed_placements

    mem, free, cfg, _ = fuzzed_placements(wide_et, dev, 8, 0, False)
    got = device_env.allocate_job(mem, free, cfg, dev)
    want = device_env.allocate_job_plain(mem, free, cfg, dev)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    rng = np.random.RandomState(3)
    cfg_t, ots, _ = _fuzzed_calls(wide_et, dev, rng.randint(
        0, dev.n_cfg, 8), 3)
    got = device_env.price_and_score(ots, cfg_t, dev)
    want = device_env.price_and_score_plain(ots, cfg_t, dev)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        same = (g == w) | (torch.isnan(g) & torch.isnan(w)) \
            if g.is_floating_point() else g == w
        assert bool(same.all()), i


def _plain_evaluate(ek, state):
    """``EpisodeKernels.evaluate`` (no memo) through the plain versions of
    K23, K24 and K21, on the state's device."""
    from ddls_tpu_torch.sim import lookahead as lookahead_mod

    dev, cfg = ek.dev, state["cfg"]
    ots, new_mem, ok_place = device_env.allocate_job_plain(
        state["mem"], state["srv_job"] < 0, cfg, dev)
    times, is_flow, chan, op_score, dep_score, finite_ok = \
        device_env.price_and_score_plain(ots, cfg, dev)
    t_step, _, _, _, ok_la, ticks = lookahead_mod.lookahead_plain(
        *lookahead_mod.gather_indexed(cfg, ots, op_score, times, is_flow,
                                      dep_score, chan, dev.t),
        num_workers=dev.et.n_srv, num_channels=dev.et.n_chan,
        skip=~state["active"])
    return {"ots": ots, "new_mem": new_mem, "ok_place": ok_place,
            "times": times, "is_flow": is_flow, "chan": chan,
            "op_score": op_score, "dep_score": dep_score,
            "finite_ok": finite_ok, "t_step": t_step, "ok_la": ok_la,
            "ticks": ticks}


def _hold_fuzzed_episode(et, cuda, mode, lanes, dtype, evaluate=None,
                         jobs=FUZZ_JOBS):
    """The body of ``test_episode_step_equals_plain_on_fuzzed_states`` on
    the surface ``et``, K25's inputs from ``evaluate(ek, state)`` (default
    ``ek.evaluate``, the kernels), banks of ``jobs`` jobs over twice as
    many decisions. Returns what the episodes
    reached: the
    counts of forced small and large deciding lanes, lanes without a job,
    ended lanes, lane-decisions with two running slots in one block of
    warp 0's lanes (``shared``) and the highest running slot (``top``)."""
    from ddls_tpu_torch.sim.fixture import fuzzed_scenario, max_difference

    if mode == "walk":
        et = dataclasses.replace(et, on_device={},
                                 scenario=fuzzed_scenario(et, 3000.0))
    ek = device_env.episode_kernels(et, device=cuda, dtype=dtype)
    dev = ek.dev
    n_deps = et.tables["n_deps"]
    small, large = int(np.argmin(n_deps)), int(np.argmax(n_deps))
    rng = np.random.RandomState(lanes)
    bank = _short_banks(et, lanes, dtype, cuda, jobs)
    D = FUZZ_DECISIONS * jobs // FUZZ_JOBS
    acts = torch.from_numpy(rng.choice([0, 1, 2, 4, 8, 16], (
        lanes, D)).astype(np.int32)).to(cuda)
    reset = mode == "reset"
    name = "episode_step_scenario" if mode == "walk" else "episode_step"
    kw = dict(device=cuda)
    trace = {n: torch.zeros((lanes, D), dtype=want or dtype, **kw)
             for n, want in device_env.TRACE_FIELDS}
    seg = ({n: torch.zeros((lanes, D), dtype=want or dtype, **kw)
            for n, want in device_env.SEGMENT_TRACE_FIELDS}
           if reset else None)
    fields = ({n: torch.zeros((lanes, D + 1), dtype=want or dtype, **kw)
               for n, want in device_env.OBS_FIELDS} if reset else None)
    state = ek.init_state(bank, None if reset else acts)
    seen = dict(small=0, large=0, no_job=0, ended=0, shared=0, top=-1)
    K = -(-ek.R // 32)
    for d in range(D):
        if reset:
            ek.prepare(state, bank, acts[:, d])
        forced = (small, large) if lanes > 1 else ((small,) if d % 2 == 0
                                                   else (large,))
        for lane, c in enumerate(forced):
            state["cfg"][lane] = c
        has_job = (state["queue_row"] >= 0) & ~state["done"]
        seen["small"] += int(has_job[0]) if forced[0] == small else 0
        seen["large"] += int(has_job[len(forced) - 1]) \
            if forced[-1] == large else 0
        seen["no_job"] += int((~has_job).sum())
        running = state["slot_valid"].cpu().numpy()
        for lane_slots in running:
            idx = np.flatnonzero(lane_slots)
            if len(idx):
                seen["shared"] += int(np.bincount(idx // K).max() >= 2)
                seen["top"] = max(seen["top"], int(idx.max()))
        raw = ek.evaluate(state) if evaluate is None else evaluate(ek, state)

        def clone(x):
            return None if x is None else {k: v.clone() for k, v in
                                           x.items()}

        s2, t2, g2, f2 = clone(state), clone(trace), clone(seg), \
            clone(fields)
        before = kernels.launch_counts()[name]
        device_env.episode_step(ek, state, bank, None if reset else acts,
                                raw, trace, d, seg_trace=seg,
                                fields=fields, reset=reset)
        assert kernels.launch_counts()[name] == before + 1
        device_env.episode_step_plain(ek, s2, bank, None if reset else acts,
                                      raw, t2, d, seg_trace=g2, fields=f2,
                                      reset=reset)
        torch.cuda.synchronize()
        pairs = [(state[k], s2[k]) for k in state] + \
            [(trace[k], t2[k]) for k in trace]
        if reset:
            pairs += [(seg[k], g2[k]) for k in seg] + \
                [(fields[k], f2[k]) for k in fields]
            seen["ended"] += int(seg["done"][:, d].sum())
        for i, (g, w) in enumerate(pairs):
            assert max_difference(g, w) == 0, (mode, d, i)
    assert seen["small"] and seen["large"], seen
    # with the reset an ended lane decides its next episode's first job
    assert seen["ended"] > 0 if reset else seen["no_job"] > 0, seen
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rows", [1, 8, 72])
def test_price_reduce_equals_plain_on_fuzzed_rows(cuda, rows, dtype):
    """K29 bit-equal to its plain version at 1, 8 and 72 rows on K24's
    outputs for random placements of random configurations (the smallest
    and the largest among them), each row's prefix only read: lanes
    without a job or whose episode ended, rows with ok_place, ok_la or
    finite_ok false, occupied channels that fail a row, a strided time;
    one launch a call."""
    _hold_price_reduce(_shipped_tables(), cuda, rows, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_price_reduce_equals_plain_on_128_servers(cuda, dtype):
    """``test_price_reduce_equals_plain_on_fuzzed_rows`` at 72 rows on 128
    servers (``wide_episode_tables(8)``: 16,256 channels, whose staged
    occupancy takes more than the default 48 KB of shared memory)."""
    from ddls_tpu_torch.sim.fixture import wide_episode_tables

    et = wide_episode_tables(8)
    assert et.n_chan * 4 > 48 * 1024
    _hold_price_reduce(et, cuda, 72, dtype)


def _hold_price_reduce(et, cuda, rows, dtype, plain_pricing=False):
    """The body of ``test_price_reduce_equals_plain_on_fuzzed_rows`` on the
    surface ``et``, K24's outputs from its plain version with
    ``plain_pricing``."""
    dev = device_env.device_tables(et, cuda, dtype)
    lanes = 8 if rows == 72 else 1
    rng = np.random.RandomState(rows)
    n_deps = et.tables["n_deps"]
    cfg = rng.randint(0, dev.n_cfg, rows)
    cfg[0] = int(np.argmax(n_deps))
    cfg[-1] = int(np.argmin(n_deps))
    cfg_t, ots, _ = _fuzzed_calls(et, dev, cfg, rows)
    _, is_flow, chan, _, _, finite_ok = (
        device_env.price_and_score_plain if plain_pricing
        else device_env.price_and_score)(ots, cfg_t, dev)
    n_deg = rows // lanes
    occ = np.full((lanes, et.n_chan), -1, np.int32)
    occ[rng.rand(lanes, et.n_chan) < 0.01] = 3
    flow_np, chan_np = is_flow.cpu().numpy(), chan.cpu().numpy()
    for lane in range(0, lanes, 2):
        # occupy one flow's channel of the lane's first row
        r = lane * n_deg
        if flow_np[r].any():
            occ[lane, chan_np[r][flow_np[r]][0]] = 1
    J = 4
    state = {"chan_occ": torch.from_numpy(occ).to(cuda),
             "queue_row": torch.from_numpy(rng.randint(0, J, lanes).astype(
                 np.int32)).to(cuda),
             "done": torch.zeros(lanes, dtype=torch.bool, device=cuda)}
    if lanes > 1:
        state["queue_row"][5] = -1
        state["done"][6] = True
    bank = {"steps": torch.from_numpy(rng.choice([10.0, 20.0, 37.0], (
        lanes, J))).to(cuda, dtype)}
    ok_place = torch.from_numpy(rng.rand(rows) < 0.8).to(cuda)
    ok_la = torch.from_numpy(rng.rand(rows) < 0.9).to(cuda)
    t4 = torch.from_numpy(rng.uniform(0, 50, (rows, 4))).to(cuda, dtype)
    args = (is_flow, chan, ok_place, finite_ok, t4[:, 1], ok_la, state,
            bank)
    before = kernels.launch_counts()["price_reduce"]
    got = device_env.price_reduce(*args, cfg_t, dev.t["n_deps"])
    assert kernels.launch_counts()["price_reduce"] == before + 1
    want = device_env.price_reduce_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if rows == 72:
        ok = got[0].reshape(-1)
        may = ok_place & ok_la & finite_ok
        has_job = ((state["queue_row"] >= 0) & ~state["done"]
                   ).repeat_interleave(n_deg)
        assert bool(ok.any())
        assert bool((may & has_job & ~ok).any())   # a channel failed it
        assert bool((~may & has_job).any()) and bool((~has_job).any())
