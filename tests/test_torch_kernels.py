"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; whether
there is one is decided inside the fixture, never at import or collection,
so every worker of a parallel run collects the same tests.

On a machine with the card (this file imports neither JAX nor the JAX
package, so the repo's JAX conftest is skipped):

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels.py

Tolerance: abs and rel 1e-5 for the forward kernels (float32; the
plain versions repeat the kernels' roundings except in the activations'
transcendental functions). The backward kernels K5–K8 and the IMPALA and
PG update's kernels K10–K12 are held at abs 1e-5 of each output's own
largest magnitude (exactly where that is 0):
their parameter gradients are float32 sums over up to 16,384 rows in
another order than the plain versions' matrix products. K5's plain
version takes relu's kink decisions from K1's output on the same inputs,
as K5, which recomputes K1's pre-activations, does. K2, K4, K5–K8 and K10–K12
are also held bitwise across two runs. The Ape-X DQN and ES kernels: K13
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
banks, whose float32 trace is the recorded JAX one.
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
    after = kernels.launch_counts()
    assert after["ln_linear_act_bwd"] == before["ln_linear_act_bwd"] + 1
    assert (after["ln_linear_act_bwd_reduce"]
            == before["ln_linear_act_bwd_reduce"] + 1)
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


def test_ln_linear_act_bwd_reduce_sums_blocks_in_order(cuda):
    partial = torch.randn(132, 4288, generator=torch.Generator(
        device="cpu").manual_seed(2)).to(cuda)
    out = gnn.ln_linear_act_bwd_reduce(partial)
    torch.cuda.synchronize()
    assert torch.equal(out, gnn.ln_linear_act_bwd_reduce_plain(partial))


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
    # K9 samples rollouts and K10-K16 belong to the other learners: the
    # PPO update never launches them
    assert all(n > 0 for name, n in kernels.launch_counts().items()
               if name not in ("mask_sample_logp", *AC_KERNELS,
                               *DQN_ES_KERNELS))
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


@pytest.mark.parametrize("hiddens,activation", HEAD_CASES)
def test_mlp_heads_bwd_matches_plain_autograd(cuda, hiddens, activation):
    """K18 (through K17's autograd function) against autograd of the plain
    heads: dx and every weight and bias gradient within 1e-5 of its
    largest magnitude, at 128 and 1,000 rows (past K18's 132-block cap);
    bitwise across two runs; one K18 and one reduce launch a backward; a
    head the loss does not reach gets zero gradients."""
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
            assert after["mlp_heads_bwd"] == before["mlp_heads_bwd"] + 1
            assert (after["mlp_heads_bwd_reduce"]
                    == before["mlp_heads_bwd_reduce"] + 1)
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
    largest magnitude; three launches a step with the clip, one without;
    the leaf table built once."""
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
        before = sum(kernels.launch_counts()[k] for k in
                     ("clip_adam_norm", "clip_adam_reduce",
                      "clip_adam_update"))
        clip_adam(state, grads, hp)
        after = sum(kernels.launch_counts()[k] for k in
                    ("clip_adam_norm", "clip_adam_reduce",
                     "clip_adam_update"))
        assert after - before == (1 if clip is None else 3)
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


def test_minibatch_gather_equals_plain_and_the_host_batch(cuda):
    """K20 on the staged training fixture (8 x 64 samples at the (38, 128)
    bucket): a permutation's minibatch of 128, a minibatch with repeated
    samples, one sample, and the full batch in row order, each equal array
    for array to the plain version and to ``prepare_flat_batch`` of the
    same samples on the host; one launch a call."""
    from ddls_tpu_torch.rl.fixture import load_train_fixture
    from ddls_tpu_torch.rl.learner import (TRAJ_OBS_KEYS,
                                           minibatch_gather_plain)
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
