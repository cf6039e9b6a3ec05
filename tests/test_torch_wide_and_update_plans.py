"""The wide surfaces' event clock, the launch plans of K25, K18 and K19,
and K18's and K19's orders of sums, held on the CPU:

(a) the plain clock's mirror (``test_torch_episode_prefix.Mirror``: K25's
    clock in the kernel's order, warp 0's lanes each owning a block of K
    slots) bit-equal to ``EpisodeKernels.advance`` on plain episodes on
    160 and 256 servers (K = 5 and 8 slots a lane of the warp), in float32
    and float64;
(b) the plans: K25's slots a lane (``device_env.episode_slots_a_lane``),
    K18's tiles, parts and cluster for 0-70,000 rows (every row in exactly
    one tile of one part; ``policy.heads_bwd_plan``) and K19's CTAs and
    job runs for 1-96 leaves (``learner.clip_adam_plan``);
(c) mirrors in float32 of the sums K18 and K19 document (``mlp_heads.cu``,
    ``clip_adam.cu``): K18's 8-row tiles, each part's tiles in order and
    the parts in block order, within tolerance of autograd of the plain
    heads; K19's norm as one warp computes it (lane l holding the block's
    threads l + 32 m, ``tree256``) bit-equal to the 256-thread blocks of
    the earlier three-launch design, and the step within tolerance of
    ``clip_adam_plain``.
"""
import numpy as np
import pytest
import torch

from ddls_tpu_torch.models import policy
from ddls_tpu_torch.rl import learner
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.fixture import wide_episode_tables
from ddls_tpu_torch.sim.lookahead import fma32
# the mirror of K25's clock and the plain episodes it is held on (its
# module holds the 64- and 128-server cases)
from test_torch_episode_prefix import WARP, WIDE_DECISIONS, Mirror, _bank

torch.set_num_threads(1)

DTYPES = (torch.float32, torch.float64)


# ----------------------------------------------------------------- (a)
@pytest.fixture(scope="module", params=[10, 16], ids=["160srv", "256srv"])
def wide(request):
    return wide_episode_tables(request.param)


@pytest.fixture(scope="module")
def replay():
    from ddls_tpu_torch.sim.fixture import load_device_env_fixture

    return load_device_env_fixture()


@pytest.mark.parametrize("dtype", DTYPES)
def test_mirror_is_the_plain_clock_with_five_to_eight_slots_a_lane(
        wide, replay, dtype):
    """On 160 and 256 servers, where each lane of the warp owns K = 5 and 8
    slots (K25's register blocks of 8): the plain episode of two recorded
    banks under random degrees (placement, pricing, the lookahead and the
    decision), each clock held against the mirror; some clock finds two
    running slots in one lane's block, and some slot past lane 0's block
    runs."""
    et = wide
    K = -(-et.n_srv // WARP)
    assert K in (5, 8)
    assert device_env.episode_slots_a_lane(et.n_srv) == 8
    ek = device_env.episode_kernels(et, device="cpu", dtype=dtype)
    bank = _bank(replay["banks"], [0, 1], dtype)
    D = 2 * WIDE_DECISIONS  # enough running jobs to pass lane 0's block
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


# ----------------------------------------------------------------- (b)
def test_k25_slots_a_lane():
    """The least register block of 4, 8, 16, 32 that holds ceil(R / 32)
    slots a lane, for 1 to 2,000 slots; 0 (the memory form) past 1,024
    slots or when asked."""
    for slots in range(1, 2001):
        k = -(-slots // 32)
        ks = device_env.episode_slots_a_lane(slots)
        if slots > 1024:
            assert ks == 0, slots
        else:
            assert ks in device_env.EPISODE_SLOT_BLOCKS and ks >= k, slots
            assert ks == 4 or ks // 2 < k, slots
        assert device_env.episode_slots_a_lane(slots, memory=True) == 0
    assert [device_env.episode_slots_a_lane(r) for r in
            (32, 128, 129, 160, 256, 257, 512, 513, 1024)] == \
        [4, 4, 8, 8, 8, 16, 16, 32, 32]


@pytest.mark.parametrize("rows", [0, 1, 7, 8, 9, 127, 128, 129, 500, 512,
                                  1055, 1056, 1057, 4000, 4096, 8448,
                                  8449, 33333, 70000])
def test_k18_plan_covers_every_row_once(rows):
    """``heads_bwd_plan``: ceil(rows / 8) tiles; min(tiles, 132) parts (at
    least one); part g takes tiles g, g + parts, ...: every row lies in
    exactly one tile of exactly one part, a part takes at most
    ceil(tiles / parts) tiles; one cluster (the least power of two that
    holds the parts) up to 16 parts, 128 rows, else the fewest clusters
    of 8 that hold them (the ticket)."""
    parts, tiles, cluster, clusters = policy.heads_bwd_plan(rows)
    assert tiles == -(-rows // 8)
    assert parts == max(1, min(tiles, 132))
    cover = np.zeros(rows, np.int64)
    for g in range(parts):
        mine = list(range(g, tiles, parts))
        assert len(mine) <= max(1, -(-tiles // parts))
        for t in mine:
            cover[t * 8:min(t * 8 + 8, rows)] += 1
    assert (cover == 1).all()
    if parts <= 16:
        assert clusters == 1 and cluster >= parts
        assert cluster & (cluster - 1) == 0 and cluster < 2 * parts
        assert rows <= 128
    else:
        assert cluster == 8 and clusters == -(-parts // 8) and rows > 128
    assert parts <= cluster * clusters < parts + cluster


def _leaf_sizes(n_leaves, seed):
    rng = np.random.RandomState(seed)
    return [int(x) for x in rng.choice([1, 5, 17, 24, 408, 1023, 1024, 1025,
                                        3000, 6144, 65536],
                                       n_leaves)]


@pytest.mark.parametrize("n_leaves", [1, 2, 9, 36, 95, 96])
@pytest.mark.parametrize("ctas", [None, 1, 3, 16])
def test_k19_plan(n_leaves, ctas):
    """``clip_adam_plan`` for 1-96 leaves: chunks the largest leaf's count
    of 1,024-element chunks; bounds from 0 to L * chunks, non-decreasing,
    one run a CTA; each CTA's elements within one job of its share of the
    total; the default CTAs one per 768 elements (1 to 16); every CTA's
    jobs' offsets and every job's partial within its shared memory."""
    sizes = _leaf_sizes(n_leaves, n_leaves)
    plan = learner.clip_adam_plan(sizes, ctas=ctas)
    chunks = max(1, -(-max(sizes) // 1024))
    assert plan.chunks == chunks
    jobs = learner.job_sizes(sizes, chunks)
    assert len(jobs) == n_leaves * chunks and sum(jobs) == sum(sizes)
    want = ctas or max(1, min(16, -(-sum(sizes) // 768)))
    assert plan.ctas == want and len(plan.bounds) == want + 1
    assert plan.bounds[0] == 0 and plan.bounds[-1] == len(jobs)
    assert all(a <= b for a, b in zip(plan.bounds, plan.bounds[1:]))
    runs = [jobs[a:b] for a, b in zip(plan.bounds, plan.bounds[1:])]
    for r in runs:
        assert sum(r) <= sum(sizes) / want + 1024
    assert max(4 * (len(r) + 1 + len(jobs)) for r in runs) <= \
        learner._OPT_SMEM
    with pytest.raises(ValueError, match="CTAs"):
        learner.clip_adam_plan(sizes, ctas=17)


def test_k19_plan_of_the_shipped_policy():
    """The shipped policy's 5,838 floats: eight CTAs over all its jobs; the
    plan refuses 97 leaves, and jobs whose partials do not fit a CTA's
    shared memory."""
    from ddls_tpu_torch.serve import load_export
    from ddls_tpu_torch.serve.fixture import EXPORT_PATH

    model, _, _ = load_export(EXPORT_PATH)
    sizes = [p.numel() for p in model.parameters()]
    assert sum(sizes) == 5838
    plan = learner.clip_adam_plan(sizes)
    assert plan.ctas == 8
    assert plan.bounds[0] == 0 and plan.bounds[-1] == len(sizes) * plan.chunks
    with pytest.raises(ValueError, match="leaves"):
        learner.clip_adam_plan([1] * 97)
    # 96 leaves of 300 chunks: 28,800 partials, 115,200 bytes, and as many
    # offsets on one CTA
    with pytest.raises(ValueError, match="shared memory"):
        learner.clip_adam_plan([300 * 1024] * 96, ctas=1)


# ----------------------------------------------------------------- (c)
def _dense(h, w, b):
    """K17's and K18's recompute: one fmaf a feature in feature order,
    then the bias (float32)."""
    acc = torch.zeros(h.shape[0], w.shape[0], dtype=torch.float32)
    for k in range(w.shape[1]):
        acc = fma32(h[:, k:k + 1], w[None, :, k], acc)
    return acc + b


def k18_mirror(x, logit_layers, value_layers, dlogits, dvalue):
    """K18's sums (``mlp_heads.cu``) in float32 with relu: per 8-row tile
    (rows past the end zero) the recompute, then per head and layer
    backwards dW (one fmaf a row, rows in order), db (rows in order), d h
    (one fmaf an output, outputs in order, times relu' at z); each part's
    row the sum of its tiles in order; the gradient ((0 + P_0) + P_1) +
    ... in block order; d x = (0 + head 0's d h) + head 1's."""
    rows = x.shape[0]
    parts, tiles, _, _ = policy.heads_bwd_plan(rows)
    heads = [logit_layers, value_layers]
    n_params = sum(w.numel() + b.numel() for layers in heads
                   for w, b in layers)
    part = [None] * parts
    dx = torch.empty_like(x)
    for t in range(tiles):
        g = t % parts
        r0, tr = t * 8, min(8, rows - t * 8)
        xs = torch.zeros(8, x.shape[1])
        xs[:tr] = x[r0:r0 + tr]
        flat, dh0 = [], []
        for h, layers in enumerate(heads):
            hs, zs = [xs], []
            for w, b in layers[:-1]:
                z = _dense(hs[-1], w, b)
                zs.append(z)
                hs.append(torch.maximum(z, torch.zeros(())))
            d = torch.zeros(8, layers[-1][0].shape[0])
            d[:tr] = (dlogits[r0:r0 + tr] if h == 0
                      else dvalue[r0:r0 + tr, None])
            grads = []
            for l in range(len(layers) - 1, -1, -1):
                w, _ = layers[l]
                hin = hs[l]
                dw = torch.zeros_like(w)
                db = torch.zeros(w.shape[0])
                for r in range(8):
                    dw = fma32(d[r][:, None], hin[r][None, :], dw)
                    db = db + d[r]
                dh = torch.zeros(8, w.shape[1])
                for o in range(w.shape[0]):
                    dh = fma32(d[:, o:o + 1], w[o][None, :], dh)
                if l > 0:
                    dh = dh * (zs[l - 1] > 0).to(torch.float32)
                grads[:0] = [dw.reshape(-1), db]
                d = dh
            flat += grads
            dh0.append(d)
        tile_sum = torch.cat(flat)
        part[g] = tile_sum if part[g] is None else part[g] + tile_sum
        dx[r0:r0 + tr] = ((torch.zeros(()) + dh0[0]) + dh0[1])[:tr]
    total = torch.zeros(n_params)
    for p in part:
        total = total + p
    return dx, total


@pytest.mark.parametrize("rows", [1, 7, 8, 33, 128, 129, 1057])
def test_k18_order_of_sums_is_within_tolerance_of_autograd(rows):
    """``k18_mirror`` at the small heads 6 -> 5 -> {3, 1} against autograd
    of the plain heads (``mlp_heads_bwd_plain``) within 7.6e-5 of each
    output's largest magnitude (PERF.md's K18 row), on each side of the
    one-cluster limit (128 rows), the 132-part cap (1,056) and a ragged
    tile; the parts' block order is the gradient's whatever the launch
    (cluster or ticket)."""
    g = torch.Generator().manual_seed(rows)
    heads = []
    for final in (3, 1):
        heads.append([(torch.randn(5, 6, generator=g) / 2,
                       torch.randn(5, generator=g) / 10),
                      (torch.randn(final, 5, generator=g) / 2,
                       torch.randn(final, generator=g) / 10)])
    x = torch.randn(rows, 6, generator=g)
    dlogits = torch.randn(rows, 3, generator=g)
    dvalue = torch.randn(rows, generator=g)
    dx, total = k18_mirror(x, *heads, dlogits, dvalue)
    ref_dx, ref = policy.mlp_heads_bwd_plain(x, *heads, "relu", dlogits,
                                             dvalue)
    ref_total = torch.cat([t.reshape(-1) for t in ref])
    for got, want in ((dx, ref_dx), (total, ref_total)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=7.6e-5 * float(want.abs().max()))


def _tree256(s):
    """The 256-thread block's tree (strides 128, ..., 1) in float32."""
    red = s.astype(np.float32).copy()
    stride = 128
    while stride:
        red[:stride] = red[:stride] + red[stride:2 * stride]
        stride //= 2
    return red[0]


def _warp_tree256(s):
    """``clip_adam.cu`` tree256: lane l holds threads l + 32 m; the first
    three levels among them, then shuffles down by 16, ..., 1."""
    v = s.astype(np.float32).reshape(8, 32)  # v[m][l] = s[l + 32 m]
    r = [v[m] + v[m + 4] for m in range(4)]
    lanes = (r[0] + r[2]) + (r[1] + r[3])
    for d in (16, 8, 4, 2, 1):
        nxt = lanes.copy()
        nxt[:32 - d] = lanes[:32 - d] + lanes[d:]
        lanes = nxt
    return lanes[0]


def k19_norms(grads, chunks):
    """The global norm as the earlier three-launch design summed it and as
    the one launch sums it (one warp a job, one warp the norm):
    ``(earlier, one_launch)``, each the float32 square root. Both take the
    same threads' serial sums (a chunk's thread t: one fmaf an element, t,
    t + 256, ...; the norm's thread t: the partials t, t + 256, ...) and
    differ only in their trees."""
    thread_sums = []
    for g in grads:
        for c in range(chunks):
            part = np.zeros(1024, np.float32)  # zeros add nothing
            chunk = g[c * 1024:(c + 1) * 1024]
            part[:len(chunk)] = chunk
            acc = torch.zeros(256, dtype=torch.float32)
            for k in range(4):
                v = torch.from_numpy(part[256 * k:256 * (k + 1)])
                acc = fma32(v, v, acc)
            thread_sums.append(acc.numpy())
    out = []
    for tree in (_tree256, _warp_tree256):
        flat = np.array([tree(s) for s in thread_sums], np.float32)
        s = np.zeros(256, np.float32)
        for i, v in enumerate(flat):
            s[i % 256] = np.float32(s[i % 256] + v)
        out.append(np.sqrt(tree(s), dtype=np.float32))
    return out


@pytest.mark.parametrize("seed,n_leaves", [(0, 1), (1, 9), (2, 40),
                                           (3, 96)])
def test_k19_norm_keeps_the_earlier_order_and_the_step_is_close(seed,
                                                                n_leaves):
    """K19's norm as one warp sums it equals, bit for bit, the norm of the
    earlier design's 256-thread blocks (its partials' flat order: leaf *
    chunks + chunk, thread t taking partials t, t + 256, ...), over 1 to
    96 leaves (at 40 and 96 leaves more than 256 partials, so threads add
    several); within 1e-6 of the float64 norm; and the clipped adam step
    with that norm (optax's float32 order) within 1e-6 of each leaf's
    largest magnitude of ``clip_adam_plain``."""
    rng = np.random.RandomState(seed)
    sizes = [int(x) for x in rng.choice([1, 17, 300, 1024, 2500],
                                        n_leaves)]
    if n_leaves >= 40:
        sizes[0] = 7 * 1024 + 5  # 8 chunks a leaf: > 256 partials
    grads = [rng.randn(n).astype(np.float32) for n in sizes]
    plan = learner.clip_adam_plan(sizes)
    earlier, one_launch = k19_norms(grads, plan.chunks)
    assert np.float32(earlier).view(np.uint32) == \
        np.float32(one_launch).view(np.uint32)
    exact = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                        for g in grads))
    assert abs(float(one_launch) - exact) <= 1e-6 * exact
    # the step: adam with the clip firing, as the kernel computes it
    hp = learner.OptimizerStep("adam", 1e-3, float(exact) / 2, 0.9, 0.999,
                               1e-8, 0.1, 1e-3)
    f32 = np.float32
    params = [rng.randn(n).astype(np.float32) for n in sizes]
    ref_p = [torch.from_numpy(p.copy()) for p in params]
    ref_mu = [torch.zeros(n) for n in sizes]
    ref_nu = [torch.zeros(n) for n in sizes]
    learner.clip_adam_plain(ref_p, [torch.from_numpy(g) for g in grads],
                            ref_mu, ref_nu, hp)
    norm = f32(one_launch)
    clip = not norm < f32(hp.grad_clip)
    assert clip
    for p, g, want in zip(params, grads, ref_p):
        gc = (g / norm) * f32(hp.grad_clip)
        mu = gc * f32(1 - hp.b1)
        nu = (gc * gc) * f32(1 - hp.b2)
        upd = (mu / f32(hp.bc1)) / (np.sqrt(nu / f32(hp.bc2)) + f32(hp.eps))
        got = p + upd * f32(-hp.lr)
        np.testing.assert_allclose(got, want.numpy(), rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))
