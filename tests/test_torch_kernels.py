"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; whether
there is one is decided inside the fixture, never at import or collection,
so every worker of a parallel run collects the same tests.

On a machine with the card (this file imports neither JAX nor the JAX
package, so the repo's JAX conftest is skipped):

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels.py

Tolerance: abs and rel 1e-5 (float32; the kernels sum in another order
than the plain versions: warp-shuffle trees for the LayerNorm statistics,
fused multiply-adds in the Dense sums). K2 and K4 are also held bitwise
across two runs.
"""
import numpy as np
import pytest
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.models import gnn, policy
from ddls_tpu_torch.ops import segment

pytestmark = pytest.mark.gpu

TOL = 1e-5


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
    assert all(n > 0 for n in kernels.launch_counts().values())
    forward = BucketForward(model, params, 8, device="cuda")
    padded = [server.bucketer.bucket_obs(o)[1] for o in requests[:8]]
    lo, va, ac = forward.forward(padded)
    for k, obs in enumerate(padded):
        lo1, va1, ac1 = forward.forward([obs])
        assert np.array_equal(lo1[0], lo[k]) and va1[0] == va[k]
        assert ac1[0] == ac[k]
