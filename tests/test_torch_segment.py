"""The port's segment reductions (ddls_tpu_torch/ops/segment.py) against
the JAX package's (ddls_tpu/ops/segment.py), on the CPU.

The same numpy inputs, made from a seed, go through both. The plain
PyTorch functions must agree with JAX at atol 1e-6 (f32 sums of [0, 1]
data in a possibly different order). The two kernel wrappers take their
plain versions here (the tensors lie on the CPU) and must agree with the
JAX composition they replace: K2 (``csr_segment_mean`` over ``build_csr``)
with ``masked_segment_mean(..., extra) * node_mask``, K3
(``masked_mean_pool_concat``) with the vmapped ``masked_mean`` plus the
concat. The cases include nodes with no in-edges, padded edges pointing at
node 0, and a graph with zero real nodes.

The backward kernels' plain versions (K6: ``csr_segment_mean_bwd``,
``csr_segment_sum``, ``masked_mean_pool_concat_bwd``) are held against
torch autograd of the plain forward in float64 (atol 1e-12: the same
arithmetic, sums possibly reordered) and against ``jax.vjp`` of the JAX
composition in float32 (atol 1e-6, as above).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddls_tpu.ops import segment as jseg
from ddls_tpu_torch import kernels
from ddls_tpu_torch.ops import segment as tseg

ATOL = 1e-6


def _graph(rng, n_nodes, n_edges, n_real_nodes, n_real_edges, f):
    """Padded edge list: real edges among the real nodes, padded edges
    pointing at node 0, as the encoder pads them."""
    src = np.zeros(n_edges, np.int32)
    dst = np.zeros(n_edges, np.int32)
    if n_real_nodes:
        src[:n_real_edges] = rng.integers(0, n_real_nodes, n_real_edges)
        dst[:n_real_edges] = rng.integers(0, n_real_nodes, n_real_edges)
    edge_mask = np.arange(n_edges) < n_real_edges
    node_mask = np.arange(n_nodes) < n_real_nodes
    data = rng.uniform(0, 1, (n_edges, f)).astype(np.float32)
    extra = rng.uniform(0, 1, (n_nodes, f)).astype(np.float32)
    return src, dst, edge_mask, node_mask, data, extra


CASES = [  # (n_nodes, n_edges, real nodes, real edges, f)
    (12, 20, 9, 14, 5),
    (30, 64, 30, 64, 16),
    (16, 24, 10, 0, 3),     # no edges at all: every node has no in-edge
    (8, 12, 0, 0, 4),       # a graph with zero real nodes
]


@pytest.mark.parametrize("case", CASES)
def test_masked_segment_sum_and_mean_match_jax(case):
    rng = np.random.default_rng(sum(case))
    _, dst, edge_mask, _, data, extra = _graph(rng, *case)
    n = case[0]
    t = torch.from_numpy
    got_sum = tseg.masked_segment_sum(t(data), t(dst), t(edge_mask), n)
    ref_sum = jseg.masked_segment_sum(jnp.asarray(data), jnp.asarray(dst),
                                      jnp.asarray(edge_mask), n)
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(ref_sum),
                               atol=ATOL)
    for ex in (None, extra):
        got = tseg.masked_segment_mean(
            t(data), t(dst), t(edge_mask), n,
            extra=None if ex is None else t(ex))
        ref = jseg.masked_segment_mean(
            jnp.asarray(data), jnp.asarray(dst), jnp.asarray(edge_mask), n,
            extra=None if ex is None else jnp.asarray(ex))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("n_real", [0, 1, 7, 12])
def test_masked_mean_matches_jax(n_real):
    rng = np.random.default_rng(n_real)
    data = rng.uniform(0, 1, (12, 6)).astype(np.float32)
    mask = np.arange(12) < n_real
    got = tseg.masked_mean(torch.from_numpy(data), torch.from_numpy(mask))
    ref = jseg.masked_mean(jnp.asarray(data), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_build_csr_sorts_stably_and_drops_masked_edges():
    dst = np.array([2, 0, 2, 1, 0, 0, 3], np.int32)
    mask = np.array([1, 1, 1, 1, 0, 1, 0], bool)
    row_ptr, col = tseg.build_csr(dst, mask, 5)
    assert row_ptr.dtype == np.int32 and col.dtype == np.int32
    np.testing.assert_array_equal(row_ptr, [0, 2, 3, 5, 5, 5])
    # node 0: edges 1, 5 (edge 4 is masked); node 1: 3; node 2: 0, 2
    np.testing.assert_array_equal(col[:5], [1, 5, 3, 0, 2])
    np.testing.assert_array_equal(col[5:], 0)
    assert col.shape == dst.shape
    # a masked edge may point anywhere; a real one may not
    tseg.build_csr(np.array([0, 99]), np.array([True, False]), 2)
    with pytest.raises(ValueError, match="destinations"):
        tseg.build_csr(np.array([0, 2]), np.array([True, True]), 2)
    with pytest.raises(ValueError, match="shape"):
        tseg.build_csr(np.array([0, 1]), np.array([True]), 2)


@pytest.mark.parametrize("case", CASES)
def test_csr_segment_mean_matches_jax_segment_mean(case):
    """K2's contract: the CSR mean over {self} U in-edges, times the node
    mask, equals the reference's masked_segment_mean(extra) * mask."""
    rng = np.random.default_rng(100 + sum(case))
    _, dst, edge_mask, node_mask, data, extra = _graph(rng, *case)
    n = case[0]
    row_ptr, col = tseg.build_csr(dst, edge_mask, n)
    before = kernels.launch_counts()
    t = torch.from_numpy
    got = tseg.csr_segment_mean(t(data), t(extra), t(row_ptr), t(col),
                                t(node_mask.astype(np.float32)))
    ref = jseg.masked_segment_mean(
        jnp.asarray(data), jnp.asarray(dst), jnp.asarray(edge_mask), n,
        extra=jnp.asarray(extra)) * jnp.asarray(node_mask)[:, None]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # masked nodes come out exactly zero; CPU tensors launch nothing
    assert np.all(got.numpy()[~node_mask] == 0.0)
    assert kernels.launch_counts() == before


def test_csr_segment_mean_is_batch_invariant():
    """A node's result depends only on its own edges: the same graph in
    another slot of a flattened batch gives the same bits."""
    rng = np.random.default_rng(7)
    src, dst, edge_mask, node_mask, data, extra = _graph(rng, 10, 16, 8,
                                                         13, 4)
    row_ptr, col = tseg.build_csr(dst, edge_mask, 10)
    t = torch.from_numpy
    alone = tseg.csr_segment_mean(t(data), t(extra), t(row_ptr), t(col),
                                  t(node_mask.astype(np.float32)))
    other = _graph(np.random.default_rng(8), 10, 16, 10, 16, 4)
    dst2 = np.concatenate([other[1], dst + 10])
    mask2 = np.concatenate([other[2], edge_mask])
    row_ptr2, col2 = tseg.build_csr(dst2, mask2, 20)
    both = tseg.csr_segment_mean(
        t(np.concatenate([other[4], data])),
        t(np.concatenate([other[5], extra])), t(row_ptr2), t(col2),
        t(np.concatenate([other[3], node_mask]).astype(np.float32)))
    np.testing.assert_array_equal(both.numpy()[10:], alone.numpy())


@pytest.mark.parametrize("n_real", [[5, 0, 9, 1], [9, 9, 9, 9]])
def test_masked_mean_pool_concat_matches_vmapped_masked_mean(n_real):
    rng = np.random.default_rng(sum(n_real))
    b, n, f, g = len(n_real), 9, 6, 3
    emb = rng.uniform(-1, 1, (b, n, f)).astype(np.float32)
    mask = np.arange(n) < np.asarray(n_real)[:, None]
    graph_emb = rng.uniform(-1, 1, (b, g)).astype(np.float32)
    got = tseg.masked_mean_pool_concat(
        torch.from_numpy(emb), torch.from_numpy(mask.astype(np.float32)),
        torch.from_numpy(graph_emb))
    pooled = jax.vmap(jseg.masked_mean)(jnp.asarray(emb), jnp.asarray(mask))
    ref = jnp.concatenate([pooled, jnp.asarray(graph_emb)], axis=-1)
    assert got.shape == (b, f + g)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_wrappers_refuse_mixed_devices():
    """A wrapper runs its plain version only when every tensor lies on the
    CPU; anything else must go to the kernel or raise, never quietly
    compute on the host."""
    x = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        kernels.on_cpu(x, torch.zeros(3, 2, device="meta"))
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        tseg.masked_mean_pool_concat(torch.zeros(1, 2, 2, device="meta"),
                                     torch.zeros(1, 2), torch.zeros(1, 1))
    assert kernels.on_cpu(x, None, x)


def _csr_mean_inputs(case, seed):
    rng = np.random.default_rng(seed + sum(case))
    src, dst, edge_mask, node_mask, data, extra = _graph(rng, *case)
    n = case[0]
    row_ptr, col = tseg.build_csr(dst, edge_mask, n)
    edge_dst = np.where(edge_mask, dst, -1).astype(np.int32)
    dout = rng.normal(0, 1, (n, case[4])).astype(np.float32)
    return (src, dst, edge_mask, node_mask, data, extra, row_ptr, col,
            edge_dst, dout)


@pytest.mark.parametrize("case", CASES)
def test_csr_segment_mean_bwd_matches_autograd_and_jax(case):
    """K6 ``csr_segment_mean_bwd``: d_msg is the destination's
    (dOut * mask) / (deg + 1) on a real edge and 0 on a padded one, d_self
    the same per node; equal to autograd of K2's plain version and to the
    VJP of the reference's masked_segment_mean(extra) * node_mask."""
    (_, dst, edge_mask, node_mask, data, extra, row_ptr, col, edge_dst,
     dout) = _csr_mean_inputs(case, 200)
    n = case[0]
    t = torch.from_numpy
    mask_f = node_mask.astype(np.float32)
    d_msg, d_self = tseg.csr_segment_mean_bwd(t(dout), t(row_ptr),
                                              t(edge_dst), t(mask_f))
    assert np.all(d_msg.numpy()[~edge_mask] == 0.0)

    msg = t(data).double().requires_grad_(True)
    self_msg = t(extra).double().requires_grad_(True)
    out = tseg.csr_segment_mean_plain(msg, self_msg, t(row_ptr), t(col),
                                      t(mask_f).double())
    ref_msg, ref_self = torch.autograd.grad(out, (msg, self_msg),
                                            t(dout).double(),
                                            allow_unused=True,
                                            materialize_grads=True)
    d64 = tseg.csr_segment_mean_bwd(t(dout).double(), t(row_ptr),
                                    t(edge_dst), t(mask_f).double())
    np.testing.assert_allclose(d64[0].numpy(), ref_msg.numpy(), atol=1e-12)
    np.testing.assert_allclose(d64[1].numpy(), ref_self.numpy(),
                               atol=1e-12)

    def jax_fn(m, x):
        return jseg.masked_segment_mean(
            m, jnp.asarray(dst), jnp.asarray(edge_mask), n,
            extra=x) * jnp.asarray(node_mask)[:, None]

    _, vjp = jax.vjp(jax_fn, jnp.asarray(data), jnp.asarray(extra))
    j_msg, j_self = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(d_msg.numpy(), np.asarray(j_msg), atol=ATOL)
    np.testing.assert_allclose(d_self.numpy(), np.asarray(j_self),
                               atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_csr_segment_sum_is_the_transpose_of_the_gather(case):
    """K6 ``csr_segment_sum`` along the SOURCE CSR folds per-edge rows into
    their source nodes in ascending edge id, dropping padded edges: the
    gradient of the masked gather ``a[src]`` (the reference's message
    gather), against autograd and jax.vjp."""
    (src, _, edge_mask, _, data, _, _, _, _, _) = _csr_mean_inputs(case,
                                                                   300)
    n, f = case[0], case[4]
    row_ptr, col = tseg.build_csr(src, edge_mask, n)
    t = torch.from_numpy
    got = tseg.csr_segment_sum(t(data), t(row_ptr), t(col))
    assert got.shape == (n, f)

    a = torch.zeros(n, f, dtype=torch.float64, requires_grad=True)
    keep = t(edge_mask.astype(np.float64))[:, None]
    (ref,) = torch.autograd.grad(a[t(src).long()] * keep, a,
                                 t(data).double())
    got64 = tseg.csr_segment_sum(t(data).double(), t(row_ptr), t(col))
    np.testing.assert_allclose(got64.numpy(), ref.numpy(), atol=1e-12)

    _, vjp = jax.vjp(lambda x: jnp.where(jnp.asarray(edge_mask)[:, None],
                                         x[jnp.asarray(src)], 0.0),
                     jnp.zeros((n, f), jnp.float32))
    (j_ref,) = vjp(jnp.asarray(data))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_ref), atol=ATOL)


@pytest.mark.parametrize("n_real", [[5, 0, 9, 1], [9, 9, 9, 9]])
def test_masked_mean_pool_concat_bwd_matches_autograd_and_jax(n_real):
    """K6 ``masked_mean_pool_concat_bwd``: (dPool / count) * mask per node,
    a graph with no real node getting zeros, and the graph-embedding
    columns passed through."""
    rng = np.random.default_rng(400 + sum(n_real))
    b, n, f, g = len(n_real), 9, 6, 3
    emb = rng.uniform(-1, 1, (b, n, f)).astype(np.float32)
    mask = (np.arange(n) < np.asarray(n_real)[:, None]).astype(np.float32)
    graph_emb = rng.uniform(-1, 1, (b, g)).astype(np.float32)
    dout = rng.normal(0, 1, (b, f + g)).astype(np.float32)
    t = torch.from_numpy
    d_emb, d_graph = tseg.masked_mean_pool_concat_bwd(t(dout), t(mask), f)
    assert np.all(d_emb.numpy()[mask == 0] == 0.0)

    e64 = t(emb).double().requires_grad_(True)
    g64 = t(graph_emb).double().requires_grad_(True)
    out = tseg.masked_mean_pool_concat_plain(e64, t(mask).double(), g64)
    ref_emb, ref_graph = torch.autograd.grad(out, (e64, g64),
                                             t(dout).double())
    d64 = tseg.masked_mean_pool_concat_bwd(t(dout).double(),
                                           t(mask).double(), f)
    np.testing.assert_allclose(d64[0].numpy(), ref_emb.numpy(), atol=1e-12)
    np.testing.assert_array_equal(d64[1].numpy(), ref_graph.numpy())

    def jax_fn(x, y):
        pooled = jax.vmap(jseg.masked_mean)(x, jnp.asarray(mask > 0))
        return jnp.concatenate([pooled, y], axis=-1)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(emb), jnp.asarray(graph_emb))
    j_emb, j_graph = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(d_emb.numpy(), np.asarray(j_emb), atol=ATOL)
    np.testing.assert_array_equal(d_graph.numpy(), np.asarray(j_graph))
