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
