"""The launch plans of K2 (``csr_segment_mean``) and K20
(``minibatch_gather``), on the CPU, and the index arithmetic each kernel's
design rests on (the card tests hold each Python plan against its C
entry's query, and the kernels against their plain versions):

(a) K2's plan (``segment.csr_segment_mean_plan``, a mirror of
    ``csr_segment_mean.cu`` ``make_plan``) at widths 1-4,096 over node
    counts 0 to past the update's 4,864: a group of lanes a node is a
    divisor of 32 and its chunks cover the row; a numpy mirror of the
    kernel's index arithmetic writes every (node, float) exactly once, and
    its walk hands out each node's edges in ascending id, each once,
    whatever its degree;
(b) K20's plan (``policy.minibatch_gather_plan``, a mirror of
    ``minibatch_gather.cu`` ``gather_plan``): 4 samples a summing lane in
    flight up to 256, 8 past, warps enough for the sums and the copies;
    and the col layout the kernel writes (sample m's entries below
    (m + 1) E, the zeros at or past the total) is ``prepare_flat_batch``'s
    on the training fixture's samples.
"""
import numpy as np
import pytest

from ddls_tpu_torch.models import policy
from ddls_tpu_torch.ops import segment

# ---------------------------------------------------------------- (a) K2
K2_WIDTHS = (1, 2, 3, 4, 5, 8, 16, 17, 31, 32, 33, 64, 100, 128, 129, 255,
             256, 260, 512, 1024, 1100, 4096)
K2_NODES = (0, 1, 7, 255, 1200, 4864, 21248)


@pytest.mark.parametrize("f", K2_WIDTHS)
def test_k2_plan_covers_the_row_with_a_divisor_of_the_warp(f):
    for n_nodes in K2_NODES:
        plan = segment.csr_segment_mean_plan(f, n_nodes)
        assert 32 % plan.group == 0
        # the least group and chunks that cover the row (8 chunks of a
        # whole warp at most: past that a lane walks the CSR again)
        assert plan.group == min(32, 1 << max(f - 1, 0).bit_length())
        assert plan.chunks in (1, 2, 4, 8)
        assert plan.chunks == 1 or plan.group == 32
        assert plan.group * plan.chunks >= f or plan.chunks == 8
        assert plan.chunks == 1 or plan.group * plan.chunks // 2 < f
        per_cta = segment.MEAN_THREADS // plan.group
        assert plan.blocks * per_cta >= n_nodes
        assert (plan.blocks - 1) * per_cta < n_nodes or n_nodes == 0
        assert plan.blocks == 0 or n_nodes > 0


@pytest.mark.parametrize("f", (1, 3, 5, 16, 17, 64, 128, 260, 1100))
@pytest.mark.parametrize("n_nodes", (1, 33, 1200))
def test_k2_threads_write_every_node_float_once(f, n_nodes):
    """Every thread of the plan's grid, as the kernel's index arithmetic
    takes them: node = block * (128 / G) + thread / G, lane = thread % G,
    floats pass + c G + lane over its passes and chunks."""
    plan = segment.csr_segment_mean_plan(f, n_nodes)
    g, c = plan.group, plan.chunks
    thread = np.arange(plan.blocks * segment.MEAN_THREADS)
    node = (thread // segment.MEAN_THREADS * (segment.MEAN_THREADS // g)
            + thread % segment.MEAN_THREADS // g)
    lane = thread % g
    live = node < n_nodes
    written = np.zeros((n_nodes, f), np.int64)
    for p in range(0, f, g * c):
        for k in range(c):
            u = p + k * g + lane
            ok = live & (u < f)
            np.add.at(written, (node[ok], u[ok]), 1)
    assert (written == 1).all(), (f, n_nodes)


# the plan's (group, chunks): chunks only with a whole warp a node
K2_WALKS = ((1, 1), (2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (32, 2),
            (32, 4), (32, 8))


@pytest.mark.parametrize("group,chunks", K2_WALKS)
def test_k2_walk_hands_out_each_edge_once_in_order(group, chunks):
    """The kernel's walk of a node's CSR slice: windows of kHeld * G
    entries (lane l holds entries o + k G + l), batches of 4 edges (one
    chunk) or 2 (more), edge w of a window taken from lane w % G's entry
    w / G, up to a bound at least the degree (the warp's largest where a
    warp holds one node): every degree 0-100 gives its edges 0, 1, ...,
    deg - 1, each once."""
    batch = 4 if chunks == 1 else 2
    held = max(batch // group, 1)
    window = held * group
    for deg in range(101):
        for span in (deg, deg + 7):
            taken = []
            for o in range(0, span, window):
                entries = {(k, lane): o + k * group + lane
                           for k in range(held) for lane in range(group)}
                for b0 in range(0, window, batch):
                    if o + b0 >= span:
                        break
                    for j in range(batch):
                        w = b0 + j
                        edge = entries[(w // group, w % group)]
                        if o + w < deg:
                            taken.append(edge)
            assert taken == list(range(deg)), (deg, span)


# ---------------------------------------------------------------- (b) K20
# (n, e, fn, fe, g, a): the update's bucket, the env's pad, a tiny and a
# wide graph
K20_SIZES = ((38, 128, 5, 2, 51, 17), (150, 512, 5, 2, 51, 17),
             (1, 1, 1, 1, 0, 1), (600, 2048, 16, 8, 64, 64))
K20_ROWS = (1, 2, 127, 128, 256, 257, 512, 1024, 1025, 4000, 8192)


@pytest.mark.parametrize("m", K20_ROWS)
@pytest.mark.parametrize("sizes", K20_SIZES)
def test_k20_plan_sums_and_copies(sizes, m):
    n, e, fn, fe, g, a = sizes
    words = n * fn + e * fe + g + a + n + 2 * e
    plan = policy.minibatch_gather_plan(m, n, e, fn, fe, g, a)
    assert plan.ahead == (8 if m > 256 else 4)
    assert plan.sum_warps == min(-(-m // (32 * plan.ahead)), 16)
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    copy = plan.threads // 32 - plan.sum_warps
    assert copy >= 1
    # about 4 two-word units a copying thread, unless at the cap
    assert copy * 32 * 8 >= words or plan.threads == 1024
    assert (copy - 1) * 32 * 8 < words
    assert policy.minibatch_gather_plan(128, 38, 128, 5, 2, 51, 17) == \
        policy.GatherPlan(4, 1, 160)
    assert policy.minibatch_gather_plan(512, 38, 128, 5, 2, 51, 17) == \
        policy.GatherPlan(8, 2, 192)


def _fixture_rows():
    from ddls_tpu_torch.rl.fixture import load_train_fixture
    from ddls_tpu_torch.rl.learner import TRAJ_OBS_KEYS

    obs = load_train_fixture()["traj"]["obs"]
    s_rows = int(np.prod(np.shape(obs["node_split"])[:2]))
    rows = {k: np.swapaxes(np.asarray(obs[k]), 0, 1).reshape(
        (s_rows,) + np.shape(obs[k])[2:]) for k in TRAJ_OBS_KEYS}
    rows["node_features"] = rows["node_features"][:, :38]
    for key in ("edge_features", "edges_src", "edges_dst"):
        rows[key] = rows[key][:, :128]
    return rows


@pytest.mark.parametrize("m_total", (1, 2, 128, 512, 1024, 4000))
def test_k20_col_writes_are_the_host_layout(m_total):
    """On the training fixture's samples at the (38, 128) bucket: sample
    m's col entries lie in [start_m, start_m + nnz_m), below (m + 1) E;
    zeros over the part of each CTA's range [m E, (m + 1) E) at or past
    the total, then each sample's entries, give ``prepare_flat_batch``'s
    col and row_ptr arrays, both CSRs."""
    rows = _fixture_rows()
    structure, _ = policy.sample_structure(rows)
    n, e = 38, 128
    rng = np.random.default_rng(m_total)
    idx = rng.integers(0, structure.shape[0], m_total)
    host = policy.prepare_flat_batch({k: v[idx] for k, v in rows.items()})
    for ptr_key, col_key, ptr_at in (
            ("csr_row_ptr", "csr_col", 2 * e),
            ("src_csr_row_ptr", "src_csr_col", 3 * e + n + 1)):
        col_at = ptr_at + n + 1
        local = structure[idx]
        nnz = local[:, ptr_at + n].astype(np.int64)
        start = np.cumsum(nnz) - nnz
        total = int(nnz.sum())
        assert (start + nnz <= (np.arange(m_total) + 1) * e).all()
        col = np.full(m_total * e, -7, np.int64)
        for m in range(m_total):
            col[max(m * e, total):(m + 1) * e] = 0
        row_ptr = np.full(m_total * n + 1, -7, np.int64)
        for m in range(m_total):
            k = nnz[m]
            col[start[m]:start[m] + k] = local[m, col_at:col_at + k] + m * e
            row_ptr[m * n:(m + 1) * n] = local[m, ptr_at:ptr_at + n] \
                + start[m]
        row_ptr[-1] = total
        assert np.array_equal(col, host[col_key]), col_key
        assert np.array_equal(row_ptr, host[ptr_key]), ptr_key
