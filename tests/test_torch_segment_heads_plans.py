"""The launch plans of K6 (``segment_bwd``), K17 (``mlp_heads``) and K23
(``allocate_job``), on the CPU, and the placement the repair of K23 opens
against the reference:

(a) K17's row plan (``policy.heads_fwd_plan``) for 0 to 70,000 rows and
    each head shape the wrapper takes: the CTAs' tiles cover every row
    exactly once, serving's batches (up to 8 rows) of the shipped heads
    take one CTA, the update's 128 rows spread over 32;
(b) K6's plans (``segment.segment_bwd_plan``, a mirror of
    ``segment_bwd.cu`` ``make_plan``; the card tests hold it against the C
    entry's) for widths 1-64 and edge and node counts from 0 to the
    update's (16,384 and 4,864): a numpy mirror of each kernel's index
    arithmetic writes every output element exactly once, the vector form
    only where the width is a multiple of 4 and the pointers are 16-byte
    aligned (the CSR sum: a warp a node, by the float); the CSR sum's
    lanes, so mirrored, add each node's edges in ascending id (the plain
    version's bits);
(c) K23's form, by ``device_env.allocate_job_plan`` (a mirror of
    ``placement.cu`` ``alloc_plan``; the card tests hold it against the C
    entry's) on 32-, 64-, 128-, 160- and 256-server surfaces in float32 and
    float64 at the H100's 232,448 bytes: everything in shared memory up
    to 160 servers, the shape tables from global memory at 256;
(d) the port's plain placement (``allocate_job_plain``) bit-equal to the
    reference's ``jax_allocate_job`` on the 256-server surface in float32:
    the surface K23 now takes is one the reference answers.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddls_tpu.envs import RampJobPartitioningEnvironment as JaxEnv
from ddls_tpu.sim import jax_env
from ddls_tpu_torch.models import policy
from ddls_tpu_torch.ops import segment
from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.fixture import (fuzzed_placements,
                                        wide_episode_tables)

torch.set_num_threads(1)

# the H100's shared memory a CTA may opt into
H100_OPTIN = 232448
# the update's minibatch: 128 graphs of the (38, 128) bucket
UPDATE_EDGES, UPDATE_NODES = 128 * 128, 128 * 38


# ------------------------------------------------------------ (a) K17
def _head_params(hiddens, k_in=24, n_actions=17):
    """Weights and biases of both heads (as ``policy._heads_table``
    counts them)."""
    total = 0
    for final in (n_actions, 1):
        widths = [k_in, *hiddens, final]
        total += sum(widths[i] * widths[i + 1] + widths[i + 1]
                     for i in range(len(widths) - 1))
    return total


# the head shapes the wrapper takes: the shipped policy's, none hidden, the
# Ape-X DQN's, the default fcnet_hiddens, the widest input and output
HEAD_SHAPES = {"shipped": ((17,), 24, 17), "linear": ((), 24, 17),
               "dqn": ((256,), 24, 17), "default": ((256, 256), 24, 17),
               "widest": ((256, 256), 64, 64)}


@pytest.mark.parametrize("shape", sorted(HEAD_SHAPES))
def test_heads_fwd_plan_covers_every_row_once(shape):
    hiddens, k_in, n_actions = HEAD_SHAPES[shape]
    n_params = _head_params(hiddens, k_in, n_actions)
    small = n_params <= 4096
    for rows in range(0, 70001):
        tile, ctas = policy.heads_fwd_plan(rows, n_params)
        assert 1 <= tile <= 8
        if rows == 0:
            assert ctas == 0
            continue
        # CTA c takes rows [c * tile, min((c + 1) * tile, rows)): every
        # row once, no CTA empty
        assert (ctas - 1) * tile < rows <= ctas * tile, rows
        if small and rows <= 8:
            assert ctas == 1, rows
        elif small:
            assert tile >= 4, rows
        if rows <= 132 * 8 and not (small and rows <= 132 * 4):
            assert ctas <= 132, rows
        elif rows > 132 * 8:
            assert tile == 8, rows
    if small:
        assert policy.heads_fwd_plan(128, n_params) == (4, 32)
    else:
        assert policy.heads_fwd_plan(128, n_params) == (1, 128)


@pytest.mark.parametrize("tile", [1, 4, 16])
def test_heads_fwd_plan_takes_a_forced_tile(tile):
    from ddls_tpu_torch import kernels

    with kernels._forcing("mlp_heads", tile):
        assert policy.heads_fwd_plan(128, _head_params((17,))) == (
            tile, -(-128 // tile))


# ------------------------------------------------------------- (b) K6
K6_ROWS = (0, 1, 7, 255, 4864, 16384, UPDATE_EDGES + UPDATE_NODES)


def _mean_rows_written(plan, name, f, rows):
    """How often the mean backward's (and the CSR sum's) groups write each
    (row, unit) of a launch of ``plan`` over ``rows`` rows: the kernels'
    index arithmetic, every thread of every CTA."""
    units = f // plan.vec
    threads = segment.SEGMENT_THREADS
    per_block = threads // plan.group
    tid = np.arange(plan.blocks * threads)
    row = (tid // threads) * per_block + (tid % threads) // plan.group
    lane = tid % plan.group
    written = np.zeros((rows, units), np.int64)
    live = row < rows
    for step in range(-(-units // plan.group)):
        unit = lane + step * plan.group
        ok = live & (unit < units)
        np.add.at(written, (row[ok], unit[ok]), 1)
    return written


@pytest.mark.parametrize("f", range(1, 65))
def test_segment_bwd_plan_writes_every_element_once(f):
    for name in ("csr_segment_mean_bwd", "csr_segment_sum"):
        for rows in K6_ROWS:
            for aligned in (True, False):
                plan = segment.segment_bwd_plan(name, f, rows,
                                                aligned=aligned)
                if name == "csr_segment_sum":
                    assert plan[:2] == (1, 32)
                else:
                    assert plan.vec == (4 if f % 4 == 0 and aligned else 1)
                    units = f // plan.vec
                    assert plan.group & (plan.group - 1) == 0
                    assert plan.group == min(32, 1 << max(units - 1, 0)
                                             .bit_length())
                assert (plan.blocks == 0) == (rows == 0)
                if rows <= 4864:
                    assert (_mean_rows_written(plan, name, f, rows)
                            == 1).all()
                else:  # the grid covers the rows, no CTA past them
                    per = segment.SEGMENT_THREADS // plan.group
                    assert (plan.blocks - 1) * per < rows <= plan.blocks * per


def _csr_sum_mirror(g, row_ptr, col, plan):
    """The CSR sum's arithmetic, thread by thread: lane ``lane`` of node
    ``u``'s group adds the unit ``j`` (``vec`` floats) of every edge of the
    node's slice, in order, from 0 (float32, one rounding an add)."""
    n_nodes, f = row_ptr.shape[0] - 1, g.shape[1]
    out = np.full((n_nodes, f), np.nan, np.float32)
    units = f // plan.vec
    threads = segment.SEGMENT_THREADS
    for tid in range(plan.blocks * threads):
        u = (tid // threads) * (threads // plan.group) + \
            (tid % threads) // plan.group
        if u >= n_nodes:
            continue
        for j in range(tid % plan.group, units, plan.group):
            cols = slice(j * plan.vec, (j + 1) * plan.vec)
            acc = np.zeros(plan.vec, np.float32)
            for e in range(row_ptr[u], row_ptr[u + 1]):
                acc = (acc + g[col[e], cols]).astype(np.float32)
            out[u, cols] = acc
    return out


@pytest.mark.parametrize("f", [1, 3, 4, 16, 17, 64])
def test_csr_sum_lanes_add_each_node_in_edge_order(f):
    """The CSR sum's warps, mirrored on a random source CSR (nodes with
    no edge, a node with 40), give the plain version's bits."""
    rng = np.random.default_rng(f)
    n_nodes, n_edges = 37, 160
    src = np.sort(rng.integers(0, n_nodes - 3, n_edges))
    src[-40:] = n_nodes - 4
    mask = rng.uniform(size=n_edges) < 0.9
    row_ptr, col = segment.build_csr(src, mask, n_nodes)
    g = rng.normal(size=(n_edges, f)).astype(np.float32)
    want = segment.csr_segment_sum_plain(
        torch.from_numpy(g), torch.from_numpy(row_ptr),
        torch.from_numpy(col)).numpy()
    plan = segment.segment_bwd_plan("csr_segment_sum", f, n_nodes)
    got = _csr_sum_mirror(g, row_ptr, col, plan)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _pool_written(plan, batch, n_nodes, f):
    """How often the pooling backward writes each (graph, node, unit)."""
    units = f // plan.vec
    warps = plan.group
    per = 32 // units if units <= 32 else 1
    written = np.zeros((batch, n_nodes, units), np.int64)
    threads = segment.SEGMENT_THREADS
    for gw in range(plan.blocks * threads // 32):
        b, w = divmod(gw, warps)
        if b >= batch:
            continue
        for lane in range(32):
            unit0 = lane % units if units <= 32 else lane
            row0 = lane // units if units <= 32 else 0
            if row0 >= per:
                continue
            for u in range(unit0, units, 32):
                for n in range(w * per + row0, n_nodes, warps * per):
                    written[b, n, u] += 1
    return written


@pytest.mark.parametrize("f", [1, 3, 4, 5, 16, 17, 24, 64, 132, 256])
@pytest.mark.parametrize("n_nodes", [1, 5, 38, 150])
def test_pool_bwd_plan_writes_every_element_once(f, n_nodes):
    name = "masked_mean_pool_concat_bwd"
    for batch in (1, 8, 33):
        plan = segment.segment_bwd_plan(name, f, batch, n_nodes)
        assert plan.vec == (4 if f % 4 == 0 else 1)
        assert 1 <= plan.group <= 8
        assert (_pool_written(plan, batch, n_nodes, f) == 1).all()
    assert segment.segment_bwd_plan(name, f, 8, n_nodes,
                                    aligned=False).vec == 1


def test_segment_plans_at_the_update_widths():
    """The update's calls: the mean backward at the node width 64 takes
    groups of 16 lanes; the pooling backward 2 warps a graph of 38 nodes;
    the CSR sum a warp a node."""
    assert segment.segment_bwd_plan(
        "csr_segment_sum", 16, UPDATE_NODES) == (1, 32, 608)
    assert segment.segment_bwd_plan(
        "csr_segment_mean_bwd", 64, UPDATE_EDGES + UPDATE_NODES)[:2] == (
            4, 16)
    assert segment.segment_bwd_plan(
        "masked_mean_pool_concat_bwd", 16, 128, 38) == (4, 2, 32)


# ------------------------------------------------------------ (c) K23
WIDE_RACKS = {32: 2, 64: 4, 128: 8, 160: 10, 256: 16}


@pytest.fixture(scope="module")
def surfaces():
    out = {}
    for n_srv, racks in WIDE_RACKS.items():
        out[n_srv] = wide_episode_tables(racks)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_srv", sorted(WIDE_RACKS))
def test_allocate_job_form_by_surface(surfaces, n_srv, dtype):
    dev = device_env.device_tables(surfaces[n_srv], "cpu", dtype)
    sizes = device_env.allocate_job_sizes(dev)
    is_f64 = dtype == torch.float64
    plan = device_env.allocate_job_plan(sizes, is_f64, H100_OPTIN)
    assert plan.smem <= H100_OPTIN
    if n_srv <= 160:
        assert (device_env.ALLOC_FORMS[plan.form], plan.rows) == (
            "shared", 4)
    else:
        assert (device_env.ALLOC_FORMS[plan.form], plan.rows) == (
            "global_tables", 4)
        # everything staged would need more than the card gives
        assert device_env.alloc_layout_bytes(sizes, is_f64, 0, 1) > \
            H100_OPTIN
    forced = device_env.allocate_job_plan(sizes, is_f64, H100_OPTIN, 1)
    assert (forced.form, forced.rows) == (1, 4)
    assert forced.smem < plan.smem or plan.form == 1
    # rows' parts past the budget: fewer rows a CTA, then none
    one = device_env.alloc_layout_bytes(sizes, is_f64, 1, 1)
    two = device_env.alloc_layout_bytes(sizes, is_f64, 1, 2)
    assert device_env.allocate_job_plan(sizes, is_f64, two).rows == 2
    assert device_env.allocate_job_plan(sizes, is_f64, one).rows == 1
    assert device_env.allocate_job_plan(sizes, is_f64, one - 16) is None


def test_allocate_job_plan_bytes_on_the_shipped_surface(surfaces):
    """The shipped surface's layout as ``placement.cu``'s comment gives
    it: 24.2 KB a CTA in float32, 25.0 KB in float64; the 256-server
    tables as ROADMAP's C3 measured them (355,888 and 360,240 bytes)."""
    for n_srv, want in ((32, (24224, 24992)), (256, (355888, 360240))):
        dev = device_env.device_tables(surfaces[n_srv], "cpu",
                                       torch.float32)
        sizes = device_env.allocate_job_sizes(dev)
        assert tuple(device_env.alloc_layout_bytes(sizes, f64, 0, 4)
                     for f64 in (False, True)) == want


# ------------------------------------------------- (d) the reference
def test_plain_placement_equals_reference_on_256_servers(surfaces):
    """``allocate_job_plain`` on fuzzed states of the 256-server surface
    (the shipped jobs on a 4 x 4 x 16 ramp) against ``jax_allocate_job``
    on the same surface built by the reference's env, float32, bit for
    bit."""
    cfg = copy.deepcopy(load_checkpoint_fixture("ppo_price_mixed")
                        ["env_config"])
    ramp = cfg["topology_config"]["kwargs"]
    ramp["num_servers_per_rack"] = 16
    cfg["node_config"]["type_1"]["num_nodes"] = (
        ramp["num_communication_groups"]
        * ramp["num_racks_per_communication_group"] * 16)
    jenv = JaxEnv(**cfg)
    jenv.reset(seed=0)
    jet = jax_env.build_episode_tables(jenv)
    pet = surfaces[256]
    assert jet.n_srv == pet.n_srv == 256
    dev = device_env.device_tables(pet, "cpu", torch.float32)
    np.testing.assert_array_equal(pet.st.row, np.asarray(jet.st.row))
    mem, other, cfg_rows, _ = fuzzed_placements(pet, dev, 6, 0, False)
    cfg_rows[0] = int(np.argmax(pet.tables["n_deps"]))
    got = device_env.allocate_job_plain(mem, other, cfg_rows, dev)
    alloc = jax.jit(lambda m, o, c: jax_env.jax_allocate_job(
        m, o, c, jet.tables, jet.st, jet.pads))
    placed = 0
    for b in range(cfg_rows.shape[0]):
        want = alloc(jnp.asarray(mem[b].numpy()), jnp.asarray(
            other[b].numpy()), jnp.int32(int(cfg_rows[b])))
        for w, g in zip(want, (got[0][b], got[1][b], got[2][b])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        placed += int(got[2][b])
    assert placed > 0
