"""K23's occupancy bitmasks and K5's grid, on the CPU.

K23 (``kernels/csrc/placement.cu`` ``allocate_job``) tests an anchor as
``anchor_ok && (anchor_bits & ~free) == 0`` over 32-bit words and stops a
row's scan after its config's ``n_fwd`` valid forward ops. Held here, each
exactly (integers and booleans equal, floats bit for bit):

(a) ``anchor_bits`` and ``anchor_ok`` say what ``anchor_cells`` and
    ``anchor_span`` say, for every (shape, anchor): on the shipped
    32-server surface, the reference episode test's small surface, and a
    64-server ramp whose masks take two words;
(b) a torch mirror of the kernel's first fit (the mask test, positions in
    order, the first set bit) equals ``_first_fit_rows`` (the reference's
    formulation) for every split row on seeded random free masks;
(c) every config's valid forward slots are a prefix of length ``n_fwd``;
(d) a scan cut at each row's ``n_fwd`` (``allocate_job_plain`` over the
    first ``n_fwd`` slots of each config's tables, as K23 loops) equals
    ``allocate_job_plain``'s full scan over all slots, in float32 and
    float64, with and without the state-lane index.

K5 (``ln_linear_act_bwd``): its grid is a function of the row count
alone and every tile falls to exactly one CTA."""
import copy
import dataclasses
import inspect
import types

import numpy as np
import pytest
import torch

from ddls_tpu_torch.envs import RampJobPartitioningEnvironment as PortEnv
from ddls_tpu_torch.graphs.synthetic import generate_pipedream_txt_files
from ddls_tpu_torch.models import gnn
from ddls_tpu_torch.serve.fixture import load_checkpoint_fixture
from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.fixture import small_surface_kwargs

torch.set_num_threads(1)

MULTI_WORD = (4, 4, 4)  # 64 servers: two mask words


@pytest.fixture(scope="module")
def surfaces(tmp_path_factory):
    """Episode tables of the shipped surface and the small one."""
    d = str(tmp_path_factory.mktemp("placement_bits_profiles"))
    generate_pipedream_txt_files(d, n_cnn=2, n_translation=1, seed=5)
    cfg = load_checkpoint_fixture("ppo_price_mixed")["env_config"]
    out = {}
    for name, kwargs in (("shipped", copy.deepcopy(cfg)),
                         ("small", small_surface_kwargs(d))):
        env = PortEnv(**kwargs, device="cpu")
        env.reset(seed=0)
        out[name] = device_env.build_episode_tables(env)
    return out


def _shape_tables(surfaces, name):
    if name == "multi_word":
        return device_env.build_shape_tables(MULTI_WORD, 16)
    return surfaces[name].st


@pytest.mark.parametrize("name", ["shipped", "small", "multi_word"])
def test_anchor_bits_say_what_the_cells_say(surfaces, name):
    st = _shape_tables(surfaces, name)
    n_srv = int(np.prod(st.ramp_shape))
    words = -(-n_srv // 32)
    assert st.anchor_bits.shape == st.anchor_span.shape + (words,)
    assert st.anchor_bits.dtype == np.int32
    assert st.anchor_ok.shape == st.anchor_span.shape
    assert (words > 1) == (name == "multi_word")
    bits = st.anchor_bits.view(np.uint32)
    for sh in range(st.anchor_cells.shape[0]):
        for a in range(st.anchor_cells.shape[1]):
            cells = st.anchor_cells[sh, a]
            want = {int(c) for c in cells if c >= 0}
            got = {32 * w + i for w in range(words) for i in range(32)
                   if (int(bits[sh, a, w]) >> i) & 1}
            assert got == want, (sh, a)
            assert st.anchor_ok[sh, a] == (st.anchor_span[sh, a]
                                           and not (cells == -1).any())


def _first_fit_bits(st, free: torch.Tensor, split: torch.Tensor):
    """The kernel's first fit in torch: pack the free mask into 32-bit
    words, test every anchor of a row position as anchor_ok && (bits &
    ~free) == 0, take the first position with a fitting anchor and its
    lowest anchor. Returns (shape id, anchor, found), each [B]."""
    lanes, n_srv = free.shape
    words = st.anchor_bits.shape[2]
    bits = torch.from_numpy(st.anchor_bits.astype(np.int64) & 0xFFFFFFFF)
    ok = torch.from_numpy(st.anchor_ok)
    weight = torch.zeros(n_srv, words, dtype=torch.int64)
    for s in range(n_srv):
        weight[s, s // 32] = 1 << (s % 32)
    free_words = free.long() @ weight                          # [B, W]
    row = torch.from_numpy(st.row)[split.clamp(0, st.row.shape[0] - 1)
                                   .long()]
    best_shape = torch.full((lanes,), -1, dtype=torch.int32)
    best_anchor = torch.full((lanes,), n_srv + 1, dtype=torch.int32)
    found = torch.zeros(lanes, dtype=torch.bool)
    for p in range(row.shape[1]):
        sid = row[:, p].long()
        missing = bits[sid.clamp(min=0)] & ~free_words[:, None, :]
        fits = (ok[sid.clamp(min=0)] & (missing == 0).all(-1)
                & (sid >= 0)[:, None])                         # [B, n_srv]
        first = torch.where(fits, torch.arange(n_srv), n_srv).amin(1)
        take = fits.any(1) & ~found
        best_shape = torch.where(take, sid.to(torch.int32), best_shape)
        best_anchor = torch.where(take, first.to(torch.int32), best_anchor)
        found |= fits.any(1)
    return best_shape, best_anchor, found


@pytest.mark.parametrize("name", ["shipped", "small", "multi_word"])
def test_bitmask_first_fit_equals_the_reference_formulation(surfaces, name):
    st = _shape_tables(surfaces, name)
    n_srv = int(np.prod(st.ramp_shape))
    dev = types.SimpleNamespace(
        anchor_cells=torch.from_numpy(st.anchor_cells),
        anchor_span=torch.from_numpy(st.anchor_span),
        row=torch.from_numpy(st.row))
    rng = np.random.RandomState(13)
    lanes = 96
    free = torch.from_numpy(rng.rand(lanes, n_srv)
                            < rng.uniform(0.3, 1.0, (lanes, 1)))
    free[0] = True
    free[1] = False
    hits = 0
    for split in range(st.row.shape[0]):
        s = torch.full((lanes,), split, dtype=torch.int32)
        want = device_env._first_fit_rows(dev, free, s)
        got = _first_fit_bits(st, free, s)
        assert torch.equal(got[2], want[2]), split
        assert torch.equal(got[0][want[2]], want[0][want[2]]), split
        assert torch.equal(got[1][want[2]], want[1][want[2]]), split
        hits += int(want[2].sum())
    assert 0 < hits < lanes * st.row.shape[0]


@pytest.mark.parametrize("name", ["shipped", "small"])
def test_valid_forward_slots_are_a_prefix(surfaces, name):
    tb = surfaces[name].tables
    slots = np.arange(tb["f_valid"].shape[1])
    np.testing.assert_array_equal(tb["f_valid"],
                                  slots[None, :] < tb["n_fwd"][:, None])
    assert (tb["n_fwd"] > 0).all()


def _fuzzed(rng, lanes, n_srv, n_cfg, worker_mem):
    mem = np.full((lanes, n_srv), worker_mem)
    used = rng.rand(lanes, n_srv) < rng.uniform(0, 0.8, (lanes, 1))
    mem[used] *= rng.choice([0.5, 0.25, 0.1, 0.02, 0.001],
                            size=int(used.sum()))
    other = rng.rand(lanes, n_srv) >= rng.uniform(0, 0.6, (lanes, 1))
    cfg = rng.randint(0, n_cfg, size=lanes).astype(np.int32)
    return mem, other, cfg


@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["shipped", "small"])
def test_scan_cut_at_the_valid_prefix_equals_the_full_scan(surfaces, name,
                                                           dtype, indexed):
    et = surfaces[name]
    dev = device_env.device_tables(et, "cpu", dtype)
    rng = np.random.RandomState(5)
    mem, other, cfg = _fuzzed(rng, 24, et.n_srv, dev.n_cfg, et.worker_mem)
    mem, other = torch.tensor(mem, dtype=dtype), torch.from_numpy(other)
    cfg = torch.from_numpy(cfg)
    lane = None
    if indexed:  # 72 pricing rows over the 24 state lanes
        lane = torch.from_numpy(rng.randint(0, 24, 72).astype(np.int32))
        cfg = torch.from_numpy(rng.randint(0, dev.n_cfg, 72)
                               .astype(np.int32))
    full = device_env.allocate_job_plain(mem, other, cfg, dev, lane)
    cut = _cut_scan(mem, other, cfg, dev, lane)
    for g, w in zip(cut, full):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert 0 < int(full[2].sum()) < len(cfg)
    if name == "shipped":  # rows whose scan the cut shortens
        assert (et.tables["n_fwd"][cfg.numpy()] < et.pads.n_fwd).any()


def _cut_scan(mem, other, cfg, dev, lane):
    """K23's loop bound on the plain scan: the rows of each valid count n
    run ``allocate_job_plain`` over tables cut to their first n forward
    slots."""
    n_fwd = dev.t["n_fwd"][cfg.long()]
    rows = len(cfg)
    ots = torch.empty((rows, dev.pads.n_ops), dtype=torch.int32)
    new_mem = torch.empty((rows, mem.shape[1]), dtype=mem.dtype)
    ok = torch.empty(rows, dtype=torch.bool)
    for n in n_fwd.unique().tolist():
        at = (n_fwd == n).nonzero()[:, 0]
        cut_dev = copy.copy(dev)
        cut_dev.pads = dataclasses.replace(dev.pads, n_fwd=n)
        cut_dev.t = {**dev.t, **{key: dev.t[key][:, :n] for key in (
            "f_valid", "f_split", "f_mem", "f_parents", "f_sub_fwd",
            "f_sub_bwd")}}
        if lane is None:
            out = device_env.allocate_job_plain(mem[at], other[at], cfg[at],
                                                cut_dev)
        else:
            out = device_env.allocate_job_plain(mem, other, cfg[at],
                                                cut_dev, lane[at])
        ots[at], new_mem[at], ok[at] = out
    return ots, new_mem, ok


def test_k5_grid_is_a_function_of_the_rows_alone():
    assert list(inspect.signature(gnn.bwd_grid).parameters) == ["rows"]
    assert gnn.bwd_grid(0) == (1, 0, 16)
    most = gnn._BWD_MAX_BLOCKS
    for rows in [1, 15, 16, 17, 128, 4096, 4097, 4864, 8192, 8193, 16384,
                 16385, 64 * most, 64 * most + 1, 65536, 100_003]:
        blocks, tiles, tile = gnn.bwd_grid(rows)
        assert (blocks, tiles, tile) == gnn.bwd_grid(rows)
        assert tile in gnn._TILES and tiles == -(-rows // tile)
        # the smallest tile that keeps one tile a CTA, else the largest
        smaller = [t for t in gnn._TILES if t < tile]
        assert all(-(-rows // t) > most for t in smaller)
        assert tiles <= most or tile == gnn._TILES[-1]
        assert 1 <= blocks <= min(tiles, most)
        # CTA g takes tiles g, g + blocks, ...: each tile exactly once
        taken = np.concatenate([np.arange(g, tiles, blocks)
                                for g in range(blocks)])
        np.testing.assert_array_equal(np.sort(taken), np.arange(tiles))
