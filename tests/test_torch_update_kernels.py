"""K1's and K8's launch choices and K1's plain version, on the CPU.

* ``models/gnn.py`` ``fwd_grid``: K1's tile (16, 32 or 64 rows, the
  smallest that keeps one tile a CTA within the cap) and CTA count, each
  row in exactly one tile of exactly one CTA (CTA g takes tiles g, g + CTAs,
  ...), on a sample of row counts from 0 to 70,000 and at every tile edge.
* ``rl/ppo.py`` ``ppo_loss_launch``: K8's lanes a row (the least power of
  two holding at most four actions a lane), threads and cluster size for
  every action count 1-64.
* A numpy mirror of ``kernels/csrc/common.cuh`` ``packed_warp_sums``, the
  butterfly K1's and K5's row statistics take several rows through at once:
  every tree's sum bit-equal to ``warp_sum``'s, and on the lanes
  ``ln_tile.cuh`` ``tile_stats`` reads it from.
* The plain K1 (``ln_linear_act_plain``) against the JAX package's
  ``FeatureModule`` first LayerNorm -> Dense -> act at the PPO update's
  widths, at row counts across K1's tile edges, on numpy inputs from a
  seed: within 1e-5 absolute (float32; the two sum in other orders), as
  ``tests/test_torch_models.py`` holds the modules.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from ddls_tpu.models import gnn as jgnn
from ddls_tpu_torch.models import gnn
from ddls_tpu_torch.rl import ppo

ATOL = 1e-5

# the tile edges (multiples of 16, 32, 64 and the grid's tile choice at
# 256 tiles of each), and a sample of other counts up to 70,000
_EDGES = sorted({n + d for t in (16, 32, 64)
                 for n in (t, 2 * t, 256 * t, 257 * t)
                 for d in (-1, 0, 1)})
GRID_ROWS = sorted(set(_EDGES) | {0, 1, 2, 1200, 4864, 65536, 70000}
                   | set(np.random.default_rng(0).integers(
                       1, 70001, 24).tolist()))


@pytest.mark.parametrize("rows", GRID_ROWS)
def test_fwd_grid_covers_each_row_once(rows):
    blocks, tiles, tile = gnn.fwd_grid(rows)
    most = gnn._FWD_MAX_BLOCKS
    assert tile in gnn._TILES and tiles == -(-rows // tile)
    # the smallest tile that keeps one tile a CTA, else the largest
    assert all(-(-rows // t) > most for t in gnn._TILES if t < tile)
    assert tiles <= most or tile == gnn._TILES[-1]
    assert 1 <= blocks <= most and (rows == 0 or blocks <= tiles)
    # CTA g takes tiles g, g + blocks, ...; tile j holds rows
    # [j tile, (j + 1) tile) below the row count
    owner = np.full(rows, -1)
    for g in range(blocks):
        for j in range(g, tiles, blocks):
            span = owner[j * tile:(j + 1) * tile]
            assert (span == -1).all()
            span[:] = g
    assert (owner >= 0).all()


def test_fwd_grid_is_a_function_of_the_rows_alone():
    assert gnn.fwd_grid(0) == (1, 0, 16)
    assert gnn.fwd_grid(4864) == (152, 152, 32)
    assert gnn.fwd_grid(16384) == (256, 256, 64)
    assert gnn.fwd_grid(65536) == (256, 1024, 64)


@pytest.mark.parametrize("a", range(1, 65))
def test_ppo_loss_launch_group_width(a):
    for m in (1, 31, 128, 129, 1000, 4000, 100_000):
        lanes, threads, ctas = ppo.ppo_loss_launch(m, a)
        # the least power of two whose lanes hold the row, four actions a
        # lane at most
        assert lanes & (lanes - 1) == 0 and 4 * lanes >= a
        assert lanes == 1 or 2 * lanes < a
        assert threads % 32 == 0 and 32 <= threads <= ppo.PPO_LOSS_THREADS
        assert 1 <= ctas <= ppo.PPO_LOSS_MAX_CTAS
        rows = -(-m // ctas)  # a CTA's rows
        per_pass = threads // lanes
        # one cluster CTA only where a full CTA would take over two passes
        assert ctas == 1 or m > 2 * (ppo.PPO_LOSS_THREADS // lanes)
        # a CTA takes its rows in at most two passes unless the cluster is
        # at its largest, and no CTA of the cluster is left without rows
        passes = -(-rows // per_pass)
        assert passes <= 2 or ctas == ppo.PPO_LOSS_MAX_CTAS
        assert (ctas - 1) * rows < m
        assert ppo.ppo_loss_launch(m, a) == (lanes, threads, ctas)
    assert ppo.ppo_loss_launch(128, 17) == (8, 1024, 1)


# ------------------------------------------- the packed butterfly's bits
def _warp_sum(v):
    """common.cuh warp_sum over the 32 lanes' float32 values."""
    lanes = np.arange(32)
    for offset in (16, 8, 4, 2, 1):
        v = (v + v[lanes ^ offset]).astype(np.float32)
    return v


def _packed_warp_sums(v):
    """common.cuh packed_warp_sums: v [32 lanes, T trees] -> each lane's
    tree sum."""
    lanes = np.arange(32)
    t_count = v.shape[1]
    v = v.copy()
    for j, offset in enumerate((16, 8, 4, 2, 1)):
        upper = (lanes & offset) != 0
        half = (t_count >> j) // 2
        for t in range(half):
            send = np.where(upper, v[:, t], v[:, t + half])
            v[:, t] = (np.where(upper, v[:, t + half], v[:, t])
                       + send[lanes ^ offset]).astype(np.float32)
        if half == 0:
            v[:, 0] = (v[:, 0] + v[lanes ^ offset, 0]).astype(np.float32)
    return v[:, 0]


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_packed_butterfly_gives_each_row_warp_sums_bits(batch):
    """tile_stats's trees: each row's s, then each row's s2 (2 batch
    trees); row i's s must sit on lane i << shift and its s2 on that lane
    ^ 16, bit-equal to warp_sum of the row."""
    shift = {1: 4, 2: 3, 4: 2, 8: 1}[batch]
    rng = np.random.default_rng(batch)
    for _ in range(50):
        v = (rng.normal(0, 1, (32, 2 * batch))
             * 10.0 ** rng.uniform(-4, 4, (32, 2 * batch))).astype(
                 np.float32)
        got = _packed_warp_sums(v).view(np.int32)
        for i in range(batch):
            lane = i << shift
            assert got[lane] == _warp_sum(v[:, i])[0].view(np.int32)
            assert got[lane ^ 16] == _warp_sum(
                v[:, batch + i])[0].view(np.int32)
            # every lane of the row's tree holds the same bits
            mates = [q for q in range(16) if q >> shift == i]
            assert (got[mates] == got[lane]).all()


# --------------------------------------- the plain K1 against JAX's module
class _FlaxFeature(nn.Module):
    features: int
    activation: str

    @nn.compact
    def __call__(self, x):
        return jgnn.FeatureModule(self.features, 1, self.activation,
                                  name="m")(x)


# the update's calls: (left width, right width, right given, gathered,
# outputs) for the node (5 -> 16), edge (2 -> 16), message (16 + 16 -> 64
# and -> 16, gathered), self-message (16 + a zero 16 -> 64 and -> 16),
# round-1 node (64 -> 16) and graph (51 -> 8) modules
UPDATE_WIDTHS = [(5, 0, False, False, 16), (2, 0, False, False, 16),
                 (16, 16, True, True, 64), (16, 16, False, False, 64),
                 (64, 0, False, False, 16), (16, 16, True, True, 16),
                 (16, 16, False, False, 16), (51, 0, False, False, 8)]
K1_ROWS = [1, 15, 16, 17, 33, 64, 65, 129, 4097]


_REFERENCE = {}


def _case(widths, rows):
    """One call's numpy inputs, made from a seed."""
    fa, fb, b_given, gathered, fo = widths
    rng = np.random.default_rng(rows * 100 + fa + fb + fo)
    src = max(rows // 3, 1) if gathered else rows
    a = rng.normal(0.5, 2.0, (src, fa)).astype(np.float32)
    a[0] = 1.5  # a row whose features tie
    idx = rng.integers(0, src, rows).astype(np.int32) if gathered else None
    b = (rng.uniform(0, 1, (rows, fb)).astype(np.float32) if b_given
         else None)
    x = a[idx] if gathered else a
    x = np.concatenate([x, b if b_given else np.zeros((rows, fb),
                                                      np.float32)], 1)
    return a, idx, b, x


def _reference(widths):
    """The flax module's parameters at these widths and its output for
    every row count's case: one apply over all the cases' rows (the
    module acts on each row alone)."""
    if widths not in _REFERENCE:
        fa, fb, _, _, fo = widths
        fm = _FlaxFeature(fo, "relu")
        params = fm.init(jax.random.PRNGKey(fa + fb + fo),
                         jnp.zeros((1, fa + fb)))
        xs = [_case(widths, rows)[3] for rows in K1_ROWS]
        out = np.asarray(fm.apply(params, jnp.asarray(np.concatenate(xs))))
        ends = np.cumsum([len(x) for x in xs])
        _REFERENCE[widths] = (params["params"]["m"], dict(zip(
            K1_ROWS, np.split(out, ends[:-1]))))
    return _REFERENCE[widths]


@pytest.mark.parametrize("widths", UPDATE_WIDTHS,
                         ids=lambda w: f"{w[0]}+{w[1]}{'g' if w[3] else ''}"
                                       f"{'b' if w[2] else ''}->{w[4]}")
@pytest.mark.parametrize("rows", K1_ROWS)
def test_plain_k1_matches_flax_feature_module(widths, rows):
    fa, fb, b_given, gathered, fo = widths
    a, idx, b, _ = _case(widths, rows)
    p, refs = _reference(widths)

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    got = gnn.ln_linear_act_plain(
        t(a), t(p["LayerNorm_0"]["scale"]), t(p["LayerNorm_0"]["bias"]),
        t(np.asarray(p["Dense_0"]["kernel"]).T), t(p["Dense_0"]["bias"]),
        "relu", idx=None if idx is None else torch.from_numpy(idx),
        b=None if b is None else t(b), b_width=0 if b_given else fb)
    assert got.shape == (rows, fo)
    np.testing.assert_allclose(got.numpy(), refs[rows], atol=ATOL, rtol=0)
