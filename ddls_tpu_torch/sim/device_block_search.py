"""The RAMP first-fit block search over boolean server grids, batched.

Port of ``ddls_tpu/sim/jax_block_search.py``: for a boolean free-server
grid and a static list of candidate block shapes, find the (shape, origin)
of the first valid block in (shape order, then lexicographic origin)
order. ``first_fit_block`` takes a batch of grids ([G, C, R, S]) where the
reference jits one grid (``first_fit_block_jax`` :62) and vmaps it
(``jitted_first_fit`` :103): on CUDA tensors it launches K22
(``kernels/csrc/placement.cu``, one CTA per grid), on CPU tensors it runs
``first_fit_block_plain``, the reference's formulation in tensor ops.

Semantics kept from the reference, quirks included: a block of shape (dc,
dr, ds) anchored at (i, j, k) is free iff every cell of its window, taken
modulo the grid (``jnp.roll``), is free; anchors lie inside the origin
span ``meta - shape + 1`` of each axis; shapes that do not fit inside the
meta shape are skipped; a diagonal shape (``S == -1``) has an empty window
and so asks only for a free anchor (the full placer, ``sim/device_env.py``
``allocate_job``, handles diagonals through the wrap bases). Not found:
shape -1 and the origin of rank ``C * R * S + 1``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.agents.block_search import enumerate_block

Coord = Tuple[int, int, int]
FirstFit = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


def valid_anchor_mask(free: torch.Tensor, shape: Coord,
                      meta_shape: Coord) -> torch.Tensor:
    """Boolean [..., C, R, S] grid of anchors where a ``shape`` block fits
    entirely on free servers, anchored inside ``meta_shape``
    (reference: ``valid_anchor_mask`` :39)."""
    ok = free
    for dc in range(shape[0]):
        for dr in range(shape[1]):
            for ds in range(shape[2]):
                if dc == dr == ds == 0:
                    continue
                ok = ok & torch.roll(free, shifts=(-dc, -dr, -ds),
                                     dims=(-3, -2, -1))
    C, R, S = free.shape[-3:]
    span = [max(meta_shape[a] - shape[a] + 1, 0) for a in range(3)]
    ii, jj, kk = torch.meshgrid(torch.arange(C), torch.arange(R),
                                torch.arange(S), indexing="ij")
    in_span = (ii < span[0]) & (jj < span[1]) & (kk < span[2])
    return ok & in_span.to(free.device)


def _unrank(rank: torch.Tensor, dims: Sequence[int]) -> List[torch.Tensor]:
    _, R, S = dims
    return [rank // (R * S), (rank // S) % R, rank % S]


def first_fit_block_plain(free: torch.Tensor, shapes: Sequence[Coord],
                          meta_shape: Coord) -> FirstFit:
    """K22's plain version: ``(shape_idx, i, j, k, found)``, each [G], of
    the first valid block on each grid of ``free`` [G, C, R, S]."""
    G = free.shape[0]
    dims = free.shape[1:]
    n_cells = int(np.prod(dims))
    big = n_cells + 1
    device = free.device
    lex = torch.arange(n_cells, dtype=torch.int32, device=device)
    best_shape = torch.full((G,), -1, dtype=torch.int32, device=device)
    best_rank = torch.full((G,), big, dtype=torch.int32, device=device)
    found = torch.zeros(G, dtype=torch.bool, device=device)
    for si, shape in enumerate(shapes):
        if not all(meta_shape[a] >= shape[a] for a in range(3)):
            continue
        mask = valid_anchor_mask(free, shape, meta_shape).reshape(G, -1)
        any_valid = mask.any(1)
        rank = torch.where(mask, lex, big).amin(1).to(torch.int32)
        take = any_valid & ~found
        best_shape = torch.where(take, si, best_shape).to(torch.int32)
        best_rank = torch.where(take, rank, best_rank)
        found = found | any_valid
    i, j, k = _unrank(best_rank, dims)
    return best_shape, i, j, k, found


_SHAPE_TABLES: Dict[Tuple[Tuple[Coord, ...], str], torch.Tensor] = {}


def _shape_table(shapes: Tuple[Coord, ...], device) -> torch.Tensor:
    """The shape list as an int32 [n_shapes, 3] tensor on ``device``, made
    once per list and device (so a call after the first copies nothing
    from the host and can be captured in a CUDA graph)."""
    key = (shapes, str(device))
    table = _SHAPE_TABLES.get(key)
    if table is None:
        table = _SHAPE_TABLES[key] = torch.tensor(
            list(shapes) or [(0, 0, 0)], dtype=torch.int32, device=device)
    return table


def first_fit_block(free: torch.Tensor, shapes: Sequence[Coord],
                    meta_shape: Coord) -> FirstFit:
    """K22: ``(shape_idx, i, j, k, found)``, each [G] (int32, found bool),
    for a batch of boolean grids ``free`` [G, C, R, S] (True: the server
    can host the op). ``shapes`` and ``meta_shape`` are static."""
    if kernels.on_cpu(free):
        return first_fit_block_plain(free, shapes, meta_shape)
    if free.dim() != 4:
        raise ValueError(f"free must be [G, C, R, S], got {tuple(free.shape)}")
    kernels.check_cuda("free", free, torch.bool)
    G, C, R, S = free.shape
    table = _shape_table(tuple(map(tuple, shapes)), free.device)
    out = torch.empty((G, 4), dtype=torch.int32, device=free.device)
    found = torch.empty(G, dtype=torch.bool, device=free.device)
    if G:
        kernels.launch("first_fit_block", free.data_ptr(), table.data_ptr(),
                       out.data_ptr(), found.data_ptr(), G, C, R, S,
                       len(shapes), *meta_shape)
    return out[:, 0], out[:, 1], out[:, 2], out[:, 3], found


def block_cells(shape: Coord, origin: Coord,
                ramp_shape: Coord) -> List[Coord]:
    """Servers covered by the found block (reference: ``block_cells``
    :112): the host's ``enumerate_block``, so the geometry is the host's."""
    return enumerate_block(shape, ramp_shape, origin)


def free_grid_from_ramp(ramp, ramp_shape: Coord, job_idx,
                        op_size=None) -> np.ndarray:
    """``block_ok``'s per-server conjunction as one boolean grid: free of
    other jobs and, when ``op_size`` is given, with enough memory
    (reference: ``free_grid_from_ramp`` :121)."""
    grid = np.zeros(ramp_shape, dtype=bool)
    for coord, entry in ramp.items():
        occupants = entry["job_idxs"]
        ok = (not occupants) or (job_idx in occupants)
        if ok and op_size is not None:
            ok = entry["mem"] >= op_size
        grid[coord] = ok
    return grid
