"""Symmetric server-block search for RAMP collective placement.

RAMP collectives require symmetric server blocks: a split op's sub-ops must
land on a block of servers whose (c, r, s) shape satisfies the RAMP symmetry
rules. This module provides the first-fit search over candidate block shapes
used by the placer and by action-mask computation
(reference: ddls/environments/ramp_cluster/agents/placers/utils.py:13-530).

Search order is preserved exactly (factor pairs ascending, square shapes
before row/column shapes, diagonal fallback last; origins scanned
c-major/r/s) because "first fit" makes the order part of the semantics.

Port: a copy of ``ddls_tpu/agents/block_search.py`` with its imports pointed at
``ddls_tpu_torch``; the search runs on the native (C++) kernel only, so the
JAX package's Python fallback (``enumerate_block``, ``block_ok``,
``first_fit_block``) is left out.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

Coord = Tuple[int, int, int]


def snapshot_free_servers(cluster) -> Dict[Coord, dict]:
    """Dict snapshot of per-server free memory and occupying jobs
    (reference: placers/utils.py:235 dummy_ramp)."""
    snap: Dict[Coord, dict] = {}
    for server_id in cluster.topology.server_ids:
        coord = cluster.topology.parse_server_id(server_id)
        mem = 0.0
        job_idxs: set = set()
        for worker_id in cluster.topology.server_to_workers.get(server_id, []):
            worker = cluster.topology.workers[worker_id]
            mem += worker.memory_free
            if worker.mounted_job_idx_to_ops:
                job_idxs.update(worker.mounted_job_idx_to_ops.keys())
        snap[coord] = {"mem": mem, "job_idxs": job_idxs}
    return snap


def factor_pairs(n: int) -> List[Tuple[int, int]]:
    """All (n/i, i) integer factor pairs, i ascending
    (reference: placers/utils.py:445)."""
    return [(n // i, i) for i in range(1, n + 1) if n % i == 0]


def block_shapes_for(pairs: Sequence[Tuple[int, int]],
                     meta_shape: Coord) -> List[Coord]:
    """Candidate (C, R, S) block shapes fitting inside ``meta_shape``
    (reference: placers/utils.py:491-530)."""
    shapes: List[Coord] = []
    for a, b in pairs:
        root = math.sqrt(a)
        if (root % 1 == 0 and root <= meta_shape[0]
                and root <= meta_shape[1] and b <= meta_shape[2]):
            shapes.append((int(root), int(root), b))
        if a > meta_shape[0] or a > meta_shape[1] or b > meta_shape[2]:
            continue
        shapes.append((a, 1, b))
        shapes.append((a, b, 1))
    return shapes


def _ramp_arrays(ramp: Dict[Coord, dict], ramp_shape: Coord, job_idx):
    """C-order mem / blocked views of the snapshot for the C++ kernel.
    A server is blocked when it holds a job other than ``job_idx``
    (the reference's occupancy rule)."""
    import numpy as np

    rC, rR, rS = ramp_shape
    mem = np.zeros(rC * rR * rS, np.float64)
    blocked = np.ones(rC * rR * rS, np.uint8)  # missing cells invalid
    for (c, r, s), entry in ramp.items():
        if 0 <= c < rC and 0 <= r < rR and 0 <= s < rS:
            idx = (c * rR + r) * rS + s
            mem[idx] = entry["mem"]
            occ = entry["job_idxs"]
            blocked[idx] = 1 if (occ and job_idx not in occ) else 0
    return mem, blocked


def find_sub_block(ramp: Dict[Coord, dict],
                   ramp_shape: Coord,
                   meta_shape: Coord,
                   num_servers: int,
                   op_size: float,
                   job_idx) -> Optional[List[Coord]]:
    """(reference: placers/utils.py:385-392)"""
    shapes = block_shapes_for(factor_pairs(num_servers), meta_shape)
    shapes += [(num_servers, num_servers, -1), (num_servers, 1, 1)]
    from ddls_tpu_torch.native import run_first_fit_block

    found = run_first_fit_block(shapes, meta_shape, ramp_shape,
                                *_ramp_arrays(ramp, ramp_shape, job_idx),
                                op_size=op_size, meta_scan=False)
    return found[0] if found else None


def find_meta_block(ramp: Dict[Coord, dict],
                    ramp_shape: Coord,
                    meta_shape: Coord):
    """First fully-free block of ``meta_shape``; returns (servers, shape,
    origin) or None (reference: placers/utils.py:117-191)."""
    span = (ramp_shape[0] - meta_shape[0] + 1,
            ramp_shape[1] - meta_shape[1] + 1,
            ramp_shape[2] - meta_shape[2] + 1)
    if span[0] <= 0 or span[1] <= 0 or span[2] <= 0:
        return None
    from ddls_tpu_torch.native import run_first_fit_block

    found = run_first_fit_block([meta_shape], meta_shape, ramp_shape,
                                *_ramp_arrays(ramp, ramp_shape, "__meta__"),
                                op_size=None, meta_scan=True)
    if found is None:
        return None
    block, origin = found
    return block, meta_shape, origin


def meta_block_shape_valid(c: int, r: int, s: int,
                           ramp: Dict[Coord, dict],
                           ramp_shape: Coord,
                           job_max_partition_degree: int,
                           num_available_workers: int) -> bool:
    """Validity of a (c, r, s) meta-block action for a job with the given
    max partition degree (reference: placers/utils.py:13-30)."""
    size = c * r * s
    if not (job_max_partition_degree <= size
            <= min(num_available_workers, job_max_partition_degree)):
        return False
    if size == job_max_partition_degree and c != r:
        # exact-size blocks must pack evenly across racks and comm groups
        return False
    return find_meta_block(ramp, ramp_shape, (c, r, s)) is not None
