"""Op and dependency placers.

:class:`RampFirstFitOpPlacer` -- the RAMP packing heuristic (reference:
agents/placers/ramp_first_fit_op_placer.py:23 + placers/utils.py:532): walk
the job's forward ops in topological order; for each op try *parent
co-location* (pack sub-ops onto exactly the servers its parent occupies) and
fall back to a *regular* symmetric sub-block search; forward and backward
sub-ops are always placed together on the same server. A failed op fails the
whole job (it is simply absent from the returned placement, which blocks it).

:class:`FirstFitDepPlacer` -- routes every cross-server nonzero dep over the
first (shortest path x channel) combination whose channels carry no other
job; one unroutable flow drops the whole job
(reference: agents/placers/first_fit_dep_placer.py:18).

Port: a copy of ``ddls_tpu/agents/placers.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ddls_tpu_torch.agents.block_search import (Coord, find_sub_block,
                                          snapshot_free_servers)
from ddls_tpu_torch.graphs.readers import backward_op_id
from ddls_tpu_torch.hardware.devices import channel_id as make_channel_id
from ddls_tpu_torch.sim.partition import partitioned_op_id

# sentinel distinguishing "pair not scanned yet" from "pair has no options"
_PAIR_UNSEEN = object()
# shared marker for non-flow deps (zero size or same server): one tuple
# object serves every such dep
_NONFLOW = (None,)


def _pair_memory(full_graph, op: str, b_op: str) -> float:
    """Combined memory of a forward op and its backward counterpart: both are
    mounted on the same server, so the placer must reserve both (the
    reference reserves only the forward op's memory,
    placers/utils.py:296-312, and can hand the cluster a placement that
    overflows a worker at mount time; accounting for both here keeps
    placements mountable by construction)."""
    mem = full_graph.memory_cost(op)
    if full_graph.has_op(b_op):
        mem += full_graph.memory_cost(b_op)
    return mem


def _try_parent_colocation(ramp, full_graph, op: str, split: int,
                           meta_servers: Set[Coord], parents: List[str],
                           op_to_servers: Dict[str, List[Coord]],
                           n_forward: int,
                           placed: Dict[str, Coord]) -> bool:
    """Pack the op's sub-ops one-per-server onto a parent's exact server set
    (reference: placers/utils.py:258-314). Requires split == number of parent
    servers and per-server free memory for each fwd+bwd sub-op pair."""
    b_op = backward_op_id(op, n_forward)
    per_server = _pair_memory(full_graph, op, b_op) / split
    for parent in parents:
        servers = op_to_servers.get(parent, [])
        if not servers or not set(servers).issubset(meta_servers):
            continue
        if split != len(servers):
            continue
        if any(ramp[s]["mem"] < per_server for s in servers):
            continue
        for i, server in enumerate(servers):
            ramp[server]["mem"] -= per_server
            if split > 1:
                placed[partitioned_op_id(op, i)] = server
                placed[partitioned_op_id(b_op, i)] = server
            else:
                placed[str(int(op))] = server
                placed[str(int(b_op))] = server
            op_to_servers.setdefault(op, []).append(server)
        return True
    return False


def _try_regular_placement(ramp, ramp_shape, full_graph, op: str, split: int,
                           meta_shape: Coord, op_to_servers, n_forward: int,
                           job_idx, placed: Dict[str, Coord]) -> bool:
    """Symmetric sub-block placement, one sub-op per server
    (reference: placers/utils.py:333-383)."""
    b_op = backward_op_id(op, n_forward)
    op_size = _pair_memory(full_graph, op, b_op) / split
    block = find_sub_block(ramp, ramp_shape, meta_shape, num_servers=split,
                           op_size=op_size, job_idx=job_idx)
    if not block:
        return False
    for j, server in enumerate(block):
        ramp[server]["mem"] -= op_size
        if split > 1:
            placed[partitioned_op_id(op, j)] = server
            placed[partitioned_op_id(b_op, j)] = server
        else:
            placed[str(int(op))] = server
            placed[str(int(b_op))] = server
        op_to_servers.setdefault(op, []).append(server)
    return True


def allocate_job(ramp, ramp_shape: Coord, forward_graph, full_graph,
                 split_fwd: Dict[str, int],
                 meta_servers: Set[Coord], meta_shape: Coord,
                 job_idx) -> Optional[Dict[str, Coord]]:
    """Allocate every (sub-)op of one job; returns op_id -> server coord or
    None on failure (reference: placers/utils.py:532 allocate)."""
    n_forward = len(forward_graph.op_ids)
    parents = {op: forward_graph.parents(op) for op in forward_graph.op_ids}
    op_to_servers: Dict[str, List[Coord]] = {}
    placed: Dict[str, Coord] = {}
    for op in forward_graph.topo_order():
        split = split_fwd.get(str(int(op)), 1)
        ok = _try_parent_colocation(ramp, full_graph, op, split,
                                    meta_servers, parents[op], op_to_servers,
                                    n_forward, placed)
        if not ok:
            ok = _try_regular_placement(ramp, ramp_shape, full_graph, op,
                                        split, meta_shape, op_to_servers,
                                        n_forward, job_idx, placed)
        if not ok:
            return None
    return placed


class RampFirstFitOpPlacer:
    def __init__(self, **kwargs):
        pass

    def get(self, op_partition, cluster, meta_block_shapes: Optional[dict] = None,
            verbose: bool = False):
        """``meta_block_shapes`` optionally restricts each job to a chosen
        (c, r, s) meta block (the placement-shaping MDP's action); default is
        the whole cluster (reference: ramp_first_fit_op_placer.py:80-86)."""
        from ddls_tpu_torch.sim.actions import OpPlacement

        topo = cluster.topology
        ramp_shape = topo.shape
        ramp = snapshot_free_servers(cluster)
        placement: Dict[int, Dict[str, str]] = {}

        for job_id in op_partition.action:
            original = op_partition.original_jobs[job_id]
            job_idx = original.details["job_idx"]
            forward_graph = original.graph.forward_view()
            split_fwd = op_partition.job_id_to_split_forward_ops[job_id]

            if meta_block_shapes and job_id in meta_block_shapes:
                from ddls_tpu_torch.agents.block_search import find_meta_block

                meta = find_meta_block(ramp, ramp_shape,
                                       meta_block_shapes[job_id])
                if meta is None:
                    continue
                meta_servers, meta_shape = set(meta[0]), meta[1]
            else:
                meta_servers = {topo.parse_server_id(s)
                                for s in topo.server_ids}
                meta_shape = ramp_shape

            placed = allocate_job(ramp, ramp_shape, forward_graph,
                                  original.graph, split_fwd,
                                  meta_servers, meta_shape, job_idx)
            if placed is None:
                continue
            op_to_worker = {}
            for op_id, coord in placed.items():
                server_id = f"{coord[0]}-{coord[1]}-{coord[2]}"
                # RAMP currently assumes 1 worker per server
                worker_id = topo.server_to_workers[server_id][0]
                op_to_worker[str(op_id)] = worker_id
            placement[job_id] = op_to_worker
            # mark servers as occupied by this job for subsequent jobs in the
            # same step
            for coord in placed.values():
                ramp[coord]["job_idxs"].add(job_idx)

        return OpPlacement(placement, op_partition=op_partition,
                           cluster=cluster)


class RandomOpPlacer:
    """Random valid worker per op, respecting memory and the one-job-per-
    worker rule (reference: agents/placers/random_op_placer.py:13).

    Unlike the first-fit placer this ignores collective symmetry, so jobs it
    places may price collectives pessimistically."""

    def __init__(self, **kwargs):
        pass

    def get(self, op_partition, cluster, meta_block_shapes=None,
            verbose: bool = False):
        # meta_block_shapes is accepted (and ignored) so this placer is
        # drop-in compatible with the shaping env's placer call signature;
        # parameter order mirrors RampFirstFitOpPlacer.get
        from ddls_tpu_torch.sim.actions import OpPlacement

        topo = cluster.topology
        placement: Dict[int, Dict[str, str]] = {}
        free_mem = {wid: w.memory_free for wid, w in topo.workers.items()}
        occupied = {wid: set(w.mounted_job_idx_to_ops)
                    for wid, w in topo.workers.items()}
        for job_id, partitioned in op_partition.partitioned_jobs.items():
            job_idx = partitioned.details["job_idx"]
            op_to_worker: Dict[str, str] = {}
            ok = True
            for op_id in partitioned.graph.op_ids:
                mem = partitioned.graph.memory_cost(op_id)
                candidates = [
                    wid for wid in topo.workers
                    if free_mem[wid] >= mem
                    and (not occupied[wid] or occupied[wid] == {job_idx})]
                if not candidates:
                    ok = False
                    break
                wid = random.choice(candidates)
                op_to_worker[op_id] = wid
                free_mem[wid] -= mem
                occupied[wid].add(job_idx)
            if ok:
                placement[job_id] = op_to_worker
        return OpPlacement(placement, op_partition=op_partition,
                           cluster=cluster)


class FirstFitDepPlacer:
    def __init__(self, **kwargs):
        pass

    def get(self, op_partition, op_placement, cluster, verbose: bool = False):
        from ddls_tpu_torch.sim.actions import DepPlacement

        topo = cluster.topology
        dense = topo.dense_tables()
        if dense["pair_channel"] is not None:
            return self._get_arrays(op_partition, op_placement, cluster,
                                    dense)
        placements = op_placement.action
        result: Dict[int, Dict[Tuple[str, str], tuple]] = {}
        channels_used_by_other_jobs: Set[str] = set()
        worker_to_server = topo.worker_to_server

        for job_id, partitioned in op_partition.partitioned_jobs.items():
            if job_id not in placements:
                continue
            job_idx = partitioned.details["job_idx"]
            placement = placements[job_id]
            arrays = partitioned.graph.finalize()
            op_ids, edge_ids = arrays["op_ids"], arrays["edge_ids"]

            server_of_op = [worker_to_server[placement[op]] for op in op_ids]
            scode, is_flow = partitioned.graph.flow_mask(server_of_op)

            dep_to_channels: Dict[Tuple[str, str], tuple] = {}
            # channel validity for a (src, dst) pair is fixed while this
            # job's deps are being placed, so scan the path x channel space
            # once per pair: first path with any valid channel + that path's
            # valid channel list. Per dep, a uniform pick from the list is
            # distribution-identical to the reference's shuffled first-fit
            # (first_fit_dep_placer.py:118-121) at O(1) instead of
            # O(paths x channels) per flow. The channel-id tuple per
            # (pair, channel) is materialised once and shared by every dep
            # riding it (ids are read-only downstream).
            pair_options: Dict[Tuple[int, int], Optional[tuple]] = {}
            ok = True
            for ei in np.nonzero(~is_flow)[0]:
                dep_to_channels[edge_ids[ei]] = _NONFLOW
            for ei in np.nonzero(is_flow)[0]:
                u, v = edge_ids[ei]
                si, di = scode[arrays["edge_src"][ei]], scode[
                    arrays["edge_dst"][ei]]
                key = (si, di)
                options = pair_options.get(key, _PAIR_UNSEEN)
                if options is _PAIR_UNSEEN:
                    found = self._valid_path_channels(
                        topo, server_of_op[arrays["edge_src"][ei]],
                        server_of_op[arrays["edge_dst"][ei]], job_idx,
                        channels_used_by_other_jobs)
                    if found is None:
                        options = None
                    else:
                        path, valid_channels = found
                        by_ch = {}
                        for ch_num in valid_channels:
                            by_ch[ch_num] = tuple(
                                make_channel_id(path[idx], path[idx + 1],
                                                ch_num)
                                for idx in range(len(path) - 1))
                        options = (valid_channels, by_ch, set())
                    pair_options[key] = options
                if options is None:
                    ok = False
                    break
                valid_channels, by_ch, chosen = options
                # single-channel topologies (the canonical RAMP config) skip
                # the uniform pick — random.choice dominates this loop at
                # ~1.5k placed deps per env step otherwise
                ch_num = (valid_channels[0] if len(valid_channels) == 1
                          else random.choice(valid_channels))
                dep_to_channels[edge_ids[ei]] = by_ch[ch_num]
                chosen.add(ch_num)
            if ok:
                result[job_id] = dep_to_channels
                # commit exactly the channels this job's deps ride (feeds the
                # next job's validity scans within this composite action)
                for options in pair_options.values():
                    if options is not None:
                        _, by_ch, chosen = options
                        for ch_num in chosen:
                            channels_used_by_other_jobs.update(by_ch[ch_num])
        return DepPlacement(result)

    def _get_arrays(self, op_partition, op_placement, cluster, dense):
        """Array fast path (single-channel complete topology): every flow
        dep's channel is the direct (src, dst) link, so placement is one
        vectorised gather + occupancy check per job — same outcome as the
        first-fit scan (there is exactly one path and one channel to try),
        at none of the per-dep dict cost."""
        from ddls_tpu_torch.sim.actions import DepArrays, DepPlacement

        pair_channel = dense["pair_channel"]
        occ = cluster.channel_occ
        placements = op_placement.action
        action: Dict[int, DepArrays] = {}
        # channels claimed by earlier jobs of this same composite action
        taken = None
        for job_id, partitioned in op_partition.partitioned_jobs.items():
            if job_id not in placements:
                continue
            job_idx = partitioned.details["job_idx"]
            sc = op_placement.job_server_codes[job_id]
            arrays = partitioned.graph.finalize()
            is_flow = partitioned.graph.flow_mask_from_codes(sc)
            chan = np.full(arrays["edge_src"].shape[0], -1, np.int32)
            flow_idx = np.nonzero(is_flow)[0]
            chan[flow_idx] = pair_channel[sc[arrays["edge_src"][flow_idx]],
                                          sc[arrays["edge_dst"][flow_idx]]]
            channels = np.unique(chan[flow_idx])
            occ_vals = occ[channels]
            ok = bool(((occ_vals == -1) | (occ_vals == job_idx)).all())
            if ok and taken is not None:
                ok = not bool(taken[channels].any())
            if not ok:
                continue  # a busy channel drops the whole job (reference
                # first_fit_dep_placer.py: one failed flow blocks the job)
            action[job_id] = DepArrays(arrays["edge_ids"], chan, channels)
            if taken is None:
                taken = np.zeros(occ.shape[0], bool)
            taken[channels] = True
        return DepPlacement(action, channel_ids=dense["channel_ids"])

    def _valid_path_channels(self, topo, src_node: str, dst_node: str,
                             job_idx: int,
                             channels_used_by_other_jobs: Set[str]):
        """First path with >=1 valid channel, plus its valid channel nums."""
        for path in topo.shortest_paths[src_node][dst_node]:
            valid = [ch_num for ch_num in range(topo.num_channels)
                     if self._path_channel_valid(
                         topo, path, ch_num, job_idx,
                         channels_used_by_other_jobs)]
            if valid:
                return path, valid
        return None

    def _path_channel_valid(self, topo, path, ch_num: int, job_idx: int,
                            channels_used_by_other_jobs: Set[str]) -> bool:
        for idx in range(len(path) - 1):
            ch_id = make_channel_id(path[idx], path[idx + 1], ch_num)
            channel = topo.channel_id_to_channel[ch_id]
            if job_idx in channel.mounted_job_idx_to_deps:
                continue
            if channel.mounted_job_idx_to_deps:
                return False
            if ch_id in channels_used_by_other_jobs:
                return False
        return True
