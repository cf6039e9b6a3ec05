"""Cluster network topologies.

* :class:`RampTopology` -- the RAMP all-optical architecture (arXiv
  2211.15226): servers addressed by (communication group ``c``, rack ``r``,
  server ``s``), a fully connected server graph with per-direction wavelength
  channels of bandwidth ``total_node_bandwidth / C``
  (reference: ddls/topologies/ramp.py:11-67).
* :class:`TorusTopology` -- wrap-around 2D/3D torus; in the TPU-native build
  this doubles as the model of a TPU pod slice's ICI mesh
  (reference: ddls/topologies/torus.py:10; SURVEY.md §2.2 TPU mapping note).

No networkx: servers/links/channels live in plain dict tables keyed by server
id strings (``"c-r-s"`` for RAMP), with precomputed shortest-path lists (for
the full RAMP mesh every pair is one hop).

Port: a copy of ``ddls_tpu/hardware/topologies.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

from ddls_tpu_torch.hardware.devices import (DEVICE_TYPES, Channel, Processor,
                                       channel_id)
from ddls_tpu_torch.utils import get_class_from_path


class BaseTopology:
    """Server/channel tables shared by all topologies."""

    def __init__(self) -> None:
        self.server_ids: List[str] = []
        self.links: List[Tuple[str, str]] = []  # undirected node pairs
        self.channel_id_to_channel: Dict[str, Channel] = {}
        # populated by populate_workers:
        self.workers: Dict[str, Processor] = {}          # worker_id -> worker
        self.worker_to_server: Dict[str, str] = {}
        self.server_to_workers: Dict[str, List[str]] = {}
        self.worker_types: set = set()
        # shortest paths: src -> dst -> list of node paths
        self.shortest_paths: Dict[str, Dict[str, List[List[str]]]] = {}

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    @property
    def num_servers(self) -> int:
        return len(self.server_ids)

    def dense_tables(self):
        """Dense-integer runtime tables for the array-native step pipeline.

        Built lazily, once: server ids -> 0..S-1, channel ids -> 0..K-1
        (topology insertion order), and — when every server pair is
        directly connected with exactly one channel per direction (the
        canonical RAMP shape) — a [S, S] matrix mapping a directed server
        pair to its dense channel index. ``pair_channel`` is None for
        multi-channel or non-complete topologies; callers fall back to the
        dict/path pipeline there.
        """
        tables = getattr(self, "_dense_tables", None)
        if tables is not None:
            return tables
        import numpy as np

        server_index = {sid: i for i, sid in enumerate(self.server_ids)}
        channel_ids = list(self.channel_id_to_channel)
        channel_index = {cid: i for i, cid in enumerate(channel_ids)}
        S = len(self.server_ids)
        pair_channel = None
        if (getattr(self, "num_channels", 0) == 1
                and len(channel_ids) == S * (S - 1)):
            pair_channel = np.full((S, S), -1, np.int32)
            complete = True
            for cid, ch in self.channel_id_to_channel.items():
                u = server_index.get(ch.src)
                v = server_index.get(ch.dst)
                if u is None or v is None:
                    complete = False
                    break
                pair_channel[u, v] = channel_index[cid]
            if not complete or (pair_channel < 0).sum() != S:  # diag only
                pair_channel = None
        self._dense_tables = {
            "server_index": server_index,
            "channel_ids": channel_ids,
            "channel_index": channel_index,
            "pair_channel": pair_channel,
        }
        return self._dense_tables

    def _add_bidirectional_channels(self, u: str, v: str, num_channels: int,
                                    bandwidth: float) -> None:
        self.links.append((u, v))
        for n in range(num_channels):
            for src, dst in ((u, v), (v, u)):
                ch = Channel(src, dst, n, channel_bandwidth=bandwidth)
                self.channel_id_to_channel[ch.channel_id] = ch

    def populate_workers(self, node_config: dict,
                         one_worker_per_server: bool = True) -> None:
        """Instantiate one-or-more workers per server from a node_config of
        the reference's shape (env_dev.yaml node_config block). The RAMP
        placer assumes exactly 1 worker per server
        (reference: ramp_cluster_environment.py:180-181), which is enforced
        by default; the legacy Torus cluster passes
        ``one_worker_per_server=False`` (reference run_sim.py mounts 4
        workers per node)."""
        server_iter = iter(self.server_ids)
        for node_type, cfg in node_config.items():
            for _ in range(cfg["num_nodes"]):
                try:
                    server_id = next(server_iter)
                except StopIteration:
                    raise ValueError(
                        "node_config specifies more nodes than the topology "
                        f"has servers ({self.num_servers})")
                self.server_to_workers[server_id] = []
                for worker_cfg in cfg["workers_config"]:
                    if one_worker_per_server and worker_cfg["num_workers"] != 1:
                        raise ValueError(
                            "RAMP supports exactly 1 worker per server "
                            "(reference: ramp_cluster_environment.py:181)")
                    spec = worker_cfg["worker"]
                    if isinstance(spec, str):
                        cls = (DEVICE_TYPES[spec] if spec in DEVICE_TYPES
                               else get_class_from_path(spec))
                    else:
                        cls = spec
                    for k in range(worker_cfg["num_workers"]):
                        worker = cls(
                            processor_id=f"node_{server_id}_worker_{k}")
                        self.workers[worker.processor_id] = worker
                        self.worker_to_server[worker.processor_id] = server_id
                        self.server_to_workers[server_id].append(
                            worker.processor_id)
                        self.worker_types.add(worker.device_type)
        remaining = sum(1 for _ in server_iter)
        if remaining:
            raise ValueError(
                f"node_config populated {self.num_servers - remaining} of "
                f"{self.num_servers} topology servers; counts must match")

    def reset_devices(self) -> None:
        for worker in self.workers.values():
            worker.reset()
        for ch in self.channel_id_to_channel.values():
            ch.reset()


class RampTopology(BaseTopology):
    def __init__(self,
                 num_communication_groups: int = 4,
                 num_racks_per_communication_group: int = 2,
                 num_servers_per_rack: int = 4,
                 num_channels: int = 1,
                 total_node_bandwidth: float = 1.6e12,
                 intra_gpu_propagation_latency: float = 1.25e-6,
                 worker_io_latency: float = 100e-9,
                 **kwargs):
        super().__init__()
        if num_racks_per_communication_group > num_communication_groups:
            raise ValueError(
                f"num_racks_per_communication_group "
                f"({num_racks_per_communication_group}) must be <= "
                f"num_communication_groups ({num_communication_groups})")
        self.num_communication_groups = num_communication_groups
        self.num_racks_per_communication_group = num_racks_per_communication_group
        self.num_servers_per_rack = num_servers_per_rack
        self.num_channels = num_channels
        self.total_node_bandwidth = total_node_bandwidth
        # per-transceiver (a.k.a. per-channel) bandwidth
        self.channel_bandwidth = total_node_bandwidth / num_communication_groups
        self.intra_gpu_propagation_latency = intra_gpu_propagation_latency
        self.worker_io_latency = worker_io_latency

        for c in range(num_communication_groups):
            for r in range(num_racks_per_communication_group):
                for s in range(num_servers_per_rack):
                    self.server_ids.append(f"{c}-{r}-{s}")

        # fully connected server graph, one Channel object per direction
        for u, v in itertools.combinations(self.server_ids, 2):
            self._add_bidirectional_channels(u, v, num_channels,
                                             self.channel_bandwidth)

        # every pair is directly connected -> unique one-hop shortest path
        for u in self.server_ids:
            self.shortest_paths[u] = {
                v: [[u, v]] for v in self.server_ids if v != u}

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.num_communication_groups,
                self.num_racks_per_communication_group,
                self.num_servers_per_rack)

    @staticmethod
    def parse_server_id(server_id: str) -> Tuple[int, int, int]:
        c, r, s = server_id.split("-")
        return int(c), int(r), int(s)


class TorusTopology(BaseTopology):
    """x/y(/z) wrap-around torus; the natural model of TPU ICI."""

    def __init__(self,
                 x_dims: int = 4,
                 y_dims: int = 4,
                 z_dims: Optional[int] = None,
                 num_channels: int = 1,
                 channel_bandwidth: float = 1.25e9,
                 **kwargs):
        super().__init__()
        self.x_dims, self.y_dims, self.z_dims = x_dims, y_dims, z_dims
        self.num_channels = num_channels
        self.channel_bandwidth = channel_bandwidth

        dims = [x_dims, y_dims] + ([z_dims] if z_dims else [])
        coords = list(itertools.product(*[range(d) for d in dims]))
        self.server_ids = ["-".join(map(str, c)) for c in coords]
        index = {c: i for i, c in enumerate(coords)}

        seen = set()
        for coord in coords:
            for axis, dim in enumerate(dims):
                if dim < 2:
                    continue
                nbr = list(coord)
                nbr[axis] = (nbr[axis] + 1) % dim
                nbr = tuple(nbr)
                key = tuple(sorted((index[coord], index[nbr])))
                if key in seen:
                    continue
                seen.add(key)
                self._add_bidirectional_channels(
                    self.server_ids[index[coord]], self.server_ids[index[nbr]],
                    num_channels, channel_bandwidth)

        self._compute_shortest_paths(dims, coords, index)

    def _compute_shortest_paths(self, dims, coords, index) -> None:
        """BFS all-pairs shortest paths (torus is small in the legacy path)."""
        adj: Dict[str, List[str]] = {sid: [] for sid in self.server_ids}
        for u, v in self.links:
            adj[u].append(v)
            adj[v].append(u)
        for src in self.server_ids:
            # collect one shortest path per destination via BFS parents
            from collections import deque

            parent = {src: None}
            queue = deque([src])
            while queue:
                node = queue.popleft()
                for nbr in adj[node]:
                    if nbr not in parent:
                        parent[nbr] = node
                        queue.append(nbr)
            self.shortest_paths[src] = {}
            for dst in self.server_ids:
                if dst == src:
                    continue
                path, node = [], dst
                while node is not None:
                    path.append(node)
                    node = parent[node]
                self.shortest_paths[src][dst] = [path[::-1]]


def build_topology(topology_config: dict) -> BaseTopology:
    """(reference: ramp_cluster_environment.py:155-162 _init_topology)"""
    kind = topology_config["type"]
    kwargs = topology_config.get("kwargs", {})
    if kind == "ramp":
        return RampTopology(**kwargs)
    if kind == "torus":
        return TorusTopology(**kwargs)
    raise ValueError(f"unrecognised topology type {kind!r}")
