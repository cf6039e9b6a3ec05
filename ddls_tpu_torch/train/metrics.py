"""Lazy training metrics: device scalars as futures.

Counterpart of ``ddls_tpu/train/metrics.py`` over torch tensors. The
pipelined epoch loop (``train/loops.py``) never blocks the collect -> update
path on a read-back: a learner's metrics stay on the card, wrapped in a
``LazyMetrics`` mapping that rides the epoch's results unchanged, and are
read at a sync boundary (every ``metrics_sync_interval`` epochs, an
evaluation, ``close``, or the first access to a value), a whole group of
them in ONE device-to-host copy (``materialize_group``).

``LazyMetrics`` is a ``Mapping``: ``results["learner"]["total_loss"]``
works everywhere (the first access materialises), ``"k" in m``, ``len(m)``
and iteration never touch the card, and a materialised instance equals the
float dict the sequential loop builds, value for value (float32 scalars
read back as float32 and then made Python floats, as ``.tolist()`` makes
them).
"""
from __future__ import annotations

import threading
from collections.abc import Mapping
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch


def _flatten(tree) -> List[Any]:
    """The leaves of a metrics tree (a dict, or a list of dicts), in
    order."""
    if isinstance(tree, dict):
        return list(tree.values())
    return [v for d in tree for v in d.values()]


def read_back(leaves: List[Any]) -> List[float]:
    """Python floats of ``leaves`` (tensors or numbers); every tensor in
    one read-back (float64 holds float32 values exactly, so the floats are
    those of each tensor's own ``.tolist()``)."""
    tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
    host: List[float] = []
    if tensors:
        host = torch.stack([t.detach().reshape(()).to(torch.float64)
                            for t in tensors]).cpu().tolist()
    it = iter(host)
    return [next(it) if isinstance(v, torch.Tensor) else float(v)
            for v in leaves]


class LazyMetrics(Mapping):
    """Mapping over scalar training metrics with a deferred read-back.

    ``device_metrics`` is one dict of device (or host) scalars, or, with
    ``reduce="mean"``, a LIST of such dicts (the DQN epoch: many updates,
    logged as their per-key mean). ``extras`` are host values (counters the
    loop owns), merged in at materialisation and readable or writable
    without any device traffic."""

    __slots__ = ("_device", "_host", "_extras", "_reduce", "_lock")

    def __init__(self, device_metrics=None,
                 extras: Optional[Dict[str, Any]] = None,
                 reduce: Optional[str] = None):
        if reduce not in (None, "mean"):
            raise ValueError(f"unknown reduce {reduce!r}")
        if reduce is None and isinstance(device_metrics, list):
            raise ValueError("a list of metric dicts needs reduce='mean'")
        self._device = device_metrics
        self._host: Optional[Dict[str, float]] = None
        self._extras: Dict[str, Any] = dict(extras or {})
        self._reduce = reduce
        self._lock = threading.Lock()
        if device_metrics is None or (isinstance(device_metrics, list)
                                      and not device_metrics):
            self._host = {}
            self._device = None

    # ------------------------------------------------------------ futures
    @property
    def pending(self) -> bool:
        return self._host is None

    def _finish(self, values: List[float]) -> None:
        """Install the host values of this instance's leaves (read
        elsewhere, by a group sync); idempotent."""
        with self._lock:
            if self._host is not None:
                return
            if self._reduce == "mean":
                it = iter(values)
                dicts = [{k: next(it) for k in d} for d in self._device]
                self._host = {k: float(np.mean([d[k] for d in dicts]))
                              for k in dicts[0]}
            else:
                self._host = dict(zip(self._device, values))
            self._device = None

    def materialize(self) -> Dict[str, float]:
        """Host dict of floats (device values and extras); reads at most
        once. The only place a LazyMetrics touches the card."""
        if self._host is None:
            LazyMetrics.materialize_group([self])
        return {**self._host, **{k: float(v)
                                 for k, v in self._extras.items()}}

    @staticmethod
    def materialize_group(group: Iterable["LazyMetrics"]) -> None:
        """Materialise every pending instance with ONE read-back over all
        their values: the metrics ring's sync boundary."""
        pending = [lm for lm in group if lm.pending]
        if not pending:
            return
        leaves = [_flatten(lm._device) for lm in pending]
        values = read_back([v for lv in leaves for v in lv])
        at = 0
        for lm, lv in zip(pending, leaves):
            lm._finish(values[at:at + len(lv)])
            at += len(lv)

    # ------------------------------------------------------------ mapping
    def _keys(self) -> List[str]:
        if self._host is not None:
            base = list(self._host)
        elif self._reduce == "mean":
            base = list(self._device[0]) if self._device else []
        else:
            base = list(self._device or {})
        return base + [k for k in self._extras if k not in base]

    def __getitem__(self, key: str):
        if key in self._extras:
            return self._extras[key]
        return self.materialize()[key]

    def __setitem__(self, key: str, value) -> None:
        """Host extras only (ES's eval_fitness_mean, DQN's replay_size)."""
        self._extras[key] = value

    def __contains__(self, key) -> bool:
        return key in self._keys()

    def __iter__(self):
        return iter(self._keys())

    def __len__(self) -> int:
        return len(self._keys())

    def __repr__(self) -> str:
        state = "pending" if self.pending else "materialized"
        return f"LazyMetrics({state}, keys={self._keys()})"

    def __eq__(self, other) -> bool:
        if isinstance(other, (LazyMetrics, dict)):
            return dict(self.materialize()) == dict(
                other.materialize() if isinstance(other, LazyMetrics)
                else other)
        return NotImplemented

    def __ne__(self, other) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq


def materialize_results(node):
    """A results tree with every ``LazyMetrics`` replaced by its
    materialised float dict (and containers copied), so that it is plain
    JSON and pickle material."""
    if isinstance(node, LazyMetrics):
        return node.materialize()
    if isinstance(node, dict):
        return {k: materialize_results(v) for k, v in node.items()}
    if isinstance(node, list):
        return [materialize_results(v) for v in node]
    if isinstance(node, tuple):
        return tuple(materialize_results(v) for v in node)
    return node
