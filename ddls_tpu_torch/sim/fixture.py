"""The recorded lookahead lanes: real inputs of the array lookahead engine
with the JAX engine's answers to them, for holding K21 on a machine that
has no JAX.

``scripts/export_torch_lookahead_lanes.py`` writes the archive
(``ddls_tpu_torch/data/lookahead_lanes_recorded.npz``). Each group of lanes
is one batched engine call: the lanes' arrays are stored ragged (each
lane's ``n`` valid ops and ``m`` valid deps, concatenated; the valid slots
are a prefix) with the group's padded sizes, and ``load_lookahead_lanes``
pads them back as the builder does (op workers and channels -1, the rest
zero). The JAX outputs were computed on exactly those padded arrays.
"""
from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
LANES_PATH = os.path.join(DATA_DIR, "lookahead_lanes_recorded.npz")

OP_FIELDS = ("op_remaining", "op_valid", "op_worker", "op_score",
             "num_parents")
DEP_FIELDS = ("dep_remaining", "dep_valid", "dep_src", "dep_dst",
              "dep_mutual", "dep_is_flow", "dep_score", "dep_channel")
JAX_OUTPUTS = ("jax_t", "jax_comm", "jax_comp", "jax_busy", "jax_ok")
_PAD_VALUE = {"op_worker": -1, "dep_channel": -1}


def pack_lanes(lanes: Sequence, num_workers: int, num_channels: int
               ) -> Dict[str, np.ndarray]:
    """The ragged form of ``lanes`` (objects with the engine's thirteen
    array fields, valid slots a prefix); the group's padded sizes are the
    largest of the lanes'."""
    n = np.array([int(a.op_valid.sum()) for a in lanes], np.int64)
    m = np.array([int(a.dep_valid.sum()) for a in lanes], np.int64)
    for a, nb, mb in zip(lanes, n, m):
        if not (a.op_valid[:nb].all() and a.dep_valid[:mb].all()):
            raise ValueError("the valid slots of a lane must be a prefix")
    out = {"n": n, "m": m,
           "pad": np.array([max(a.op_remaining.shape[0] for a in lanes),
                            max(a.dep_remaining.shape[0] for a in lanes),
                            max(a.dep_channel.shape[1] for a in lanes)],
                           np.int64),
           "num_workers": np.array(num_workers, np.int64),
           "num_channels": np.array(num_channels, np.int64)}
    for name in OP_FIELDS:
        out[name] = np.concatenate([getattr(a, name)[:nb]
                                    for a, nb in zip(lanes, n)])
    links = int(out["pad"][2])
    for name in DEP_FIELDS:
        parts = [getattr(a, name)[:mb] for a, mb in zip(lanes, m)]
        if name == "dep_channel":
            parts = [np.pad(p, ((0, 0), (0, links - p.shape[1])),
                            constant_values=-1) for p in parts]
        out[name] = np.concatenate(parts)
    return out


def unpack_lanes(packed) -> Dict[str, np.ndarray]:
    """The padded, stacked arrays of a packed group ([B, N], [B, E],
    [B, E, L]), keyed by field name."""
    n, m = np.asarray(packed["n"]), np.asarray(packed["m"])
    pad_n, pad_e, links = (int(x) for x in packed["pad"])
    lanes = len(n)
    out = {}
    for names, counts, size in ((OP_FIELDS, n, pad_n),
                                (DEP_FIELDS, m, pad_e)):
        starts = np.concatenate([[0], np.cumsum(counts)])
        for name in names:
            flat = np.asarray(packed[name])
            shape = (lanes, size) + ((links,) if name == "dep_channel"
                                     else ())
            arr = np.full(shape, _PAD_VALUE.get(name, 0), flat.dtype)
            for b in range(lanes):
                arr[b, :counts[b]] = flat[starts[b]:starts[b + 1]]
            out[name] = arr
    return out


def load_lookahead_lanes(path: str = LANES_PATH
                         ) -> Dict[str, Dict[str, object]]:
    """``{group: {"args": the thirteen padded arrays in the engine's
    order, "num_workers", "num_channels", "n" and "m" (each lane's valid
    ops and deps), "jax": (t, comm, comp, busy, ok)}}``."""
    from ddls_tpu_torch.sim.lookahead import ARG_NAMES

    groups: Dict[str, Dict[str, object]] = {}
    with np.load(path, allow_pickle=False) as data:
        names = sorted({k.split("/")[0] for k in data.files})
        for g in names:
            packed = {k.split("/", 1)[1]: data[k] for k in data.files
                      if k.startswith(f"{g}/")}
            arrays = unpack_lanes(packed)
            groups[g] = {
                "args": tuple(arrays[a] for a in ARG_NAMES),
                "num_workers": int(packed["num_workers"]),
                "num_channels": int(packed["num_channels"]),
                "n": packed["n"], "m": packed["m"],
                "jax": tuple(packed[k] for k in JAX_OUTPUTS)}
    return groups
