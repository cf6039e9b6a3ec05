"""The device episode's lookahead memo (B11): a set-associative table per
lane, keyed by the host memo's signature, that serves a lookahead already
computed on bit-identical inputs instead of running K21 again.

Port of ``ddls_tpu/sim/jax_memo.py`` (``MemoConfig`` :100,
``resolve_memo_cfg`` :110, ``_hash_weights`` :130, ``memo_init`` :142,
``canonical_groups`` :167, ``memo_lookahead`` :201,
``memo_trace_counters`` and ``summarize_counters``), lane-batched: every
tensor carries a leading lane axis and each lane owns its table.

The key of a decision is (the config row, the canonical first-appearance
grouping of its ops' server codes, the mounted dep times); the probe hashes
it onto a set (``sum(payload * weights)`` with mod 2**32 wrap, weights from
``RandomState(0x5EED)``), then compares the FULL key bitwise against every
way of the set, so a hash collision is a miss and ``-0.0`` never matches
``0.0``. ``memo_lookahead`` splits the reference's function around the
lookahead: K27 (``memo_probe``) probes before K21, whose ``skip`` it
gives; K28 (``memo_insert``) after it selects the served value or the
computed one and, on a miss, inserts the key at the set's round-robin way.
A float64 time is two key words, low word first (``bitcast_convert_type``'s
order). Both kernels touch the table only for lanes that evaluate a
candidate (``active``), the reference's ``lax.cond(action_ok, ...)``.

Hits serve what the same K21 computed on bit-identical inputs, so an
episode with the memo is bit-identical to one without it. The table
outlives the in-kernel episode reset (``make_segment_fn``), as the host
``lookahead_cache`` outlives ``reset()``.

Each kernel's wrapper launches it on CUDA tensors and runs its plain
PyTorch version (``*_plain``) on CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ddls_tpu_torch import kernels

#: the cumulative counters the memo-enabled segment traces each step
MEMO_TRACE_KEYS = ("memo_hits", "memo_misses", "memo_evicts")
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class MemoConfig:
    """Table geometry: ``n_sets`` x ``n_ways`` entries a lane, round-robin
    way eviction per set."""
    n_sets: int = 64
    n_ways: int = 2


def resolve_memo_cfg(memo_cfg: Union[str, MemoConfig, None],
                     n_lanes: int) -> Optional[MemoConfig]:
    """The ``use_jax_lookahead_memo`` knob: ``"auto"`` turns the memo on at
    every lane count; a ``MemoConfig`` or None forces it on or off."""
    if memo_cfg == "auto":
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        return MemoConfig()
    if memo_cfg is None or isinstance(memo_cfg, MemoConfig):
        return memo_cfg
    raise ValueError(f"memo_cfg must be 'auto', None or a MemoConfig, "
                     f"got {memo_cfg!r}")


def _hash_weights(n_words: int) -> np.ndarray:
    """Odd uint32 multipliers of the key hash (the reference's, from
    ``RandomState(0x5EED)``)."""
    r = np.random.RandomState(0x5EED)
    w = r.randint(0, 1 << 31, size=n_words, dtype=np.int64).astype(
        np.uint32)
    return (w << np.uint32(1)) | np.uint32(1)


def key_words(n_ops: int, n_deps: int, dtype: torch.dtype) -> int:
    """Words of a key: the config row, the ops' groups, the times' bits."""
    return 1 + n_ops + n_deps * (2 if dtype == torch.float64 else 1)


def memo_init(lanes: int, n_ops: int, n_deps: int, dtype: torch.dtype,
              cfg: MemoConfig, device) -> Dict[str, torch.Tensor]:
    """An empty table per lane (reference: ``memo_init`` :142): keys as
    their raw parts (``key_times`` holds the times' bits as int32 words),
    values the lookahead's time and convergence flag, per-lane counters.
    ``weights`` (int32 bit patterns of the uint32 hash weights) rides
    along."""
    S, W = cfg.n_sets, cfg.n_ways
    words = key_words(n_ops, n_deps, dtype) - 1 - n_ops
    kw = dict(device=device)
    i32 = dict(dtype=torch.int32, **kw)
    weights = _hash_weights(key_words(n_ops, n_deps, dtype))
    return {
        "key_cfg": torch.full((lanes, S, W), -1, **i32),
        "key_groups": torch.zeros((lanes, S, W, n_ops), **i32),
        "key_times": torch.zeros((lanes, S, W, words), **i32),
        "val_t": torch.zeros((lanes, S, W), dtype=dtype, **kw),
        "val_ok": torch.zeros((lanes, S, W), dtype=torch.bool, **kw),
        "rr": torch.zeros((lanes, S), **i32),
        "hits": torch.zeros(lanes, **i32),
        "misses": torch.zeros(lanes, **i32),
        "evicts": torch.zeros(lanes, **i32),
        "weights": torch.from_numpy(weights.view(np.int32)).to(device),
    }


def canonical_groups(ots: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """First-appearance renumbering of each lane's op server codes
    (reference: ``canonical_groups`` :167): ``ots`` [B, N] int32,
    ``valid`` [B, N] bool -> [B, N] int32, -1 where not valid."""
    n = ots.shape[-1]
    idx = torch.arange(n, device=ots.device)
    same = ((ots[..., None, :] == ots[..., :, None])
            & valid[..., None, :] & valid[..., :, None])
    first = torch.where(same, idx, n).amin(-1)
    is_first = valid & (first == idx)
    rank_at = torch.cumsum(is_first.to(torch.int32), -1) - 1
    return torch.where(valid, rank_at.gather(-1, first.clamp(0, n - 1)),
                       -1).to(torch.int32)


def time_words(times: torch.Tensor) -> torch.Tensor:
    """The times' bits as int32 key words [B, Mw]: a float32 time one
    word, a float64 time two, low word first."""
    return times.contiguous().view(torch.int32).reshape(times.shape[0], -1)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2**32`` of uint32 values held in int64, without
    overflowing int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _U32


def key_hash(cfg: torch.Tensor, groups: torch.Tensor,
             words: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``sum(payload * weights) mod 2**32`` per lane, payload = (cfg,
    groups, words) as uint32 (int64 [B])."""
    payload = torch.cat([cfg[:, None], groups, words], 1).long() & _U32
    return _mul32(payload, weights.long()[None] & _U32).sum(1) & _U32


def memo_probe_plain(memo: dict, cfg: torch.Tensor, active: torch.Tensor,
                     ots: torch.Tensor, op_valid: torch.Tensor,
                     times: torch.Tensor, n_srv: int
                     ) -> Dict[str, torch.Tensor]:
    """K27's plain version: see ``memo_probe``."""
    lanes = cfg.shape[0]
    S, W = memo["key_cfg"].shape[1:]
    valid = op_valid[cfg.long()]
    groups = canonical_groups(torch.where(valid, ots, -1), valid)
    words = time_words(times)
    h = key_hash(cfg, groups, words, memo["weights"])
    set_idx = (h % S).to(torch.int32)
    ar = torch.arange(lanes, device=cfg.device)
    s = set_idx.long()
    eq = ((memo["key_cfg"][ar, s] == cfg[:, None])
          & (memo["key_groups"][ar, s] == groups[:, None]).all(-1)
          & (memo["key_times"][ar, s] == words[:, None]).all(-1))
    hit = eq.any(1) & active
    way = eq.to(torch.int8).argmax(1).to(torch.int32)
    t = memo["val_t"][ar, s, way.long()]
    ok = memo["val_ok"][ar, s, way.long()]
    # a lane that evaluates nothing probes nothing: its outputs are zero
    off = ~active
    return {"groups": torch.where(off[:, None], -1, groups),
            "set": torch.where(off, 0, set_idx),
            "hit": hit, "way": torch.where(off, 0, way),
            "t": torch.where(off, torch.zeros_like(t), t), "ok": ok & active,
            "skip": hit | off}


def memo_probe(memo: dict, cfg: torch.Tensor, active: torch.Tensor,
               ots: torch.Tensor, op_valid: torch.Tensor,
               times: torch.Tensor, n_srv: int) -> Dict[str, torch.Tensor]:
    """K27: probe each lane's table with the key of its candidate: the
    canonical groups of ``where(op_valid, ots, -1)``, the hash, the set and
    the bitwise compare against every way. ``cfg`` [B] int32, ``active``
    [B] bool (lanes that evaluate a candidate; the others probe nothing
    and get zero outputs, groups -1), ``ots`` [B, N] int32 (K23; server
    codes -1 .. ``n_srv`` - 1), ``op_valid`` [K, N] the table, ``times``
    [B, M] the mounted dep times (K24). Returns ``groups`` [B, N], ``set``,
    ``hit``, ``way`` (the hit way), the served ``t`` and ``ok``, and
    ``skip`` = hit | ~active (K21's), each [B]."""
    if kernels.on_cpu(cfg, active, ots, op_valid, times):
        return memo_probe_plain(memo, cfg, active, ots, op_valid, times,
                                n_srv)
    lanes, n = ots.shape
    S, W = memo["key_cfg"].shape[1:]
    m = times.shape[1]
    dt = times.dtype
    kernels.check_cuda("cfg", cfg, torch.int32, (lanes,))
    kernels.check_cuda("active", active, torch.bool, (lanes,))
    kernels.check_cuda("ots", ots, torch.int32, (lanes, n))
    kernels.check_cuda("op_valid", op_valid, torch.bool)
    kernels.check_cuda("times", times, dt, (lanes, m))
    _check_table(memo, lanes, n, m, dt)
    dev = cfg.device
    out = {"groups": torch.empty((lanes, n), dtype=torch.int32, device=dev),
           "set": torch.empty(lanes, dtype=torch.int32, device=dev),
           "hit": torch.empty(lanes, dtype=torch.bool, device=dev),
           "way": torch.empty(lanes, dtype=torch.int32, device=dev),
           "t": torch.empty(lanes, dtype=dt, device=dev),
           "ok": torch.empty(lanes, dtype=torch.bool, device=dev),
           "skip": torch.empty(lanes, dtype=torch.bool, device=dev)}
    if lanes:
        kernels.launch(
            "memo_probe", cfg.data_ptr(), active.data_ptr(), ots.data_ptr(),
            op_valid.data_ptr(), times.data_ptr(),
            *(memo[k].data_ptr() for k in _TABLE_KEYS),
            memo["weights"].data_ptr(),
            *(out[k].data_ptr() for k in _PROBE_KEYS), lanes, n, m, S, W,
            n_srv, int(dt == torch.float64))
    return out


# the table K27 and K28 read, and K27's outputs, in their argument order
_TABLE_KEYS = ("key_cfg", "key_groups", "key_times", "val_t", "val_ok",
               "rr")
_PROBE_KEYS = ("groups", "set", "hit", "way", "t", "ok", "skip")
_COUNTER_KEYS = ("hits", "misses", "evicts")


def _check_table(memo: dict, lanes: int, n: int, m: int,
                 dt: torch.dtype) -> None:
    S, W = memo["key_cfg"].shape[1:]
    words = key_words(n, m, dt) - 1 - n
    for name, want, shape in (
            ("key_cfg", torch.int32, (lanes, S, W)),
            ("key_groups", torch.int32, (lanes, S, W, n)),
            ("key_times", torch.int32, (lanes, S, W, words)),
            ("val_t", dt, (lanes, S, W)), ("val_ok", torch.bool, (lanes, S, W)),
            ("rr", torch.int32, (lanes, S)), ("hits", torch.int32, (lanes,)),
            ("misses", torch.int32, (lanes,)),
            ("evicts", torch.int32, (lanes,)),
            ("weights", torch.int32, (1 + n + words,))):
        kernels.check_cuda(f"memo {name}", memo[name], want, shape)


def memo_insert_plain(memo: dict, probe: dict, cfg: torch.Tensor,
                      active: torch.Tensor, times: torch.Tensor,
                      t_step: torch.Tensor, ok_la: torch.Tensor,
                      trace: Optional[dict] = None, d: int = 0) -> None:
    """K28's plain version: see ``memo_insert``."""
    lanes = cfg.shape[0]
    W = memo["key_cfg"].shape[2]
    ar = torch.arange(lanes, device=cfg.device)
    s = probe["set"].long()
    hit = probe["hit"]
    t = torch.where(hit, probe["t"], t_step)
    ok = torch.where(hit, probe["ok"], ok_la)
    t_step.copy_(torch.where(active, t, t_step))
    ok_la.copy_(torch.where(active, ok, ok_la))
    miss = active & ~hit
    way = (memo["rr"][ar, s] % W).long()
    evict = miss & (memo["key_cfg"][ar, s, way] >= 0)

    def upd(name, val):
        old = memo[name][ar, s, way]
        cond = miss.reshape((-1,) + (1,) * (old.dim() - 1))
        memo[name][ar, s, way] = torch.where(cond, val, old)

    upd("key_cfg", cfg)
    upd("key_groups", probe["groups"])
    upd("key_times", time_words(times))
    upd("val_t", t)
    upd("val_ok", ok)
    memo["rr"][ar, s] += miss.to(torch.int32)
    memo["hits"] += (active & hit).to(torch.int32)
    memo["misses"] += miss.to(torch.int32)
    memo["evicts"] += evict.to(torch.int32)
    if trace is not None:
        for key in _COUNTER_KEYS:
            trace[f"memo_{key}"][:, d] = memo[key]


def memo_insert(memo: dict, probe: dict, cfg: torch.Tensor,
                active: torch.Tensor, times: torch.Tensor,
                t_step: torch.Tensor, ok_la: torch.Tensor,
                trace: Optional[dict] = None, d: int = 0) -> None:
    """K28: for each lane that evaluates a candidate, the lookahead's time
    and flag (``t_step`` [B] of the float type, may be strided, and
    ``ok_la`` [B], K21's outputs, overwritten in place) become the served
    ones where K27 hit; on a miss the key and the computed value are
    inserted at the set's round-robin way (the eviction counted when the
    way held a key); the lane's ``hits``, ``misses`` and ``evicts`` move.
    With ``trace`` ({``memo_hits``, ``memo_misses``, ``memo_evicts``: [B,
    T] int32}), column ``d`` takes every lane's counters."""
    if kernels.on_cpu(cfg, active, times, t_step, ok_la):
        return memo_insert_plain(memo, probe, cfg, active, times, t_step,
                                 ok_la, trace, d)
    lanes, m = times.shape
    n = probe["groups"].shape[1]
    dt = times.dtype
    S, W = memo["key_cfg"].shape[1:]
    kernels.check_cuda("cfg", cfg, torch.int32, (lanes,))
    kernels.check_cuda("active", active, torch.bool, (lanes,))
    kernels.check_cuda("times", times, dt, (lanes, m))
    kernels.check_cuda("ok_la", ok_la, torch.bool, (lanes,))
    if t_step.dtype != dt or t_step.shape != (lanes,) or \
            t_step.device != times.device:
        raise ValueError("t_step must be the lookahead's [B] times")
    for k in _PROBE_KEYS:
        kernels.check_cuda(f"probe {k}", probe[k], probe[k].dtype)
    _check_table(memo, lanes, n, m, dt)
    cols = 0
    if trace is not None:
        cols = trace["memo_hits"].shape[1]
        for key in MEMO_TRACE_KEYS:
            kernels.check_cuda(key, trace[key], torch.int32, (lanes, cols))
    if lanes:
        kernels.launch(
            "memo_insert", cfg.data_ptr(), active.data_ptr(),
            times.data_ptr(), *(probe[k].data_ptr() for k in _PROBE_KEYS),
            t_step.data_ptr(), ok_la.data_ptr(),
            *(memo[k].data_ptr() for k in _TABLE_KEYS + _COUNTER_KEYS),
            *((trace[k].data_ptr() for k in MEMO_TRACE_KEYS)
              if trace is not None else (None, None, None)),
            lanes, n, m, S, W, t_step.stride(0), cols, d,
            int(dt == torch.float64))


def memo_lookahead(memo: dict, cfg: torch.Tensor, active: torch.Tensor,
                   ots: torch.Tensor, op_valid: torch.Tensor,
                   times: torch.Tensor, n_srv: int, compute: Callable,
                   trace=None, d: int = 0):
    """Probe-or-compute each lane's lookahead under the memo key
    (reference: ``memo_lookahead`` :201): K27, then ``compute(skip)``
    (K21 with K27's ``skip``; returns K21's ``(t [B], ..., ok [B])``),
    then K28. Returns ``compute``'s outputs with ``t`` and ``ok`` served
    where the probe hit."""
    probe = memo_probe(memo, cfg, active, ots, op_valid, times, n_srv)
    out = compute(probe["skip"])
    memo_insert(memo, probe, cfg, active, times, out[0], out[-1], trace, d)
    return out


def memo_trace_counters(memo: dict) -> Dict[str, torch.Tensor]:
    """Each lane's cumulative counters under ``MEMO_TRACE_KEYS``."""
    return {f"memo_{k}": memo[k] for k in _COUNTER_KEYS}


def summarize_counters(memo: dict) -> Dict[str, float]:
    """{hits, misses, evicts, hit_rate} summed over lanes (one read-back;
    for reporting boundaries)."""
    vals = torch.stack([memo[k] for k in _COUNTER_KEYS]).sum(1).tolist()
    out = dict(zip(_COUNTER_KEYS, (int(v) for v in vals)))
    total = out["hits"] + out["misses"]
    out["hit_rate"] = out["hits"] / total if total else 0.0
    return out
