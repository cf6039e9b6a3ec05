"""The array lookahead engine: one training step of a job, simulated by
dependency-driven ticking over padded arrays, for a batch of lanes at once.

Port of the engine half of ``ddls_tpu/sim/jax_lookahead.py``
(``jax_lookahead`` :313 under ``jax.vmap``, :457): ``lookahead`` takes
every array with a leading lane axis and returns ``(t, comm_oh, comp_oh,
busy, ok)`` per lane. On CUDA tensors it launches K21
(``kernels/csrc/lookahead.cu``), one launch for all lanes with the whole
tick loop inside the kernel; on CPU tensors it runs ``lookahead_plain``,
the same tick loop as tensor ops over all lanes.

Semantics (the host engine's, ``sim/cluster.py:_run_lookahead``): per
worker the highest-scoring ready op is selected (every op whose score
equals its worker's best, and the best > 0); ready non-flow deps force a
zero tick and alone advance; otherwise each channel nominates its
highest-scoring ready flow dep, the shortest nominated one bounds the
tick, and ALL ready flow deps advance (the reference's parallel-flow
hack); readiness is snapshotted before a tick's completions; mutual deps
never gate their child. A lane stops when every valid op and dep is done,
when no tick can progress (``ok`` False), or after ``N + E + 4`` ticks of
the padded sizes (``ok`` False).

The scalars follow the input float type: float32 (what both of the
simulator's entry points use, as the reference's arrays are float32) or
float64 (the reference's x64 mode). In float32 the engine takes XLA's
arithmetic on the CPU, bit for bit: every sum rounds on its own except
``busy + tick * count``, which XLA contracts into one fused multiply-add
(rounding it twice leaves the recorded lanes' busy one float32 step
off). In float64 that product and sum round apart, as the C++ engine
computes them.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddls_tpu_torch import kernels
from ddls_tpu_torch.sim.lookahead_arrays import LookaheadArrays, arrays_as_args

# stands in for +inf (the reference's BIG, a float32 constant also under x64)
BIG = float(np.float32(3.4e38))
# how often the plain loop asks whether any lane is still live: a tick of
# a finished lane changes nothing, so checking less often only saves syncs
_LIVE_CHECK_EVERY = 16

# the thirteen inputs' dtypes (None: the float type, float32 or float64)
ARG_NAMES = ("op_remaining", "op_valid", "op_worker", "op_score",
             "num_parents", "dep_remaining", "dep_valid", "dep_src",
             "dep_dst", "dep_mutual", "dep_is_flow", "dep_score",
             "dep_channel")
_ARG_DTYPES = (None, torch.bool, torch.int32, None, torch.int32, None,
               torch.bool, torch.int32, torch.int32, torch.bool, torch.bool,
               None, torch.int32)

LookaheadOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]


def engine_device(device) -> torch.device:
    """The device the array engine runs on: ``"cuda"`` (K21) or ``"cpu"``
    (the plain version). Raises for CUDA on a machine without a card: the
    engine never moves to the CPU by itself."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the array lookahead engine (use_jax_lookahead, "
            "candidate_pricing='jax') runs on the CUDA card by default and "
            "this machine has none; pass device='cpu' for its plain "
            "version")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the array lookahead engine runs on cuda or cpu, "
                         f"got {device}")
    return device


def stack_lanes(batch: Sequence[LookaheadArrays], device
                ) -> List[torch.Tensor]:
    """The lanes' arrays (equal padded sizes, float32 as the padded
    builder makes them) stacked on a leading lane axis, as tensors on
    ``device``."""
    out = []
    for want, parts in zip(_ARG_DTYPES, zip(*(arrays_as_args(a)
                                               for a in batch))):
        arr = torch.from_numpy(np.stack(parts))
        out.append(arr.to(device=device, dtype=want or torch.float32))
    return out


def bucket(size: int) -> int:
    """The padded size of ``size`` ops or deps: a power of two from 16, so
    that jobs of similar sizes share shapes (the reference's buckets)."""
    padded = 16
    while padded < size:
        padded *= 2
    return padded


def run_lanes(batch: Sequence[LookaheadArrays], device
              ) -> List[Optional[Tuple[float, float, float, float]]]:
    """One engine call over ``batch`` (equal padded sizes) on ``device``
    (one K21 launch on CUDA): per lane ``(t, comm_oh, comp_oh, busy)`` of
    one training step, as Python floats of the float32 results, or None
    where the engine could not finish (``ok`` False)."""
    args = stack_lanes(batch, device)
    t, comm, comp, busy, ok = lookahead(
        *args, num_workers=max(a.num_workers for a in batch),
        num_channels=max(a.num_channels for a in batch))
    vals = torch.stack((t, comm, comp, busy), 1).tolist()
    return [tuple(v) if good else None for v, good in zip(vals, ok.tolist())]


def lookahead(op_remaining, op_valid, op_worker, op_score, num_parents,
              dep_remaining, dep_valid, dep_src, dep_dst, dep_mutual,
              dep_is_flow, dep_score, dep_channel, *, num_workers: int,
              num_channels: int, ticks: Optional[torch.Tensor] = None
              ) -> LookaheadOut:
    """K21: ``(t, comm_oh, comp_oh, busy, ok)``, each [B], for B lanes of
    padded arrays: [B, N] ops, [B, E] deps, [B, E, L] ``dep_channel``
    (dtypes as ``_ARG_DTYPES``; float32 or float64). ``num_workers`` and
    ``num_channels`` bound the dense worker and channel indices over all
    lanes. If ``ticks`` (int32 [B], on the inputs' device) is given, each
    lane's tick count is written into it."""
    args = (op_remaining, op_valid, op_worker, op_score, num_parents,
            dep_remaining, dep_valid, dep_src, dep_dst, dep_mutual,
            dep_is_flow, dep_score, dep_channel)
    if kernels.on_cpu(*args, ticks):
        out = lookahead_plain(*args, num_workers=num_workers,
                              num_channels=num_channels)
        if ticks is not None:
            ticks.copy_(out[5])
        return out[:5]
    dtype = op_remaining.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"op_remaining must be float32 or float64, got "
                        f"{dtype}")
    if op_remaining.dim() != 2 or dep_remaining.dim() != 2 or \
            dep_channel.dim() != 3:
        raise ValueError("lookahead takes [B, N] ops, [B, E] deps and "
                         "[B, E, L] dep_channel")
    lanes, n = op_remaining.shape
    e, links = dep_channel.shape[1], dep_channel.shape[2]
    if num_workers < 1 or num_channels < 1 or links < 1:
        raise ValueError("num_workers, num_channels and L must be >= 1")
    for name, t, want in zip(ARG_NAMES, args, _ARG_DTYPES):
        shape = ((lanes, n) if name.startswith("op_") or
                 name == "num_parents" else
                 (lanes, e, links) if name == "dep_channel" else (lanes, e))
        kernels.check_cuda(name, t, want or dtype, shape)
    device = op_remaining.device
    vals = torch.empty((lanes, 4), dtype=dtype, device=device)
    ok = torch.empty(lanes, dtype=torch.bool, device=device)
    if ticks is None:
        ticks = torch.empty(lanes, dtype=torch.int32, device=device)
    kernels.check_cuda("ticks", ticks, torch.int32, (lanes,))
    # per-lane working state: remaining times, done and per-tick flags,
    # completed-parent counts (the kernel initialises all of it)
    rem_op = torch.empty((lanes, n), dtype=dtype, device=device)
    rem_dep = torch.empty((lanes, e), dtype=dtype, device=device)
    flags_op = torch.empty((lanes, 2, n), dtype=torch.uint8, device=device)
    flags_dep = torch.empty((lanes, 2, e), dtype=torch.uint8, device=device)
    parents = torch.empty((lanes, n), dtype=torch.int32, device=device)
    if lanes:
        kernels.launch("lookahead", *(t.data_ptr() for t in args),
                       rem_op.data_ptr(), rem_dep.data_ptr(),
                       flags_op.data_ptr(), flags_dep.data_ptr(),
                       parents.data_ptr(), vals.data_ptr(), ok.data_ptr(),
                       ticks.data_ptr(), lanes, n, e, links, num_workers,
                       num_channels, int(dtype == torch.float64))
    return vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3], ok


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """``a * b + c`` on float32 tensors with one rounding, as a fused
    multiply-add gives it: the product of two float32 is exact in float64,
    the float64 sum's rounding error is recovered exactly (TwoSum), and it
    decides the one case where rounding the float64 sum to float32 would
    round twice: a sum that lands exactly halfway between two float32."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    f = s.float()
    fd = f.double()
    toward = torch.where(s > fd, torch.full_like(f, float("inf")),
                         torch.full_like(f, -float("inf")))
    g = torch.nextafter(f, toward)
    halfway = (s != fd) & (s == (fd + g.double()) * 0.5) & (err != 0)
    # halfway: the exact sum lies on the side of s that err points to
    return torch.where(halfway & ((g.double() - s) * err > 0), g, f)


def _busy_step(busy, tick, count):
    """``busy + tick * count`` as the reference computes it: XLA's CPU
    compiler contracts it into one fused multiply-add in float32; in
    float64 the C++ engine's separate product and sum."""
    if busy.dtype == torch.float32:
        return fma32(tick, count, busy)
    return busy + tick * count


def lookahead_plain(op_remaining, op_valid, op_worker, op_score, num_parents,
                    dep_remaining, dep_valid, dep_src, dep_dst, dep_mutual,
                    dep_is_flow, dep_score, dep_channel, *, num_workers: int,
                    num_channels: int):
    """K21's plain version: the reference's ``body`` over all lanes at
    once, each lane frozen once its own loop condition fails (as
    ``vmap`` of ``lax.while_loop`` runs). Returns ``(t, comm_oh, comp_oh,
    busy, ok, ticks)``."""
    dt = op_remaining.dtype
    device = op_remaining.device
    lanes, n = op_remaining.shape
    e = dep_remaining.shape[1]
    links = dep_channel.shape[2]
    max_iters = n + e + 4
    w, c = int(num_workers), int(num_channels)
    big = torch.tensor(BIG, dtype=dt, device=device)
    zero = torch.zeros((), dtype=dt, device=device)
    neg = torch.full((), -1.0, dtype=dt, device=device)

    # padding (-1) goes to one spare column past the last worker/channel
    in_range = (op_worker >= 0) & (op_worker < w)
    w_idx = torch.where(in_range, op_worker, w).long()
    ch_ok = (dep_channel >= 0) & (dep_channel < c)
    ch_idx = torch.where(ch_ok, dep_channel, c).long()
    src, dst = dep_src.long(), dep_dst.long()

    rem_op, rem_dep = op_remaining.clone(), dep_remaining.clone()
    op_done = torch.zeros((lanes, n), dtype=torch.bool, device=device)
    dep_done = torch.zeros((lanes, e), dtype=torch.bool, device=device)
    parent_done = torch.zeros((lanes, n), dtype=torch.int32, device=device)
    t, comm, comp, busy = (torch.zeros(lanes, dtype=dt, device=device)
                           for _ in range(4))
    ticks = torch.zeros(lanes, dtype=torch.int32, device=device)
    stuck = torch.zeros(lanes, dtype=torch.bool, device=device)

    def finished():
        return ((op_done | ~op_valid).all(1)
                & (dep_done | ~dep_valid).all(1))

    for it in range(max_iters):
        live = ~finished() & ~stuck
        if it % _LIVE_CHECK_EVERY == 0 and not bool(live.any()):
            break
        # 1. readiness, snapshotted before this tick's completions
        ops_ready = op_valid & ~op_done & (parent_done >= num_parents)
        deps_ready = dep_valid & ~dep_done & torch.gather(op_done, 1, src)
        flow_ready = deps_ready & dep_is_flow
        nonflow_ready = deps_ready & ~dep_is_flow
        any_nonflow = nonflow_ready.any(1)

        # 2. per worker, every ready op whose score is the worker's best
        scores = torch.where(ops_ready, op_score, neg)
        best = torch.full((lanes, w + 1), -1.0, dtype=dt, device=device)
        best = best.scatter_reduce(1, w_idx, scores, "amax")
        best_op = torch.gather(best, 1, w_idx)
        sel = ops_ready & in_range & (scores == best_op) & (best_op > 0)
        shortest_op = torch.where(sel, rem_op, big).amin(1)

        # 3. per channel, the best ready flow dep (scatter-max over links)
        dscores = torch.where(flow_ready, dep_score, neg)
        ch_best = torch.full((lanes, c + 1), -1.0, dtype=dt, device=device)
        ch_best = ch_best.scatter_reduce(
            1, ch_idx.reshape(lanes, e * links),
            dscores[:, :, None].expand(lanes, e, links).reshape(
                lanes, e * links), "amax")
        nominated = torch.zeros((lanes, e), dtype=torch.bool, device=device)
        for li in range(links):
            nominated |= (ch_ok[:, :, li] & flow_ready
                          & (dscores >= torch.gather(ch_best, 1,
                                                     ch_idx[:, :, li]))
                          & (dscores > 0))
        shortest_comm = torch.where(
            any_nonflow, zero, torch.where(nominated, rem_dep, big).amin(1))

        tick = torch.minimum(shortest_op, shortest_comm)
        new_stuck = tick >= big

        # 4.-5. advance the selected ops, then the snapshot's non-flow
        # deps if any, else all of its ready flow deps
        tick_b = tick[:, None]
        rem_op2 = torch.where(sel, torch.maximum(rem_op - tick_b, zero),
                              rem_op)
        op_now_done = sel & (rem_op2 <= 0) & ~op_done
        dep_tick = torch.where(any_nonflow[:, None], nonflow_ready,
                               flow_ready)
        rem_dep2 = torch.where(dep_tick,
                               torch.maximum(rem_dep - tick_b, zero), rem_dep)
        dep_now_done = dep_tick & (rem_dep2 <= 0) & ~dep_done

        # 6. non-mutual completions advance their child's parent count
        inc = (dep_now_done & ~dep_mutual).to(torch.int32)
        parent_done2 = parent_done.scatter_add(1, dst, inc)

        # 7. overheads, busy time and the clock, in the reference's order
        ticked_ops = sel.any(1)
        ticked_flows = ~any_nonflow & flow_ready.any(1)
        safe_tick = torch.where(new_stuck, zero, tick)
        comp2 = comp + torch.where(ticked_ops, safe_tick, zero)
        comm2 = comm + torch.where(ticked_flows, safe_tick, zero)
        busy2 = _busy_step(busy, safe_tick, sel.sum(1).to(dt))
        t2 = t + safe_tick

        live_b = live[:, None]
        rem_op = torch.where(live_b, rem_op2, rem_op)
        rem_dep = torch.where(live_b, rem_dep2, rem_dep)
        op_done = op_done | (live_b & op_now_done)
        dep_done = dep_done | (live_b & dep_now_done)
        parent_done = torch.where(live_b, parent_done2, parent_done)
        comp = torch.where(live, comp2, comp)
        comm = torch.where(live, comm2, comm)
        busy = torch.where(live, busy2, busy)
        t = torch.where(live, t2, t)
        ticks = ticks + live.to(torch.int32)
        stuck = stuck | (live & new_stuck)
    ok = finished() & ~stuck
    return t, comm, comp, busy, ok, ticks
