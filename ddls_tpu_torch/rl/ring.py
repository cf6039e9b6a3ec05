"""Multi-segment shared-memory trajectory ring: the deferred collector's
trajectory buffers, owned segment by segment.

Counterpart of ``ddls_tpu/rl/ring.py`` (``TrajRing``, ``RingSegment``,
``staged_aliases``), trimmed of its telemetry and of the slab-less device
mode. The shm backend (``rl/shm.py``) lets workers write observations in
place into ``[T+1, B, ...]`` slab rows, so the trajectory IS slab rows; with
one slab rewritten in place, whatever staged from those rows would have to
finish reading them before the next collect began. The ring keeps K
independently owned segments instead: a segment is not rewritten until it
is RELEASED, and release happens only after whatever staged from it has
consumed it.

Ownership ledger (workers still own only their ``[row, env_index]`` slice
between a step command and its pipe reply):

* ``free``      nobody reads or writes; the only state a lease takes a
  segment from;
* ``leased``    the COLLECTOR owns it: worker writes target its rows, the
  collector reads them back as trajectory views;
* ``published`` the LEARNER owns it: the rows are (or are about to be)
  staged into the update; nobody writes.

Release, the transition back to ``free``, is driven by a *release token*:
a ``torch.cuda.Event`` (ready when the work recorded before it has run on
the card), ``READY`` (a marker that the consumer is done with the bytes),
or anything with a ``query()``. The token is chosen per segment by the
ALIAS VERDICT, probed once at its first staging (``staged_aliases``: does
any staged tensor's memory lie inside the segment's slab views, by
``data_ptr()`` range?):

* no alias (the learner copied the rows: on the card a host-to-device
  copy, on the CPU ``Learner.stage_traj``'s packing into a fresh buffer):
  phase 1's token is an event recorded after the staging (``READY`` on
  the CPU, where the copy has happened when staging returns);
* alias (a CPU tensor built with ``torch.from_numpy`` over the slab view):
  the update reads the segment's own bytes, and only the consuming
  update's end can mark them consumed.

Phase 2 (``note_update``) attaches the update's token UNCONDITIONALLY
after the update: it replaces phase 1's token where there was one, and is
the only one where the staging aliased.

``lease()`` sweeps ready tokens without blocking; when every segment is
unreleased it counts a STALL and polls under a hard ``timeout_s``
deadline, so a lost or never-ready token becomes an error, not a hang.
Each segment's ``SlabSet`` carries its own ``weakref.finalize``, so an
interrupted run leaves no ``/dev/shm`` litter.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ddls_tpu_torch.rl.shm import SlabSet

# a release token that is ready now
READY = True


def _token_ready(token: Any) -> bool:
    """Non-blocking readiness of a release token: ``READY``, or an object
    with ``query()`` (a ``torch.cuda.Event``); anything else counts as
    ready."""
    if token is READY:
        return True
    query = getattr(token, "query", None)
    return bool(query()) if query is not None else True


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    tensors = getattr(tree, "tensors", None)  # a StagedTraj
    return _tensors(tensors) if tensors is not None else []


def staged_aliases(staged, views: Dict[str, np.ndarray]) -> bool:
    """Whether any tensor of the staged tree (a tensor, a dict or list of
    them, or a ``StagedTraj``) shares memory with the segment's host slab
    views: the per-segment alias verdict, by comparing each CPU tensor's
    storage range (``data_ptr()`` to its end) with the views' address
    ranges. A tensor on the card never aliases host memory."""
    ranges: List[Tuple[int, int]] = []
    for v in views.values():
        base = v.__array_interface__["data"][0]
        ranges.append((base, base + v.nbytes))
    for t in _tensors(staged):
        if t.device.type != "cpu" or not t.numel():
            continue
        # the whole storage: conservative (an alias verdict only delays
        # the release until the update's token)
        storage = t.untyped_storage()
        lo, hi = storage.data_ptr(), storage.data_ptr() + storage.nbytes()
        if any(lo < r_hi and r_lo < hi for r_lo, r_hi in ranges):
            return True
    return False


def staged_token(staged) -> Any:
    """The token that says a staging's copies have landed: an event on the
    current stream when the staged tensors lie on the card, ``READY`` on
    the CPU (the copy ran when staging returned)."""
    tensors = _tensors(staged)
    if tensors and tensors[0].device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
        return event
    return READY


class RingSegment:
    """One ``[rows, B, ...]`` slab plus its ledger entry."""

    __slots__ = ("index", "slabs", "state", "release_token", "aliased",
                 "generation")

    def __init__(self, index: int, slabs: SlabSet):
        self.index = index
        self.slabs = slabs
        self.state = "free"
        self.release_token: Any = None
        # alias verdict: None until the first staging probes it
        self.aliased: Optional[bool] = None
        # lease counter: a token quoting an older generation belongs to a
        # batch long gone and must not release a recycled segment
        self.generation = 0

    @property
    def views(self) -> Dict[str, np.ndarray]:
        return self.slabs.views


class TrajRing:
    """K independently owned trajectory segments with the ledger above.

    Thread contract: ``lease``/``publish`` run on the collecting thread
    (the main thread at ``pipeline_depth=0``, the background collection
    thread otherwise); ``set_release_token`` may run on either. One
    condition variable serialises the ledger."""

    def __init__(self, fields: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
                 rows: int, num_envs: int, segments: int):
        if segments < 2:
            raise ValueError(
                f"a trajectory ring needs >= 2 segments, got {segments}")
        self.rows = int(rows)
        self.num_envs = int(num_envs)
        self.fields = dict(fields)
        self.segments: List[RingSegment] = []
        try:
            for i in range(segments):
                self.segments.append(RingSegment(
                    i, SlabSet(fields, rows=rows, num_envs=num_envs)))
        except Exception:
            self.close()
            raise
        self._cond = threading.Condition()
        self._next = 0  # round-robin lease cursor
        self.leases = 0
        self.stalls = 0
        self.publishes = 0
        self.releases = 0
        # occupied-segment count at each lease, index = occupancy
        self.occupancy_counts = [0] * (segments + 1)
        self._params_age_sum = 0
        self._params_age_n = 0

    # ------------------------------------------------------------- ledger
    def _sweep_locked(self) -> None:
        for seg in self.segments:
            if seg.state == "published" and seg.release_token is not None:
                if _token_ready(seg.release_token):
                    self._release_locked(seg)

    def _release_locked(self, seg: RingSegment) -> None:
        seg.state = "free"
        seg.release_token = None
        self.releases += 1
        self._cond.notify_all()

    def _next_free_locked(self) -> Optional[RingSegment]:
        k = len(self.segments)
        for off in range(k):
            seg = self.segments[(self._next + off) % k]
            if seg.state == "free":
                self._next = (seg.index + 1) % k
                return seg
        return None

    def lease(self, timeout_s: float = 300.0) -> RingSegment:
        """Claim the next free segment for collection, waiting (and
        counting a stall) while every segment is leased or published;
        token readiness is polled under the hard ``timeout_s`` deadline,
        so a lost or never-ready release token raises instead of
        hanging."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            self._sweep_locked()
            occupied = sum(1 for s in self.segments if s.state != "free")
            self.occupancy_counts[occupied] += 1
            seg = self._next_free_locked()
            if seg is None:
                self.stalls += 1
            while seg is None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    states = [(s.index, s.state,
                               s.release_token is not None)
                              for s in self.segments]
                    raise RuntimeError(
                        f"trajectory ring lease timed out after "
                        f"{timeout_s:.0f}s: no segment released (ledger: "
                        f"{states}); a published segment's release token "
                        "was never set or never became ready")
                self._cond.wait(timeout=min(remaining, 0.05))
                self._sweep_locked()
                seg = self._next_free_locked()
            seg.state = "leased"
            seg.release_token = None
            seg.generation += 1
            self.leases += 1
            return seg

    def publish(self, seg: RingSegment) -> None:
        """Collection done: ownership passes to the learner. The segment
        stays unwritable until its release token reports ready."""
        with self._cond:
            if seg.state != "leased":
                raise RuntimeError(
                    f"publish on segment {seg.index} in state "
                    f"{seg.state!r} (must be leased)")
            seg.state = "published"
            self.publishes += 1
            self._cond.notify_all()

    def set_release_token(self, seg: RingSegment, token: Any,
                          generation: Optional[int] = None) -> None:
        """Attach the marker that turns this published segment free once
        ready. ``generation``, the lease the caller's batch came from,
        makes a late token harmless: it does nothing once the segment was
        released and leased again."""
        with self._cond:
            if seg.state != "published":
                return
            if generation is not None and seg.generation != generation:
                return
            seg.release_token = token
            self._cond.notify_all()

    def sweep(self) -> None:
        """Release every published segment whose token is ready (the pass
        a lease makes), for callers that need the ledger current."""
        with self._cond:
            self._sweep_locked()

    def release(self, seg: RingSegment) -> None:
        """Immediate explicit release (teardown, tests); the normal path
        is token-driven through the lease-time sweep."""
        with self._cond:
            if seg.state == "free":
                return
            self._release_locked(seg)

    # ------------------------------------------- consumer token protocol
    def note_staged(self, seg: RingSegment, staged,
                    generation: Optional[int] = None) -> None:
        """Phase 1, at staging: probe the alias verdict once per segment
        (cached), and where the staging copied the segment's bytes attach
        ``staged_token`` (ready once the copies land). Pass the batch's
        ``ring_generation``."""
        if seg.aliased is None:
            seg.aliased = staged_aliases(staged, seg.views)
        if not seg.aliased:
            self.set_release_token(seg, staged_token(staged),
                                   generation=generation)

    def note_update(self, seg: RingSegment, token: Any = READY,
                    generation: Optional[int] = None) -> None:
        """Phase 2, after the update that consumed the segment's batch,
        unconditionally: ``token`` (an event recorded after the update on
        the card, ``READY`` where the update has run when it returns) is
        the release marker of an aliased segment and replaces phase 1's
        for a copied one."""
        self.set_release_token(seg, token, generation=generation)

    # ------------------------------------------------------------ metrics
    def observe_params_age(self, age: int) -> None:
        """Record one consumed batch's params age (updates between its
        collection and its consumption)."""
        self._params_age_sum += int(age)
        self._params_age_n += 1

    def stats(self) -> Dict[str, Any]:
        """The ledger counters as one host dict."""
        with self._cond:
            return {
                "segments": len(self.segments),
                "rows": self.rows,
                "leases": self.leases,
                "stalls": self.stalls,
                "publishes": self.publishes,
                "releases": self.releases,
                "occupancy_counts": list(self.occupancy_counts),
                "mean_params_age": (
                    self._params_age_sum / self._params_age_n
                    if self._params_age_n else None),
                "aliased_segments": [bool(s.aliased) for s in self.segments
                                     if s.aliased is not None],
            }

    # ---------------------------------------------------------- lifecycle
    def specs(self) -> List[list]:
        """Per-segment slab specs for the workers' ring attach."""
        return [seg.slabs.spec() for seg in self.segments]

    def segment_names(self) -> List[str]:
        return [name for seg in self.segments
                for name in seg.slabs.segment_names()]

    def close(self) -> None:
        """Unlink every segment (idempotent); each ``SlabSet``'s own
        finalizer covers paths that never reach here."""
        for seg in self.segments:
            seg.slabs.close()
