"""Shared-memory observation slabs for zero-copy rollout collection.

A copy of ``ddls_tpu/rl/shm.py`` (whose import would pull JAX in through
``ddls_tpu/rl/__init__.py``). The pipe backend of ``ParallelVectorEnv``
sends every padded observation over a pipe each step; the shm backend's
parent allocates one POSIX shared-memory segment per observation field,
shaped ``[rows, B, *field]`` (``rows = 1`` for plain stepping, ``T + 1``
for the deferred-fetch collector, whose trajectory IS slab rows
``[0:T]``), workers map the same segments and write their ``[row, i]``
slice in place, and only small control payloads (actions in; reward,
done and episode record out) ride the pipes.

Ownership contract:

* the PARENT owns every segment's lifecycle: it creates, unlinks on
  ``close()``, and carries a ``weakref.finalize`` fallback so an
  interrupted run leaves no ``/dev/shm`` litter;
* WORKERS attach without resource-tracker registration (the tracker would
  unlink the parent's live segment when the worker exits) and only ever
  write their own ``[row, env_index]`` slice, between receiving a step
  command and sending the reply: the reply on the pipe is the per-worker
  ready flag, and the parent reads a slice only after it;
* above the slab, the trajectory RING (``rl/ring.py``) adds a per-segment
  ledger: the collector owns a segment from lease to publish, the learner
  from publish to release, and release (token-driven) is the only point a
  segment becomes writable again. Workers are oblivious: a ring just means
  K slab attachments and a ``(segment, row)`` write destination.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

try:  # pragma: no cover - the import exists on every supported CPython
    from multiprocessing import resource_tracker, shared_memory
except ImportError:  # pragma: no cover
    shared_memory = None
    resource_tracker = None


@dataclass(frozen=True)
class SlabField:
    """Picklable descriptor of one field's slab, sent to workers over the
    control pipe so they can map the same segment by name."""
    key: str
    shm_name: str
    shape: Tuple[int, ...]  # full slab shape: (rows, num_envs, *field)
    dtype: str


_AVAILABLE: bool | None = None


def shm_available() -> bool:
    """Whether POSIX shared memory is usable here (``/dev/shm`` mounted,
    not blocked by a container). Probed once per process with a tiny
    create+unlink round trip."""
    global _AVAILABLE
    if _AVAILABLE is None:
        if shared_memory is None:
            _AVAILABLE = False
        else:
            try:
                seg = shared_memory.SharedMemory(create=True, size=16)
            except (OSError, ValueError):
                _AVAILABLE = False
            else:
                seg.close()
                seg.unlink()
                _AVAILABLE = True
    return _AVAILABLE


def obs_field_specs(obs: Dict[str, np.ndarray],
                    keys: Sequence[str]) -> Dict[str, Tuple[Tuple[int, ...],
                                                            np.dtype]]:
    """(shape, dtype) template per field from one encoded observation —
    the slab layout source. Fixed shapes are a backend requirement: an
    unpadded env (no ``pad_obs_kwargs``) cannot ride slabs."""
    out = {}
    for k in keys:
        arr = np.asarray(obs[k])
        out[k] = (tuple(arr.shape), arr.dtype)
    return out


def _release_segments(segments: List) -> None:
    """Close + unlink every segment; the single cleanup path shared by
    ``SlabSet.close`` and its finalizer. A still-exported numpy view pins
    the local mapping (``BufferError``) but never the name — unlink still
    removes the ``/dev/shm`` entry and the memory frees when the last map
    dies."""
    for seg in segments:
        try:
            seg.close()
        except BufferError:
            pass
        except OSError:
            pass
        try:
            seg.unlink()
        except (FileNotFoundError, OSError):
            pass


class SlabSet:
    """Parent-side owner of the per-field shared-memory slabs.

    ``views[key]`` is a ``[rows, num_envs, *field]`` ndarray over the
    segment. ``close()`` unlinks; a ``weakref.finalize`` covers every
    other exit path (leak-proofing is part of the backend contract).
    """

    def __init__(self, fields: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
                 rows: int, num_envs: int):
        if shared_memory is None:
            raise RuntimeError("multiprocessing.shared_memory unavailable")
        self.rows = int(rows)
        self.num_envs = int(num_envs)
        self.fields = dict(fields)
        self._segments: Dict[str, object] = {}
        self.views: Dict[str, np.ndarray] = {}
        created: List = []
        try:
            for key, (shape, dtype) in fields.items():
                full = (self.rows, self.num_envs) + tuple(shape)
                nbytes = int(np.prod(full)) * np.dtype(dtype).itemsize
                seg = shared_memory.SharedMemory(create=True,
                                                 size=max(nbytes, 1))
                created.append(seg)
                self._segments[key] = seg
                view = np.ndarray(full, dtype=np.dtype(dtype),
                                  buffer=seg.buf)
                view.fill(0)
                self.views[key] = view
        except Exception:
            _release_segments(created)
            raise
        self._finalizer = weakref.finalize(self, _release_segments, created)

    @property
    def obs_nbytes(self) -> int:
        """Bytes of ONE environment's observation (all fields) — the
        per-env-step unit for the bytes-copied telemetry counters."""
        return sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                   for shape, dtype in self.fields.values())

    def spec(self) -> List[SlabField]:
        return [SlabField(key=key, shm_name=self._segments[key].name,
                          shape=tuple(self.views[key].shape),
                          dtype=np.dtype(dtype).str)
                for key, (_, dtype) in self.fields.items()]

    def segment_names(self) -> List[str]:
        return [seg.name for seg in self._segments.values()]

    def close(self) -> None:
        """Unlink every segment (idempotent; the finalizer runs at most
        once). Views are dropped first so the munmap can proceed unless a
        caller still holds one — in which case unlink alone suffices."""
        self.views = {}
        self._finalizer()


def _attach_untracked(name: str):
    """Attach an existing segment WITHOUT resource-tracker registration:
    the tracker is shared with the parent under the spawn context, so a
    worker-side register/unregister pair would delete the PARENT's
    registration (and a by-name attach left registered would unlink the
    parent's live segment when the worker exits). CPython 3.13 exposes
    ``track=False`` for exactly this; earlier versions need the register
    hook silenced around the constructor."""
    try:
        return shared_memory.SharedMemory(name=name, track=False)
    except TypeError:  # Python < 3.13: no track kwarg
        original = resource_tracker.register
        resource_tracker.register = lambda *a, **k: None
        try:
            return shared_memory.SharedMemory(name=name)
        finally:
            resource_tracker.register = original


class SlabAttachment:
    """Worker-side mapping of the parent's slabs (attach by name, never
    create, never unlink)."""

    def __init__(self, fields: Sequence[SlabField]):
        if shared_memory is None:
            raise RuntimeError("multiprocessing.shared_memory unavailable")
        self._segments: List = []
        self.views: Dict[str, np.ndarray] = {}
        for f in fields:
            seg = _attach_untracked(f.shm_name)
            self._segments.append(seg)
            self.views[f.key] = np.ndarray(tuple(f.shape),
                                           dtype=np.dtype(f.dtype),
                                           buffer=seg.buf)

    def close(self) -> None:
        self.views = {}
        for seg in self._segments:
            try:
                seg.close()
            except BufferError:
                pass
        self._segments = []


class RingAttachment:
    """Worker-side mapping of a trajectory ring's K segments (attach by
    name, never create, never unlink — one ``SlabAttachment`` per ring
    segment). ``views_for(seg)`` selects the segment a ``(seg, row)``
    step destination addresses."""

    def __init__(self, segment_specs: Sequence[Sequence[SlabField]]):
        self.segments: List[SlabAttachment] = []
        try:
            for spec in segment_specs:
                self.segments.append(SlabAttachment(spec))
        except Exception:
            self.close()
            raise

    def views_for(self, seg: int) -> Dict[str, np.ndarray]:
        return self.segments[seg].views

    def close(self) -> None:
        for att in self.segments:
            att.close()
        self.segments = []
