"""Vectorised rollout collection.

Counterpart of ``ddls_tpu/rl/rollout.py``: ``stack_obs`` :32,
``harvest_episode_record`` :37, ``VectorEnv`` :60-157, the subprocess env
workers ``_parallel_env_worker``, ``_LazyObsList`` and
``ParallelVectorEnv`` :159-966 (the pipe and shm transports, ``auto``,
``prefetch_stacked``, ``ensure_traj_rows`` / ``ensure_traj_ring``,
``step_subset``, the bounded step wait and the dead-worker error), and
``RolloutCollector`` :967 with its plain, deferred-fetch and two-half
schedules (:1058-1314): one host process drives B environment instances (in
itself, or one subprocess each), stacks their padded observations into
[B, ...] arrays and samples all B actions in one batched forward on the
learner's device (``Learner.sample_actions``: K1-K3, K17, then K9).
Environments auto-reset on episode end; completed-episode returns,
lengths and the cluster's episode stats are harvested for logging.

Randomness: each step's uniforms come from a ``torch.Generator`` on the
learner's device, or, for parity with the reference, from ``noise``: the
[T, B, A] uniforms the reference's sampler drew, handed over step by step.

Left out: the reference's adaptive choice of the two-half schedule
(``pipeline=None``: the port's loops keep it off, see
``RolloutCollector``), the telemetry counters and the flight recorder.
"""
from __future__ import annotations

import multiprocessing as mp
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ddls_tpu_torch.envs.obs import ObsWriter
from ddls_tpu_torch.models.policy import gumbel_uniforms
from ddls_tpu_torch.rl.ring import TrajRing
from ddls_tpu_torch.rl.shm import (RingAttachment, SlabAttachment, SlabSet,
                                   obs_field_specs, shm_available)

OBS_KEYS = ("node_features", "edge_features", "graph_features",
            "edges_src", "edges_dst", "node_split", "edge_split",
            "action_mask")


def stack_obs(obs_list: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([np.asarray(o[k]) for o in obs_list])
            for k in OBS_KEYS}


def harvest_episode_record(env, env_index: int, episode_return: float,
                           episode_length: int) -> Dict[str, Any]:
    """Episode summary + the cluster's episode stats, mirroring what RLlib's
    callbacks collect (ddls/environments/ramp_cluster/utils.py:25-73)."""
    record = {"env_index": env_index,
              "episode_return": float(episode_return),
              "episode_length": int(episode_length)}
    cluster = getattr(env, "cluster", None)
    if cluster is not None and getattr(cluster, "episode_stats", None):
        stats = cluster.episode_stats
        for key in ("num_jobs_arrived", "num_jobs_completed",
                    "num_jobs_blocked", "blocking_rate",
                    "acceptance_rate"):
            if key in stats:
                record[key] = stats[key]
        for key in ("job_completion_time",
                    "job_completion_time_speedup"):
            vals = stats.get(key)
            if vals:
                record[f"mean_{key}"] = float(np.mean(vals))
    return record


class VectorEnv:
    """B independent environment instances with auto-reset. The env at
    index i is reset with ``seeds[i]``; each finished episode adds
    ``num_envs`` to that seed, so workload sampling differs per episode."""

    def __init__(self, env_fns: List[Callable[[], Any]],
                 seeds: Optional[List[int]] = None):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.seeds = seeds or list(range(self.num_envs))
        self.episode_returns = np.zeros(self.num_envs)
        self.episode_lengths = np.zeros(self.num_envs, dtype=np.int64)
        self.completed_episodes: List[Dict[str, Any]] = []
        self.obs: Optional[List[Dict[str, np.ndarray]]] = None

    def stacked_obs(self) -> Dict[str, np.ndarray]:
        """The current obs list as one [B, ...] batch."""
        return stack_obs(self.obs)

    def reset(self) -> List[Dict[str, np.ndarray]]:
        self.obs = [env.reset(seed=self.seeds[i])
                    for i, env in enumerate(self.envs)]
        self.episode_returns[:] = 0.0
        self.episode_lengths[:] = 0
        return self.obs

    def step(self, actions: np.ndarray):
        """Step every env with its action; returns (obs list, rewards [B]
        float32, dones [B] bool)."""
        _, rewards, dones = self.step_subset(range(self.num_envs), actions)
        return self.obs, rewards, dones

    def step_subset(self, indices, actions: np.ndarray):
        """Step only ``envs[i] for i in indices`` with ``actions`` (one per
        index); returns (the subset's obs list, rewards, dones)."""
        indices = list(indices)
        rewards = np.zeros(len(indices), dtype=np.float32)
        dones = np.zeros(len(indices), dtype=bool)
        for k, i in enumerate(indices):
            env = self.envs[i]
            obs, reward, done, _ = env.step(int(actions[k]))
            rewards[k] = reward
            dones[k] = done
            self.episode_returns[i] += reward
            self.episode_lengths[i] += 1
            if done:
                self.completed_episodes.append(harvest_episode_record(
                    env, i, self.episode_returns[i],
                    self.episode_lengths[i]))
                self.seeds[i] += self.num_envs
                obs = env.reset(seed=self.seeds[i])
                self.episode_returns[i] = 0.0
                self.episode_lengths[i] = 0
            self.obs[i] = obs
        return [self.obs[i] for i in indices], rewards, dones

    def drain_completed_episodes(self) -> List[Dict[str, Any]]:
        out, self.completed_episodes = self.completed_episodes, []
        return out

    def restart_episodes(self) -> List[Dict[str, np.ndarray]]:
        """Abandon every in-progress episode and start fresh ones on
        advanced per-env seeds. Completed-episode records are kept; the
        abandoned partial returns and lengths are dropped (used after an
        off-policy interlude, such as ES's eval window, so its steps never
        leak into training episode stats)."""
        for i in range(self.num_envs):
            self.seeds[i] += self.num_envs
        self.obs = [env.reset(seed=self.seeds[i])
                    for i, env in enumerate(self.envs)]
        self.episode_returns[:] = 0.0
        self.episode_lengths[:] = 0
        return self.obs

    def close(self) -> None:
        pass


def _parallel_env_worker(conn, env_builder, env_kwargs: Dict[str, Any],
                         env_index: int, seed: int,
                         seed_stride: int) -> None:
    """Subprocess body: owns one env, steps it on command, auto-resets.

    ``env_builder`` is a picklable callable (the env class) receiving
    ``**env_kwargs``. The worker is spawned, so it inherits no CUDA
    context and creates none: it imports the simulator (and, through this
    module, torch, which stays off the card) and runs one intra-op thread,
    so that many workers do not each start a thread pool on the host.

    Shared-memory protocol (the ``shm`` backend): on ``shm_open`` the
    worker maps the parent's slabs (``rl/shm.py``); step commands then
    carry ``(action, dest_row)`` and the observation is written in place
    into this worker's ``[dest_row, env_index]`` slice through
    ``envs.obs.ObsWriter``; the pipe reply shrinks to (reward, done,
    record), which doubles as the ready flag the parent waits on before
    reading the slice. ``ring_open`` upgrades the mapping to a trajectory
    ring (``rl/ring.py``): K segment attachments, and ``dest_row`` becomes
    ``(segment, row)``; who may write which segment when is decided by the
    parent alone."""
    attachment = None
    ring_attachment = None
    writer = None
    try:
        torch.set_num_threads(1)
        env = env_builder(**env_kwargs)
        episode_return, episode_length = 0.0, 0
        while True:
            cmd, payload = conn.recv()
            if cmd == "reset":
                # a seedless reset replays the current seed (as VectorEnv);
                # "restart" advances it
                seed = payload if payload is not None else seed
                obs = env.reset(seed=seed)
                episode_return, episode_length = 0.0, 0
                conn.send(("obs", obs))
            elif cmd == "restart":
                seed += seed_stride
                obs = env.reset(seed=seed)
                episode_return, episode_length = 0.0, 0
                conn.send(("obs", obs))
            elif cmd == "shm_open":
                if attachment is not None:
                    attachment.close()
                attachment = SlabAttachment(payload)
                writer = ObsWriter(
                    attachment.views["node_features"].shape[2],
                    attachment.views["edge_features"].shape[2])
                conn.send(("ok", None))
            elif cmd == "ring_open":
                if ring_attachment is not None:
                    ring_attachment.close()
                if attachment is not None:
                    # the pre-ring slab is retired: the parent unlinks it
                    # at the first lease, and a bare-row step after the
                    # ring's install fails loudly
                    attachment.close()
                    attachment = None
                ring_attachment = RingAttachment(payload)
                v0 = ring_attachment.views_for(0)
                writer = ObsWriter(v0["node_features"].shape[2],
                                   v0["edge_features"].shape[2])
                conn.send(("ok", None))
            elif cmd == "step":
                if isinstance(payload, tuple):
                    action, dest_row = payload
                else:
                    action, dest_row = payload, None
                obs, reward, done, _ = env.step(int(action))
                episode_return += reward
                episode_length += 1
                record = None
                if done:
                    record = harvest_episode_record(
                        env, env_index, episode_return, episode_length)
                    seed += seed_stride
                    obs = env.reset(seed=seed)
                    episode_return, episode_length = 0.0, 0
                if isinstance(dest_row, tuple):
                    seg, row = dest_row
                    writer.write(obs, {k: v[row, env_index] for k, v in
                                       ring_attachment.views_for(
                                           seg).items()})
                    conn.send(("step", (float(reward), bool(done), record)))
                elif attachment is not None and dest_row is not None:
                    writer.write(obs, {k: v[dest_row, env_index]
                                       for k, v in attachment.views.items()})
                    conn.send(("step", (float(reward), bool(done), record)))
                else:
                    conn.send(("step",
                               (obs, float(reward), bool(done), record)))
            elif cmd == "close":
                conn.send(("closed", None))
                return
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass  # interrupted, or the parent closed the pipe: nothing to tell
    except Exception as e:  # surface worker crashes to the parent
        import traceback
        conn.send(("error", f"{e}\n{traceback.format_exc()}"))
    finally:
        if attachment is not None:
            attachment.close()
        if ring_attachment is not None:
            ring_attachment.close()


class _LazyObsList:
    """Sequence over a shm-backend env's per-env obs dicts: ``step()``'s
    return value materialises slab copies only if someone indexes or
    iterates it (the collectors ignore it)."""

    def __init__(self, env):
        self._env = env

    def __len__(self):
        return self._env.num_envs

    def __getitem__(self, i):
        return self._env.obs[i]

    def __iter__(self):
        return iter(self._env.obs)


class ParallelVectorEnv:
    """B environment instances stepped in B subprocesses, with
    ``VectorEnv``'s interface. The env builder and its kwargs must pickle:
    the workers are spawned fresh, which keeps CUDA out of them (only the
    parent touches the card).

    ``backend`` selects the observation transport:

    * ``"pipe"``: workers pickle the full padded obs over the control pipe
      every step;
    * ``"shm"``: workers write each obs once, in place, into per-field
      shared-memory slabs (``rl/shm.py``) and the pipe carries only the
      (reward, done, record) ready flag. ``stacked_obs()`` then returns
      VIEWS of the slab (valid until the next ``step``/``reset``; ``.obs``
      materialises per-env copies on access), and ``ensure_traj_rows(T +
      1)`` or ``ensure_traj_ring`` grow the slabs so that the deferred
      collector's trajectory is the slab itself. Bit-identical to
      ``pipe`` (obs, rewards, dones, episode records and their order) for
      the same seeds;
    * ``"auto"``: ``shm`` where POSIX shared memory is usable, else
      ``pipe``.

    A step waits at most ``step_timeout_s`` for its replies (a wedged
    worker raises); a dead worker raises at once (pipe EOF). Either error
    closes the env first."""

    def __init__(self, env_builder: Callable[..., Any],
                 env_kwargs: Dict[str, Any], num_envs: int,
                 seeds: Optional[List[int]] = None,
                 backend: str = "pipe"):
        if backend == "auto":
            backend = "shm" if shm_available() else "pipe"
        if backend not in ("pipe", "shm"):
            raise ValueError(f"backend must be 'pipe', 'shm' or 'auto', "
                             f"got {backend!r}")
        if backend == "shm" and not shm_available():
            import warnings

            warnings.warn("POSIX shared memory unavailable; "
                          "ParallelVectorEnv falling back to the pipe "
                          "backend")
            backend = "pipe"
        self.backend = backend
        self.num_envs = num_envs
        self.seeds = seeds or list(range(num_envs))
        # opt-in (the deferred collector sets it): a full-batch step()
        # takes worker replies out of order as they finish and writes each
        # obs row straight into a stacked [B, ...] batch, so the next
        # sample's input assembles while slower workers still step (the
        # shm backend subsumes it: stacked_obs IS the slab)
        self.prefetch_stacked = False
        self._stacked_cache: Optional[Dict[str, np.ndarray]] = None
        self._stacked_bufs: Optional[Dict[str, np.ndarray]] = None
        # shm state: slabs are allocated at the first reset (field shapes
        # come from a real obs); row 0 holds the current obs until
        # ensure_traj_rows grows the slab, or ensure_traj_ring replaces it
        # with a K-segment ring, after which _slabs is the ACTIVE
        # segment's slab set and _active_seg its index (None: one slab)
        self._slabs = None
        self._ring = None
        self._active_seg = None
        self._field_specs = None
        self._cur_row = 0
        self._obs_list: List[Dict[str, np.ndarray]] = []
        self._obs_cache: Optional[List[Dict[str, np.ndarray]]] = None
        self._extra_obs: Optional[List[Dict[str, np.ndarray]]] = None
        self.step_timeout_s = 300.0
        self._closed = False
        ctx = mp.get_context("spawn")
        self._conns = []
        self._procs = []
        for i in range(num_envs):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_parallel_env_worker,
                args=(child, env_builder, env_kwargs, i, self.seeds[i],
                      num_envs),
                daemon=True)
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self.completed_episodes: List[Dict[str, Any]] = []
        self._first_reset = True

    # ------------------------------------------------------------- obs views
    @property
    def obs(self) -> List[Dict[str, np.ndarray]]:
        """Per-env obs dicts. Pipe backend: the worker-sent dicts. Shm
        backend: copies materialised from the slab on access (cached
        until the next step) plus the reset-time fields the slabs do not
        carry; the copies stay valid across later steps, so the DQN
        loop's ``prev_obs`` is safe."""
        if self._slabs is None:
            return self._obs_list
        if self._obs_cache is None:
            row = self._cur_row
            views = self._slabs.views
            extra = self._extra_obs or [{}] * self.num_envs
            self._obs_cache = [
                {**extra[i],
                 **{k: np.array(views[k][row, i]) for k in OBS_KEYS}}
                for i in range(self.num_envs)]
        return self._obs_cache

    @obs.setter
    def obs(self, value) -> None:
        self._obs_list = list(value)
        self._obs_cache = self._obs_list if self._slabs is not None else None

    def _send(self, i: int, msg) -> None:
        """Dispatch to worker i; a worker that died before the command
        raises a clear error instead of a BrokenPipeError."""
        try:
            self._conns[i].send(msg)
        except (BrokenPipeError, OSError):
            exitcode = self._procs[i].exitcode
            self.close()
            raise RuntimeError(
                f"env worker {i} died (exitcode {exitcode}): cannot "
                f"dispatch {msg[0]!r}") from None

    def _recv(self, conn) -> Tuple[str, Any]:
        i = self._conns.index(conn)
        if not conn.poll(self.step_timeout_s):
            self.close()
            raise RuntimeError(
                f"env worker {i} did not reply within "
                f"{self.step_timeout_s:.0f}s (wedged worker?)")
        try:
            kind, payload = conn.recv()
        except (EOFError, ConnectionResetError, OSError):
            exitcode = self._procs[i].exitcode
            self.close()
            raise RuntimeError(
                f"env worker {i} died (exitcode {exitcode}): pipe closed "
                f"before its reply") from None
        if kind == "error":
            self.close()
            raise RuntimeError(f"env worker failed:\n{payload}")
        return kind, payload

    def _drain_step_replies(self, on_reply) -> None:
        """One step reply per worker, taken out of order as workers
        finish, under one ``step_timeout_s`` deadline; ``on_reply(i,
        payload)`` handles each. The one drain loop of the shm and
        prefetch step paths, so their dead- and wedged-worker handling
        cannot diverge."""
        from multiprocessing import connection as mp_connection

        remaining = {conn: i for i, conn in enumerate(self._conns)}
        deadline = time.monotonic() + self.step_timeout_s
        while remaining:
            ready = mp_connection.wait(
                list(remaining), timeout=max(deadline - time.monotonic(),
                                             0.0))
            if not ready:
                stuck = sorted(remaining.values())
                self.close()
                raise RuntimeError(
                    f"env workers {stuck} did not reply within "
                    f"{self.step_timeout_s:.0f}s (wedged worker?)")
            for conn in ready:
                i = remaining.pop(conn)
                try:
                    kind, payload = conn.recv()
                except (EOFError, ConnectionResetError, OSError):
                    exitcode = self._procs[i].exitcode
                    self.close()
                    raise RuntimeError(
                        f"env worker {i} died mid-step (exitcode "
                        f"{exitcode})") from None
                if kind == "error":
                    self.close()
                    raise RuntimeError(f"env worker failed:\n{payload}")
                on_reply(i, payload)

    # ---------------------------------------------------------- shm plumbing
    def _setup_slabs(self, obs: List[Dict[str, np.ndarray]]) -> None:
        """First-reset slab allocation from the workers' obs shapes (every
        worker must agree: the env pads to fixed bounds); on failure the
        env falls back to pipe for good rather than crash training."""
        try:
            fields = obs_field_specs(obs[0], OBS_KEYS)
            for j, o in enumerate(obs[1:], start=1):
                other = obs_field_specs(o, OBS_KEYS)
                if other != fields:
                    raise ValueError(
                        f"env {j} obs shapes {other} differ from env 0's "
                        f"{fields} (shm needs fixed pad bounds)")
            slabs = SlabSet(fields, rows=1, num_envs=self.num_envs)
        except Exception as e:
            import warnings

            warnings.warn(f"shm backend unusable for this env ({e}); "
                          "falling back to pipe")
            self.backend = "pipe"
            return
        self._field_specs = fields
        self._install_slabs(slabs)
        # obs fields outside the slabs are episode-constant: captured at
        # reset and put back into materialised obs copies
        self._extra_obs = [{k: np.asarray(v) for k, v in o.items()
                            if k not in OBS_KEYS} for o in obs]

    def _install_slabs(self, slabs) -> None:
        """Send the slab spec and wait for every worker's attach ack
        (after which step replies carry no obs)."""
        spec = slabs.spec()
        for i in range(self.num_envs):
            self._send(i, ("shm_open", spec))
        for conn in self._conns:
            self._recv(conn)
        self._slabs = slabs
        self._cur_row = 0

    def _guard_ring_write(self, what: str) -> None:
        """Writing the active ring segment while it is PUBLISHED would
        corrupt a batch the learner may still read: raise (after
        releasing whatever has a ready token)."""
        if self._ring is None or self._active_seg is None:
            return
        self._ring.sweep()
        seg = self._ring.segments[self._active_seg]
        if seg.state == "published":
            raise RuntimeError(
                f"{what} would write ring segment {seg.index}, which is "
                "PUBLISHED (owned by the learner until its release token "
                "fires): settle the update (or release the segment) "
                "first")

    def _write_row0(self, obs: List[Dict[str, np.ndarray]]) -> None:
        self._guard_ring_write("reset/restart row-0 write")
        views = self._slabs.views
        for k in OBS_KEYS:
            for i in range(self.num_envs):
                views[k][0, i] = obs[i][k]
        self._cur_row = 0

    def ensure_traj_rows(self, rows: int) -> bool:
        """Grow the obs slabs to ``[rows, B, ...]`` so that a [T, B]
        collector can take rows ``[0:T]`` as its trajectory (row t = the
        obs BEFORE step t; the last row = the bootstrap obs). True when
        the slab-trajectory contract holds; False on the pipe backend."""
        if self._slabs is None:
            return False
        if self._ring is not None:
            raise RuntimeError(
                "ensure_traj_rows on a ring-backed env: its trajectory "
                "transport is the ring (ensure_traj_ring); build another "
                "vec env for single-slab collection")
        if self._slabs.rows >= rows:
            return True
        current = self.obs  # materialise from the OLD slab first
        old = self._slabs
        try:
            slabs = SlabSet(self._field_specs, rows=rows,
                            num_envs=self.num_envs)
        except Exception as e:
            import warnings

            warnings.warn(f"could not grow shm slabs to {rows} rows "
                          f"({e}); keeping the one-row slab")
            return False
        self._install_slabs(slabs)
        self._write_row0(current)
        self._obs_cache = current
        old.close()
        return True

    def rebase_row0(self) -> None:
        """Move the current obs to slab row 0 (one [B, ...] copy per
        field, once per segment) so the next T steps write rows 1..T."""
        if self._slabs is None or self._cur_row == 0:
            return
        views = self._slabs.views
        for k in OBS_KEYS:
            views[k][0] = views[k][self._cur_row]
        self._cur_row = 0
        self._obs_cache = None

    # ------------------------------------------------------ trajectory ring
    @property
    def traj_ring(self):
        """The installed trajectory ring (``rl/ring.py``), or None."""
        return self._ring

    def ensure_traj_ring(self, rows: int, segments: int):
        """Install (or return) a ``segments``-way trajectory ring of
        ``[rows, B, ...]`` slabs; None on the pipe backend or when it
        cannot be allocated (the caller falls back to the one slab). A
        different shape once a ring is installed raises: collection must
        never fall back onto a slab the learner may own."""
        if self._slabs is None:
            return None
        if self._ring is not None:
            if (self._ring.rows >= rows
                    and len(self._ring.segments) >= segments):
                return self._ring
            raise RuntimeError(
                f"trajectory ring shape change mid-run: installed "
                f"[{self._ring.rows} rows x "
                f"{len(self._ring.segments)} segments], requested "
                f"[{rows} x {segments}]; build a fresh vec env for "
                "another rollout length or pipeline depth")
        try:
            ring = TrajRing(self._field_specs, rows=rows,
                            num_envs=self.num_envs, segments=segments)
        except Exception as e:
            import warnings

            warnings.warn(f"could not allocate a {segments}-segment "
                          f"trajectory ring ({e}); keeping the one slab")
            return None
        specs = ring.specs()
        for i in range(self.num_envs):
            self._send(i, ("ring_open", specs))
        for conn in self._conns:
            self._recv(conn)
        self._ring = ring
        return ring

    def begin_ring_segment(self, segment) -> None:
        """Point collection at a freshly leased ring segment: the current
        obs (the previous segment's bootstrap row, or the pre-ring slab's
        current row at the first lease) is copied into its row 0. The
        previous segment is only READ here, which every ledger state
        allows."""
        prev, prev_row = self._slabs, self._cur_row
        views = segment.views
        if prev is not segment.slabs or prev_row != 0:
            for k in OBS_KEYS:
                views[k][0] = prev.views[k][prev_row]
        if self._active_seg is None and prev is not segment.slabs:
            # the first lease retires the pre-ring slab
            prev.close()
        self._slabs = segment.slabs
        self._active_seg = segment.index
        self._cur_row = 0
        self._obs_cache = None
        self._stacked_cache = None

    def traj_obs_views(self, t_len: int) -> Dict[str, np.ndarray]:
        """Slab rows [0:T] as the trajectory obs: zero-copy views, valid
        until the next collect begins (a ring segment's: until it is
        leased again), and never after ``close()``, which unmaps them."""
        return {k: self._slabs.views[k][:t_len] for k in OBS_KEYS}

    def reset(self) -> List[Dict[str, np.ndarray]]:
        # seeds live worker-side (advanced at every auto-reset): only the
        # first reset pins them, later resets continue each worker's
        # sequence
        payload = self.seeds if self._first_reset else [None] * self.num_envs
        self._first_reset = False
        self._stacked_cache = None
        for i, seed in enumerate(payload):
            self._send(i, ("reset", seed))
        obs = [self._recv(conn)[1] for conn in self._conns]
        self.obs = obs
        if self.backend == "shm" and self._slabs is None:
            self._setup_slabs(obs)
        if self._slabs is not None:
            self._write_row0(obs)
            self._obs_cache = obs
        return self.obs

    def stacked_obs(self) -> Dict[str, np.ndarray]:
        """The current obs as one [B, ...] batch. Shm backend: VIEWS of
        the slab row the workers wrote (no copy; valid until the next
        ``step``/``reset``). Pipe backend with ``prefetch_stacked``: the
        batch the previous ``step()`` assembled as replies arrived."""
        if self._slabs is not None:
            row = self._cur_row
            return {k: self._slabs.views[k][row] for k in OBS_KEYS}
        if self._stacked_cache is not None:
            return self._stacked_cache
        return stack_obs(self.obs)

    def step(self, actions: np.ndarray):
        if self._slabs is not None:
            return self._step_shm(actions)
        if self.prefetch_stacked:
            return self._step_prefetch(actions)
        return self.step_subset(range(self.num_envs), actions)

    def _step_shm(self, actions: np.ndarray):
        """Full-batch step over the slabs: obs rows are written by the
        workers (each write the only copy of that obs); replies carry
        (reward, done, record) and arrive out of order; episode records
        are flushed in env-index order, as the pipe paths give them."""
        if self._ring is not None and self._active_seg is None:
            raise RuntimeError(
                "trajectory ring installed but no segment is active: "
                "lease a segment and call begin_ring_segment() before "
                "stepping")
        self._guard_ring_write("step")
        n_rows = self._slabs.rows
        dest = (self._cur_row if n_rows == 1
                else min(self._cur_row + 1, n_rows - 1))
        payload_dest = (dest if self._active_seg is None
                        else (self._active_seg, dest))
        for i in range(self.num_envs):
            self._send(i, ("step", (int(actions[i]), payload_dest)))
        rewards = np.zeros(self.num_envs, dtype=np.float32)
        dones = np.zeros(self.num_envs, dtype=bool)
        records: Dict[int, dict] = {}

        def on_reply(i, payload):
            reward, done, record = payload
            rewards[i] = reward
            dones[i] = done
            if record is not None:
                records[i] = record

        self._drain_step_replies(on_reply)
        self._cur_row = dest
        self._obs_cache = None
        self.completed_episodes.extend(records[i] for i in sorted(records))
        return _LazyObsList(self), rewards, dones

    def _step_prefetch(self, actions: np.ndarray):
        """Full-batch pipe step with out-of-order replies: each worker's
        obs row lands in the stacked batch the moment it arrives, so the
        stacking overlaps the stragglers' stepping. Outputs are those of
        the in-order path (records flushed in env-index order)."""
        for i in range(self.num_envs):
            self._send(i, ("step", int(actions[i])))
        n = self.num_envs
        rewards = np.zeros(n, dtype=np.float32)
        dones = np.zeros(n, dtype=bool)
        records: Dict[int, dict] = {}
        state = {"stacked": None}

        def on_reply(i, payload):
            obs, reward, done, record = payload
            self.obs[i] = obs
            stacked = state["stacked"]
            if stacked is None:
                # the previous step's buffers, reused (valid until the
                # next step, as stacked_obs says)
                stacked = self._stacked_bufs
                if stacked is None or any(
                        stacked[k].shape[1:] != np.asarray(obs[k]).shape
                        or stacked[k].dtype != np.asarray(obs[k]).dtype
                        for k in OBS_KEYS):
                    stacked = {
                        k: np.empty((n,) + np.asarray(obs[k]).shape,
                                    np.asarray(obs[k]).dtype)
                        for k in OBS_KEYS}
                self._stacked_bufs = state["stacked"] = stacked
            for k in OBS_KEYS:
                stacked[k][i] = obs[k]
            rewards[i] = reward
            dones[i] = done
            if record is not None:
                records[i] = record

        self._drain_step_replies(on_reply)
        self.completed_episodes.extend(records[i] for i in sorted(records))
        self._stacked_cache = state["stacked"]
        return list(self.obs), rewards, dones

    def step_subset(self, indices, actions: np.ndarray):
        """Step only the workers in ``indices`` with ``actions`` (same
        length); see ``VectorEnv.step_subset``. On the shm backend a
        subset's obs ride the pipe and the parent refreshes the current
        slab row in place."""
        indices = list(indices)
        self._stacked_cache = None
        for k, i in enumerate(indices):
            self._send(i, ("step", int(actions[k])))
        rewards = np.zeros(len(indices), dtype=np.float32)
        dones = np.zeros(len(indices), dtype=bool)
        for k, i in enumerate(indices):
            _, (obs, reward, done, record) = self._recv(self._conns[i])
            if self._slabs is not None:
                self._guard_ring_write("step_subset")
                views = self._slabs.views
                for key in OBS_KEYS:
                    views[key][self._cur_row, i] = obs[key]
                self._obs_cache = None
            else:
                self.obs[i] = obs
            rewards[k] = reward
            dones[k] = done
            if record is not None:
                self.completed_episodes.append(record)
        return [self.obs[i] for i in indices], rewards, dones

    def drain_completed_episodes(self) -> List[Dict[str, Any]]:
        out, self.completed_episodes = self.completed_episodes, []
        return out

    def restart_episodes(self) -> List[Dict[str, np.ndarray]]:
        """See ``VectorEnv.restart_episodes``: workers advance their own
        seeds on the restart command and drop their partial sums."""
        if self._first_reset:
            return self.reset()
        self._stacked_cache = None
        for i in range(self.num_envs):
            self._send(i, ("restart", None))
        obs = [self._recv(conn)[1] for conn in self._conns]
        self.obs = obs
        if self._slabs is not None:
            self._write_row0(obs)
            self._obs_cache = obs
        return self.obs

    def close(self) -> None:
        """Idempotent shutdown: close acks drained under one shared
        deadline, workers reaped (join, then terminate, then kill) so a
        wedged worker cannot hang teardown, and the shm slabs unlinked
        last (their finalizers cover paths that never reach here)."""
        if self._closed:
            return
        self._closed = True
        for conn in self._conns:
            try:
                conn.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        # stale step replies may sit ahead of the ack after a worker error
        deadline = time.monotonic() + 2.0
        for conn in self._conns:
            try:
                while True:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not conn.poll(remaining):
                        break
                    kind, _ = conn.recv()
                    if kind == "closed":
                        break
            except (EOFError, BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=5)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=1)
        for conn in self._conns:
            conn.close()
        if self._ring is not None:
            if self._active_seg is None and self._slabs is not None:
                # ring installed but never leased: the pre-ring slab is
                # still ours to unlink
                self._slabs.close()
            self._ring.close()
            self._ring = None
            self._slabs = None
        if self._slabs is not None:
            self._slabs.close()
            self._slabs = None


def _has_been_reset(vec_env) -> bool:
    if isinstance(vec_env, ParallelVectorEnv):
        return not vec_env._first_reset
    return vec_env.obs is not None


class RolloutCollector:
    """Collects [T, B] trajectory batches from a ``VectorEnv`` or
    ``ParallelVectorEnv`` that its owner has reset; each collect steps the
    envs on from where the last one left them.

    ``deferred_fetch`` (the pipelined loop's schedule) changes when the
    host reads the card, never what is computed: each step's actions are
    its only read-back, the log-probabilities and values stay on the
    device until one read-back at the segment's end, and on a shm-backed
    ``ParallelVectorEnv`` the workers' in-place writes ARE the trajectory
    buffer. With ``ring_segments >= 2`` (the default for deferred fetch)
    each collect leases one segment of a trajectory ring (``rl/ring.py``)
    and returns ZERO-COPY views of its rows, published to the learner,
    whose staging must run the ring's two-phase token protocol
    (``note_staged``, ``note_update``; ``train/loops.py`` does); 0 keeps
    one slab and copies the rows out at the segment's end. The outputs are
    bit-identical to the plain schedule's.

    ``pipeline`` (an even batch of at least two envs, not with deferred
    fetch) splits the envs into two halves and interleaves them: while the
    host steps one half's simulators, the card runs the other half's
    forward. Each step's uniforms are drawn for the whole batch, as the
    plain schedule draws them, and split between the halves, so the
    envs see the same actions; each half pads to its own bucket, so its
    float results may differ from the whole batch's in the last place.
    The loops leave it off (their sequential and pipelined modes stay
    bit-equal)."""

    def __init__(self, vec_env, learner, rollout_length: int,
                 deferred_fetch: bool = False,
                 ring_segments: Optional[int] = None,
                 pipeline: bool = False):
        self.vec_env = vec_env
        self.learner = learner
        self.rollout_length = int(rollout_length)
        self.deferred_fetch = bool(deferred_fetch)
        self.pipeline = bool(pipeline) and not self.deferred_fetch
        if ring_segments is None:
            ring_segments = 2 if self.deferred_fetch else 0
        self.ring_segments = int(ring_segments)
        if (self.deferred_fetch
                and getattr(vec_env, "prefetch_stacked", None) is False):
            vec_env.prefetch_stacked = True

    def collect(self, generator: Optional[torch.Generator] = None,
                noise: Optional[np.ndarray] = None,
                model: Optional[torch.nn.Module] = None) -> Dict[str, Any]:
        """Run ``rollout_length`` steps in every env; returns a trajectory
        dict of [T, B, ...] host arrays, the bootstrap values [B], the
        completed episodes, the env steps and ``timing``: the host wall of
        env stepping (``env_s``: the simulator and candidate pricing) and
        of sampling (``sample_s``: batch assembly, the forward, K9 and the
        read-back).

        Step t's uniforms are ``noise[t]`` ([T, B, A] float32 in [tiny, 1))
        when given, else drawn from ``generator`` (a ``torch.Generator`` on
        the learner's device). ``model`` (default: the learner's) is the
        policy that acts: the pipelined IMPALA loop hands in a snapshot of
        older parameters."""
        t_len, lanes = self.rollout_length, self.vec_env.num_envs
        if (noise is None) == (generator is None):
            raise ValueError("collect needs exactly one of generator, noise")
        if not _has_been_reset(self.vec_env):
            raise ValueError("collect needs a vec env that has been reset")
        device = self.learner.device
        n_actions = np.asarray(
            self.vec_env.stacked_obs()["action_mask"]).shape[1]
        if noise is not None:
            noise = np.asarray(noise, np.float32)
            if noise.shape != (t_len, lanes, n_actions):
                raise ValueError(f"noise must be [{t_len}, {lanes}, "
                                 f"{n_actions}], got {noise.shape}")

        def uniforms(t):
            if noise is not None:
                return torch.from_numpy(noise[t]).to(device)
            return gumbel_uniforms((lanes, n_actions), generator, device)

        if self.deferred_fetch:
            return self._collect_deferred(uniforms, model)
        if self.pipeline and lanes >= 2 and lanes % 2 == 0:
            return self._collect_pipelined(uniforms, model)
        obs_buf: List[Dict[str, np.ndarray]] = []
        act_buf = np.zeros((t_len, lanes), dtype=np.int32)
        logp_buf = np.zeros((t_len, lanes), dtype=np.float32)
        val_buf = np.zeros((t_len, lanes), dtype=np.float32)
        rew_buf = np.zeros((t_len, lanes), dtype=np.float32)
        done_buf = np.zeros((t_len, lanes), dtype=bool)
        env_s = sample_s = 0.0
        for t in range(t_len):
            t0 = time.perf_counter()
            batched = stack_obs(self.vec_env.obs)
            actions, logp, values = self.learner.sample_actions(
                batched, uniforms(t), model=model)
            t1 = time.perf_counter()
            obs_buf.append(batched)
            act_buf[t] = actions
            logp_buf[t] = logp
            val_buf[t] = values
            _, rewards, dones = self.vec_env.step(actions)
            rew_buf[t] = rewards
            done_buf[t] = dones
            env_s += time.perf_counter() - t1
            sample_s += t1 - t0

        t0 = time.perf_counter()
        last_values = self.learner.values(stack_obs(self.vec_env.obs),
                                          model=model)
        sample_s += time.perf_counter() - t0
        traj_obs = {k: np.stack([o[k] for o in obs_buf]) for k in OBS_KEYS}
        return {
            "traj": {"obs": traj_obs, "actions": act_buf, "logp": logp_buf,
                     "values": val_buf, "rewards": rew_buf,
                     "dones": done_buf},
            "last_values": np.asarray(last_values, np.float32),
            "episodes": self.vec_env.drain_completed_episodes(),
            "env_steps": t_len * lanes,
            "timing": {"env_s": env_s, "sample_s": sample_s},
        }

    def _collect_pipelined(self, uniforms, model) -> Dict[str, Any]:
        """The two-half schedule (see the class docstring): half 1's
        forward of step t is dispatched before the host steps half 0, and
        half 0's forward of step t + 1 right after, so each half's
        stepping overlaps the other half's forward."""
        vec = self.vec_env
        t_len, lanes = self.rollout_length, vec.num_envs
        half = lanes // 2
        groups = [list(range(half)), list(range(half, lanes))]
        cols = [slice(0, half), slice(half, lanes)]
        obs_buf: List[List[Dict[str, np.ndarray]]] = [[], []]
        act_buf = np.zeros((t_len, lanes), dtype=np.int32)
        rew_buf = np.zeros((t_len, lanes), dtype=np.float32)
        done_buf = np.zeros((t_len, lanes), dtype=bool)
        refs: List[List[torch.Tensor]] = [[], []]  # per half: logp, values
        last: List[Optional[torch.Tensor]] = [None, None]
        env_s = sample_s = 0.0

        def sample(g, u):
            batched = stack_obs([vec.obs[i] for i in groups[g]])
            return batched, self.learner.sample_actions(
                batched, u[cols[g]], model=model, fetch=False)

        t0 = time.perf_counter()
        u = uniforms(0)
        pending = [sample(0, u), None]
        sample_s += time.perf_counter() - t0
        for t in range(t_len):
            t0 = time.perf_counter()
            pending[1] = sample(1, u)
            sample_s += time.perf_counter() - t0
            for g in (0, 1):
                t0 = time.perf_counter()
                batched, (actions, logp, values) = pending[g]
                actions = actions.cpu().numpy()  # waits on this half only
                t1 = time.perf_counter()
                obs_buf[g].append(batched)
                act_buf[t, cols[g]] = actions
                refs[g] += [logp, values]
                _, rewards, dones = vec.step_subset(groups[g], actions)
                rew_buf[t, cols[g]] = rewards
                done_buf[t, cols[g]] = dones
                t2 = time.perf_counter()
                if g == 0:
                    if t + 1 < t_len:
                        u = uniforms(t + 1)
                        pending[0] = sample(0, u)
                    else:
                        last[0] = self.learner.values(
                            stack_obs([vec.obs[i] for i in groups[0]]),
                            model=model, fetch=False)
                sample_s += (t1 - t0) + (time.perf_counter() - t2)
                env_s += t2 - t1
        t0 = time.perf_counter()
        last[1] = self.learner.values(
            stack_obs([vec.obs[i] for i in groups[1]]), model=model,
            fetch=False)
        # one read-back: per half, T x (logp, values), then the bootstraps
        packed = torch.cat([torch.stack(r).reshape(-1) for r in refs]
                           + [v.reshape(-1) for v in last]).cpu().numpy()
        sample_s += time.perf_counter() - t0
        logp_buf = np.zeros((t_len, lanes), dtype=np.float32)
        val_buf = np.zeros((t_len, lanes), dtype=np.float32)
        at = 0
        for g in (0, 1):
            width = cols[g].stop - cols[g].start
            block = packed[at:at + 2 * t_len * width].reshape(
                t_len, 2, width)
            logp_buf[:, cols[g]] = block[:, 0]
            val_buf[:, cols[g]] = block[:, 1]
            at += 2 * t_len * width
        traj_obs = {k: np.concatenate(
            [np.stack([o[k] for o in obs_buf[0]]),
             np.stack([o[k] for o in obs_buf[1]])], axis=1)
            for k in OBS_KEYS}
        return {
            "traj": {"obs": traj_obs, "actions": act_buf, "logp": logp_buf,
                     "values": val_buf, "rewards": rew_buf,
                     "dones": done_buf},
            "last_values": packed[at:].astype(np.float32),
            "episodes": vec.drain_completed_episodes(),
            "env_steps": t_len * lanes,
            "timing": {"env_s": env_s, "sample_s": sample_s},
        }

    def _collect_deferred(self, uniforms, model) -> Dict[str, Any]:
        """The deferred-fetch schedule (see the class docstring). The
        per-step sample reads the slab row as views: each step's action
        read-back finishes the forward before any row it read can be
        rewritten."""
        vec = self.vec_env
        t_len, lanes = self.rollout_length, vec.num_envs
        ring = segment = None
        if self.ring_segments >= 2:
            ensure_ring = getattr(vec, "ensure_traj_ring", None)
            if ensure_ring is not None:
                ring = ensure_ring(t_len + 1, self.ring_segments)
        if ring is not None:
            # lease the next free segment (a stall waits for the oldest
            # published one's token); its row 0 takes the current obs
            segment = ring.lease()
            vec.begin_ring_segment(segment)
            use_slab = True
        else:
            ensure = getattr(vec, "ensure_traj_rows", None)
            use_slab = bool(ensure is not None and ensure(t_len + 1))
            if use_slab:
                vec.rebase_row0()
        act_buf = np.zeros((t_len, lanes), dtype=np.int32)
        rew_buf = np.zeros((t_len, lanes), dtype=np.float32)
        done_buf = np.zeros((t_len, lanes), dtype=bool)
        traj_obs: Optional[Dict[str, np.ndarray]] = None
        logp_refs: List[torch.Tensor] = []
        val_refs: List[torch.Tensor] = []
        env_s = sample_s = 0.0
        for t in range(t_len):
            t0 = time.perf_counter()
            batched = vec.stacked_obs()
            actions, logp, values = self.learner.sample_actions(
                batched, uniforms(t), model=model, fetch=False)
            if not use_slab:
                if traj_obs is None:
                    traj_obs = {k: np.empty((t_len,) + batched[k].shape,
                                            batched[k].dtype)
                                for k in OBS_KEYS}
                # copied while the card runs this step's forward
                for k in OBS_KEYS:
                    traj_obs[k][t] = batched[k]
            actions = actions.cpu().numpy()  # the step's only read-back
            t1 = time.perf_counter()
            act_buf[t] = actions
            logp_refs.append(logp)
            val_refs.append(values)
            _, rewards, dones = vec.step(actions)
            rew_buf[t] = rewards
            done_buf[t] = dones
            env_s += time.perf_counter() - t1
            sample_s += t1 - t0
        t0 = time.perf_counter()
        if segment is not None:
            traj_obs = dict(vec.traj_obs_views(t_len))
        elif use_slab:
            # one slab: the rows are copied out, since the next collect
            # rewrites them
            traj_obs = {k: np.array(v)
                        for k, v in vec.traj_obs_views(t_len).items()}
        last = self.learner.values(vec.stacked_obs(), model=model,
                                   fetch=False)
        # one read-back for every deferred value
        packed = torch.cat([torch.stack(logp_refs).reshape(-1),
                            torch.stack(val_refs).reshape(-1),
                            last.reshape(-1)]).cpu().numpy()
        sample_s += time.perf_counter() - t0
        n = t_len * lanes
        out = {
            "traj": {"obs": traj_obs, "actions": act_buf,
                     "logp": packed[:n].reshape(t_len, lanes).astype(
                         np.float32),
                     "values": packed[n:2 * n].reshape(t_len, lanes).astype(
                         np.float32),
                     "rewards": rew_buf, "dones": done_buf},
            "last_values": packed[2 * n:].astype(np.float32),
            "episodes": vec.drain_completed_episodes(),
            "env_steps": n,
            "timing": {"env_s": env_s, "sample_s": sample_s},
        }
        if segment is not None:
            # ownership passes to the learner, which must run the ring's
            # two-phase token protocol quoting this generation
            ring.publish(segment)
            out["ring"] = ring
            out["ring_segment"] = segment
            out["ring_generation"] = segment.generation
        return out
