"""Device-resident rollout collection (the counterpart of
``ddls_tpu/rl/ppo_device.py``): every lane's environment, observation,
policy forward and sampling run on the card (``sim/device_env.py``
``make_segment_fn``), a [T, B] segment a collect with no host sync inside
it; the host then reads the compact trace back once, rebuilds the
observations the forwards saw (``rebuild_obs_batch``, K26 on the card) and
hands the learner the same trajectory dict as ``RolloutCollector``."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ddls_tpu_torch.sim import device_env
from ddls_tpu_torch.sim.device_memo import (resolve_memo_cfg,
                                            summarize_counters)


class DevicePPOCollector:
    """Drop-in counterpart of ``rl/rollout.py:RolloutCollector`` whose envs
    live on the card (reference: ``DevicePPOCollector`` :22). ``banks``:
    stacked job banks ([B, J] arrays, ``rl/fused.py:stacked_job_banks``),
    one lane each; ``model`` the acting ``GNNPolicy`` on ``device``.

    ``memo_cfg`` wires the lookahead memo: ``"auto"`` (default) turns it on
    at every lane count, a ``MemoConfig`` or None forces it; the results
    do not depend on it. ``mesh`` and ``params_shardings`` (multi-device
    collection, ROADMAP A9) raise. The episodes' state and the memo live
    on the card across collects, in float32 (the reference's collection
    precision); ``device="cpu"`` runs the plain versions.
    """

    def __init__(self, et, ot, model, banks: Dict, rollout_length: int,
                 mesh=None, memo_cfg="auto", params_shardings=None, *,
                 device="cuda"):
        if mesh is not None or params_shardings is not None:
            raise ValueError(
                "device collection over a mesh or with sharded params is "
                "not ported (ROADMAP A9): collect on one device")
        self.et, self.ot, self.model = et, ot, model
        self.rollout_length = int(rollout_length)
        self.num_envs = int(np.shape(banks["type"])[0])
        self.memo_cfg = resolve_memo_cfg(memo_cfg, self.num_envs)
        self.segment = device_env.make_segment_fn(
            et, ot, model, self.rollout_length, memo_cfg=self.memo_cfg,
            device=device)
        dev = device_env.device_tables(et, device, torch.float32)
        self.dobs = device_env.device_obs(ot, dev)
        self.banks = device_env.device_bank(banks, dev)
        self.state = device_env.segment_init(et, self.banks, self.memo_cfg,
                                             device=device)
        # each lane's decisions in its running episode (episodes span
        # collects; the kernel's counters reset at done)
        self._ep_len = np.zeros(self.num_envs, np.int64)

    def collect(self, generator: Optional[torch.Generator] = None,
                uniforms=None, model=None) -> Dict[str, Any]:
        """One [T, B] segment: the learner's trajectory dict (``obs`` [T,
        B, ...] at the env's pad, ``actions``, ``logp``, ``values``,
        ``rewards``, ``dones``; host arrays), ``last_values`` [B] (the
        value head on the observations after the segment), ``env_steps``,
        ``episodes`` (the records of the episodes that ended) and
        ``timing``. K9's uniforms come from ``generator`` (a
        ``torch.Generator`` on the device) or are handed in as
        ``uniforms`` [B, T, A]; ``model`` (default: the collector's) is the
        policy that acts."""
        model = self.model if model is None else model
        t0 = time.perf_counter()
        trace, next_fields = self.segment(self.banks, self.state, uniforms,
                                          generator, model)
        obs = device_env.rebuild_obs_batch(self.dobs, trace)
        with torch.no_grad():
            gf, mask = device_env.kernel_obs(
                self.dobs, *(next_fields[name]
                             for name, _ in device_env.OBS_FIELDS))
            _, last_values = model.trunk(self.dobs.forward_batch(
                next_fields["jtype"], gf, mask))
        t1 = time.perf_counter()
        host = {k: v.cpu().numpy() for k, v in trace.items()}
        obs = {k: np.swapaxes(v.cpu().numpy(), 0, 1) for k, v in obs.items()}
        last_values = last_values.cpu().numpy().astype(np.float32)
        tb = {k: np.swapaxes(v, 0, 1) for k, v in host.items()}   # [T, B]
        traj = {"obs": obs, "actions": tb["action"].astype(np.int32),
                "logp": tb["logp"].astype(np.float32),
                "values": tb["value"].astype(np.float32),
                "rewards": tb["reward"].astype(np.float32),
                "dones": tb["done"].astype(bool)}
        t2 = time.perf_counter()
        return {"traj": traj, "last_values": last_values,
                "env_steps": self.rollout_length * self.num_envs,
                "episodes": self._harvest_episodes(tb), "trace": tb,
                "timing": {"segment_s": t1 - t0, "read_back_s": t2 - t1}}

    def memo_counters(self) -> Optional[Dict[str, float]]:
        """{hits, misses, evicts, hit_rate} summed over lanes (one
        read-back); None when the memo is off."""
        if self.state["memo"] is None:
            return None
        return summarize_counters(self.state["memo"])

    def _harvest_episodes(self, trace: Dict[str, np.ndarray]) -> List[dict]:
        """The records of the episodes that ended in the segment, from the
        traced counters ([T, B]), with the host's denominators
        (reference: ``_harvest_episodes`` :188): ``acceptance_rate`` =
        completed / arrived, ``blocking_rate`` = blocked / arrived, arrived
        counting every job that entered the queue."""
        episodes = []
        done = trace["done"]
        for t in range(done.shape[0]):
            self._ep_len += 1
            for b in np.nonzero(done[t])[0]:
                blk = int(trace["ep_blocked"][t, b])
                com = int(trace["ep_completed"][t, b])
                arr = int(trace["ep_arrived"][t, b])
                episodes.append({
                    "env_index": int(b),
                    "episode_return": float(trace["ep_return"][t, b]),
                    "episode_length": int(self._ep_len[b]),
                    "num_jobs_arrived": arr,
                    "num_jobs_completed": com,
                    "num_jobs_blocked": blk,
                    "acceptance_rate": com / arr if arr else 0.0,
                    "blocking_rate": blk / arr if arr else 0.0,
                })
                self._ep_len[b] = 0
        return episodes
