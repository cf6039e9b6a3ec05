"""Failure-schedule vocabulary and the completion-time inflation.

Port: a copy of ``ddls_tpu/scenarios/failures.py`` (:41-134): the window
kind codes, ``FAILURE_KIND_TO_EVENT``, ``FAILURE_KIND_NAMES``,
``ScenarioRuntime`` and the host ``inflate_duration``. The traced
``inflate_duration_jax`` has its counterpart in the device episode: the
plain walk ``sim/device_env.py`` ``scenario_adjusted`` and K25's scenario
mode (``kernels/csrc/episode.cu``).

The scenario subsystem models heterogeneous device speeds and
deterministic failure windows (worker preemption, straggler channels)
without touching the lookahead engines: every engine keeps serving the
nominal lookahead, and the scenario is applied as a pure completion-time
inflation when a lookahead is registered, once on the host
(``cluster._register_completed_lookahead``) and once in the device
episode's decision. A nominal scenario (unit speeds, no windows) is never
built, so the default path is untouched.

Model (the reference's ``docs/scenarios.md``):

- device speeds: a job progresses at ``r0 = min(speed of mounted
  servers)``. ``jct_run = nominal / r0``.
- failure windows: half-open intervals ``[t0, t1)`` on one resource
  (server or channel) during which an affected job progresses at
  ``rate`` (0.0 = full preemption, ``1/slowdown`` = straggler). Windows
  are globally pairwise non-overlapping (the spec layer checks), which
  makes the single forward pass of ``inflate_duration`` exact.

SLA admission stays failure-blind: the accept/block gate is judged on the
nominal jct, so a scenario never changes which jobs are admitted, only
when they finish.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# window kinds: int codes shared by the host inflation and the device
# walk
FAILURE_WORKER_PREEMPT = 0
FAILURE_CHANNEL_STRAGGLE = 1

# kind code -> the event kind the reference's flight recorder emits when
# the simulated clock first crosses the window's t0 (cluster.step;
# bijective)
FAILURE_KIND_TO_EVENT = {
    FAILURE_WORKER_PREEMPT: "worker_preempted",
    FAILURE_CHANNEL_STRAGGLE: "channel_degraded",
}

# spec-file spelling of the kind codes
FAILURE_KIND_NAMES = {
    "worker_preempt": FAILURE_WORKER_PREEMPT,
    "channel_straggle": FAILURE_CHANNEL_STRAGGLE,
}


class ScenarioRuntime:
    """A built scenario: dense per-server speeds + the normalized,
    t0-sorted failure windows, in the topology's dense index space
    (``hardware/topologies.py dense_tables``: ``server_index`` order for
    servers, ``channel_index`` order for channels).

    Constructed by ``spec.build_runtime``; attached to
    ``RampClusterEnvironment(scenario_runtime=...)``. ``is_nominal``
    runtimes are never built (build_runtime returns None), so any
    attached runtime implies real inflation work.
    """

    __slots__ = ("name", "fingerprint", "speeds", "windows",
                 "win_t0", "win_t1", "win_rate", "win_kind", "win_res")

    def __init__(self, name: str, fingerprint: str,
                 speeds: Sequence[float],
                 windows: Sequence[Dict[str, object]]):
        self.name = str(name)
        self.fingerprint = str(fingerprint)
        self.speeds = np.asarray(speeds, dtype=np.float64)
        self.windows: List[Dict[str, object]] = [dict(w) for w in windows]
        self.windows.sort(key=lambda w: float(w["t0"]))
        self.win_t0 = np.asarray([w["t0"] for w in self.windows], np.float64)
        self.win_t1 = np.asarray([w["t1"] for w in self.windows], np.float64)
        self.win_rate = np.asarray([w["rate"] for w in self.windows],
                                   np.float64)
        self.win_kind = [int(w["kind"]) for w in self.windows]
        self.win_res = [int(w["resource"]) for w in self.windows]

    @property
    def is_nominal(self) -> bool:
        return (not self.windows
                and bool(np.all(self.speeds == 1.0)))

    def __repr__(self) -> str:
        return (f"ScenarioRuntime({self.name!r}, fp={self.fingerprint}, "
                f"servers={len(self.speeds)}, windows={len(self.windows)})")


def inflate_duration(t_start: float, nominal: float, r0: float,
                     win_t0, win_t1, win_rate,
                     affects: Sequence[bool]) -> float:
    """Adjusted run duration for a job of NOMINAL duration starting at
    ``t_start`` on resources with min speed ``r0``, walking the sorted,
    non-overlapping failure windows once.

    Per affected window overlapping the remaining run: the time spent
    inside the window advances work at ``rate``; ``rate == 0`` (full
    preemption) pushes completion past the window end. The closed-form
    per-window update is exact because windows never overlap, so each is
    visited at most once with the final ``t_done`` already accounting
    for every earlier window.

    The device episode's walk (``sim/device_env.py``
    ``scenario_adjusted`` and K25's scenario mode) computes the same
    expressions in the same order — keep them in lockstep.
    """
    t_done = t_start + nominal / r0
    for i in range(len(win_t0)):
        if not affects[i]:
            continue
        w0 = float(win_t0[i])
        w1 = float(win_t1[i])
        r = float(win_rate[i])
        lo = w0 if w0 > t_start else t_start
        if not (lo < w1 and t_done > lo):
            continue
        remaining = t_done - lo          # run time still needed at lo
        span = w1 - lo                   # window time available
        cap = r * span                   # work the window can host
        if r > 0.0 and remaining <= cap:
            t_done = lo + remaining / r  # finishes inside the window
        else:
            t_done = w1 + (remaining - cap)
    return t_done - t_start
