"""The job banks of device collection (the counterpart of the bank helpers
of ``ddls_tpu/rl/fused.py``): ``horizon_bank_jobs`` :519 sizes a lane's
bank, ``stacked_job_banks`` :554 samples one per lane with the reference's
seed formula. The fused epoch driver itself is not ported (ROADMAP)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ddls_tpu_torch.sim.device_env import EpisodeTables, sample_job_bank


def horizon_bank_jobs(env, seed: int, explicit: Optional[int] = None) -> int:
    """Jobs per lane bank: ``explicit`` when given, else enough to cover
    the simulation horizon: the horizon over the mean of 1,000 sampled
    interarrival times, with 10% slack and a 2-sigma margin on the arrival
    count, plus 10 (a bank that runs dry ends its episodes early). The
    process-global numpy stream the distributions draw from is saved and
    restored around the draw."""
    if explicit:
        return int(explicit)
    msrt = float(env.max_simulation_run_time)
    if not np.isfinite(msrt):
        raise ValueError(
            "device collection with an unbounded max_simulation_run_time "
            "needs an explicit algo_config device_bank_jobs")
    rng_state = np.random.get_state()
    try:
        np.random.seed(seed)
        ias = np.array([env.cluster.jobs_generator.interarrival_dist.sample()
                        for _ in range(1000)], np.float64)
    finally:
        np.random.set_state(rng_state)
    mean = max(float(ias.mean()), 1e-9)
    base = msrt / mean
    return int(base * 1.1
               + 2.0 * (float(ias.std()) / mean) * np.sqrt(base)) + 10


def stacked_job_banks(et: EpisodeTables, env, n_lanes: int, n_jobs: int,
                      seed_base: int = 0) -> Dict[str, np.ndarray]:
    """One job bank per lane from ``env``'s own workload machinery, stacked
    on a leading lane axis (numpy): lane i draws with seed ``seed_base +
    7559 * i + 17``, the reference's device-collection seed formula."""
    banks = [sample_job_bank(et, env, n_jobs, seed_base + 7559 * i + 17)
             for i in range(n_lanes)]
    return {k: np.stack([b[k] for b in banks]) for k in banks[0]}
