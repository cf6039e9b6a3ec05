"""Small shared utilities of the port's simulator and loops.

Counterpart of ``ddls_tpu/utils/common.py``, trimmed to what the
simulator copy and the epoch loop call: ``SqliteDict`` and the log
writers (``save_logs_to_dir``, ``snapshot_logs``), ``Stopwatch``,
``seed_everything``, ``get_class_from_path``, ``unique_experiment_dir``
and ``recursive_update``. ``prng_key`` (a JAX key) stays out.

``get_class_from_path`` never imports the JAX package: the configs'
``_target_`` paths name ``ddls_tpu.*`` (and the reference's ``ddls.*``)
classes, and an explicit table maps each one this port has onto its
``ddls_tpu_torch`` counterpart. A path outside the table and outside
``ddls_tpu_torch`` raises.
"""
from __future__ import annotations

import glob
import importlib
import pathlib
import pickle
import random
import sqlite3
from typing import Any, Mapping

import numpy as np


class SqliteDict:
    """Minimal persistent dict over stdlib sqlite3 (sqlitedict stand-in used
    by the reference's Logger/cluster save paths)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._conn = sqlite3.connect(self.path)
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (key TEXT PRIMARY KEY, val BLOB)")
        self._conn.commit()

    def __setitem__(self, key: str, value: Any) -> None:
        self._conn.execute(
            "REPLACE INTO kv (key, val) VALUES (?, ?)",
            (key, pickle.dumps(value)))

    def __getitem__(self, key: str) -> Any:
        row = self._conn.execute(
            "SELECT val FROM kv WHERE key = ?", (key,)).fetchone()
        if row is None:
            raise KeyError(key)
        return pickle.loads(row[0])

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def keys(self):
        return [r[0] for r in
                self._conn.execute("SELECT key FROM kv").fetchall()]

    def commit(self) -> None:
        self._conn.commit()

    def close(self) -> None:
        self._conn.commit()
        self._conn.close()


def save_logs_to_dir(out_dir, logs: Mapping[str, Mapping[str, Any]],
                     use_sqlite: bool) -> None:
    """Write each named log dict into ``out_dir`` as either a gzip pickle
    or a SqliteDict database. Callers must pass a SNAPSHOT (not live,
    still-mutating dicts) when invoking this from a background thread."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for log_name, log in logs.items():
        if use_sqlite:
            db = SqliteDict(str(out_dir / f"{log_name}.sqlite"))
            try:
                for key, val in dict(log).items():
                    db[key] = val
                db.commit()
            finally:
                db.close()
        else:
            import gzip

            with gzip.open(out_dir / f"{log_name}.pkl", "wb") as f:
                pickle.dump(dict(log), f)


def snapshot_logs(logs: Mapping[str, Mapping[str, Any]]
                  ) -> dict:
    """Shallow-copy each log's dict and list values on the calling thread
    so a background writer never races the simulator's mutations."""
    return {name: {k: (list(v) if isinstance(v, list) else v)
                   for k, v in log.items()}
            for name, log in logs.items()}


class Stopwatch:
    """Simulated wall clock (reference: ddls/utils.py:485)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._time = 0.0

    def tick(self, amount: float = 1.0) -> None:
        self._time += amount

    def time(self) -> float:
        return self._time


def available_cores() -> int:
    """CPU cores this process may use (affinity-aware where supported)."""
    import os

    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


def seed_everything(seed: int, torch_too: bool = False) -> None:
    """Seed numpy + stdlib random (the simulator's global streams: the
    job sampler and the distributions draw from them), and torch's default
    generators too when ``torch_too`` is set. The port's learner and
    collector take explicit ``torch.Generator``s instead."""
    np.random.seed(seed)
    random.seed(seed)
    if torch_too:
        import torch

        torch.manual_seed(seed)


def get_class_from_path(path: str):
    """The class a config's dotted ``_target_`` path names, as the port
    has it (see the module docstring)."""
    if not path.startswith("ddls_tpu_torch."):
        if path not in CLASS_PATHS:
            raise ValueError(
                f"{path!r} names no class of the port (ported classes: "
                f"{sorted(CLASS_PATHS)})")
        path = CLASS_PATHS[path]
    module_path, _, name = path.rpartition(".")
    module = importlib.import_module(module_path)
    return getattr(module, name)


_PORTED = (
    "hardware.devices.A100", "hardware.devices.GPU",
    "hardware.devices.TPUv4", "hardware.devices.TPUv5e",
    "demands.distributions.Fixed", "demands.distributions.Uniform",
    "demands.distributions.ProbabilityMassFunction",
    "demands.distributions.CustomSkewNorm",
    "demands.distributions.ListOfDistributions",
    "envs.partitioning_env.RampJobPartitioningEnvironment",
    "envs.baselines.FixedDegreePacking",
    "train.loops.RLEpochLoop",
)
# ddls_tpu.<path> and the reference's ddls.<path> -> ddls_tpu_torch.<path>
CLASS_PATHS = {f"ddls_tpu.{p}": f"ddls_tpu_torch.{p}" for p in _PORTED}
CLASS_PATHS.update({
    "ddls.devices.processors.gpus.A100.A100":
        "ddls_tpu_torch.hardware.devices.A100",
    "ddls.distributions.fixed.Fixed":
        "ddls_tpu_torch.demands.distributions.Fixed",
    "ddls.distributions.uniform.Uniform":
        "ddls_tpu_torch.demands.distributions.Uniform",
    "ddls.distributions.probability_mass_function.ProbabilityMassFunction":
        "ddls_tpu_torch.demands.distributions.ProbabilityMassFunction",
    "ddls.distributions.custom_skew_norm.CustomSkewNorm":
        "ddls_tpu_torch.demands.distributions.CustomSkewNorm",
    "ddls.distributions.list_of_distributions.ListOfDistributions":
        "ddls_tpu_torch.demands.distributions.ListOfDistributions",
    "ddls.environments.ramp_job_partitioning."
    "ramp_job_partitioning_environment.RampJobPartitioningEnvironment":
        "ddls_tpu_torch.envs.partitioning_env."
        "RampJobPartitioningEnvironment",
})


def unique_experiment_dir(base: str, name: str) -> str:
    """Create ``base/name/name_<i>/`` with the next free integer suffix
    (reference: ddls/utils.py:530)."""
    root = pathlib.Path(base) / name
    root.mkdir(parents=True, exist_ok=True)
    taken = []
    for item in glob.glob(str(root / f"{name}_*")):
        tail = item.rsplit("_", 1)[-1]
        if tail.isdigit():
            taken.append(int(tail))
    idx = max(taken) + 1 if taken else 0
    out = root / f"{name}_{idx}"
    out.mkdir(parents=True, exist_ok=False)
    return str(out)


def recursive_update(base: dict, overrides: Mapping[str, Any]) -> dict:
    """Deep-merge ``overrides`` into ``base`` (reference: ddls/utils.py:577)."""
    for key, val in overrides.items():
        if key in base and isinstance(base[key], dict) and isinstance(val, Mapping):
            recursive_update(base[key], val)
        else:
            base[key] = val
    return base
