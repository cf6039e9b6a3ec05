"""Scenario subsystem: one declarative spec, the port's conforming backends.

Port of ``ddls_tpu/scenarios``. ``spec.ScenarioSpec`` names a fabric, a
workload, device speeds and a deterministic failure schedule;
``conformance.run_conformance`` holds the port's host, C++, array-engine
and device-episode backends to each other on it (``python -m
ddls_tpu_torch.scenarios.conformance --json``). The reference's traced
``inflate_duration_jax`` has its counterpart in the device episode
(``sim/device_env.py`` ``scenario_adjusted`` and K25's scenario mode).
"""
from ddls_tpu_torch.scenarios.failures import (FAILURE_CHANNEL_STRAGGLE,
                                               FAILURE_KIND_TO_EVENT,
                                               FAILURE_WORKER_PREEMPT,
                                               ScenarioRuntime,
                                               inflate_duration)
from ddls_tpu_torch.scenarios.spec import (REGISTRY, ScenarioError,
                                           ScenarioSpec, build_runtime,
                                           canonical_spec, env_kwargs,
                                           failures_spec, get_spec,
                                           multi_channel_spec,
                                           resolve_failure_windows,
                                           spec_fingerprint, validate_spec)

__all__ = [
    "FAILURE_CHANNEL_STRAGGLE", "FAILURE_KIND_TO_EVENT",
    "FAILURE_WORKER_PREEMPT", "ScenarioRuntime", "inflate_duration",
    "REGISTRY", "ScenarioError", "ScenarioSpec", "build_runtime",
    "canonical_spec", "env_kwargs", "failures_spec", "get_spec",
    "multi_channel_spec", "resolve_failure_windows", "spec_fingerprint",
    "validate_spec",
]
