"""Stochastic workload parameter distributions.

Counterpart of the reference's ``ddls/distributions/`` package. Each
distribution exposes ``sample(size=None)`` returning a scalar (size=None) or an
ndarray. (Reference: ddls/distributions/{fixed,uniform,probability_mass_function,
custom_skew_norm,list_of_distributions}.py.)

Note the reference's Uniform references an undefined name in its
negative-decimals branch (SURVEY.md §7.5); here negative ``decimals`` rounds to
tens/hundreds/... as presumably intended.

Port: a copy of ``ddls_tpu/demands/distributions.py`` without the
trace-driven ``LoadgenInterarrival`` (it replays ``serve/loadgen.py``,
which is not ported); a config that names it raises in
``utils.get_class_from_path``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np


class Distribution:
    def sample(self, size: Optional[int] = None):
        raise NotImplementedError


class Fixed(Distribution):
    def __init__(self, val: Union[int, float], **kwargs):
        self.val = val

    def sample(self, size: Optional[int] = None):
        if size is None:
            return self.val
        return np.full(size, self.val)


class Uniform(Distribution):
    def __init__(self,
                 min_val: Union[int, float],
                 max_val: Union[int, float],
                 decimals: Optional[int] = None,
                 **kwargs):
        self.min_val = min_val
        self.max_val = max_val
        self.decimals = decimals

    def sample(self, size: Optional[int] = None):
        val = np.random.uniform(self.min_val, self.max_val, size=size)
        if self.decimals is not None:
            val = np.round(val, self.decimals)
        if size is None:
            return float(val)
        return val


class ProbabilityMassFunction(Distribution):
    def __init__(self, probability_mass_function: dict, **kwargs):
        self.values = np.array(list(probability_mass_function.keys()), dtype=float)
        probs = np.array(list(probability_mass_function.values()), dtype=float)
        self.probs = probs / probs.sum()

    def sample(self, size: Optional[int] = None):
        val = np.random.choice(self.values, size=size, p=self.probs)
        if size is None:
            return float(val)
        return val


class CustomSkewNorm(Distribution):
    """Skew-normal samples rescaled into [min_val, max_val]."""

    def __init__(self,
                 skewness: float,
                 min_val: Union[int, float],
                 max_val: Union[int, float],
                 decimals: Optional[int] = None,
                 num_cached_samples: int = 10000,
                 **kwargs):
        from scipy.stats import skewnorm

        self.min_val = min_val
        self.max_val = max_val
        self.decimals = decimals
        raw = skewnorm.rvs(a=skewness, size=num_cached_samples)
        raw = raw - raw.min()
        raw = raw / raw.max()
        self._pool = raw * (max_val - min_val) + min_val

    def sample(self, size: Optional[int] = None):
        val = np.random.choice(self._pool, size=size)
        if self.decimals is not None:
            val = np.round(val, self.decimals)
        if size is None:
            return float(val)
        return val


class ListOfDistributions(Distribution):
    """Uniformly sample one of several distributions; ``sample()`` returns the
    chosen Distribution object (used to vary the max-JCT-frac dist between
    episodes, reference: ddls/distributions/list_of_distributions.py)."""

    def __init__(self, name_to_cls_to_kwargs: dict, **kwargs):
        from ddls_tpu_torch.utils import get_class_from_path

        self.distributions = []
        for cls_to_kwargs in name_to_cls_to_kwargs.values():
            for cls_path, cls_kwargs in cls_to_kwargs.items():
                self.distributions.append(get_class_from_path(cls_path)(**cls_kwargs))

    def sample(self, size: Optional[int] = None):
        idx = np.random.randint(len(self.distributions))
        return self.distributions[idx]


def make_distribution(spec) -> Distribution:
    """Instantiate a Distribution from a ``{'_target_': path, **kwargs}`` dict
    (the reference's hand-rolled hydra instantiation,
    ddls/demands/jobs/jobs_generator.py:125-130) or pass through an object."""
    if isinstance(spec, Distribution):
        return spec
    if isinstance(spec, dict):
        if "_target_" not in spec:
            raise ValueError("distribution dict spec requires a '_target_' key")
        from ddls_tpu_torch.utils import get_class_from_path

        kwargs = {k: v for k, v in spec.items() if k != "_target_"}
        return get_class_from_path(spec["_target_"])(**kwargs)
    raise TypeError(f"cannot build a Distribution from {spec!r}")
