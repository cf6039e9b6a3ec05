"""Minimal observation/action space descriptions.

gym is not a dependency of this framework (the reference subclasses gym.Env;
here environments follow the same reset/step protocol with these lightweight
space descriptors, which carry everything the JAX models need: shapes and
dtypes for building padded device arrays).

Port: a copy of ``ddls_tpu/envs/spaces.py`` with its imports pointed at
``ddls_tpu_torch``.
"""
from __future__ import annotations

from typing import Dict as TDict

import numpy as np


class Space:
    def sample(self):
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


class Discrete(Space):
    def __init__(self, n: int):
        self.n = int(n)

    def sample(self) -> int:
        return int(np.random.randint(self.n))

    def contains(self, x) -> bool:
        return 0 <= int(x) < self.n

    def __repr__(self):
        return f"Discrete({self.n})"


class Box(Space):
    def __init__(self, low, high, shape, dtype=np.float32):
        self.low = low
        self.high = high
        self.shape = tuple(shape)
        self.dtype = dtype

    def sample(self):
        return np.random.uniform(self.low, self.high,
                                 size=self.shape).astype(self.dtype)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return x.shape == self.shape

    def __repr__(self):
        return f"Box(low={self.low}, high={self.high}, shape={self.shape})"


class Dict(Space):
    def __init__(self, spaces: TDict[str, Space]):
        self.spaces = dict(spaces)

    def sample(self):
        return {k: s.sample() for k, s in self.spaces.items()}

    def contains(self, x) -> bool:
        return all(k in x for k in self.spaces)

    def items(self):
        return self.spaces.items()

    def __getitem__(self, key):
        return self.spaces[key]

    def __repr__(self):
        return f"Dict({self.spaces})"
