"""Hyperparameter distributions and sampling spaces (automl/ParamSpace.scala).

The port's copy of ``mmlspark_tpu/automl/params.py``: numpy draws from
``default_rng(seed)``, so the sampled settings are the reference's."""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import numpy as np


class Dist:
    """A sampling distribution over one hyperparameter."""

    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError

    def grid_values(self) -> List[Any]:
        raise NotImplementedError


class RangeHyperParam(Dist):
    """Uniform over [lo, hi]; integer-valued when both ends are ints
    (RangeHyperParam in ParamSpace.scala)."""

    def __init__(self, lo, hi, seed: int = 0):
        self.lo, self.hi = lo, hi
        self.is_int = isinstance(lo, int) and isinstance(hi, int)

    def sample(self, rng):
        if self.is_int:
            return int(rng.integers(self.lo, self.hi + 1))
        return float(rng.uniform(self.lo, self.hi))

    def grid_values(self, n: int = 3) -> List[Any]:
        if self.is_int:
            return sorted({int(v) for v in np.linspace(self.lo, self.hi, n)})
        return [float(v) for v in np.linspace(self.lo, self.hi, n)]


class DiscreteHyperParam(Dist):
    """Uniform over an explicit value list (DiscreteHyperParam)."""

    def __init__(self, values: Sequence[Any], seed: int = 0):
        self.values = list(values)

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]

    def grid_values(self) -> List[Any]:
        return list(self.values)


class HyperparamBuilder:
    """Collects (estimator, param-name) -> Dist entries
    (automl/HyperparamBuilder + the Python overlay HyperparamBuilder.py)."""

    def __init__(self):
        self._entries: List[Tuple[Any, str, Dist]] = []

    def add_hyperparam(self, estimator, param_name: str, dist: Dist
                       ) -> "HyperparamBuilder":
        estimator.param(param_name)  # validate it exists
        self._entries.append((estimator, param_name, dist))
        return self

    def build(self) -> List[Tuple[Any, str, Dist]]:
        return list(self._entries)


class ParamSpace:
    """Random sampling space: infinite iterator of param settings."""

    def __init__(self, entries: List[Tuple[Any, str, Dist]], seed: int = 0):
        self.entries = entries
        self.seed = seed

    def param_maps(self) -> Iterator[List[Tuple[Any, str, Any]]]:
        rng = np.random.default_rng(self.seed)
        while True:
            yield [(est, name, dist.sample(rng)) for est, name, dist in self.entries]


class GridSpace:
    """Exhaustive cartesian grid over each Dist's grid values."""

    def __init__(self, entries: List[Tuple[Any, str, Dist]]):
        self.entries = entries

    def param_maps(self) -> Iterator[List[Tuple[Any, str, Any]]]:
        grids = [d.grid_values() for _, _, d in self.entries]
        for combo in itertools.product(*grids):
            yield [(est, name, v)
                   for (est, name, _), v in zip(self.entries, combo)]

    def space_size(self) -> int:
        out = 1
        for _, _, d in self.entries:
            out *= len(d.grid_values())
        return out
