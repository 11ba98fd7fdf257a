"""Search-space primitives + config sampling.

Reference parity: ``ray.tune`` sampling domains — ``grid_search`` takes
the cross product (repeated ``num_samples`` times), stochastic domains
(``choice/uniform/loguniform/randint``) draw per sample
(``python/ray/tune/search/``; mount empty).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np


@dataclass(frozen=True)
class GridSearch:
    values: tuple

    def __iter__(self):
        return iter(self.values)


@dataclass(frozen=True)
class Domain:
    kind: str
    a: Any = None
    b: Any = None
    values: tuple = ()

    def sample(self, rng: np.random.Generator):
        if self.kind == "choice":
            return self.values[rng.integers(0, len(self.values))]
        if self.kind == "uniform":
            return float(rng.uniform(self.a, self.b))
        if self.kind == "loguniform":
            return float(np.exp(rng.uniform(np.log(self.a),
                                            np.log(self.b))))
        if self.kind == "randint":
            return int(rng.integers(self.a, self.b))
        raise ValueError(self.kind)


def grid_search(values: Sequence) -> GridSearch:
    return GridSearch(tuple(values))


def choice(values: Sequence) -> Domain:
    return Domain("choice", values=tuple(values))


def uniform(a: float, b: float) -> Domain:
    return Domain("uniform", a, b)


def loguniform(a: float, b: float) -> Domain:
    return Domain("loguniform", a, b)


def randint(a: int, b: int) -> Domain:
    return Domain("randint", a, b)


def expand(param_space: dict, num_samples: int, seed: int) -> list[dict]:
    """Concrete trial configs: the grid cross-product, each point
    repeated ``num_samples`` times with stochastic domains re-drawn."""
    rng = np.random.default_rng(seed)
    grid_keys = [k for k, v in param_space.items()
                 if isinstance(v, GridSearch)]
    grids = [list(param_space[k].values) for k in grid_keys]
    points = list(itertools.product(*grids)) if grid_keys else [()]
    configs: list[dict] = []
    for _ in range(num_samples):
        for point in points:
            cfg = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    cfg[k] = point[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            configs.append(cfg)
    return configs
