"""Resource quantities, requests, and per-node resource state.

Reference parity: upstream Ray models resource quantities as ``FixedPoint``
(integer, 1e-4 granularity) inside ``ResourceSet``/``ResourceRequest``/
``NodeResources`` (``src/ray/common/scheduling/fixed_point.h``,
``resource_request.h``, ``cluster_resource_data.h``).  [Cited per SURVEY.md §1
layer 1 / §2.1; reference mount empty, line numbers unavailable.]

TPU-first contract
------------------
Quantities are **int32 centi-units** (``cu`` = value x 100, granularity 0.01).
The granularity is coarser than the reference's 1e-4 by design: it bounds the
integer magnitudes so that the scheduling score

    score_fp = ((used + req) * SCALE) // total        (SCALE = 2**12)

can be computed **exactly in int32 on the device** (no int64, which TPUs lack
without jax_enable_x64; no float division, which XLA does not guarantee to be
bit-identical across platforms).  With per-node per-resource totals capped at
``MAX_TOTAL_CU = 2**17`` cu (= 1310.72 units) the intermediate
``(used + req) * SCALE <= 2*2**17*2**12 = 2**30`` never overflows int32.  The
CPU oracle uses the identical integer formulas, which is what makes
bit-for-bit parity a property instead of a hope (SURVEY §7 hard part 5).

Memory-like resources are therefore expressed in GiB (so "memory": 128 means
128 GiB, well under the cap), not bytes as in the reference.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

# --- fixed-point quantity contract -----------------------------------------
CU_PER_UNIT = 100                  # centi-units per resource unit
MAX_TOTAL_CU = 1 << 17             # per-node, per-resource cap (int32 safety)

# Predefined resource names get the first dense columns, in this order, so
# that column indices are stable across hosts without coordination.
PREDEFINED_RESOURCES = ("CPU", "GPU", "TPU", "memory", "object_store_memory")

# Resources whose *unit* is implicit GiB in user-facing dicts.
_GIB_RESOURCES = frozenset({"memory", "object_store_memory"})


def to_cu(value: float | int) -> int:
    """Quantize a user-facing quantity to centi-units (round half up)."""
    if value < 0:
        raise ValueError(f"negative resource quantity: {value}")
    cu = int(float(value) * CU_PER_UNIT + 0.5)  # round half up, not banker's
    if cu > MAX_TOTAL_CU:
        raise ValueError(
            f"resource quantity {value} exceeds cap "
            f"{MAX_TOTAL_CU / CU_PER_UNIT} units (int32 score-arithmetic "
            f"contract, see module docstring)")
    return cu


def from_cu(cu: int) -> float:
    return cu / CU_PER_UNIT


class ResourceIndex:
    """Stable mapping resource-name <-> dense column index.

    The device kernels operate on dense ``(nodes, R)`` arrays; this registry
    assigns each resource name (predefined first, then custom in first-seen
    order) a column.  Mirrors the reference's ``ResourceID`` interning
    (``src/ray/common/scheduling/scheduling_ids.h``) [SURVEY §2.1, unverified].
    """

    def __init__(self, extra: Iterable[str] = ()):
        self._names: list[str] = list(PREDEFINED_RESOURCES)
        self._index: dict[str, int] = {n: i for i, n in enumerate(self._names)}
        for name in extra:
            self.get_or_add(name)

    def get_or_add(self, name: str) -> int:
        idx = self._index.get(name)
        if idx is None:
            idx = len(self._names)
            self._names.append(name)
            self._index[name] = idx
        return idx

    def get(self, name: str) -> int | None:
        return self._index.get(name)

    def name(self, idx: int) -> str:
        return self._names[idx]

    @property
    def num_resources(self) -> int:
        return len(self._names)

    def names(self) -> tuple[str, ...]:
        return tuple(self._names)


class ResourceRequest:
    """An immutable demand vector (what a task/actor/bundle asks for).

    Reference: ``src/ray/common/scheduling/resource_request.h`` [SURVEY §2.1].
    """

    __slots__ = ("_cu", "_key")

    def __init__(self, resources: Mapping[str, float] | None = None):
        cu: dict[str, int] = {}
        for name, value in (resources or {}).items():
            q = to_cu(value)
            if q:
                cu[name] = q
        self._cu = cu
        self._key = tuple(sorted(cu.items()))

    @classmethod
    def from_cu_dict(cls, cu: Mapping[str, int]) -> "ResourceRequest":
        req = cls.__new__(cls)
        req._cu = {k: int(v) for k, v in cu.items() if v}
        req._key = tuple(sorted(req._cu.items()))
        return req

    def cu(self) -> Mapping[str, int]:
        return dict(self._cu)

    def is_empty(self) -> bool:
        return not self._cu

    def to_dict(self) -> dict[str, float]:
        return {k: from_cu(v) for k, v in self._cu.items()}

    def dense(self, index: ResourceIndex, width: int | None = None) -> np.ndarray:
        """Dense int32 cu vector under ``index`` (interning unseen names)."""
        cols = {index.get_or_add(name): q for name, q in self._cu.items()}
        w = width if width is not None else index.num_resources
        vec = np.zeros(w, dtype=np.int32)
        for col, q in cols.items():
            vec[col] = q
        return vec

    # scheduling-class identity: tasks with equal keys are batch-groupable
    def key(self) -> tuple:
        return self._key

    def __eq__(self, other):
        return isinstance(other, ResourceRequest) and other._key == self._key

    def __hash__(self):
        return hash(self._key)

    def __repr__(self):
        return f"ResourceRequest({self.to_dict()})"


class NodeResources:
    """Total + available capacity and labels for one node.

    Reference: ``NodeResources`` in
    ``src/ray/common/scheduling/cluster_resource_data.h`` [SURVEY §2.1].
    """

    __slots__ = ("total_cu", "available_cu", "labels")

    def __init__(self, total: Mapping[str, float],
                 labels: Mapping[str, str] | None = None):
        self.total_cu: dict[str, int] = {
            k: to_cu(v) for k, v in total.items() if to_cu(v)}
        self.available_cu: dict[str, int] = dict(self.total_cu)
        self.labels: dict[str, str] = dict(labels or {})

    # -- queries ------------------------------------------------------------
    def is_feasible(self, req: ResourceRequest) -> bool:
        return all(self.total_cu.get(k, 0) >= q for k, q in req.cu().items())

    def is_available(self, req: ResourceRequest) -> bool:
        return all(self.available_cu.get(k, 0) >= q
                   for k, q in req.cu().items())

    # -- mutation (local resource manager) ----------------------------------
    def allocate(self, req: ResourceRequest) -> bool:
        if not self.is_available(req):
            return False
        for k, q in req.cu().items():
            self.available_cu[k] -= q
        return True

    def free(self, req: ResourceRequest) -> None:
        for k, q in req.cu().items():
            self.available_cu[k] = min(
                self.total_cu.get(k, 0), self.available_cu.get(k, 0) + q)

    def to_dict(self) -> dict:
        return {
            "total": {k: from_cu(v) for k, v in self.total_cu.items()},
            "available": {k: from_cu(v) for k, v in self.available_cu.items()},
            "labels": dict(self.labels),
        }

    def __repr__(self):
        return f"NodeResources({self.to_dict()})"
