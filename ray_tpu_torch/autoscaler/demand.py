"""Autoscaler demand packing — CPU reference oracle (north-star config #5).

Reference parity: upstream's ``ResourceDemandScheduler`` (autoscaler v1,
``python/ray/autoscaler/_private/resource_demand_scheduler.py``; same
semantics in v2's ``Scheduler``) answers "given pending resource demands and
the available node types, how many nodes of each type to launch": it first
bin-packs demands onto existing nodes' free capacity, then greedily adds
virtual nodes of the type scoring best by a utilization scorer until demands
are met or per-type quotas are hit.  [SURVEY.md §1 layer 11 / §2.2 / §4
autoscaler tier; reference mount empty — the exact scorer and traversal are
re-derived as the deterministic contract below, which the device program in
ray_tpu_torch/ops/binpack_kernel.py matches bit-for-bit.]

The contract
------------
Inputs: existing cluster state, demand classes ``(G, R)`` with counts
``(G,)``, node types ``(K, R)`` capacities with launch quotas ``(K,)``.

Phase 1 — fit on existing nodes: FIRST-FIT in node-row order, demands in
class order.  This is exactly the hybrid contract with the spread threshold
above the maximum possible score (every available node ties at eff 0 and
wins by traversal index) and ``require_available`` semantics (an unfit
demand is a leftover, never queued) — so phase 1 IS the water-fill kernel.

Phase 2 — launch loop over leftovers, repeated until done/stuck:
  1. For each type k with quota left, FIRST-FIT one fresh node of type k
     over the remaining classes in class order -> packed counts p_k (G,),
     utilization score s_k = max_i (used_i * SCALE) // cap_i.
  2. Choose the type maximizing (s_k, -k) among those packing > 0 units
     (best packing; deterministic low-index tie-break).
  3. Batch-repeat: launch t = min(quota_k, min_{g: p_g>0} remaining_g // p_g,
     floored at 1) identical nodes at once; subtract t * p_k.
The batch-repeat factor is part of the contract (both implementations take
it), bounding the loop at O(G*K + G + K) iterations regardless of demand
counts — that is what makes 1M pending demands a device-friendly problem.

All-zero demand rows never launch nodes (dropped up front).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..scheduling.contract import SCALE
from ..scheduling.oracle import ClusterState, schedule_grouped_oracle

# The smallest spread threshold above the max score (2*SCALE = 2x
# utilization) turns the hybrid policy into first-fit-by-traversal-order.
# Exactly 2*SCALE + 1 in fixed point: any higher (e.g. 4*SCALE) pushes
# (L+1)*totals in the kernel's slot-count inversion past int31 for max-cap
# nodes (contract.py width audit).
FIRST_FIT_THRESHOLD = (2 * SCALE + 1) / SCALE


@dataclass(frozen=True)
class NodeTypeSpec:
    """One launchable node type (resources in user units, quota in nodes)."""

    name: str
    resources: dict[str, float]
    max_workers: int


def fit_existing(state: ClusterState, demand_reqs: np.ndarray,
                 demand_counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Phase 1. Returns (fit counts (G, N+1), leftover per class (G,)).

    Mutates ``state.avail`` (the fitted demands hold those resources).
    """
    counts = schedule_grouped_oracle(
        state, demand_reqs, demand_counts,
        spread_threshold=FIRST_FIT_THRESHOLD, require_available=True)
    return counts, counts[:, -1].copy()


def pack_one_node(cap: np.ndarray, demand_reqs: np.ndarray,
                  remaining: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First-fit one fresh node: (packed (G,), used (R,))."""
    R = cap.shape[0]
    used = np.zeros(R, dtype=np.int64)
    packed = np.zeros(remaining.shape[0], dtype=np.int64)
    for g in range(demand_reqs.shape[0]):
        if remaining[g] <= 0:
            continue
        req = demand_reqs[g].astype(np.int64)
        pos = req > 0
        if not pos.any():
            continue                       # zero demands never pack
        fit = ((cap.astype(np.int64) - used)[pos] // req[pos]).min()
        fit = min(max(fit, 0), int(remaining[g]))
        used += fit * req
        packed[g] = fit
    return packed, used


def _type_score(cap: np.ndarray, used: np.ndarray) -> int:
    """Fixed-point critical-resource utilization of a packed node."""
    pos = cap > 0
    if not pos.any():
        return 0
    return int(((used[pos] * SCALE) // cap[pos]).max())


def get_nodes_to_launch(state: ClusterState, demand_reqs: np.ndarray,
                        demand_counts: np.ndarray, type_caps: np.ndarray,
                        type_quotas: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full demand-scheduler pass.

    demand_reqs: (G, R) int32 cu.  demand_counts: (G,) int.
    type_caps: (K, R) int32 cu.  type_quotas: (K,) int.
    Returns (launches (K,), fit counts (G, N+1), unmet (G,)).
    Mutates ``state.avail`` for phase-1 fits.
    """
    demand_reqs = np.asarray(demand_reqs, dtype=np.int32)
    type_caps = np.asarray(type_caps, dtype=np.int32)
    fit_counts, remaining = fit_existing(state, demand_reqs, demand_counts)
    remaining = remaining.astype(np.int64)

    K = type_caps.shape[0]
    launches = np.zeros(K, dtype=np.int64)
    quota = np.asarray(type_quotas, dtype=np.int64).copy()
    zero_rows = ~(demand_reqs > 0).any(axis=1)
    remaining[zero_rows] = 0

    while remaining.sum() > 0:
        best_k, best_score, best_packed = -1, -1, None
        for k in range(K):
            if quota[k] <= 0:
                continue
            packed, used = pack_one_node(type_caps[k], demand_reqs,
                                         remaining)
            if packed.sum() == 0:
                continue
            score = _type_score(type_caps[k].astype(np.int64), used)
            if score > best_score:
                best_k, best_score, best_packed = k, score, packed
        if best_k < 0:
            break
        p = best_packed
        nz = p > 0
        t = int(min(quota[best_k], (remaining[nz] // p[nz]).min()))
        t = max(t, 1)
        launches[best_k] += t
        quota[best_k] -= t
        remaining = remaining - t * p
        np.clip(remaining, 0, None, out=remaining)

    return launches.astype(np.int32), fit_counts, remaining
