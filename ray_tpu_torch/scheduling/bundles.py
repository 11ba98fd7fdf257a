"""Bundle (placement-group) scheduling — CPU reference oracle.

Reference parity: upstream Ray's gang scheduler places a placement group's
bundles atomically via ``BundleSchedulingPolicy`` variants —
``BundlePackSchedulingPolicy``, ``BundleSpreadSchedulingPolicy``,
``BundleStrictPackSchedulingPolicy``, ``BundleStrictSpreadSchedulingPolicy``
(``src/ray/raylet/scheduling/policy/bundle_scheduling_policy.cc``, invoked
from ``GcsPlacementGroupScheduler::ScheduleUnplacedBundles``).  [SURVEY.md
§3.5 / §2.1 scheduling row; reference mount empty — semantics re-derived
from the survey's behavioral description: "STRICT_SPREAD: <=1 bundle/node;
STRICT_PACK: all on one; PACK/SPREAD: soft scoring".]

The contract (shared with the device kernel in ray_tpu/ops/bundle_kernel.py)
------------------------------------------------------------------------
Bundles are placed in index order on a snapshot of ``avail``; placement is
all-or-nothing (the caller then runs 2-phase prepare/commit against the
chosen nodes).  Reservation CONSUMES resources, so a bundle may only land on
an *available* node (unlike task scheduling's feasible-queue fallback).

* STRICT_PACK   — one node must hold the elementwise sum of all bundles;
                  chosen by the hybrid key of the summed request.
* STRICT_SPREAD — each bundle goes to a distinct node; bundle b's key is the
                  hybrid key masked to nodes without earlier bundles.
* PACK (soft)   — bundle b first tries nodes already holding one of this
                  group's bundles (min hybrid key among them); if none is
                  available it falls back to all nodes.
* SPREAD (soft) — mirror image: first tries nodes NOT yet holding one of
                  this group's bundles, falls back to reuse.

Soft preference is a two-pass masked argmin, NOT a key-bit: availability
must dominate preference, and the int32 key has no spare bits between the
availability bucket and the score field (contract.py layout).
"""

from __future__ import annotations

import enum

import numpy as np

from .contract import AVAIL_SHIFT, INFEASIBLE_KEY, compute_keys, threshold_fp
from .oracle import ClusterState


class PlacementStrategy(enum.Enum):
    PACK = 0
    SPREAD = 1
    STRICT_PACK = 2
    STRICT_SPREAD = 3


def _best_available(totals, avail, req, thr_fp, mask) -> int:
    """Row of the min-key AVAILABLE node under ``mask``, or -1."""
    keys = compute_keys(totals, avail, req, thr_fp, mask)
    node = int(np.argmin(keys))
    if keys[node] == INFEASIBLE_KEY or (keys[node] >> AVAIL_SHIFT) != 0:
        return -1
    return node


def schedule_bundles(state: ClusterState, bundle_reqs: np.ndarray,
                     strategy: PlacementStrategy,
                     spread_threshold: float | None = None,
                     node_mask: np.ndarray | None = None,
                     commit: bool = True) -> np.ndarray | None:
    """Atomically place a bundle set. Returns (B,) node rows or None.

    bundle_reqs: (B, R) int32 cu.  On success with ``commit`` the chosen
    reservations are subtracted from ``state.avail``; on failure ``state``
    is untouched (all-or-nothing, the PG stays pending).
    """
    bundle_reqs = np.asarray(bundle_reqs, dtype=np.int32)
    thr = threshold_fp(spread_threshold)
    mask = state.node_mask if node_mask is None \
        else state.node_mask & node_mask
    B = bundle_reqs.shape[0]
    avail = state.avail.copy()
    rows = np.empty(B, dtype=np.int32)

    if strategy is PlacementStrategy.STRICT_PACK:
        total = bundle_reqs.sum(axis=0, dtype=np.int64)
        if (total > np.iinfo(np.int32).max).any():
            return None
        node = _best_available(state.totals, avail, total.astype(np.int32),
                               thr, mask)
        if node < 0:
            return None
        rows[:] = node
        avail[node] -= total.astype(np.int32)
    else:
        used = np.zeros(state.num_nodes, dtype=bool)
        for b in range(B):
            req = bundle_reqs[b]
            if strategy is PlacementStrategy.STRICT_SPREAD:
                node = _best_available(state.totals, avail, req, thr,
                                       mask & ~used)
            elif strategy is PlacementStrategy.PACK:
                node = _best_available(state.totals, avail, req, thr,
                                       mask & used)
                if node < 0:
                    node = _best_available(state.totals, avail, req, thr,
                                           mask)
            else:  # SPREAD
                node = _best_available(state.totals, avail, req, thr,
                                       mask & ~used)
                if node < 0:
                    node = _best_available(state.totals, avail, req, thr,
                                           mask)
            if node < 0:
                return None
            rows[b] = node
            used[node] = True
            avail[node] -= req

    if commit:
        state.avail = avail
    return rows
