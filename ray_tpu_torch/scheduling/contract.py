"""The scheduling contract: exact integer semantics shared by the CPU oracle
and the TPU kernel.

Reference parity: this encodes the semantics of upstream Ray's
``HybridSchedulingPolicy`` (``src/ray/raylet/scheduling/policy/
hybrid_scheduling_policy.cc``) and ``LeastResourceScorer``
(``src/ray/raylet/scheduling/policy/scorer.h``), per SURVEY.md §2.5
[reference mount empty — semantics re-derived from the survey's behavioral
description, not copied from source].  BASELINE.json's north star requires the
TPU backend to match the CPU policy bit-for-bit; everything in this module is
therefore *pure integer arithmetic* with explicitly documented widths.

Semantics (the contract)
------------------------
For a request ``r`` (dense int32 cu vector) against node ``n`` with totals
``T_n`` and availables ``A_n``:

* feasible(n)   = all(T_n[i] >= r[i] for r[i] > 0)
* available(n)  = all(A_n[i] >= r[i] for r[i] > 0)
* score(n)      = max over {i : r[i] > 0} of ((T_n[i] - A_n[i] + r[i]) * SCALE)
                  // T_n[i]              -- critical-resource utilization,
                  integer floor division, SCALE = 2**12.  Empty request => 0.
* eff(n)        = 0 if (available(n) and score(n) < threshold_fp) else score(n)
                  -- the hybrid pack/spread bucketing: below-threshold
                  available nodes tie at 0 and fall to traversal order
                  (packing); above it they rank by score (spreading).
* key(n)        = (not available(n)) << 27 | eff(n) << 13 | traversal_index(n)
                  if feasible(n) else INFEASIBLE_KEY
* decision      = argmin over nodes of key(n); INFEASIBLE_KEY everywhere
                  => infeasible (queue until the cluster changes).

A placement on an *available* node decrements its availables by ``r``; a
placement on a feasible-but-unavailable node queues (no decrement) — matching
the reference's "best feasible node" fallback (SURVEY §2.5 item 4).

Batch semantics: one scheduling round partitions the pending queue by
scheduling class (identical (resources, strategy)) and processes classes in
first-appearance order, tasks within a class in queue order.  This is faithful
to the reference, whose ``ClusterTaskManager`` keys its schedule queue by
``SchedulingClass`` and drains it class-by-class (SURVEY §3.2).

Width audit (why int32 suffices end to end, incl. on TPU):
    T, A, r      <= MAX_TOTAL_CU = 2**17
    q = used + r <= 2 * 2**17 = 2**18
    q * SCALE    <= 2**30 < 2**31 - 1          (the score numerator)
    (L+1) * T    <= (2*SCALE + 1) * 2**17 < 2**31   (water-fill inversion;
                    L is capped by the largest permitted threshold
                    2*SCALE + 1 = the autoscaler first-fit threshold)
    key          <  2**28
"""

from __future__ import annotations

import numpy as np

from ..common.config import get_config

SCORE_SCALE_BITS = 12
SCALE = 1 << SCORE_SCALE_BITS          # 4096
NODE_BITS = 13
MAX_NODES = 1 << NODE_BITS             # 8192
SCORE_SHIFT = NODE_BITS
AVAIL_SHIFT = NODE_BITS + 14           # eff(n) <= 2*SCALE < 2**14
INFEASIBLE_KEY = np.int32(2**31 - 1)
MAX_SCORE = 2 * SCALE                  # score of a node at 2x utilization
# Per-(class, node) lease-budget ceiling: the fused beat emits water-fill
# headroom as lease budgets (see compute_budgets); the cap bounds what a
# single grant can hand a raylet and keeps the packed budget tensor well
# inside int32 (avail <= MAX_TOTAL_CU = 2**17, req >= 1 cu).
BUDGET_CAP = 1 << 15


def threshold_fp(spread_threshold: float | None = None) -> int:
    """Spread threshold in score fixed point."""
    t = (get_config().scheduler_spread_threshold
         if spread_threshold is None else spread_threshold)
    return int(round(t * SCALE))


def compute_keys(totals: np.ndarray, avail: np.ndarray, req: np.ndarray,
                 thr_fp: int, node_mask: np.ndarray | None = None
                 ) -> np.ndarray:
    """Packed int32 keys for one request against all nodes (numpy, exact).

    totals/avail: (N, R) int32 cu.  req: (R,) int32 cu.
    node_mask: optional (N,) bool — False rows are treated as infeasible
    (affinity/label constraints, dead nodes, padding rows).
    Returns (N,) int32.
    """
    totals = np.asarray(totals, dtype=np.int64)
    avail = np.asarray(avail, dtype=np.int64)
    req = np.asarray(req, dtype=np.int64)
    n = totals.shape[0]
    req_pos = req > 0

    if not req_pos.any():
        feasible = np.ones(n, dtype=bool)
        available = np.ones(n, dtype=bool)
        score = np.zeros(n, dtype=np.int64)
    else:
        t = totals[:, req_pos]
        a = avail[:, req_pos]
        r = req[req_pos]
        feasible = (t >= r).all(axis=1)
        available = (a >= r).all(axis=1)
        denom = np.where(t > 0, t, 1)
        q = t - a + r
        score = ((q * SCALE) // denom).max(axis=1)

    eff = np.where(available & (score < thr_fp), 0, score)
    key = ((~available).astype(np.int64) << AVAIL_SHIFT) \
        | (eff << SCORE_SHIFT) | np.arange(n, dtype=np.int64)
    key = np.where(feasible, key, np.int64(INFEASIBLE_KEY))
    if node_mask is not None:
        key = np.where(node_mask, key, np.int64(INFEASIBLE_KEY))
    return key.astype(np.int32)


def compute_keys_batch(totals: np.ndarray, avail: np.ndarray,
                       reqs: np.ndarray, thr_fp: int,
                       node_mask: np.ndarray | None = None) -> np.ndarray:
    """Packed keys for a batch of class requests: (C, N) int32.

    The host oracle twin of ``ops.hybrid_kernel.full_rescore`` — the
    carried key tensor a ``DeltaScheduler`` keeps device-resident
    between beats must equal this on the mirrored state, row for row
    (the delta-sequence parity gate).
    """
    reqs = np.asarray(reqs, dtype=np.int64)
    return np.stack([compute_keys(totals, avail, r, thr_fp, node_mask)
                     for r in reqs])


def compute_budgets(totals: np.ndarray, avail: np.ndarray, reqs: np.ndarray,
                    node_mask: np.ndarray | None = None,
                    cap: int = BUDGET_CAP) -> np.ndarray:
    """Per-(class, node) lease budgets from a post-water-fill state.

    The host oracle twin of the budget tensor the fused beat emits
    (``ops.hybrid_kernel.fused_beat`` / ``ShardPlane.fused_beat``): for
    each class ``c`` and node ``n``, how many MORE tasks of ``c`` node
    ``n`` could admit against the availables the beat left behind.

    * feasible(c, n) = all(T_n[i] >= r_c[i] for r_c[i] > 0) and mask(n)
    * fill(c, n)     = min over {i : r_c[i] > 0} of max(A_n[i], 0) // r_c[i]
                       (``cap`` when the class requests nothing — the
                       "zero" lease class is admission-unbounded)
    * budget(c, n)   = clip(fill, 0, cap) if feasible else 0

    ``avail`` is clamped to >= 0 *before* the floor division on both the
    host and device twins — numpy and XLA agree on non-negative ``//``
    but not on negative operands, and overcommitted rows owe 0 headroom
    anyway.  totals/avail: (N, R) int32 cu; reqs: (C, R); returns (C, N)
    int32.
    """
    totals = np.asarray(totals, dtype=np.int64)
    avail = np.maximum(np.asarray(avail, dtype=np.int64), 0)
    reqs = np.atleast_2d(np.asarray(reqs, dtype=np.int64))
    n = totals.shape[0]
    mask = (np.ones(n, dtype=bool) if node_mask is None
            else np.asarray(node_mask, dtype=bool))
    out = np.zeros((reqs.shape[0], n), dtype=np.int32)
    for c, r in enumerate(reqs):
        pos = r > 0
        if not pos.any():
            out[c] = np.where(mask, np.int32(cap), np.int32(0))
            continue
        feas = (totals[:, pos] >= r[pos]).all(axis=1) & mask
        fill = (avail[:, pos] // r[pos]).min(axis=1)
        out[c] = np.where(feas, np.clip(fill, 0, cap), 0).astype(np.int32)
    return out


def unpack_key(key: int) -> tuple[int, int, int]:
    """(unavailable_bucket, eff_score, traversal_index) for debugging."""
    return (int(key) >> AVAIL_SHIFT,
            (int(key) >> SCORE_SHIFT) & ((1 << 14) - 1),
            int(key) & (MAX_NODES - 1))
