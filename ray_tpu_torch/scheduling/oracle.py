"""CPU reference scheduler — the bit-for-bit parity anchor.

Implements the contract in ``contract.py`` with a straightforward
task-at-a-time loop, exactly the way the reference's raylet invokes
``HybridSchedulingPolicy::Schedule`` once per task from
``ClusterTaskManager::ScheduleAndDispatchTasks`` (SURVEY.md §3.2 hot loop).
The device kernel (ray_tpu_torch/ops/hybrid_kernel.py) must reproduce this loop's
placements exactly; tests/test_parity.py asserts it property-style.

Nothing here is performance-relevant — clarity and obvious correctness win.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .contract import (AVAIL_SHIFT, INFEASIBLE_KEY, compute_keys,
                       threshold_fp)


@dataclass
class ClusterState:
    """Dense mirror of per-node resource state.

    Rows are traversal order (the deterministic tie-break order of the
    contract).  The ClusterResourceManager owns the NodeID <-> row mapping.
    """

    totals: np.ndarray            # (N, R) int32 cu
    avail: np.ndarray             # (N, R) int32 cu
    node_mask: np.ndarray = field(default=None)  # (N,) bool; False = dead/pad

    def __post_init__(self):
        self.totals = np.asarray(self.totals, dtype=np.int32)
        self.avail = np.asarray(self.avail, dtype=np.int32)
        if self.node_mask is None:
            self.node_mask = np.ones(self.totals.shape[0], dtype=bool)

    def copy(self) -> "ClusterState":
        return ClusterState(self.totals.copy(), self.avail.copy(),
                            self.node_mask.copy())

    @property
    def num_nodes(self) -> int:
        return self.totals.shape[0]


def _schedule_one_info(state: ClusterState, req: np.ndarray,
                       thr_fp: int, extra_mask: np.ndarray | None,
                       commit: bool, require_available: bool
                       ) -> tuple[int, bool]:
    """(node, consumed): core of schedule_one; consumed=False means the
    placement did not change state (queued or infeasible) — a fixed point
    for identical follow-up requests."""
    mask = state.node_mask if extra_mask is None \
        else (state.node_mask & extra_mask)
    keys = compute_keys(state.totals, state.avail, req, thr_fp, mask)
    node = int(np.argmin(keys))
    if keys[node] == INFEASIBLE_KEY:
        return -1, False
    if (keys[node] >> AVAIL_SHIFT) != 0:             # best is unavailable
        return (-1, False) if require_available else (node, False)
    if commit:
        state.avail[node] -= np.asarray(req, dtype=np.int32)
    return node, commit and bool((np.asarray(req) > 0).any())


def schedule_one(state: ClusterState, req: np.ndarray,
                 thr_fp: int, extra_mask: np.ndarray | None = None,
                 commit: bool = True, require_available: bool = False) -> int:
    """Schedule a single request. Returns node row or -1 (infeasible).

    Decrements ``state.avail`` iff the chosen node is available and
    ``commit`` — feasible-but-unavailable placements queue without consuming
    (contract; reference behavior per SURVEY §2.5 item 4), unless
    ``require_available``, in which case they return -1.
    """
    return _schedule_one_info(state, req, thr_fp, extra_mask, commit,
                              require_available)[0]


def schedule_tasks(state: ClusterState, reqs: np.ndarray,
                   spread_threshold: float | None = None,
                   masks: np.ndarray | None = None) -> np.ndarray:
    """Sequential greedy over a task batch (mutates ``state.avail``).

    reqs: (T, R) int32 cu.  masks: optional (T, N) bool per-task feasibility
    restriction.  Returns (T,) int32 node rows (-1 = infeasible).
    """
    thr = threshold_fp(spread_threshold)
    out = np.empty(reqs.shape[0], dtype=np.int32)
    for t in range(reqs.shape[0]):
        m = masks[t] if masks is not None else None
        out[t] = schedule_one(state, reqs[t], thr, m)
    return out


def group_requests(reqs: np.ndarray, masks: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Partition a task batch into scheduling classes.

    Returns (group_reqs (G, R), group_counts (G,), task_group (T,)) with
    groups ordered by first appearance — the contract's batch order.  Tasks
    are one class iff request vectors AND masks match.
    """
    seen: dict[bytes, int] = {}
    group_reqs: list[np.ndarray] = []
    counts: list[int] = []
    task_group = np.empty(reqs.shape[0], dtype=np.int32)
    for t in range(reqs.shape[0]):
        key = reqs[t].tobytes()
        if masks is not None:
            key += masks[t].tobytes()
        g = seen.get(key)
        if g is None:
            g = len(group_reqs)
            seen[key] = g
            group_reqs.append(reqs[t])
            counts.append(0)
        counts[g] += 1
        task_group[t] = g
    return (np.stack(group_reqs).astype(np.int32),
            np.asarray(counts, dtype=np.int32), task_group)


def schedule_grouped_oracle(state: ClusterState, group_reqs: np.ndarray,
                            group_counts: np.ndarray,
                            spread_threshold: float | None = None,
                            group_masks: np.ndarray | None = None,
                            require_available: bool = False) -> np.ndarray:
    """Grouped batch semantics via the sequential loop (mutates state).

    Returns per-(group, node) placement counts (G, N) int32; column index N
    (one past the last node) counts infeasible tasks.  This is the function
    the TPU water-fill kernel must match bit-for-bit.

    ``require_available``: feasible-but-unavailable nodes count as column N
    instead of queueing — the autoscaler's fit-onto-existing-nodes semantics
    (a demand that doesn't fit now must trigger a launch, not wait).
    """
    thr = threshold_fp(spread_threshold)
    G, N = group_reqs.shape[0], state.num_nodes
    counts = np.zeros((G, N + 1), dtype=np.int32)
    for g in range(G):
        m = group_masks[g] if group_masks is not None else None
        remaining = int(group_counts[g])
        while remaining > 0:
            node, consumed = _schedule_one_info(
                state, group_reqs[g], thr, m, True, require_available)
            if consumed:
                counts[g, node] += 1
                remaining -= 1
                continue
            # fixed point: state unchanged => every remaining request of
            # this class lands identically (empty request, queue on the
            # same feasible node, or infeasible) — bit-exact short-cut
            counts[g, node if node >= 0 else N] += remaining
            break
    return counts


def expand_group_counts(counts: np.ndarray, task_group: np.ndarray
                        ) -> np.ndarray:
    """Turn (G, N+1) placement counts into per-task node rows.

    Within a scheduling class, placements are handed out in *key order*
    (cheapest slots first), which for the sequential loop means: the order in
    which the greedy loop produced them.  Reconstructing that order from
    counts alone is not possible — but any within-class assignment of tasks
    to the counted slots is equivalent (tasks in a class are identical), so
    we hand slots out node-row-ascending.  Returns (T,) int32, -1 infeasible.
    """
    G, n_plus_1 = counts.shape
    out = np.empty(task_group.shape[0], dtype=np.int32)
    cursors = [np.repeat(np.arange(n_plus_1), counts[g]) for g in range(G)]
    pos = np.zeros(G, dtype=np.int64)
    for t, g in enumerate(task_group):
        out[t] = cursors[g][pos[g]]
        pos[g] += 1
    out[out == n_plus_1 - 1] = -1
    return out
