"""Cluster-wide resource view: NodeID <-> dense-row mapping + state arrays.

Reference parity: ``ClusterResourceManager`` keeps an
``absl::flat_hash_map<scheduling::NodeID, Node>`` of ``NodeResources`` and is
the state every ``ISchedulingPolicy`` reads
(``src/ray/raylet/scheduling/cluster_resource_manager.h``); a
``LocalResourceManager`` tracks the owning node's instances
(``local_resource_manager.h``).  [SURVEY.md §1 layer 5 / §2.1; mount empty.]

TPU-first: the hash-map becomes *dense arrays in traversal order* — the form
both the numpy oracle and the HBM-resident device state consume.  Node
addition assigns the next free row; node death frees the row (mask=False) for
reuse so traversal indices stay < MAX_NODES.  Row order IS the contract's
deterministic tie-break order, so row assignment is part of observable
scheduling behavior: rows are assigned in registration order, matching the
reference's local-node-first traversal when the local node registers first.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque

import numpy as np

from ..common.ids import NodeID
from ..common.resources import NodeResources, ResourceIndex, ResourceRequest
from .contract import MAX_NODES
from .oracle import ClusterState


# Dirty-row journal depth.  At 8k nodes a full resync uploads every row, so
# once more than this many mutations pile up between two heartbeats the
# delta bookkeeping costs more than it saves — truncate and let the consumer
# fall back to a full upload.
_DIRTY_LOG_CAP = 8192
# Interned dense-request vectors (scheduling classes are few; this cap only
# guards against an adversarial stream of unique requests).
_REQ_CACHE_CAP = 4096


class ClusterResourceManager:
    """Owns the dense cluster state + id mapping. Thread-safe."""

    def __init__(self, num_resource_slots: int = 16,
                 capacity: int = 64):
        self._lock = threading.RLock()
        # waiters parked on capacity (wait_subtract); add_back notifies
        self._freed = threading.Condition(self._lock)
        self.resource_index = ResourceIndex()
        self._r_slots = max(num_resource_slots,
                            self.resource_index.num_resources)
        self._capacity = min(capacity, MAX_NODES)
        self.totals = np.zeros((self._capacity, self._r_slots), dtype=np.int32)
        self.avail = np.zeros_like(self.totals)
        self.node_mask = np.zeros(self._capacity, dtype=bool)
        # DRAINING rows stay registered (running tasks keep their debits,
        # heartbeats still sync) but every placement view masks them out,
        # so no new work lands there while the drain completes
        self.draining = np.zeros(self._capacity, dtype=bool)
        # SUSPECT rows (gray failures: slow event loop, open circuit
        # breaker on the node's data-plane link) are SOFT-avoided: the
        # raylet's placement rounds skip them while any healthy node
        # fits, but fall back to them rather than parking feasible work
        # — unlike draining, suspect never hides a node from snapshot()
        self.suspect = np.zeros(self._capacity, dtype=bool)
        # LOANED rows are batch nodes lent to the serve plane: they stay
        # in the placement mask, but the loan manager force-subtracts all
        # generic availability and exposes a shaped "serve_loaned"
        # resource only loaner replicas request — batch work cannot fit
        # until the loan is reclaimed and the availability restored
        self.loaned = np.zeros(self._capacity, dtype=bool)
        self._row_of: dict[NodeID, int] = {}
        self._id_of: dict[int, NodeID] = {}
        self._labels: dict[int, dict[str, str]] = {}
        self.version = 0          # epoch: bumped on every mutation
        # -- delta-heartbeat bookkeeping (see delta_view) -------------------
        # journal of (version, row) per mutation, bounded by _DIRTY_LOG_CAP;
        # consumers synced before _log_floor / _struct_version must resync
        self._dirty_log: deque[tuple[int, int]] = deque()
        self._log_floor = 0
        self._struct_version = 0  # last capacity/width growth epoch
        # epoch-memoized read-only copies handed out by snapshot()/arrays()/
        # delta_view(): (version, totals, avail, raw_mask, place_mask).
        # Two generations rotate so a stale epoch can usually be brought
        # current by patching only the rows dirtied since it was built
        # (see _frozen_locked) instead of re-copying every shard's rows.
        self._frozen: tuple | None = None
        self._frozen_prev: tuple | None = None
        self.frozen_stats = {"full": 0, "patched": 0, "rows_patched": 0}
        # interned dense request vectors: (req.key(), width) -> frozen vec
        self._req_cache: dict[tuple, np.ndarray] = {}

    # -- epoch / dirty tracking ---------------------------------------------
    def _mark(self, row: int | None = None) -> None:
        """Bump the epoch and journal the dirty row (caller holds _lock).

        Every mutation funnels through here so a device-resident mirror
        can ask "what changed since version V?" (delta_view) instead of
        re-uploading the whole state each heartbeat."""
        self.version += 1
        if row is not None:
            if len(self._dirty_log) >= _DIRTY_LOG_CAP:
                self._log_floor = self._dirty_log.popleft()[0]
            self._dirty_log.append((self.version, row))

    def _mark_struct(self) -> None:
        """Capacity or width grew: array shapes moved under every mirror,
        so all of them must full-resync.  Caller holds _lock."""
        self._mark()
        self._struct_version = self.version
        self._dirty_log.clear()
        self._log_floor = self.version

    # -- registration -------------------------------------------------------
    def add_node(self, node_id: NodeID, resources: NodeResources) -> int:
        with self._lock:
            if node_id in self._row_of:
                raise ValueError(f"node {node_id} already registered")
            row = self._alloc_row()
            for name, cu in resources.total_cu.items():
                col = self._col(name)
                self.totals[row, col] = cu
            for name, cu in resources.available_cu.items():
                self.avail[row, self._col(name)] = cu
            self.node_mask[row] = True
            self.draining[row] = False
            self.suspect[row] = False
            self.loaned[row] = False
            self._row_of[node_id] = row
            self._id_of[row] = node_id
            self._labels[row] = dict(resources.labels)
            self._mark(row)
            return row

    def remove_node(self, node_id: NodeID) -> None:
        with self._lock:
            row = self._row_of.pop(node_id, None)
            if row is None:
                return
            self._id_of.pop(row)
            self._labels.pop(row, None)
            self.totals[row] = 0
            self.avail[row] = 0
            self.node_mask[row] = False
            self.draining[row] = False
            self.suspect[row] = False
            # rows are reused by _alloc_row — a stale loaned bit would
            # hide the next tenant of this row from the loan picker
            self.loaned[row] = False
            self._mark(row)

    # -- drain lifecycle (ALIVE -> DRAINING -> removed) ---------------------
    def set_draining(self, node_id: NodeID, flag: bool = True) -> int | None:
        """Mark/unmark a node DRAINING.  Returns its row, or None if the
        node is unknown (already removed — drain raced with death)."""
        with self._lock:
            row = self._row_of.get(node_id)
            if row is None:
                return None
            if bool(self.draining[row]) != flag:
                self.draining[row] = flag
                self._mark(row)
            return row

    def is_draining(self, row: int) -> bool:
        with self._lock:
            return bool(self.draining[row]) if 0 <= row < self._capacity \
                else False

    def draining_rows(self) -> list[int]:
        with self._lock:
            return [int(r) for r in
                    np.flatnonzero(self.node_mask & self.draining)]

    # -- suspect lifecycle (gray failure: soft-avoid, never mask) -----------
    def set_suspect(self, row: int, flag: bool = True) -> None:
        """Mark/unmark a row suspect (the health manager mirrors its
        loop-suspect + breaker-quarantine view here each round)."""
        with self._lock:
            if 0 <= row < self._capacity and \
                    bool(self.suspect[row]) != flag:
                self.suspect[row] = flag
                self._mark(row)

    def suspect_mask(self) -> np.ndarray:
        with self._lock:
            return (self.node_mask & self.suspect).copy()

    def suspect_rows(self) -> list[int]:
        with self._lock:
            return [int(r) for r in
                    np.flatnonzero(self.node_mask & self.suspect)]

    # -- loan lifecycle (batch node lent to the serve plane) ----------------
    def set_loaned(self, row: int, flag: bool = True) -> None:
        """Mark/unmark a row as loaned to serve.  Loaned rows stay in
        the placement mask — batch is kept off them by availability
        (force-subtracted to zero), not by masking, so the drain/restore
        epilogue is a plain add_back."""
        with self._lock:
            if 0 <= row < self._capacity and \
                    bool(self.loaned[row]) != flag:
                self.loaned[row] = flag
                self._mark(row)

    def is_loaned(self, row: int) -> bool:
        with self._lock:
            return bool(self.loaned[row]) if 0 <= row < self._capacity \
                else False

    def loaned_rows(self) -> list[int]:
        with self._lock:
            return [int(r) for r in
                    np.flatnonzero(self.node_mask & self.loaned)]

    def _alloc_row(self) -> int:
        free = np.flatnonzero(~self.node_mask)
        # prefer rows never used / lowest index: deterministic traversal order
        if free.size == 0:
            if self._capacity >= MAX_NODES:
                raise RuntimeError(f"cluster exceeds MAX_NODES={MAX_NODES}")
            self._grow()
            free = np.flatnonzero(~self.node_mask)
        return int(free[0])

    def _grow(self):
        cap = min(self._capacity * 2, MAX_NODES)
        for name in ("totals", "avail"):
            arr = getattr(self, name)
            new = np.zeros((cap, self._r_slots), dtype=np.int32)
            new[:self._capacity] = arr
            setattr(self, name, new)
        mask = np.zeros(cap, dtype=bool)
        mask[:self._capacity] = self.node_mask
        self.node_mask = mask
        drain = np.zeros(cap, dtype=bool)
        drain[:self._capacity] = self.draining
        self.draining = drain
        sus = np.zeros(cap, dtype=bool)
        sus[:self._capacity] = self.suspect
        self.suspect = sus
        loan = np.zeros(cap, dtype=bool)
        loan[:self._capacity] = self.loaned
        self.loaned = loan
        self._capacity = cap
        self._mark_struct()

    def _col(self, name: str) -> int:
        col = self.resource_index.get_or_add(name)
        grew = False
        while col >= self._r_slots:
            new = np.zeros((self._capacity, self._r_slots * 2), dtype=np.int32)
            new[:, :self._r_slots] = self.totals
            self.totals = new
            new_a = np.zeros_like(new)
            new_a[:, :self._r_slots] = self.avail
            self.avail = new_a
            self._r_slots *= 2
            grew = True
        if grew:
            self._mark_struct()
        return col

    def _dense_req(self, req: ResourceRequest) -> np.ndarray:
        """Dense cu vector, growing the resource slots to cover the request
        (ResourceRequest.dense interns names but cannot grow our arrays).
        Caller must hold self._lock (array growth replaces the arrays).

        The vector of each scheduling class is interned once per
        (request, width) and shared read-only across beats — heartbeats
        stop re-densifying every class every time."""
        vec = self._req_cache.get((req.key(), self._r_slots))
        if vec is None:
            for name in req.cu():
                self._col(name)          # may grow width (changes the key)
            vec = req.dense(self.resource_index, self._r_slots)
            vec.setflags(write=False)
            if len(self._req_cache) >= _REQ_CACHE_CAP:
                self._req_cache.clear()
            self._req_cache[(req.key(), self._r_slots)] = vec
        return vec

    def intern_request(self, req: ResourceRequest) -> np.ndarray:
        """Public, lock-acquiring name interning + densification — the safe
        entry point for external callers (array growth under _lock)."""
        with self._lock:
            return self._dense_req(req)

    # -- sync from heartbeats (ray_syncer analogue, SURVEY §2.1) ------------
    def update_node_available(self, node_id: NodeID,
                              available_cu: dict[str, int]) -> None:
        with self._lock:
            row = self._row_of.get(node_id)
            if row is None:
                return
            for name, cu in available_cu.items():
                self.avail[row, self._col(name)] = cu
            self._mark(row)

    # -- allocation (used by the dispatch path) -----------------------------
    def subtract(self, row: int, req: ResourceRequest) -> bool:
        with self._lock:
            vec = self._dense_req(req)
            if (self.avail[row] < vec).any():
                return False
            self.avail[row] -= vec
            self._mark(row)
            return True

    def force_subtract(self, row: int, req: ResourceRequest) -> None:
        """Debit even into negative availability (bounded oversubscription
        on worker-unblock; the matching add_back rebalances)."""
        with self._lock:
            self.avail[row] -= self._dense_req(req)
            self._mark(row)

    def add_back(self, row: int, req: ResourceRequest) -> None:
        with self._lock:
            vec = self._dense_req(req)
            self.avail[row] = np.minimum(self.totals[row],
                                         self.avail[row] + vec)
            self._mark(row)
            self._freed.notify_all()

    def wait_subtract(self, row: int, req: ResourceRequest,
                      timeout: float) -> bool:
        """Blocking subtract: parks on the release condition (no polling)
        until the resources fit or ``timeout`` elapses.  Returns whether
        the debit happened."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                vec = self._dense_req(req)
                if (self.avail[row] >= vec).all():
                    self.avail[row] -= vec
                    self._mark(row)
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._freed.wait(remaining)

    # -- bundle (placement-group) resource shaping --------------------------
    def add_shaped_resources(self, row: int, shaped_cu: dict[str, int]
                             ) -> None:
        """Create/extend pg-shaped resource columns on a node (reference:
        committed bundles surface as ``CPU_group_{pgid}``-style custom
        resources that pg tasks then request — SURVEY §3.5)."""
        with self._lock:
            for name, cu in shaped_cu.items():
                col = self._col(name)
                self.totals[row, col] += cu
                self.avail[row, col] += cu
            self._mark(row)

    def remove_shaped_resources(self, row: int, shaped_cu: dict[str, int]
                                ) -> None:
        with self._lock:
            for name, cu in shaped_cu.items():
                col = self._col(name)
                self.totals[row, col] = max(0, self.totals[row, col] - cu)
                self.avail[row, col] = max(0, self.avail[row, col] - cu)
            self._mark(row)

    # -- views --------------------------------------------------------------
    # a frozen array nobody else holds has exactly this many refs at the
    # getrefcount call: the generation tuple + getrefcount's argument
    _FROZEN_FREE_REFS = 2

    def _recycle_frozen_locked(self) -> tuple | None:
        """Bring the RETIRED frozen generation current by patching only
        the rows dirtied since it was built, instead of re-copying every
        node shard's rows because one row moved.  Returns the patched
        generation, or None when only a full rebuild is sound:

        - no retired generation yet, or shapes grew under it
          (_struct_version), or the dirty journal was truncated past it
          (_log_floor) so "which rows?" cannot be answered;
        - some consumer still holds one of its arrays (refcount probe) —
          patching in place would mutate a view handed out as immutable.

        Caller holds _lock (getrefcount is exact under the GIL)."""
        cand = self._frozen_prev
        if cand is None:
            return None
        v0 = cand[0]
        if v0 < self._struct_version or v0 < self._log_floor or \
                cand[1].shape != self.totals.shape:
            return None
        for i in range(1, 5):
            if sys.getrefcount(cand[i]) > self._FROZEN_FREE_REFS:
                return None
        rows = sorted({r for (ver, r) in self._dirty_log if ver > v0})
        _v, totals, avail, raw_mask, place_mask = cand
        for arr in (totals, avail, raw_mask, place_mask):
            arr.setflags(write=True)
        if rows:
            totals[rows] = self.totals[rows]
            avail[rows] = self.avail[rows]
            raw_mask[rows] = self.node_mask[rows]
            place_mask[rows] = self.node_mask[rows] & \
                ~self.draining[rows]
        for arr in (totals, avail, raw_mask, place_mask):
            arr.setflags(write=False)
        self.frozen_stats["patched"] += 1
        self.frozen_stats["rows_patched"] += len(rows)
        return (self.version, totals, avail, raw_mask, place_mask)

    def _frozen_locked(self) -> tuple:
        """Epoch-memoized read-only copies of the state arrays.  One set
        of copies per epoch, shared by snapshot()/arrays()/delta_view():
        unchanged beats stop re-copying three arrays per heartbeat, and
        dirty beats recycle the retired generation row-by-row
        (_recycle_frozen_locked) rather than rebuilding every view.
        Caller holds _lock."""
        if self._frozen is not None and self._frozen[0] == self.version:
            return self._frozen
        gen = self._recycle_frozen_locked()
        if gen is None:
            totals = self.totals.copy()
            avail = self.avail.copy()
            raw_mask = self.node_mask.copy()
            place_mask = self.node_mask & ~self.draining
            for arr in (totals, avail, raw_mask, place_mask):
                arr.setflags(write=False)
            gen = (self.version, totals, avail, raw_mask, place_mask)
            self.frozen_stats["full"] += 1
        self._frozen_prev = self._frozen
        self._frozen = gen
        return gen

    def snapshot(self) -> ClusterState:
        """Copy-on-read snapshot for a scheduling round (pure-function
        discipline: policies never see live mutable state — SURVEY §4
        'every scheduling decision is testable without real distribution')."""
        with self._lock:
            # DRAINING rows are infeasible for every placement consumer
            # (raylet rounds, pg bundles, autoscaler demand, trainer fit).
            # Policies decrement state.avail in place, so each caller gets
            # its own writable avail; totals/mask are shared frozen views.
            _, totals, avail, _raw, place = self._frozen_locked()
            return ClusterState(totals, avail.copy(), place)

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Read-only epoch-frozen (totals, avail, node_mask) for metric /
        autoscaler reads — memoized by the epoch counter."""
        with self._lock:
            _, totals, avail, raw, _place = self._frozen_locked()
            return totals, avail, raw

    def delta_view(self, since_version: int) -> tuple:
        """Atomic "what changed since epoch V" view for device-resident
        mirrors (the delta-scheduling heartbeat).

        Returns ``(version, totals, avail, place_mask, dirty_rows)``.
        The arrays are the shared read-only epoch copies (never mutate);
        ``place_mask = node_mask & ~draining`` — the same placement mask
        ``snapshot()`` hands every consumer.  ``dirty_rows`` is the set
        of rows mutated in ``(since_version, version]``; ``None`` means
        the journal cannot answer (first sync, journal truncated past
        ``since_version``, or a capacity/width growth moved array shapes)
        and the caller must re-upload everything."""
        with self._lock:
            v, totals, avail, _raw, place = self._frozen_locked()
            rows: set[int] | None
            if since_version >= v:
                rows = set()
            elif since_version < self._struct_version or \
                    since_version < self._log_floor:
                rows = None
            else:
                rows = {r for (ver, r) in self._dirty_log
                        if ver > since_version}
            return v, totals, avail, place, rows

    def row_of(self, node_id: NodeID) -> int | None:
        with self._lock:
            return self._row_of.get(node_id)

    def id_of(self, row: int) -> NodeID | None:
        with self._lock:
            return self._id_of.get(row)

    def labels_of(self, row: int) -> dict[str, str]:
        with self._lock:
            return dict(self._labels.get(row, {}))

    def num_nodes(self) -> int:
        with self._lock:
            return len(self._row_of)

    def label_mask(self, label_selector: dict[str, str]) -> np.ndarray:
        """(capacity,) bool mask of nodes matching all label k=v pairs."""
        with self._lock:
            mask = self.node_mask & ~self.draining
            for row in range(self._capacity):
                if not mask[row]:
                    continue
                labels = self._labels.get(row, {})
                if any(labels.get(k) != v
                       for k, v in label_selector.items()):
                    mask[row] = False
            return mask
