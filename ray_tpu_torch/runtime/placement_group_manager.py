"""Placement-group lifecycle: gang placement + 2-phase reservation.

Reference parity: ``GcsPlacementGroupManager`` + ``GcsPlacementGroupScheduler
::ScheduleUnplacedBundles`` with 2-phase commit (PrepareBundleResources on
each raylet -> all-ack -> CommitBundleResources, any nack -> rollback) and
the committed-bundle resource shaping (``CPU_group_{pgid}`` /
``CPU_group_{i}_{pgid}`` custom resources that pg tasks request) —
``src/ray/gcs/gcs_server/gcs_placement_group_*``, SURVEY.md §3.5; mount
empty.

Placement itself is the bundle policy contract from
``ray_tpu_torch/scheduling/bundles.py`` (device twin: ``ops.bundle_kernel``).
Groups that cannot place now go to a pending list retried on every resource
release / node arrival (event-driven via the CRM version, polled by a slow
ticker as a safety net).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np

from ..common.ids import ObjectID, PlacementGroupID, TaskID
from ..common.resources import ResourceRequest, from_cu
from ..scheduling.bundles import PlacementStrategy, schedule_bundles
from .object_ref import ObjectRef
from ..common import clock as _clk


def ready_oid_for(pg_id: PlacementGroupID) -> ObjectID:
    """Deterministic ready-marker object id for a group: resolvable from
    the pg id alone, so any process can await readiness."""
    return ObjectID.for_task_return(
        TaskID.deterministic(pg_id.binary(), _nil_actor()), 1)


def shaped_name(base: str, pg_hex: str, bundle_index: int | None = None
                ) -> str:
    if bundle_index is None:
        return f"{base}_group_{pg_hex}"
    return f"{base}_group_{bundle_index}_{pg_hex}"


def shape_request(resources: dict[str, float], pg_hex: str,
                  bundle_index: int = -1) -> dict[str, float]:
    """Rewrite a task's demand onto pg-shaped resources (reference: tasks
    under a PlacementGroupSchedulingStrategy consume ``*_group_*``).

    Indexed demand consumes BOTH the indexed and the wildcard name — the
    wildcard column is the node's total reserved capacity, so every
    admission must debit it or an indexed task and a wildcard task would
    both be admitted against one reserved bundle (reference behavior)."""
    if bundle_index < 0:
        return {shaped_name(k, pg_hex): v for k, v in resources.items()}
    out = {}
    for k, v in resources.items():
        out[shaped_name(k, pg_hex, bundle_index)] = v
        out[shaped_name(k, pg_hex)] = v
    return out


def _bundle_shaped_cu(bundle_req: ResourceRequest, pg_hex: str,
                      bundle_index: int) -> dict[str, int]:
    """The shaped cu columns one committed bundle surfaces on its node
    (indexed + wildcard) — single source for reserve AND release."""
    shaped: dict[str, int] = {}
    for kname, cu in bundle_req.cu().items():
        shaped[shaped_name(kname, pg_hex, bundle_index)] = cu
        shaped[shaped_name(kname, pg_hex)] = cu
    return shaped


@dataclass
class PlacementGroupRecord:
    pg_id: PlacementGroupID
    bundles: list[dict[str, float]]
    strategy: PlacementStrategy
    name: str | None
    state: str = "PENDING"              # PENDING | CREATED | REMOVED
    rows: list[int] = field(default_factory=list)
    ready_oid: ObjectID | None = None


class PlacementGroupManager:
    def __init__(self, cluster):
        self._cluster = cluster
        self._crm = cluster.crm
        self._store = cluster.store
        self._lock = threading.RLock()
        self._groups: dict[PlacementGroupID, PlacementGroupRecord] = {}
        self._pending: list[PlacementGroupID] = []
        self._ticker: threading.Thread | None = None
        self._stop = False

    # -- creation -----------------------------------------------------------
    def create(self, pg_id: PlacementGroupID,
               bundles: list[dict[str, float]], strategy: PlacementStrategy,
               name: str | None = None) -> ObjectID:
        ready_oid = ready_oid_for(pg_id)
        rec = PlacementGroupRecord(pg_id, [dict(b) for b in bundles],
                                   strategy, name, ready_oid=ready_oid)
        # the ready marker outlives any transient pg.ready() ObjectRef —
        # pin it against refcount reclamation until the group is removed
        self._cluster.ref_counter.pin(ready_oid)
        with self._lock:
            self._groups[pg_id] = rec
            if pg_id not in self._place_many([rec]):
                self._pending.append(pg_id)
                self._ensure_ticker()
                # a group that cannot place is autoscaler demand
                asc = getattr(self._cluster, "autoscaler", None)
                if asc is not None:
                    asc.kick()
        return ready_oid

    def pending_bundle_demand(self) -> list[ResourceRequest]:
        """Bundles of still-PENDING groups (autoscaler demand — reference:
        pending placement groups feed get_nodes_to_launch)."""
        with self._lock:
            out = []
            for pg_id in self._pending:
                rec = self._groups.get(pg_id)
                if rec is not None and rec.state == "PENDING":
                    out.extend(ResourceRequest(b) for b in rec.bundles)
            return out

    def _try_place(self, rec: PlacementGroupRecord) -> bool:
        """Place + 2-phase reserve. Caller holds the lock."""
        reqs = [ResourceRequest(b) for b in rec.bundles]
        for r in reqs:                      # intern any new resource names
            self._crm.intern_request(r)     # (lock-acquiring: grows arrays)
        width = self._crm.avail.shape[1]
        dense = np.stack([r.dense(self._crm.resource_index, width)
                          for r in reqs])
        snapshot = self._crm.snapshot()
        rows = schedule_bundles(snapshot, dense, rec.strategy, commit=False)
        if rows is None:
            return False
        return self._reserve_and_commit(rec, reqs, rows)

    def _reserve_and_commit(self, rec: PlacementGroupRecord, reqs,
                            rows) -> bool:
        """2-phase reservation of a computed placement: prepare subtracts
        base resources on each chosen raylet (re-validated against the
        LIVE view — a device batch computed on a snapshot may have raced
        a task), rolling back atomically on any failure; commit surfaces
        the shaped bundle resources and seals the ready marker."""
        prepared: list[tuple[int, ResourceRequest]] = []
        ok = True
        for b, row in enumerate(rows):
            if self._crm.subtract(int(row), reqs[b]):
                prepared.append((int(row), reqs[b]))
            else:                           # raced with a task: rollback
                ok = False
                break
        if not ok:
            for row, r in prepared:
                self._crm.add_back(row, r)
            return False
        # phase 2 — commit: surface the shaped bundle resources
        pg_hex = rec.pg_id.hex()
        for b, row in enumerate(rows):
            self._crm.add_shaped_resources(
                int(row), _bundle_shaped_cu(reqs[b], pg_hex, b))
        rec.rows = [int(r) for r in rows]
        rec.state = "CREATED"
        self._store.put(rec.ready_oid, {
            "placement_group_id": pg_hex,
            "bundles_to_node_row": rec.rows,
        })
        self._wake_raylets()
        return True

    def _place_many(self, recs: list) -> set:
        """Place a batch of pending groups; returns the placed pg ids.
        Batches at or above ``pg_device_batch_min`` run the device
        gang-placement kernel in ONE call (bit-identical to sequential
        ``schedule_bundles`` — the live path of ops/bundle_kernel.py);
        smaller batches take the per-group CPU path.  Caller holds the
        lock."""
        from ..common.config import get_config
        cfg = get_config()
        if not (cfg.scheduler_device_backend
                and len(recs) >= cfg.pg_device_batch_min):
            return {rec.pg_id for rec in recs if self._try_place(rec)}
        from ..ops.bundle_kernel import schedule_bundle_groups_np
        self.device_batches = getattr(self, "device_batches", 0) + 1
        all_reqs = []
        for rec in recs:
            reqs = [ResourceRequest(b) for b in rec.bundles]
            for r in reqs:
                self._crm.intern_request(r)
            all_reqs.append(reqs)
        width = self._crm.avail.shape[1]
        B = max(len(r) for r in all_reqs)
        P = len(recs)
        bundle_reqs = np.zeros((P, B, width), dtype=np.int32)
        valid = np.zeros((P, B), dtype=bool)
        strategies = []
        for p, reqs in enumerate(all_reqs):
            for b, r in enumerate(reqs):
                bundle_reqs[p, b] = r.dense(self._crm.resource_index,
                                            width)
                valid[p, b] = True
            strategies.append(recs[p].strategy)
        snapshot = self._crm.snapshot()
        rows, ok, _ = schedule_bundle_groups_np(
            snapshot.totals, snapshot.avail, snapshot.node_mask,
            bundle_reqs, valid, strategies,
            device=self._cluster.scheduler_device)
        placed = set()
        for p, rec in enumerate(recs):
            if not ok[p]:
                continue
            group_rows = rows[p, :len(all_reqs[p])]
            if self._reserve_and_commit(rec, all_reqs[p], group_rows):
                placed.add(rec.pg_id)
        return placed

    def _wake_raylets(self) -> None:
        for raylet in list(self._cluster.raylets.values()):
            raylet._notify_dirty()

    # -- pending retry ------------------------------------------------------
    def _ensure_ticker(self) -> None:
        if self._ticker is None or not self._ticker.is_alive():
            self._ticker = threading.Thread(
                target=self._retry_loop, daemon=True, name="pg-pending")
            self._ticker.start()

    def _retry_loop(self) -> None:
        last_version = -1
        while not self._stop:
            with self._lock:
                if not self._pending:
                    return
                if self._crm.version != last_version:
                    last_version = self._crm.version
                    recs = [self._groups[pg_id]
                            for pg_id in self._pending
                            if self._groups.get(pg_id) is not None
                            and self._groups[pg_id].state == "PENDING"]
                    placed = self._place_many(recs) if recs else set()
                    self._pending = [rec.pg_id for rec in recs
                                     if rec.pg_id not in placed]
            _clk.sleep(0.05)

    # -- node death ---------------------------------------------------------
    def on_node_removed(self, row: int) -> None:
        """A node holding bundles died: release the group's surviving
        reservations and send it back to pending for rescheduling
        (reference: GcsPlacementGroupManager reschedules bundles of dead
        nodes)."""
        with self._lock:
            for rec in self._groups.values():
                if rec.state != "CREATED" or row not in rec.rows:
                    continue
                pg_hex = rec.pg_id.hex()
                for b, r in enumerate(rec.rows):
                    if r == row:
                        continue            # dead node: resources are gone
                    req = ResourceRequest(rec.bundles[b])
                    self._crm.remove_shaped_resources(
                        r, _bundle_shaped_cu(req, pg_hex, b))
                    self._crm.add_back(r, req)
                rec.rows = []
                rec.state = "PENDING"
                # retract the stale ready marker: pg.wait() must block
                # until the group is re-reserved (and the deferred-actor
                # on_ready path must not fire synchronously forever)
                self._store.delete([rec.ready_oid])
                if rec.pg_id not in self._pending:
                    self._pending.append(rec.pg_id)
            if self._pending:
                self._ensure_ticker()

    def on_node_draining(self, row: int) -> int:
        """A node holding bundles is DRAINING: release reservations on
        EVERY row — including the draining one, which is still alive so
        its base resources really do come back — and re-pend the group.
        Re-placement runs against the CRM snapshot, whose drain mask
        excludes the row, so the whole group (STRICT_PACK included)
        reschedules atomically elsewhere.  Returns how many groups were
        displaced."""
        displaced = 0
        with self._lock:
            for rec in self._groups.values():
                if rec.state != "CREATED" or row not in rec.rows:
                    continue
                pg_hex = rec.pg_id.hex()
                for b, r in enumerate(rec.rows):
                    req = ResourceRequest(rec.bundles[b])
                    self._crm.remove_shaped_resources(
                        r, _bundle_shaped_cu(req, pg_hex, b))
                    self._crm.add_back(r, req)
                rec.rows = []
                rec.state = "PENDING"
                self._store.delete([rec.ready_oid])
                if rec.pg_id not in self._pending:
                    self._pending.append(rec.pg_id)
                displaced += 1
            if self._pending:
                self._ensure_ticker()
        return displaced

    # -- removal ------------------------------------------------------------
    def remove(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            rec = self._groups.get(pg_id)
            if rec is None or rec.state == "REMOVED":
                return
            if rec.state == "PENDING":
                rec.state = "REMOVED"
                if pg_id in self._pending:
                    self._pending.remove(pg_id)
                # seal the ready marker with an error: waiters (pg.ready()
                # gets, actors parked on the marker) must WAKE and fail,
                # not hang forever (reference: actor creation fails when
                # its placement group is removed).  Woken actors re-resolve
                # through scheduling_options_for -> "dead" -> ActorDied.
                from .serialization import RayTaskError
                self._store.put(rec.ready_oid, RayTaskError(
                    "placement_group.ready",
                    f"placement group {pg_id.hex()[:12]} was removed "
                    "while pending"))
                self._wake_raylets()
                return
            pg_hex = pg_id.hex()
            for b, row in enumerate(rec.rows):
                req = ResourceRequest(rec.bundles[b])
                self._crm.remove_shaped_resources(
                    row, _bundle_shaped_cu(req, pg_hex, b))
                self._crm.add_back(row, req)
            rec.state = "REMOVED"
            self._store.delete([rec.ready_oid])
            self._cluster.ref_counter.unpin(rec.ready_oid)
        self._wake_raylets()

    # -- strategy resolution (shared by raylet + actor manager) -------------
    def scheduling_options_for(self, strategy, n_rows: int):
        """Resolve a PLACEMENT_GROUP SchedulingStrategy into scheduling
        options.  Returns (verdict, options):

        * ("ok", options)   — group reserved; affinity/mask options
        * ("park", options) — group pending; all-False mask (task parks
                              until the commit wakes the raylets)
        * ("dead", None)    — group removed/unknown/bad bundle index; the
                              caller must FAIL the task/actor
        """
        import numpy as np

        from ..scheduling.policy import SchedulingOptions, SchedulingType
        with self._lock:
            rec = self._groups.get(strategy.placement_group_id)
            if rec is None or rec.state == "REMOVED":
                return "dead", None
            if strategy.bundle_index >= len(rec.bundles):
                return "dead", None
            if rec.state != "CREATED":
                return "park", SchedulingOptions(
                    node_mask=np.zeros(n_rows, dtype=bool))
            if strategy.bundle_index >= 0:
                return "ok", SchedulingOptions(
                    scheduling_type=SchedulingType.NODE_AFFINITY,
                    node_row=rec.rows[strategy.bundle_index], soft=False)
            mask = np.zeros(n_rows, dtype=bool)
            mask[[r for r in rec.rows if r < n_rows]] = True
            return "ok", SchedulingOptions(node_mask=mask)

    # -- introspection ------------------------------------------------------
    def table(self) -> dict:
        with self._lock:
            return {
                rec.pg_id.hex(): {
                    "state": rec.state,
                    "name": rec.name,
                    "strategy": rec.strategy.name,
                    "bundles": [dict(b) for b in rec.bundles],
                    "node_rows": list(rec.rows),
                } for rec in self._groups.values()
            }

    def get(self, pg_id: PlacementGroupID) -> PlacementGroupRecord | None:
        with self._lock:
            return self._groups.get(pg_id)

    def shutdown(self) -> None:
        self._stop = True


def _nil_actor():
    from ..common.ids import ActorID, JobID
    return ActorID.nil_for_job(JobID.from_int(0))
