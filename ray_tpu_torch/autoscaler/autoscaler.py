"""Autoscaler runtime loop: live demand in, node launches/terminations out.

Reference parity: upstream's ``StandardAutoscaler.update()`` (``python/ray/
autoscaler/_private/autoscaler.py``) periodically collects pending resource
demands (infeasible tasks + pending placement groups) from the load
metrics, asks ``ResourceDemandScheduler.get_nodes_to_launch`` how many
nodes of each available type to add, launches them through the node
provider, and terminates nodes idle past ``idle_timeout_minutes``
(SURVEY.md §1 layer 11; mount empty).

Device-first: the packing math is the bin-pack kernel — large demand
rounds run ``ops.binpack_kernel.autoscale`` on the cluster's
``scheduler_device`` (bit-identical to the CPU oracle in
``autoscaler.demand``): one water-fill launch and one launch of the
hand-written launch-loop kernel on the GPU, so a 1M-pending-demand round
costs two launches (north-star config #5); with
``scheduler_device="cpu"`` the same route runs their plain versions.
The loop itself is event-driven: raylets kick it when a scheduling
round parks infeasible tasks, with ``autoscaler_update_interval_ms`` as
the fallback tick.
"""

from __future__ import annotations

import threading

import numpy as np

from ..common.config import get_config
from ..common.resources import ResourceRequest
from .demand import NodeTypeSpec, get_nodes_to_launch
from ..common import clock as _clk

NODE_TYPE_LABEL = "node-type"       # CRM label carrying the launch type


class StandardAutoscaler:
    """The runtime loop around the demand-packing math.

    ``update()`` is one synchronous round (tests call it directly);
    ``start()`` runs rounds on a daemon thread, woken early by ``kick()``
    (raylets call it when tasks park infeasible, placement-group manager
    when a group cannot place).
    """

    def __init__(self, cluster, node_types: list[NodeTypeSpec],
                 min_workers: int = 0, workers_per_node: int = 2,
                 idle_timeout_s: float | None = None,
                 interval_ms: int | None = None):
        cfg = get_config()
        self._cluster = cluster
        self._types = list(node_types)
        self._min_workers = min_workers
        self._workers_per_node = workers_per_node
        self._idle_timeout = (idle_timeout_s if idle_timeout_s is not None
                              else cfg.autoscaler_idle_timeout_s)
        self._interval = (interval_ms if interval_ms is not None
                          else cfg.autoscaler_update_interval_ms) / 1000.0
        self._device_min = cfg.autoscaler_device_batch_min
        self._use_device = cfg.scheduler_device_backend
        self._wake = threading.Event()
        self._stop = False
        self._thread: threading.Thread | None = None
        self._idle_since: dict = {}             # NodeID -> monotonic time
        self._surplus_since: dict = {}          # NodeID -> monotonic time
        self._migrating: set = set()            # sole-copy pulls in flight
        self._lock = threading.Lock()           # one update at a time
        # stats
        self.num_launched = 0
        self.num_terminated = 0
        self.num_drained = 0
        self.migrations_started = 0
        self.migrations_completed = 0
        self.migrations_failed = 0
        self.device_rounds = 0
        self.oracle_rounds = 0
        self.last_unmet = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def kick(self) -> None:
        """Wake the loop early (infeasible task / pending PG arrival)."""
        self._wake.set()

    def shutdown(self) -> None:
        """Stop AND join (an in-flight update must not race teardown)."""
        self._stop = True
        self._wake.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop:
            self._wake.wait(timeout=self._interval)
            self._wake.clear()
            if self._stop:
                return
            try:
                self.update()
            except Exception:   # noqa: BLE001 — a bad round must not kill
                import traceback
                traceback.print_exc()

    # -- one round -----------------------------------------------------------
    def update(self) -> dict:
        """Collect demand, launch what packing says, retire idle nodes.
        Returns the round's summary (launches by type, unmet classes)."""
        with self._lock:
            launches = self._scale_up()
            terminated = self._scale_down()
        # capacity loaning rides the autoscaler beat: batch pressure
        # (unmet demand) is the reclaim trigger, serve backlog the loan
        # trigger — both are read inside the manager's own tick
        loans = getattr(self._cluster, "loans", None)
        if loans is not None:
            loans.tick(unmet=self.last_unmet)
        return {"launches": launches, "terminated": terminated,
                "unmet": self.last_unmet}

    def request_resources(self, bundles: list[dict]) -> None:
        """Explicit demand floor (reference:
        ``ray.autoscaler.sdk.request_resources``): the cluster sizes so
        these bundles COULD schedule, immediately and independent of
        live task load.  Each call REPLACES the previous request; an
        empty list clears it."""
        reqs = [ResourceRequest(b) for b in bundles]
        with self._lock:
            self._requested = reqs
        self.kick()

    def _pending_demand(self) -> tuple[list[ResourceRequest], list[int]]:
        """Per-class pending demand: infeasible/queued tasks from every
        raylet plus the bundles of pending placement groups (reference:
        ``LoadMetrics`` resource_demand + pending_placement_groups)
        plus any explicit ``request_resources`` floor."""
        by_class: dict = {}
        for raylet in list(self._cluster.raylets.values()):
            for req in raylet.pending_demand():
                ent = by_class.setdefault(req.key(), [req, 0])
                ent[1] += 1
        for req in self._cluster.pg_manager.pending_bundle_demand():
            ent = by_class.setdefault(req.key(), [req, 0])
            ent[1] += 1
        for req in getattr(self, "_requested", ()):
            ent = by_class.setdefault(req.key(), [req, 0])
            ent[1] += 1
        reqs = [e[0] for e in by_class.values()]
        counts = [e[1] for e in by_class.values()]
        return reqs, counts

    def _live_type_counts(self) -> dict[str, int]:
        crm = self._cluster.crm
        out: dict[str, int] = {}
        for row in list(self._cluster.raylets):
            t = crm.labels_of(row).get(NODE_TYPE_LABEL)
            if t is not None:
                out[t] = out.get(t, 0) + 1
        return out

    def _scale_up(self) -> dict[str, int]:
        reqs, counts = self._pending_demand()
        if not reqs or not self._types:
            self.last_unmet = 0
            return {}
        crm = self._cluster.crm
        for r in reqs:
            crm.intern_request(r)
        type_reqs = [ResourceRequest(t.resources) for t in self._types]
        for r in type_reqs:
            crm.intern_request(r)
        snapshot = crm.snapshot()
        width = snapshot.totals.shape[1]
        demand_reqs = np.stack(
            [r.dense(crm.resource_index, width) for r in reqs])
        demand_counts = np.asarray(counts, dtype=np.int64)
        type_caps = np.stack(
            [r.dense(crm.resource_index, width) for r in type_reqs])
        live = self._live_type_counts()
        quotas = np.asarray(
            [max(t.max_workers - live.get(t.name, 0), 0)
             for t in self._types], dtype=np.int64)

        if self._use_device and int(demand_counts.sum()) >= self._device_min:
            from ..ops.binpack_kernel import autoscale_np
            self.device_rounds += 1
            launches, _fit, unmet, _avail = autoscale_np(
                snapshot.totals, snapshot.avail, snapshot.node_mask,
                demand_reqs, demand_counts.astype(np.int32), type_caps,
                quotas.astype(np.int32),
                device=self._cluster.scheduler_device)
        else:
            self.oracle_rounds += 1
            launches, _fit, unmet = get_nodes_to_launch(
                snapshot, demand_reqs, demand_counts, type_caps, quotas)
        self.last_unmet = int(np.asarray(unmet).sum())

        launched: dict[str, int] = {}
        for k, n in enumerate(np.asarray(launches)):
            for _ in range(int(n)):
                self._cluster.add_node(
                    resources=dict(self._types[k].resources),
                    num_workers=self._workers_per_node,
                    labels={NODE_TYPE_LABEL: self._types[k].name},
                    wait=False)
                self.num_launched += 1
                launched[self._types[k].name] = \
                    launched.get(self._types[k].name, 0) + 1
        if launched:
            self._cluster.events.emit("autoscaler", "nodes_launched",
                                      launches=launched,
                                      unmet=self.last_unmet)
        return launched

    def _scale_down(self) -> list:
        """Terminate nodes idle past the timeout (never the head; never
        below ``min_workers`` worker nodes).  With
        ``autoscaler_drain_busy`` on, BUSY nodes whose capacity the
        cluster no longer needs are gracefully drained instead of
        waiting (possibly forever) for idleness."""
        cluster = self._cluster
        cfg = get_config()
        now = _clk.monotonic()
        totals, avail, mask = cluster.crm.arrays()
        drain_mask = cluster.crm.draining
        loan_mask = cluster.crm.loaned
        terminated = []
        rows = [(row, r) for row, r in list(cluster.raylets.items())
                if row != cluster._head_row]
        live_workers = len(rows)
        # nodes already DRAINING are on their way out: skip them below,
        # but count them as leaving so this round keeps min_workers
        leaving = sum(1 for row, _ in rows if drain_mask[row])
        requested = list(getattr(self, "_requested", ()))
        for row, raylet in rows:
            if drain_mask[row] or loan_mask[row]:
                # LOANED rows belong to the serve plane until the loan
                # manager reclaims them: neither idle-terminate nor
                # surplus-drain may take them out from under a replica
                self._idle_since.pop(raylet.node_id, None)
                self._surplus_since.pop(raylet.node_id, None)
                continue
            fully_free = bool(mask[row]) and \
                (avail[row] == totals[row]).all()
            if fully_free and requested and \
                    not self._fits_without(row, requested):
                # an explicit request_resources floor still needs this
                # node's capacity: terminating would relaunch it next
                # round (flap) and break the floor contract
                self._idle_since.pop(raylet.node_id, None)
                continue
            if fully_free and raylet.is_idle():
                self._surplus_since.pop(raylet.node_id, None)
                sole = cluster.directory.sole_copies_on(row)
                if sole:
                    # the node holds the only copy of live objects:
                    # terminating would destroy them (or burn lineage
                    # retries).  Migrate to the head first; the node
                    # retires on a later round once a FRESH sole-copy
                    # scan comes back empty — i.e. the copies actually
                    # landed (reference: drain-before-terminate).
                    self._migrate_off(sole, row)
                    continue
                t0 = self._idle_since.setdefault(raylet.node_id, now)
                if (now - t0 >= self._idle_timeout and
                        live_workers - len(terminated) - leaving
                        > self._min_workers):
                    cluster.events.emit(
                        "autoscaler", "idle_node_terminated", node_row=row,
                        node_id=raylet.node_id.hex(),
                        idle_seconds=now - t0)
                    cluster.remove_node(raylet.node_id)
                    self._idle_since.pop(raylet.node_id, None)
                    self.num_terminated += 1
                    terminated.append(raylet.node_id)
            else:
                self._idle_since.pop(raylet.node_id, None)
                # busy-but-surplus: the cluster fits all explicit demand
                # without this node and nothing is unmet — hand its work
                # off gracefully instead of waiting for idleness
                # (Aryl-style preemption-aware scale-down)
                if (cfg.autoscaler_drain_busy and bool(mask[row])
                        and self.last_unmet == 0
                        and live_workers - len(terminated) - leaving
                        > self._min_workers
                        and self._fits_without(row, requested)):
                    t0 = self._surplus_since.setdefault(raylet.node_id,
                                                        now)
                    if now - t0 >= cfg.autoscaler_drain_surplus_s:
                        self._surplus_since.pop(raylet.node_id, None)
                        cluster.drain_node(
                            raylet.node_id,
                            reason="autoscaler: busy-but-surplus "
                                   "scale-down")
                        self.num_drained += 1
                        leaving += 1
                else:
                    self._surplus_since.pop(raylet.node_id, None)
        return terminated

    def _fits_without(self, row: int, requested) -> bool:
        """Would the explicit request floor still fit on AVAILABLE
        capacity if ``row`` were terminated?  Greedy per-node bundle
        fit (same granularity the launch packer uses)."""
        cluster = self._cluster
        _totals, avail, mask = cluster.crm.arrays()
        drain_mask = cluster.crm.draining
        width = avail.shape[1]
        remaining = {r: avail[r].astype(np.int64).copy()
                     for r in cluster.raylets
                     if r != row and mask[r] and not drain_mask[r]}
        for req in requested:
            vec = req.dense(cluster.crm.resource_index, width)
            placed = False
            for r, cap in remaining.items():
                if (cap[:vec.shape[0]] >= vec).all():
                    cap[:vec.shape[0]] -= vec
                    placed = True
                    break
            if not placed:
                return False
        return True

    def _migrate_off(self, object_ids, row: int) -> None:
        """Pull sole-copy objects to the head so the node becomes safe
        to retire.  Completion-tracked: every plasma kind a directory
        entry can carry (shm, spill, AND agent-plane ``remote``)
        migrates, callbacks record landings/failures, and in-flight
        pulls are not re-requested.  The node only retires once a fresh
        ``sole_copies_on`` scan comes back empty — i.e. the directory
        saw each copy land on the head."""
        from ..runtime.object_store import PLASMA_KINDS
        from ..runtime.pull_manager import PullPriority
        cluster = self._cluster
        head_row = cluster._head_row
        store = cluster.store
        for oid in object_ids:
            if oid in self._migrating:
                continue                    # pull already in flight
            kind, size = store.plasma_info(oid)
            if kind not in PLASMA_KINDS:
                continue                    # reclaimed since the scan
            self._migrating.add(oid)
            self.migrations_started += 1
            if cluster.pull_manager.request_pull(
                    oid, size, head_row, PullPriority.TASK_ARG,
                    callback=lambda ok, o=oid:
                    self._migration_done(o, ok)):
                self._migration_done(oid, True)     # already satisfied

    def _migration_done(self, oid, ok: bool) -> None:
        self._migrating.discard(oid)
        if ok:
            self.migrations_completed += 1
        else:
            self.migrations_failed += 1
            self._cluster.events.emit("autoscaler", "migration_failed",
                                      object_id=oid.hex())

    def stats(self) -> dict:
        return {"num_launched": self.num_launched,
                "num_terminated": self.num_terminated,
                "num_drained": self.num_drained,
                "migrations_started": self.migrations_started,
                "migrations_completed": self.migrations_completed,
                "migrations_failed": self.migrations_failed,
                "device_rounds": self.device_rounds,
                "oracle_rounds": self.oracle_rounds,
                "last_unmet": self.last_unmet}
