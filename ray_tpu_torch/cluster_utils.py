"""Simulated multi-node cluster — the ``cluster_utils.Cluster`` analogue.

Reference parity: upstream's ``python/ray/cluster_utils.py::Cluster`` starts
N real raylets + one GCS on a single machine with fabricated ``--resources``
JSON; all multi-node scheduling/spillback/PG/failure tests run against it
(SURVEY.md §4 simulated multi-node tier; mount empty).

Here a node = one ``Raylet`` (its own worker-process pool + its row in the
shared ``ClusterResourceManager``).  The process-local shared CRM/store IS
the GCS + ray_syncer of the single-host form: every raylet schedules
against the same authoritative resource view, so spillback converges in one
hop (the policy is deterministic in global row order — the destination
raylet recomputes the same answer and dispatches locally).
"""

from __future__ import annotations

import os
import tempfile
import threading
import uuid

import numpy as np

from .common.config import get_config
from .common.ids import NodeID
from .common.resources import NodeResources
from .runtime.object_directory import ObjectDirectory
from .runtime.object_ref import install_counter, uninstall_counter
from .runtime.object_store import MemoryStore, ObjectLostError
from .runtime.placement_group_manager import PlacementGroupManager
from .runtime.pull_manager import PullManager
from .runtime.raylet import Raylet
from .runtime.recovery import ObjectRecoveryManager
from .runtime.reference_counter import ReferenceCounter
from .runtime.task_manager import TaskManager
from .scheduling.cluster_resources import ClusterResourceManager
from .common import clock as _clk

# default simulated link rates (MB/s): same-node "transfers" are free;
# inter-node defaults to a 10 GB/s link until overridden via
# set_node_bandwidth
LOCAL_BW_MBPS = 1_000_000
DEFAULT_BW_MBPS = 10_000


def reap_stale_arenas(shm_dir: str = "/dev/shm") -> int:
    """Unlink arena files left by dead sessions (a killed owner never runs
    ``Arena.close``; upstream similarly cleans stale per-session state at
    startup).  Arena names embed the owner pid: ``rt_arena_<pid>_<tag>``.
    Returns the number of files reaped."""
    reaped = 0
    try:
        names = os.listdir(shm_dir)
    except OSError:
        return 0
    for name in names:
        if not name.startswith("rt_arena_"):
            continue
        parts = name.split("_")
        try:
            pid = int(parts[2])
        except (IndexError, ValueError):
            continue
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)             # owner alive?
        except ProcessLookupError:
            try:
                os.unlink(os.path.join(shm_dir, name))
                reaped += 1
            except OSError:
                pass
        except PermissionError:
            pass                        # alive, owned by another user
    return reaped


def _make_arena(session_dir: str):
    """Create the shared-memory arena backing the object store (plasma
    analogue); /dev/shm when available, session dir otherwise."""
    from .native import Arena
    cfg = get_config()
    capacity = cfg.object_store_memory_mb * 1024 * 1024
    name = f"rt_arena_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    try:
        reap_stale_arenas("/dev/shm")
        return Arena(os.path.join("/dev/shm", name), capacity, create=True)
    except OSError:
        return Arena(os.path.join(session_dir, name), capacity, create=True)


class Cluster:
    def __init__(self):
        # the device of the raylets' placement programs (the heartbeat,
        # the localized water-fill, bundle/pull/broadcast), resolved
        # once: without a GPU this raises here, at init, unless the
        # caller asked for scheduler_device="cpu"
        from .device import resolve_device
        self.scheduler_device = resolve_device(
            get_config().scheduler_device)
        self._lock = threading.RLock()
        self.crm = ClusterResourceManager()
        self.session_dir = tempfile.mkdtemp(prefix="ray_tpu_session_")
        self.arena = _make_arena(self.session_dir)
        spill_dir = get_config().object_spilling_dir or \
            os.path.join(self.session_dir, "spill")
        self.store = MemoryStore(arena=self.arena, spill_dir=spill_dir)
        self.task_manager = TaskManager()     # ownership is driver-central
        self.fn_registry: dict[str, bytes] = {}
        self.raylets: dict[int, Raylet] = {}  # row -> raylet
        self.actor_manager = None             # attached by the runtime
        self.pg_manager = PlacementGroupManager(self)
        self.directory = ObjectDirectory()
        # GCS control-plane siblings: namespaced KV + pubsub broker
        from .runtime.kv_pubsub import KVStore, PubSub
        self.kv = KVStore()
        self.pubsub = PubSub()
        from .runtime.runtime_env import RuntimeEnvManager
        self.runtime_env_manager = RuntimeEnvManager(self.session_dir)
        self.job_runtime_env = None           # set by api.init(runtime_env=)
        self.on_job_env_change = None         # AgentHub policy push hook
        self.default_namespace = ""           # set by api.init(namespace=):
        #   worker-side named-actor ops inherit it (workers carry no
        #   namespace of their own)
        # node-bandwidth matrix (MB/s) — the pull cost model's input;
        # grows with the CRM row space
        self.bandwidth_mbps = np.zeros((0, 0), dtype=np.int32)
        # wire-level object plane: this process's endpoint (serves the
        # head store once a server attaches it) + row -> remote plane
        # address for agent nodes (None = shares the head store)
        from .runtime.object_plane import ObjectPlane
        self.plane = ObjectPlane(self.store)
        self.planes: dict[int, str | None] = {}
        self.pull_manager = PullManager(self)
        # 1->N sibling of the pull manager: relay-tree weight
        # distribution over the same bandwidth matrix
        from .broadcast import BroadcastManager
        self.broadcasts = BroadcastManager(self)
        self.recovery = ObjectRecoveryManager(self)
        # owner-side reference counting: ObjectRefs created in this
        # (driver) process drive reclamation of out-of-scope objects
        self.ref_counter = ReferenceCounter()
        self.ref_counter.attach(self._reclaim_object, self.store.contains,
                                self.store.on_ready, self._expects_seal)
        install_counter(self.ref_counter)
        self.autoscaler = None          # attached by start_autoscaler
        from .runtime.events import EventLog
        self.events = EventLog(self.session_dir)
        from .runtime.health import HealthCheckManager
        self.health = HealthCheckManager(self)
        self.health.start()
        # elastic serve<->batch capacity loaning (LOANED rows atop the
        # CRM); ticked from the autoscaler round and the health round
        from .serve.loaning import CapacityLoanManager
        self.loans = CapacityLoanManager(self)
        port = get_config().metrics_export_port
        self.metrics = None
        if port:
            from .runtime.metrics import MetricsExporter
            self.metrics = MetricsExporter(self, port)
        dash_port = get_config().dashboard_port
        self.dashboard = None
        if dash_port:
            from .runtime.dashboard import Dashboard
            self.dashboard = Dashboard(self, dash_port,
                                       host=get_config().dashboard_host)
        self._head_row: int | None = None
        self._stack_waits: dict[str, tuple] = {}    # live stack dumps
        # node drain lifecycle (ALIVE -> DRAINING -> removed/dead):
        # NodeID -> status dict; completed drains stay for status queries
        self._drains: dict[NodeID, dict] = {}

    def _reclaim_object(self, oid) -> None:
        """Refcount hit zero cluster-wide: free the object everywhere and
        release producing-task lineage once all its returns are dead."""
        rows = self.directory.locations(oid)
        self.store.delete([oid])
        self.directory.drop([oid])
        # copies on agent planes free over the wire (best-effort, off
        # the refcount thread)
        for row in rows:
            addr = self.planes.get(row)
            if addr is not None:
                self.plane.free_on(addr, [oid])
        self.task_manager.on_return_reclaimed(oid)

    # -- live worker stack sampling (SURVEY §5.1(c): the dashboard's
    # py-spy integration, rebuilt on the worker reader thread) ---------------
    def dump_worker_stacks(self, row: int | None = None,
                           timeout: float = 5.0) -> dict:
        """Ask every live worker (one node's with ``row``) what it is
        doing RIGHT NOW: {(row, worker_index): all-thread stack text}.
        Workers answer from their reader thread, so one wedged in user
        code still reports — that wedge is exactly what this shows."""
        import uuid
        req = uuid.uuid4().hex
        ev = threading.Event()
        out: dict = {}
        expected = [0]
        self._stack_waits[req] = (ev, out, expected)
        try:
            with self._lock:
                targets = [(r, ry) for r, ry in self.raylets.items()
                           if row is None or r == row]
            sent = 0
            for r, raylet in targets:
                with raylet.pool._lock:
                    workers = list(raylet.pool._workers)
                for w in workers:
                    if not w.dead and w.ready and \
                            w.send(("dump_stacks", req)):
                        sent += 1
            expected[0] = sent
            if sent and len(out) < sent:
                ev.wait(timeout)
            return dict(out)
        finally:
            self._stack_waits.pop(req, None)

    def _on_stacks_reply(self, req: str, row: int, index: int,
                         text: str) -> None:
        entry = self._stack_waits.get(req)
        if entry is None:
            return          # late reply after timeout: drop
        ev, out, expected = entry
        out[(row, index)] = text
        if expected[0] and len(out) >= expected[0]:
            ev.set()

    def set_job_runtime_env(self, env: dict | None) -> None:
        """Install the job-level default runtime_env and notify any
        attached agent hub: autonomous agents are env-blind, so a job
        env appearing must gate their fast path off."""
        self.job_runtime_env = env
        hook = self.on_job_env_change
        if hook is not None:
            hook(env)

    def _expects_seal(self, oid) -> bool:
        """Will an absent object ever seal?  Only a pending task return
        can; puts and deleted markers never re-seal."""
        if oid.is_put():
            return False
        rec = self.task_manager.get(oid.task_id())
        return rec is not None and not rec.done

    # -- topology -----------------------------------------------------------
    def add_node(self, resources: dict[str, float] | None = None,
                 num_workers: int = 2,
                 labels: dict[str, str] | None = None,
                 wait: bool = True, spawner=None,
                 inline_objects: bool = False,
                 plane_address: str | None = None) -> NodeID:
        resources = resources or {"CPU": 2, "memory": 2}
        node_id = NodeID.from_random()
        with self._lock:
            row = self.crm.add_node(node_id,
                                    NodeResources(resources, labels))
            self._grow_bandwidth(row + 1)
            if plane_address is not None:
                self.planes[row] = plane_address
            raylet = Raylet(node_id, self, num_workers, spawner=spawner,
                            inline_objects=inline_objects,
                            plane_address=plane_address)
            raylet.actor_manager = self.actor_manager
            self.raylets[row] = raylet
            if self._head_row is None:
                self._head_row = row
        try:
            raylet.start()
        except BaseException:
            # a remote spawner can fail mid-start (agent gone): unwind
            # the CRM row so the scheduler never places onto a node
            # whose raylet never ran
            with self._lock:
                self.raylets.pop(row, None)
                self.planes.pop(row, None)
                self.crm.remove_node(node_id)
                if self._head_row == row:
                    self._head_row = None
            raise
        self.events.emit("node", "node_added", node_row=row,
                         node_id=node_id.hex(), resources=resources)
        self.pubsub.publish("node", {"event": "added", "row": row,
                                     "node_id": node_id.hex()})
        if wait and num_workers:
            raylet.pool.wait_ready(num_workers, timeout=60.0)
        # wake every existing raylet: tasks parked as infeasible may now
        # have a feasible node (reference: node arrival triggers a
        # scheduling round on every raylet via the resource broadcast)
        self.wake_raylets(exclude=raylet)
        return node_id

    def add_remote_node(self, resources: dict[str, float] | None = None,
                        num_workers: int = 2, spawner=None,
                        labels: dict[str, str] | None = None,
                        plane_address: str | None = None) -> NodeID:
        """A node whose worker processes live behind a node agent on
        another machine (``runtime/node_agent.py``): same raylet, same
        scheduling row — only the process transport differs.  The
        agent ALWAYS runs its own arena (``plane_address`` is
        mandatory): objects move arena-to-arena over the object plane,
        exec/get frames carry by-reference descriptors the agent
        resolves locally.  The legacy relay-only mode (every payload
        in-band through the head) is gone — one data-plane code path."""
        if plane_address is None:
            raise ValueError(
                "remote nodes require a plane_address: relay-only "
                "agents (payloads in-band through the head) were "
                "removed — run a NodeAgent, which always serves an "
                "object plane")
        return self.add_node(resources=resources, num_workers=num_workers,
                             labels=labels, spawner=spawner,
                             inline_objects=True,
                             plane_address=plane_address)

    def _grow_bandwidth(self, n: int) -> None:
        """Extend the bandwidth matrix to cover ``n`` rows (caller holds
        the lock)."""
        old = self.bandwidth_mbps.shape[0]
        if n <= old:
            return
        bw = np.full((n, n), DEFAULT_BW_MBPS, dtype=np.int32)
        np.fill_diagonal(bw, LOCAL_BW_MBPS)
        bw[:old, :old] = self.bandwidth_mbps
        self.bandwidth_mbps = bw

    def set_node_bandwidth(self, src_row: int, dst_row: int,
                           mbps: int, symmetric: bool = True) -> None:
        """Override a link rate in the pull cost model (tests/operators)."""
        with self._lock:
            self.bandwidth_mbps[src_row, dst_row] = mbps
            if symmetric:
                self.bandwidth_mbps[dst_row, src_row] = mbps

    def register_location(self, oid, row: int) -> None:
        """Record that a freshly sealed plasma-routed object was born on
        ``row`` (in-band values have no locations — they ship with specs)."""
        kind, _ = self.store.plasma_info(oid)
        if kind in ("shm", "spill"):
            self.directory.add_location(oid, row)

    def seal_serialized(self, oid, data, row: int) -> None:
        """Seal a serialized payload born on ``row`` with the directory
        entry registered BEFORE the seal: sealing wakes dependent-task
        placement and driver gets, which read the directory for locality
        — registering after would race an empty entry."""
        plasma = self.store.routes_to_plasma(len(data))
        if plasma:
            self.directory.add_location(oid, row)
        self.store.put_serialized(oid, data)
        if plasma and self.store.plasma_info(oid)[0] not in ("shm",
                                                            "spill"):
            self.directory.drop([oid])  # store-full in-band fallback
        elif not plasma:
            self.register_location(oid, row)

    def remove_node(self, node_id: NodeID) -> None:
        """Simulate node death: resources vanish, running tasks retried
        elsewhere (or failed), queued tasks re-routed, actors restarted or
        declared dead, plasma objects whose only copy lived there are LOST
        (SURVEY §5.3 failure semantics)."""
        with self._lock:
            row = self.crm.row_of(node_id)
            if row is None or row == self._head_row:
                raise ValueError("cannot remove head node or unknown node")
            raylet = self.raylets.pop(row)
            self.planes.pop(row, None)
            self.crm.remove_node(node_id)
        self.events.emit("node", "node_removed", node_row=row,
                         node_id=node_id.hex())
        self.pubsub.publish("node", {"event": "removed", "row": row,
                                     "node_id": node_id.hex()})
        lost = self.directory.on_node_removed(row)
        self.pull_manager.on_objects_lost(lost)
        from .runtime.serialization import RayTaskError
        for oid in lost:
            # a lost object sealed on an agent plane left a metadata-only
            # RemoteEntry in the head store: drop it BEFORE re-driving
            # lineage so readers wait for the fresh seal (or see the
            # poison below) instead of materializing stale metadata
            self.store.drop_remote_entry(oid)
            # lineage first: reconstructable objects re-execute their
            # producing task and re-seal; only unrecoverable ones poison
            # (SURVEY §5.3 — reconstruction, else ObjectLostError)
            if self.recovery.recover(oid):
                continue
            self.store.poison(oid, RayTaskError(
                "object", f"object {oid.hex()[:12]} is lost: the node "
                "holding its only copy died", ObjectLostError(
                    f"object {oid.hex()[:12]} lost with node "
                    f"{node_id.hex()[:12]}")))
        self.pg_manager.on_node_removed(row)
        raylet.drain_for_removal(self.head())
        # wake every SURVIVING raylet: a task parked infeasible behind
        # a pin/label on the removed node must re-reach placement so
        # the dead-node fail-fast (or a re-place) fires — membership
        # changes re-trigger scheduling in both directions, like
        # add_node's wake (reference: the resource broadcast)
        self.wake_raylets()

    # -- graceful drain (ALIVE -> DRAINING -> removed/dead) ------------------
    def drain_node(self, node_id: NodeID, reason: str = "",
                   deadline_s: float | None = None) -> dict:
        """Gracefully retire a node (preemption notice, scale-down).

        The node is masked out of every placement view immediately (no
        new leases or PG bundles land on it), its queued/pipelined work
        re-enters global scheduling, its PG bundles re-place atomically
        elsewhere, and sole-copy plasma objects migrate to the head.
        Running tasks finish normally.  A monitor thread removes the
        node once it is empty — or at ``deadline_s``, whichever comes
        first; a node that DIES mid-drain converges through the health
        manager's dead path.  Returns the drain status dict immediately
        (poll ``drain_status`` or join via ``wait_for_drain``)."""
        if deadline_s is None:
            deadline_s = get_config().drain_deadline_s
        with self._lock:
            row = self.crm.row_of(node_id)
            if row is None or row == self._head_row:
                raise ValueError("cannot drain head node or unknown node")
            st = self._drains.get(node_id)
            if st is not None and st["state"] == "DRAINING":
                return self._drain_view(st)     # idempotent
            self.crm.set_draining(node_id, True)
            st = {"node_id": node_id.hex(), "row": row, "reason": reason,
                  "deadline_s": float(deadline_s), "state": "DRAINING",
                  "outcome": None, "started": _clk.monotonic(),
                  "migrated_objects": 0, "displaced_groups": 0}
            self._drains[node_id] = st
            raylet = self.raylets.get(row)
        self.events.emit("node", "node_draining", node_row=row,
                         node_id=node_id.hex(), reason=reason,
                         deadline_s=deadline_s)
        # drain notice BEFORE displacing work: subscribers (the elastic
        # trainer) get the chance to checkpoint-and-resize proactively
        self.pubsub.publish("node", {"event": "draining", "row": row,
                                     "node_id": node_id.hex(),
                                     "reason": reason,
                                     "deadline_s": deadline_s})
        st["displaced_groups"] = self.pg_manager.on_node_draining(row)
        if raylet is not None:
            raylet.start_graceful_drain()
            # remote node: tell its agent to stop autonomous local
            # dispatch and hand queued leases back (best-effort — a
            # dead agent converges via the health manager anyway)
            sp = getattr(raylet.pool, "_spawner", None)
            if sp is not None and hasattr(sp, "drain_remote"):
                try:
                    sp.drain_remote()
                except Exception:   # noqa: BLE001
                    pass
        self.wake_raylets()         # requeued backlog needs a round
        thread = threading.Thread(target=self._drain_monitor,
                                  args=(node_id, st), daemon=True,
                                  name=f"drain-{row}")
        st["_thread"] = thread
        thread.start()
        return self._drain_view(st)

    def _drain_monitor(self, node_id: NodeID, st: dict) -> None:
        poll = max(get_config().drain_poll_ms, 1) / 1000.0
        deadline = st["started"] + st["deadline_s"]
        row = st["row"]
        from .runtime.pull_manager import PullPriority
        inflight: dict = {}         # oid -> pull in flight
        mlock = threading.Lock()

        def _migrated(oid):
            def cb(ok: bool) -> None:
                with mlock:
                    inflight.pop(oid, None)
                    if ok:
                        st["migrated_objects"] += 1
            return cb

        while True:
            with self._lock:
                gone = self.crm.row_of(node_id) is None
                raylet = self.raylets.get(row)
            if gone:        # died mid-drain: health manager removed it
                self._finish_drain(node_id, st, "dead")
                return
            # migrate sole copies to the head — re-scanned every tick
            # because RUNNING tasks keep sealing new objects mid-drain
            sole = self.directory.sole_copies_on(row)
            for oid in sole:
                with mlock:
                    if oid in inflight:
                        continue
                    inflight[oid] = True
                _kind, size = self.store.plasma_info(oid)
                if self.pull_manager.request_pull(
                        oid, size, self._head_row, PullPriority.TASK_ARG,
                        callback=_migrated(oid)):
                    with mlock:     # already at the head
                        inflight.pop(oid, None)
            with mlock:
                migrating = bool(inflight)
            if raylet is None or (raylet.drain_empty() and not migrating
                                  and not sole):
                outcome = "drained"
            elif _clk.monotonic() >= deadline:
                outcome = "deadline"    # grace expired: forced removal
            else:
                _clk.sleep(poll)
                continue
            try:
                self.remove_node(node_id)
            except (ValueError, KeyError):
                outcome = "dead"        # node death raced the removal
            self._finish_drain(node_id, st, outcome)
            return

    def _finish_drain(self, node_id: NodeID, st: dict,
                      outcome: str) -> None:
        st["outcome"] = outcome
        st["state"] = "DEAD" if outcome == "dead" else "REMOVED"
        st["elapsed_s"] = round(_clk.monotonic() - st["started"], 3)
        self.events.emit("node", "node_drain_finished",
                         node_row=st["row"], node_id=st["node_id"],
                         outcome=outcome, elapsed_s=st["elapsed_s"],
                         migrated_objects=st["migrated_objects"],
                         displaced_groups=st["displaced_groups"])

    @staticmethod
    def _drain_view(st: dict) -> dict:
        return {k: v for k, v in st.items() if not k.startswith("_")}

    def drain_status(self, node_id: NodeID | None = None):
        """Status dict for one node's drain (None if never drained), or
        every drain this cluster has seen."""
        with self._lock:
            if node_id is not None:
                st = self._drains.get(node_id)
                return None if st is None else self._drain_view(st)
            return [self._drain_view(st) for st in self._drains.values()]

    def is_draining(self, node_id: NodeID) -> bool:
        with self._lock:
            st = self._drains.get(node_id)
            return st is not None and st["state"] == "DRAINING"

    def wait_for_drain(self, node_id: NodeID,
                       timeout: float | None = None) -> dict | None:
        """Block until a started drain finishes; returns its status."""
        with self._lock:
            st = self._drains.get(node_id)
        if st is None:
            return None
        thread = st.get("_thread")
        if thread is not None:
            thread.join(timeout)
        return self._drain_view(st)

    def wake_raylets(self, exclude=None) -> None:
        """Re-trigger every raylet's scheduling loop (cluster
        membership/resource events): snapshot under the lock, notify
        outside it."""
        with self._lock:
            raylets = [r for r in self.raylets.values()
                       if r is not exclude]
        for r in raylets:
            r._notify_dirty()

    def start_autoscaler(self, node_types, **kwargs) -> "StandardAutoscaler":
        """Attach + start the autoscaler runtime loop (reference:
        the monitor process running StandardAutoscaler.update)."""
        from .autoscaler.autoscaler import StandardAutoscaler
        self.autoscaler = StandardAutoscaler(self, node_types, **kwargs)
        self.autoscaler.start()
        return self.autoscaler

    def head(self) -> Raylet:
        return self.raylets[self._head_row]

    def raylet_of_row(self, row: int) -> Raylet | None:
        with self._lock:
            return self.raylets.get(row)

    def stream_ack(self, task_id, consumed: int) -> None:
        """Route a streaming-generator consumption ack to whichever
        worker runs the producer — a task's raylet or a streaming actor
        call's dedicated worker (best-effort)."""
        if self.actor_manager is not None and \
                self.actor_manager.stream_ack(task_id, consumed):
            return
        with self._lock:
            raylets = list(self.raylets.values())
        for r in raylets:
            if r.stream_ack(task_id, consumed):
                return

    def stream_close(self, task_id, consumed: int) -> None:
        """Consumer finished/abandoned a stream: cancel the producer
        cooperatively (it stops yielding at its next backpressure
        check) and reclaim sealed-but-unconsumed items everywhere."""
        orphans = self.task_manager.stream_close(task_id, consumed)
        cancelled = (self.actor_manager is not None
                     and self.actor_manager.stream_cancel(task_id))
        if not cancelled:
            with self._lock:
                raylets = list(self.raylets.values())
            for r in raylets:
                if r.stream_cancel(task_id):
                    break
        for oid in orphans:
            if self.store.contains(oid):
                # through the counter, not _reclaim_object directly:
                # refs pickled INSIDE sealed-but-unconsumed items must
                # release with them (contained-entry bookkeeping)
                self.ref_counter.force_reclaim(oid)

    def cancel_task(self, task_id, force: bool = False) -> bool:
        """Cancel wherever the task lives — any node's queues, running
        set, or agent lease (drivers and the client-mode head RPC both
        route here)."""
        head = self.head()
        if head.cancel(task_id, force=force):
            return True
        with self._lock:
            raylets = list(self.raylets.values())
        for r in raylets:
            if r is not head and r.cancel(task_id, force=force):
                return True
        return False

    # -- routing (spillback) ------------------------------------------------
    def route_local(self, row: int, task_id) -> bool:
        """Deliver a PLACED task into the target node's local dispatch
        queue (the task is scheduled exactly once)."""
        return self.route_local_batch(row, [task_id])

    def route_local_batch(self, row: int, task_ids: list) -> bool:
        """Deliver a beat's whole per-node lease group in one call (the
        fused schedule->lease->dispatch hand-off: no per-task boundary
        crossing between the placement readback and the target's
        dispatch queue)."""
        target = self.raylet_of_row(row)
        if target is None:
            return False
        target.enqueue_local_batch(list(task_ids))
        return True

    # -- GCS persistence -----------------------------------------------------
    def save_gcs_snapshot(self, path: str) -> str:
        """Persist the GCS metadata plane — KV table, function/class
        registry, live named-actor creation specs — the reference's
        Redis-backed GCS fault tolerance (``RedisStoreClient``,
        SURVEY.md §5.4).  Object-store contents and running tasks are
        NOT persisted (upstream behaves the same: objects re-derive
        from lineage or are lost; detached actors RESTART)."""
        import pickle
        # actor specs BEFORE the registry copy: create_actor registers
        # class bytes before the record becomes visible, so every spec
        # captured here is guaranteed resolvable in the later registry
        # snapshot (the reverse order can capture an actor whose bytes
        # missed the copy)
        named = (self.actor_manager.named_actor_specs()
                 if self.actor_manager else [])
        snap = {"named_actors": named,
                "fn_registry": dict(self.fn_registry),
                "kv": self.kv.snapshot()}
        # writer-unique tmp name: two concurrent savers (persist tick
        # vs final stop snapshot) must not truncate each other's file
        # and promote a torn pickle
        import threading as _threading
        tmp = f"{path}.tmp.{os.getpid()}.{_threading.get_ident()}"
        with open(tmp, "wb") as f:
            pickle.dump(snap, f)
        os.replace(tmp, path)       # atomic: no torn snapshot
        return path

    def restore_gcs_snapshot(self, path: str) -> None:
        """Load a snapshot into THIS cluster: KV + registry restore
        in-place; named actors are RE-CREATED (fresh incarnation, ctor
        re-runs — reference detached-actor restart semantics).
        Requires an attached actor_manager and at least one node."""
        import pickle

        from .common.ids import ActorID, JobID
        from .runtime.serialization import deserialize
        with open(path, "rb") as f:
            snap = pickle.load(f)
        # validate EVERYTHING before mutating anything: a failed restore
        # must not leave the cluster half its own state, half snapshot
        if self.actor_manager is None and snap["named_actors"]:
            raise RuntimeError("attach an actor manager (ray_tpu_torch.init) "
                               "before restoring named actors")
        for spec in snap["named_actors"]:
            if spec["cls_id"] not in snap["fn_registry"]:
                raise RuntimeError(
                    f"snapshot is missing class bytes for named actor "
                    f"{spec['name']!r}")
        self.kv.restore(snap["kv"])
        for fn_id, fn_bytes in snap["fn_registry"].items():
            self.fn_registry.setdefault(fn_id, fn_bytes)
        job_id = JobID.next()
        skipped = []
        for spec in snap["named_actors"]:
            ns = spec.get("namespace", "")
            if self.actor_manager.get_by_name(spec["name"],
                                              ns) is not None:
                skipped.append(spec["name"])    # live actor wins
                continue
            args, kwargs = deserialize(spec["init"])
            self.actor_manager.create_actor(
                ActorID.of(job_id), spec["cls_id"],
                self.fn_registry.get(spec["cls_id"]), args, kwargs,
                spec["max_restarts"], spec["max_task_retries"],
                spec["name"], resources=spec["resources"],
                runtime_env=spec["runtime_env"],
                namespace=ns, lifetime=spec.get("lifetime"))
        if skipped:
            self.events.emit("gcs", "restore_skipped_actors",
                             names=skipped)

    # -- teardown -----------------------------------------------------------
    def stop(self) -> None:
        self.health.shutdown()
        if self.autoscaler is not None:
            self.autoscaler.shutdown()
        uninstall_counter(self.ref_counter)
        self.ref_counter.shutdown()
        self.pg_manager.shutdown()
        self.pull_manager.shutdown()
        self.broadcasts.shutdown()
        self.plane.shutdown()
        with self._lock:
            raylets = list(self.raylets.values())
            self.raylets.clear()
        for r in raylets:
            r.stop()
        if self.metrics is not None:
            self.metrics.shutdown()
        if self.dashboard is not None:
            self.dashboard.shutdown()
        self.events.close()
        self.arena.close()
        import shutil
        shutil.rmtree(self.session_dir, ignore_errors=True)
