"""Raylet: per-node task queueing, scheduling, dispatch, and completion.

Reference parity: the raylet's ``NodeManager`` + ``ClusterTaskManager``
(queue by scheduling class, schedule per event-loop turn via
``ClusterResourceScheduler::GetBestSchedulableNode``) + ``LocalTaskManager``
(resource allocation + worker handout) + ``DependencyManager`` (hold tasks
until args exist) + spillback to the chosen remote raylet — ``src/ray/
raylet/``, SURVEY.md §1 layer 4 / §3.2 hot loop; mount empty.

Device-first: when a scheduling round's batch is big enough and uniformly
default-strategy, the WHOLE batch is placed by the device water-fill kernel
(the delta heartbeat, or ``ray_tpu_torch.ops.schedule_grouped`` and the
localized kernel) in one call — the north-star data plane
running inside the live runtime.  Small or mixed batches take the per-task
CPU policy, which is bit-identical by the parity contract, so the switch is
invisible to callers (``scheduler_device_backend`` config).

The scheduling loop is event-driven (condition variable, not a busy tick):
it wakes on task arrival, dependency readiness, worker release, and
resource release — the same wake set as the reference's asio event loop.
"""

from __future__ import annotations

import threading
from collections import deque

import numpy as np

from ..common.config import get_config
from ..common.ids import TaskID
from ..common.resources import ResourceRequest
from ..common.task_spec import SchedulingStrategyKind
from ..scheduling.policy import (CompositeSchedulingPolicy,
                                 SchedulingOptions, SchedulingType)
from .object_ref import ObjectRef
from .serialization import (RayTaskError, WorkerCrashedError, deserialize,
                            serialize)
from .worker_pool import WorkerHandle, WorkerPool
from ..common import clock as _clk


class _ClassQueue:
    """Dispatch queue bucketed by scheduling-class key, FIFO per class
    (the reference ClusterTaskManager keys its dispatch queues by
    SchedulingClass — SURVEY.md §1 layer 4).  All mutation runs under
    the owning raylet's ``_cv``; iteration order is class insertion
    order, FIFO within a class."""

    __slots__ = ("_by", "_key_of")

    def __init__(self):
        self._by: dict = {}             # class key -> deque[TaskID]
        self._key_of: dict = {}         # TaskID -> class key

    def append(self, task_id, key=None) -> None:
        self._key_of[task_id] = key
        dq = self._by.get(key)
        if dq is None:
            dq = self._by[key] = deque()
        dq.append(task_id)

    def remove(self, task_id) -> None:
        """Raises ValueError when absent (deque.remove contract)."""
        try:
            key = self._key_of.pop(task_id)
        except KeyError:
            raise ValueError(task_id) from None
        dq = self._by[key]
        dq.remove(task_id)
        if not dq:
            del self._by[key]

    def classes(self) -> list:
        return list(self._by)

    def bucket(self, key):
        return self._by.get(key, ())

    def clear(self) -> None:
        self._by.clear()
        self._key_of.clear()

    def __contains__(self, task_id) -> bool:
        return task_id in self._key_of

    def __len__(self) -> int:
        return len(self._key_of)

    def __bool__(self) -> bool:
        return bool(self._key_of)

    def __iter__(self):
        for dq in list(self._by.values()):
            yield from list(dq)


class Raylet:
    def __init__(self, node_id, cluster, num_workers: int,
                 spawner=None, inline_objects: bool = False,
                 plane_address: str | None = None):
        self.node_id = node_id
        self.cluster = cluster
        # remote-node raylet: workers live on another machine (node
        # agent) and share no arena with the head.  The agent always
        # runs its own arena (plane_address mandatory for remote
        # nodes): plasma args/results move over the object plane and
        # frames carry by-REFERENCE descriptors the agent resolves
        # against its local store.  inline_objects marks the no-shared-
        # arena transport (small values still ship in-band in frames)
        self.inline_objects = inline_objects
        self.plane_address = plane_address
        self.remote_plane = plane_address is not None
        self.crm = cluster.crm
        self.row = self.crm.row_of(node_id)
        self.store = cluster.store
        self.task_manager = cluster.task_manager
        self._fn_registry = cluster.fn_registry
        self._policy = CompositeSchedulingPolicy()
        self._cv = threading.Condition()
        self._queue: deque[TaskID] = deque()        # awaiting PLACEMENT
        self._local_queue = _ClassQueue()   # placed here, await dispatch
        self._planned_cu = None     # dense planned-load vector (lazy width)
        self._waiting: dict[TaskID, int] = {}   # task -> missing dep count
        self._pull_pending: dict[TaskID, int] = {}  # task -> in-flight pulls
        # task_id_bin -> (TaskID, WorkerHandle, pinned shm-arg batch)
        self._running: dict[bytes, tuple[TaskID, WorkerHandle, list]] = {}
        self._task_start: dict[bytes, float] = {}   # timeline spans
        self._round_durations: deque = deque(maxlen=256)    # metrics p50
        self._local_since: dict[TaskID, float] = {}  # lease-wait clocks
        # first time a task missed pop_idle for its runtime env (grace
        # for env-worker growth is measured from HERE, not queue entry —
        # a task long-queued for unrelated reasons must still wait out
        # the grace before the cache grows)
        self._env_miss_since: dict[TaskID, float] = {}
        self._env_staging: set[str] = set()     # env keys staging off-thread
        # count of pipelined-lease entries across all workers: while
        # nonzero the event loop wakes periodically to reconcile
        # entries stranded by commit races (worker released/blocked/
        # died between pipeline_target and the commit)
        self._assigned_total = 0
        self._avoid_local: set[TaskID] = set()  # lease-spilled: skip here
        # last _effective_snapshot soft-masked SUSPECT rows out (gray
        # failures): tells _schedule_rows a -1 deserves a full-cluster
        # fallback pass before parking the task
        self._suspect_softmask = False
        # device-resident delta-heartbeat engine (lazy: only rounds that
        # take the plain device path ever build one)
        self._delta_engine = None
        # placement rounds of all-default batches, by route: the device
        # programs (_schedule_rows_device) or their host twin; of the
        # device rounds, those the delta beat placed (the rest upload a
        # snapshot: a locality row or an avoid flag in the batch) and
        # those that spread over top-k keys (scheduler_top_k_fraction)
        self.device_rounds = 0
        self.host_rounds = 0
        self.delta_rounds = 0
        self.topk_rounds = 0
        self._stopped = False
        # DRAINING: no new leases commit here, running tasks finish;
        # the pool and event loop stay alive (unlike _stopped) so the
        # node keeps scheduling its backlog onto OTHER rows
        self._draining = False
        self._dirty = False     # wake flag: new task / capacity / worker
        self.actor_manager = None   # attached by the runtime/cluster
        # agent-autonomous dispatch bookkeeping (plane agents only):
        # tasks the AGENT leased locally without a head round-trip —
        # registered here via the batched agent_sync so lineage,
        # ownership, and node-death recovery still work
        self.agent_inflight: dict = {}          # TaskID -> TaskRecord
        self.agent_local_cu: dict | None = None  # live local demand
        arena = getattr(cluster, "arena", None)
        self.pool = WorkerPool(
            num_workers, self._on_worker_message, self._on_worker_death,
            on_idle=self._notify_dirty,
            arena_path=(arena.path if arena and not inline_objects
                        else None),
            spawner=spawner)
        self.pool.node_id_hex = node_id.hex()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"raylet-{self.row}")

    def start(self) -> None:
        self.pool.start()
        self._thread.start()

    # -- submission ---------------------------------------------------------
    def submit(self, spec) -> None:
        """Register + enter scheduling.  Deliberately returns NO
        ObjectRefs: result refs are the caller's to create BEFORE
        submitting (owner-side refcounting — a transient ref made here
        and dropped would dip the count to zero and could reclaim the
        result under a caller that has not built its refs yet)."""
        job_env = self.cluster.job_runtime_env
        if job_env:
            from .runtime_env import merge_runtime_env
            spec.runtime_env = merge_runtime_env(job_env, spec.runtime_env)
        self.submit_existing(self.task_manager.register(spec))

    def submit_existing(self, rec) -> None:
        """(Re-)enter an already-registered task into scheduling — the
        lineage-reconstruction resubmit path shares this with first
        submission (reference: reconstruction re-drives the normal task
        path with attempt_number bumped)."""
        spec = rec.spec
        deps = [a.id for a in spec.args if isinstance(a, ObjectRef)]
        missing = [d for d in deps if not self.store.contains(d)]
        if missing:
            with self._cv:
                self._waiting[spec.task_id] = len(missing)
            for d in missing:
                self.store.on_ready(d, lambda _oid, t=spec.task_id:
                                    self._dep_ready(t))
        else:
            self._enqueue(spec.task_id)

    def enqueue_forwarded(self, task_id: TaskID) -> None:
        """Arrival needing (re-)placement (deps already resolved)."""
        self._enqueue(task_id)

    # -- autoscaler hooks ----------------------------------------------------
    def pending_demand(self) -> list:
        """Resource requests of tasks awaiting placement here (infeasible
        parks) AND placed-but-undispatched backlog (resource-starved local
        queue) — the raylet's share of autoscaler demand (reference:
        LoadMetrics resource_load_by_shape includes both).  Local backlog
        is safe to report: the packing pass fits demand onto existing free
        capacity first, so only genuinely-starved tasks launch nodes."""
        with self._cv:
            ids = list(self._queue) + list(self._local_queue)
        out = []
        for tid in ids:
            rec = self.task_manager.get(tid)
            if rec is not None and not rec.done:
                out.append(rec.spec.resources)
        return out

    def is_idle(self) -> bool:
        """No queued, waiting, placed, or running work on this node
        (including tasks its agent leased autonomously)."""
        with self._cv:
            return not (self._queue or self._local_queue or self._running
                        or self._waiting or self._pull_pending
                        or self.agent_inflight)

    def queue_stats(self) -> dict:
        """Live depths + recent scheduling-round durations (metrics)."""
        with self._cv:
            return {"pending": len(self._queue) + len(self._waiting),
                    "placed": len(self._local_queue),
                    "running": len(self._running),
                    "round_durations": list(self._round_durations)}

    # -- health (GCS health-check manager probes this) -----------------------
    def ping(self) -> None:
        """Health ping: wake the event loop so it re-stamps its pong
        (reference: the raylet answering the GCS health-check RPC proves
        its main loop turns)."""
        self._notify_dirty()

    @property
    def last_pong(self) -> float:
        return getattr(self, "_last_pong", 0.0)

    def health_vitals(self) -> dict:
        """Structural liveness (the manager decides staleness by comparing
        ``last_pong`` against its own previous ping time)."""
        return {
            "thread_alive": self._thread.is_alive(),
            "workers_alive": (self.pool.num_alive() > 0
                              or self.pool.expected() == 0),
            "last_pong": self.last_pong,
        }

    def enqueue_local(self, task_id: TaskID) -> None:
        """Placement decided: this node owns the task until dispatch.

        Tasks are scheduled ONCE (reference: ClusterTaskManager places,
        then the task waits in LocalTaskManager for workers/resources —
        it is not re-scheduled on every worker event).  The planned load
        is visible to subsequent scheduling rounds so they do not
        over-assign this node.  Plasma args not yet local are pulled at
        task-arg priority; dispatch waits for the copies (reference:
        DependencyManager asks the PullManager for task args)."""
        self.enqueue_local_batch([task_id])

    def enqueue_local_batch(self, task_ids: list[TaskID]) -> None:
        """Batched placement hand-off: a beat's whole lease group for
        this node lands with one record-lookup pass and ONE queue
        critical section instead of a per-task boundary crossing (the
        fused schedule->lease->dispatch path).  Semantics per task are
        exactly ``enqueue_local``'s, drain-race bounce included."""
        if self._draining:
            # route_local raced the drain: back to global scheduling
            for task_id in task_ids:
                self._enqueue(task_id)
            return
        recs = self.task_manager.get_many(task_ids)
        pulls_by_task: dict[TaskID, list] = {}
        from .object_store import PLASMA_KINDS
        for task_id, rec in zip(task_ids, recs):
            if rec is None:
                continue
            pulls = []
            for a in rec.spec.args:
                if isinstance(a, ObjectRef):
                    kind, size = self.store.plasma_info(a.id)
                    if kind in PLASMA_KINDS and \
                            not self.cluster.directory.has_location(
                                a.id, self.row):
                        pulls.append((a.id, size))
            if pulls:
                pulls_by_task[task_id] = pulls
        with self._cv:
            now = _clk.monotonic()
            for task_id, rec in zip(task_ids, recs):
                if rec is not None:
                    self._planned_add(rec.spec.resources, 1)
                if task_id in pulls_by_task:
                    self._pull_pending[task_id] = len(
                        pulls_by_task[task_id])
                self._local_queue.append(
                    task_id,
                    rec.spec.resources.key() if rec is not None else None)
                self._local_since[task_id] = now
            self._dirty = True
            self._cv.notify_all()
        if self._draining:
            # a placement round snapshotted before the drain mask landed
            # routed here: bounce straight back to global scheduling so
            # the guarantee "zero new leases after drain_node" holds
            with self._cv:
                for task_id, rec in zip(task_ids, recs):
                    if task_id in self._local_queue:
                        self._local_queue.remove(task_id)
                        self._local_since.pop(task_id, None)
                        self._pull_pending.pop(task_id, None)
                        if rec is not None:
                            self._planned_add(rec.spec.resources, -1)
                        self._queue.append(task_id)
                self._cv.notify_all()
        if pulls_by_task:
            from .pull_manager import PullPriority
            for task_id, pulls in pulls_by_task.items():
                for oid, size in pulls:
                    self.cluster.pull_manager.request_pull(
                        oid, size, self.row, PullPriority.TASK_ARG,
                        callback=lambda _ok, t=task_id: self._pull_done(t))

    def _pull_done(self, task_id: TaskID) -> None:
        with self._cv:
            left = self._pull_pending.get(task_id)
            if left is None:
                return
            if left <= 1:
                del self._pull_pending[task_id]
                self._dirty = True
                self._cv.notify_all()
            else:
                self._pull_pending[task_id] = left - 1

    def _planned_add(self, resources, sign: int) -> None:
        # caller holds _cv
        vec = resources.dense(self.crm.resource_index,
                              self.crm.avail.shape[1])
        if self._planned_cu is None or \
                self._planned_cu.shape[0] < vec.shape[0]:
            import numpy as _np
            new = _np.zeros(vec.shape[0], dtype=_np.int64)
            if self._planned_cu is not None:
                new[:self._planned_cu.shape[0]] = self._planned_cu
            self._planned_cu = new
        if sign > 0:
            self._planned_cu[:vec.shape[0]] += vec
        else:
            self._planned_cu[:vec.shape[0]] -= vec

    def planned_snapshot(self):
        with self._cv:
            return None if self._planned_cu is None \
                else self._planned_cu.copy()

    def _dep_ready(self, task_id: TaskID) -> None:
        fallback = None
        with self._cv:
            left = self._waiting.get(task_id)
            if left is None:
                return
            if left <= 1:
                del self._waiting[task_id]
                if self._stopped:
                    # node was removed while this task awaited deps: hand
                    # it to the surviving raylet recorded at drain time
                    fallback = getattr(self, "_removal_fallback", None)
                else:
                    self._queue.append(task_id)
                    self._dirty = True
                    self._cv.notify_all()
            else:
                self._waiting[task_id] = left - 1
        if fallback is not None:
            fallback.enqueue_forwarded(task_id)

    def _enqueue(self, task_id: TaskID) -> None:
        with self._cv:
            self._queue.append(task_id)
            self._dirty = True
            self._cv.notify_all()

    def _notify_dirty(self) -> None:
        with self._cv:
            self._dirty = True
            self._cv.notify_all()

    # -- scheduling loop ----------------------------------------------------
    def _loop(self) -> None:
        """Event-driven: wakes only when the dirty flag was raised (task
        arrival, dep readiness, worker idle, resources freed) — a leftover
        queue alone does NOT re-trigger, so an unplaceable backlog parks
        instead of busy-spinning."""
        while True:
            with self._cv:
                while True:
                    # liveness pong: every wake (including health pings via
                    # _notify_dirty) re-stamps — a wedged batch or a dead
                    # thread stops the stamps and the health manager sees it
                    self._last_pong = _clk.monotonic()
                    if self._stopped or (self._dirty and
                                         (self._queue or self._local_queue)):
                        break
                    # while pipelined-lease entries exist, wake on a
                    # timer too: a commit that raced a worker-state
                    # change has no other wake-up to recall it
                    if self._assigned_total > 0:
                        if not self._cv.wait(0.2):
                            break       # timed out: reconcile below
                    else:
                        self._cv.wait()
                if self._stopped:
                    return
                self._dirty = False
                batch = list(self._queue)
                self._queue.clear()
            round_t0 = _clk.monotonic()
            try:
                self._reconcile_assigned()
                # the timed wake must ALSO run the stale-lease recall:
                # a task committed behind a long-running (never-blocking)
                # holder has no other wake-up to pull it back
                with self._cv:
                    any_assigned = self._assigned_total > 0
                if any_assigned:
                    self._spill_stale_leases()
                if batch:
                    leftover = self._place_batch(batch)
                    if leftover:
                        with self._cv:
                            # infeasible-now tasks park at the front, in order
                            self._queue.extendleft(reversed(leftover))
                        # infeasible backlog is autoscaler demand: wake it
                        asc = getattr(self.cluster, "autoscaler", None)
                        if asc is not None:
                            asc.kick()
                self._drain_local()
                if batch:
                    self._round_durations.append(
                        _clk.monotonic() - round_t0)
            except Exception:   # noqa: BLE001 — one bad batch must not
                # kill the node's scheduling thread (every later task
                # would hang); the batch's tasks are lost to this round
                # but retriable ones re-enter via their owners
                import traceback
                traceback.print_exc()

    # -- batch scheduling ---------------------------------------------------
    def _schedule_rows(self, batch: list) -> list[int]:
        """Choose a node row for every task record in the batch.

        Two-pass suspect avoidance: the first pass runs with SUSPECT
        rows (gray failures flagged by the health manager) soft-masked
        out of the snapshot; any task that pass could not place retries
        against the full cluster — a degraded node beats parking
        feasible work, but only as a last resort.
        """
        rows = self._schedule_rows_soft(batch)
        if self._suspect_softmask and any(r < 0 for r in rows):
            snapshot = self._effective_snapshot(avoid_suspect=False)
            n_rows = snapshot.node_mask.shape[0]
            for t, r in enumerate(rows):
                if r >= 0:
                    continue
                spec = batch[t].spec
                req = spec.resources.dense(self.crm.resource_index,
                                           snapshot.totals.shape[1])
                rows[t] = self._policy.schedule(
                    snapshot, req, self._options_for(spec, n_rows))
        return rows

    def _schedule_rows_soft(self, batch: list) -> list[int]:
        """First placement pass (suspect rows soft-masked).

        Returns one row per record (-1 = infeasible/park).  Uses the device
        water-fill kernel for large uniform batches, the CPU policy
        otherwise — bit-identical placements either way (parity contract).
        """
        cfg = get_config()
        specs = [rec.spec for rec in batch]
        # ALL-DEFAULT batches take the subgroup route (device or its
        # host twin): locality bias, lease-avoidance, and top-k are
        # device surfaces too (ops/locality_kernel.py).  Both backends
        # process subgroups keyed (class, locality row, avoid) in
        # first-appearance order, so scheduler_device_batch_min is not
        # observable in placements (top-k rounds excepted — documented
        # sampling divergence)
        if (cfg.scheduler_device_backend
                and all(s.strategy.kind is SchedulingStrategyKind.DEFAULT
                        for s in specs)):
            prefs = [self._locality_row(s) if not
                     (s.task_id in self._avoid_local) else None
                     for s in specs]
            avoids = [s.task_id in self._avoid_local for s in specs]
            with self._cv:      # flags consumed, like the host path
                for s, a in zip(specs, avoids):
                    if a:
                        self._avoid_local.discard(s.task_id)
            n_sub = len({(s.scheduling_class(), p, a) for s, p, a
                         in zip(specs, prefs, avoids)})
            if (len(batch) >= cfg.scheduler_device_batch_min
                    and n_sub <= cfg.tpu_group_capacity):
                self.device_rounds += 1
                return self._schedule_rows_device(specs, prefs, avoids)
            self.host_rounds += 1
            return self._schedule_rows_host_subgrouped(specs, prefs,
                                                       avoids)
        # mixed-strategy batches: per-task CPU policy on a snapshot
        # (sequential within the round), partitioned by scheduling class
        # in first-appearance order
        snapshot = self._effective_snapshot()
        by_class: dict[tuple, list[int]] = {}
        for t, spec in enumerate(specs):
            by_class.setdefault(spec.scheduling_class(), []).append(t)
        rows = [-1] * len(specs)
        for idxs in by_class.values():
            # one dense vector per class (identical by definition), as the
            # device path does
            req = specs[idxs[0]].resources.dense(
                self.crm.resource_index, snapshot.totals.shape[1])
            for t in idxs:
                rows[t] = self._policy.schedule(
                    snapshot, req,
                    self._options_for(specs[t],
                                      snapshot.node_mask.shape[0]))
        return rows

    def _schedule_rows_host_subgrouped(self, specs, prefs,
                                       avoids) -> list[int]:
        """Host twin of the device subgroup path: the SAME
        (class, pref, avoid) subgroups in first-appearance order — so
        small rounds and device rounds evolve ``avail`` identically
        (the batch-size threshold stays unobservable) and the locality
        probe is never run twice.

        Multi-task subgroups place through the pure-numpy water-fill
        (``ops.hybrid_kernel.schedule_group_host`` — one vectorized
        call per subgroup, bit-identical to the sequential policy by
        the parity contract) instead of per-task ``compute_keys``
        loops: the per-task path's numpy overhead on the scheduling
        thread was the dominant GIL cost of tiny-task rounds.
        Singletons and top-k sampling rounds keep the per-task policy
        (the host sampler draws per task)."""
        snapshot = self._effective_snapshot()
        n_rows = snapshot.node_mask.shape[0]
        by_sub: dict[tuple, list[int]] = {}
        for t, spec in enumerate(specs):
            key = (spec.scheduling_class(),
                   prefs[t] if prefs[t] is not None else -1, avoids[t])
            by_sub.setdefault(key, []).append(t)
        rows = [-1] * len(specs)
        vec_ok = get_config().scheduler_top_k_fraction == 0
        if vec_ok:
            from ..ops.hybrid_kernel import schedule_group_host
            from ..scheduling.contract import threshold_fp
            thr = threshold_fp(None)
        for (cls_key, pref, avoid), idxs in by_sub.items():
            req = specs[idxs[0]].resources.dense(
                self.crm.resource_index, snapshot.totals.shape[1])
            if vec_ok and len(idxs) > 1:
                gmask = None
                if avoid and 0 <= self.row < n_rows:
                    gmask = np.ones(n_rows, dtype=bool)
                    gmask[self.row] = False
                # avoid wins over pref, matching the per-task branch
                # below and _schedule_rows' construction (avoid tasks
                # get pref None there — the local data node is exactly
                # what starved them)
                counts_row, new_avail = schedule_group_host(
                    snapshot.avail, snapshot.totals, snapshot.node_mask,
                    req, len(idxs), gmask, thr,
                    pref_row=-1 if avoid else int(pref))
                snapshot.avail[:] = new_avail       # sequential carry
                slots = np.repeat(
                    np.concatenate([np.arange(n_rows, dtype=np.int32),
                                    np.array([-1], dtype=np.int32)]),
                    counts_row)
                for t, r in zip(idxs, slots):
                    rows[t] = int(r)
                continue
            for t in idxs:
                if avoid:
                    opts = SchedulingOptions(avoid_local_node=True,
                                             local_node_row=self.row)
                elif pref >= 0:
                    opts = SchedulingOptions(
                        scheduling_type=SchedulingType.NODE_AFFINITY,
                        node_row=int(pref), soft=True)
                else:
                    opts = SchedulingOptions()
                rows[t] = self._policy.schedule(snapshot, req, opts)
        return rows

    def _schedule_rows_device(self, specs: list,
                              prefs: list | None = None,
                              avoids: list | None = None) -> list[int]:
        """One device water-fill call places the whole batch (north star).

        Subgroups key on (scheduling class, locality row, avoid flag):
        locality-biased groups pre-place on their preferred row (soft
        affinity, bit-identical to the host sequence), avoid groups mask
        out this node, and with ``scheduler_top_k_fraction`` > 0 the
        no-preference groups spread over their top-k keys on device
        (documented sampling divergence — ops/locality_kernel.py).

        The device is the cluster's ``scheduler_device``; torch is
        imported here, not at module level, so that workers (which
        import this package) never pay for it."""
        import torch

        from ..ops import schedule_grouped
        from ..scheduling.contract import threshold_fp

        if prefs is None:
            prefs = [None] * len(specs)
        if avoids is None:
            avoids = [False] * len(specs)
        cfg = get_config()
        width = self.crm.arrays()[0].shape[1]
        groups: dict[tuple, int] = {}
        reqs: list[np.ndarray] = []
        counts: list[int] = []
        pref_rows: list[int] = []
        avoid_flags: list[bool] = []
        task_group = np.empty(len(specs), dtype=np.int32)
        for t, spec in enumerate(specs):
            pref = prefs[t] if prefs[t] is not None else -1
            key = (spec.scheduling_class(), pref, avoids[t])
            g = groups.get(key)
            if g is None:
                g = len(reqs)
                groups[key] = g
                reqs.append(spec.resources.dense(self.crm.resource_index,
                                                 width))
                counts.append(0)
                pref_rows.append(int(pref))
                avoid_flags.append(bool(avoids[t]))
            counts[g] += 1
            task_group[t] = g
        G = len(reqs)
        # pad the class axis to a power-of-2 bucket (the shapes the
        # heartbeat's resident class plane sees stay few); count-0
        # padding rows are no-ops in the water-fill
        Gp = max(8, 1 << (G - 1).bit_length())
        req_arr = np.zeros((Gp, width), dtype=np.int32)
        req_arr[:G] = np.stack(reqs)
        cnt_arr = np.zeros(Gp, dtype=np.int32)
        cnt_arr[:G] = counts
        pref_arr = np.full(Gp, -1, dtype=np.int32)
        pref_arr[:G] = pref_rows
        top_k = cfg.scheduler_top_k_fraction
        plain = (pref_arr < 0).all() and not any(avoid_flags)
        if plain and top_k == 0 and not cfg.scheduler_sharded_state \
                and cfg.scheduler_delta_beats:
            # incremental heartbeat: no snapshot copy, no full upload —
            # the resident mirror syncs from the CRM dirty journal and
            # planned load rides along as per-beat avail overrides
            self.delta_rounds += 1
            counts_host = self._schedule_rows_delta(req_arr[:G],
                                                    cnt_arr[:G])
            N = counts_host.shape[1] - 1
        else:
            snapshot = self._effective_snapshot()
            totals, avail, mask = (snapshot.totals, snapshot.avail,
                                   snapshot.node_mask)
            if totals.shape[1] != width:
                # a resource column appeared between the width probe and
                # the snapshot; dense vectors only append columns, so
                # zero-padding the request rows is exact
                wider = np.zeros((Gp, totals.shape[1]), dtype=np.int32)
                wider[:, :width] = req_arr
                req_arr = wider
            N = totals.shape[0]
            gmask = np.ones((Gp, N), dtype=bool)
            for g, av in enumerate(avoid_flags):
                if av and 0 <= self.row < N:
                    gmask[g, self.row] = False
            if cfg.scheduler_sharded_state and plain and top_k == 0:
                # host gmask: the sharded branch pads its node axis
                counts_host = self._schedule_sharded(
                    totals, avail, mask, req_arr, cnt_arr, gmask)[:G]
            elif top_k > 0:
                counts_host = self._schedule_device_topk(
                    totals, avail, mask, req_arr, cnt_arr, gmask,
                    pref_arr, cfg)[:G]
            else:
                dev = self.cluster.scheduler_device

                def put(x, dtype):     # a copy: snapshots are read-only
                    return torch.tensor(np.ascontiguousarray(x, dtype),
                                        device=dev)

                args = (put(totals, np.int32), put(avail, np.int32),
                        put(mask, bool), put(req_arr, np.int32),
                        put(cnt_arr, np.int32), put(gmask, bool))
                if plain:
                    counts_dev, _ = schedule_grouped(
                        *args, threshold_fp(None))
                else:
                    from ..ops.locality_kernel import \
                        schedule_grouped_localized
                    counts_dev, _ = schedule_grouped_localized(
                        *args, put(pref_arr, np.int32), threshold_fp(None))
                # the round's one readback (snapshot and locality
                # rounds; delta rounds read back in the beat)
                counts_dev = counts_dev[:G]
                counts_host = counts_dev.cpu().numpy()  # rtlint: disable=W6
        # expand (G, N+1) counts into per-task rows, class-internal order
        # node-row-ascending (tasks within a class are interchangeable)
        slots = [np.repeat(
            np.concatenate([np.arange(N, dtype=np.int32),
                            np.array([-1], dtype=np.int32)]),
            counts_host[g]) for g in range(G)]
        cursor = np.zeros(G, dtype=np.int64)
        rows = []
        for t in range(len(specs)):
            g = task_group[t]
            rows.append(int(slots[g][cursor[g]]))
            cursor[g] += 1
        return rows

    def _schedule_rows_delta(self, req_arr, cnt_arr) -> "np.ndarray":
        """The fused delta-heartbeat placement call
        (scheduling.policy.DeltaScheduler): the device mirror syncs
        incrementally from the CRM's dirty journal; this node's view of
        planned-but-undispatched load rides along as per-beat avail
        overrides and suspect rows as a per-beat soft mask — both with
        the exact ``_effective_snapshot`` arithmetic, so placements are
        bit-identical to the snapshot path.  One counts readback per
        beat.  Returns (G, N+1) int32 counts.

        The engine comes from ``make_delta_scheduler`` on the cluster's
        ``scheduler_device``: with ``scheduler_shards`` resolving past
        one rank (the local CUDA cards) the mirror and the beat shard
        over them (ShardedDeltaScheduler), else the single-device
        DeltaScheduler; placements are bit-identical either way."""
        from ..scheduling.sharded_delta import make_delta_scheduler
        eng = self._delta_engine
        if eng is None:
            eng = self._delta_engine = make_delta_scheduler(
                self.crm, device=self.cluster.scheduler_device)
        _v, totals_f, avail_f, place_mask, _rows = self.crm.delta_view(-2)
        # suspect soft-avoid, same healthy-survivor rule as
        # _effective_snapshot (suspect is advisory, never hard)
        self._suspect_softmask = False
        extra = None
        sus = self.crm.suspect_mask()
        if sus.any():
            n = min(sus.shape[0], place_mask.shape[0])
            healthy = place_mask.copy()
            healthy[:n] &= ~sus[:n]
            if healthy.any():
                extra = ~sus
                self._suspect_softmask = True
        overrides: dict[int, np.ndarray] = {}
        for row, planned in self._planned_overrides(
                avail_f.shape[1]).items():
            if not 0 <= row < avail_f.shape[0]:
                continue
            w = min(avail_f.shape[1], planned.shape[0])
            base = avail_f[row].astype(np.int64)
            base[:w] = (base[:w] - planned[:w]).clip(-(2**30), 2**30)
            overrides[row] = base.astype(np.int32)
        counts = eng.beat(req_arr, cnt_arr, overrides=overrides,
                          extra_mask=extra)
        cfg = get_config()
        if cfg.lease_plane_enabled and cfg.lease_budget_source == "beat":
            self._publish_beat_budgets(eng)
        return counts

    def _publish_beat_budgets(self, eng) -> None:
        """Hand the beat's device-priced (class x node) lease budgets —
        already host-side, they rode the beat's single readback — to
        the process-wide budget board the head's ``AgentHub`` sizes
        grants from (the closed dispatch loop: beat -> readback ->
        grantor -> raylet lease cache).  Budget rows are re-keyed from
        interned request vectors to the lease plane's class-key strings
        (``node_agent._lease_class_key`` format)."""
        from ..leasing.board import budget_board
        budgets = eng.last_budgets()
        if budgets is None:
            return
        index = self.crm.resource_index
        rows: dict[str, np.ndarray] = {}
        for slot, vec in eng.class_vectors().items():
            if slot >= budgets.shape[0]:
                continue        # interned after the beat; next beat has it
            parts = sorted((index.name(int(c)), int(vec[c]))
                           for c in np.flatnonzero(vec))
            ck = ",".join(f"{k}:{v}" for k, v in parts) or "zero"
            rows[ck] = budgets[slot]
        budget_board().publish(eng.budget_seq, rows)

    def _schedule_device_topk(self, totals, avail, mask, req_arr,
                              cnt_arr, gmask, pref_arr,
                              cfg) -> "np.ndarray":
        """Top-k rounds on device: locality groups pre-place via the
        localized kernel (affinity is deterministic, no sampling), then
        the remaining groups spread over their top-k keys with a pinned
        (row, round) draw — deterministic replay, documented divergence
        from the host sampler's per-task draws.  Both run on the
        cluster's ``scheduler_device``."""
        from ..ops.locality_kernel import (schedule_grouped_localized_np,
                                          schedule_grouped_topk_np)
        dev = self.cluster.scheduler_device
        self.topk_rounds += 1              # also the draws' round index
        has_pref = pref_arr >= 0
        counts_out = np.zeros((req_arr.shape[0], totals.shape[0] + 1),
                              dtype=np.int32)
        avail_now = avail
        if has_pref.any():
            loc_cnt = np.where(has_pref, cnt_arr, 0).astype(np.int32)
            c_loc, avail_now = schedule_grouped_localized_np(
                totals, avail_now, mask, req_arr, loc_cnt, pref_arr,
                group_masks=gmask, spread_threshold=None, device=dev)
            counts_out += c_loc
        topk_cnt = np.where(has_pref, 0, cnt_arr).astype(np.int32)
        if topk_cnt.any():
            c_topk, _ = schedule_grouped_topk_np(
                totals, avail_now, mask, req_arr, topk_cnt,
                seed=self.row, round_index=self.topk_rounds,
                group_masks=gmask,
                k_abs=cfg.scheduler_top_k_absolute,
                k_frac=cfg.scheduler_top_k_fraction, device=dev)
            counts_out += c_topk
        return counts_out

    def _schedule_sharded(self, totals, avail, mask, req_arr, cnt_arr,
                          gmask) -> "np.ndarray":
        """The device placement call with cluster-state rows SHARDED
        over every rank (``scheduler_sharded_state``; the ranks of
        ``make_delta_scheduler``'s resolver, ``shard_reduce.local_ranks``:
        the local CUDA cards): each rank owns N/n node rows and the
        water-fill's global sums and argmin are collectives
        (``ShardPlane.schedule_grouped``); on one rank it is the
        single-device call.  Node rows pad to a multiple of the rank
        count with mask-False rows (no-ops); ``plane_for`` caches the
        plane.  Returns host counts of shape (Gp, N+1): real node
        columns plus the infeasible column."""
        from ..ops import shard_reduce as sr
        from ..scheduling.contract import threshold_fp
        ranks = sr.local_ranks(self.cluster.scheduler_device)
        plane = sr.plane_for(len(ranks), "flat", ranks)
        counts, _ = plane.schedule_grouped_np(
            totals, avail, mask, req_arr, cnt_arr, gmask,
            threshold_fp(None))
        return counts

    def _effective_snapshot(self, avoid_suspect: bool = True):
        """CRM snapshot minus every node's planned-but-undispatched load
        AND its agent-locally-running load (tasks an autonomous agent
        leased without the head — reported on the batched agent_sync),
        so placement rounds do not over-assign nodes whose queues or
        local leases are already deep.

        With ``avoid_suspect`` (the default), SUSPECT rows are masked
        out too — but only while at least one healthy node survives,
        and ``self._suspect_softmask`` records that the mask was
        applied so ``_schedule_rows`` knows a -1 merits a full-cluster
        retry (suspect is advisory, never a hard exclusion)."""
        snapshot = self.crm.snapshot()
        self._suspect_softmask = False
        if avoid_suspect:
            sus = self.crm.suspect_mask()
            n = min(sus.shape[0], snapshot.node_mask.shape[0])
            if sus[:n].any():
                healthy = snapshot.node_mask.copy()
                healthy[:n] &= ~sus[:n]
                if healthy.any():
                    snapshot.node_mask = healthy
                    self._suspect_softmask = True
        for row, planned in self._planned_overrides(
                snapshot.avail.shape[1]).items():
            w = min(snapshot.avail.shape[1], planned.shape[0])
            snapshot.avail[row, :w] = (
                snapshot.avail[row, :w].astype(np.int64) - planned[:w]
            ).clip(-(2**30), 2**30).astype(np.int32)
        return snapshot

    def _planned_overrides(self, width: int) -> dict[int, np.ndarray]:
        """Per-row planned-but-undispatched + agent-locally-running
        debits (int64 cu vectors): the ephemeral load every placement
        round subtracts — applied to the snapshot copy by
        ``_effective_snapshot`` and as per-beat device overrides by
        ``_schedule_rows_delta`` (identical arithmetic either way)."""
        out: dict[int, np.ndarray] = {}
        for row, raylet in list(self.cluster.raylets.items()):
            planned = raylet.planned_snapshot()
            local = raylet.agent_local_cu
            if local:
                vec = ResourceRequest.from_cu_dict(local).dense(
                    self.crm.resource_index, width).astype(np.int64)
                if planned is None:
                    planned = vec
                else:
                    n = max(planned.shape[0], vec.shape[0])
                    merged = np.zeros(n, dtype=np.int64)
                    merged[:planned.shape[0]] += planned
                    merged[:vec.shape[0]] += vec
                    planned = merged
            if planned is not None:
                out[row] = planned
        return out

    def _locality_row(self, spec) -> int | None:
        """Node row holding the most bytes of the spec's plasma args, or
        None when locality gives no signal (no plasma args, or the knob
        is off).  Reference: the core worker's locality-aware lease
        policy targets the raylet with the most object bytes local."""
        if not spec.args or not get_config().locality_aware_scheduling:
            return None
        by_row: dict[int, int] = {}
        from .object_store import PLASMA_KINDS
        for a in spec.args:
            if isinstance(a, ObjectRef):
                kind, size = self.store.plasma_info(a.id)
                if kind in PLASMA_KINDS:
                    for r in self.cluster.directory.locations(a.id):
                        by_row[r] = by_row.get(r, 0) + size
        if not by_row:
            return None
        # max bytes, lowest row on ties (deterministic)
        return min(by_row, key=lambda r: (-by_row[r], r))

    def _options_for(self, spec, n_rows: int) -> SchedulingOptions:
        kind = spec.strategy.kind
        if kind is SchedulingStrategyKind.DEFAULT:
            if spec.task_id in self._avoid_local:
                # lease-timeout spillback: one placement that excludes
                # this node (flag consumed; locality skipped — the local
                # data node is exactly what starved the task)
                self._avoid_local.discard(spec.task_id)
                return SchedulingOptions(avoid_local_node=True,
                                         local_node_row=self.row)
            row = self._locality_row(spec)
            if row is not None:
                # soft affinity: land on the max-local-bytes node when it
                # can take the task, hybrid otherwise
                return SchedulingOptions(
                    scheduling_type=SchedulingType.NODE_AFFINITY,
                    node_row=row, soft=True)
            return SchedulingOptions()
        if kind is SchedulingStrategyKind.SPREAD:
            return SchedulingOptions(scheduling_type=SchedulingType.SPREAD)
        if kind is SchedulingStrategyKind.NODE_AFFINITY:
            row = self.crm.row_of(spec.strategy.node_id)
            return SchedulingOptions(
                scheduling_type=SchedulingType.NODE_AFFINITY,
                node_row=row if row is not None else -1,
                soft=spec.strategy.soft)
        if kind is SchedulingStrategyKind.NODE_LABEL:
            # resolve the selector into a node mask against live labels
            mask = self.crm.label_mask(dict(spec.strategy.label_selector))
            return SchedulingOptions(
                scheduling_type=SchedulingType.NODE_LABEL,
                node_mask=mask[:n_rows], soft=spec.strategy.soft)
        if kind is SchedulingStrategyKind.PLACEMENT_GROUP:
            # pin to the group's reserved bundles; a still-pending group
            # parks the task (all-False mask) until the PG manager's
            # commit wakes the raylets (SURVEY §3.5).  "dead" groups are
            # failed earlier in _place_batch; park defensively if one
            # races through here.
            verdict, options = self.cluster.pg_manager.\
                scheduling_options_for(spec.strategy, n_rows)
            if verdict == "dead":
                return SchedulingOptions(
                    node_mask=np.zeros(n_rows, dtype=bool))
            return options
        return SchedulingOptions()

    def _place_batch(self, batch: list[TaskID]) -> list[TaskID]:
        """Assign every task a node (ONE scheduling decision per task);
        returns the infeasible leftover."""
        recs = []
        for task_id in batch:
            rec = self.task_manager.get(task_id)
            if rec is None or rec.done:
                continue
            strat = rec.spec.strategy
            if strat.kind is SchedulingStrategyKind.PLACEMENT_GROUP:
                verdict, _ = self.cluster.pg_manager.\
                    scheduling_options_for(strat, 0)
                if verdict == "dead":
                    # removed/unknown group or bad bundle index: fail the
                    # task (reference: tasks of a removed PG error out)
                    self._fail_unscheduled(
                        rec, "placement group removed, unknown, or "
                        "bundle index out of range")
                    continue
            if strat.kind is SchedulingStrategyKind.NODE_AFFINITY \
                    and not strat.soft \
                    and self.crm.row_of(strat.node_id) is None:
                # hard affinity to a node that no longer exists can
                # NEVER place — fail fast instead of parking forever
                # (reference: hard NodeAffinity to a dead node fails
                # the task as unschedulable)
                self._fail_unscheduled(
                    rec, "hard node affinity to a dead or unknown "
                    f"node {strat.node_id.hex()[:12]}")
                continue
            recs.append(rec)
        if not recs:
            return []
        rows = self._schedule_rows(recs)
        leftover: list[TaskID] = []
        local_ids: list[TaskID] = []
        remote: dict[int, list[TaskID]] = {}
        for rec, row in zip(recs, rows):
            if row < 0:
                leftover.append(rec.spec.task_id)
            elif row == self.row:
                local_ids.append(rec.spec.task_id)
            else:
                remote.setdefault(row, []).append(rec.spec.task_id)
        # fused hand-off: the beat's placement readback becomes per-node
        # lease groups delivered in one call per target raylet
        if local_ids:
            self.enqueue_local_batch(local_ids)
        for row, ids in remote.items():
            if not self.cluster.route_local_batch(row, ids):
                leftover.extend(ids)            # target died: retry
        return leftover

    def _drain_local(self) -> None:
        """Dispatch placed tasks to workers; stops scanning after a run of
        consecutive failures (worker/resource-starved queue parks until the
        next idle/free event).  The queue is bucketed by scheduling-class
        key (the reference ClusterTaskManager's SchedulingClass-keyed
        dispatch queues): a class whose resource demand cannot fit skips
        the rest of its bucket, so a deep single-class backlog costs at
        most one chunk copy per pass instead of a full queue scan;
        buckets are visited oldest-head first for cross-class
        fairness."""
        from itertools import islice
        max_misses = 8
        chunk_size = 128
        misses = 0
        env_missed: set = set()         # env keys already counted a miss
        kicked = False                  # autoscaler kicked this pass
        with self._cv:
            if self._draining or not self._local_queue:
                return
            # oldest class first (head-entry enqueue time): bucket order
            # must not starve a lone task of a late class behind an
            # earlier class's steady stream — the fairness the flat FIFO
            # gave, at class granularity
            class_keys = sorted(
                self._local_queue.classes(),
                key=lambda k: min(
                    (self._local_since.get(t, float("inf"))
                     for t in islice(self._local_queue.bucket(k), 1)),
                    default=float("inf")))
        for key in class_keys:
            # buckets snapshot in CHUNKS: a class that cannot fit stops
            # after one chunk, so a 100k-deep starved backlog costs a
            # bounded copy per pass, not O(queue)
            skipped = 0         # examined but left queued this pass
            class_full = False
            while not class_full:
                if misses >= max_misses:
                    return
                with self._cv:
                    chunk = list(islice(self._local_queue.bucket(key),
                                        skipped, skipped + chunk_size))
                    # pull state snapshotted WITH the chunk: enqueue sets
                    # _pull_pending in the same _cv section as the queue
                    # append, so a task enqueued mid-pass with in-flight
                    # pulls cannot appear in a chunk without its entry
                    # (intersect with the chunk — O(chunk), not O(pending))
                    pull_pending = {t for t in chunk
                                    if t in self._pull_pending}
                if not chunk:
                    break
                for task_id in chunk:
                    if misses >= max_misses:
                        return
                    if task_id in pull_pending:
                        skipped += 1    # args still in flight this pass
                        continue
                    rec = self.task_manager.get(task_id)
                    if rec is None or rec.done:
                        with self._cv:
                            try:
                                self._local_queue.remove(task_id)
                            except ValueError:
                                continue    # concurrent cancel removed it
                            self._local_since.pop(task_id, None)
                            self._env_miss_since.pop(task_id, None)
                            if rec is not None:
                                self._planned_add(rec.spec.resources, -1)
                        continue
                    spec = rec.spec
                    # reserve resources BEFORE popping a worker
                    # (pool.release fires the idle wake-up, so a
                    # speculative pop-then-release would spin the loop)
                    if not self.crm.subtract(self.row, spec.resources):
                        if not kicked:
                            # resource-starved backlog = autoscaler demand
                            asc = getattr(self.cluster, "autoscaler", None)
                            if asc is not None:
                                asc.kick()
                            kicked = True
                        misses += 1
                        class_full = True
                        break           # rest of the bucket cannot fit
                    outcome = self._drain_try_worker(task_id, rec, spec,
                                                     env_missed)
                    if outcome == "stop":
                        return
                    if outcome == "ok":
                        continue        # entry removed from the bucket
                    if outcome == "miss":
                        misses += 1
                    skipped += 1        # miss/skip leave the entry queued
                    # (over-counts when a helper removed the entry — a
                    # later pass re-examines anything this one missed)
        return

    def _drain_try_worker(self, task_id, rec, spec,
                          env_missed: set) -> str:
        """Second half of one drain step: lease a worker (env-keyed or
        default, else a pipelined commit) and dispatch.  Outcomes:
        ``"ok"`` dispatched/committed, ``"miss"`` count against the miss
        budget, ``"skip"`` no budget charge (env miss already counted,
        concurrent removal), ``"stop"`` end the whole pass
        (worker-limited)."""
        if spec.runtime_env:
            worker, env_k = self._pop_env_worker(task_id, rec, spec)
            if worker is None:
                # one miss per env KEY per scan (like a full class's
                # single miss for resources): a block of same-env tasks
                # parked at a barrier must not eat the whole miss budget
                # and starve runnable default tasks behind them
                if env_k is None or env_k not in env_missed:
                    if env_k is not None:
                        env_missed.add(env_k)
                    return "miss"   # waits for its env worker (or
                #                     failed staging); others may still
                return "skip"       # dispatch
        else:
            worker = self.pool.pop_idle()
            if worker is None:
                # pipelined lease: commit the task to a BUSY worker's
                # soft queue (resources stay debited); the exec frame
                # ships the instant that worker's current result
                # lands, cutting the result->rescan->dispatch round
                # trip out of the tiny-task critical path
                depth = get_config().worker_pipeline_depth
                target = self.pool.pipeline_target(None, depth) \
                    if depth > 1 else None
                if target is not None:
                    committed = False
                    with self._cv:
                        # re-validate AT COMMIT: the target may have
                        # died/blocked/been released since selection
                        # (the reconcile sweep covers what still
                        # slips through this non-atomic check)
                        if not target.dead and not target.blocked \
                                and target.leased_task is not None:
                            try:
                                self._local_queue.remove(task_id)
                            except ValueError:
                                self.crm.add_back(self.row,
                                                  spec.resources)
                                return "skip"
                            self._local_since.pop(task_id, None)
                            self._env_miss_since.pop(task_id, None)
                            self._planned_add(spec.resources, -1)
                            target.assigned.append(
                                (task_id, _clk.monotonic()))
                            self._assigned_total += 1
                            committed = True
                    if committed:
                        return "ok"
                    self.crm.add_back(self.row, spec.resources)
                    self._spill_stale_leases()
                    return "stop"
                self.crm.add_back(self.row, spec.resources)
                # worker-limited: park, but tasks that waited past the
                # lease timeout spill back to global placement
                self._spill_stale_leases()
                return "stop"
        with self._cv:
            try:
                self._local_queue.remove(task_id)
            except ValueError:
                self.crm.add_back(self.row, spec.resources)
                self.pool.release(worker)
                return "skip"
            self._local_since.pop(task_id, None)
            self._env_miss_since.pop(task_id, None)
            self._planned_add(spec.resources, -1)
        self._dispatch(worker, rec)
        return "ok"

    def _dispatch(self, worker: WorkerHandle, rec) -> bool:
        spec = rec.spec
        # resolve top-level ObjectRef args (deps are ready by construction)
        # as store descriptors: shm-resident args reach the worker as
        # (offset, size) and are read zero-copy; errors are always in-band.
        # Plane-backed remote nodes ship plasma args BY REFERENCE in the
        # frame's extern table — the agent resolves them against its own
        # arena, so payload bytes never transit the head (reference: task
        # args resolve in the executing node's local plasma store)
        from .object_store import PLASMA_KINDS
        from .worker import ArgRef
        args = []
        extern: list = []       # frame-level descriptors (outside the
        #                         payload pickle, rewritable by the agent)
        pinned: list = []       # shm args stay pinned until task completion
        dep_error = None
        vanished = None
        for a in spec.args:
            if isinstance(a, ObjectRef):
                if self.remote_plane:
                    kind, _size = self.store.plasma_info(a.id)
                    if kind in PLASMA_KINDS:
                        extern.append(("r", a.id.binary()))
                        args.append(ArgRef(("x", len(extern) - 1)))
                        continue
                try:
                    desc = self.store.descriptor_of(a.id)
                except KeyError:
                    # arg vanished between placement and dispatch (lineage
                    # recovery re-seal in flight): park until it reappears
                    vanished = a.id
                    break
                if desc[0] == "s":
                    if self.inline_objects:
                        # remote worker with no plane: copy out of the
                        # arena under the pin, ship bytes, release now
                        desc = ("b", self.store.inline_bytes(a.id, desc))
                    else:
                        pinned.append((a.id, desc[1]))
                if desc[0] == "v" and isinstance(desc[1], RayTaskError):
                    dep_error = desc[1]
                    break
                args.append(ArgRef(desc))
            else:
                args.append(a)
        if vanished is not None:
            self.store.unpin(pinned)
            self.crm.add_back(self.row, spec.resources)
            self.pool.release(worker)
            with self._cv:
                self._waiting[spec.task_id] = 1
            self.store.on_ready(vanished, lambda _oid, t=spec.task_id:
                                self._dep_ready(t))
            return False
        if dep_error is not None:
            # propagate the dependency's error to this task's outputs
            # without executing (reference: failed deps fail the task)
            self.store.unpin(pinned)
            self._finish_with_error(rec, dep_error, worker)
            return False

        fn_id = spec.function_descriptor
        if fn_id not in worker.fn_cache:
            fn_bytes = self._fn_registry.get(fn_id)
            if fn_bytes is None:
                self.store.unpin(pinned)
                self._finish_with_error(rec, RayTaskError(
                    fn_id, "function bytes never reached the driver "
                    "(stub submitted without registration)"), worker)
                return False
            if not worker.send(("fn", fn_id, fn_bytes)):
                self.store.unpin(pinned)
                self._requeue_after_worker_loss(rec, worker)
                return False
            worker.fn_cache.add(fn_id)
        from .object_ref import mark_transferred, transfer_generators
        with transfer_generators() as xfer_gens:
            payload = serialize((tuple(args), spec.kwargs,
                                 spec.num_returns))
        # lineage budget cost, measured here where the args are already
        # serialized (complete() must not re-pickle under the manager lock)
        rec.lineage_bytes = len(payload) + 256
        self._task_start[spec.task_id.binary()] = _clk.now()
        worker.leased_task = spec.task_id.binary()
        worker.leased_streaming = spec.num_returns == -1
        with self._cv:
            self._running[spec.task_id.binary()] = (spec.task_id, worker,
                                                    pinned)
        # plane agents get the task's demand vector appended (7th
        # element, stripped before the worker sees the frame): the
        # agent maintains a local availability view for its autonomous
        # dispatch fast path from exactly these observations
        if self.remote_plane:
            frame = ("exec", spec.task_id.binary(), fn_id, payload,
                     spec.trace_ctx, extern, spec.resources.cu())
        else:
            frame = ("exec", spec.task_id.binary(), fn_id, payload,
                     spec.trace_ctx, extern)
        if not worker.send(frame):
            with self._cv:
                entry = self._running.pop(spec.task_id.binary(), None)
            if entry is not None:
                # a concurrent _on_worker_death that popped first already
                # unpinned, returned resources, and retried/failed the
                # task — doing it again here would double-release
                self.store.unpin(pinned)
                self._requeue_after_worker_loss(rec, worker)
            return False
        mark_transferred(xfer_gens)     # exec frame shipped
        return True

    def _pop_env_worker(self, task_id, rec, spec):
        """Lease a worker matching the task's runtime env, staging the
        env off-thread and spawning a cached env worker on first need
        (reference: the runtime-env agent provisions, then the lease
        retries).  Returns ``(worker_or_None, env_key_or_None)``: a None
        worker means the task cannot dispatch this round (env worker
        busy/booting/staging, or staging failed and the task was sealed
        with RuntimeEnvSetupError); the key lets the scan dedup misses
        per env."""
        from .runtime_env import RuntimeEnvSetupError, env_key
        try:
            key = env_key(spec.runtime_env)
            payload = self.cluster.runtime_env_manager.get_if_ready(key)
        except (RuntimeEnvSetupError, ValueError) as e:
            with self._cv:
                try:
                    self._local_queue.remove(task_id)
                except ValueError:
                    self.crm.add_back(self.row, spec.resources)
                    return None, None
                self._local_since.pop(task_id, None)
                self._env_miss_since.pop(task_id, None)
                self._planned_add(spec.resources, -1)
            self._finish_with_error(rec, RayTaskError(
                spec.function_descriptor, f"runtime_env setup failed: {e}",
                e if isinstance(e, RuntimeEnvSetupError)
                else RuntimeEnvSetupError(str(e))), None)
            return None, None
        if payload is None:
            # unstaged: provision on a side thread — a copytree of a
            # large working_dir on THIS thread would stall every other
            # task's dispatch on the node (reference: the runtime-env
            # agent keeps staging off the raylet's dispatch path)
            self._stage_env_async(key, spec.runtime_env)
            self.crm.add_back(self.row, spec.resources)
            return None, key
        worker = self.pool.pop_idle(key)
        if worker is None:
            # cold start (no worker staged into this env) spawns now;
            # otherwise wait out a grace period first — the busy worker
            # normally returns to idle in microseconds (sequential
            # reuse), but tasks that rendezvous with each other (a
            # barrier under a job-level env) hold their workers, and
            # only growing the cache un-deadlocks them
            now = _clk.monotonic()
            grace = get_config().env_worker_grace_ms / 1000.0
            with self._cv:
                first = self._env_miss_since.setdefault(task_id, now)
            if self.pool.live_env_workers(key) == 0 or now - first > grace:
                with self._cv:
                    # a fresh grace gates the NEXT growth step: without
                    # this re-stamp, every scan after the first lapse
                    # would fork another process
                    self._env_miss_since[task_id] = now
                self.pool.ensure_env_worker(key, payload)
            elif first == now:
                # first miss: nothing else re-triggers the scan if the
                # busy worker never returns, so arm ONE re-check timer
                # per waiting task for just past the grace
                t = threading.Timer(grace * 1.1, self._notify_dirty)
                t.daemon = True
                t.start()
            self.crm.add_back(self.row, spec.resources)
        return worker, key

    def _parent_env_of(self, worker: WorkerHandle) -> dict | None:
        """The runtime env of whatever this worker is executing: its
        leased task's (job-merged) env, or its bound actor's."""
        tid_bin = worker.leased_task
        if tid_bin is not None:
            entry = self._running.get(tid_bin)
            if entry is not None:
                rec = self.task_manager.get(entry[0])
                if rec is not None:
                    return rec.spec.runtime_env
        actor_id = getattr(worker, "actor_binding", None)
        if actor_id is not None and self.actor_manager is not None:
            return self.actor_manager.runtime_env_of(actor_id)
        return None

    def _stage_env_async(self, key: str, env: dict) -> None:
        """Provision a runtime env on a daemon thread, once per key;
        completion (or the now-cached failure) re-wakes the scan."""
        with self._cv:
            if key in self._env_staging:
                return
            self._env_staging.add(key)

        def run() -> None:
            try:
                self.cluster.runtime_env_manager.stage(env)
            except Exception:   # noqa: BLE001 — the manager caches the
                pass            # error; the next scan fails the task
            finally:
                with self._cv:
                    self._env_staging.discard(key)
                self._notify_dirty()
        threading.Thread(target=run, daemon=True,
                         name=f"env-stage-{key[:8]}").start()

    def _spill_stale_leases(self) -> None:
        """Placed tasks that waited longer than ``worker_lease_timeout_ms``
        for a worker re-enter GLOBAL placement (reference: an expired
        worker-lease request is retried and may spill back to another
        raylet).  Tasks with in-flight arg pulls stay (they are making
        progress)."""
        timeout = get_config().worker_lease_timeout_ms / 1000.0
        now = _clk.monotonic()
        moved = []
        multi_node = len(self.cluster.raylets) > 1
        with self._cv:
            if not multi_node:
                pass            # nowhere to spill to; the pipelined-
                # lease recall below still applies single-node
            else:
                self._spill_queue_locked(now, timeout, moved)
        for tid in moved:
            self._enqueue(tid)
        # pipelined-lease staleness: a committed task stuck behind a
        # long-running (but never-blocking) holder past the lease
        # timeout pulls back and re-enters local dispatch
        stale_workers = []
        with self.pool._lock:
            workers = list(self.pool._workers)
        for w in workers:
            with self._cv:
                oldest = w.assigned[0][1] if w.assigned else None
            if oldest is not None and now - oldest > timeout:
                stale_workers.append(w)
        for w in stale_workers:
            # multi-node: spill away from this node like the queue path
            # above; single-node there is nowhere else to go
            self._recall_assigned(w, avoid_local=multi_node)

    def _spill_queue_locked(self, now, timeout, moved) -> None:
        """Move lease-timed-out queue entries into ``moved`` (caller
        holds ``_cv`` and re-enqueues globally)."""
        for tid in list(self._local_queue):
            t0 = self._local_since.get(tid)
            if t0 is None or now - t0 <= timeout or \
                    tid in self._pull_pending:
                continue
            self._local_queue.remove(tid)
            self._local_since.pop(tid, None)
            self._env_miss_since.pop(tid, None)
            rec = self.task_manager.get(tid)
            if rec is not None:
                self._planned_add(rec.spec.resources, -1)
            # re-place AWAY from this starved node (reference:
            # spillback excludes the rejecting raylet)
            self._avoid_local.add(tid)
            moved.append(tid)

    def _reconcile_assigned(self) -> None:
        """Safety net for pipelined-lease commit races: entries parked
        on a worker that is dead, blocked, or idle (its release raced
        the commit) have no result-arrival left to ship them — recall
        so normal dispatch takes over.  Runs on the event loop's timed
        wake while any entries exist."""
        with self._cv:
            if self._assigned_total <= 0:
                return
        with self.pool._lock:
            workers = list(self.pool._workers)
        for w in workers:
            with self._cv:
                if not w.assigned:
                    continue
            if w.dead:
                self._recall_assigned(w, to_global=True)
            elif w.blocked or w.leased_task is None:
                self._recall_assigned(w)

    def _dispatch_next_assigned(self, worker: WorkerHandle) -> bool:
        """Send the next pipelined-lease task to a worker that just
        finished one.  Returns True when an exec frame shipped; False
        when the queue is empty (a failed dispatch recalls the
        remainder — its failure path already released the worker, which
        would otherwise strand them)."""
        while True:
            with self._cv:
                if not worker.assigned:
                    return False
                task_id, _t = worker.assigned.popleft()
                self._assigned_total -= 1
            rec = self.task_manager.get(task_id)
            if rec is None or rec.done:
                # completed while queued = cancelled; the cancel path
                # removed-or-refunded already (a refund HERE would
                # double-credit the CRM — see _recall_assigned, which
                # skips the same way)
                continue
            if self._dispatch(worker, rec):
                return True
            self._recall_assigned(worker)
            return False

    def _quick_dispatch_from_queue(self, worker: WorkerHandle) -> bool:
        """Result-chained dispatch (runs on the worker's reader
        thread): hand the just-freed worker the OLDEST placed
        default-env task whose resources fit, without waiting for a
        scheduling-loop wake.  Conservative by design — any
        complication (env task at the head, in-flight arg pulls,
        stopped node, resource miss) falls back to the event loop,
        which retains full responsibility for fairness across classes
        and env/pull handling."""
        if worker.dead or worker.blocked or worker.env_key is not None \
                or getattr(worker, "dedicated", False):
            return False
        with self._cv:
            if self._stopped or self._draining or not self._local_queue:
                return False
            # oldest class head (same order _drain_local visits)
            pick, oldest = None, float("inf")
            for key in self._local_queue.classes():
                for tid in self._local_queue.bucket(key):
                    t0 = self._local_since.get(tid, float("inf"))
                    if t0 < oldest:
                        oldest, pick = t0, tid
                    break               # head of this class only
            if pick is None or pick in self._pull_pending:
                return False
            rec = self.task_manager.get(pick)
            if rec is None or rec.done or rec.spec.runtime_env:
                return False
            if not self.crm.subtract(self.row, rec.spec.resources):
                return False
            try:
                self._local_queue.remove(pick)
            except ValueError:
                self.crm.add_back(self.row, rec.spec.resources)
                return False
            self._local_since.pop(pick, None)
            self._env_miss_since.pop(pick, None)
            self._planned_add(rec.spec.resources, -1)
        return self._dispatch(worker, rec)

    def _recall_assigned(self, worker: WorkerHandle,
                         to_global: bool = False,
                         avoid_local: bool = False) -> None:
        """Pull every not-yet-sent task back off a worker (blocked in a
        get, declared stale, or dying) and requeue it for dispatch
        elsewhere.  Resources return; placement is re-planned.
        ``avoid_local``: re-place AWAY from this node (stale-lease
        spillback — local requeue would just re-commit to the same
        wedged worker in a loop)."""
        with self._cv:
            spill = list(worker.assigned)
            worker.assigned.clear()
            self._assigned_total -= len(spill)
            if self._draining:
                to_global = True    # local requeue would lease here again
        for task_id, _t in spill:
            rec = self.task_manager.get(task_id)
            if rec is None or rec.done:
                continue        # cancelled while queued: the cancel
                # path refunded at removal (see _dispatch_next_assigned)
            self.crm.add_back(self.row, rec.spec.resources)
            if avoid_local:
                with self._cv:
                    self._avoid_local.add(task_id)
                self._enqueue(task_id)
            elif to_global:
                self._enqueue(task_id)
            else:
                with self._cv:
                    self._local_queue.append(task_id,
                                             rec.spec.resources.key())
                    self._local_since[task_id] = _clk.monotonic()
                    self._planned_add(rec.spec.resources, 1)
        if spill:
            self._notify_dirty()

    def _requeue_after_worker_loss(self, rec, worker: WorkerHandle) -> None:
        self.crm.add_back(self.row, rec.spec.resources)
        self._task_start.pop(rec.spec.task_id.binary(), None)
        worker.dead = True
        self._enqueue(rec.spec.task_id)

    def _seal_error_returns(self, rec, err) -> None:
        """Seal ``err`` into every live return (seal before complete —
        see the result handler); a streaming generator additionally
        finishes its stream with the error so blocked consumers wake."""
        for oid in rec.return_ids:
            if oid not in rec.dead_returns:
                self.store.put(oid, err)
        if rec.spec.num_returns == -1:
            self.task_manager.stream_finished(rec.spec.task_id, err)

    def _fail_unscheduled(self, rec, message: str) -> None:
        """Fail a task that never reached dispatch (no resources were
        subtracted, no worker leased)."""
        err = RayTaskError(rec.spec.function_descriptor, message)
        self._seal_error_returns(rec, err)
        self.task_manager.complete(rec.spec.task_id)

    def _finish_with_error(self, rec, error: RayTaskError,
                           worker: WorkerHandle | None) -> None:
        self._seal_error_returns(rec, error)
        self.task_manager.complete(rec.spec.task_id)
        self.crm.add_back(self.row, rec.spec.resources)
        if worker is not None:
            self.pool.release(worker)
        self._notify_dirty()

    # -- worker frame handling (runs on reader threads) ---------------------
    def _on_worker_message(self, worker: WorkerHandle, msg: tuple) -> None:
        kind = msg[0]
        am = self.actor_manager
        if am is not None:
            if am.on_worker_message(worker, msg):
                return
            if kind == "actor_create":
                from ..common.ids import ActorID
                unpacked = deserialize(msg[4])
                namespace, lifetime = None, None
                if len(unpacked) == 11:
                    (args, kwargs, max_restarts, max_task_retries, name,
                     res, strategy, runtime_env, concurrency, namespace,
                     lifetime) = unpacked
                elif len(unpacked) == 9:
                    (args, kwargs, max_restarts, max_task_retries, name,
                     res, strategy, runtime_env, concurrency) = unpacked
                else:       # pre-concurrency frame shape
                    (args, kwargs, max_restarts, max_task_retries, name,
                     res, strategy, runtime_env) = unpacked
                    concurrency = None
                parent_env = self._parent_env_of(worker)
                if parent_env:
                    # worker-created actors inherit the creating
                    # task/actor's env, like child tasks do
                    from .runtime_env import merge_runtime_env
                    runtime_env = merge_runtime_env(parent_env,
                                                    runtime_env)
                if namespace is None:   # worker default: job namespace
                    namespace = self.cluster.default_namespace
                am.create_actor(ActorID(msg[1]), msg[2], msg[3], args,
                                kwargs, max_restarts, max_task_retries,
                                name, resources=res, strategy=strategy,
                                runtime_env=runtime_env,
                                concurrency=concurrency,
                                namespace=namespace, lifetime=lifetime)
                return
            if kind == "actor_submit":
                from ..common.ids import ActorID
                unpacked = deserialize(msg[4])
                if len(unpacked) == 5:
                    args, kwargs, num_returns, trace_ctx, group = unpacked
                else:
                    args, kwargs, num_returns, trace_ctx = unpacked
                    group = None
                am.submit(ActorID(msg[1]), TaskID(msg[2]), msg[3], args,
                          kwargs, num_returns, trace_ctx=trace_ctx,
                          concurrency_group=group)
                return
            if kind == "actor_kill":
                from ..common.ids import ActorID
                am.kill(ActorID(msg[1]), no_restart=msg[2])
                return
            if kind == "named_actor":
                ns = msg[2] if len(msg) > 2 else None
                if ns is None:      # worker default: the job's namespace
                    ns = self.cluster.default_namespace
                aid = am.get_by_name(msg[1], ns)
                worker.send(("named_actor_reply",
                             aid.binary() if aid else None))
                return
        if kind in ("result", "result_x", "error"):
            task_id_bin = msg[1]
            with self._cv:
                entry = self._running.pop(task_id_bin, None)
            if entry is None:
                self.pool.release(worker)
                return
            task_id, _, pinned = entry
            self.store.unpin(pinned)    # task done: release shm arg pins
            rec = self.task_manager.get(task_id)
            t0 = self._task_start.pop(task_id_bin, None)
            if t0 is not None and rec is not None:
                trace = {}
                if rec.spec.trace_ctx is not None:
                    trace = {"trace_id": rec.spec.trace_ctx[0],
                             "parent_id": rec.spec.trace_ctx[1],
                             "span_id": rec.spec.task_id.hex()}
                self.cluster.events.span(
                    "task", rec.spec.function_descriptor[:16], t0,
                    _clk.now(), self.row, worker=worker.proc.pid,
                    status=kind, **trace)
            if rec is not None and not rec.done:
                # returns seal BEFORE complete(): a dropped ref whose
                # decref folds mid-handler must see either a pending
                # record (defer-to-seal) or a sealed object (reclaim now)
                # — marking done first opens a window where the counter
                # concludes the object will never seal and leaks it
                if kind == "result":
                    self._seal_contained(rec, msg[3] if len(msg) > 3
                                         else None)
                    self._seal_results(rec, msg[2])
                elif kind == "result_x":
                    self._seal_contained(rec, msg[3] if len(msg) > 3
                                         else None)
                    self._seal_results_x(rec, msg[2])
                else:
                    self._seal_error_returns(rec, deserialize(msg[2]))
                self.task_manager.complete(task_id)
                self.crm.add_back(self.row, rec.spec.resources)
            # max_calls worker recycling (reference: the executing
            # worker retires after N calls of the function — the
            # pressure valve for native-memory leaks): kill instead of
            # reuse; the pool's death-respawn replaces it and recalls
            # any pipelined tasks
            if rec is not None and rec.spec.max_calls > 0 \
                    and not worker.dedicated:
                fd = rec.spec.function_descriptor
                worker.fn_calls[fd] = worker.fn_calls.get(fd, 0) + 1
                if worker.fn_calls[fd] >= rec.spec.max_calls:
                    self.pool.kill_worker(worker)
                    self._notify_dirty()
                    return
            # pipelined lease: ship the next committed task from THIS
            # reader thread before anything else can steal the worker;
            # with no committed entry, chain straight into the oldest
            # queued task that fits (skips the event-loop wake — the
            # tiny-task hot path's dominant fixed cost)
            if not self._dispatch_next_assigned(worker) and \
                    not self._quick_dispatch_from_queue(worker):
                self.pool.release(worker)
            self._notify_dirty()
        elif kind == "get":
            oids = [self._oid(b) for b in msg[1]]
            timeout = msg[2] if len(msg) > 2 else None
            # descriptors: shm objects reply as (offset, size) for a
            # zero-copy read on the worker's own arena mapping
            if all(self.store.contains(o) for o in oids) and \
                    all(self._object_local(o) for o in oids):
                if self.remote_plane:
                    worker.send(("get_reply_x", "ok",
                                 self._remote_get_descs(oids)))
                    return
                descs = self.store.get_descriptors_blocking(oids)
                self._send_get_reply(worker, oids, descs)
                return
            # Blocking get: release the task's resources while the worker
            # waits (reference: CPU is returned during ray.get so dependent
            # tasks can run) and grow the pool if it is starved — otherwise
            # recursive fan-out deadlocks on worker slots.  Remote plasma
            # objects are pulled here at GET priority (reference:
            # PullManager prioritizes gets above wait/task-arg pulls).
            from .pull_manager import PullPriority
            rec = self._rec_of_worker(worker)
            self._enter_blocked(worker, rec)
            pulled = self.cluster.pull_manager.pull_blocking(
                oids, self.row, PullPriority.GET, timeout, self.store)
            if self.remote_plane:
                ok = pulled and self.store.get_raw_presence(
                    oids, timeout=timeout)
                self._exit_blocked(worker, rec)
                if not ok:
                    worker.send(("get_reply_x", "timeout", None))
                else:
                    worker.send(("get_reply_x", "ok",
                                 self._remote_get_descs(oids)))
                return
            descs = self.store.get_descriptors_blocking(
                oids, timeout=timeout) if pulled else None
            self._exit_blocked(worker, rec)
            if descs is None:
                worker.send(("get_reply", serialize(("timeout", None))))
            else:
                self._send_get_reply(worker, oids, descs)
        elif kind == "get_ack":
            # the worker finished its zero-copy reads of the oldest
            # outstanding get reply: release those pins (FIFO — the
            # single-threaded worker acks replies in receive order)
            with worker.pin_lock:
                batch = (worker.pending_get_pins.popleft()
                         if worker.pending_get_pins else None)
            if batch:
                self.store.unpin(batch)
        elif kind == "wait":
            oids = [self._oid(b) for b in msg[1]]
            num_returns = min(msg[2], len(oids))
            timeout = msg[3]
            # fast path: already satisfiable without blocking this reader
            ready, _ = self.store.wait(oids, num_returns, timeout=0)
            if len(ready) < num_returns and (timeout is None or timeout > 0):
                rec = self._rec_of_worker(worker)
                self._enter_blocked(worker, rec)
                ready, _ = self.store.wait(oids, num_returns,
                                           timeout=timeout)
                self._exit_blocked(worker, rec)
            # warm locality for satisfied waits (reference: wait triggers
            # pulls below get priority); readiness itself is presence-based
            from .pull_manager import PullPriority
            from .object_store import PLASMA_KINDS
            for o in ready:
                if not self._object_local(o):
                    kind, size = self.store.plasma_info(o)
                    if kind in PLASMA_KINDS:
                        self.cluster.pull_manager.request_pull(
                            o, size, self.row, PullPriority.WAIT)
            worker.send(("wait_reply",
                         serialize([o.binary() for o in ready])))
        elif kind == "stream_item":
            # ("stream_item", tid_bin, index, payload, contained):
            # one yielded item of a streaming generator seals NOW
            from ..common.ids import ObjectID as _OID
            tid = TaskID(msg[1])
            oid = _OID.for_task_return(tid, msg[2])
            rec = self.task_manager.get(tid)   # None for actor streams
            if self.task_manager.stream_accepts(tid) and \
                    (rec is None or oid not in rec.dead_returns):
                self._register_contained(oid, msg[4])
                self.cluster.seal_serialized(oid, msg[3], self.row)
                self.task_manager.stream_item_sealed(tid, msg[2])
        elif kind == "stream_item_x":
            # plane mode: the agent sealed the payload into its arena
            # (the descriptor is always ("p", oid_bin, size) — small
            # items stay plain stream_item frames)
            from ..common.ids import ObjectID as _OID
            tid = TaskID(msg[1])
            oid = _OID.for_task_return(tid, msg[2])
            rec = self.task_manager.get(tid)
            d = msg[3]
            if not self.task_manager.stream_accepts(tid) \
                    or (rec is not None and oid in rec.dead_returns) \
                    or d[0] != "p":
                # dropped item: the agent's arena copy is orphaned —
                # free it (mirrors _seal_results_x's dead-return path)
                if d[0] == "p" and self.plane_address is not None:
                    self.cluster.plane.free_on(self.plane_address,
                                               [oid])
            else:
                self._register_contained(oid, msg[4])
                self.cluster.directory.add_location(oid, self.row)
                self.store.put_remote(oid, d[2])
                self.task_manager.stream_item_sealed(tid, msg[2])
        elif kind == "stream_end":
            tid = TaskID(msg[1])
            if len(msg) > 3 and msg[3]:
                # the producer STALLED out (no consumer ack for the
                # orphan window): finish the stream with a loud error
                # and reclaim its sealed payloads — a slow consumer
                # fails visibly (the errored state is retained) and
                # nothing big leaks in a long-lived driver
                orphans = self.task_manager.stream_abandon(
                    tid, RayTaskError(
                        "stream", "stream producer stalled: no "
                        "consumer ack within the orphan window (the "
                        "consuming side died, or took >10 minutes "
                        "between items)"))
                for oid in orphans:
                    if self.store.contains(oid):
                        # counter-routed so contained refs release too
                        self.cluster.ref_counter.force_reclaim(oid)
            else:
                self.task_manager.stream_finished(tid)
        elif kind == "stream_wait":
            # a WORKER consuming a stream: block like the get path
            # (resources return while it waits; this reader thread is
            # the worker's, so frames for it queue behind — the
            # existing blocking-get discipline)
            tid, index, timeout = TaskID(msg[1]), msg[2], msg[3]
            # fast path (like get): already satisfiable => no blocked-
            # worker dance (resource return/re-debit + recall per item)
            sealed, done, err, known = self.task_manager.wait_stream(
                tid, index, 0)
            if not (sealed > index or done):
                rec = self._rec_of_worker(worker)
                self._enter_blocked(worker, rec)
                sealed, done, err, known = \
                    self.task_manager.wait_stream(tid, index, timeout)
                self._exit_blocked(worker, rec)
            worker.send(("stream_wait_reply", sealed, done,
                         serialize(err) if err is not None else None,
                         known))
        elif kind == "stream_ack_up":
            self.cluster.stream_ack(TaskID(msg[1]), msg[2])
        elif kind == "stream_close_up":
            self.cluster.stream_close(TaskID(msg[1]), msg[2])
        elif kind == "named_list":
            am2 = self.actor_manager
            worker.send(("named_list_reply",
                         am2.list_named(msg[1])
                         if am2 is not None else []))
        elif kind == "stacks_reply":
            # live stack sample answered by the worker's reader thread
            self.cluster._on_stacks_reply(msg[1], self.row,
                                          worker.index, msg[2])
        elif kind == "refs":
            # this worker's batched local incref/decref events fold
            # against its holder entry (distributed refcounting)
            self.cluster.ref_counter.apply_batch(msg[1],
                                                 self._holder_of(worker))
        elif kind == "put":
            oid = self._oid(msg[1])
            self._register_contained(oid, msg[3] if len(msg) > 3 else ())
            self.cluster.ref_counter.set_owner(oid,
                                              self._holder_of(worker))
            self.cluster.seal_serialized(oid, msg[2], self.row)
        elif kind == "put_x":
            # a plane agent already sealed the put payload into its own
            # arena: record metadata only (location before seal)
            oid = self._oid(msg[1])
            self._register_contained(oid, msg[3] if len(msg) > 3 else ())
            self.cluster.ref_counter.set_owner(oid,
                                              self._holder_of(worker))
            self.cluster.directory.add_location(oid, self.row)
            self.store.put_remote(oid, msg[2])
        elif kind == "submit":
            spec = deserialize(msg[1])
            fn_id, fn_bytes = msg[2], msg[3]
            if fn_bytes is not None and fn_id not in self._fn_registry:
                self._fn_registry[fn_id] = fn_bytes
            # no driver-side ObjectRefs for the results: the live refs
            # are in the submitting WORKER process, whose own counter
            # streams them here against its holder entry ("refs"
            # frames) — the worker owns these returns and its holder
            # keeps them alive until its refs die (or it does)
            from ..common.ids import ObjectID as _OID
            holder = self._holder_of(worker)
            for i in range(spec.num_returns):
                self.cluster.ref_counter.set_owner(
                    _OID.for_task_return(spec.task_id, i + 1), holder)
            parent_env = self._parent_env_of(worker)
            if parent_env:
                # children inherit their PARENT task/actor's env, not
                # just the job's (reference inheritance semantics)
                from .runtime_env import merge_runtime_env
                spec.runtime_env = merge_runtime_env(parent_env,
                                                     spec.runtime_env)
            self.submit(spec)   # shares the job-env merge intake
        elif kind == "pg_create":
            from ..common.ids import PlacementGroupID
            from ..scheduling.bundles import PlacementStrategy
            bundles, strategy_name, name = deserialize(msg[2])
            self.cluster.pg_manager.create(
                PlacementGroupID(msg[1]), bundles,
                PlacementStrategy[strategy_name], name=name)
        elif kind == "pg_remove":
            from ..common.ids import PlacementGroupID
            self.cluster.pg_manager.remove(PlacementGroupID(msg[1]))
        elif kind == "kv":
            # ("kv", op, key, value, namespace, overwrite)
            #   -> ("kv_reply", result, error_or_None)
            # A reply goes back even on failure: the worker blocks in
            # _recv_reply with no timeout, so a swallowed exception here
            # (bad value type, unknown op) would wedge it forever.
            try:
                result = self.cluster.kv.dispatch(
                    msg[1], msg[2], msg[3], msg[4], msg[5])
                worker.send(("kv_reply", result, None))
            except Exception as e:      # noqa: BLE001
                worker.send(("kv_reply", None,
                             f"{type(e).__name__}: {e}"))

    def _holder_of(self, worker: WorkerHandle) -> tuple:
        """This worker process's refcount holder key (pool indexes are
        monotonic, so the key is never reused on this raylet)."""
        return ("w", self.row, worker.index)

    def _register_contained(self, parent, contained_bins) -> None:
        if contained_bins:
            self.cluster.ref_counter.add_contained(
                parent, [self._oid(b) for b in contained_bins])

    def _seal_contained(self, rec, contained) -> None:
        """Refs pickled inside result payloads stay alive until the
        enclosing return object is reclaimed (borrow-on-return)."""
        if not contained:
            return
        for oid, inner in zip(rec.return_ids, contained):
            if inner and oid not in rec.dead_returns:
                self._register_contained(oid, inner)

    def _seal_results(self, rec, payloads) -> None:
        """Seal a task's serialized return payloads (size-routed, with
        pre-registered locations — ``Cluster.seal_serialized``)."""
        for oid, data in zip(rec.return_ids, payloads):
            if oid in rec.dead_returns:
                continue        # reclaimed while out of scope: a re-seal
                # would live forever (no refs remain to ever decref it)
            self.cluster.seal_serialized(oid, data, self.row)

    def _seal_results_x(self, rec, descs) -> None:
        """Seal plane-mode return descriptors: ("p", oid_bin, size) means
        the agent already sealed the payload into ITS arena — the head
        records metadata only (directory location BEFORE the remote seal,
        the seal_serialized ordering); ("v", bytes) rode in-band and
        seals here, born on the HEAD row (that is where the bytes are)."""
        head_row = self.cluster.head().row
        for oid, d in zip(rec.return_ids, descs):
            if oid in rec.dead_returns:
                if d[0] == "p" and self.plane_address is not None:
                    # nobody will ever reference it: free the agent copy
                    self.cluster.plane.free_on(self.plane_address, [oid])
                continue
            if d[0] == "p":
                self.cluster.directory.add_location(oid, self.row)
                self.store.put_remote(oid, d[2])
            else:
                self.cluster.seal_serialized(oid, d[1], head_row)

    def _remote_get_descs(self, oids) -> list:
        """Get-reply descriptors for a plane-backed remote worker: plasma
        objects with a copy on this row ship by reference ("r" — the
        agent resolves them against its own arena, bytes never transit
        the head); head-resident bytes inline under the pin; in-band
        values ship serialized (the relay never unpickles user data)."""
        from .object_store import PLASMA_KINDS
        out = []
        for o in oids:
            kind, _size = self.store.plasma_info(o)
            if kind in PLASMA_KINDS and \
                    self.cluster.directory.has_location(o, self.row):
                out.append(("r", o.binary()))
                continue
            try:
                desc = self.store.descriptor_of(o)
            except KeyError:
                # vanished post-wait (reclaim race): surface as an error
                from .object_store import ObjectLostError
                desc = ("v", RayTaskError(
                    "get", f"object {o.hex()[:12]} was reclaimed",
                    ObjectLostError(o.hex())))
            if desc[0] == "s":
                out.append(("b", self.store.inline_bytes(o, desc)))
            elif desc[0] == "v":
                out.append(("vb", serialize(desc[1])))
            else:
                out.append(desc)
        return out

    def _send_get_reply(self, worker: WorkerHandle, oids, descs) -> None:
        """Ship get descriptors; shm descriptors were pinned by the store,
        so record them for release on the worker's get_ack (every reply
        with shm descriptors gets exactly one ack)."""
        if self.inline_objects:
            # remote worker: no shared arena, so copy under the pin and
            # release now — in-band descriptors are never acked
            descs = [("b", self.store.inline_bytes(o, d))
                     if d[0] == "s" else d
                     for o, d in zip(oids, descs)]
        shm_pins = [(o, d[1]) for o, d in zip(oids, descs) if d[0] == "s"]
        if shm_pins:
            with worker.pin_lock:
                if worker.no_more_pins:
                    # worker is being drained/killed: drop the reply (it
                    # will never be read) and release the pins now
                    self.store.unpin(shm_pins)
                    return
                worker.pending_get_pins.append(shm_pins)
        if not worker.send(("get_reply", serialize(("ok", descs)))) \
                and shm_pins:
            with worker.pin_lock:
                try:
                    worker.pending_get_pins.remove(shm_pins)
                except ValueError:
                    return          # a concurrent drain already released
            self.store.unpin(shm_pins)

    @staticmethod
    def _oid(binary: bytes):
        from ..common.ids import ObjectID
        return ObjectID(binary)

    def _object_local(self, oid) -> bool:
        """True when a get/dispatch on this node needs no pull: in-band
        value, or a plasma object with a local copy."""
        from .object_store import PLASMA_KINDS
        kind, _ = self.store.plasma_info(oid)
        return kind not in PLASMA_KINDS or \
            self.cluster.directory.has_location(oid, self.row)

    def _drain_worker_pins(self, worker: WorkerHandle) -> None:
        """Release every un-acked get-reply pin of a dead/draining worker
        and latch out further appends (a reader thread may still be
        finishing a blocking get for it)."""
        with worker.pin_lock:
            worker.no_more_pins = True
            batches = list(worker.pending_get_pins)
            worker.pending_get_pins.clear()
        for batch in batches:
            self.store.unpin(batch)

    def _rec_of_worker(self, worker: WorkerHandle):
        """TaskRecord of the task the worker is currently executing."""
        if worker.leased_task is None:
            return None
        with self._cv:
            entry = self._running.get(worker.leased_task)
        return self.task_manager.get(entry[0]) if entry is not None else None

    def _enter_blocked(self, worker: WorkerHandle, rec) -> None:
        """Worker blocks in get/wait: return its task's resources so
        dependent tasks can run, and grow the pool if starved.  Tasks
        pipelined behind the blocker are recalled and dispatch
        elsewhere — left queued they could deadlock (the blocker may be
        waiting on exactly the task parked behind it)."""
        worker.blocked = True
        self._recall_assigned(worker)
        if rec is not None:
            self.crm.add_back(self.row, rec.spec.resources)
            self._notify_dirty()
        self.pool.grow_for_blocked()

    def _exit_blocked(self, worker: WorkerHandle, rec) -> None:
        """Re-acquire before resuming (waits for capacity like the
        reference's worker unblock path; bounded oversubscription is
        preferred over a stuck reader if capacity never frees)."""
        if rec is not None:
            self._reacquire(rec.spec.resources)
        worker.blocked = False

    def _reacquire(self, resources: ResourceRequest,
                   patience: float = 5.0) -> None:
        """Event-driven re-debit after a blocking get: parks on the CRM's
        release condition (no polling); past ``patience`` it
        oversubscribes rather than wedging — the matching add_back at task
        completion rebalances."""
        if not self.crm.wait_subtract(self.row, resources, patience):
            self.crm.force_subtract(self.row, resources)

    def _on_worker_death(self, worker: WorkerHandle) -> None:
        self._drain_worker_pins(worker)
        # fate-sharing: every ref this worker process held dies with it
        self.cluster.ref_counter.holder_gone(self._holder_of(worker))
        # not-yet-sent pipelined tasks were never at risk: requeue them
        self._recall_assigned(worker, to_global=True)

        if self.actor_manager is not None and \
                self.actor_manager.on_worker_death(worker):
            return
        task_id_bin = worker.leased_task
        if task_id_bin is None:
            return
        with self._cv:
            entry = self._running.pop(task_id_bin, None)
        if entry is None:
            return
        task_id, _, pinned = entry
        self.store.unpin(pinned)
        self._task_start.pop(task_id_bin, None)
        rec = self.task_manager.get(task_id)
        if rec is None:
            return
        self.crm.add_back(self.row, rec.spec.resources)
        if rec.done:
            # completed elsewhere (a force-cancel sealed it before the
            # kill): only the resource refund above was still owed —
            # re-sealing would clobber the cancellation error
            self._notify_dirty()
            return
        if self.task_manager.should_retry(task_id):
            self._enqueue(task_id)
        else:
            err = RayTaskError(
                rec.spec.function_descriptor,
                "worker died", WorkerCrashedError(
                    f"worker {worker.index} died executing "
                    f"{rec.spec.function_descriptor}"))
            self._seal_error_returns(rec, err)
            self.task_manager.complete(task_id)
        self._notify_dirty()

    # -- cancel / teardown --------------------------------------------------
    def _cancel_seal_and_complete(self, task_id: TaskID) -> None:
        """Seal the cancellation error, THEN mark done (seal-before-
        complete, like the result handler)."""
        from .serialization import TaskCancelledError
        rec = self.task_manager.get(task_id)
        if rec is None or rec.done:
            return
        err = RayTaskError(rec.spec.function_descriptor, "cancelled",
                           TaskCancelledError())
        self._seal_error_returns(rec, err)
        self.task_manager.complete(task_id)

    def stream_ack(self, task_id: TaskID, consumed: int) -> bool:
        """Relay a consumer's progress to the generator's worker so its
        backpressure window slides; False when the task is not running
        here (best-effort — a stalled ack only pauses the producer)."""
        with self._cv:
            entry = self._running.get(task_id.binary())
        if entry is None:
            return False
        entry[1].send(("stream_ack", task_id.binary(), consumed))
        return True

    def stream_cancel(self, task_id: TaskID) -> bool:
        """Cooperative stop for a running generator: it ends its stream
        at the next backpressure check instead of yielding further."""
        with self._cv:
            entry = self._running.get(task_id.binary())
        if entry is None:
            return False
        entry[1].send(("stream_cancel", task_id.binary()))
        return True

    def cancel(self, task_id: TaskID, force: bool = False) -> bool:
        from .serialization import TaskCancelledError
        with self._cv:
            if task_id in self._local_queue:
                rec0 = self.task_manager.get(task_id)
                self._local_queue.remove(task_id)
                self._local_since.pop(task_id, None)
                self._env_miss_since.pop(task_id, None)
                if rec0 is not None:
                    self._planned_add(rec0.spec.resources, -1)
                self._cancel_seal_and_complete(task_id)
                return True
            if task_id in self._queue:
                self._queue.remove(task_id)
                self._avoid_local.discard(task_id)
                self._cancel_seal_and_complete(task_id)
                return True
            if self._waiting.pop(task_id, None) is not None:
                # dep-waiting: resolve its refs with the cancellation error
                # (a later _dep_ready finds no entry and is a no-op)
                self._cancel_seal_and_complete(task_id)
                return True
            entry = self._running.get(task_id.binary())
        if entry is None:
            # committed to a worker's pipelined lease but not yet sent:
            # remove + refund; sealing completes the record so a racing
            # _dispatch_next_assigned skips it
            with self.pool._lock:
                workers = list(self.pool._workers)
            for w in workers:
                with self._cv:
                    match = [e for e in w.assigned if e[0] == task_id]
                    for e in match:
                        w.assigned.remove(e)
                        self._assigned_total -= 1
                if match:
                    rec0 = self.task_manager.get(task_id)
                    if rec0 is not None:
                        self.crm.add_back(self.row, rec0.spec.resources)
                    self._cancel_seal_and_complete(task_id)
                    return True
        if entry is not None and force:
            # seal FIRST (exactly like the agent-leased branch below):
            # the worker-death bookkeeping must find the record done
            # and skip its retry — killing first would race the death
            # path into resubmitting the cancelled task
            self._cancel_seal_and_complete(task_id)
            self.pool.kill_worker(entry[1])  # death path does bookkeeping
            return True
        # agent-leased task (autonomous dispatch): ask the agent what
        # state it is in, then mirror the head-local semantics —
        # a QUEUED task cancels outright; a RUNNING one cancels only
        # under force (the kill); non-force running returns False like
        # the local path.  Sealing here may race a just-completed
        # done-sync: _cancel_seal_and_complete no-ops on a done record,
        # and AgentHub._sync_done frees agent-arena descs of a record
        # completed elsewhere, so neither side leaks.
        rec_a = self.agent_inflight.get(task_id)
        if rec_a is not None:
            sp = getattr(self.pool, "_spawner", None)
            if force:
                # seal FIRST: the kill's worker-death 'retry' handback
                # must find rec.done and be skipped — sealing after
                # would race it into resubmitting the cancelled task
                self.agent_inflight.pop(task_id, None)
                self._cancel_seal_and_complete(task_id)
                if sp is not None and hasattr(sp, "cancel_remote"):
                    sp.cancel_remote(task_id.binary(), True)
                return True
            verdict = None
            if sp is not None and hasattr(sp, "cancel_remote"):
                verdict = sp.cancel_remote(task_id.binary(), False)
            if verdict == "dequeued":
                # never dispatched: no handback can race this seal
                self.agent_inflight.pop(task_id, None)
                self._cancel_seal_and_complete(task_id)
                return True
            return False        # running + non-force: like local path
        return False

    def start_graceful_drain(self) -> None:
        """ALIVE -> DRAINING: stop committing new leases here while
        running tasks finish.  Unlike ``drain_for_removal`` the pool and
        event loop stay up: queued and pipelined-but-unsent work
        re-enters GLOBAL scheduling, and because the CRM drain mask
        makes this row infeasible to every policy, it lands elsewhere.
        Idempotent."""
        with self._cv:
            if self._draining:
                return
            self._draining = True
        # pipelined-but-unsent leases come back and re-place globally
        with self.pool._lock:
            workers = list(self.pool._workers)
        for w in workers:
            self._recall_assigned(w, to_global=True)
        with self._cv:
            requeue = list(self._local_queue)
            self._local_queue.clear()
            for task_id in requeue:
                self._local_since.pop(task_id, None)
                self._env_miss_since.pop(task_id, None)
                # in-flight arg pulls: the entry goes now, so a late
                # _pull_done finds nothing and no-ops
                self._pull_pending.pop(task_id, None)
                rec = self.task_manager.get(task_id)
                if rec is not None:
                    self._planned_add(rec.spec.resources, -1)
                self._queue.append(task_id)
            self._dirty = True
            self._cv.notify_all()

    def is_draining(self) -> bool:
        return self._draining

    def drain_empty(self) -> bool:
        """Nothing left that holds this node's resources or would die
        with it: no backlog awaiting (re-)placement, no leases, no
        running tasks, no agent-leased work, no live actor workers.
        Dep-WAITING tasks are deliberately excluded — they hold no
        lease, and forced removal reroutes their readiness callbacks
        through the fallback raylet."""
        with self._cv:
            busy = (self._queue or self._local_queue or self._running
                    or self._pull_pending or self.agent_inflight
                    or self._assigned_total)
        if busy:
            return False
        with self.pool._lock:
            return not any(w.dedicated and not w.dead
                           for w in self.pool._workers)

    def drain_for_removal(self, fallback: "Raylet") -> None:
        """Node death: fail/retry running tasks, reroute queued ones,
        restart-or-fail actors placed here, keep dep-waiting tasks alive
        (their readiness callbacks re-route to the fallback raylet)."""
        # recall never-sent pipelined tasks FIRST so the queue capture
        # below reroutes them with everything else
        with self.pool._lock:
            pool_workers = list(self.pool._workers)
        for w in pool_workers:
            self._recall_assigned(w)
        with self._cv:
            self._stopped = True
            self._removal_fallback = fallback
            queued = list(self._queue) + list(self._local_queue)
            self._queue.clear()
            self._local_queue.clear()
            self._local_since.clear()
            self._env_miss_since.clear()
            self._avoid_local.clear()
            running = list(self._running.items())
            self._running.clear()
            self._cv.notify_all()
        if self.actor_manager is not None:
            self.actor_manager.fail_actors_on_pool(self.pool)
        # the pool shutdown suppresses per-worker death callbacks, so
        # release descriptor pins (get replies + running-task args) here
        with self.pool._lock:
            workers = list(self.pool._workers)
        for w in workers:
            self._drain_worker_pins(w)
            self.cluster.ref_counter.holder_gone(self._holder_of(w))
        for task_id in queued:
            fallback.enqueue_forwarded(task_id)
        # tasks the agent leased autonomously die with the node too:
        # their done-sync will never arrive, so retry or fail them NOW
        # (exactly the running-task semantics below)
        agent_tasks = list(self.agent_inflight.values())
        self.agent_inflight.clear()
        self.agent_local_cu = None
        for rec in agent_tasks:
            task_id = rec.spec.task_id
            if rec.done:
                continue
            if self.task_manager.should_retry(task_id):
                fallback.enqueue_forwarded(task_id)
            else:
                err = RayTaskError(
                    rec.spec.function_descriptor, "node removed",
                    WorkerCrashedError("node died with agent-leased "
                                       "task running"))
                self._seal_error_returns(rec, err)
                self.task_manager.complete(task_id)
        for _bin, (task_id, _w, pinned) in running:
            self.store.unpin(pinned)
            if self.task_manager.should_retry(task_id):
                fallback.enqueue_forwarded(task_id)
            else:
                rec = self.task_manager.get(task_id)
                if rec is None:
                    continue
                err = RayTaskError(
                    rec.spec.function_descriptor, "node removed",
                    WorkerCrashedError("node died"))
                self._seal_error_returns(rec, err)
                self.task_manager.complete(task_id)
        self.pool.shutdown()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self.pool.shutdown()
