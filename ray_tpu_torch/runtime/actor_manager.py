"""Actor lifecycle + ordered method dispatch (GCS actor manager analogue).

Reference parity: ``GcsActorManager`` (registration, restart policy) +
``ActorTaskSubmitter`` (per-actor ordered queues, direct worker RPC) +
the dedicated actor worker model (``src/ray/gcs/gcs_server/
gcs_actor_manager.cc``, ``src/ray/core_worker/transport/
actor_task_submitter.cc`` — SURVEY.md §3.4; mount empty).

Model: every actor gets a DEDICATED spawned worker (reference behavior).
Method calls are strictly FIFO per actor: the head of the queue is sent
only when its ObjectRef deps are ready, preserving submission order even
when later calls' deps resolve first.  Calls pipeline onto the pipe (the
worker executes in receive order), bounded by a small in-flight window.

Restart policy: ``max_restarts`` re-runs the creation task on a fresh
worker (state is lost — reference semantics); in-flight calls at death
fail with ``ActorDiedError`` unless the actor's ``max_task_retries``
budget resubmits them; queued-not-yet-sent calls carry over.
"""

from __future__ import annotations

import enum
import threading
from collections import deque
from dataclasses import dataclass, field

from ..common.ids import ActorID, ObjectID, TaskID
from ..common.resources import ResourceRequest
from ..common.task_spec import SchedulingStrategy, SchedulingStrategyKind
from ..scheduling.policy import SchedulingOptions
from .object_ref import ObjectRef
from .serialization import (ActorDiedError, RayTaskError, deserialize,
                            serialize)
from ..common import clock as _clk

_MAX_INFLIGHT = 16          # pipelining window per actor


class ActorState(enum.Enum):
    PENDING = 0
    ALIVE = 1
    RESTARTING = 2
    DEAD = 3


@dataclass
class ActorCall:
    task_id: TaskID
    method: str
    args: tuple
    kwargs: dict
    num_returns: int
    retries_left: int = 0
    trace_ctx: tuple | None = None      # (trace_id, parent_span)
    sent_at: float = 0.0                # span start (set at send)
    group: str | None = None            # concurrency group


@dataclass
class ActorRecord:
    actor_id: ActorID
    cls_id: str
    init_args: tuple
    init_kwargs: dict
    max_restarts: int
    max_task_retries: int
    name: str | None
    resources: ResourceRequest = field(default_factory=ResourceRequest)
    strategy: SchedulingStrategy = field(
        default_factory=SchedulingStrategy)
    runtime_env: dict | None = None
    # {"max_concurrency": N, "concurrency_groups": {name: n}} — ships
    # to the worker's _ActorExecutor; widens the pipelining window so
    # a concurrent actor actually receives overlapping calls
    concurrency: dict | None = None
    # named-actor namespace ("" = the shared default namespace —
    # explicit namespaces isolate, reference ray.init(namespace=...))
    namespace: str = ""
    # "detached" actors outlive their creating job: a client disconnect
    # kills its ephemeral actors but leaves detached ones running
    # (reference lifetime="detached", GcsActorManager detached handling)
    lifetime: str = "ephemeral"
    state: ActorState = ActorState.PENDING
    worker = None
    pool = None                 # worker pool of the placement node
    row: int = -1               # placement node row (resource accounting)
    queue: deque = field(default_factory=deque)
    inflight: dict = field(default_factory=dict)    # task_id_bin -> ActorCall
    restarts_left: int = 0
    graceful_exit: bool = False


class ActorManager:
    def __init__(self, cluster):
        self._cluster = cluster
        self._store = cluster.store
        self._fn_registry = cluster.fn_registry
        self._lock = threading.RLock()
        self._actors: dict[ActorID, ActorRecord] = {}
        # (namespace, name) -> actor id
        self._names: dict[tuple[str, str], ActorID] = {}
        # streaming actor calls in flight: call task id -> actor id
        # (routes consumer acks/cancels to the actor's worker)
        self._stream_calls: dict[bytes, ActorID] = {}

    # -- creation -----------------------------------------------------------
    def create_actor(self, actor_id: ActorID, cls_id: str,
                     cls_bytes: bytes | None, args: tuple, kwargs: dict,
                     max_restarts: int, max_task_retries: int,
                     name: str | None = None,
                     resources: ResourceRequest | None = None,
                     strategy: SchedulingStrategy | None = None,
                     runtime_env: dict | None = None,
                     concurrency: dict | None = None,
                     namespace: str = "",
                     lifetime: str | None = None) -> None:
        if cls_bytes is not None:
            self._fn_registry.setdefault(cls_id, cls_bytes)
        lifetime = lifetime or "ephemeral"
        if lifetime == "detached" and name is None:
            raise ValueError(
                "detached actors must be named (reference requirement)")
        from .runtime_env import merge_runtime_env
        rec = ActorRecord(actor_id, cls_id, args, kwargs, max_restarts,
                          max_task_retries, name,
                          resources=resources or ResourceRequest(),
                          strategy=strategy or SchedulingStrategy(),
                          runtime_env=merge_runtime_env(
                              self._cluster.job_runtime_env, runtime_env),
                          concurrency=concurrency,
                          namespace=namespace or "",
                          lifetime=lifetime)
        rec.restarts_left = max_restarts
        with self._lock:
            if name is not None:
                nkey = (rec.namespace, name)
                if nkey in self._names:
                    raise ValueError(
                        f"actor name {name!r} already taken in "
                        f"namespace {rec.namespace!r}")
                self._names[nkey] = actor_id
            self._actors[actor_id] = rec
        self._resolve_then(args, lambda: self._start_incarnation(rec))

    def _resolve_then(self, args: tuple, callback) -> None:
        deps = [a.id for a in args if isinstance(a, ObjectRef)]
        missing = [d for d in deps if not self._store.contains(d)]
        if not missing:
            callback()
            return
        state = {"left": len(missing)}
        state_lock = threading.Lock()

        def on_one(_oid):
            with state_lock:
                state["left"] -= 1
                done = state["left"] == 0
            if done:
                callback()

        for d in missing:
            self._store.on_ready(d, on_one)

    def _start_incarnation(self, rec: ActorRecord) -> None:
        with self._lock:
            if rec.state is ActorState.DEAD:    # killed while pending
                return
        # placement: actors schedule like tasks, through the hybrid policy
        # over the shared resource view (reference: GcsActorScheduler uses
        # the same ClusterTaskManager lease path, SURVEY.md 3.4)
        crm = self._cluster.crm
        snapshot = crm.snapshot()
        options = SchedulingOptions()
        if rec.strategy.kind is SchedulingStrategyKind.PLACEMENT_GROUP:
            verdict, options = self._cluster.pg_manager.\
                scheduling_options_for(rec.strategy,
                                       snapshot.node_mask.shape[0])
            if verdict == "dead":
                self._on_incarnation_dead(rec.actor_id, init_error=(
                    RayTaskError("actor ctor", "placement group removed, "
                                 "unknown, or bundle index out of range",
                                 ActorDiedError())))
                return
            if verdict == "park":
                # gang member before the gang is reserved: defer until the
                # PG manager commits (its ready marker lands in the store)
                from .placement_group_manager import ready_oid_for
                self._store.on_ready(
                    ready_oid_for(rec.strategy.placement_group_id),
                    lambda _o: self._start_incarnation(rec))
                return
        req = rec.resources.dense(crm.resource_index,
                                  snapshot.totals.shape[1])
        from ..scheduling.policy import CompositeSchedulingPolicy
        row = CompositeSchedulingPolicy().schedule(snapshot, req, options)
        raylet = self._cluster.raylet_of_row(row) if row >= 0 else None
        if raylet is None:
            self._on_incarnation_dead(rec.actor_id, init_error=RayTaskError(
                "actor ctor", "no feasible node for actor resources "
                f"{rec.resources.to_dict()}", ActorDiedError()))
            return
        if not rec.resources.is_empty():
            crm.subtract(row, rec.resources)
        if rec.runtime_env:
            from .runtime_env import RuntimeEnvSetupError, env_key
            try:
                key = env_key(rec.runtime_env)
                payload = self._cluster.runtime_env_manager.get_if_ready(
                    key)
            except (RuntimeEnvSetupError, ValueError) as e:
                if not rec.resources.is_empty():
                    crm.add_back(row, rec.resources)
                self._on_incarnation_dead(
                    rec.actor_id, init_error=RayTaskError(
                        "actor ctor", f"runtime_env setup failed: {e}",
                        ActorDiedError()))
                return
            if payload is None:
                # provision off this thread: worker-submitted actor
                # creation arrives on a pool READER thread, and a
                # copytree there would stall every frame on the node
                # (get replies, results).  Release the reservation and
                # re-place once staged — the manager dedups concurrent
                # stagers of one key.
                if not rec.resources.is_empty():
                    crm.add_back(row, rec.resources)

                def provision() -> None:
                    try:
                        self._cluster.runtime_env_manager.stage(
                            rec.runtime_env)
                    except Exception:   # noqa: BLE001 — cached; the
                        pass            # retry surfaces the failure
                    self._start_incarnation(rec)
                import threading
                threading.Thread(target=provision, daemon=True,
                                 name="actor-env-stage").start()
                return
            worker = raylet.pool.spawn_dedicated(
                env_key=key, env_payload=payload)
        else:
            worker = raylet.pool.spawn_dedicated()
        worker.actor_binding = rec.actor_id
        with self._lock:
            rec.worker = worker
            rec.pool = raylet.pool
            rec.row = row
        try:
            payload = serialize((self._materialize_args(rec.init_args),
                                 rec.init_kwargs, rec.concurrency))
        except KeyError as e:
            # an init arg could not materialize at the head (its plane
            # pull failed / the object was reclaimed): fail the actor's
            # creation instead of killing this thread and leaving the
            # record PENDING forever (_on_incarnation_dead reaps the
            # dedicated worker and refunds its resources)
            self._on_incarnation_dead(rec.actor_id, init_error=RayTaskError(
                rec.cls_id, f"actor init argument unavailable: {e}"))
            return
        worker.send(("fn", rec.cls_id, self._fn_registry[rec.cls_id]))
        worker.send(("actor_new", rec.actor_id.binary(), rec.cls_id,
                     payload))

    def runtime_env_of(self, actor_id: ActorID) -> dict | None:
        """The (job-merged) env an actor runs in — children it submits
        inherit this (reference parent-inheritance semantics)."""
        with self._lock:
            rec = self._actors.get(actor_id)
            return rec.runtime_env if rec is not None else None

    def _materialize_args(self, args: tuple) -> tuple:
        # bytes living only on an agent plane pull to the head first
        # (actor args materialize head-side)
        remote = [a.id for a in args if isinstance(a, ObjectRef)
                  and self._store.plasma_info(a.id)[0] == "remote"]
        if remote:
            from .pull_manager import PullPriority
            self._cluster.pull_manager.pull_blocking(
                remote, self._cluster.head().row,
                PullPriority.TASK_ARG, None, self._store)
        out = []
        for a in args:
            if isinstance(a, ObjectRef):
                v = self._store.peek(a.id)
                out.append(v)
            else:
                out.append(a)
        return tuple(out)

    # -- method submission --------------------------------------------------
    def submit(self, actor_id: ActorID, task_id: TaskID, method: str,
               args: tuple, kwargs: dict, num_returns: int,
               trace_ctx: tuple | None = None,
               concurrency_group: str | None = None) -> None:
        if num_returns == -1:
            # streaming call: the table entry makes consumer waits
            # meaningful from submission, before any item seals
            self._cluster.task_manager.stream_open(task_id)
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None or rec.state is ActorState.DEAD:
                self._fail_call_ids(task_id, num_returns, actor_id)
                return
            call = ActorCall(task_id, method, args, kwargs, num_returns,
                             retries_left=rec.max_task_retries,
                             trace_ctx=trace_ctx,
                             group=concurrency_group)
            if num_returns == -1:
                self._stream_calls[task_id.binary()] = actor_id
            rec.queue.append(call)
        self._pump(actor_id)

    def stream_ack(self, task_id: TaskID, consumed: int) -> bool:
        """Relay a consumer ack to the worker running a streaming actor
        call (False when unknown — e.g. already finished)."""
        return self._stream_forward(task_id,
                                    ("stream_ack", task_id.binary(),
                                     consumed))

    def stream_cancel(self, task_id: TaskID) -> bool:
        return self._stream_forward(task_id,
                                    ("stream_cancel",
                                     task_id.binary()))

    def _stream_forward(self, task_id: TaskID, frame: tuple) -> bool:
        with self._lock:
            actor_id = self._stream_calls.get(task_id.binary())
            rec = self._actors.get(actor_id) if actor_id else None
            worker = rec.worker if rec is not None else None
        if worker is None:
            return False
        worker.send(frame)
        return True

    @staticmethod
    def _window(rec: ActorRecord) -> int:
        """Pipelining window: a concurrent actor must RECEIVE overlapping
        calls, so the window opens to its max_concurrency (plus group
        capacity); plain actors keep the default pipeline depth."""
        conc = rec.concurrency or {}
        want = int(conc.get("max_concurrency") or 0)
        want += sum(int(n) for n in
                    (conc.get("concurrency_groups") or {}).values())
        return max(_MAX_INFLIGHT, want)

    def _fail_call_ids(self, task_id: TaskID, num_returns: int,
                       actor_id: ActorID) -> None:
        err = RayTaskError(
            "actor task", "actor is dead",
            ActorDiedError(f"actor {actor_id.hex()[:12]} is dead"))
        self._seal_call_error(task_id, num_returns, err)

    def _seal_call_error(self, task_id: TaskID, num_returns: int,
                         err) -> None:
        """Fail one call's outputs: fixed returns seal the error;
        streaming calls finish their stream with it (waking blocked
        consumers) and drop the ack-routing entry."""
        if num_returns == -1:
            self._cluster.task_manager.stream_finished(task_id, err)
            with self._lock:
                self._stream_calls.pop(task_id.binary(), None)
            return
        for i in range(num_returns):
            self._store.put(ObjectID.for_task_return(task_id, i + 1),
                            err)

    def _pump(self, actor_id: ActorID) -> None:
        """Send queued calls in order while deps-ready and window open.

        The pop-and-send of each call happens entirely under the manager
        lock: two concurrent pumps (submitter thread + the actor's reader
        thread on completion) must not interleave their sends, or the
        worker would execute out of FIFO order.  Sends are non-blocking
        pipe writes, so holding the lock across them is cheap.
        """
        missing: list = []
        with self._lock:
            while True:
                rec = self._actors.get(actor_id)
                if rec is None or rec.state is not ActorState.ALIVE:
                    return
                if not rec.queue or \
                        len(rec.inflight) >= self._window(rec):
                    return
                call = rec.queue[0]
                deps = [a.id for a in call.args
                        if isinstance(a, ObjectRef)]
                missing = [d for d in deps
                           if not self._store.contains(d)]
                if missing:
                    break
                remote = self._remote_deps(deps)
                if remote:
                    # args whose bytes live only on an agent plane pull
                    # to the head first (actor calls materialize args
                    # head-side); the pull completion re-pumps
                    self._pull_remote_deps(remote, actor_id)
                    return
                rec.queue.popleft()
                dep_err = None
                vals = []
                for a in call.args:
                    if isinstance(a, ObjectRef):
                        v = self._store.peek(a.id)
                        if isinstance(v, RayTaskError):
                            dep_err = v
                            break
                        vals.append(v)
                    else:
                        vals.append(a)
                if dep_err is not None:
                    self._seal_call_error(call.task_id, call.num_returns, dep_err)
                    continue
                rec.inflight[call.task_id.binary()] = call
                call.sent_at = _clk.now()
                from .object_ref import (mark_transferred,
                                         transfer_generators)
                with transfer_generators() as gens:
                    payload = serialize((tuple(vals), call.kwargs,
                                         call.num_returns,
                                         call.trace_ctx, call.group))
                if rec.worker.send(("actor_call",
                                    call.task_id.binary(),
                                    call.method, payload)):
                    # only a SHIPPED frame moves stream consumption;
                    # a dead-worker send keeps the caller's close()
                    mark_transferred(gens)
        # head has missing deps: wake the pump when they land
        for d in missing:
            self._store.on_ready(d, lambda _o, a=actor_id: self._pump(a))

    def _remote_deps(self, deps) -> list:
        """Dep oids whose bytes are NOT materializable at the head: a
        metadata-only RemoteEntry means the payload lives on an agent
        plane (shm/spill entries are head-resident by definition — one
        shared store backs every simulated row)."""
        return [d for d in deps
                if self._store.plasma_info(d)[0] == "remote"]

    def _pull_remote_deps(self, oids, actor_id: ActorID) -> None:
        from .pull_manager import PullPriority
        head_row = self._cluster.head().row
        for d in oids:
            _kind, size = self._store.plasma_info(d)
            self._cluster.pull_manager.request_pull(
                d, size, head_row, PullPriority.TASK_ARG,
                callback=lambda _ok, a=actor_id: self._pump(a))

    # -- worker frame handling ---------------------------------------------
    def on_worker_message(self, worker, msg) -> bool:
        """Returns True if the frame was an actor frame and was handled."""
        kind = msg[0]
        if kind == "actor_ready":
            actor_id = ActorID(msg[1])
            doomed = None       # (pool, worker) of an actor killed mid-ctor
            with self._lock:
                rec = self._actors.get(actor_id)
                if rec is not None:
                    if rec.state is ActorState.DEAD:
                        # killed while PENDING: do not resurrect — reap the
                        # dedicated worker and return its resources
                        doomed = self._reap_worker_locked(rec)
                    else:
                        rec.state = ActorState.ALIVE
            if doomed is not None:
                self._kill_reaped(doomed)
                return True
            self._pump(actor_id)
            return True
        if kind == "actor_init_error":
            actor_id = ActorID(msg[1])
            err = deserialize(msg[2])
            self._on_incarnation_dead(actor_id, init_error=err)
            return True
        if kind in ("actor_result", "actor_result_x", "actor_error"):
            task_id_bin = msg[1]
            actor_id = getattr(worker, "actor_binding", None)
            with self._lock:
                rec = self._actors.get(actor_id) if actor_id else None
                call = rec.inflight.pop(task_id_bin, None) if rec else None
                self._stream_calls.pop(task_id_bin, None)
            if call is None:
                return True
            if call.trace_ctx is not None:
                self._cluster.events.span(
                    "actor_task", call.method[:24], call.sent_at,
                    _clk.now(), rec.row if rec is not None else -1,
                    status=kind, trace_id=call.trace_ctx[0],
                    parent_id=call.trace_ctx[1],
                    span_id=call.task_id.hex())
            contained = msg[3] if len(msg) > 3 else None
            if contained and kind in ("actor_result", "actor_result_x"):
                # refs pickled inside the results stay alive until the
                # enclosing return object is reclaimed (borrow-on-return)
                for i, inner in enumerate(contained):
                    if inner:
                        self._cluster.ref_counter.add_contained(
                            ObjectID.for_task_return(call.task_id, i + 1),
                            [ObjectID(b) for b in inner])
            if kind == "actor_result":
                row = rec.row if rec is not None else -1
                for i, data in enumerate(msg[2]):
                    oid = ObjectID.for_task_return(call.task_id, i + 1)
                    if row >= 0:
                        # pre-registered location (directory before seal —
                        # Cluster.seal_serialized rationale)
                        self._cluster.seal_serialized(oid, data, row)
                    else:
                        self._store.put_serialized(oid, data)
            elif kind == "actor_result_x":
                # plane mode: big results already sealed into the
                # actor's agent arena — metadata only (location before
                # seal); in-band bytes seal here, born on the head row.
                # "p" descriptors are handled UNCONDITIONALLY (d[1] is
                # an oid binary, never payload bytes) — rec.row can read
                # -1 when a concurrent kill raced this frame
                row = rec.row if rec is not None else -1
                head_row = self._cluster.head().row
                for i, d in enumerate(msg[2]):
                    oid = ObjectID.for_task_return(call.task_id, i + 1)
                    if d[0] == "p":
                        if row >= 0:
                            self._cluster.directory.add_location(oid, row)
                        self._store.put_remote(oid, d[2])
                    else:
                        self._cluster.seal_serialized(oid, d[1], head_row)
            else:
                err = deserialize(msg[2])
                self._seal_call_error(call.task_id, call.num_returns, err)
            if actor_id:
                self._pump(actor_id)
            return True
        if kind == "actor_exit":
            actor_id = ActorID(msg[1])
            with self._lock:
                rec = self._actors.get(actor_id)
                if rec is not None:
                    rec.graceful_exit = True
            return True
        return False

    def on_worker_death(self, worker) -> bool:
        actor_id = getattr(worker, "actor_binding", None)
        if actor_id is None:
            return False
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                return True
            if rec.state is ActorState.DEAD:
                # already reaped (kill-mid-ctor / ctor failure): the reap
                # path returned resources and failed the queue
                return True
            if rec.row >= 0 and not rec.resources.is_empty():
                self._cluster.crm.add_back(rec.row, rec.resources)
                rec.row = -1
            inflight = list(rec.inflight.values())
            rec.inflight.clear()
            graceful = rec.graceful_exit
            can_restart = (not graceful) and rec.restarts_left != 0
            if can_restart and rec.restarts_left > 0:
                rec.restarts_left -= 1
            rec.state = ActorState.RESTARTING if can_restart \
                else ActorState.DEAD
            queued = None if can_restart else list(rec.queue)
            if not can_restart:
                rec.queue.clear()
                if rec.name is not None:
                    self._names.pop((rec.namespace, rec.name), None)
        # in-flight calls: retry (front of queue, original order) or fail
        err = RayTaskError(
            "actor task", "actor died",
            ActorDiedError(f"actor {actor_id.hex()[:12]} died"))
        retried = []
        for call in inflight:
            if can_restart and call.retries_left != 0:
                if call.retries_left > 0:
                    call.retries_left -= 1
                retried.append(call)
            else:
                self._seal_call_error(call.task_id, call.num_returns, err)
        if can_restart:
            with self._lock:
                for call in reversed(retried):
                    rec.queue.appendleft(call)
            self._resolve_then(rec.init_args,
                               lambda: self._restart_incarnation(rec))
        else:
            for call in (queued or []):
                self._seal_call_error(call.task_id, call.num_returns, err)
        return True

    def _restart_incarnation(self, rec: ActorRecord) -> None:
        with self._lock:
            if rec.state is not ActorState.RESTARTING:
                return
            rec.state = ActorState.PENDING
        self._start_incarnation(rec)

    def _reap_worker_locked(self, rec: ActorRecord):
        """Detach the record's dedicated worker and return its reserved
        resources to the CRM.  Caller holds the lock; returns the
        (pool, worker) pair for the caller to kill outside the lock (or
        None if there is no worker)."""
        pool, worker = rec.pool, rec.worker
        rec.worker = None
        if worker is not None and rec.row >= 0 \
                and not rec.resources.is_empty():
            self._cluster.crm.add_back(rec.row, rec.resources)
            rec.row = -1
        return (pool, worker) if worker is not None else None

    def _kill_reaped(self, doomed) -> None:
        pool, worker = doomed
        if pool is not None and worker is not None:
            pool.kill_worker(worker)

    def _on_incarnation_dead(self, actor_id: ActorID,
                             init_error=None) -> None:
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                return
            rec.state = ActorState.DEAD
            # ctor failed (or never got a node): reap the dedicated worker
            # and return reserved resources, else repeated failing actors
            # exhaust the node and leak processes
            doomed = self._reap_worker_locked(rec)
            queued = list(rec.queue)
            rec.queue.clear()
            if rec.name is not None:
                self._names.pop((rec.namespace, rec.name), None)
        if doomed is not None:
            self._kill_reaped(doomed)
        err = init_error if init_error is not None else RayTaskError(
            "actor ctor", "actor failed to start", ActorDiedError())
        for call in queued:
            self._seal_call_error(call.task_id, call.num_returns, err)

    # -- kill / lookup ------------------------------------------------------
    def kill(self, actor_id: ActorID, no_restart: bool = True) -> None:
        with self._lock:
            rec = self._actors.get(actor_id)
            if rec is None:
                return
            if no_restart:
                rec.restarts_left = 0
            worker = rec.worker if rec.state is ActorState.ALIVE else None
            # PENDING (ctor running / deps unresolved) or RESTARTING: mark
            # dead so the deferred _start/_restart_incarnation (or the
            # in-flight actor_ready) bails out; if a dedicated worker was
            # already spawned for the ctor, reap it too — otherwise the
            # process and its reserved resources leak
            if no_restart and rec.state in (ActorState.PENDING,
                                            ActorState.RESTARTING):
                doomed = self._reap_worker_locked(rec)
                worker = doomed[1] if doomed is not None else None
                self._mark_dead_locked(rec)
        if worker is not None:
            pool = rec.pool if rec.pool is not None \
                else self._cluster.head().pool
            pool.kill_worker(worker)

    def _mark_dead_locked(self, rec: ActorRecord) -> None:
        rec.state = ActorState.DEAD
        queued = list(rec.queue)
        rec.queue.clear()
        if rec.name is not None:
            self._names.pop((rec.namespace, rec.name), None)
        err = RayTaskError(
            "actor task", "actor was killed",
            ActorDiedError(f"actor {rec.actor_id.hex()[:12]} was killed"))
        for call in queued:
            self._seal_call_error(call.task_id, call.num_returns, err)

    def fail_actors_on_pool(self, pool) -> None:
        """Node removal: every actor placed on this pool loses its worker.
        The pool's shutdown suppresses reader-thread death callbacks, so
        the raylet drain calls this explicitly — restart policy applies as
        for any worker death."""
        with self._lock:
            victims = [r.worker for r in self._actors.values()
                       if r.pool is pool and r.worker is not None
                       and r.state in (ActorState.ALIVE,
                                       ActorState.PENDING)]
        for worker in victims:
            worker.dead = True
            self.on_worker_death(worker)

    def get_by_name(self, name: str,
                    namespace: str = "") -> ActorID | None:
        with self._lock:
            return self._names.get((namespace or "", name))

    def list_named(self, namespace: str | None = "") -> list[dict]:
        """Live named actors (``ray.util.list_named_actors`` parity);
        ``namespace=None`` lists every namespace."""
        with self._lock:
            out = []
            for (ns, name), aid in self._names.items():
                rec = self._actors.get(aid)
                if rec is None or rec.state is ActorState.DEAD:
                    continue
                if namespace is not None and ns != (namespace or ""):
                    continue
                out.append({"name": name, "namespace": ns,
                            "actor_id": aid.hex()})
            return out

    def on_job_exit(self, job_bin: bytes) -> None:
        """A driver/client job ended: its EPHEMERAL actors die with it;
        detached actors live until explicitly killed (reference:
        GcsActorManager destroys a job's non-detached actors on job
        death — SURVEY.md §3.4)."""
        with self._lock:
            doomed = [rec.actor_id for rec in self._actors.values()
                      if rec.lifetime != "detached"
                      and rec.state is not ActorState.DEAD
                      and rec.actor_id.job_id().binary() == job_bin]
        for actor_id in doomed:
            self.kill(actor_id, no_restart=True)

    def state_of(self, actor_id: ActorID) -> ActorState | None:
        with self._lock:
            rec = self._actors.get(actor_id)
            return rec.state if rec else None

    def named_actor_specs(self) -> list[dict]:
        """Creation specs of live NAMED actors — what a GCS snapshot
        persists so a restored head can re-create them (the reference's
        Redis-backed FT restarts detached actors from their registered
        specs; state is NOT resurrected, the ctor re-runs).  Class
        bytes travel via the fn-registry snapshot; PG strategies are
        dropped (the group does not survive the restart)."""
        from .serialization import serialize
        with self._lock:
            out = []
            for rec in self._actors.values():
                if rec.name is None or rec.state is ActorState.DEAD:
                    continue
                out.append({
                    "name": rec.name,
                    "cls_id": rec.cls_id,
                    "init": serialize((rec.init_args, rec.init_kwargs)),
                    "max_restarts": rec.max_restarts,
                    "max_task_retries": rec.max_task_retries,
                    "resources": rec.resources,
                    "runtime_env": rec.runtime_env,
                    "namespace": rec.namespace,
                    "lifetime": rec.lifetime})
            return out

    def list_actors(self) -> list[dict]:
        with self._lock:
            return [{
                "ActorID": a.hex(), "State": r.state.name,
                "Name": r.name, "Pending": len(r.queue),
                "InFlight": len(r.inflight),
            } for a, r in self._actors.items()]

    def actors_on_rows(self, rows) -> set[bytes]:
        """Actor-id binaries currently placed on the given node rows
        (the serve router demotes replicas living on SUSPECT nodes)."""
        rows = set(rows)
        if not rows:
            return set()
        with self._lock:
            return {a.binary() for a, r in self._actors.items()
                    if r.row in rows}
