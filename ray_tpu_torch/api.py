"""Public API: init/shutdown, @remote, get/put/wait/cancel.

Reference parity: ``python/ray/_private/worker.py`` (init/get/put/wait),
``python/ray/remote_function.py`` (the ``@ray.remote`` decorator and
``.remote()``/``.options()``), SURVEY.md §1 layer 9 / §3.1–§3.3; mount
empty.  One front end serves both the driver process (full runtime) and
worker processes (``WorkerApiContext`` shim installed by ``worker_main``).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable

from .common.config import Config, get_config
from .common.ids import JobID, TaskID
from .common.resources import ResourceRequest, from_cu
from .common.task_spec import DEFAULT_STRATEGY, TaskSpec, TaskType
from .runtime.object_ref import ObjectRef
from .runtime.serialization import serialize

_lock = threading.RLock()
_runtime: "DriverRuntime | Any | None" = None   # driver or WorkerApiContext


def _set_runtime(rt) -> None:
    global _runtime
    _runtime = rt


def _get_runtime():
    if _runtime is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return _runtime


class DriverRuntime:
    """The in-driver runtime: a (possibly one-node) simulated cluster."""

    is_driver = True

    def __init__(self, job_id: JobID,
                 resources: dict[str, float] | None = None,
                 num_workers: int | None = None, cluster=None):
        from .cluster_utils import Cluster
        from .runtime.actor_manager import ActorManager
        self.job_id = job_id
        self.driver_task_id = TaskID.for_task(job_id)
        self._put_index = 0
        self._put_lock = threading.Lock()
        self._owns_cluster = cluster is None
        if cluster is None:
            cluster = Cluster()
            self.actor_manager = ActorManager(cluster)
            cluster.actor_manager = self.actor_manager
            cluster.add_node(resources=resources, num_workers=num_workers)
        else:
            if cluster.actor_manager is None:
                cluster.actor_manager = ActorManager(cluster)
                for raylet in cluster.raylets.values():
                    raylet.actor_manager = cluster.actor_manager
            self.actor_manager = cluster.actor_manager
        self.cluster = cluster
        self.store = cluster.store
        self.fn_registry = cluster.fn_registry
        self.crm = cluster.crm
        self.raylet = cluster.head()
        self.node_id = self.raylet.node_id

    # -- API ----------------------------------------------------------------
    # The ref-based wrappers sit on *_raw methods that work on bare
    # ObjectIDs: the head daemon serves remote clients through the raw
    # forms so no server-side ObjectRefs are created for client-held
    # objects — a transient counted ref here would hit zero when the
    # handler returned and reclaim a result the client still holds
    # (clients get the worker-frame "conservative leak" ownership).
    def get(self, refs: list[ObjectRef], timeout: float | None = None):
        return self.get_raw([r.id for r in refs], timeout)

    def get_raw(self, oids, timeout: float | None = None):
        from .runtime.object_store import GetTimeoutError
        from .runtime.pull_manager import PullPriority
        # locality: remote plasma objects pull to the driver's node first
        # (reference: a driver get goes through the local plasma store +
        # PullManager at get priority)
        if not self.cluster.pull_manager.pull_blocking(
                oids, self.raylet.row, PullPriority.GET, timeout,
                self.store):
            raise GetTimeoutError(
                f"get timed out; objects not ready within {timeout}s")
        return self.store.get(oids, timeout)

    def put(self, value) -> ObjectRef:
        return ObjectRef(self.put_raw(value))

    def put_raw(self, value):
        with self._put_lock:
            self._put_index += 1
            idx = self._put_index
        from .common.ids import ObjectID
        oid = ObjectID.for_put(self.driver_task_id, idx)
        # size-routed like the reference: large serialized payloads seal
        # into the shared arena (location pre-registered — see
        # Cluster.seal_serialized); small values stay in-band
        from .common.ids import ObjectID as _OID
        from .runtime.object_ref import serialize_collecting
        data, contained = serialize_collecting(value)
        if self.store.routes_to_plasma(len(data)):
            if contained:
                # arena payloads hold no Python refs: register the refs
                # pickled inside so their objects outlive the holder's
                # own copies while this blob is alive
                self.cluster.ref_counter.add_contained(
                    oid, [_OID(b) for b in contained])
            self.cluster.seal_serialized(oid, data, self.raylet.row)
        else:
            self.store.put(oid, value)
        return oid

    # -- streaming generators ------------------------------------------------
    def stream_wait(self, task_id, index: int,
                    timeout: float | None = None):
        return self.cluster.task_manager.wait_stream(task_id, index,
                                                     timeout)

    def stream_ack(self, task_id, consumed: int) -> None:
        self.cluster.stream_ack(task_id, consumed)

    def stream_close(self, task_id, consumed: int) -> None:
        self.cluster.stream_close(task_id, consumed)

    def wait(self, refs, num_returns, timeout):
        ready_ids, not_ready_ids = self.wait_raw(
            [r.id for r in refs], num_returns, timeout)
        by_id = {r.id: r for r in refs}
        return ([by_id[i] for i in ready_ids],
                [by_id[i] for i in not_ready_ids])

    def wait_raw(self, oids, num_returns, timeout):
        return self.store.wait(oids, num_returns, timeout)

    def submit_spec(self, spec: TaskSpec, fn_id: str,
                    fn_bytes: bytes | None) -> None:
        if fn_bytes is not None and fn_id not in self.fn_registry:
            self.fn_registry[fn_id] = fn_bytes
        self.raylet.submit(spec)

    def create_actor(self, actor_id, cls_id, cls_bytes, args, kwargs,
                     max_restarts, max_task_retries, name,
                     resources=None, strategy=None,
                     runtime_env=None, concurrency=None,
                     namespace="", lifetime=None) -> None:
        self.actor_manager.create_actor(actor_id, cls_id, cls_bytes, args,
                                        kwargs, max_restarts,
                                        max_task_retries, name,
                                        resources=resources,
                                        strategy=strategy,
                                        runtime_env=runtime_env,
                                        concurrency=concurrency,
                                        namespace=namespace,
                                        lifetime=lifetime)

    def shutdown(self) -> None:
        # an adopted (caller-owned) cluster stays up across shutdown, the
        # reference's detach semantics; the caller stops it via
        # cluster.stop().  This JOB still ends: its ephemeral actors die
        # with it (detached ones keep running on the adopted cluster)
        if self._owns_cluster:
            self.cluster.stop()
        elif self.actor_manager is not None:
            self.actor_manager.on_job_exit(self.job_id.binary())


# ---------------------------------------------------------------------------
# RemoteFunction
# ---------------------------------------------------------------------------

class RemoteFunction:
    """What ``@ray_tpu_torch.remote`` returns; call ``.remote(*args)``.

    Serializable: shipping one to a worker (e.g. captured in a closure)
    reconstructs a stub that routes submissions back through that worker's
    runtime — nested tasks work (reference: workers submit tasks too).
    """

    def __init__(self, fn: Callable | None, fn_bytes: bytes | None = None,
                 name: str | None = None, num_returns: int = 1,
                 resources: dict[str, float] | None = None,
                 max_retries: int | None = None, fn_id: str | None = None,
                 strategy=None, runtime_env: dict | None = None,
                 max_calls: int = 0):
        if fn is None and fn_bytes is None and fn_id is None:
            raise ValueError("need a function, its bytes, or its id")
        self._fn = fn
        self._fn_bytes = fn_bytes
        self._name = name or getattr(fn, "__qualname__", "anonymous")
        self._num_returns = num_returns
        self._resources = dict(resources) if resources else {"CPU": 1}
        self._max_retries = max_retries
        self._strategy = strategy or DEFAULT_STRATEGY
        self._runtime_env = runtime_env
        self._max_calls = int(max_calls or 0)
        # The id is decoration-time random, NOT a content hash: a recursive
        # remote function's bytes contain its own wrapper, whose pickle
        # embeds the id — a content hash would be circular (reference keys
        # its GCS function table the same way: descriptor, not digest).
        self._fn_id = fn_id or os.urandom(16).hex()
        self._submit_cache = None   # (ResourceRequest, wire num_returns)

    # -- options ------------------------------------------------------------
    def options(self, *, num_returns: int | None = None,
                resources: dict[str, float] | None = None,
                num_cpus: float | None = None,
                max_retries: int | None = None,
                scheduling_strategy=None,
                placement_group=None,
                placement_group_bundle_index: int = -1,
                runtime_env: dict | None = None,
                max_calls: int | None = None) -> "RemoteFunction":
        res = dict(resources) if resources is not None \
            else dict(self._resources)
        if num_cpus is not None:
            res["CPU"] = num_cpus
        strategy = _resolve_strategy_options(
            scheduling_strategy, placement_group,
            placement_group_bundle_index, self._strategy)
        return RemoteFunction(
            self._fn, self._fn_bytes, self._name,
            num_returns if num_returns is not None else self._num_returns,
            res,
            max_retries if max_retries is not None else self._max_retries,
            fn_id=self._fn_id,     # same function => same registry entry
            strategy=strategy,
            runtime_env=(runtime_env if runtime_env is not None
                         else self._runtime_env),
            max_calls=(max_calls if max_calls is not None
                       else self._max_calls))

    # -- serialization (registry + shipping) --------------------------------
    def _materialize(self) -> tuple[str, bytes | None]:
        if self._fn_bytes is None and self._fn is not None:
            self._fn_bytes = serialize(self._fn)
        return self._fn_id, self._fn_bytes

    def __reduce__(self):
        # Ship as a descriptor stub (id + options), NOT by value: the
        # function bytes travel separately through the fn registry, and a
        # stub breaks the self-reference cycle of recursive remote fns.
        # Driver-side pickling eagerly registers the bytes so a stub that
        # reaches a worker only as a task argument still resolves; the
        # reentrancy guard skips this while serializing a recursive fn's
        # own body (that submission registers it anyway).
        registry = getattr(_runtime, "fn_registry", None)
        if not getattr(self, "_reducing", False) and self._fn is not None \
                and registry is not None:
            # capability-keyed, not is_driver: client mode exposes an
            # RPC-backed registry so stubs shipped as ARGS resolve on
            # the cluster too; workers have no registry attr and skip
            self._reducing = True
            try:
                fn_id, fn_bytes = self._materialize()
                registry.setdefault(fn_id, fn_bytes)
            finally:
                self._reducing = False
        return (RemoteFunction,
                (None, None, self._name, self._num_returns,
                 self._resources, self._max_retries, self._fn_id,
                 self._strategy, self._runtime_env, self._max_calls))

    def __call__(self, *a, **k):
        raise TypeError(
            f"remote function {self._name} cannot be called directly; "
            "use .remote()")

    # -- submission ----------------------------------------------------------
    def remote(self, *args, **kwargs):
        rt = _get_runtime()
        fn_id, fn_bytes = self._materialize()
        # submission invariants (demand vector, wire num_returns) are
        # per-FUNCTION and config-independent, so computed once — the
        # tiny-task submit path mints thousands of specs/s.  The retry
        # default is read per call: Config.reset between init cycles
        # must keep applying (it's one attribute read).
        retries = self._max_retries if self._max_retries is not None \
            else get_config().task_max_retries_default
        cached = self._submit_cache
        if cached is None:
            from .common.task_spec import SchedulingStrategyKind
            res = self._resources
            if self._strategy.kind is \
                    SchedulingStrategyKind.PLACEMENT_GROUP:
                # rewrite the demand onto the group's shaped bundle
                # resources (reference: PG tasks consume
                # ``CPU_group_{i}_{pgid}``)
                from .runtime.placement_group_manager import shape_request
                res = shape_request(
                    res, self._strategy.placement_group_id.hex(),
                    self._strategy.bundle_index)
            # "streaming" rides the wire as -1: the task is a GENERATOR
            # and its items seal incrementally (num_returns="streaming")
            num_returns = -1 if self._num_returns == "streaming" \
                else self._num_returns
            cached = (ResourceRequest(res), num_returns)
            self._submit_cache = cached
        rreq, num_returns = cached
        if rt.is_driver:
            job_id = rt.job_id
            task_id = TaskID.for_task(job_id)
        else:
            cur = rt.current_task_id
            job_id = cur.job_id() if cur else JobID.from_int(0)
            task_id = TaskID.for_task(job_id)
        from .util.tracing import context_for_new_task
        spec = TaskSpec(
            task_id=task_id, job_id=job_id, task_type=TaskType.NORMAL_TASK,
            function_descriptor=fn_id, args=args, kwargs=kwargs,
            num_returns=num_returns,
            resources=rreq,
            strategy=self._strategy, max_retries=retries,
            runtime_env=self._runtime_env,  # the job-level env merges in
            #                                 at the raylet submit intake
            trace_ctx=context_for_new_task(task_id),
            max_calls=self._max_calls)
        if num_returns == -1:
            from .runtime.object_ref import ObjectRefGenerator
            rt.submit_spec(spec, fn_id, fn_bytes)
            return ObjectRefGenerator(task_id, rt)
        # result refs are created BEFORE submission: the owner's refcount
        # must never dip to zero while the caller is still building them
        from .common.ids import ObjectID
        refs = [ObjectRef(ObjectID.for_task_return(task_id, i + 1))
                for i in range(num_returns)]
        rt.submit_spec(spec, fn_id, fn_bytes)
        return refs[0] if num_returns == 1 else refs


def remote(*args, **options):
    """``@remote`` or ``@remote(num_returns=2, resources={...})``."""
    if len(args) == 1 and callable(args[0]) and not options:
        fn = args[0]
        if isinstance(fn, type):
            from .actor_api import make_actor_class
            return make_actor_class(fn, {})
        return RemoteFunction(fn)

    def wrap(fn):
        if isinstance(fn, type):
            from .actor_api import make_actor_class
            return make_actor_class(fn, options)
        return RemoteFunction(
            fn,
            num_returns=options.get("num_returns", 1),
            resources=_normalize_resources(options),
            max_retries=options.get("max_retries"),
            strategy=_resolve_strategy_options(
                options.get("scheduling_strategy"),
                options.get("placement_group"),
                options.get("placement_group_bundle_index", -1), None),
            runtime_env=options.get("runtime_env"),
            max_calls=options.get("max_calls", 0))
    return wrap


def _resolve_strategy_options(scheduling_strategy, placement_group,
                              placement_group_bundle_index, default):
    """options() strategy resolution: explicit scheduling_strategy wins,
    then the placement_group= shorthand, then the inherited default."""
    if scheduling_strategy is not None:
        from .util.scheduling_strategies import resolve_strategy
        return resolve_strategy(scheduling_strategy)
    if placement_group is not None:
        from .common.task_spec import (SchedulingStrategy,
                                       SchedulingStrategyKind)
        _check_bundle_index(placement_group, placement_group_bundle_index)
        return SchedulingStrategy(
            kind=SchedulingStrategyKind.PLACEMENT_GROUP,
            placement_group_id=placement_group.id,
            bundle_index=placement_group_bundle_index)
    return default


def _check_bundle_index(pg, index: int) -> None:
    if index < -1:
        raise ValueError(f"invalid placement_group_bundle_index {index}")
    if index >= 0 and pg.bundle_specs and index >= len(pg.bundle_specs):
        raise ValueError(
            f"placement_group_bundle_index {index} out of range for a "
            f"{len(pg.bundle_specs)}-bundle group")


def _normalize_resources(options: dict) -> dict[str, float]:
    res = dict(options.get("resources") or {})
    if "num_cpus" in options:
        res["CPU"] = options["num_cpus"]
    if "num_gpus" in options:
        res["GPU"] = options["num_gpus"]
    if "memory" in options:
        res["memory"] = options["memory"]
    if "CPU" not in res:
        res["CPU"] = 1
    return res


# ---------------------------------------------------------------------------
# module-level API
# ---------------------------------------------------------------------------

def init(resources: dict[str, float] | None = None,
         num_workers: int | None = None,
         system_config: dict | None = None,
         runtime_env: dict | None = None,
         address: str | None = None,
         cluster=None, namespace: str | None = None) -> None:
    """Start the runtime.  ``cluster=`` adopts an existing simulated
    multi-node ``cluster_utils.Cluster`` (the reference's
    ``ray.init(address=cluster.address)`` pattern); ``runtime_env=`` is
    the job-level default environment for every task; ``address=`` (or
    ``"auto"`` with ``RAY_TPU_TORCH_ADDRESS`` set) attaches to a running
    head daemon as a CLIENT instead of starting a local cluster
    (reference: ``ray.init("ray://…")``); ``namespace=`` scopes named-actor
    lookup/registration (divergence from upstream, documented: the
    default is the SHARED "" namespace rather than an anonymous
    per-job one — explicit namespaces give the isolation)."""
    global _runtime
    with _lock:
        if _runtime is not None:
            raise RuntimeError("ray_tpu_torch already initialized")
        if address == "auto":
            address = os.environ.get("RAY_TPU_TORCH_ADDRESS")
            if not address:
                raise RuntimeError(
                    "init(address='auto') but RAY_TPU_TORCH_ADDRESS is "
                    "unset and no head daemon address was given")
        if address is not None:
            conflicting = {"resources": resources,
                           "num_workers": num_workers,
                           "system_config": system_config,
                           "cluster": cluster}
            bad = [k for k, v in conflicting.items() if v is not None]
            if bad:
                raise ValueError(
                    f"init(address=...) attaches to an existing cluster; "
                    f"{bad} configure a LOCAL cluster and would be "
                    "silently ignored — drop them or drop address")
            from .util.client import ClientRuntime
            _runtime = ClientRuntime(address, runtime_env=runtime_env,
                                     namespace=namespace)
            return
        if system_config is not None:
            Config.reset(system_config)
        cfg = get_config()
        ncpu = os.cpu_count() or 4
        if resources is None:
            resources = {"CPU": ncpu, "memory": 8}
        if num_workers is None:
            num_workers = cfg.num_workers_soft_limit or \
                min(int(resources.get("CPU", ncpu)), ncpu)
        _runtime = DriverRuntime(JobID.next(), resources, num_workers,
                                 cluster=cluster)
        _runtime.namespace = namespace or ""
        # workers inherit the job's namespace through the cluster; the
        # KV copy lets get_runtime_context() resolve it INSIDE workers
        _runtime.cluster.default_namespace = namespace or ""
        try:
            _runtime.cluster.kv.dispatch(
                "put", b"__job_namespace", (namespace or "").encode(),
                "sys", True)
        except Exception:   # noqa: BLE001 — identity metadata only
            pass
        # the cluster carries the job-level default env: EVERY spec
        # intake (driver submits, worker-submitted children, actor
        # creation) merges against it, so inheritance is uniform —
        # set_job_runtime_env also gates agents' env-blind fast path
        _runtime.cluster.set_job_runtime_env(runtime_env)


def is_initialized() -> bool:
    return _runtime is not None


def shutdown() -> None:
    global _runtime
    with _lock:
        if _runtime is not None:
            if getattr(_runtime, "is_driver", False):
                _runtime.shutdown()
            elif hasattr(_runtime, "close"):
                _runtime.close()        # client mode: drop the connection
        _runtime = None


def get(refs, timeout: float | None = None):
    single = isinstance(refs, ObjectRef)
    ref_list = [refs] if single else list(refs)
    for r in ref_list:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"ray_tpu_torch.get expects ObjectRefs, got {type(r)}")
    values = _get_runtime().get(ref_list, timeout)
    return values[0] if single else values


def put(value) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("put of an ObjectRef is not allowed (reference "
                        "behavior)")
    return _get_runtime().put(value)


def wait(refs, *, num_returns: int = 1, timeout: float | None = None):
    if isinstance(refs, ObjectRef):
        refs = [refs]
    if num_returns > len(refs):
        raise ValueError("num_returns exceeds the number of refs")
    return _get_runtime().wait(list(refs), num_returns, timeout)


def cancel(ref: ObjectRef, *, force: bool = False) -> None:
    rt = _get_runtime()
    if rt.is_driver:
        # the task may be queued/running/agent-leased on ANY node
        rt.cluster.cancel_task(ref.task_id(), force=force)
    elif hasattr(rt, "cancel_task"):    # client mode
        rt.cancel_task(ref.task_id(), force=force)


def kill(actor_handle, *, no_restart: bool = True) -> None:
    """Forcefully terminate an actor (reference: ``ray.kill``)."""
    from .actor_api import ActorHandle
    if not isinstance(actor_handle, ActorHandle):
        raise TypeError("ray_tpu_torch.kill expects an ActorHandle")
    rt = _get_runtime()
    if rt.is_driver:
        rt.actor_manager.kill(actor_handle._actor_id, no_restart=no_restart)
    else:
        rt.kill_actor(actor_handle._actor_id, no_restart=no_restart)


def get_actor(name: str, namespace: str | None = None):
    """Look up a named actor, scoped to the caller's namespace unless
    one is given (reference: ``ray.get_actor(name, namespace=...)``)."""
    from .actor_api import ActorHandle
    from .common.ids import ActorID
    rt = _get_runtime()
    ns = namespace if namespace is not None \
        else getattr(rt, "namespace", None)
    if rt.is_driver:
        aid = rt.actor_manager.get_by_name(name, ns or "")
    else:
        # workers pass None: the raylet resolves the job's default
        raw = rt.get_actor_id_by_name(name, ns)
        aid = ActorID(raw) if raw else None
    if aid is None:
        raise ValueError(f"no actor named {name!r} in namespace "
                         f"{(ns or '')!r}")
    return ActorHandle(aid)


def available_resources() -> dict[str, float]:
    rt = _get_runtime()
    if not hasattr(rt, "crm"):          # client mode: ask the head
        return rt.available_resources()
    totals, avail, mask = rt.crm.arrays()
    out: dict[str, float] = {}
    for row in range(totals.shape[0]):
        if not mask[row]:
            continue
        for col in range(avail.shape[1]):
            cu = int(avail[row, col])
            if cu:
                name = rt.crm.resource_index.name(col)
                out[name] = out.get(name, 0.0) + from_cu(cu)
    return out


def cluster_resources() -> dict[str, float]:
    rt = _get_runtime()
    if not hasattr(rt, "crm"):          # client mode: ask the head
        return rt.cluster_resources()
    totals, _, mask = rt.crm.arrays()
    out: dict[str, float] = {}
    for row in range(totals.shape[0]):
        if not mask[row]:
            continue
        for col in range(totals.shape[1]):
            cu = int(totals[row, col])
            if cu:
                name = rt.crm.resource_index.name(col)
                out[name] = out.get(name, 0.0) + from_cu(cu)
    return out


def timeline(filename: str | None = None):
    """Task/cluster lifecycle events in Chrome trace format (reference:
    ``ray.timeline``).  Returns the event list, or writes it to
    ``filename`` and returns the path."""
    rt = _get_runtime()
    if not hasattr(rt, "cluster"):      # client mode: ask the head
        events = rt.timeline()
        if filename is not None:
            import json
            with open(filename, "w") as f:
                json.dump(events, f)
            return filename
        return events
    events = rt.cluster.events
    if filename is not None:
        return events.dump_timeline(filename)
    return events.timeline()


class RuntimeContext:
    """Where am I running (reference: ``ray.get_runtime_context()`` /
    ``RuntimeContext`` — job/task/actor/node identity)."""

    def __init__(self, job_id=None, task_id=None, actor_id=None,
                 node_id=None, namespace: str = ""):
        self._job_id = job_id
        self._task_id = task_id
        self._actor_id = actor_id
        self._node_id = node_id
        self.namespace = namespace

    def get_job_id(self):
        return self._job_id

    def get_task_id(self):
        return self._task_id

    def get_actor_id(self):
        return self._actor_id

    def get_node_id(self):
        return self._node_id

    def __repr__(self):
        return (f"RuntimeContext(job={self._job_id}, "
                f"task={self._task_id}, actor={self._actor_id}, "
                f"node={self._node_id})")


def get_runtime_context() -> RuntimeContext:
    rt = _get_runtime()
    from .runtime.worker import WorkerApiContext
    if isinstance(rt, WorkerApiContext):    # inside a worker
        tid = rt.current_task_id
        aid_bin = rt.actor_id_bin
        from .common.ids import ActorID
        return RuntimeContext(
            job_id=tid.job_id().hex() if tid is not None else None,
            task_id=tid.hex() if tid is not None else None,
            actor_id=(ActorID(aid_bin).hex() if aid_bin else None),
            node_id=rt.node_id_hex,
            namespace=_worker_namespace(rt))
    if rt.is_driver:
        head = rt.cluster.head()
        return RuntimeContext(
            job_id=rt.job_id.hex(), node_id=head.node_id.hex(),
            namespace=rt.cluster.default_namespace)
    # client mode: a connected driver — no task identity
    return RuntimeContext(job_id=rt.job_id.hex(),
                          namespace=getattr(rt, "namespace", "") or "")


def _worker_namespace(rt) -> str:
    """The job's default namespace, resolved from the GCS KV (workers
    carry none of their own — api.init publishes it); cached after the
    first lookup."""
    ns = getattr(rt, "_cached_namespace", None)
    if ns is None:
        try:
            raw = rt.kv_op("get", b"__job_namespace", namespace="sys")
        except Exception:   # noqa: BLE001 — degraded KV: identity
            return ""       # lookups must not raise, and a TRANSIENT
            #                 failure must not cache a wrong ''
            #                 forever — retry next call
        ns = raw.decode() if raw else ""
        rt._cached_namespace = ns
    return ns


def list_named_actors(all_namespaces: bool = False) -> list[dict]:
    """Live named actors (reference: ``ray.util.list_named_actors``):
    ``[{"name", "namespace", "actor_id"}, ...]`` — the current
    namespace's by default.  Works from drivers, workers, and
    clients."""
    rt = _get_runtime()
    from .runtime.worker import WorkerApiContext
    if isinstance(rt, WorkerApiContext):
        # inside a worker: the listing rides a raylet frame
        # (named_list), like the named_actor lookup does
        ns = None if all_namespaces else _worker_namespace(rt)
        return rt.list_named_actors_via_head(ns)
    if not hasattr(rt, "cluster"):          # client mode: ask the head
        return rt.list_named_actors(
            all_namespaces, getattr(rt, "namespace", "") or "")
    ns = None if all_namespaces else rt.cluster.default_namespace
    return rt.actor_manager.list_named(ns)


def worker_stacks(node_row: int | None = None,
                  timeout: float = 5.0) -> dict:
    """What is every worker doing RIGHT NOW: {'row:index': all-thread
    stack text}.  Workers reply from their reader thread, so one
    wedged in user code still reports (the dashboard's py-spy
    integration upstream — SURVEY §5.1(c); mount empty)."""
    rt = _get_runtime()
    if not hasattr(rt, "cluster"):      # client mode: ask the head
        return rt.worker_stacks(node_row, timeout)
    got = rt.cluster.dump_worker_stacks(row=node_row, timeout=timeout)
    return {f"{r}:{i}": text for (r, i), text in got.items()}


def nodes() -> list[dict]:
    rt = _get_runtime()
    if not hasattr(rt, "crm"):          # client mode: ask the head
        return rt.nodes()
    out = []
    totals, _, mask = rt.crm.arrays()
    for row in range(totals.shape[0]):
        if mask[row]:
            nid = rt.crm.id_of(row)
            draining = rt.crm.is_draining(row)
            out.append({"NodeID": nid.hex() if nid else None,
                        "Alive": True, "Row": row,
                        "Status": "DRAINING" if draining else "ALIVE",
                        "Labels": rt.crm.labels_of(row)})
    return out


def drain_node(node_id, reason: str = "",
               deadline_s: float | None = None) -> dict:
    """Gracefully retire a node: ALIVE -> DRAINING -> removed.  The
    node stops accepting new leases/bundles immediately, running tasks
    finish, queued work and PG bundles re-place elsewhere, sole-copy
    objects migrate off, and the node is removed once empty or at
    ``deadline_s`` (default ``drain_deadline_s``), whichever is first.
    ``node_id`` is a NodeID or its hex string.  Returns the drain
    status dict ({"state": "DRAINING", ...})."""
    from .common.ids import NodeID
    if isinstance(node_id, str):
        node_id = NodeID.from_hex(node_id)
    rt = _get_runtime()
    if not hasattr(rt, "cluster"):      # client mode: ask the head
        return rt.drain_node(node_id.hex(), reason, deadline_s)
    return rt.cluster.drain_node(node_id, reason=reason,
                                 deadline_s=deadline_s)
