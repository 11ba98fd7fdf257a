"""Actor API: @remote classes, handles, ordered method calls.

Reference parity: ``python/ray/actor.py`` — ``ActorClass`` (from decorating
a class), ``ActorHandle`` with dynamic method accessors, ``.options(...)``
(name, max_restarts, max_task_retries), named-actor lookup
(``ray.get_actor``), graceful ``__ray_terminate__`` — SURVEY.md §3.4;
mount empty.  The lifecycle/ordering machinery lives in
``runtime/actor_manager.py``.
"""

from __future__ import annotations

import os
from typing import Any

from .common.ids import ActorID, JobID, ObjectID, TaskID
from .runtime.object_ref import ObjectRef
from .runtime.serialization import serialize


def _runtime():
    from . import api
    return api._get_runtime()


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1,
                 concurrency_group: str | None = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._group = concurrency_group

    def options(self, *, num_returns: int | None = None,
                concurrency_group: str | None = None) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._name,
            num_returns if num_returns is not None
            else self._num_returns,
            concurrency_group if concurrency_group is not None
            else self._group)

    def remote(self, *args, **kwargs):
        from .util.tracing import context_for_new_task
        rt = _runtime()
        actor_id = self._handle._actor_id
        job_id = actor_id.job_id()
        task_id = TaskID.for_task(job_id, actor_id)
        trace_ctx = context_for_new_task(task_id)
        # "streaming": the method is a generator; items seal
        # incrementally and the caller gets an ObjectRefGenerator
        # (reference: streaming actor calls share the generator protocol)
        num_returns = -1 if self._num_returns == "streaming" \
            else self._num_returns
        if rt.is_driver:
            rt.actor_manager.submit(actor_id, task_id, self._name, args,
                                    kwargs, num_returns,
                                    trace_ctx=trace_ctx,
                                    concurrency_group=self._group)
        else:
            rt.submit_actor_call(actor_id, task_id, self._name, args,
                                 kwargs, num_returns, trace_ctx,
                                 concurrency_group=self._group)
        if num_returns == -1:
            from .runtime.object_ref import ObjectRefGenerator
            return ObjectRefGenerator(task_id, rt)
        refs = [ObjectRef(ObjectID.for_task_return(task_id, i + 1))
                for i in range(num_returns)]
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *a, **k):
        raise TypeError(
            f"actor method {self._name} cannot be called directly; "
            "use .remote()")


class ActorHandle:
    def __init__(self, actor_id: ActorID):
        self._actor_id = actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id,))

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]}…)"

    def __ray_terminate__(self):
        """Graceful stop: queued behind pending method calls."""
        return ActorMethod(self, "__ray_terminate__").remote()


class ActorClass:
    def __init__(self, cls: type | None, cls_bytes: bytes | None = None,
                 name: str | None = None, cls_id: str | None = None,
                 options: dict[str, Any] | None = None):
        self._cls = cls
        self._cls_bytes = cls_bytes
        self._cls_name = name or getattr(cls, "__name__", "Actor")
        self._cls_id = cls_id or os.urandom(16).hex()
        self._options = dict(options or {})

    def options(self, **options) -> "ActorClass":
        merged = dict(self._options)
        merged.update(options)
        return ActorClass(self._cls, self._cls_bytes, self._cls_name,
                          self._cls_id, merged)

    def _materialize(self) -> tuple[str, bytes | None]:
        if self._cls_bytes is None and self._cls is not None:
            self._cls_bytes = serialize(self._cls)
        return self._cls_id, self._cls_bytes

    def __reduce__(self):
        # descriptor stub, mirroring RemoteFunction.__reduce__
        # (capability-keyed: driver and client runtimes expose a
        # registry; workers do not)
        from . import api
        registry = getattr(api._runtime, "fn_registry", None)
        if self._cls is not None and registry is not None:
            cls_id, cls_bytes = self._materialize()
            registry.setdefault(cls_id, cls_bytes)
        return (ActorClass, (None, None, self._cls_name, self._cls_id,
                             self._options))

    def __call__(self, *a, **k):
        raise TypeError(
            f"actor class {self._cls_name} cannot be instantiated "
            "directly; use .remote()")

    def remote(self, *args, **kwargs) -> ActorHandle:
        from .common.config import get_config
        from .common.resources import ResourceRequest
        rt = _runtime()
        opts = self._options
        max_restarts = opts.get(
            "max_restarts", get_config().actor_max_restarts_default)
        max_task_retries = opts.get("max_task_retries", 0)
        name = opts.get("name")
        res = dict(opts.get("resources") or {})
        if "num_cpus" in opts:
            res["CPU"] = opts["num_cpus"]
        if "num_gpus" in opts:
            res["GPU"] = opts["num_gpus"]
        # default: actors hold no resources while alive (reference default
        # is num_cpus=0 for an actor's lifetime)
        from .api import _resolve_strategy_options
        from .common.task_spec import (DEFAULT_STRATEGY,
                                       SchedulingStrategyKind)
        strategy = _resolve_strategy_options(
            opts.get("scheduling_strategy"), opts.get("placement_group"),
            opts.get("placement_group_bundle_index", -1), DEFAULT_STRATEGY)
        if strategy.kind is SchedulingStrategyKind.PLACEMENT_GROUP:
            from .runtime.placement_group_manager import shape_request
            res = shape_request(res, strategy.placement_group_id.hex(),
                                strategy.bundle_index)
        resources = ResourceRequest(res)
        # concurrency model (reference: max_concurrency for threaded
        # actors — async actors default to 1000 worker-side — and named
        # concurrency_groups with per-group limits)
        concurrency = None
        if opts.get("max_concurrency") or opts.get("concurrency_groups"):
            concurrency = {
                "max_concurrency": opts.get("max_concurrency"),
                "concurrency_groups": opts.get("concurrency_groups"),
            }
        elif self._cls is not None:
            # async actors default to max_concurrency=1000 (reference):
            # detect here so the HEAD's pipelining window widens too —
            # worker-side detection alone would cap effective
            # concurrency at the default window
            import inspect
            if any(inspect.iscoroutinefunction(m)
                   or inspect.isasyncgenfunction(m) for _n, m in
                   inspect.getmembers(self._cls) if callable(m)):
                concurrency = {"max_concurrency": 1000,
                               "concurrency_groups": None}
        cls_id, cls_bytes = self._materialize()
        if rt.is_driver:
            actor_id = ActorID.of(rt.job_id)
        else:
            cur = rt.current_task_id
            job_id = cur.job_id() if cur else JobID.from_int(0)
            actor_id = ActorID.of(job_id)
        lifetime = opts.get("lifetime")
        if lifetime not in (None, "ephemeral", "detached"):
            raise ValueError(
                f"lifetime must be 'detached', 'ephemeral', or "
                f"omitted; got {lifetime!r}")
        namespace = opts.get("namespace")
        if namespace is None:
            # None (not "") from a WORKER runtime: the raylet fills in
            # the job's default namespace cluster-side
            namespace = getattr(rt, "namespace", None)
        get_if_exists = bool(opts.get("get_if_exists"))
        if get_if_exists:
            # get-or-create (reference: options(get_if_exists=True)):
            # reuse a live actor under this name, else create; races
            # resolve by re-looking-up the REGISTRY's winner below
            if not name:
                raise ValueError("get_if_exists requires a name")
            existing = _lookup_existing(name, namespace)
            if existing is not None:
                return existing
        try:
            rt.create_actor(actor_id, cls_id, cls_bytes, args, kwargs,
                            max_restarts, max_task_retries, name,
                            resources, strategy,
                            opts.get("runtime_env"),
                            concurrency=concurrency,
                            namespace=namespace, lifetime=lifetime)
        except Exception:
            # a name-collision loss surfaces as ValueError in-process
            # but as RemoteRpcError through a client — any failure
            # under get_if_exists resolves to the winner if one exists
            if get_if_exists:
                existing = _lookup_existing(name, namespace)
                if existing is not None:
                    return existing
            raise
        if get_if_exists:
            # async runtimes (a worker's create frame is fire-and-
            # forget): the NAME registry is the authority on who won a
            # race — return whatever it resolves to once registration
            # lands, which is our own handle in the common case
            win = _await_named(name, namespace, timeout=10.0)
            if win is not None:
                return win
        return ActorHandle(actor_id)


def _lookup_existing(name: str, namespace) -> "ActorHandle | None":
    from . import api
    try:
        return api.get_actor(name, namespace=namespace)
    except ValueError:
        return None


def _await_named(name: str, namespace,
                 timeout: float = 10.0) -> "ActorHandle | None":
    import time as _time
    deadline = _time.monotonic() + timeout
    while True:
        got = _lookup_existing(name, namespace)
        if got is not None or _time.monotonic() >= deadline:
            return got
        _time.sleep(0.05)


def make_actor_class(cls: type, options: dict[str, Any]) -> ActorClass:
    # max_restarts=-1 (infinite) passes through unchanged; the restart
    # budget check in ActorManager.on_worker_death treats != 0 as usable
    return ActorClass(cls, options=dict(options))
