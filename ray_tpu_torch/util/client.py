"""Client mode: attach a driver to a running head daemon over RPC.

Reference parity: ``ray.init("ray://host:port")`` — the ray client
(``python/ray/util/client/``) proxies the full task/actor/object API
through a gRPC server colocated with the cluster (SURVEY.md §2.2; mount
empty).  Here the proxy speaks ``ray_tpu_torch.rpc`` to ``runtime/head.py``.

The ClientRuntime presents the WORKER-context surface (``is_driver``
False): ``RemoteFunction.remote``/``ActorClass.remote`` take their
non-driver path, deriving task ids from a synthetic driver task id under
the server-assigned job id.  The client is a refcount HOLDER: its local
ObjectRef events batch to the head (``refs_flush``, piggybacked on the
next RPC) and fold under ``("c", job_id)``; disconnect — graceful
``client_bye`` or an abrupt connection drop — retires every count it
held, so two concurrent drivers on one head have disjoint object
lifetimes (reference: per-process ownership, SURVEY.md §1 layer 7).
"""

from __future__ import annotations

import threading

from ..common.ids import ActorID, ObjectID, TaskID
from ..runtime.object_ref import ObjectRef
from ..runtime.serialization import deserialize, serialize


class _RemoteFnRegistry:
    """Dict-shaped shim over the head's function table: eager stub
    registration in ``RemoteFunction.__reduce__`` works unchanged."""

    def __init__(self, client: "ClientRuntime"):
        self._client = client
        self._known: set[str] = set()   # avoid re-shipping bytes

    def setdefault(self, fn_id: str, fn_bytes: bytes | None):
        if fn_bytes is not None and fn_id not in self._known:
            self._client._call("fn_register", fn_id, fn_bytes)
            self._known.add(fn_id)
        return fn_bytes

    def __contains__(self, fn_id: str) -> bool:
        return fn_id in self._known


class ClientRuntime:
    is_driver = False

    def __init__(self, address: str, runtime_env: dict | None = None,
                 namespace: str | None = None):
        from ..rpc import transport as _transport
        self.address = address
        self.namespace = namespace or ""
        # idempotent head READS transparently retry on timeout/conn
        # loss (backoff + full jitter); mutations (submit/put/create)
        # never do — re-issuing those would double-execute
        self._rpc = _transport.connect(address, retryable=frozenset({
            "ping", "status", "nodes", "available_resources",
            "cluster_resources", "list_named_actors",
            "get_actor_by_name", "job_status", "job_list", "job_logs",
            "state_list", "timeline", "memory",
        }))
        self._lock = threading.Lock()
        # this process's share of distributed refcounting: ObjectRefs
        # built here count locally; batches ship ahead of the next RPC
        # (constructed BEFORE the first _call — it flushes through this)
        from ..runtime.object_ref import install_counter_if_absent
        from ..runtime.worker import WorkerRefCounter
        self.ref_counter = WorkerRefCounter()
        self._refs_lock = threading.Lock()
        info = self._call("connect", runtime_env)
        from ..common.ids import JobID
        self.job_id = JobID(info["job_id"])
        self.session_dir = info["session_dir"]
        # non-driver submission paths derive ids from current_task_id
        self.current_task_id = TaskID.for_task(self.job_id)
        self.fn_registry = _RemoteFnRegistry(self)
        # no-op when this process already counts (embedded client in a
        # head/worker process: refs keep their original holder)
        self._counter_installed = \
            install_counter_if_absent(self.ref_counter)

    def _call(self, method: str, *args, **kwargs):
        self._flush_refs()
        return self._rpc.call(method, *args, **kwargs)

    def _flush_refs(self) -> None:
        # one flusher at a time: interleaved drains could split a +/-
        # pair across two batches whose handler threads race server-side
        # (the synchronous call also serializes batch arrival order)
        with self._refs_lock:
            events = self.ref_counter.drain()
            if events:
                try:
                    self._rpc.call("refs_flush", self.job_id.binary(),
                                   events)
                except Exception:   # noqa: BLE001 — conn gone: the
                    pass            # server's close hook retires us

    # -- core API (the surface api.py/actor_api.py dispatch to) --------------
    def submit_spec(self, spec, fn_id: str, fn_bytes: bytes | None) -> None:
        from ..runtime.object_ref import (mark_transferred,
                                          transfer_generators)
        with transfer_generators() as gens:
            payload = serialize(spec)
        self._call("submit_spec", payload, fn_id, fn_bytes,
                   self.job_id.binary())
        mark_transferred(gens)

    def get(self, refs: list[ObjectRef], timeout: float | None = None):
        kind, payload = self._call(
            "get", [r.binary() for r in refs], timeout,
            timeout=None if timeout is None else timeout + 30.0)
        result = deserialize(payload)
        if kind == "exc":
            raise result
        return result

    def put(self, value) -> ObjectRef:
        from ..runtime.object_ref import serialize_collecting
        data, contained = serialize_collecting(value)
        oid_bin = self._call("put", data, self.job_id.binary(),
                             contained)
        return ObjectRef(ObjectID(oid_bin))

    def wait(self, refs, num_returns, timeout):
        ready_bins, not_ready_bins = self._call(
            "wait", [r.binary() for r in refs], num_returns, timeout,
            timeout=None if timeout is None else timeout + 30.0)
        by_id = {r.binary(): r for r in refs}
        return ([by_id[b] for b in ready_bins],
                [by_id[b] for b in not_ready_bins])

    def create_actor(self, actor_id, cls_id, cls_bytes, args, kwargs,
                     max_restarts, max_task_retries, name,
                     resources=None, strategy=None,
                     runtime_env=None, concurrency=None,
                     namespace="", lifetime=None) -> None:
        self._call("create_actor", actor_id.binary(), cls_id, cls_bytes,
                   serialize((args, kwargs, max_restarts,
                              max_task_retries, name, resources,
                              strategy, runtime_env, concurrency,
                              namespace, lifetime)))

    def submit_actor_call(self, actor_id, task_id, method: str, args,
                          kwargs, num_returns: int,
                          trace_ctx: tuple | None = None,
                          concurrency_group: str | None = None) -> None:
        from ..runtime.object_ref import (mark_transferred,
                                          transfer_generators)
        with transfer_generators() as gens:
            payload = serialize((args, kwargs, trace_ctx,
                                 concurrency_group))
        self._call("submit_actor_call", actor_id.binary(),
                   task_id.binary(), method, payload, num_returns)
        mark_transferred(gens)

    def stream_wait(self, task_id, index: int,
                    timeout: float | None = None):
        # bounded server-side waits so one stream doesn't pin an RPC
        # worker thread forever; loop client-side for timeout=None
        while True:
            server_wait = 30.0 if timeout is None else timeout
            reply = self._call(
                "stream_wait", task_id.binary(), index, server_wait,
                timeout=server_wait + 30.0)
            sealed, done, err_bytes = reply[0], reply[1], reply[2]
            known = reply[3] if len(reply) > 3 else True
            err = deserialize(err_bytes) if err_bytes else None
            if sealed > index or done or timeout is not None:
                return sealed, done, err, known

    def stream_ack(self, task_id, consumed: int) -> None:
        self._call("stream_ack", task_id.binary(), consumed)

    def stream_close(self, task_id, consumed: int) -> None:
        self._call("stream_close", task_id.binary(), consumed)

    def kill_actor(self, actor_id, no_restart: bool = True) -> None:
        self._call("kill_actor", actor_id.binary(), no_restart)

    def get_actor_id_by_name(self, name: str,
                             namespace: str = "") -> bytes | None:
        return self._call("get_actor_by_name", name, namespace)

    def cancel_task(self, task_id, force: bool = False) -> None:
        self._call("cancel", task_id.binary(), force)

    def kv_op(self, op: str, key: bytes, value: bytes | None = None,
              namespace: str = "", overwrite: bool = True):
        """internal_kv from a client driver (same surface as workers)."""
        return self._call("kv", op, key, value, namespace, overwrite)

    # -- introspection (api module functions duck-type onto these) -----------
    def request_resources(self, bundles: list[dict]) -> None:
        self._call("request_resources", bundles)

    def list_named_actors(self, all_namespaces: bool = False,
                          namespace: str = "") -> list:
        # the CALLER's namespace rides along: the head must filter by
        # it, not by its own driver's
        return self._call("list_named_actors", all_namespaces,
                          namespace)

    def worker_stacks(self, node_row: int | None = None,
                      timeout: float = 5.0) -> dict:
        return self._call("worker_stacks", node_row, timeout,
                          timeout=timeout + 30.0)

    def nodes(self) -> list[dict]:
        return self._call("nodes")

    def drain_node(self, node_id_hex: str, reason: str = "",
                   deadline_s: float | None = None) -> dict:
        return self._call("drain_node", node_id_hex, reason,
                          deadline_s, timeout=30.0)

    def available_resources(self) -> dict:
        return self._call("available_resources")

    def cluster_resources(self) -> dict:
        return self._call("cluster_resources")

    def timeline(self) -> list[dict]:
        return self._call("timeline")

    def status(self) -> dict:
        return self._call("status")

    def close(self) -> None:
        from ..runtime.object_ref import uninstall_counter
        self._flush_refs()
        try:
            self._rpc.call("client_bye", self.job_id.binary(),
                           timeout=5.0)
        except Exception:       # noqa: BLE001 — head already gone; its
            pass                # conn-close hook retires this holder
        if self._counter_installed:
            uninstall_counter(self.ref_counter)
        self._rpc.close()


def get_head_actor_id(client: ClientRuntime, name: str):
    raw = client.get_actor_id_by_name(name)
    return ActorID(raw) if raw else None
