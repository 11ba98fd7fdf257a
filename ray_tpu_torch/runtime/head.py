"""Head daemon: a long-lived process hosting the cluster + control RPC.

Reference parity: the head node runs ``gcs_server`` + raylet + dashboard,
and remote drivers attach via ``ray.init("ray://…")`` (the ray client
proxy, ``python/ray/util/client/server``) while ``ray job submit`` runs
entrypoints through the dashboard's job module (SURVEY.md §1 layers 2/15,
§3.1; mount empty).

In this rebuild the daemon owns one ``DriverRuntime`` (cluster, raylets,
the scheduling data plane on the GPU) and serves two client surfaces over
``ray_tpu_torch.rpc``:

- **client mode** — the full task/actor/object API proxied for remote
  ``init(address=…)`` drivers.  Client-held objects deliberately take the
  worker-frame ownership model: the daemon never creates counted
  ObjectRefs for them (a transient server-side ref would hit zero when
  the handler returned and reclaim a result the client still holds).
- **operations** — status/memory/timeline introspection and job
  submission (``JobManager``), consumed by the CLI.
"""

from __future__ import annotations

import logging
import threading

from ..common.ids import ActorID, JobID, ObjectID, TaskID
from .serialization import deserialize, serialize


class HeadNode:
    def __init__(self, resources: dict | None = None,
                 num_workers: int | None = None,
                 system_config: dict | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 xlang_port: int | None = 0,
                 persist_path: str | None = None):
        """``persist_path`` enables head fault tolerance: the GCS
        metadata plane (KV incl. the job table, fn registry, named-actor
        specs) snapshots there periodically, and a restarted daemon
        restores it — agents reconnect and interrupted jobs re-run
        (reference: Redis-backed GCS FT, SURVEY.md §5.4; divergence
        noted in JobManager.restore_jobs)."""
        import os
        from .. import api
        from ..rpc import transport as _transport
        from ..rpc.xlang_gateway import XlangGateway
        from .job_manager import JobManager
        api.init(resources=resources, num_workers=num_workers,
                 system_config=system_config)
        self._rt = api._get_runtime()
        self._lock = threading.Lock()
        self.jobs = JobManager(self._rt.cluster.session_dir)
        self.jobs.attach_kv(self._rt.cluster.kv)
        self._persist_path = persist_path
        if persist_path and os.path.exists(persist_path):
            self._rt.cluster.restore_gcs_snapshot(persist_path)
        self.server = _transport.serve(self._handlers(), host=host,
                                       port=port)
        self.server.start()
        # cross-language surface (C++ frontend); xlang_port=None disables
        self.xlang = None if xlang_port is None else \
            XlangGateway(self._rt, host=host, port=xlang_port)
        self.jobs.head_address = self.server.address
        if self._rt.cluster.dashboard is not None:
            self._rt.cluster.dashboard.attach_jobs(self.jobs)
        # worker-node agents join through these handlers; attach also
        # serves the head's object plane (agents pull head-resident
        # objects from it)
        from .node_agent import AgentHub
        self.agent_hub = AgentHub(self._rt.cluster)
        self.agent_hub.attach(self.server)
        self._stop_event = threading.Event()
        # interrupted jobs re-run AFTER the control surface is up (their
        # drivers reconnect through it)
        if persist_path and os.path.exists(persist_path):
            self.jobs.head_address = self.server.address
            self.jobs.restore_jobs()
        self._persist_lock = threading.Lock()
        if persist_path:
            self._persist_thread = threading.Thread(
                target=self._persist_loop, daemon=True,
                name="head-persist")
            self._persist_thread.start()

    def _snapshot(self) -> None:
        with self._persist_lock:    # serialize vs the final stop save
            self._rt.cluster.save_gcs_snapshot(self._persist_path)

    def _persist_loop(self) -> None:
        log = logging.getLogger("ray_tpu_torch.head")
        while not self._stop_event.wait(2.0):
            try:
                self._snapshot()
            except Exception:   # noqa: BLE001 — a failed snapshot must
                # not kill the daemon (next tick retries), but silent
                # persistence loss turns a later failover into data loss
                log.warning("gcs snapshot failed; retrying next tick",
                            exc_info=True)

    @property
    def address(self) -> str:
        return self.server.address

    def wait_for_shutdown(self, timeout: float | None = None) -> bool:
        return self._stop_event.wait(timeout)

    def stop(self) -> None:
        # stop jobs FIRST so their terminal statuses land in the final
        # snapshot — a job the operator shut down must not persist as
        # RUNNING and get resurrected by the next start
        self.jobs.stop_all(wait=True)
        if self._persist_path:
            try:    # final snapshot: clean stops restore losslessly
                self._stop_event.set()      # persist loop stands down
                self._snapshot()
            except Exception:   # noqa: BLE001
                pass
        self.agent_hub.shutdown()
        if self.xlang is not None:
            self.xlang.stop()
        self.server.stop()
        from .. import api
        api.shutdown()
        self._stop_event.set()

    # -- handler table -------------------------------------------------------
    def _handlers(self) -> dict:
        return {
            "ping": self._ping,
            "connect": self._connect,
            "fn_register": self._fn_register,
            "submit_spec": self._submit_spec,
            "get": self._get,
            "put": self._put,
            "wait": self._wait,
            "create_actor": self._create_actor,
            "submit_actor_call": self._submit_actor_call,
            "kill_actor": self._kill_actor,
            "get_actor_by_name": self._get_actor_by_name,
            "cancel": self._cancel,
            "kv": self._kv,
            "refs_flush": self._refs_flush,
            "client_bye": self._client_bye,
            "stream_wait": self._stream_wait,
            "stream_ack": self._stream_ack,
            "stream_close": self._stream_close,
            "status": self._status,
            "nodes": self._nodes,
            "drain_node": self._drain_node,
            "available_resources": self._available_resources,
            "cluster_resources": self._cluster_resources,
            "timeline": self._timeline,
            "state_list": self._state_list,
            "memory": self._memory,
            "worker_stacks": self._worker_stacks,
            "list_named_actors": self._list_named_actors,
            "request_resources": self._request_resources,
            "job_submit": self._job_submit,
            "job_status": self.jobs.status,
            "job_list": self.jobs.list,
            "job_logs": self.jobs.logs,
            "job_stop": self.jobs.stop,
            "stop_daemon": self._stop_async,
            "chaos": self._chaos,
            "rollout": self._rollout,
        }

    def _job_submit(self, *args, **kwargs) -> str:
        """Submit, then snapshot synchronously: a job acked by a
        persistent head must survive kill -9 right after the ack —
        the 2 s persist tick alone leaves a durability window where
        a restarted head has never heard of the job."""
        job_id = self.jobs.submit(*args, **kwargs)
        if self._persist_path:
            self._snapshot()
        return job_id

    def _rollout(self, op: str, deployment: str = "",
                 **kwargs) -> dict:
        """Model-version plane control/observe channel.  The rollout
        controller itself runs driver-side (it owns the serve app);
        the head exposes the KV-journaled registry — ``status`` — and
        the operator control flags — ``pause``/``resume``/``abort`` —
        that the driver-side controller polls between flips.  Because
        the journal lives in the GCS-snapshotted KV, a promoted
        standby serves the same view."""
        from ..versioning import VersionRegistry
        reg = VersionRegistry()
        if op == "status":
            if deployment:
                rec = reg.record(deployment)
                return {deployment: rec} if rec is not None else {}
            return reg.all()
        if op in ("pause", "abort"):
            reg.set_control(deployment, op)
            return {"deployment": deployment, "control": op}
        if op == "resume":
            reg.set_control(deployment, "")
            return {"deployment": deployment, "control": ""}
        raise ValueError(
            f"unknown rollout op {op!r} "
            f"(one of: status, pause, resume, abort)")

    def _chaos(self, op: str, **kwargs) -> dict:
        """Runtime control of the seeded network-chaos plane (shared
        dispatch with the CLI — ``rpc/chaos.py``)."""
        from ..rpc import chaos
        return chaos.control(op, **kwargs)

    # -- client-mode surface -------------------------------------------------
    def _ping(self) -> dict:
        return {"ok": True, "session_dir": self._rt.cluster.session_dir}

    def _request_resources(self, bundles: list[dict]) -> bool:
        asc = self._rt.cluster.autoscaler
        if asc is None:
            raise RuntimeError("no autoscaler is running on this head")
        asc.request_resources(bundles)
        return True

    def _list_named_actors(self, all_namespaces: bool = False,
                           namespace: str = "") -> list:
        """Filters by the CALLING client's namespace (it rides the
        RPC), never the head driver's."""
        ns = None if all_namespaces else (namespace or "")
        return self._rt.actor_manager.list_named(ns)

    def _worker_stacks(self, row: int | None = None,
                       timeout: float = 5.0) -> dict:
        """Live all-thread stacks of every worker (py-spy analogue —
        SURVEY §5.1(c)); keys serialized as 'row:index'."""
        got = self._rt.cluster.dump_worker_stacks(row=row,
                                                  timeout=timeout)
        return {f"{r}:{i}": text for (r, i), text in got.items()}

    def _connect(self, job_runtime_env: dict | None) -> dict:
        """A client attaches: allocate it a job id; a job-level env from
        the FIRST env-bearing client becomes the cluster default (one
        shared job env — the in-process simplification).  The client
        becomes a refcount HOLDER tied to this connection: its batched
        ref events fold under ("c", job) and a disconnect — graceful or
        abrupt — retires every count it held, so concurrent drivers have
        disjoint object lifetimes."""
        job_id = JobID.next()
        with self._lock:    # check-then-set: FIRST env-bearing client
            if job_runtime_env and not self._rt.cluster.job_runtime_env:
                self._rt.cluster.set_job_runtime_env(job_runtime_env)
        counter = self._rt.cluster.ref_counter
        am = self._rt.actor_manager

        def on_gone(job_bin=job_id.binary()):
            counter.holder_gone(("c", job_bin))
            # the job's EPHEMERAL actors die with it; detached survive
            am.on_job_exit(job_bin)
        self.server.on_conn_close(on_gone)
        return {"job_id": job_id.binary(),
                "session_dir": self._rt.cluster.session_dir}

    def _refs_flush(self, job_bin: bytes, events: list) -> None:
        self._rt.cluster.ref_counter.apply_batch(events, ("c", job_bin))

    def _client_bye(self, job_bin: bytes) -> None:
        self._rt.cluster.ref_counter.holder_gone(("c", job_bin))

    def _stream_wait(self, task_bin: bytes, index: int,
                     timeout: float | None):
        sealed, done, error, known = self._rt.stream_wait(
            TaskID(task_bin), index, timeout)
        return (sealed, done, serialize(error) if error else None,
                known)

    def _stream_ack(self, task_bin: bytes, consumed: int) -> None:
        self._rt.stream_ack(TaskID(task_bin), consumed)

    def _stream_close(self, task_bin: bytes, consumed: int) -> None:
        self._rt.stream_close(TaskID(task_bin), consumed)

    def _fn_register(self, fn_id: str, fn_bytes: bytes) -> None:
        self._rt.fn_registry.setdefault(fn_id, fn_bytes)

    def _submit_spec(self, spec_bytes: bytes, fn_id: str,
                     fn_bytes: bytes | None,
                     job_bin: bytes | None = None) -> None:
        from .object_ref import counter_suppressed
        # suppressed: counted server-side twins of the client's refs
        # would decref to zero on lineage eviction and reclaim objects
        # the client still holds (see counter_suppressed docstring)
        with counter_suppressed():
            spec = deserialize(spec_bytes)
        if job_bin is not None:
            counter = self._rt.cluster.ref_counter
            for i in range(spec.num_returns):
                counter.set_owner(
                    ObjectID.for_task_return(spec.task_id, i + 1),
                    ("c", job_bin))
        self._rt.submit_spec(spec, fn_id, fn_bytes)

    def _get(self, oid_bins: list[bytes], timeout: float | None):
        oids = [ObjectID(b) for b in oid_bins]
        try:
            return ("ok", serialize(self._rt.get_raw(oids, timeout)))
        except BaseException as e:      # noqa: BLE001 — typed re-raise
            return ("exc", serialize(e))    # client-side

    def _put(self, value_bytes: bytes, job_bin: bytes | None = None,
             contained: list | None = None) -> bytes:
        from .object_ref import counter_suppressed
        with counter_suppressed():      # see _submit_spec
            value = deserialize(value_bytes)
        oid = self._rt.put_raw(value)
        counter = self._rt.cluster.ref_counter
        if job_bin is not None:
            counter.set_owner(oid, ("c", job_bin))
        if contained:
            counter.add_contained(oid,
                                  [ObjectID(b) for b in contained])
        return oid.binary()

    def _wait(self, oid_bins: list[bytes], num_returns: int,
              timeout: float | None):
        ready, not_ready = self._rt.wait_raw(
            [ObjectID(b) for b in oid_bins], num_returns, timeout)
        return ([o.binary() for o in ready],
                [o.binary() for o in not_ready])

    def _create_actor(self, actor_bin: bytes, cls_id: str,
                      cls_bytes: bytes | None, payload: bytes) -> None:
        from .object_ref import counter_suppressed
        with counter_suppressed():      # see _submit_spec
            unpacked = deserialize(payload)
        namespace, lifetime = "", None
        if len(unpacked) == 11:
            (args, kwargs, max_restarts, max_task_retries, name, res,
             strategy, runtime_env, concurrency, namespace,
             lifetime) = unpacked
        elif len(unpacked) == 9:
            (args, kwargs, max_restarts, max_task_retries, name, res,
             strategy, runtime_env, concurrency) = unpacked
        else:               # pre-concurrency client
            (args, kwargs, max_restarts, max_task_retries, name, res,
             strategy, runtime_env) = unpacked
            concurrency = None
        self._rt.create_actor(ActorID(actor_bin), cls_id, cls_bytes,
                              args, kwargs, max_restarts,
                              max_task_retries, name, resources=res,
                              strategy=strategy, runtime_env=runtime_env,
                              concurrency=concurrency,
                              namespace=namespace, lifetime=lifetime)

    def _submit_actor_call(self, actor_bin: bytes, task_bin: bytes,
                           method: str, payload: bytes,
                           num_returns: int) -> None:
        from .object_ref import counter_suppressed
        with counter_suppressed():      # see _submit_spec
            unpacked = deserialize(payload)
        if len(unpacked) == 4:
            args, kwargs, trace_ctx, group = unpacked
        else:
            args, kwargs, trace_ctx = unpacked
            group = None
        self._rt.actor_manager.submit(
            ActorID(actor_bin), TaskID(task_bin), method, args, kwargs,
            num_returns, trace_ctx=trace_ctx, concurrency_group=group)

    def _kill_actor(self, actor_bin: bytes, no_restart: bool) -> None:
        self._rt.actor_manager.kill(ActorID(actor_bin),
                                    no_restart=no_restart)

    def _get_actor_by_name(self, name: str,
                           namespace: str = "") -> bytes | None:
        aid = self._rt.actor_manager.get_by_name(name, namespace)
        return aid.binary() if aid is not None else None

    def _cancel(self, task_bin: bytes, force: bool) -> None:
        # cluster-wide: the task may be queued/running/agent-leased on
        # any node, not just the head's raylet
        self._rt.cluster.cancel_task(TaskID(task_bin), force=force)

    def _kv(self, op: str, key: bytes, value: bytes | None,
            namespace: str, overwrite: bool):
        return self._rt.cluster.kv.dispatch(op, key, value, namespace,
                                            overwrite)

    # -- operations surface --------------------------------------------------
    def _status(self) -> dict:
        from .. import api
        cluster = self._rt.cluster
        return {
            "address": self.address,
            "role": "primary",
            "leasing": self._leasing_stats(),
            "xlang_address": self.xlang.address if self.xlang else None,
            "dashboard_url": (cluster.dashboard.url
                              if cluster.dashboard else None),
            "session_dir": cluster.session_dir,
            "nodes": api.nodes(),
            "available_resources": api.available_resources(),
            "cluster_resources": api.cluster_resources(),
            "store": cluster.store.stats(),
            "object_plane": cluster.plane.stats(),
            "pulls": cluster.pull_manager.stats(),
            "broadcasts": cluster.broadcasts.stats(),
            "jobs": self.jobs.list(),
            "drains": cluster.drain_status(),
            "serve": self._serve_stats(),
            "train": self._train_stats(cluster),
            "versions": self._version_stats(),
            "health": self._health_stats(cluster),
            "chaos": self._chaos_stats(),
            "scheduler": self._scheduler_stats(),
        }

    @staticmethod
    def _leasing_stats() -> dict:
        try:
            from ..leasing import aggregate_stats
            return aggregate_stats()
        except Exception:   # noqa: BLE001 — lease plane disabled
            return {}

    @staticmethod
    def _train_stats(cluster) -> dict:
        # elastic training plane: driver-local run gauges plus the
        # loan manager's two-directional lending counters
        out: dict = {}
        try:
            from ..train.elastic import active_train_stats
            runs = active_train_stats()
            if runs:
                out["runs"] = runs
        except Exception:   # noqa: BLE001 — train plane unused
            pass
        loans = getattr(cluster, "loans", None)
        if loans is not None:
            try:
                out["loans"] = loans.stats()
            except Exception:   # noqa: BLE001
                pass
        return out

    @staticmethod
    def _health_stats(cluster) -> dict:
        from ..rpc import breaker
        health = getattr(cluster, "health", None)
        out = health.stats() if health is not None else {}
        out["suspect_rows"] = cluster.crm.suspect_rows()
        out["breakers"] = breaker.stats()
        return out

    @staticmethod
    def _chaos_stats() -> dict:
        from ..rpc import chaos
        return chaos.status() if chaos.is_enabled() else {"enabled": False}

    @staticmethod
    def _version_stats() -> dict:
        # per-deployment model-version journal (current version plus
        # any in-flight rollout's phase/progress); empty when the
        # version registry has never been written
        try:
            from ..versioning import VersionRegistry
            out = {}
            for name, rec in VersionRegistry().all().items():
                row = {"current": rec["current"],
                       "previous": rec["previous"]}
                ro = rec.get("rollout")
                if ro is not None:
                    row["rollout"] = {
                        "to": ro["to"], "phase": ro["phase"],
                        "flipped": ro["flipped"],
                        "replicas": ro["replicas"],
                        "error": ro["error"]}
                out[name] = row
            return out
        except Exception:   # noqa: BLE001 — versioning absent/unused
            return {}

    @staticmethod
    def _serve_stats() -> dict:
        # per-deployment request-plane stats; only populated when serve
        # apps run in this process (the router registry is local)
        try:
            from ..serve.router import request_plane_stats
            return request_plane_stats()
        except Exception:   # noqa: BLE001 — serve absent/unused
            return {}

    def _scheduler_stats(self) -> dict:
        """Where the head's placement rounds ran: its raylets' rounds by
        route and the device programs' launch counters (read from the
        modules only if they were imported: reading them never imports
        torch)."""
        import sys
        cluster = self._rt.cluster
        rounds = {"device_rounds": 0, "delta_rounds": 0,
                  "host_rounds": 0, "topk_rounds": 0}
        for raylet in list(cluster.raylets.values()):
            for key in rounds:
                rounds[key] += getattr(raylet, key, 0)
        launches = {}
        hk = sys.modules.get("ray_tpu_torch.ops.hybrid_kernel")
        if hk is not None:
            launches["waterfill_scan"] = hk.waterfill_scan.launches
            launches["localized"] = hk.waterfill_scan.localized_launches
            launches["beat_rows"] = hk.beat_rows.launches
            launches["beat_tail"] = hk.beat_tail.launches
        bp = sys.modules.get("ray_tpu_torch.ops.binpack_kernel")
        if bp is not None:
            launches["binpack_launch_loop"] = \
                bp.binpack_launch_loop.launches
        for module, fn in (("locality_kernel", "schedule_grouped_topk"),
                           ("bundle_kernel", "schedule_bundle_groups"),
                           ("pull_kernel", "choose_sources")):
            mod = sys.modules.get(f"ray_tpu_torch.ops.{module}")
            if mod is not None:
                launches[fn] = getattr(mod, fn).launches
        asc = cluster.autoscaler
        return {"device": str(cluster.scheduler_device), **rounds,
                "launches": launches,
                "autoscaler": asc.stats() if asc is not None else None}

    def _nodes(self) -> list[dict]:
        from .. import api
        return api.nodes()

    def _drain_node(self, node_id_hex: str, reason: str = "",
                    deadline_s: float | None = None) -> dict:
        from ..common.ids import NodeID
        return self._rt.cluster.drain_node(
            NodeID.from_hex(node_id_hex), reason=reason,
            deadline_s=deadline_s)

    def _available_resources(self) -> dict:
        from .. import api
        return api.available_resources()

    def _cluster_resources(self) -> dict:
        from .. import api
        return api.cluster_resources()

    def _timeline(self) -> list[dict]:
        return self._rt.cluster.events.timeline()

    def _state_list(self, kind: str,
                    filters: list | None = None) -> list[dict]:
        """State-API rows for the CLI (reference: ``ray list tasks`` et
        al. resolve through the head's state aggregator)."""
        from ..util import state
        table = {"tasks": state.list_tasks,
                 "actors": state.list_actors,
                 "objects": state.list_objects,
                 "nodes": state.list_nodes,
                 "placement-groups": state.list_placement_groups}
        fn = table.get(kind)
        if fn is None:
            raise ValueError(
                f"unknown state kind {kind!r} (one of {sorted(table)})")
        return fn([tuple(f) for f in filters] if filters else None)

    def _memory(self) -> dict:
        return self._rt.cluster.store.stats()

    def _stop_async(self) -> str:
        # reply first, THEN tear down — stopping inline would close the
        # socket under the caller's pending reply
        threading.Timer(0.2, self.stop).start()
        return "stopping"
