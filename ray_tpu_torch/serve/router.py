"""Per-deployment request plane: admission control, bounded queueing,
deadline-aware dispatch, load shedding, and request-level stats.

Reference parity: upstream Serve's router
(``python/ray/serve/_private/router.py``) sits between the
``DeploymentHandle`` and the replica set — it caps per-replica in-flight
requests at ``max_ongoing_requests`` (excess requests QUEUE client-side
instead of over-submitting), bounds that queue at
``max_queued_requests`` (a full queue sheds with ``BackPressureError``),
and picks replicas with power-of-two-choices on observed load
(SURVEY.md §1 layer 14; mount empty).

Here the request plane is SHARDED (the per-ingress router model): a
``RouterGroup`` per controller owns ``serve_router_shards``
``RequestRouter`` shards, sessions (multiplexed model ids, HTTP
``X-Session-Id``) consistent-hash onto shards, and each shard routes
power-of-two-choices on its own exact counts plus the peer shards'
gossiped load digests (``serve/gossip.py`` — folded at most every
``serve_gossip_interval_s``, piggybacked on the health probe round).
Replica stickiness itself is rendezvous hashing over *replica* ids, so
it is shard-independent by construction: re-sharding, shard restarts,
and refreshes cannot move a model's traffic.  Queued requests are
PROMISE object refs: ``remote()`` never blocks — when all replicas are saturated it
allocates a fresh object id, parks the request in the bounded queue,
and returns a ref to the not-yet-submitted result.  A dispatcher
thread submits parked requests as completions free replica slots,
copying each real result into its promise (or poisoning it on deadline
expiry, so ``ray_tpu_torch.get`` surfaces ``GetTimeoutError`` instead of
hanging on work that was never done).

Load accounting feeds the ``_Controller`` autoscaler through GCS KV:

- ``inflight-<base>``  +1 at dispatch (router), -1 at completion
  (replica shell) — or by the router itself when the completion is a
  TRANSPORT error (dead replica): the shell never ran, so the router
  must settle the counter or the backlog signal inflates forever.
  Requests whose replica DIED are then failed over — dead replica
  evicted from the shard view, request re-routed — so a stale view
  window (replica release, loan reclaim, crash) degrades to a retry,
  not a caller-visible ActorDiedError.  Driver-side requests are ALL
  promise-backed (even the unsaturated fast path) precisely so this
  retry has a promise to re-point.
- ``queued-<base>``    +1 at enqueue, -1 at dispatch/expiry/shed.
- ``lat-<base>``       request-latency EWMA (ms), written by the router
  on every completion; the autoscaler and ``serve.status`` read it.
- ``batch*-<base>``    batch-size histogram counters written by the
  replicas' ``@serve.batch`` wrappers.

Workers and replicas (no driver store, so completions are unobservable)
fall back to direct dispatch with optimistic accounting — their KV
increment still happens before submit and is rolled back if the submit
itself fails.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from ..common.status import BackPressureError, GetTimeoutError
from .batching import BATCH_BUCKETS


def _api():
    import ray_tpu_torch
    return ray_tpu_torch


def _now() -> float:
    return time.monotonic()


# -- stats -------------------------------------------------------------------

_QPS_WINDOW_S = 5.0


class _Stats:
    """Driver-side request counters for one deployment (feeds the
    Prometheus endpoint, the dashboard, and ``ray_tpu_torch status``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.completed = 0
        self.user_errors = 0
        self.transport_errors = 0
        self.shed = 0
        self.expired = 0
        self.ewma_ms = 0.0
        self._lat_ms = deque(maxlen=512)
        self._done_t = deque(maxlen=4096)

    def record_completion(self, lat_ms: float, alpha: float,
                          user_error: bool) -> float:
        with self.lock:
            self.completed += 1
            if user_error:
                self.user_errors += 1
            self._lat_ms.append(lat_ms)
            self._done_t.append(time.monotonic())
            self.ewma_ms = lat_ms if self.completed == 1 else \
                alpha * lat_ms + (1.0 - alpha) * self.ewma_ms
            return self.ewma_ms

    def snapshot(self) -> dict:
        with self.lock:
            lats = sorted(self._lat_ms)
            now = time.monotonic()
            recent = sum(1 for t in self._done_t
                         if now - t <= _QPS_WINDOW_S)
            out = {
                "completed": self.completed,
                "user_errors": self.user_errors,
                "transport_errors": self.transport_errors,
                "shed": self.shed,
                "expired": self.expired,
                "qps": round(recent / _QPS_WINDOW_S, 2),
                "latency_ewma_ms": round(self.ewma_ms, 3),
            }
        if lats:
            out["p50_ms"] = round(lats[len(lats) // 2], 3)
            out["p99_ms"] = round(lats[min(len(lats) - 1,
                                           int(len(lats) * 0.99))], 3)
        else:
            out["p50_ms"] = out["p99_ms"] = 0.0
        return out


class _Queued:
    __slots__ = ("method", "args", "kwargs", "mux", "deadline", "ref",
                 "t_enq")

    def __init__(self, method, args, kwargs, mux, deadline, ref):
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.mux = mux
        self.deadline = deadline    # monotonic, or None
        self.ref = ref              # promise ObjectRef
        self.t_enq = _now()


# -- router ------------------------------------------------------------------

class RequestRouter:
    """One router SHARD (see module docstring).  ``for_controller`` /
    ``discard`` remain as compatibility entry points but resolve
    through the :class:`RouterGroup` registry — the group is the
    per-deployment object now."""

    @classmethod
    def for_controller(cls, controller) -> "RouterGroup":
        return RouterGroup.for_controller(controller)

    @classmethod
    def discard(cls, controller) -> None:
        RouterGroup.discard(controller)

    @classmethod
    def _routers(cls) -> list["RequestRouter"]:
        return [s for g in RouterGroup._groups() for s in g._shards]

    def __init__(self, controller, shard_id: int = 0, group=None):
        self._controller = controller
        self._shard_id = shard_id
        self._group = group
        self._cv = threading.Condition()
        self._version = -1
        self._replicas: list = []
        self._kv_inflight = b""
        self._kv_base = ""
        self._cfg: dict = {}
        self._inflight: dict[bytes, int] = {}
        self._queue: deque[_Queued] = deque()
        self._rr = 0
        self._calls = 0
        self._refreshing = False
        self._closed = False
        self._dispatcher: threading.Thread | None = None
        self._stats = _Stats()
        self._store = None
        self._store_checked = False
        self._suspect_keys: set[bytes] = set()  # replicas on gray nodes
        self._suspect_at = 0.0

    # -- environment ---------------------------------------------------------
    def _driver_store(self):
        """The owner's memory store, or None outside the driver (workers
        cannot observe completions, so they run in fallback mode)."""
        if not self._store_checked:
            # Idempotent lazy init: concurrent callers compute the
            # same value, so the last-writer-wins race is benign.
            try:
                from ray_tpu_torch.api import _get_runtime
                self._store = getattr(  # rtlint: disable=W7
                    _get_runtime(), "store", None)
            except Exception:   # noqa: BLE001
                self._store = None  # rtlint: disable=W7
            self._store_checked = True  # rtlint: disable=W7
        return self._store

    def _kv(self, key: bytes, delta: int) -> None:
        from ray_tpu_torch.experimental.internal_kv import _internal_kv_incr
        try:
            _internal_kv_incr(key, delta, namespace="serve")
        except Exception:   # noqa: BLE001 — accounting must not fail a call
            pass

    # -- replica view (satellite: fetch OUTSIDE the lock) --------------------
    def _refresh(self, force: bool = False) -> None:
        """Pick up controller-side scaling.  The RPC happens with no
        router lock held — a slow controller must not stall concurrent
        callers that already have a usable (if stale) view; only
        view-LESS callers wait, on the fetching leader's result."""
        with self._cv:
            self._calls += 1
            if not force and self._replicas and self._calls % 16 != 0:
                return
            while self._refreshing:
                if self._replicas and not force:
                    return          # stale view beats stalling
                self._cv.wait(1.0)  # viewless: ride the leader's fetch
                if self._replicas and not force:
                    return
                force = False       # the leader's result satisfies us
            self._refreshing = True
        got = None
        try:
            got = _api().get(self._controller.get_replicas.remote(),
                             timeout=30)
        finally:
            with self._cv:
                self._refreshing = False
                if got is not None:
                    version, replicas, kv_key, cfg = got
                    if version != self._version:
                        live = {r._actor_id.binary() for r in replicas}
                        self._inflight = {
                            k: v for k, v in self._inflight.items()
                            if k in live}
                    self._version, self._replicas = version, replicas
                    # Whole-object publishes of immutable values: racy
                    # readers see either the old or new snapshot, and a
                    # stale view is valid by design (see docstring).
                    self._kv_inflight = kv_key.encode()  # rtlint: disable=W7
                    self._kv_base = cfg.get("base", "")  # rtlint: disable=W7
                    was_rolling = self._cfg.get("rollout_active", False)
                    self._cfg = cfg  # rtlint: disable=W7
                    if was_rolling and not cfg.get("rollout_active") \
                            and self._group is not None:
                        # rollout sealed/rolled back: one version again
                        self._group.clear_version_pins()
                self._cv.notify_all()

    def _ensure_view(self) -> None:
        self._refresh()
        if not self._replicas:
            # scale-to-zero cold start: ask for a replica, blocking
            _api().get(self._controller.ensure_replica.remote(),
                       timeout=60)
            self._refresh(force=True)

    # -- replica choice ------------------------------------------------------
    def _load_locked(self, replica) -> int:
        """Routing load for one replica: this shard's exact live count
        plus the peer shards' gossiped (bounded-stale) contribution.
        With one shard the remote term is identically zero and this is
        the PR-3 single-router behavior, bit for bit."""
        key = replica._actor_id.binary()
        own = self._inflight.get(key, 0)
        if self._group is None or self._group.num_shards == 1:
            return own
        from .gossip import board
        return own + board.remote_load(self._kv_base, self._shard_id,
                                       key)

    def _refresh_suspects_locked(self) -> set[bytes]:
        """Actor-id binaries of replicas on SUSPECT nodes (gray
        failures flagged by the health manager).  Observable only on
        the in-process driver — client mode and workers see an empty
        set (the head's scheduler still soft-avoids those nodes).
        Cached ~1 s so the per-request cost is a clock read."""
        now = _now()
        if now - self._suspect_at < 1.0:
            return self._suspect_keys
        self._suspect_at = now
        keys: set[bytes] = set()
        try:
            from ray_tpu_torch.api import _get_runtime
            rt = _get_runtime()
            cluster = getattr(rt, "cluster", None)
            am = getattr(rt, "actor_manager", None)
            if cluster is not None and am is not None:
                rows = cluster.crm.suspect_rows()
                if rows:
                    keys = am.actors_on_rows(rows)
        except Exception:   # noqa: BLE001 — health view is best-effort
            keys = set()
        self._suspect_keys = keys
        return keys

    def _pick_locked(self, mux: str, capped: bool = True):
        """Power-of-two-choices among replicas with a free slot; a
        multiplexed model id overrides with rendezvous hashing so one
        model's calls stick to one replica (its ``@multiplexed`` LRU
        stays hot) — a saturated sticky replica returns None (the
        request queues rather than breaking stickiness).  While a
        rolling update is in flight the candidate set first narrows to
        the session's pinned model version (never to empty — the pin
        migrates when its version has no replica left), so no sticky
        session straddles two weight versions mid-flip."""
        import random
        reps = self._replicas
        if not reps:
            return None
        # demote replicas on quarantined/suspect nodes: route around
        # them while ANY healthy replica exists (a fully-suspect
        # replica set keeps serving — degraded beats down)
        suspects = self._refresh_suspects_locked()
        if suspects:
            healthy = [r for r in reps
                       if r._actor_id.binary() not in suspects]
            if healthy:
                reps = healthy
        if mux and self._group is not None and \
                self._cfg.get("rollout_active"):
            reps = self._group.pin_candidates(mux, reps, self._cfg)
        cap = self._cfg.get("max_ongoing", 4)
        if mux and len(reps) > 1:
            import hashlib
            rep = max(reps, key=lambda r: hashlib.md5(
                r._actor_id.binary() + mux.encode()).digest())
            self._rr += 1
            if capped and self._load_locked(rep) >= cap:
                return None
            return rep
        elig = [r for r in reps
                if not capped or self._load_locked(r) < cap]
        if not elig:
            return None
        self._rr += 1
        if len(elig) == 1:
            return elig[0]
        i, j = random.sample(range(len(elig)), 2)
        li, lj = self._load_locked(elig[i]), self._load_locked(elig[j])
        if li == lj:
            return elig[(i, j)[self._rr % 2]]
        return elig[i] if li < lj else elig[j]

    def _acquire_locked(self, replica) -> None:
        key = replica._actor_id.binary()
        self._inflight[key] = self._inflight.get(key, 0) + 1

    def _release(self, replica_key: bytes) -> None:
        with self._cv:
            c = self._inflight.get(replica_key, 0)
            if c > 0:
                self._inflight[replica_key] = c - 1
            self._cv.notify_all()

    # -- submission ----------------------------------------------------------
    def submit(self, method: str, args: tuple, kwargs: dict, mux: str,
               stream: bool, timeout_s: float | None):
        self._ensure_view()
        if self._group is not None:
            self._group.maybe_fold()    # gossip: refresh stale digests
        self._controller.tick.remote()  # fire-and-forget scale poke
        if stream:
            return self._submit_stream(method, args, kwargs, mux)
        store = self._driver_store()
        if store is None:
            return self._submit_fallback(method, args, kwargs, mux)
        deadline = None if timeout_s is None else _now() + timeout_s
        if deadline is not None and timeout_s <= 0:
            with self._stats.lock:
                self._stats.expired += 1
            raise GetTimeoutError(
                f"request deadline expired before submission "
                f"(timeout_s={timeout_s})")
        with self._cv:
            replica = self._pick_locked(mux)
            if replica is not None:
                self._acquire_locked(replica)
            else:
                return self._enqueue_locked(method, args, kwargs, mux,
                                            deadline)
        # even the fast path hands back a PROMISE ref, never the raw
        # submit ref: a replica that dies under a stale view (release,
        # loan reclaim, crash) then re-routes invisibly instead of
        # surfacing ActorDiedError to a caller who picked nothing
        from ray_tpu_torch.common.ids import ObjectID
        from ray_tpu_torch.runtime.object_ref import ObjectRef
        promise = ObjectRef(ObjectID.from_random())
        self._dispatch(replica, method, args, kwargs, mux,
                       promise=promise)
        return promise

    def _enqueue_locked(self, method, args, kwargs, mux, deadline):
        """All replicas saturated: park the request (bounded) and return
        a promise ref.  Caller holds the router lock."""
        from ray_tpu_torch.common.ids import ObjectID
        from ray_tpu_torch.runtime.object_ref import ObjectRef
        limit = self._cfg.get("max_queued", 200)
        if self._group is not None and self._group.num_shards > 1:
            # the deployment-level queue bound splits across shards, so
            # total parked work stays ~max_queued regardless of shards
            limit = max(1, limit // self._group.num_shards)
        if len(self._queue) >= limit:
            with self._stats.lock:
                self._stats.shed += 1
            name = self._cfg.get("name", "?")
            raise BackPressureError(
                f"deployment {name!r} rejected the request: all "
                f"replicas are at max_ongoing_requests and the request "
                f"queue is full ({limit} queued); retry later")
        ref = ObjectRef(ObjectID.from_random())
        item = _Queued(method, args, kwargs, mux, deadline, ref)
        self._queue.append(item)
        self._kv(b"queued-" + self._kv_base.encode(), 1)
        self._ensure_dispatcher_locked()
        self._cv.notify_all()
        return ref

    def _ensure_dispatcher_locked(self) -> None:
        if self._dispatcher is None or not self._dispatcher.is_alive():
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name=(f"serve-router-{self._cfg.get('name', '?')}"
                      f"-s{self._shard_id}"))
            self._dispatcher.start()

    def _submit_call(self, replica, method, args, kwargs, mux,
                     streaming: bool = False):
        """KV-accounted submit: +1 inflight BEFORE the call (backlog
        drives upscaling), rolled back if the submit itself raises —
        a failed submit must not permanently inflate the signal."""
        from ray_tpu_torch.actor_api import ActorMethod
        self._kv(self._kv_inflight, 1)
        try:
            if streaming:
                return ActorMethod(replica, "__serve_call__",
                                   num_returns="streaming").remote(
                    method, args, kwargs, mux)
            return ActorMethod(replica, "__serve_call__").remote(
                method, args, kwargs, mux)
        except BaseException:
            self._kv(self._kv_inflight, -1)
            raise

    def _dispatch(self, replica, method, args, kwargs, mux, promise):
        """Submit to an acquired replica slot and watch the completion.
        Returns the real ref (inline path) — queued requests get their
        promise fulfilled instead."""
        rkey = replica._actor_id.binary()
        try:
            ref = self._submit_call(replica, method, args, kwargs, mux)
        except BaseException as err:
            self._release(rkey)
            if promise is None:
                raise
            self._poison(promise, err)
            return None
        self._watch(rkey, ref, promise, (method, args, kwargs, mux))
        return ref

    def _watch(self, replica_key: bytes, ref, promise,
               request=None) -> None:
        """Completion observer: frees the replica slot, classifies the
        result (transport errors settle the shell's KV debt), records
        latency, and fulfills the promise for queued requests.  A
        replica-death completion on a promise fails OVER instead of
        failing the request: the dead replica is evicted from the local
        view and the request re-routed to a live one (membership
        changed under a stale view — planned releases and loan reclaims
        land here)."""
        store = self._driver_store()
        t0 = _now()

        def done(_oid=None):
            from ray_tpu_torch.runtime.serialization import (ActorDiedError,
                                                       TaskCancelledError,
                                                       WorkerCrashedError)
            lat_ms = (_now() - t0) * 1000.0
            err = store.error_of(ref.id)
            transport = err is not None and isinstance(
                err.cause,
                (ActorDiedError, WorkerCrashedError, TaskCancelledError))
            if transport:
                # the replica shell never ran: settle its -1 ourselves
                self._kv(self._kv_inflight, -1)
                with self._stats.lock:
                    self._stats.transport_errors += 1
                self._release(replica_key)
                # cancellation is deliberate — surface it; replica
                # DEATH evicts the stale view entry immediately (the
                # next pick skips the corpse) and re-routes the request
                # (at-least-once, matching upstream serve's
                # retry-on-replica-failure)
                if isinstance(err.cause,
                              (ActorDiedError, WorkerCrashedError)):
                    self._evict_dead(replica_key)
                    if promise is not None and request is not None:
                        self._redispatch(promise, request)
                        return
            else:
                from ray_tpu_torch.common.config import get_config
                alpha = get_config().serve_latency_ewma_alpha
                ewma = self._stats.record_completion(
                    lat_ms, alpha, user_error=err is not None)
                self._write_latency(ewma)
                self._release(replica_key)
            if promise is not None:
                self._fulfill(promise, ref)
        store.on_ready(ref.id, done)

    def _evict_dead(self, replica_key: bytes) -> None:
        """Drop a dead replica from the local routing view NOW — the
        transport error proves it is gone; waiting for the periodic
        refresh would keep landing requests on it."""
        with self._cv:
            self._replicas = [r for r in self._replicas
                              if r._actor_id.binary() != replica_key]
            self._inflight.pop(replica_key, None)
            self._cv.notify_all()

    def _redispatch(self, promise, request) -> None:
        """Re-route a request whose replica died before running it:
        straight to a free live replica, or parked with its EXISTING
        promise ref for the dispatcher thread.  Each hop evicts a dead
        replica first, so the fail-over chain is bounded by the view."""
        method, args, kwargs, mux = request
        with self._cv:
            replica = self._pick_locked(mux)
            if replica is not None:
                self._acquire_locked(replica)
            else:
                self._queue.append(_Queued(method, args, kwargs, mux,
                                           None, promise))
                self._kv(b"queued-" + self._kv_base.encode(), 1)
                self._ensure_dispatcher_locked()
                self._cv.notify_all()
                return
        self._dispatch(replica, method, args, kwargs, mux, promise)

    def _write_latency(self, ewma_ms: float) -> None:
        from ray_tpu_torch.experimental.internal_kv import _internal_kv_put
        try:
            _internal_kv_put(b"lat-" + self._kv_base.encode(),
                             f"{ewma_ms:.3f}".encode(),
                             namespace="serve")
        except Exception:   # noqa: BLE001
            pass

    def _fulfill(self, promise, real_ref) -> None:
        """Copy the settled real result into the promise entry.  Runs on
        a store sealer thread: the common case (in-band or local value)
        is a dict copy; the rare remote-resident case is handed to a
        one-shot thread so the sealer never blocks on a pull."""
        store = self._driver_store()
        try:
            vals = store.get_raw_blocking([real_ref.id], timeout=0.0)
            if vals is None:
                raise KeyError("result not present")
            store.put(promise.id, vals[0])
        except Exception:   # noqa: BLE001 — remote entry: pull off-thread
            def pull():
                try:
                    store.put(promise.id,
                              _api().get(real_ref, timeout=60))
                except BaseException as err:    # noqa: BLE001
                    self._poison(promise, err)
            threading.Thread(target=pull, daemon=True,
                             name="serve-promise-pull").start()

    def _poison(self, promise, err: BaseException) -> None:
        from ray_tpu_torch.runtime.serialization import RayTaskError
        store = self._driver_store()
        if isinstance(err, RayTaskError):
            store.poison(promise.id, err)
        else:
            store.poison(promise.id, RayTaskError(
                "serve request", f"{type(err).__name__}: {err}", err))

    # -- queued dispatch -----------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            if self._group is not None:
                self._group.maybe_fold()
            expired: list[_Queued] = []
            to_send: list[tuple[_Queued, object]] = []
            with self._cv:
                if self._closed:
                    return
                now = _now()
                remaining: deque[_Queued] = deque()
                while self._queue:
                    item = self._queue.popleft()
                    if item.deadline is not None \
                            and item.deadline <= now:
                        expired.append(item)
                        continue
                    replica = self._pick_locked(item.mux)
                    if replica is None:
                        remaining.append(item)
                        continue
                    self._acquire_locked(replica)
                    to_send.append((item, replica))
                self._queue = remaining
                if not expired and not to_send:
                    wait = 0.5
                    deadlines = [i.deadline for i in self._queue
                                 if i.deadline is not None]
                    if deadlines:
                        wait = min(wait,
                                   max(min(deadlines) - _now(), 0.0))
                    self._cv.wait(wait)
                    continue
            qkey = b"queued-" + self._kv_base.encode()
            for item in expired:
                self._kv(qkey, -1)
                with self._stats.lock:
                    self._stats.expired += 1
                self._poison(item.ref, GetTimeoutError(
                    f"request expired after "
                    f"{_now() - item.t_enq:.3f}s in the "
                    f"{self._cfg.get('name', '?')!r} queue, before "
                    "dispatch"))
            for item, replica in to_send:
                self._kv(qkey, -1)
                self._dispatch(replica, item.method, item.args,
                               item.kwargs, item.mux, promise=item.ref)

    # -- non-driver / streaming paths ----------------------------------------
    def _submit_fallback(self, method, args, kwargs, mux):
        """Worker-side handles cannot observe completions: dispatch
        directly (uncapped) with round-robin-ish p2c."""
        with self._cv:
            replica = self._pick_locked(mux, capped=False)
        if replica is None:
            raise RuntimeError("no replicas available")
        return self._submit_call(replica, method, args, kwargs, mux)

    def _submit_stream(self, method, args, kwargs, mux):
        """Streaming calls bypass the queue and the in-flight cap:
        there is no single seal to observe, and a long-lived stream
        pinning a slot would starve unary traffic.  The KV inflight
        count still covers them (the shell settles at stream end)."""
        with self._cv:
            replica = self._pick_locked(mux, capped=False)
        if replica is None:
            raise RuntimeError("no replicas available")
        return self._submit_call(replica, method, args, kwargs, mux,
                                 streaming=True)

    # -- teardown / introspection -------------------------------------------
    def _close(self) -> None:
        with self._cv:
            self._closed = True
            pending = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        if self._driver_store() is not None:
            for item in pending:
                self._poison(item.ref, GetTimeoutError(
                    "deployment deleted while the request was queued"))

    def snapshot(self) -> dict:
        with self._cv:
            out = {
                "deployment": self._cfg.get("name", ""),
                "shard": self._shard_id,
                "replicas": len(self._replicas),
                "queued": len(self._queue),
                "inflight": sum(self._inflight.values()),
                "max_ongoing_requests": self._cfg.get("max_ongoing", 0),
                "max_queued_requests": self._cfg.get("max_queued", 0),
            }
        out.update(self._stats.snapshot())
        out.update(batch_stats(self._kv_base))
        return out


# -- router group (the per-deployment object) --------------------------------

class RouterGroup:
    """All router shards for one deployment.  Sessions consistent-hash
    onto shards (rendezvous over shard ids — stable across shard
    restarts); sessionless traffic round-robins.  The group is also the
    gossip publisher: ``fold()`` snapshots every shard's digest and
    merges it onto the process :data:`~ray_tpu_torch.serve.gossip.board`."""

    _registry: dict[bytes, "RouterGroup"] = {}
    _reg_lock = threading.Lock()

    @classmethod
    def for_controller(cls, controller,
                       num_shards: int | None = None) -> "RouterGroup":
        key = controller._actor_id.binary()
        with cls._reg_lock:
            group = cls._registry.get(key)
            if group is None:
                group = cls._registry[key] = cls(controller, num_shards)
            return group

    @classmethod
    def discard(cls, controller) -> None:
        key = controller._actor_id.binary()
        with cls._reg_lock:
            group = cls._registry.pop(key, None)
        if group is not None:
            group._close()

    @classmethod
    def _groups(cls) -> list["RouterGroup"]:
        with cls._reg_lock:
            return list(cls._registry.values())

    def __init__(self, controller, num_shards: int | None = None):
        if num_shards is None:
            from ray_tpu_torch.common.config import get_config
            num_shards = get_config().serve_router_shards
        self.num_shards = max(1, int(num_shards))
        self._controller = controller
        self._shards = [RequestRouter(controller, shard_id=i, group=self)
                        for i in range(self.num_shards)]
        self._rr = itertools.count()
        self._fold_lock = threading.Lock()
        self._folded_at = 0.0
        # session/mux -> pinned model version, only populated while the
        # controller reports a rollout in flight.  Group-level (not
        # per-shard) so restart_shard cannot drop a live session's pin.
        self._version_pins: dict[str, str] = {}
        self._pin_lock = threading.Lock()
        self.pin_migrations = 0

    # -- shard choice --------------------------------------------------------
    def shard_for(self, session: str | None) -> RequestRouter:
        """Consistent-hash session stickiness: the same session key
        always lands on the same shard (warm queue position, coherent
        per-session ordering); shard ids are stable, so the mapping
        survives a shard restart.  Sessionless calls round-robin."""
        if self.num_shards == 1:
            return self._shards[0]
        if session:
            import hashlib
            i = max(range(self.num_shards),
                    key=lambda k: hashlib.md5(
                        b"%d|" % k + session.encode()).digest())
            return self._shards[i]
        return self._shards[next(self._rr) % self.num_shards]

    def submit(self, method: str, args: tuple, kwargs: dict, mux: str,
               stream: bool, timeout_s: float | None,
               session: str | None = None):
        return self.shard_for(session or mux).submit(
            method, args, kwargs, mux, stream, timeout_s)

    # -- model-version pinning (rolling updates) -----------------------------
    def pin_candidates(self, key: str, reps: list, cfg: dict) -> list:
        """Narrow ``reps`` to the session's pinned model version while
        a rollout is in flight.  First sight pins to the version
        serving right now; a pin whose version has no replica left
        migrates to the current serving version rather than starving
        the session.  Never returns empty given non-empty ``reps``."""
        rv = cfg.get("replica_versions", {})
        serving = cfg.get("model_version", "v1")
        with self._pin_lock:
            pin = self._version_pins.setdefault(key, serving)
        subset = [r for r in reps
                  if rv.get(r._actor_id.binary().hex(), serving) == pin]
        if subset:
            return subset
        if pin != serving:
            with self._pin_lock:
                self._version_pins[key] = serving
                self.pin_migrations += 1
            subset = [r for r in reps
                      if rv.get(r._actor_id.binary().hex(),
                                serving) == serving]
        return subset or reps

    def clear_version_pins(self) -> None:
        """Called when a refresh observes the rollout over (sealed or
        rolled back): every replica is back on one version, so pins
        would only misfilter the NEXT rollout."""
        with self._pin_lock:
            self._version_pins.clear()

    def version_pins(self) -> dict[str, str]:
        with self._pin_lock:
            return dict(self._version_pins)

    # -- gossip --------------------------------------------------------------
    def fold(self) -> None:
        """Snapshot every shard's digest (each under its own lock, none
        held while publishing) and merge onto the board, evicting
        replicas that left the controller's membership."""
        from .gossip import board
        digests: dict[int, dict[bytes, int]] = {}
        live: set[bytes] = set()
        base = ""
        versions: dict[bytes, str] = {}
        for s in self._shards:
            with s._cv:
                digests[s._shard_id] = dict(s._inflight)
                live.update(r._actor_id.binary() for r in s._replicas)
                base = base or s._kv_base
                rv = s._cfg.get("replica_versions")
                if rv:
                    serving = s._cfg.get("model_version", "v1")
                    for r in s._replicas:
                        key = r._actor_id.binary()
                        versions[key] = rv.get(key.hex(), serving)
        if base:
            board.fold(base, digests, live, versions=versions)
            # Monotonic freshness stamp: a lost store only makes the
            # next maybe_fold() re-fold a little early — harmless.
            self._folded_at = _now()  # rtlint: disable=W7

    def maybe_fold(self) -> None:
        """Fold when the board view is older than the gossip interval —
        the opportunistic half of the protocol (the periodic half rides
        the health probe round)."""
        if self.num_shards == 1:
            return
        from ray_tpu_torch.common.config import get_config
        interval = get_config().serve_gossip_interval_s
        if _now() - self._folded_at < interval:
            return
        if self._fold_lock.acquire(blocking=False):
            try:
                if _now() - self._folded_at >= interval:
                    self.fold()
            finally:
                self._fold_lock.release()

    # -- compat with the single-router surface -------------------------------
    def _refresh(self, force: bool = False) -> None:
        for s in self._shards:
            s._refresh(force=force)

    def restart_shard(self, i: int) -> RequestRouter:
        """Replace one shard in place (crash-and-recreate model).  The
        new shard re-fetches the replica view; session->shard and
        mux->replica hashes are both id-stable, so stickiness holds."""
        old = self._shards[i]
        # Single-slot list store is atomic under the GIL; concurrent
        # readers iterate either the old or new shard, both valid.
        self._shards[i] = RequestRouter(  # rtlint: disable=W7
            self._controller, shard_id=i, group=self)
        old._close()
        return self._shards[i]

    def _close(self) -> None:
        from .gossip import board
        base = ""
        for s in self._shards:
            base = base or s._kv_base
            s._close()
        if base:
            board.evict(base)

    # -- merged stats --------------------------------------------------------
    def backlog(self) -> tuple[int, int, float]:
        """(queued, inflight, latency_ewma_ms) across shards — the
        driver-side load signal the capacity-loan manager reads."""
        queued = inflight = 0
        ewma = 0.0
        for s in self._shards:
            with s._cv:
                queued += len(s._queue)
                inflight += sum(s._inflight.values())
            ewma = max(ewma, s._stats.ewma_ms)
        return queued, inflight, ewma

    def cfg(self) -> dict:
        for s in self._shards:
            if s._cfg:
                return s._cfg
        return {}

    def snapshot(self) -> dict:
        """The deployment-level view: counters summed across shards,
        latency percentiles over the merged sample window, batch stats
        read once (they are deployment-level KV counters)."""
        from .gossip import board
        base = ""
        replicas = queued = inflight = 0
        completed = user_errors = transport_errors = shed = expired = 0
        lats: list[float] = []
        recent = 0
        ewma = 0.0
        cfg: dict = {}
        now = time.monotonic()
        for s in self._shards:
            with s._cv:
                replicas = max(replicas, len(s._replicas))
                queued += len(s._queue)
                inflight += sum(s._inflight.values())
                base = base or s._kv_base
                cfg = cfg or s._cfg
            st = s._stats
            with st.lock:
                completed += st.completed
                user_errors += st.user_errors
                transport_errors += st.transport_errors
                shed += st.shed
                expired += st.expired
                lats.extend(st._lat_ms)
                recent += sum(1 for t in st._done_t
                              if now - t <= _QPS_WINDOW_S)
                if st.completed:
                    ewma = max(ewma, st.ewma_ms)
        lats.sort()
        out = {
            "deployment": cfg.get("name", ""),
            "replicas": replicas,
            "queued": queued,
            "inflight": inflight,
            "max_ongoing_requests": cfg.get("max_ongoing", 0),
            "max_queued_requests": cfg.get("max_queued", 0),
            "shards": self.num_shards,
            "completed": completed,
            "user_errors": user_errors,
            "transport_errors": transport_errors,
            "shed": shed,
            "expired": expired,
            "qps": round(recent / _QPS_WINDOW_S, 2),
            "latency_ewma_ms": round(ewma, 3),
            "gossip_digest": board.digest_size(base),
        }
        if lats:
            out["p50_ms"] = round(lats[len(lats) // 2], 3)
            out["p99_ms"] = round(lats[min(len(lats) - 1,
                                           int(len(lats) * 0.99))], 3)
        else:
            out["p50_ms"] = out["p99_ms"] = 0.0
        out.update(batch_stats(base))
        return out


def batch_stats(kv_base: str) -> dict:
    """Aggregate the replicas' batch-size KV counters for one
    deployment: count, mean, and the raw (non-cumulative) buckets."""
    if not kv_base:
        return {}
    from ray_tpu_torch.experimental.internal_kv import _internal_kv_incr
    try:
        cnt = _internal_kv_incr(f"batchcnt-{kv_base}".encode(), 0,
                                namespace="serve")
        if not cnt:
            return {}
        total = _internal_kv_incr(f"batchsum-{kv_base}".encode(), 0,
                                  namespace="serve")
        buckets = {}
        for le in list(BATCH_BUCKETS) + ["inf"]:
            n = _internal_kv_incr(f"batchb-{le}-{kv_base}".encode(), 0,
                                  namespace="serve")
            if n:
                buckets[str(le)] = n
        return {"batches": cnt,
                "batch_size_mean": round(total / cnt, 2),
                "batch_size_buckets": buckets}
    except Exception:   # noqa: BLE001
        return {}


def request_plane_stats() -> dict[str, dict]:
    """Per-deployment request-plane stats for every router group in
    this process, keyed by deployment name (metrics/dashboard/status
    hook).  Counters are merged across the group's shards."""
    out: dict[str, dict] = {}
    for group in RouterGroup._groups():
        try:
            snap = group.snapshot()
        except Exception:   # noqa: BLE001
            continue
        name = snap.get("deployment") or "?"
        if name in out:
            base = ""
            for s in group._shards:
                base = base or s._kv_base
            name = f"{name}@{base[:4]}"
        out[name] = snap
    return out
