"""Deployments, replica pools, routing, autoscaling.

Reference parity: Serve's controller owns per-deployment replica sets
and reconciles them against target counts; ``DeploymentHandle`` routes
requests client-side with power-of-two-choices on observed in-flight
load (as upstream) and reports load; autoscaling moves replica counts
between
``min_replicas`` and ``max_replicas`` to hold
``target_ongoing_requests`` per replica (``python/ray/serve/`` —
SURVEY.md §1 layer 14; mount empty).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


def _api():
    import ray_tpu_torch
    return ray_tpu_torch


# -- model multiplexing ------------------------------------------------------

_MUX_LOCK = threading.Lock()    # per-process: guards replica LRU caches
# created eagerly at import: a lazily-raced creation could hand two
# threads DIFFERENT vars and silently lose a request's model id
import contextvars as _contextvars  # noqa: E402

_mux_model_id = _contextvars.ContextVar("serve_mux_model", default="")


def _mux_var():
    return _mux_model_id


def get_multiplexed_model_id() -> str:
    """Inside a replica method: the model id the current request was
    routed with (reference: ``serve.get_multiplexed_model_id``)."""
    return _mux_var().get()


def multiplexed(fn=None, *, max_num_models_per_replica: int = 3):
    """Decorate a replica's model-loader method: results cache per
    replica in an LRU bounded at ``max_num_models_per_replica``
    (reference: ``@serve.multiplexed`` model multiplexing — one
    replica set serves MANY models, each loaded on demand and evicted
    least-recently-used).  Pair with
    ``handle.options(multiplexed_model_id=...)``, which routes every
    call for one model id to the same replica (rendezvous hashing) so
    its cache stays hot."""
    import functools
    cap = max(int(max_num_models_per_replica), 1)

    def deco(loader):
        # the cache lives ON the instance and the lock is a module
        # global: the deployment target class must stay picklable, so
        # the closure may capture only plain values
        cache_attr = f"_serve_mux_cache_{loader.__name__}"

        pending_attr = f"_serve_mux_pending_{loader.__name__}"

        @functools.wraps(loader)
        def wrapper(self, model_id: str):
            import threading as _threading
            from collections import OrderedDict

            # late import: a module-global referenced directly would be
            # captured BY VALUE when cloudpickle ships the enclosing
            # user class, and locks don't pickle
            from ray_tpu_torch.serve.deployment import _MUX_LOCK
            while True:
                with _MUX_LOCK:
                    cache = getattr(self, cache_attr, None)
                    if cache is None:
                        cache = OrderedDict()
                        setattr(self, cache_attr, cache)
                    if model_id in cache:
                        cache.move_to_end(model_id)
                        return cache[model_id]
                    pending = getattr(self, pending_attr, None)
                    if pending is None:
                        pending = {}
                        setattr(self, pending_attr, pending)
                    ev = pending.get(model_id)
                    if ev is None:
                        # we lead the load; concurrent cold requests
                        # for the same model WAIT instead of each
                        # running the expensive loader
                        pending[model_id] = _threading.Event()
                        break
                ev.wait(timeout=600.0)
                # leader finished (or failed): re-check the cache; a
                # failed leader leaves it absent and a follower leads
            try:
                model = loader(self, model_id)  # load OUTSIDE the lock
                with _MUX_LOCK:
                    cache[model_id] = model
                    cache.move_to_end(model_id)
                    while len(cache) > cap:
                        cache.popitem(last=False)   # evict LRU
                return model
            finally:
                with _MUX_LOCK:
                    ev2 = pending.pop(model_id, None)
                if ev2 is not None:
                    ev2.set()
        wrapper._serve_multiplexed = True
        return wrapper
    return deco if fn is None else deco(fn)


# -- replica shell -----------------------------------------------------------

class _ReplicaShell:
    """Hosts one user replica object and settles its load accounting.

    The GCS KV inflight counter is incremented by the ``RequestRouter``
    at dispatch (so submitted-but-unfinished calls count toward
    autoscaling) and decremented HERE when execution completes.
    Replicas run as threaded actors (``max_concurrency`` = the
    deployment's ``max_ongoing_requests``), so a slow request does not
    head-of-line-block the others — the worker's reader-thread frame
    routing makes the shared pipe safe for concurrent calls.

    The shell also publishes a per-call context for ``@serve.batch``
    wrappers on the user object: the deployment's KV key base (batch
    histograms aggregate cluster-wide) and the replica's LIVE call
    count, which lets a batch leader cut its window early once every
    in-flight call has joined the batch.
    """

    def __init__(self, target_bytes: bytes, init_args: bytes,
                 kv_key: str):
        from ray_tpu_torch.runtime.serialization import deserialize
        target = deserialize(target_bytes)
        args, kwargs = deserialize(init_args)
        self._obj = target(*args, **kwargs)
        self._kv_key = kv_key.encode()
        self._kv_base = kv_key.split("-", 1)[1] if "-" in kv_key \
            else kv_key
        self._active = 0
        self._active_lock = threading.Lock()
        self._model_version = "v1"

    def _active_count(self) -> int:
        with self._active_lock:
            return self._active

    def _reload(self, artifact, version: str) -> dict:
        """Hot-swap step on a DRAINED replica (the rollout controller
        pulls it out of routing first): hand the new weights to the
        user object's ``reload(artifact)`` if it defines one, re-tag
        the model version, and run the verification probe
        (``__check_health__`` when defined).  ``artifact`` arrives as
        the broadcast-staged value (ObjectRef args resolve before the
        call, so the bytes come off the replica-local copy the tree
        delivered); ``None`` re-tags only (rollback with no retained
        artifact)."""
        ok = True
        if artifact is not None and hasattr(self._obj, "reload"):
            try:
                self._obj.reload(artifact)
            except Exception:   # noqa: BLE001 — a throwing reload is a
                ok = False      # failed probe, not a dead replica
        self._model_version = version
        if ok and hasattr(self._obj, "__check_health__"):
            try:
                ok = bool(self._obj.__check_health__())
            except Exception:   # noqa: BLE001 — same contract
                ok = False
        return {"ok": ok, "version": version,
                "active": self._active_count()}

    def __serve_call__(self, method: str, args: tuple, kwargs: dict,
                       model_id: str = ""):
        import inspect

        from ray_tpu_torch.experimental.internal_kv import _internal_kv_incr

        from .batching import _shell_ctx

        def settle():
            _internal_kv_incr(self._kv_key, -1, namespace="serve")
        with self._active_lock:
            self._active += 1
        shell_token = _shell_ctx.set(
            {"kv_base": self._kv_base, "active": self._active_count})
        token = _mux_var().set(model_id) if model_id else None
        try:
            out = getattr(self._obj, method)(*args, **kwargs)
        except BaseException:
            settle()
            raise
        finally:
            if token is not None:
                _mux_var().reset(token)
            _shell_ctx.reset(shell_token)
            with self._active_lock:
                self._active -= 1
        if inspect.isgenerator(out):
            # a STREAMING response stays in the inflight count until
            # the stream finishes — calling the generator function
            # returns instantly, and settling then would leave the
            # autoscaler blind to long-running streams.  The model-id
            # var re-wraps EVERY advance: the body only executes at
            # next(), long after the outer finally reset the token,
            # and a token left set across a yield would bleed into
            # interleaved calls on the same thread
            def stream():
                try:
                    while True:
                        tok = _mux_var().set(model_id) if model_id \
                            else None
                        try:
                            item = next(out)
                        except StopIteration:
                            return
                        finally:
                            if tok is not None:
                                _mux_var().reset(tok)
                        yield item
                finally:
                    settle()
            return stream()
        settle()
        return out


# -- controller actor --------------------------------------------------------

class _Controller:
    """Owns one deployment's replica set (actor handles) and scales it.

    Runs as a dedicated actor so handles living in tasks/other actors
    can fetch the current replica list; scaling decisions read the KV
    inflight counter on ``tick`` (handles fire one per request).
    """

    def __init__(self, cls_or_fn_bytes: bytes, init_args: bytes,
                 num_replicas: int, autoscaling: dict | None,
                 actor_options: dict, max_ongoing_requests: int = 4,
                 max_queued_requests: int = 200, name: str = ""):
        import os
        self._target_bytes = cls_or_fn_bytes
        self._init_args_bytes = init_args
        self._autoscaling = autoscaling
        self._actor_options = dict(actor_options)
        self._max_ongoing = max(int(max_ongoing_requests), 1)
        self._max_queued = max(int(max_queued_requests), 0)
        self._name = name
        self._kv_base = os.urandom(6).hex()
        self._kv_key = f"inflight-{self._kv_base}"
        self._replicas: list = []
        self._loaners: list = []    # replicas on LOANED batch nodes
        self._retiring: list = []   # loaners draining for reclaim
        self._releasing: list = []  # replicas draining for a reverse lend
        self._flipping: list = []   # replicas out of routing mid-flip
        self._version = 0
        self._model_version = "v1"  # the deployment's SERVING version
        self._replica_versions: dict[str, str] = {}  # actor hex -> ver
        self._rollout_active = False
        self._last_scale = time.monotonic()
        if autoscaling:
            n = autoscaling.get("min_replicas", 1)
        else:
            n = max(num_replicas, 1)
        for _ in range(n):
            self._start_replica()

    def _start_replica(self) -> None:
        import ray_tpu_torch
        actor_cls = ray_tpu_torch.remote(_ReplicaShell)
        opts = dict(self._actor_options)
        # replicas handle requests CONCURRENTLY (threaded actor up to
        # max_ongoing_requests — upstream replicas do the same on their
        # event loop)
        opts.setdefault("max_concurrency", self._max_ongoing)
        stub = actor_cls.options(**opts) if opts else actor_cls
        handle = stub.remote(self._target_bytes, self._init_args_bytes,
                             self._kv_key)
        self._replicas.append(handle)
        self._replica_versions[handle._actor_id.binary().hex()] = \
            self._model_version
        self._version += 1

    def _stop_replica(self) -> None:
        import ray_tpu_torch
        handle = self._replicas.pop()
        self._replica_versions.pop(handle._actor_id.binary().hex(),
                                   None)
        self._version += 1
        ray_tpu_torch.kill(handle)

    # -- handle-facing -------------------------------------------------------
    def get_replicas(self):
        auto = self._autoscaling
        hi = auto.get("max_replicas", 4) if auto else \
            len(self._replicas)
        return (self._version, list(self._replicas) + list(self._loaners),
                self._kv_key, {
                    "max_ongoing": self._max_ongoing,
                    "max_queued": self._max_queued,
                    "name": self._name,
                    "base": self._kv_base,
                    # the loan manager's "pool exhausted" signal: the
                    # regular pool cannot grow past its configured cap
                    "at_max": len(self._replicas) >= hi,
                    "loaners": len(self._loaners),
                    "releasing": len(self._releasing),
                    # model-version plane: per-replica version tags so
                    # routers can pin sessions to a consistent version
                    # while a rollout is mid-flight
                    "model_version": self._model_version,
                    "replica_versions": dict(self._replica_versions),
                    "rollout_active": self._rollout_active,
                })

    # -- elastic capacity loaning (driver LoanManager calls these) -----------
    def add_loaner(self, actor_options: dict):
        """Start one replica on a LOANED batch node: the options carry
        the loan-shaped resource (``serve_loaned``) that only loaned
        CRM rows expose, so placement lands there and nowhere else.
        Returns the replica handle — the loan record keeps it for the
        targeted reclaim drain."""
        import ray_tpu_torch
        actor_cls = ray_tpu_torch.remote(_ReplicaShell)
        opts = dict(self._actor_options)
        opts.update(actor_options)
        opts.setdefault("max_concurrency", self._max_ongoing)
        handle = actor_cls.options(**opts).remote(
            self._target_bytes, self._init_args_bytes, self._kv_key)
        self._loaners.append(handle)
        self._replica_versions[handle._actor_id.binary().hex()] = \
            self._model_version
        self._version += 1
        return handle

    def begin_retire_loaner(self, key_hex: str = ""):
        """Reclaim step 1: pull one loaner out of the routing set
        (version bump -> shards stop dispatching to it) but keep it
        alive to finish in-flight work.  ``key_hex`` targets a specific
        replica (node death); empty retires the newest loan (LIFO)."""
        pick = None
        if key_hex:
            for h in self._loaners:
                if h._actor_id.binary().hex() == key_hex:
                    pick = h
                    break
        elif self._loaners:
            pick = self._loaners[-1]
        if pick is None:
            return None
        self._loaners.remove(pick)
        self._retiring.append(pick)
        self._version += 1
        return pick

    def finish_retire_loaner(self, key_hex: str) -> bool:
        """Reclaim step 2: the drain converged (or timed out, or the
        node died) — kill the retiring replica and forget it."""
        import ray_tpu_torch
        for h in list(self._retiring):
            if h._actor_id.binary().hex() == key_hex:
                self._retiring.remove(h)
                try:
                    ray_tpu_torch.kill(h)
                except Exception:   # noqa: BLE001 — already dead
                    pass
                return True
        return False

    # -- reverse lending (batch/train borrows a serve node) ------------------
    def begin_release_replica(self):
        """Reverse-lend step 1: lend one regular replica's node to
        batch/train — pull the newest replica out of routing (version
        bump -> shards stop dispatching) but keep it alive to finish
        in-flight work; the loan manager kills it once idle via
        ``finish_release_replica``, freeing the node for batch
        placement.  Refuses to shrink below the autoscaling floor."""
        auto = self._autoscaling
        lo = max(auto.get("min_replicas", 1) if auto else 1, 1)
        if len(self._replicas) <= lo:
            return None
        pick = self._replicas[-1]               # LIFO, like loan reclaim
        self._replicas.remove(pick)
        self._releasing.append(pick)
        self._version += 1
        return pick

    def finish_release_replica(self, key_hex: str) -> bool:
        """Reverse-lend step 2: the drain converged (or the node died)
        — kill the released replica; its resources return to the CRM
        and batch placement can use the whole node."""
        import ray_tpu_torch
        for h in list(self._releasing):
            if h._actor_id.binary().hex() == key_hex:
                self._releasing.remove(h)
                self._replica_versions.pop(key_hex, None)
                try:
                    ray_tpu_torch.kill(h)
                except Exception:   # noqa: BLE001 — already dead
                    pass
                self._version += 1
                return True
        return False

    def restore_replica(self) -> None:
        """Reverse-lend epilogue: the lend ended (serve pressure came
        back, or the lent node died) — start a fresh replica to take
        the lent one's place in the pool."""
        self._start_replica()

    # -- model-version plane (versioning/rollout.py calls these) -------------
    def begin_flip(self, key_hex: str) -> bool:
        """Flip step 1: pull the replica out of the routing set
        (version bump -> shards stop dispatching to it) but keep it
        alive to drain its in-flight requests — the retire-loaner
        two-step, applied to a regular replica for a weight swap."""
        for h in self._replicas:
            if h._actor_id.binary().hex() == key_hex:
                self._replicas.remove(h)
                self._flipping.append(h)
                self._version += 1
                return True
        return False

    def commit_flip(self, key_hex: str, model_version: str) -> bool:
        """Flip step 2 (success): the drained replica reloaded and
        probed healthy — re-enter routing under the new version tag."""
        for h in list(self._flipping):
            if h._actor_id.binary().hex() == key_hex:
                self._flipping.remove(h)
                self._replicas.append(h)
                self._replica_versions[key_hex] = model_version
                self._version += 1
                return True
        return False

    def cancel_flip(self, key_hex: str, dead: bool = False) -> bool:
        """Flip step 2 (failure): probe failed (back into routing on
        the OLD version, untouched) or the replica died mid-flip
        (dropped from the set entirely)."""
        import ray_tpu_torch
        for h in list(self._flipping):
            if h._actor_id.binary().hex() == key_hex:
                self._flipping.remove(h)
                if dead:
                    self._replica_versions.pop(key_hex, None)
                    try:
                        ray_tpu_torch.kill(h)
                    except Exception:   # noqa: BLE001 — already dead
                        pass
                else:
                    self._replicas.append(h)
                self._version += 1
                return True
        return False

    def flipping_handles(self) -> list:
        return list(self._flipping)

    def set_model_version(self, model_version: str) -> None:
        """Seal: new replicas (scale-up, loaners) now start on this
        version."""
        self._model_version = model_version

    def model_version(self) -> str:
        return self._model_version

    def set_rollout_active(self, active: bool) -> None:
        """Routers pin sessions to per-replica version tags only while
        a rollout is actually mid-flight (the pin table costs a dict
        lookup per pick)."""
        self._rollout_active = bool(active)
        self._version += 1

    def version_counts(self) -> dict:
        out: dict[str, int] = {}
        for v in self._replica_versions.values():
            out[v] = out.get(v, 0) + 1
        return out

    def ensure_replica(self):
        """Cold start for scale-to-zero: a request arrived while no
        replica exists."""
        if not self._replicas:
            self._start_replica()
        return self._version

    def tick(self):
        """Autoscaling check (fired by handles; fire-and-forget)."""
        self._maybe_scale()
        return None

    def _signals(self) -> tuple[int, int, float]:
        """The router-maintained load signals for this deployment:
        (dispatched-but-unfinished, queued awaiting a free slot,
        request-latency EWMA in ms)."""
        from ray_tpu_torch.experimental.internal_kv import (_internal_kv_get,
                                                      _internal_kv_incr)
        inflight = _internal_kv_incr(self._kv_key.encode(), 0,
                                     namespace="serve")
        queued = _internal_kv_incr(f"queued-{self._kv_base}".encode(),
                                   0, namespace="serve")
        raw = _internal_kv_get(f"lat-{self._kv_base}".encode(),
                               namespace="serve")
        try:
            lat_ms = float(raw) if raw else 0.0
        except ValueError:
            lat_ms = 0.0
        return inflight, queued, lat_ms

    def _maybe_scale(self) -> None:
        auto = self._autoscaling
        if not auto:
            return
        now = time.monotonic()
        if now - self._last_scale < auto.get("upscale_delay_s", 0.1):
            return
        target = max(auto.get("target_ongoing_requests", 2), 1)
        lo = auto.get("min_replicas", 1)
        hi = auto.get("max_replicas", 4)
        inflight, queued, lat_ms = self._signals()
        # demand = executing + queued: a bounded router queue means
        # raw inflight alone UNDERCOUNTS pressure (requests the router
        # is holding back never show up in the replica counter)
        demand = inflight + queued
        want = max(lo, min(hi, -(-demand // target)))
        target_lat = auto.get("target_latency_ms", 0.0)
        if target_lat and lat_ms > target_lat \
                and want <= len(self._replicas) < hi:
            # latency-EWMA escape hatch: per-replica load looks on
            # target but requests are SLOW — add capacity anyway
            want = len(self._replicas) + 1
        if want > len(self._replicas):
            while len(self._replicas) < want:
                self._start_replica()
            self._last_scale = now
        elif want < len(self._replicas) and queued == 0 and \
                now - self._last_scale > auto.get("downscale_delay_s",
                                                  1.0):
            # never downscale with a backlog: the queue would re-pack
            # the survivors and immediately re-trigger an upscale
            while len(self._replicas) > want:
                self._stop_replica()
            self._last_scale = now

    def num_replicas(self) -> int:
        return len(self._replicas) + len(self._loaners)

    def stats(self) -> dict:
        """Controller-side view of the request-plane load signals
        (``serve.status`` merges this with the driver router's
        counters)."""
        inflight, queued, lat_ms = self._signals()
        return {"deployment": self._name,
                "replicas": len(self._replicas),
                "loaners": len(self._loaners),
                "inflight": inflight, "queued": queued,
                "latency_ewma_ms": lat_ms,
                "model_version": self._model_version,
                "version_counts": self.version_counts(),
                "rollout_active": self._rollout_active}

    def shutdown(self) -> None:
        import ray_tpu_torch
        for h in list(self._replicas) + list(self._loaners) + \
                list(self._retiring) + list(self._flipping):
            ray_tpu_torch.kill(h)
        self._replicas.clear()
        self._loaners.clear()
        self._retiring.clear()
        self._flipping.clear()
        self._replica_versions.clear()
        # the deployment's KV counters (inflight/queued/lat/batch*) are
        # keyed by a per-controller random base: delete them, or every
        # run/delete cycle leaks namespace entries forever
        from ray_tpu_torch.experimental.internal_kv import (_internal_kv_del,
                                                      _internal_kv_list)
        try:
            suffix = self._kv_base.encode()
            for key in _internal_kv_list(b"", namespace="serve"):
                if key.endswith(suffix):
                    _internal_kv_del(key, namespace="serve")
        except Exception:   # noqa: BLE001 — cleanup is best-effort
            pass


# -- handle ------------------------------------------------------------------

class DeploymentHandle:
    """Facade over the deployment's ``RequestRouter``: ``.remote()``
    submits through the shared per-controller router, which enforces
    the per-replica in-flight cap, the bounded queue, and deadline
    propagation (see ``serve/router.py``).  Every handle variant
    produced by ``options()`` routes through the SAME router, so the
    load view and the admission bound stay coherent across callers.

    Serializable (carries only the controller's actor handle plus the
    call options), so deployments compose: pass one deployment's handle
    to another's ``bind``.
    """

    def __init__(self, controller_handle, method: str = "__call__",
                 stream: bool = False, multiplexed_model_id: str = "",
                 timeout_s: float | None = None, session_id: str = ""):
        self._controller = controller_handle
        self._method = method
        self._stream = stream
        self._mux_id = multiplexed_model_id
        self._timeout_s = timeout_s
        self._session_id = session_id

    def options(self, *, method_name: str | None = None,
                stream: bool | None = None,
                multiplexed_model_id: str | None = None,
                timeout_s: float | None = None,
                session_id: str | None = None) -> "DeploymentHandle":
        """``stream=True``: calls return an ObjectRefGenerator — the
        replica method must be a generator; items stream back with
        backpressure (reference: handle.options(stream=True)).
        ``multiplexed_model_id``: route every call for this model to
        the same replica (rendezvous hashing) so its ``@multiplexed``
        LRU cache stays hot.  ``timeout_s``: per-request deadline —
        a request still queued in the router when it expires is
        DROPPED before dispatch and its ref raises
        ``GetTimeoutError``.  ``session_id``: consistent-hash the call
        onto one router shard (the per-ingress sharded request plane —
        a multiplexed model id implies its own session key)."""
        return DeploymentHandle(
            self._controller,
            method_name if method_name is not None else self._method,
            stream if stream is not None else self._stream,
            multiplexed_model_id if multiplexed_model_id is not None
            else self._mux_id,
            timeout_s if timeout_s is not None else self._timeout_s,
            session_id if session_id is not None else self._session_id)

    def remote(self, *args, **kwargs):
        from .router import RouterGroup
        return RouterGroup.for_controller(self._controller).submit(
            self._method, args, kwargs, self._mux_id, self._stream,
            self._timeout_s, session=self._session_id)

    def __reduce__(self):
        return (DeploymentHandle,
                (self._controller, self._method, self._stream,
                 self._mux_id, self._timeout_s, self._session_id))


# -- deployment / application ------------------------------------------------

@dataclass
class Application:
    """A bound deployment node.  ``bind`` composes DECLARATIVELY:
    passing one deployment's ``bind()`` result as an argument to
    another's makes a deployment GRAPH — ``serve.run`` materializes
    the whole DAG depth-first, replacing each nested node with its
    live ``DeploymentHandle`` (reference: Serve's ``bind`` DAG API,
    ``python/ray/serve/``, SURVEY.md §1 layer 14; mount empty).
    A node shared by several parents (diamond fan-in) materializes
    once and its replicas are shared."""

    deployment: "Deployment"
    args: tuple
    kwargs: dict


class Deployment:
    def __init__(self, target: type | Callable, name: str,
                 num_replicas: int = 1,
                 autoscaling_config: dict | None = None,
                 ray_actor_options: dict | None = None,
                 max_ongoing_requests: int = 4,
                 max_queued_requests: int | None = None):
        self._target = target
        self.name = name
        self._num_replicas = num_replicas
        self._autoscaling = autoscaling_config
        self._actor_options = dict(ray_actor_options or {})
        self._max_ongoing = max_ongoing_requests
        # None => the serve_max_queued_requests config default,
        # resolved in the DRIVER at run() time (workers may not share
        # the driver's system_config overrides)
        self._max_queued = max_queued_requests

    def options(self, *, num_replicas: int | None = None,
                autoscaling_config: dict | None = None,
                ray_actor_options: dict | None = None,
                name: str | None = None,
                max_ongoing_requests: int | None = None,
                max_queued_requests: int | None = None) -> "Deployment":
        return Deployment(
            self._target, name or self.name,
            num_replicas if num_replicas is not None
            else self._num_replicas,
            autoscaling_config if autoscaling_config is not None
            else self._autoscaling,
            ray_actor_options if ray_actor_options is not None
            else self._actor_options,
            max_ongoing_requests if max_ongoing_requests is not None
            else self._max_ongoing,
            max_queued_requests if max_queued_requests is not None
            else self._max_queued)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(target: type | Callable | None = None, *,
               name: str | None = None, num_replicas: int = 1,
               autoscaling_config: dict | None = None,
               ray_actor_options: dict | None = None,
               max_ongoing_requests: int = 4,
               max_queued_requests: int | None = None):
    """``@serve.deployment`` (bare or parameterized)."""
    def make(t):
        tgt = t if isinstance(t, type) else _wrap_function(t)
        return Deployment(tgt, name or t.__name__, num_replicas,
                          autoscaling_config, ray_actor_options,
                          max_ongoing_requests, max_queued_requests)
    if target is not None:
        return make(target)
    return make


def _wrap_function(fn: Callable) -> type:
    import inspect

    class _FnReplica:
        # function deployments that are generators stream over HTTP too
        _serve_http_stream = inspect.isgeneratorfunction(fn)

        def __call__(self, *args, **kwargs):
            return fn(*args, **kwargs)
    _FnReplica.__name__ = getattr(fn, "__name__", "fn_replica")
    return _FnReplica


# -- run / delete / status ---------------------------------------------------

@dataclass
class _Running:
    controller: Any
    handle: DeploymentHandle
    deployment: Deployment = None
    route_prefix: str | None = None
    # child controllers of a deployment graph (teardown order: root
    # first — it is the only one the ingress/user routes into)
    child_controllers: list = field(default_factory=list)


_apps: dict[str, _Running] = {}
_apps_lock = threading.Lock()
_ingress = None
_ingress_lock = threading.Lock()


def start(http_host: str = "127.0.0.1", http_port: int = 0,
          request_timeout_s: float = 30.0,
          max_body_bytes: int = 64 * 1024 * 1024) -> str:
    """Start the HTTP ingress (idempotent); returns its address.
    ``http_port=0`` binds an ephemeral port — pass 8000 for the
    reference's fixed default."""
    return _ensure_ingress(http_host, http_port,
                           request_timeout_s, max_body_bytes).address


def _ensure_ingress(http_host: str = "127.0.0.1", http_port: int = 0,
                    request_timeout_s: float = 30.0,
                    max_body_bytes: int = 64 * 1024 * 1024):
    global _ingress
    from .http_proxy import HttpIngress
    with _ingress_lock:
        if _ingress is None:
            _ingress = HttpIngress(http_host, http_port,
                                   request_timeout_s, max_body_bytes)
        return _ingress


def _ingress_if_running():
    with _ingress_lock:
        return _ingress


def http_address() -> str | None:
    with _ingress_lock:
        return _ingress.address if _ingress is not None else None


def _substitute_bound(value, build):
    """Replace Application nodes with live handles inside an argument,
    one container level deep (lists/tuples/dicts of bound nodes are
    common graph shapes)."""
    if isinstance(value, Application):
        return build(value)
    if isinstance(value, (list, tuple)):
        out = [build(v) if isinstance(v, Application) else v
               for v in value]
        return type(value)(out)
    if isinstance(value, dict):
        return {k: build(v) if isinstance(v, Application) else v
                for k, v in value.items()}
    return value


def run(app: Application, *, name: str = "default",
        route_prefix: str | None = None) -> DeploymentHandle:
    import ray_tpu_torch
    from ray_tpu_torch.runtime.serialization import serialize
    if route_prefix is not None:
        # validate BEFORE materializing actors: a bad prefix must not
        # leak a live replica set nothing can reach or tear down
        from .http_proxy import _norm_prefix
        route_prefix = _norm_prefix(route_prefix)
    # materialize the bound DAG depth-first: nested Application args
    # become live DeploymentHandles (shared nodes materialize once)
    materialized: dict[int, DeploymentHandle] = {}
    building: set[int] = set()
    controllers: list = []

    def build(a: Application) -> DeploymentHandle:
        got = materialized.get(id(a))
        if got is not None:
            return got
        if id(a) in building:
            raise ValueError(
                f"deployment graph cycle through {a.deployment.name!r}")
        building.add(id(a))
        d = a.deployment
        b_args = tuple(_substitute_bound(x, build) for x in a.args)
        b_kwargs = {k: _substitute_bound(v, build)
                    for k, v in a.kwargs.items()}
        from ray_tpu_torch.common.config import get_config
        max_queued = d._max_queued if d._max_queued is not None \
            else get_config().serve_max_queued_requests
        controller_cls = ray_tpu_torch.remote(_Controller)
        ctl = controller_cls.remote(
            serialize(d._target), serialize((b_args, b_kwargs)),
            d._num_replicas, d._autoscaling, d._actor_options,
            d._max_ongoing, max_queued, d.name)
        # materialize the replica set before handing the handle out
        ray_tpu_torch.get(ctl.num_replicas.remote(), timeout=60)
        h = DeploymentHandle(ctl)
        building.discard(id(a))
        materialized[id(a)] = h
        controllers.append(ctl)
        return h

    dep = app.deployment
    try:
        handle = build(app)
    except BaseException:
        # a mid-build failure (cycle, replica init hang/raise) must not
        # leak the child controllers already materialized — nothing
        # else would ever reference them
        for ctl in reversed(controllers):
            try:
                ray_tpu_torch.get(ctl.shutdown.remote(), timeout=30)
                ray_tpu_torch.kill(ctl)
            except Exception:   # noqa: BLE001 — best-effort teardown
                pass
        raise
    controller = controllers.pop()      # the root's (built last)
    if route_prefix is not None:
        # a generator __call__ makes the HTTP route STREAMING: chunked
        # transfer of each yielded item (reference streaming responses)
        import inspect
        http_stream = (
            inspect.isgeneratorfunction(
                getattr(dep._target, "__call__", None))
            or getattr(dep._target, "_serve_http_stream", False))
        _ensure_ingress().add_route(route_prefix, handle,
                                    stream=http_stream)
    with _apps_lock:
        old = _apps.pop(name, None)
        _apps[name] = _Running(controller, handle, dep, route_prefix,
                               controllers)
    if old is not None:
        ingress = _ingress_if_running()
        if old.route_prefix is not None and ingress is not None:
            # ownership-checked: only drops the route if the OLD handle
            # still holds it (same-prefix re-run already swapped it)
            ingress.remove_route(old.route_prefix, old.handle)
        _teardown(old)
    return handle


def get_deployment_handle(name: str = "default") -> DeploymentHandle:
    with _apps_lock:
        running = _apps.get(name)
    if running is None:
        raise KeyError(f"no running serve app {name!r}")
    return running.handle


def status(name: str = "default") -> dict:
    import ray_tpu_torch
    with _apps_lock:
        running = _apps.get(name)
    if running is None:
        return {"status": "NOT_RUNNING"}
    n = ray_tpu_torch.get(running.controller.num_replicas.remote(),
                    timeout=30)
    out = {"status": "RUNNING",
           "deployment": running.deployment.name,
           "num_replicas": n}
    try:
        plane = ray_tpu_torch.get(running.controller.stats.remote(),
                            timeout=30)
        from .router import RequestRouter
        plane.update(
            RequestRouter.for_controller(running.controller)
            .snapshot())
        out["request_plane"] = plane
    except Exception:   # noqa: BLE001 — status must answer regardless
        pass
    return out


def _teardown(running: _Running) -> None:
    import ray_tpu_torch

    from .router import RequestRouter
    # root first (nothing routes into the children once it is gone),
    # then the graph's children; each router is discarded BEFORE its
    # controller dies so queued requests poison cleanly instead of
    # dispatching into a dead replica set
    for ctl in [running.controller] + \
            list(reversed(running.child_controllers)):
        try:
            RequestRouter.discard(ctl)
        except Exception:   # noqa: BLE001
            pass
        try:
            ray_tpu_torch.get(ctl.shutdown.remote(), timeout=30)
            ray_tpu_torch.kill(ctl)
        except Exception:   # noqa: BLE001 — already dead
            pass


def delete(name: str = "default") -> None:
    with _apps_lock:
        running = _apps.pop(name, None)
    if running is not None:
        ingress = _ingress_if_running()
        if running.route_prefix is not None and ingress is not None:
            ingress.remove_route(running.route_prefix, running.handle)
        _teardown(running)


def shutdown() -> None:
    """Tear down every app and the HTTP ingress (reference:
    ``serve.shutdown()``)."""
    global _ingress
    with _apps_lock:
        names = list(_apps)
    for n in names:
        delete(n)
    with _ingress_lock:
        if _ingress is not None:
            _ingress.shutdown()
            _ingress = None
