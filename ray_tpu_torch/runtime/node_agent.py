"""Worker-node agent: joins a remote machine's workers to a head.

Reference parity: ``ray start --address=<head>`` boots a worker node
whose raylet registers with the GCS and leases local worker processes to
the cluster over gRPC, with a per-node plasma store and an object
manager moving payloads between nodes directly (``NodeManagerService`` +
``src/ray/object_manager/`` — SURVEY.md §1 layers 2-4,6, §3.1, §3.3;
mount empty).  The rebuild keeps ALL scheduling/lease/env state in the
head process (the head's ``WorkerPool`` and ``Raylet`` run unchanged)
and makes the process transport AND the data plane remote:

    head                                  agent machine
    ----                                  -------------
    Raylet ── WorkerPool ── AgentSpawner ──TCP── NodeAgent ── pipe ── worker
      │ (control frames: by-REFERENCE descriptors)   │ arena+store (plane)
      └── PullManager ──(op_pull: src → dest direct)─┘

- The **agent** (``NodeAgent``) spawns ``worker_main`` processes locally
  (same ``LocalSpawner`` mechanics as the head) and shuttles their pipe
  frames to/from the head over the RPC plane.  It owns a LOCAL object
  store (arena + spill dir): its workers read plasma args zero-copy from
  the agent's arena; big task results/puts seal into it and only their
  METADATA rides to the head (``result_x``/``put_x`` frames).  Payload
  bytes move between machines over the object plane
  (``runtime/object_plane.py``) — source to destination directly, never
  through the head.
- The **head** (``AgentHub`` + ``AgentSpawner``) serves the agent's
  registration, creates a normal raylet row whose pool spawns through
  the agent, and routes incoming worker frames to virtual pipe
  connections.  The raylet runs with a ``plane_address``: exec/get
  frames carry ``("r", oid)`` descriptors that the agent resolves
  against its own arena before handing them to the worker.

An agent disconnect (process death, network drop) surfaces through the
RPC client's ``on_close`` and drives the existing ``remove_node`` drain:
running tasks retry elsewhere, objects whose only copy lived on the
agent recover via lineage or surface ``ObjectLostError`` — exactly like
a node death.

Limitation (v1, noted): runtime-env ``working_dir``/``py_modules``
staging paths live on the head's filesystem, so tasks with those envs
only resolve on agents sharing that filesystem.
"""

from __future__ import annotations

import logging
import os
import queue
import shutil
import tempfile
import threading
import uuid
from collections import deque

from ..common.ids import NodeID, ObjectID, TaskID
from .worker_pool import LocalSpawner
from ..common import clock as _clk

_LOG = logging.getLogger("ray_tpu_torch.node_agent")

_EOF = object()

# the head's add_node default — the register reply normally carries the
# effective resources, this is only the fallback for a headless boot
DEFAULT_NODE_RESOURCES = {"CPU": 2, "memory": 2}


def _lease_class_key(cu: dict) -> str:
    """Interned resource-class key: tasks with identical demand vectors
    share one leased budget (the repeat-class steady state the lease
    plane serves).  Shared by the agent's admission and the head's
    grant bookkeeping — both sides must intern identically."""
    return ",".join(f"{k}:{cu[k]}" for k in sorted(cu)) or "zero"


def _make_agent_arena(session_dir: str):
    """The agent machine's own arena (plasma analogue): /dev/shm when
    available, session dir otherwise — mirrors the head's
    ``cluster_utils._make_arena``, including reaping arenas left by
    crashed sessions (a SIGKILLed agent never runs ``_a_stop``; its
    /dev/shm file would otherwise leak RAM until reboot)."""
    from ..cluster_utils import reap_stale_arenas
    from ..common.config import get_config
    from ..native import Arena
    capacity = get_config().object_store_memory_mb * 1024 * 1024
    name = f"rt_arena_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    try:
        reap_stale_arenas("/dev/shm")
        return Arena(os.path.join("/dev/shm", name), capacity, create=True)
    except OSError:
        return Arena(os.path.join(session_dir, name), capacity,
                     create=True)


# ---------------------------------------------------------------------------
# agent process side
# ---------------------------------------------------------------------------

class NodeAgent:
    """The daemon on a worker machine: spawn + relay + local object
    plane + AUTONOMOUS LOCAL DISPATCH.  Frame relay stays dumb except
    where the data plane demands resolution (by-reference descriptors)
    or extraction (big payloads seal locally; metadata rides up).

    Raylet-per-host (VERDICT r04 missing #2, SURVEY §7 step 8): a
    worker here submitting ``f.remote()`` no longer pays a head
    round-trip per lease.  The agent keeps a LOCAL availability view
    (seeded from the register reply's resources; head-dispatched execs
    carry their demand vector as a stripped 7th frame element) and an
    observed per-worker state (ready/inflight/dedicated/env).  An
    eligible nested submission — DEFAULT strategy, no runtime_env,
    non-streaming, function bytes known, all ObjectRef args resident
    in the LOCAL arena, resources available, an idle local worker —
    dispatches straight to that worker from the pump thread.  Nothing
    blocks on the head: ownership/lineage metadata folds up on a
    BATCHED ``agent_sync`` (started specs + done results + live local
    load), which the head registers into its TaskManager/refcounter so
    gets, retries, lineage recovery, and node-death drain behave
    exactly as for head-dispatched tasks (the head reconciles return
    refs on registration to close the fire-and-forget decref race).
    Ineligible submissions relay to the head unchanged — the head's
    global batch kernel IS the spillback path.  Local gets of
    locally-resident plasma objects are served from the agent arena
    the same way (no head round-trip).

    ``ray.cancel`` reaches agent-leased tasks: the head seals the
    cancellation and completes its record first (so any in-flight
    done/retry sync is skipped), then asks the agent over ``a_cancel``
    to drop the queued entry or force-kill the running worker.

    Known v1 limits, by design: a local worker death hands the task
    BACK to the head with a ``retry`` disposition rather than retrying
    in place; transient resource oversubscription between the head's
    CRM and the local view is bounded by the worker pool (the same
    class of slack as ``force_subtract``)."""

    def __init__(self, head_address: str,
                 resources: dict[str, float] | None = None,
                 num_workers: int = 2,
                 labels: dict[str, str] | None = None,
                 host: str = "127.0.0.1", port: int = 0,
                 reconnect_timeout_s: float = 0.0,
                 standby_address: str | None = None):
        """``reconnect_timeout_s`` > 0 makes the agent survive a head
        restart: on link loss it retries the head address for that long
        and re-registers as a fresh node (local workers of the dead
        head's pool are reaped, the local store resets — the restarted
        head has no directory entries for it).  ``standby_address``
        names a hot-standby head (``runtime/standby.py``): on link loss
        the agent casts a head-down vote there, the quorum input that
        lets the standby promote within one probe interval instead of
        waiting out its own miss threshold."""
        from ..rpc import transport as _transport
        from .object_plane import ObjectPlane
        from .object_store import MemoryStore
        self._head_address = head_address
        self._standby_address = standby_address
        self._resources = resources
        self._num_workers = num_workers
        self._labels = labels
        self._reconnect_timeout = reconnect_timeout_s
        self._spawner = LocalSpawner()
        self._workers: dict[int, tuple] = {}    # index -> (proc, conn)
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._stopping = False
        self._reconnecting = False
        # registration epoch: pump threads of a PREVIOUS head's workers
        # must not relay frames/EOFs to the re-registered head (their
        # indices collide with the new pool's)
        self._epoch = 0
        # local object plane: own arena + spill dir
        self._session_dir = tempfile.mkdtemp(prefix="ray_tpu_agent_")
        self._arena = _make_agent_arena(self._session_dir)
        self.store = MemoryStore(
            arena=self._arena,
            spill_dir=os.path.join(self._session_dir, "spill"))
        self.plane = ObjectPlane(self.store)
        # descriptor pins handed to local workers: exec pins release at
        # the task's result/error frame; get-reply pin batches at the
        # worker's get_ack (FIFO — the single-threaded worker acks in
        # receive order), everything at worker EOF
        self._exec_pins: dict[tuple[int, bytes], list] = {}
        self._get_pins: dict[int, deque] = {}
        self._pin_lock = threading.Lock()
        # -- autonomous local dispatch state --------------------------------
        self._fast_enabled = False      # head policy (register reply)
        self._draining = False          # node DRAINING: no new local leases
        self._policy_pushed = False     # an a_policy push wins over a
        #                                 concurrently-computed register
        #                                 reply (job env landing mid-
        #                                 registration)
        self._view_lock = threading.Lock()
        self._totals_cu: dict[str, int] = {}
        self._avail_cu: dict[str, int] = {}
        # index -> {"ready","dedicated","env","inflight","fns"}
        self._w_state: dict[int, dict] = {}
        self._send_locks: dict[int, threading.Lock] = {}
        self._fn_cache: dict[str, bytes] = {}
        self._fn_fetching: set[str] = set()     # in-flight head fetches
        self._fn_uploaded: set[str] = set()     # bytes shipped headward
        self._head_tasks: dict[bytes, tuple] = {}   # tid -> (cu, index)
        self._local_tasks: dict[bytes, dict] = {}   # agent-leased
        # accepted-but-undispatched local leases (FIFO, the raylet's
        # dispatch queue): drains as workers/resources free; entries
        # older than the lease timeout hand back to the head
        self._local_queue: deque = deque()
        self._LOCAL_QUEUE_CAP = 1024
        # small local-task results CACHE (authority stays at the head,
        # which got the bytes in the done-sync): serves local gets of
        # tiny results without a head round-trip.  LRU-bounded; a miss
        # just relays, and a stale entry can only duplicate bytes the
        # id still names (ids are never reused for different values)
        self._small_cache: "dict[bytes, bytes]" = {}
        self._small_cache_order: deque = deque()
        self._small_cache_bytes = 0
        self._small_cache_lock = threading.Lock()   # pump threads race
        self._SMALL_CACHE_CAP = 32 << 20
        self._sync_lock = threading.Lock()
        # ONE ordered batch of ("refs"|"started"|"done", ...) entries:
        # a single stream preserves every intra-agent ordering the
        # head's counter fold depends on (a parent's incref for a
        # child's return is enqueued before that child's done entry,
        # so the head folds them in that order too)
        self._sync_batch: list = []
        self._sync_wake = threading.Event()
        self._sync_thread: threading.Thread | None = None
        # -- lease plane (ray_tpu_torch/leasing/): raylet-side grant authority.
        # Admission checks the epoch-stamped class budgets the head
        # leased to this node; a miss relays the submit to the head
        # (spillback) and rides the next sync as a lease request so the
        # rest of the fan-out fast-paths.  The fence horizon equals the
        # head's quiet-lease TTL: the node stops granting at or before
        # the moment the head revokes its epoch.
        from ..common.config import get_config
        cfg = get_config()
        self._lease = None
        self._lease_lock = threading.Lock()     # after _view_lock only
        self._lease_want: set[str] = set()
        self._last_sync_call = _clk.monotonic()
        self._msub_batches = 0
        self._msub_frames = 0
        self._msub_max = max(int(cfg.lease_submit_batch_max), 1)
        if cfg.lease_plane_enabled:
            from ..leasing import LocalLeaseCache, register_stats
            # capacity == the dispatch-queue bound: per-class budgets
            # (head-issued) are the binding admission limit; the
            # overcommit multiple of the queue cap is the backstop
            self._lease = LocalLeaseCache(
                capacity=self._LOCAL_QUEUE_CAP,
                fence_after_s=float(cfg.lease_ttl_s),
                overcommit=float(cfg.lease_overcommit),
                max_classes=int(cfg.lease_max_classes))
            self._lease.on_head_contact(_clk.monotonic())
            register_stats("agent", self._lease_stats)
        handlers = {
            "a_spawn": self._a_spawn,
            "a_send": self._a_send,
            "a_kill": self._a_kill,
            "a_stop": self._a_stop,
            "a_ping": lambda: "ok",
            "a_policy": self._a_policy,
            "a_cancel": self._a_cancel,
            "a_drain": self._a_drain,
        }
        handlers.update(self.plane.handlers())
        self.server = _transport.serve(handlers, host=host,
                                       port=port).start()
        self.plane.serve_address = self.server.address
        # head link: frames flow agent->head on this client; its loss
        # (head died) ends the agent — or, with reconnect enabled,
        # triggers the retry/re-register loop.  The INITIAL registration
        # retries under the same budget: a head dying mid-register must
        # not strand a reconnect-enabled agent
        deadline = _clk.monotonic() + max(reconnect_timeout_s, 0.0)
        self._reconnecting = True   # a mid-register drop must not fork
        try:                        # a racing reconnect loop
            while True:
                try:
                    # agent_fn (function-bytes fetch) is an idempotent
                    # read: let it ride out gray head links with retry
                    self._head = _transport.connect(head_address,
                                           on_close=self._on_head_lost,
                                           retryable=frozenset(
                                               {"agent_fn"}))
                    self.agent_id = NodeID.from_random().hex()
                    reply = self._head.call(
                        "agent_register", self.agent_id,
                        self.server.address, resources, num_workers,
                        labels, True, timeout=120.0)
                    self._apply_register_reply(reply, resources)
                    break
                except Exception:
                    if _clk.monotonic() >= deadline:
                        raise
                    with self._lock:    # epoch bump quiets stale pumps
                        self._epoch += 1
                        self._workers.clear()
                    _clk.sleep(1.0)
        finally:
            with self._lock:
                self._reconnecting = False
        self._sync_thread = threading.Thread(
            target=self._sync_loop, daemon=True, name="agent-sync")
        self._sync_thread.start()

    def _apply_register_reply(self, reply, resources) -> None:
        """Register reply: dict with the node's EFFECTIVE resources and
        the head's fast-path policy (a bare node-id hex from an older
        head keeps autonomy off)."""
        from ..common.resources import ResourceRequest
        if isinstance(reply, dict):
            self.node_id_hex = reply["node_id"]
            eff = reply.get("resources") or resources \
                or DEFAULT_NODE_RESOURCES
            fast = bool(reply.get("fast_path", False))
        else:
            self.node_id_hex = reply
            eff = resources or DEFAULT_NODE_RESOURCES
            fast = False
        cu = ResourceRequest(eff).cu()
        with self._view_lock:
            self._totals_cu = dict(cu)
            self._avail_cu = dict(cu)
        if not self._policy_pushed:
            # a push that raced in DURING registration is newer than
            # the reply's snapshot — don't overwrite it
            self._fast_enabled = fast
        lease = reply.get("lease") if isinstance(reply, dict) else None
        if self._lease is not None and lease is not None:
            with self._lease_lock:
                self._lease.on_head_contact(_clk.monotonic())
                epoch = int(lease.get("epoch", 0))
                self._lease.observe_epoch(epoch)
                self._lease.install(lease.get("grants") or {}, epoch)

    def _lease_stats(self) -> dict:
        """The node-side half of the observability satellite: lease
        cache counters + the pump's multi-submit batching counters."""
        s = self._lease.stats() if self._lease is not None else {}
        s["submit_batches"] = self._msub_batches
        s["submit_batched_frames"] = self._msub_frames
        return s

    def _lease_release(self, entry: dict) -> None:
        """A locally-admitted entry left the local system (done, error,
        handback): return its class admission.  Pop-once: every exit
        path may call this safely."""
        ck = entry.pop("lease_ck", None)
        if ck is not None and self._lease is not None:
            with self._lease_lock:
                self._lease.release(ck)

    def _a_policy(self, policy: dict) -> bool:
        """Head policy push (e.g. a job-level runtime_env appearing
        gates the env-blind fast path off)."""
        self._policy_pushed = True
        self._fast_enabled = bool(policy.get("fast_path", False))
        return True

    def _a_drain(self) -> int:
        """Node is DRAINING: stop leasing locally and hand every
        accepted-but-undispatched task back to the head for global
        placement ("requeue" — never ran, no retry consumed).  Tasks a
        worker is already RUNNING finish normally and report through
        the usual done-sync.  Returns how many were handed back."""
        self._draining = True
        with self._view_lock:
            handed = list(self._local_queue)
            self._local_queue.clear()
        for e in handed:
            self._finish_local(e, None, None, None, "requeue")
        return len(handed)

    # -- head failover -------------------------------------------------------
    def _vote_standby(self) -> None:
        """The head link dropped: cast a head-down vote at the hot
        standby (``runtime/standby.py``).  One agent vote plus the
        standby's own failed probe is enough to promote — sub-
        heartbeat failover instead of waiting out the miss threshold.
        Best-effort: no standby configured / reachable, no vote."""
        if not self._standby_address:
            return
        from ..rpc import transport as _transport
        try:
            c = _transport.connect(self._standby_address)
            try:
                c.call("standby_vote", getattr(self, "agent_id", ""),
                       timeout=5.0)
            finally:
                c.close()
        except Exception:   # noqa: BLE001 — standby gone too: the
            pass            # reconnect loop still covers recovery

    def _on_head_lost(self) -> None:
        if self._standby_address and not self._stopping:
            threading.Thread(target=self._vote_standby, daemon=True,
                             name="agent-standby-vote").start()
        if self._stopping or self._reconnect_timeout <= 0:
            self._stop_event.set()
            return
        with self._lock:
            if self._reconnecting:
                return      # one loop at a time: a client that drops
            self._reconnecting = True   # mid-register must not fork a
            #                             racing second registration
        threading.Thread(target=self._reconnect_loop, daemon=True,
                         name="agent-reconnect").start()

    def _reconnect_loop(self) -> None:
        """The head died: reap the dead pool's local workers, reset the
        local store (the restarted head has no directory rows for it),
        and re-register as a fresh node until the timeout lapses."""
        from ..rpc import transport as _transport
        deadline = _clk.monotonic() + self._reconnect_timeout
        # new epoch FIRST: surviving pump threads of the dead head's
        # workers go quiet instead of relaying colliding indices
        with self._lock:
            self._epoch += 1
            workers = list(self._workers.values())
            self._workers.clear()
        for proc, conn in workers:
            try:
                proc.terminate()
            except Exception:   # noqa: BLE001 — keep reaping the rest
                _LOG.debug("terminating stale worker failed",
                           exc_info=True)
        with self._pin_lock:
            self._exec_pins.clear()
            self._get_pins.clear()
        self._reset_autonomy_state()
        self.store.delete([oid for oid, _s, _k
                           in self.store.list_objects()])
        try:
            while _clk.monotonic() < deadline and not self._stopping:
                head = None
                try:
                    head = _transport.connect(self._head_address,
                                     on_close=self._on_head_lost,
                                     retryable=frozenset({"agent_fn"}))
                    # install the link BEFORE registering: the register
                    # call blocks on worker-ready frames, which the new
                    # pump threads relay through self._head/agent_id
                    self._head = head
                    self.agent_id = NodeID.from_random().hex()
                    reply = self._head.call(
                        "agent_register", self.agent_id,
                        self.server.address, self._resources,
                        self._num_workers, self._labels, True,
                        timeout=120.0)
                    self._apply_register_reply(reply, self._resources)
                    return      # rejoined
                except Exception:   # noqa: BLE001 — head still down
                    if head is not None:
                        head.close()
                    _clk.sleep(1.0)
            self._stop_event.set()
        finally:
            with self._lock:
                self._reconnecting = False

    def _reset_autonomy_state(self) -> None:
        """Head gone/replaced: agent-leased tasks can never report
        their done-sync — drop them (the head's drain fails/retries
        registered ones, exactly like node death)."""
        self._fast_enabled = False
        self._draining = False      # a fresh head re-decides the drain
        self._policy_pushed = False     # fresh head: fresh policy
        with self._sync_lock:
            self._sync_batch.clear()
        entries = list(self._local_tasks.values())
        self._local_tasks.clear()
        with self._view_lock:
            queued = list(self._local_queue)
            self._local_queue.clear()
            self._lease_want.clear()
        for e in entries:
            self.store.unpin(e["pins"])
        for e in entries:
            self._lease_release(e)
        for e in queued:
            self._lease_release(e)
        self._head_tasks.clear()
        self._fn_uploaded.clear()       # the new head has a fresh registry
        with self._small_cache_lock:
            self._small_cache.clear()
            self._small_cache_order.clear()
            self._small_cache_bytes = 0
        with self._view_lock:
            self._avail_cu = dict(self._totals_cu)
        self._w_state.clear()

    def wait_for_shutdown(self, timeout: float | None = None) -> bool:
        return self._stop_event.wait(timeout)

    def stop(self) -> None:
        self._stopping = True
        try:
            self._head.call("agent_bye", self.agent_id, timeout=5.0)
        except Exception:       # noqa: BLE001 — head may already be gone
            pass
        self._a_stop()

    # -- RPC handlers (called by the head) ----------------------------------
    def _a_spawn(self, index: int, env_payload: dict | None) -> int:
        """Spawn a local worker attached to the AGENT's arena; returns
        its real pid (0 = failed)."""
        proc, conn = self._spawner.spawn(index, self._arena.path,
                                         env_payload)
        with self._lock:
            self._workers[index] = (proc, conn)
            epoch = self._epoch
            self._send_locks.setdefault(index, threading.Lock())
            self._w_state[index] = {"ready": False, "dedicated": False,
                                    "env": env_payload is not None,
                                    "inflight": 0, "fns": set()}
        threading.Thread(target=self._pump, args=(index, conn, epoch),
                         daemon=True, name=f"agent-pump-{index}").start()
        return proc.pid or 0

    def _send_to_worker(self, index: int, msg) -> bool:
        """Serialized pipe write: head-relayed frames (``a_send``
        handler threads) and agent-local dispatch (pump threads) both
        target the same worker conn."""
        with self._lock:
            entry = self._workers.get(index)
            lock = self._send_locks.setdefault(index, threading.Lock())
        if entry is None:
            return False
        with lock:
            try:
                entry[1].send(msg)
                return True
            except (OSError, BrokenPipeError):
                return False

    def _a_send(self, index: int, msg) -> bool:
        with self._lock:
            entry = self._workers.get(index)
        if entry is None:
            return False
        original = msg
        try:
            msg = self._rewrite_down(index, msg)
            if msg is None:
                return True     # swallowed: the error frame went up
        except Exception:   # noqa: BLE001 — unexpected surgery failure:
            msg = original      # forward as-is; the worker surfaces an
            #                     unresolved-descriptor error, not a hang
        if self._send_to_worker(index, msg):
            return True
        self._release_frame_pins(index, msg)
        return False

    def _a_kill(self, index: int) -> None:
        with self._lock:
            entry = self._workers.get(index)
        if entry is not None:
            try:
                entry[0].terminate()
            except Exception:   # noqa: BLE001
                pass

    def _a_stop(self) -> str:
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for proc, conn in workers:
            try:
                conn.send(("shutdown",))
            except (OSError, BrokenPipeError):
                pass
        for proc, conn in workers:
            proc.join(timeout=2.0)
            if proc.is_alive():
                proc.terminate()
            try:
                conn.close()
            except Exception:   # noqa: BLE001
                pass
        self.plane.shutdown()
        try:
            self._arena.close()
        except Exception:       # noqa: BLE001
            pass
        if self._lease is not None:
            from ..leasing import unregister_stats
            unregister_stats("agent")
        shutil.rmtree(self._session_dir, ignore_errors=True)
        self._stop_event.set()
        return "stopping"

    # -- data-plane frame surgery -------------------------------------------
    def _rewrite_down(self, index: int, msg):
        """Head->worker: resolve by-reference descriptors against the
        LOCAL store (pin for the read's duration) and OBSERVE the
        frame stream for the autonomy state (fn cache, per-worker
        inflight, dedicated marking, resource debits).  Returns the
        frame to forward, or None to swallow it (resolution failure
        already sent an error frame up)."""
        kind = msg[0]
        state = self._w_state.get(index)
        if kind == "fn":
            self._fn_cache[msg[1]] = msg[2]
            if state is not None:
                state["fns"].add(msg[1])
        elif kind in ("actor_new", "actor_call"):
            if state is not None:
                state["dedicated"] = True
        elif kind == "exec":
            if len(msg) == 7:
                # plane frame: the head appended the task's demand cu
                # dict — strip it (workers know nothing of it) and
                # debit the local availability view until the result
                cu = msg[6]
                msg = msg[:6]
                if state is not None:
                    with self._lock:    # inflight is multi-thread RMW
                        state["inflight"] += 1
                self._head_tasks[msg[1]] = (cu, index)
                with self._view_lock:
                    for k, v in (cu or {}).items():
                        self._avail_cu[k] = self._avail_cu.get(k, 0) - v
            elif state is not None:
                with self._lock:
                    state["inflight"] += 1
        if kind == "exec" and len(msg) == 6 and msg[5]:
            extern, pins = [], []
            try:
                for d in msg[5]:
                    if d[0] == "r":
                        desc = self.store.descriptor_of(ObjectID(d[1]))
                        if desc[0] == "s":
                            pins.append((ObjectID(d[1]), desc[1]))
                        extern.append(desc)
                    else:
                        extern.append(d)
            except KeyError:
                self.store.unpin(pins)
                self._credit_head_task(msg[1])
                self._send_error_up(
                    index, msg[1],
                    "task arg is not resident on this node's object "
                    "plane (transfer failed or the object was freed)")
                return None
            if pins:
                with self._pin_lock:
                    self._exec_pins[(index, msg[1])] = pins
            return msg[:5] + (extern,)
        if kind == "get_reply_x" and msg[1] == "ok":
            descs, pins = [], []
            for d in msg[2]:
                if d[0] == "r":
                    try:
                        desc = self.store.descriptor_of(ObjectID(d[1]))
                    except KeyError:
                        from .object_store import ObjectLostError
                        from .serialization import RayTaskError, serialize
                        desc = ("vb", serialize(RayTaskError(
                            "get", "object vanished from the local "
                            "plane", ObjectLostError(d[1].hex()))))
                    if desc[0] == "s":
                        pins.append((ObjectID(d[1]), desc[1]))
                    descs.append(desc)
                else:
                    descs.append(d)
            if pins:
                with self._pin_lock:
                    self._get_pins.setdefault(index,
                                              deque()).append(pins)
            return (msg[0], msg[1], descs)
        return msg

    def _rewrite_up(self, index: int, msg):
        """Worker->head: big payloads seal into the LOCAL store and only
        metadata rides up; pin releases ride the task lifecycle.
        Returns None to SWALLOW a frame the agent fully handled
        (autonomous dispatch, locally-served gets)."""
        kind = msg[0]
        if kind == "ready":
            state = self._w_state.get(index)
            if state is not None:
                state["ready"] = True
            self._drain_local_queue()
        elif kind == "submit":
            # ("submit", spec_bytes, fn_id, fn_bytes): the autonomy
            # fast path — dispatch locally with NO head round-trip
            # when eligible; relay for global placement otherwise
            try:
                if self._try_local_dispatch(index, msg[1], msg[2],
                                            msg[3]):
                    return None
            except Exception:   # noqa: BLE001 — fast path must never
                pass            # drop a submission; fall through
            return msg
        elif kind == "refs":
            # coalesce ref-count batches into the sync stream instead
            # of one head call per flush: a tiny-task fan-out's pump
            # thread must not serialize on a head RTT between a refs
            # frame and the submit frame behind it
            with self._sync_lock:
                self._sync_batch.append(("refs", index, msg[1]))
            self._sync_wake.set()
            return None
        elif kind in ("result", "error") and msg[1] in self._local_tasks:
            try:
                self._on_local_done(index, msg)
            except Exception:   # noqa: BLE001 — a failed completion
                # hand the task back to the head as a retry rather
                # than losing it
                entry = self._local_tasks.pop(msg[1], None)
                if entry is not None:
                    self.store.unpin(entry["pins"])
                    self._finish_local(entry, None, None, None, "retry")
            return None
        elif kind == "get":
            served = self._try_local_get(index, msg)
            if served:
                return None
            return msg
        if kind in ("result", "actor_result"):
            if kind == "result":
                self._credit_head_task(msg[1])
            self._release_exec_pins(index, msg[1])
            tid = TaskID(msg[1])
            descs, any_big = [], False
            for i, data in enumerate(msg[2]):
                if len(data) > self.store._threshold:
                    oid = ObjectID.for_task_return(tid, i + 1)
                    self.store.put_serialized(oid, data)
                    k, size = self.store.plasma_info(oid)
                    if k in ("shm", "spill"):
                        descs.append(("p", oid.binary(), size))
                        any_big = True
                        continue
                    # store-full in-band fallback: bytes ride up
                descs.append(("v", data))
            if any_big:
                # trailing elements (contained-ref lists) pass through
                return (kind + "_x", msg[1], descs) + tuple(msg[3:])
            return msg
        if kind in ("error", "actor_error"):
            if kind == "error":
                self._credit_head_task(msg[1])
            self._release_exec_pins(index, msg[1])
            return msg
        if kind == "stream_item":
            # ("stream_item", tid, idx, payload, contained): big items
            # seal into the LOCAL arena; metadata rides up
            if len(msg[3]) > self.store._threshold:
                oid = ObjectID.for_task_return(TaskID(msg[1]), msg[2])
                self.store.put_serialized(oid, msg[3])
                k, size = self.store.plasma_info(oid)
                if k in ("shm", "spill"):
                    return ("stream_item_x", msg[1], msg[2],
                            ("p", oid.binary(), size), msg[4])
            return msg
        if kind == "put":
            if len(msg[2]) > self.store._threshold:
                oid = ObjectID(msg[1])
                self.store.put_serialized(oid, msg[2])
                k, size = self.store.plasma_info(oid)
                if k in ("shm", "spill"):
                    return ("put_x", msg[1], size) + tuple(msg[3:])
            return msg
        if kind == "get_ack":
            with self._pin_lock:
                dq = self._get_pins.get(index)
                batch = dq.popleft() if dq else None
            if batch:
                self.store.unpin(batch)
            # swallowed: the head never tracks pins for plane workers
            # (their s-descriptors are all resolved HERE), so the ack
            # is purely local — relaying it is a wasted head frame
            return None
        return msg

    def _send_error_up(self, index: int, task_id_bin: bytes,
                       message: str) -> None:
        from .serialization import RayTaskError, serialize
        try:
            self._head.call(
                "agent_frame", self.agent_id, index,
                ("error", task_id_bin,
                 serialize(RayTaskError("task", message))))
        except Exception:       # noqa: BLE001 — head gone
            pass

    def _release_exec_pins(self, index: int, task_id_bin: bytes) -> None:
        with self._pin_lock:
            pins = self._exec_pins.pop((index, task_id_bin), None)
        if pins:
            self.store.unpin(pins)

    def _credit_head_task(self, tid_bin: bytes) -> None:
        """A head-dispatched task finished (or will never run): return
        its demand to the local view, drop the worker's inflight."""
        entry = self._head_tasks.pop(tid_bin, None)
        if entry is None:
            return
        cu, index = entry
        with self._lock:
            state = self._w_state.get(index)
            if state is not None and state["inflight"] > 0:
                state["inflight"] -= 1
        with self._view_lock:
            for k, v in (cu or {}).items():
                self._avail_cu[k] = self._avail_cu.get(k, 0) + v
        self._drain_local_queue()       # a worker/resources just freed

    def _release_frame_pins(self, index: int, msg) -> None:
        """A rewritten frame failed to send: release the pins it carried
        (its ack/result will never come)."""
        kind = msg[0]
        if kind == "exec":
            self._release_exec_pins(index, msg[1])
            self._credit_head_task(msg[1])
        elif kind == "get_reply_x":
            with self._pin_lock:
                dq = self._get_pins.get(index)
                batch = dq.pop() if dq else None
            if batch:
                self.store.unpin(batch)

    def _release_index_pins(self, index: int) -> None:
        """Worker died/exited: every descriptor it held is dead."""
        with self._pin_lock:
            pins = []
            for key in [k for k in self._exec_pins if k[0] == index]:
                pins.extend(self._exec_pins.pop(key))
            for batch in self._get_pins.pop(index, ()):
                pins.extend(batch)
        if pins:
            self.store.unpin(pins)

    # -- autonomous local dispatch ------------------------------------------
    def _try_local_dispatch(self, submitter: int, spec_bytes: bytes,
                            fn_id: str, fn_bytes) -> bool:
        """ACCEPT a nested submission for local execution: eligible
        tasks enter the agent's FIFO dispatch queue (registered at the
        head via the started-sync) and drain as workers/resources
        free.  Returns True when the task was taken (the submit frame
        must then be swallowed); False relays it to the head for
        global placement."""
        if not self._fast_enabled or self._draining:
            return False
        sub = self._w_state.get(submitter)
        if sub is None or sub["env"] or sub["dedicated"]:
            # env/actor parents imply runtime-env inheritance the
            # agent cannot evaluate — the head merges those
            return False
        if fn_bytes is None and fn_id not in self._fn_cache:
            # a stub submission (bytes live only in the head's fn
            # registry): relay THIS one, but fetch the bytes in the
            # background so the rest of the fan-out fast-paths —
            # one head round-trip per function EVER, off every
            # dispatch path
            self._fetch_fn_async(fn_id)
            return False
        from ..common.task_spec import SchedulingStrategyKind
        from .object_ref import ObjectRef
        from .serialization import deserialize
        spec = deserialize(spec_bytes)
        if spec.strategy.kind is not SchedulingStrategyKind.DEFAULT \
                or spec.runtime_env or spec.num_returns < 0 \
                or getattr(spec, "max_calls", 0) > 0:
            # max_calls recycling is head-pool bookkeeping: relay
            return False
        from .object_store import PLASMA_KINDS
        for a in spec.args:
            if isinstance(a, ObjectRef):
                kind, _ = self.store.plasma_info(a.id)
                if kind not in PLASMA_KINDS:
                    return False    # not locally materializable
        cu = spec.resources.cu()
        with self._view_lock:
            if len(self._local_queue) >= self._LOCAL_QUEUE_CAP:
                return False
            for k, v in cu.items():
                if self._totals_cu.get(k, 0) < v:
                    return False    # infeasible here, ever
            ck = None
            if self._lease is not None:
                # the lease-plane admission proper: grant locally only
                # inside the epoch-stamped budget the head leased for
                # this class; a miss SPILLS BACK (the relayed submit
                # is the spillback) and requests the class on the next
                # sync so the rest of the fan-out fast-paths
                ck = _lease_class_key(cu)
                with self._lease_lock:
                    granted = self._lease.try_grant(ck,
                                                    _clk.monotonic())
                if not granted:
                    if len(self._lease_want) < 256:
                        self._lease_want.add(ck)
                    self._sync_wake.set()
                    return False
            entry = {"spec": spec, "spec_bytes": spec_bytes,
                     "fn_id": fn_id, "fn_bytes": fn_bytes,
                     "submitter": submitter, "cu": cu,
                     "lease_ck": ck, "enq": _clk.monotonic()}
            # started rides the sync BEFORE any dispatch: the result
            # can arrive arbitrarily fast, and its done entry must
            # never reach the head in a flush preceding registration.
            # Worker-defined functions' bytes ride along ONCE per fn —
            # the head's registry must stay complete (retries and
            # lineage reconstruction resolve fn_id there) even though
            # the submit frame that carried them was swallowed
            up_bytes = None
            if fn_bytes is not None and fn_id not in self._fn_uploaded:
                self._fn_uploaded.add(fn_id)
                up_bytes = fn_bytes
            with self._sync_lock:
                self._sync_batch.append(
                    ("started", spec_bytes, submitter, fn_id,
                     up_bytes))
            self._local_queue.append(entry)
        self._sync_wake.set()
        # the task is ACCEPTED from here on: a drain hiccup must not
        # unwind the accept (the caller would relay the submit and the
        # task would run twice) — the queue drains on the next trigger
        try:
            self._drain_local_queue()
        except Exception:   # noqa: BLE001
            pass
        return True

    def _a_cancel(self, tid_bin: bytes, force: bool) -> str:
        """Head-initiated cancel of an agent-leased task.  The head
        already sealed the cancellation error and completed the record
        — here we only stop the wasted work: drop a queued entry, or
        (force) kill the worker running it (its death handback finds
        the record done at the head and is skipped)."""
        with self._view_lock:
            for e in list(self._local_queue):
                if e["spec"].task_id.binary() == tid_bin:
                    self._local_queue.remove(e)
                    self._lease_release(e)
                    return "dequeued"
        entry = self._local_tasks.get(tid_bin)
        if entry is None:
            # dispatch window: the drain popped the queue entry but
            # has not inserted the running record yet — re-check once
            _clk.sleep(0.1)
            entry = self._local_tasks.get(tid_bin)
            if entry is None:
                return "unknown"
        if force:
            self._a_kill(entry["index"])
            return "killed"
        return "running"

    def _fetch_fn_async(self, fn_id: str) -> None:
        with self._lock:
            if fn_id in self._fn_fetching or fn_id in self._fn_cache:
                return
            self._fn_fetching.add(fn_id)

        def run() -> None:
            try:
                data = self._head.call("agent_fn", fn_id, timeout=30.0)
                if data is not None:
                    self._fn_cache[fn_id] = data
            except Exception:   # noqa: BLE001 — head gone/slow: the
                pass            # next stub submission retries
            finally:
                with self._lock:
                    self._fn_fetching.discard(fn_id)
        threading.Thread(target=run, daemon=True,
                         name=f"agent-fn-{fn_id[:8]}").start()

    def _drain_local_queue(self) -> None:
        """Dispatch queued local leases FIFO while a default worker is
        idle and the head entry's resources are available (strict FIFO:
        a head that cannot fit parks the queue, the same fairness the
        head raylet's class buckets give)."""
        while True:
            with self._view_lock:
                if not self._local_queue:
                    return
                entry = self._local_queue[0]
                cu = entry["cu"]
                for k, v in cu.items():
                    if self._avail_cu.get(k, 0) < v:
                        return
                windex = None
                with self._lock:
                    for i, st in self._w_state.items():
                        if st["ready"] and not st["dedicated"] \
                                and not st["env"] \
                                and st["inflight"] == 0 \
                                and i in self._workers:
                            windex = i
                            break
                    if windex is None:
                        return
                    self._w_state[windex]["inflight"] += 1
                for k, v in cu.items():
                    self._avail_cu[k] = self._avail_cu.get(k, 0) - v
                self._local_queue.popleft()
            try:
                ok = self._dispatch_now(entry, windex)
            except Exception:   # noqa: BLE001 — a failed dispatch must
                ok = False      # undo its lease, never leak it
            if not ok:
                # worker vanished / args freed: undo the lease and hand
                # the (already-registered) task back to the head —
                # "requeue" re-enters global scheduling without
                # consuming a retry attempt (the task never ran)
                with self._view_lock:
                    with self._lock:
                        st = self._w_state.get(windex)
                        if st is not None and st["inflight"] > 0:
                            st["inflight"] -= 1
                    for k, v in entry["cu"].items():
                        self._avail_cu[k] = self._avail_cu.get(k, 0) + v
                self._finish_local(entry, None, None, None, "requeue")

    def _dispatch_now(self, entry: dict, windex: int) -> bool:
        from .object_ref import ObjectRef
        from .serialization import serialize
        from .worker import ArgRef
        spec, fn_id = entry["spec"], entry["fn_id"]
        args, pins = [], []
        try:
            for a in spec.args:
                if isinstance(a, ObjectRef):
                    desc = self.store.descriptor_of(a.id)
                    if desc[0] == "s":
                        pins.append((a.id, desc[1]))
                    args.append(ArgRef(desc))
                else:
                    args.append(a)
        except KeyError:        # freed between accept and dispatch
            self.store.unpin(pins)
            return False
        state = self._w_state.get(windex)
        if state is not None and fn_id not in state["fns"]:
            data = entry["fn_bytes"] if entry["fn_bytes"] is not None \
                else self._fn_cache.get(fn_id)
            if data is None or not self._send_to_worker(
                    windex, ("fn", fn_id, data)):
                self.store.unpin(pins)
                return False
            state["fns"].add(fn_id)
            self._fn_cache.setdefault(fn_id, data)
        payload = serialize((tuple(args), spec.kwargs,
                             spec.num_returns))
        tid_bin = spec.task_id.binary()
        entry["index"] = windex
        entry["pins"] = pins
        self._local_tasks[tid_bin] = entry
        if not self._send_to_worker(
                windex, ("exec", tid_bin, fn_id, payload,
                         spec.trace_ctx, None)):
            self._local_tasks.pop(tid_bin, None)
            self.store.unpin(pins)
            return False
        return True

    def _on_local_done(self, index: int, msg) -> None:
        """Terminal frame of an agent-leased task: seal big returns
        into the LOCAL arena, queue the metadata for the batched
        done-sync, free the lease."""
        kind, tid_bin = msg[0], msg[1]
        entry = self._local_tasks.pop(tid_bin, None)
        if entry is None:
            return
        self.store.unpin(entry["pins"])
        with self._lock:
            st = self._w_state.get(entry["index"])
            if st is not None and st["inflight"] > 0:
                st["inflight"] -= 1
        with self._view_lock:
            for k, v in entry["cu"].items():
                self._avail_cu[k] = self._avail_cu.get(k, 0) + v
        if kind == "error":
            self._finish_local(entry, None, None, msg[2], "error")
            self._drain_local_queue()
            return
        try:
            tid = TaskID(tid_bin)
            descs = []
            for i, data in enumerate(msg[2]):
                oid = ObjectID.for_task_return(tid, i + 1)
                if len(data) > self.store._threshold:
                    self.store.put_serialized(oid, data)
                    k, size = self.store.plasma_info(oid)
                    if k in ("shm", "spill"):
                        descs.append(("p", oid.binary(), size))
                        continue
                self._small_cache_put(oid.binary(), data)
                descs.append(("v", data))
            self._finish_local(entry, descs,
                               msg[3] if len(msg) > 3 else None, None,
                               "done")
        except Exception:   # noqa: BLE001 — seal failure (arena+spill
            # exhausted, ...): the entry is already popped, so the
            # handback must happen HERE or the head record never
            # completes and the caller hangs
            self._finish_local(entry, None, None, None, "retry")
        self._drain_local_queue()

    def _finish_local(self, entry, descs, contained, err_bytes,
                      disposition: str) -> None:
        self._lease_release(entry)
        with self._sync_lock:
            self._sync_batch.append(
                ("done", entry["spec"].task_id.binary(), descs,
                 contained, err_bytes, disposition))
        self._sync_wake.set()

    def _on_worker_gone(self, index: int) -> None:
        """A local worker died/exited: hand its agent-leased tasks back
        to the head (retry disposition — the head's TaskManager owns
        the attempt budget) and credit its head-task debits."""
        lost = [tid for tid, e in list(self._local_tasks.items())
                if e["index"] == index]
        for tid_bin in lost:
            entry = self._local_tasks.pop(tid_bin, None)
            if entry is None:
                continue
            self.store.unpin(entry["pins"])
            with self._view_lock:
                for k, v in entry["cu"].items():
                    self._avail_cu[k] = self._avail_cu.get(k, 0) + v
            self._finish_local(entry, None, None, None, "retry")
        for tid_bin in [t for t, (_cu, i) in list(self._head_tasks.items())
                        if i == index]:
            self._credit_head_task(tid_bin)

    def _small_cache_put(self, oid_bin: bytes, data: bytes) -> None:
        if len(data) > self.store._threshold:
            return      # not small: the arena/spill already holds it
        with self._small_cache_lock:
            if oid_bin in self._small_cache:
                return
            self._small_cache[oid_bin] = data
            self._small_cache_order.append(oid_bin)
            self._small_cache_bytes += len(data)
            while self._small_cache_bytes > self._SMALL_CACHE_CAP and \
                    self._small_cache_order:
                old = self._small_cache_order.popleft()
                dropped = self._small_cache.pop(old, None)
                if dropped is not None:
                    self._small_cache_bytes -= len(dropped)

    def _try_local_get(self, index: int, msg) -> bool:
        """Serve a worker's get entirely from this machine when every
        requested object is plasma-resident in the local arena OR a
        cached small local-task result (the data is already here — a
        head round-trip would only copy the descriptor path)."""
        from .object_store import PLASMA_KINDS
        oids = [ObjectID(b) for b in msg[1]]
        if not oids:
            return False
        descs, pins = [], []
        try:
            for o in oids:
                small = self._small_cache.get(o.binary())
                if small is not None:
                    descs.append(("b", small))
                    continue
                kind, _ = self.store.plasma_info(o)
                if kind not in PLASMA_KINDS:
                    self.store.unpin(pins)
                    return False
                desc = self.store.descriptor_of(o)
                if desc[0] != "s":
                    self.store.unpin(pins)
                    return False
                pins.append((o, desc[1]))
                descs.append(desc)
        except KeyError:
            self.store.unpin(pins)
            return False
        if pins:
            # pin batches enter the FIFO only when the reply carries
            # "s" descriptors — the worker acks exactly those replies
            with self._pin_lock:
                self._get_pins.setdefault(index, deque()).append(pins)
        if not self._send_to_worker(index,
                                    ("get_reply_x", "ok", descs)):
            if pins:
                with self._pin_lock:
                    dq = self._get_pins.get(index)
                    if dq and dq[-1] is pins:
                        dq.pop()
                self.store.unpin(pins)
            return False
        return True

    # -- batched head sync ---------------------------------------------------
    def _sync_loop(self) -> None:
        """Ship started/done/load batches to the head: amortized (a
        2 ms coalescing window after the first append) so a fan-out of
        N local leases costs O(1) head frames, not O(N)."""
        while not self._stopping and not self._stop_event.is_set():
            if self._sync_wake.wait(timeout=0.5):
                _clk.sleep(0.002)       # coalesce a burst
                self._sync_wake.clear()
            # stale local leases (queued past the lease timeout behind
            # blocked/busy workers) spill back to the head for global
            # placement — the raylet's stale-lease spillback, agent-
            # side.  Runs on EVERY tick including wake timeouts: a
            # stranded queue with no further sync traffic is exactly
            # the case that must still spill
            from ..common.config import get_config
            stale_after = get_config().worker_lease_timeout_ms / 1000.0
            now = _clk.monotonic()
            stale = []
            with self._view_lock:
                while self._local_queue and \
                        now - self._local_queue[0]["enq"] > stale_after:
                    stale.append(self._local_queue.popleft())
            for e in stale:
                self._finish_local(e, None, None, None, "requeue")
            with self._sync_lock:
                batch = self._sync_batch
                self._sync_batch = []
            want = None
            if self._lease is not None:
                with self._view_lock:
                    if self._lease_want:
                        want = sorted(self._lease_want)
                        self._lease_want.clear()
                if want is None and not batch and \
                        now - self._last_sync_call > \
                        self._lease.fence_after_s / 3.0:
                    # lease keepalive: a fenced cache spills EVERYTHING,
                    # so an idle agent still confirms head contact well
                    # inside the fence horizon (and folds fresh
                    # grants/epochs while it's there)
                    want = []
            if not batch and want is None:
                continue
            load: dict[str, int] = {}
            for e in list(self._local_tasks.values()):
                for k, v in e["cu"].items():
                    load[k] = load.get(k, 0) + v
            try:
                reply = self._head.call("agent_sync", self.agent_id,
                                        batch, load, want)
                self._last_sync_call = _clk.monotonic()
                self._fold_sync_reply(reply)
            except Exception:   # noqa: BLE001 — head gone: the
                # on_close/reconnect flow owns cleanup; log so a sync
                # silently failing for OTHER reasons is visible
                _LOG.debug("agent_sync to head failed", exc_info=True)

    def _fold_sync_reply(self, reply) -> None:
        """Lease half of the sync reply: a confirmed head contact, the
        node's current epoch, and fresh grants.  An epoch ADVANCE means
        the head revoked this node's grant set (quiet lease / drain /
        re-admission): the head has already requeued everything it
        registered, so locally-queued not-yet-started grants hand back
        for global placement rather than running under a dead epoch."""
        if self._lease is None or not isinstance(reply, dict):
            return
        epoch = int(reply.get("epoch", 0))
        with self._lease_lock:
            self._lease.on_head_contact(_clk.monotonic())
            revoked = self._lease.observe_epoch(epoch)
            grants = reply.get("grants")
            if grants:
                self._lease.install(grants, epoch)
        if revoked:
            with self._view_lock:
                handed = list(self._local_queue)
                self._local_queue.clear()
            for e in handed:
                e.pop("lease_ck", None)     # epoch bump zeroed budgets
                self._finish_local(e, None, None, None, "requeue")

    # -- worker->head pump ---------------------------------------------------
    def _relay_up(self, index: int, frames: list) -> bool:
        """Relay rewritten frames to the head IN ORDER, packing every
        run of >= 2 consecutive spilled ``submit`` frames into ONE
        framed multi-submit (``rpc/wire.pack_multi_submit``): a burst
        of N lease misses costs one head frame, not N.  Returns False
        when the head link is gone (the pump stops)."""
        from ..rpc import wire
        from .serialization import serialize
        i, n = 0, len(frames)
        while i < n:
            msg = frames[i]
            j = i + 1
            if self._lease is not None and msg[0] == "submit":
                while j < n and frames[j][0] == "submit":
                    j += 1
            if j - i >= 2:
                packed = wire.pack_multi_submit(
                    [serialize(f) for f in frames[i:j]])
                self._msub_batches += 1
                self._msub_frames += j - i
                msg = ("msub", packed)
            try:
                # explicit no-deadline: a large result frame draining
                # slowly is not a dead head; loss raises via on_close
                self._head.call("agent_frame", self.agent_id, index,
                                msg, timeout=None)
            except Exception:   # noqa: BLE001 — head gone: nothing to
                return False    # relay to; the on_close hook is
                #                 already ending the agent
            i = j
        return True

    def _pump(self, index: int, conn, epoch: int = 0) -> None:
        eof = False
        while not eof:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            if self._epoch != epoch:
                return      # stale worker of a replaced head: its index
                #             collides with the new pool's — go quiet
            msgs = [msg]
            if self._lease is not None:
                # greedy drain: every frame the worker already piped
                # this cycle rides one relay burst, so a fan-out's
                # consecutive spilled submits coalesce into one
                # multi-submit frame instead of one head RPC each
                try:
                    while len(msgs) < self._msub_max and conn.poll(0):
                        msgs.append(conn.recv())
                except (EOFError, OSError):
                    eof = True
            out = []
            for m in msgs:
                try:
                    m = self._rewrite_up(index, m)
                except Exception:   # noqa: BLE001 — surgery must not
                    # drop the frame; forward as-is, but a failing
                    # rewrite is a protocol bug worth surfacing
                    _LOG.warning("frame rewrite failed; forwarding raw",
                                 exc_info=True)
                if m is not None:
                    out.append(m)
            if out and not self._relay_up(index, out):
                return
        if self._epoch != epoch:
            return          # stale: do NOT EOF the new pool's worker
        self._release_index_pins(index)
        self._on_worker_gone(index)
        try:
            self._head.call("agent_eof", self.agent_id, index)
        except Exception:       # noqa: BLE001
            pass
        with self._lock:
            self._workers.pop(index, None)
            self._w_state.pop(index, None)


# ---------------------------------------------------------------------------
# head side
# ---------------------------------------------------------------------------

class _RemoteConn:
    """Virtual pipe endpoint: send = RPC to the agent; recv = queue fed
    by the hub's incoming agent_frame handler."""

    def __init__(self, spawner: "AgentSpawner", index: int):
        self._spawner = spawner
        self._index = index
        self._q: queue.Queue = queue.Queue()
        self.eof = threading.Event()

    def send(self, msg) -> None:
        self._spawner.send_to_worker(self._index, msg)

    def recv(self):
        item = self._q.get()
        if item is _EOF:
            raise EOFError("remote worker gone")
        return item

    def feed(self, msg) -> None:
        self._q.put(msg)

    def close(self) -> None:
        self.feed(_EOF)


class _RemoteProc:
    """Process facade over the agent's real worker process."""

    def __init__(self, spawner: "AgentSpawner", index: int,
                 conn: _RemoteConn, pid: int):
        self._spawner = spawner
        self._index = index
        self._conn = conn
        self.pid = pid          # the real pid on the agent machine

    def is_alive(self) -> bool:
        return not (self._conn.eof.is_set() or self._spawner._closed)

    def terminate(self) -> None:
        self._spawner.kill_worker(self._index)

    kill = terminate

    def join(self, timeout: float | None = None) -> None:
        if self._spawner._closed:
            return              # link gone: nothing to wait for
        self._conn.eof.wait(timeout)


class AgentSpawner:
    """The WorkerPool spawner seam, backed by one registered agent."""

    def __init__(self, agent_address: str, on_disconnect=None):
        from ..rpc import transport as _transport
        self._conns: dict[int, _RemoteConn] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._client = _transport.connect(agent_address,
                                 on_close=self._handle_disconnect)
        self._on_disconnect = on_disconnect

    # -- spawner interface (WorkerPool) --------------------------------------
    def spawn(self, index: int, arena_path, env_payload):
        conn = _RemoteConn(self, index)
        with self._lock:
            if self._closed:
                raise RuntimeError("agent is gone")
            self._conns[index] = conn
        try:
            pid = self._client.call("a_spawn", index, env_payload,
                                    timeout=60.0)
        except Exception:
            with self._lock:
                self._conns.pop(index, None)
            raise
        if not pid:
            with self._lock:
                self._conns.pop(index, None)
            raise RuntimeError("agent failed to spawn worker")
        return _RemoteProc(self, index, conn, pid), conn

    def stop(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            self._client.call("a_stop", timeout=5.0)
        except Exception:       # noqa: BLE001 — agent may already be gone
            pass
        self._client.close()
        self._drop_all()

    # -- frame plumbing ------------------------------------------------------
    def send_to_worker(self, index: int, msg) -> None:
        with self._lock:
            if self._closed or index not in self._conns:
                raise BrokenPipeError("remote worker gone")
        try:
            # no deadline: a slow worker draining a large frame is NOT a
            # dead worker (a timeout here would dead-mark it and run the
            # task twice); a truly lost link raises RpcConnectionError
            ok = self._client.call("a_send", index, msg,
                                   timeout=None)
        except Exception as e:
            raise BrokenPipeError(f"agent link lost: {e}") from e
        if not ok:
            raise BrokenPipeError("remote worker pipe closed")

    def kill_worker(self, index: int) -> None:
        try:
            self._client.call("a_kill", index, timeout=10.0)
        except Exception:       # noqa: BLE001 — best-effort, like SIGKILL
            pass                # on an already-dead pid

    def cancel_remote(self, tid_bin: bytes, force: bool) -> str | None:
        """Cancel an agent-leased task: drop it from the agent's local
        queue, or (force) kill the worker running it.  Returns the
        agent's verdict ("dequeued"/"killed"/"running"/"unknown") or
        None when the agent is unreachable — the caller decides what
        to seal from it."""
        try:
            return self._client.call("a_cancel", tid_bin, force,
                                     timeout=10.0)
        except Exception:       # noqa: BLE001
            return None

    def drain_remote(self) -> int | None:
        """Relay a node drain to the agent: it stops autonomous local
        dispatch and hands queued leases back.  Best-effort — a dead
        agent converges through the health manager's dead path."""
        try:
            return self._client.call("a_drain", timeout=10.0)
        except Exception:       # noqa: BLE001
            return None

    def set_policy(self, policy: dict) -> None:
        """Push an autonomy-policy update (job-env gating) to the
        agent; best-effort — a dropped push only disables/keeps the
        fast path until the next one."""
        try:
            self._client.call("a_policy", policy, timeout=10.0)
        except Exception:       # noqa: BLE001
            pass

    def feed_frame(self, index: int, msg) -> None:
        with self._lock:
            conn = self._conns.get(index)
        if conn is not None:
            conn.feed(msg)

    def feed_eof(self, index: int) -> None:
        with self._lock:
            conn = self._conns.pop(index, None)
        if conn is not None:
            conn.eof.set()
            conn.feed(_EOF)

    def _drop_all(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            conn.eof.set()
            conn.feed(_EOF)

    def _handle_disconnect(self) -> None:
        """Agent link dropped: every remote worker is unreachable.
        Drain the node FIRST (remove_node → pool.shutdown latches the
        pool, so worker-reader threads exiting on the EOFs below do not
        race a respawn through this dead link), then EOF the readers."""
        with self._lock:
            already = self._closed
            self._closed = True
        if not already and self._on_disconnect is not None:
            self._on_disconnect()
        self._drop_all()


class AgentHub:
    """Head-side registry: serves agent registration + frame routing.

    Attach via ``attach(server)`` (``HeadNode`` does this; tests may
    attach to any server fronting a cluster) — it also exposes the
    head's object plane so agents can pull head-resident objects."""

    _EPOCH_KEY = b"lease_epochs"
    _EPOCH_NS = "_lease"

    def __init__(self, cluster):
        from ..common.config import get_config
        self._cluster = cluster
        self._agents: dict[str, tuple[AgentSpawner, object]] = {}
        self._agent_workers: dict[str, int] = {}
        self._lock = threading.Lock()
        # -- lease plane: the head-side single source of truth --------------
        cfg = get_config()
        self._grantor = None
        self._cfg_budget = int(cfg.lease_budget_per_class)
        self._lease_overcommit = float(cfg.lease_overcommit)
        # budget sizing knobs: an explicit lease_budget_per_class wins;
        # otherwise 'beat' reads the scheduling beat's device-priced
        # headroom off the budget board (host heuristic as fallback),
        # 'heuristic' is the pre-budget-beat workers x overcommit path
        self._budget_min = max(1, int(cfg.lease_budget_min))
        self._board = None
        if str(cfg.lease_budget_source) == "beat" and not self._cfg_budget:
            from ..leasing.board import budget_board
            self._board = budget_board()
        self._epoch_tab: dict[str, int] = {}
        if cfg.lease_plane_enabled:
            from ..leasing import LeaseGrantor, register_stats
            self._grantor = LeaseGrantor(
                budget_per_class=self._cfg_budget or self._budget_min,
                max_classes=int(cfg.lease_max_classes),
                journal=self._journal_epoch)
            self._restore_epochs()
            register_stats("head_grantor", self._grantor.stats)

    # -- epoch journal (rides the persisted GCS snapshot's KV plane) --------
    def _journal_epoch(self, node: str, epoch: int) -> None:
        """Revocation epochs persist through the cluster KV, which the
        GCS snapshot covers: a promoted standby restores the table and
        never re-issues an epoch the dead head already revoked — how
        outstanding leases survive failover."""
        import json
        self._epoch_tab[node] = int(epoch)
        try:
            self._cluster.kv.put(
                self._EPOCH_KEY, json.dumps(self._epoch_tab).encode(),
                namespace=self._EPOCH_NS)
        except Exception:   # noqa: BLE001 — journal loss degrades to
            pass            # the fence horizon, never to a crash

    def _restore_epochs(self) -> None:
        import json
        try:
            raw = self._cluster.kv.get(self._EPOCH_KEY,
                                       namespace=self._EPOCH_NS)
            if raw:
                self._epoch_tab = {str(k): int(v) for k, v
                                   in json.loads(bytes(raw)).items()}
                self._grantor.restore(self._epoch_tab)
        except Exception:   # noqa: BLE001 — corrupt journal: start
            self._epoch_tab = {}        # fresh (fencing still holds)

    def handlers(self) -> dict:
        return {
            "agent_register": self.register,
            "agent_frame": self.frame,
            "agent_eof": self.eof,
            "agent_bye": self.bye,
            "agent_sync": self.sync,
            "agent_fn": self.fn_bytes,
        }

    def fn_bytes(self, fn_id: str):
        """Serve a function's bytes from the head registry (agents
        fetch once per function for their autonomous dispatch)."""
        return self._cluster.fn_registry.get(fn_id)

    def attach(self, server) -> None:
        for name, fn in self.handlers().items():
            server.add_handler(name, fn)
        self._cluster.plane.attach(server)
        # job-env changes gate the agents' env-blind fast path
        self._cluster.on_job_env_change = self._push_policy_all

    def _push_policy_all(self, env) -> None:
        """Fire the policy push on a side thread: the caller may hold
        head-level locks (HeadNode._connect), and an unreachable agent
        must not stall it for the RPC timeout."""
        with self._lock:
            spawners = [e[0] for e in self._agents.values()]
        policy = {"fast_path": not bool(env)}

        def run() -> None:
            for sp in spawners:
                sp.set_policy(policy)
        threading.Thread(target=run, daemon=True,
                         name="agent-policy-push").start()

    def register(self, agent_id: str, agent_address: str,
                 resources: dict | None, num_workers: int,
                 labels: dict | None, plane: bool = True):
        if not plane:
            raise ValueError(
                "relay-only agents are no longer supported: every "
                "NodeAgent serves an object plane (one data-plane "
                "code path)")
        # the disconnect hook is live from the START — an agent dying
        # mid-registration must still tear down whatever exists by then
        spawner = AgentSpawner(
            agent_address,
            on_disconnect=lambda: self._on_agent_lost(agent_id))
        # route frames BEFORE adding the node: add_remote_node blocks on
        # worker-ready frames, which arrive through this table — adding
        # the entry after would drop them and wedge the registration
        with self._lock:
            self._agents[agent_id] = (spawner, None)
        try:
            node_id = self._cluster.add_remote_node(
                resources=resources, num_workers=num_workers,
                spawner=spawner, labels=labels,
                plane_address=agent_address)
        except BaseException:
            with self._lock:
                self._agents.pop(agent_id, None)
            spawner.stop()
            raise
        with self._lock:
            if agent_id not in self._agents:
                # disconnected while the node was coming up: the hook
                # already popped the entry but had no node to remove
                vanished = True
            else:
                self._agents[agent_id] = (spawner, node_id)
                vanished = False
        if vanished:
            try:
                self._cluster.remove_node(node_id)
            except (KeyError, ValueError):
                pass
            raise ConnectionError("agent disconnected during "
                                  "registration")
        with self._lock:
            self._agent_workers[agent_id] = int(num_workers)
        out = {"node_id": node_id.hex(),
               "resources": resources or dict(DEFAULT_NODE_RESOURCES),
               "fast_path": not bool(self._cluster.job_runtime_env)}
        if self._grantor is not None:
            ep, grants = self._grantor.snapshot_for(agent_id)
            out["lease"] = {"epoch": ep, "grants": grants}
        return out

    def frame(self, agent_id: str, index: int, msg) -> None:
        entry = self._agents.get(agent_id)
        if entry is None:
            return
        if isinstance(msg, tuple) and msg and msg[0] == "msub":
            # one framed multi-submit off the agent's pump: unpack the
            # individual worker submit frames (order preserved — the
            # wire round-trip is byte-exact) and feed them as if they
            # had arrived one frame each
            from ..rpc import wire
            from .serialization import deserialize
            for raw in wire.unpack_multi_submit(msg[1]):
                entry[0].feed_frame(index, deserialize(raw))
            return
        entry[0].feed_frame(index, msg)

    # -- autonomy sync (ordered refs/started/done batch from an agent) ------
    def sync(self, agent_id: str, batch: list, load: dict,
             lease_want=None):
        """Fold an agent's autonomous-dispatch batch into the head's
        authority, IN ORDER: ref-count events, started specs
        (ownership, lineage), done results (seal + complete +
        reconcile), then the node's live local load.  The per-lease
        head cost is this amortized call — the lease itself never
        touched the head.

        ``lease_want`` lists resource classes the agent spilled since
        its last sync: the grantor leases them (bounded per node) and
        the reply carries the node's current epoch + grant snapshot, so
        one spillback converts the whole rest of a repeat-class stream
        into local grants."""
        entry = self._agents.get(agent_id)
        if entry is None or entry[1] is None:
            return False
        node_id = entry[1]
        cluster = self._cluster
        row = cluster.crm.row_of(node_id)
        raylet = cluster.raylets.get(row) if row is not None else None
        if raylet is None:
            return False
        for item in batch:
            kind = item[0]
            if kind == "refs":
                cluster.ref_counter.apply_batch(
                    item[2], ("w", row, item[1]))
            elif kind == "started":
                self._sync_started(cluster, raylet, row, item[1],
                                   item[2],
                                   item[3] if len(item) > 3 else None,
                                   item[4] if len(item) > 4 else None)
            elif kind == "done":
                self._sync_done(cluster, raylet, row, item)
        raylet.agent_local_cu = dict(load) if load else None
        raylet._notify_dirty()
        if self._grantor is not None:
            fallback = self._cfg_budget or max(
                self._budget_min,
                int(self._agent_workers.get(agent_id, 2) *
                    self._lease_overcommit))
            for ck in list(lease_want or ())[:32]:
                budget = fallback
                if self._board is not None:
                    # the beat's device-priced headroom for this
                    # (class, node); floored so repeat-class pipelines
                    # stay warm even when the beat prices a node at 0
                    b = self._board.budget_for(str(ck), row)
                    if b is not None:
                        budget = max(self._budget_min, int(b))
                self._grantor.grant(agent_id, str(ck), budget)
            ep, grants = self._grantor.snapshot_for(agent_id)
            return {"ok": True, "epoch": ep, "grants": grants}
        return True

    def _sync_started(self, cluster, raylet, row: int,
                      spec_bytes: bytes, submitter: int,
                      fn_id: str | None = None,
                      fn_bytes: bytes | None = None) -> None:
        from ..common.ids import ObjectID as _OID
        from .serialization import deserialize
        tm = cluster.task_manager
        if fn_bytes is not None and fn_id is not None:
            # worker-defined fn whose submit frame never reached the
            # head: the registry must resolve fn_id for retries and
            # lineage reconstruction
            cluster.fn_registry.setdefault(fn_id, fn_bytes)
        spec = deserialize(spec_bytes)
        if tm.get(spec.task_id) is not None:
            return              # duplicate (reconnect replay)
        rec = tm.register(spec)
        rec.lineage_bytes = len(spec_bytes) + 256
        holder = ("w", row, submitter)
        for i in range(max(spec.num_returns, 0)):
            cluster.ref_counter.set_owner(
                _OID.for_task_return(spec.task_id, i + 1), holder)
        raylet.agent_inflight[spec.task_id] = rec

    def _sync_done(self, cluster, raylet, row: int, item) -> None:
        from ..common.ids import TaskID
        from .serialization import RayTaskError, WorkerCrashedError, \
            deserialize
        _kind, tid_bin, descs, contained, err_bytes, disposition = item
        tm = cluster.task_manager
        tid = TaskID(tid_bin)
        rec = raylet.agent_inflight.pop(tid, None)
        if rec is None:
            rec = tm.get(tid)
        if rec is None or rec.done:
            # a record completed elsewhere (cancel raced completion):
            # the agent-arena copies described here have no owner and
            # would leak until agent restart — free them
            from ..common.ids import ObjectID as _OID
            for d in (descs or ()):
                if d[0] == "p" and raylet.plane_address is not None:
                    cluster.plane.free_on(raylet.plane_address,
                                          [_OID(d[1])])
            return
        if disposition == "requeue":
            # never ran on the agent (stale lease, worker vanished
            # pre-exec, arg freed): re-enter global scheduling without
            # consuming a retry attempt
            raylet.submit_existing(rec)
            return
        if disposition == "retry":
            # local worker died under the task: the head owns the
            # attempt budget — resubmit through normal scheduling
            if tm.should_retry(tid):
                raylet.submit_existing(rec)
            else:
                err = RayTaskError(
                    rec.spec.function_descriptor, "worker died",
                    WorkerCrashedError(
                        "agent-local worker died executing "
                        f"{rec.spec.function_descriptor}"))
                raylet._seal_error_returns(rec, err)
                tm.complete(tid)
            return
        if err_bytes is not None:
            raylet._seal_error_returns(rec, deserialize(err_bytes))
            tm.complete(tid)
            return
        raylet._seal_contained(rec, contained)
        head_row = cluster.head().row
        for oid, d in zip(rec.return_ids, descs or ()):
            if oid in rec.dead_returns:
                if d[0] == "p" and raylet.plane_address is not None:
                    cluster.plane.free_on(raylet.plane_address, [oid])
                continue
            if d[0] == "p":
                cluster.directory.add_location(oid, row)
                cluster.store.put_remote(oid, d[2])
            else:
                cluster.seal_serialized(oid, d[1], head_row)
        tm.complete(tid)
        # close the fire-and-forget race: a return whose refs all died
        # before this registration reclaims now instead of leaking
        # (reference_counter.reconcile docstring)
        for oid in rec.return_ids:
            cluster.ref_counter.reconcile(oid)

    def eof(self, agent_id: str, index: int) -> None:
        entry = self._agents.get(agent_id)
        if entry is not None:
            entry[0].feed_eof(index)

    def bye(self, agent_id: str) -> None:
        self._on_agent_lost(agent_id)

    def shutdown(self) -> None:
        with self._lock:
            agents = list(self._agents)
        for agent_id in agents:
            self._on_agent_lost(agent_id)
        if self._grantor is not None:
            from ..leasing import unregister_stats
            unregister_stats("head_grantor")

    def _on_agent_lost(self, agent_id: str) -> None:
        with self._lock:
            entry = self._agents.pop(agent_id, None)
            self._agent_workers.pop(agent_id, None)
        if entry is None:
            return
        if self._grantor is not None:
            # node left (death, bye, shutdown): revoke its epoch so a
            # re-registration under the same id can never reuse grants
            # (journaled — survives head kill and standby promotion)
            self._grantor.drop_node(agent_id)
        spawner, node_id = entry
        # drain first so the raylet stops dispatching into the void,
        # then drop the link; remove_node tolerates an already-gone node
        if node_id is not None:
            try:
                self._cluster.remove_node(node_id)
            except (KeyError, ValueError):
                pass            # already removed / cluster torn down
        spawner.stop()
