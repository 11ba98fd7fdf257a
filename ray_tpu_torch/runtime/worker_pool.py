"""Worker pool: spawns, leases, and monitors worker processes.

Reference parity: the raylet's ``WorkerPool`` (prestarted per-language
workers, ``PopWorker``/``PushWorker`` lease handout, crash detection via
socket disconnect — ``src/ray/raylet/worker_pool.cc``, SURVEY.md §1 layer 4;
mount empty).

Workers are spawned (not forked): the driver owns a live CUDA context
whose threads and device handles must not leak into children (a CUDA
context cannot cross a fork); ``worker_main`` hides the GPU from every
worker, so workers never contend for the card.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading
from collections import deque
from typing import Callable

from .worker import worker_main
from ..common import clock as _clk

# env vars a spawned worker must not inherit (none on the GPU: the
# worker itself sets CUDA_VISIBLE_DEVICES, see worker_main)
_SCRUB_ENV: tuple[str, ...] = ()
_spawn_env_lock = threading.Lock()


class LocalSpawner:
    """Default transport: spawn worker processes on THIS machine over
    multiprocessing pipes.  The pool is parameterized over this seam so a
    remote node agent can supply workers on another machine while every
    piece of lease/env/death bookkeeping stays in the one pool
    (``runtime/node_agent.py``)."""

    def __init__(self):
        self._ctx = mp.get_context("spawn")

    def spawn(self, index: int, arena_path: str | None,
              env_payload: dict | None):
        """Returns ``(proc, conn)``, already started; ``proc`` must offer
        terminate/join/is_alive, ``conn`` send/recv/close."""
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        with _spawn_env_lock:
            saved = {k: os.environ.pop(k) for k in _SCRUB_ENV
                     if k in os.environ}
            # export THIS process's resolved config as RT_* env vars so
            # the spawned worker (fresh interpreter) rebuilds the same
            # Config — programmatic system_config overrides would
            # otherwise silently vanish at the process boundary
            cfg_saved = {}
            try:
                from ..common.config import get_config
                for key, val in get_config().to_dict().items():
                    env_key = "RT_" + key.upper()
                    cfg_saved[env_key] = os.environ.get(env_key)
                    os.environ[env_key] = str(val)
                proc = self._ctx.Process(
                    target=worker_main,
                    args=(child_conn, index, arena_path, env_payload),
                    daemon=True, name=f"rt-worker-{index}")
                proc.start()
            finally:
                for env_key, old in cfg_saved.items():
                    if old is None:
                        os.environ.pop(env_key, None)
                    else:
                        os.environ[env_key] = old
                os.environ.update(saved)
        child_conn.close()
        return proc, parent_conn

    def stop(self) -> None:
        pass


class WorkerHandle:
    def __init__(self, index: int, proc, conn):
        self.index = index
        self.proc = proc
        self.conn = conn
        self.send_lock = threading.Lock()   # scheduler + reader both send
        self.ready = False
        self.dead = False
        self.blocked = False                # inside a blocking get
        self.dedicated = False              # actor worker: never in idle set
        self.env_key = None                 # runtime-env cache key
        self.env_payload = None             # staged payload (respawn)
        self.leased_task = None             # task_id_bin while executing
        # executing a streaming generator: it can pause indefinitely on
        # consumer backpressure, so tasks must never pipeline behind it
        # (the consumer may be waiting on exactly the queued task)
        self.leased_streaming = False
        # pipelined lease: (TaskID, assign_time) entries committed to
        # this worker but NOT yet sent — recallable (blocked worker,
        # stale lease, death) until the exec frame ships.  Mutated under
        # the owning raylet's _cv.
        self.assigned: deque = deque()
        self.fn_cache: set[str] = set()
        # per-function execution counts (max_calls worker recycling)
        self.fn_calls: dict[str, int] = {}
        # FIFO of shm-pin batches for get replies in flight to this
        # worker; drained by its get_ack frames, or by death/drain
        # cleanup (which may run on another thread — hence the lock and
        # the no_more_pins latch that stops late appends).
        self.pending_get_pins: deque = deque()
        self.pin_lock = threading.Lock()
        self.no_more_pins = False

    def send(self, msg) -> bool:
        with self.send_lock:
            if self.dead:
                return False
            try:
                self.conn.send(msg)
                return True
            except (OSError, BrokenPipeError):
                self.dead = True
                return False


class WorkerPool:
    """Owns worker processes; routes their frames to the raylet."""

    def __init__(self, num_workers: int,
                 on_message: Callable[[WorkerHandle, tuple], None],
                 on_death: Callable[[WorkerHandle], None],
                 on_idle: Callable[[], None] | None = None,
                 arena_path: str | None = None,
                 spawner=None):
        self._num = num_workers
        self._on_message = on_message
        self._on_death = on_death
        self._on_idle = on_idle or (lambda: None)
        self._arena_path = arena_path
        self._spawner = spawner if spawner is not None else LocalSpawner()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._workers: list[WorkerHandle] = []
        self._idle: list[WorkerHandle] = []
        self._next_index = 0
        self._shutdown = False
        # env keys with a spawn in flight -> owning worker index (-1
        # while the claim predates its handle).  Ownership matters: a
        # death-respawn of a post-ready env worker runs OUTSIDE the
        # gate, and its ready must not release a gate a concurrent
        # ensure_env_worker spawn still holds
        self._env_spawning: dict = {}
        self.node_id_hex: str | None = None     # set by the raylet

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        for _ in range(self._num):
            self._spawn_one()

    def _spawn_one(self, dedicated: bool = False, env_key=None,
                   env_payload: dict | None = None) -> WorkerHandle | None:
        with self._lock:
            if self._shutdown:
                return None
            index = self._next_index
            self._next_index += 1
        proc, parent_conn = self._spawner.spawn(index, self._arena_path,
                                                env_payload)
        handle = WorkerHandle(index, proc, parent_conn)
        handle.dedicated = dedicated
        handle.env_key = env_key
        handle.env_payload = env_payload
        with self._lock:
            self._workers.append(handle)
            # an unowned gate claim (-1) for this key becomes ours; the
            # key stays gated until the worker signals READY (see
            # _reader) — releasing at proc.start() would let every
            # scheduler scan during the worker's multi-hundred-ms boot
            # fork yet another process
            if (not dedicated and env_key is not None
                    and self._env_spawning.get(env_key) == -1):
                self._env_spawning[env_key] = handle.index
        threading.Thread(target=self._reader, args=(handle,),
                         daemon=True, name=f"rt-reader-{index}").start()
        return handle

    def spawn_dedicated(self, env_key=None,
                        env_payload: dict | None = None) -> WorkerHandle:
        """Spawn a worker that is never leased from the idle set — the
        dedicated actor-worker model (reference: each actor gets its own
        worker process), optionally inside a staged runtime env."""
        handle = self._spawn_one(dedicated=True, env_key=env_key,
                                 env_payload=env_payload)
        if handle is None:
            raise RuntimeError("pool is shut down")
        return handle

    def ensure_env_worker(self, env_key, env_payload: dict) -> None:
        """Grow the per-env worker cache by one (single spawn in flight
        per key).  WHEN to grow is the raylet's call — a one-per-env
        cache deadlocks when tasks sharing an env block on each other (a
        barrier under a job-level runtime_env), while unconditional
        growth double-spawns on sequential reuse, so the raylet spawns
        immediately only on cold start and otherwise after a grace
        period (``env_worker_grace_ms``)."""
        with self._lock:
            if env_key in self._env_spawning:
                return
            self._env_spawning[env_key] = -1    # claimed; spawn next
        try:
            self._spawn_one(env_key=env_key, env_payload=env_payload)
        except Exception:
            # a failed fork must not wedge the gate: future scans retry
            with self._lock:
                if self._env_spawning.get(env_key) == -1:
                    del self._env_spawning[env_key]
            raise

    def live_env_workers(self, env_key) -> int:
        """Leasable workers staged into this env (idle or busy, not
        dedicated to an actor), plus any spawn in flight."""
        with self._lock:
            n = sum(1 for h in self._workers
                    if h.env_key == env_key and not h.dead
                    and not h.dedicated)
            if env_key in self._env_spawning:
                n += 1
            return n

    def _reader(self, handle: WorkerHandle) -> None:
        while True:
            try:
                msg = handle.conn.recv()
            except (EOFError, OSError):
                break
            if msg[0] == "ready":
                if self.node_id_hex:
                    # runtime-context identity: tell the worker which
                    # node hosts it (reference: RuntimeContext.node_id)
                    handle.send(("node_info", self.node_id_hex))
                if not handle.dedicated and handle.env_key is not None:
                    with self._lock:
                        # boot done: reopen the env gate — but only OUR
                        # claim; a death-respawn's ready must not free a
                        # gate a concurrent ensure spawn still holds
                        if self._env_spawning.get(handle.env_key) \
                                == handle.index:
                            del self._env_spawning[handle.env_key]
                with self._cv:
                    handle.ready = True
                    if not handle.dedicated:
                        self._idle.append(handle)
                    self._cv.notify_all()
                if not handle.dedicated:
                    self._on_idle()
                continue
            try:
                self._on_message(handle, msg)
            except Exception:  # noqa: BLE001 — a bad frame must not kill
                import traceback
                traceback.print_exc()
        handle.dead = True
        with self._cv:
            if handle in self._idle:
                self._idle.remove(handle)
            self._cv.notify_all()
        if not self._shutdown:
            self._on_death(handle)
            if not handle.dedicated:
                # keep the pool at strength; env workers respawn into
                # their staged environment.  A worker that died MID-BOOT
                # still owns its gate claim: hand the claim to the
                # replacement (back to -1, which the respawned _spawn_one
                # re-claims) so the gate reopens at the replacement's
                # ready — or here, on spawn failure
                if handle.env_key is not None:
                    with self._lock:
                        if self._env_spawning.get(handle.env_key) \
                                == handle.index:
                            self._env_spawning[handle.env_key] = -1
                try:
                    self._spawn_one(env_key=handle.env_key,
                                    env_payload=handle.env_payload)
                except Exception:
                    if handle.env_key is not None:
                        with self._lock:
                            if self._env_spawning.get(handle.env_key) \
                                    == -1:
                                del self._env_spawning[handle.env_key]
                    raise

    # -- leasing ------------------------------------------------------------
    def pop_idle(self, env_key=None) -> WorkerHandle | None:
        """Lease an idle worker whose runtime env matches ``env_key``
        (None = the default environment)."""
        with self._cv:
            for i in range(len(self._idle) - 1, -1, -1):
                h = self._idle[i]
                if h.dead:
                    del self._idle[i]
                    continue
                if h.env_key == env_key:
                    del self._idle[i]
                    return h
            return None

    def pipeline_target(self, env_key=None,
                        depth: int = 2) -> WorkerHandle | None:
        """A busy (executing, not blocked, not dedicated) worker with
        room in its pipelined-lease queue, matching ``env_key`` —
        least-loaded first.  ``assigned`` lengths are read without the
        raylet lock (heuristic tie-break only; the raylet re-checks
        under its own lock when committing)."""
        with self._cv:
            best = None
            for h in self._workers:
                if h.dead or h.dedicated or h.blocked or \
                        h.leased_streaming or \
                        h.env_key != env_key or h.leased_task is None:
                    continue
                if len(h.assigned) >= depth - 1:
                    continue
                if best is None or len(h.assigned) < len(best.assigned):
                    best = h
            return best

    def release(self, handle: WorkerHandle) -> None:
        with self._cv:
            handle.leased_task = None
            handle.leased_streaming = False
            if not handle.dead and handle not in self._idle:
                self._idle.append(handle)
                self._cv.notify_all()
        self._on_idle()

    def wait_ready(self, count: int = 1, timeout: float = 60.0) -> bool:
        """Block until at least ``count`` workers signalled ready."""
        deadline = _clk.monotonic() + timeout
        with self._cv:
            while sum(h.ready and not h.dead for h in self._workers) < count:
                remaining = deadline - _clk.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def num_alive(self) -> int:
        with self._lock:
            return sum(not h.dead for h in self._workers)

    def expected(self) -> int:
        """Configured steady-state pool size (health checks compare
        num_alive against this)."""
        return self._num

    def grow_for_blocked(self, max_factor: int = 4) -> bool:
        """Spawn one extra DEFAULT worker when the pool is starved by
        workers parked in a blocking get (reference: workers blocked in
        ray.get stop counting toward the soft limit, and the pool starts
        replacements on demand — SURVEY §3.2 lease notes).  Env workers
        are excluded from every count here: an idle env worker cannot be
        leased by a default task (pop_idle is env-keyed), so it must not
        suppress growth, and env-cache growth has its own demand-driven
        path (``ensure_env_worker``)."""
        with self._lock:
            alive = [h for h in self._workers
                     if not h.dead and not h.dedicated
                     and h.env_key is None]
            unblocked = sum(not h.blocked for h in alive)
            idle_default = any(not h.dead and h.env_key is None
                               for h in self._idle)
            if idle_default or unblocked >= self._num \
                    or len(alive) >= self._num * max_factor:
                return False
        self._spawn_one()
        return True

    def kill_worker(self, handle: WorkerHandle) -> None:
        """Force-kill (ray.cancel(force=True) / ray.kill path)."""
        handle.dead = True
        try:
            handle.proc.terminate()
        except Exception:
            pass

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            workers = list(self._workers)
        for h in workers:
            h.send(("shutdown",))
        for h in workers:
            h.proc.join(timeout=2.0)
            if h.proc.is_alive():
                h.proc.terminate()
        for h in workers:
            try:
                h.conn.close()
            except Exception:
                pass
        self._spawner.stop()
