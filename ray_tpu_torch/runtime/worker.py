"""Worker process: executes tasks shipped by the raylet.

Reference parity: the worker side of upstream's core worker —
``CoreWorker::ExecuteTask`` receiving ``PushTask`` RPCs, with an in-worker
API surface so user functions can call ``get/put/wait/.remote`` from inside
a task, async actors running on an event loop, and threaded actors with
bounded ``max_concurrency`` / concurrency groups
(``src/ray/core_worker/``, SURVEY.md §1 layer 7, §3.2 tail; mount empty).

Transport: one duplex ``multiprocessing`` connection to the owning raylet.
A dedicated READER thread owns ``conn.recv`` and routes frames: replies to
this worker's own requests go to a reply queue (API calls are serialized
by a lock, so exactly one is outstanding); work frames (exec, actor
lifecycle) go to the work queue the main thread drains.  This is what
lets concurrent actor calls block in ``ray.get`` independently — the
reference gets the same property from the core worker's dedicated IO
service thread.

Frames (tuples, first element is the kind):
  raylet -> worker: ("fn", fn_id, bytes), ("exec", task_id_bin, fn_id,
                    payload, trace_ctx, extern), ("get_reply*", ...),
                    ("wait_reply", payload), ("shutdown",)
  worker -> raylet: ("ready",), ("result", task_id_bin, [bytes, ...],
                    contained), ("error", task_id_bin, bytes),
                    ("get", [oid_bin, ...]), ("wait", ...),
                    ("put", oid_bin, bytes, contained),
                    ("submit", spec_bytes, fn_id, fn_bytes | None),
                    ("refs", [(delta, oid_bin), ...])
"""

from __future__ import annotations

import contextvars
import logging
import os
import queue
import sys
import threading

from ..common.ids import ObjectID, TaskID
from .object_ref import ObjectRef
from .serialization import RayTaskError, deserialize, serialize

# reply frame kinds the reader routes to the API reply queue
_REPLY_KINDS = frozenset({"get_reply", "get_reply_x", "wait_reply",
                          "kv_reply", "named_actor_reply",
                          "named_list_reply", "stream_wait_reply"})


def _format_all_stacks() -> str:
    """Every thread's current Python stack, named — what is this
    process doing RIGHT NOW."""
    import sys
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    out = [f"pid {os.getpid()}"]
    for ident, frame in sys._current_frames().items():
        out.append(f"--- thread {names.get(ident, ident)} ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
    return "\n".join(out)


class ArgRef:
    """A task argument shipped as a store descriptor instead of a value:
    shm-resident args are read zero-copy from the worker's arena mapping
    (reference: plasma args are mmap views, not copies)."""

    __slots__ = ("desc",)

    def __init__(self, desc):
        self.desc = desc

    def __reduce__(self):
        return (ArgRef, (self.desc,))


class WorkerRefCounter:
    """This worker process's share of distributed refcounting: local
    ObjectRef construction/destruction queue here (``__del__``-safe,
    lock-free) and batches ship to the raylet as ``("refs", …)`` frames,
    where they fold against this worker's HOLDER entry in the head's
    ReferenceCounter.  A stashed borrowed ref therefore keeps its object
    alive after the lending task returns; worker death retires the whole
    holder (reference: per-worker ReferenceCounter + borrower protocol,
    SURVEY.md §1 layer 7; mount empty)."""

    def __init__(self):
        from collections import deque
        self._events: deque = deque()

    def incref(self, object_id) -> None:
        self._events.append((1, object_id))

    def decref(self, object_id) -> None:
        self._events.append((-1, object_id))

    def drain(self) -> list:
        out = []
        while True:
            try:
                delta, oid = self._events.popleft()
            except IndexError:
                return out
            out.append((delta, oid.binary()))


class WorkerApiContext:
    """The in-worker implementation of the public API (get/put/submit).

    Installed as the process-global runtime by ``worker_main``; the
    ``ray_tpu_torch.api`` front end routes to it when running inside a worker.
    Thread-safe: concurrent actor calls share it (sends are serialized;
    request/reply API calls additionally hold ``_api_lock`` end-to-end,
    which also keeps get-ack order matched to the raylet's pin FIFO).
    The current task id is a context variable, so it is correct per
    thread AND per asyncio task."""

    is_driver = False

    def __init__(self, conn, arena_path: str | None = None):
        self._conn = conn
        self._task_var: contextvars.ContextVar = \
            contextvars.ContextVar("rt_task", default=None)
        self._put_index = 0
        self._put_lock = threading.Lock()
        self._arena_path = arena_path
        self._arena = None          # lazily attached, read-only
        self._arena_lock = threading.Lock()
        self.ref_counter = WorkerRefCounter()
        self._send_lock = threading.Lock()
        self._api_lock = threading.RLock()
        self._flush_lock = threading.Lock()
        self._reply_q: queue.SimpleQueue = queue.SimpleQueue()
        # streaming-generator backpressure: highest consumer-acked item
        # per task (fed by the reader thread's stream_ack routing)
        self._stream_acks: dict[bytes, int] = {}
        self._stream_active: set[bytes] = set()
        self._stream_cancelled: set[bytes] = set()
        self._stream_cv = threading.Condition()
        # runtime-context identity (reference: ray.get_runtime_context)
        self.node_id_hex: str | None = None     # fed by "node_info"
        self.actor_id_bin: bytes | None = None  # set at actor_new

    # -- transport ----------------------------------------------------------
    def send(self, msg) -> None:
        with self._send_lock:
            self._conn.send(msg)

    def reader_loop(self, work_q: queue.SimpleQueue) -> None:
        """Owns ``conn.recv``: replies to our API calls go to the reply
        queue, work frames to the main loop's queue.  EOF poisons both."""
        while True:
            try:
                msg = self._conn.recv()
            except (EOFError, OSError):
                break
            if msg[0] in _REPLY_KINDS:
                self._reply_q.put(msg)
            elif msg[0] == "dump_stacks":
                # live stack sampling (upstream: the dashboard's py-spy
                # integration — SURVEY §5.1(c)): answered ON THE READER
                # THREAD so a worker wedged in user code (the exact
                # case you want to inspect) still replies
                try:
                    self.send(("stacks_reply", msg[1],
                               _format_all_stacks()))
                except Exception:   # noqa: BLE001 — diagnostics only;
                    # the reader must survive, but record the failure
                    logging.getLogger("ray_tpu_torch.worker").debug(
                        "stack-dump reply failed", exc_info=True)
            elif msg[0] == "node_info":
                # which node hosts this worker (runtime-context
                # surface) — set from the reader so it is visible even
                # while the main thread executes a long task
                self.node_id_hex = msg[1]
            elif msg[0] == "stream_ack":
                # out-of-band: the main thread is inside the generator.
                # Only ACTIVE streams record (a late ack after
                # stream_done must not re-create the entry)
                with self._stream_cv:
                    if msg[1] in self._stream_active:
                        prev = self._stream_acks.get(msg[1], 0)
                        self._stream_acks[msg[1]] = max(prev, msg[2])
                        self._stream_cv.notify_all()
            elif msg[0] == "stream_cancel":
                with self._stream_cv:
                    # ACTIVE streams only (like stream_ack): a cancel
                    # racing past stream_done must not park a dead
                    # entry in the set forever
                    if msg[1] in self._stream_active:
                        self._stream_cancelled.add(msg[1])
                        self._stream_cv.notify_all()
            else:
                work_q.put(msg)
        work_q.put(None)
        self._reply_q.put(None)

    def flush_refs(self) -> None:
        """Ship queued local ref events to the raylet.  Drain and send
        hold one lock so concurrent actor-call threads cannot split a
        +/- pair across two frames that then hit the wire out of order
        (per-holder event order is the counter's correctness
        invariant)."""
        with self._flush_lock:
            events = self.ref_counter.drain()
            if events:
                self.send(("refs", events))

    def _materialize(self, desc, extern=None):
        """Resolve a descriptor: in-band value ("v"), in-band serialized
        value ("vb"), in-band serialized payload ("b"), a zero-copy
        arena read ("s"), or an extern-table indirection ("x" — plane
        mode ships plasma descriptors OUTSIDE the payload pickle so the
        node agent can resolve them against its local arena)."""
        kind = desc[0]
        if kind == "x":
            desc = extern[desc[1]]
            kind = desc[0]
        if kind == "v":
            return desc[1]
        if kind in ("b", "vb"):
            return deserialize(desc[1])
        if kind == "r":
            raise RuntimeError(
                "unresolved by-reference descriptor reached the worker "
                "(the node agent failed to rewrite it)")
        # ("s", offset, size): attach the arena once, read zero-copy
        if self._arena is None:
            with self._arena_lock:
                if self._arena is None:
                    from ..native import Arena
                    self._arena = Arena(self._arena_path)
        return deserialize(self._arena.view(desc[1], desc[2]))

    def _recv_reply(self, expected_kinds):
        if isinstance(expected_kinds, str):
            expected_kinds = (expected_kinds,)
        while True:
            msg = self._reply_q.get()
            if msg is None:
                raise ConnectionError("raylet connection lost")
            if msg[0] in expected_kinds:
                return msg
            # stale reply (an abandoned earlier call): drop it

    def stream_begin(self, task_id_bin: bytes) -> None:
        with self._stream_cv:
            self._stream_active.add(task_id_bin)
            self._stream_cancelled.discard(task_id_bin)

    def stream_wait_budget(self, task_id_bin: bytes, produced: int,
                           window: int) -> bool:
        """Generator backpressure: pause until the consumer has acked
        within ``window`` of what we produced.  A slow-but-alive
        consumer keeps memory bounded (every ack re-arms the clock);
        an ABANDONED stream normally cancels cooperatively
        (ObjectRefGenerator close/GC sends stream_cancel), and the
        10-minute no-progress cap catches ORPHANED streams whose
        consumer can never close them (a transferred generator whose
        carrier task died before delivery) — the producer then stops
        yielding instead of holding its worker forever.  Returns False
        when the producer should stop."""
        import time as _time
        deadline = _time.monotonic() + 600.0
        with self._stream_cv:
            last = self._stream_acks.get(task_id_bin, 0)
            while produced - self._stream_acks.get(task_id_bin, 0) \
                    >= window:
                if task_id_bin in self._stream_cancelled:
                    return "cancelled"
                acked = self._stream_acks.get(task_id_bin, 0)
                if acked > last:        # consumer alive: re-arm
                    last = acked
                    deadline = _time.monotonic() + 600.0
                if _time.monotonic() >= deadline:
                    return "stalled"    # orphaned: stop producing
                self._stream_cv.wait(1.0)
            return "cancelled" if task_id_bin in self._stream_cancelled \
                else "ok"

    def stream_done(self, task_id_bin: bytes) -> None:
        with self._stream_cv:
            self._stream_acks.pop(task_id_bin, None)
            self._stream_active.discard(task_id_bin)
            self._stream_cancelled.discard(task_id_bin)

    # -- task lifecycle (called by the exec paths) --------------------------
    def begin_task(self, task_id: TaskID):
        return self._task_var.set(task_id)

    def end_task(self, token=None):
        if token is not None:
            self._task_var.reset(token)
        else:
            self._task_var.set(None)

    @property
    def current_task_id(self) -> TaskID | None:
        return self._task_var.get()

    # -- API ----------------------------------------------------------------
    def get(self, refs: list[ObjectRef], timeout: float | None = None):
        # the WHOLE request/reply/materialize/ack sequence holds the api
        # lock: the raylet releases get-reply pins on acks in FIFO order
        # per worker, so two threads' acks must not interleave
        with self._api_lock:
            self.send(("get", [r.binary() for r in refs], timeout))
            msg = self._recv_reply(("get_reply", "get_reply_x"))
            if msg[0] == "get_reply":
                status, descs = deserialize(msg[1])
            else:       # plane mode: descriptors ride outside the pickle
                status, descs = msg[1], msg[2]
            if status == "timeout":
                from .object_store import GetTimeoutError
                raise GetTimeoutError(
                    f"get timed out after {timeout}s inside worker")
            try:
                values = [self._materialize(d) for d in descs]
            finally:
                # ack releases the raylet/agent-side pins on this
                # reply's shm descriptors; sent only when any exist
                if any(d[0] == "s" for d in descs):
                    self.send(("get_ack",))
        for v in values:
            if isinstance(v, RayTaskError):
                raise v.cause if v.cause is not None else v
        return values

    def put(self, value) -> ObjectRef:
        task_id = self.current_task_id
        assert task_id is not None, "put outside a task"
        with self._put_lock:
            self._put_index += 1
            idx = self._put_index
        # the process-wide monotonic index keeps put ids unique across
        # concurrent calls (per-task indexes could collide after an
        # interleaving); ids still embed the creating task
        oid = ObjectID.for_put(task_id, idx)
        from .object_ref import serialize_collecting
        data, contained = serialize_collecting(value)
        self.flush_refs()
        self.send(("put", oid.binary(), data, contained))
        return ObjectRef(oid)

    def wait(self, refs, num_returns, timeout):
        """True ray.wait semantics: the raylet-side store partitions by
        actual readiness; partial (ready, not_ready) on timeout, no raise."""
        with self._api_lock:
            self.send(("wait", [r.binary() for r in refs], num_returns,
                       timeout))
            _, payload = self._recv_reply("wait_reply")
        ready_bins = set(deserialize(payload))
        ready = [r for r in refs if r.binary() in ready_bins]
        not_ready = [r for r in refs if r.binary() not in ready_bins]
        return ready, not_ready

    def submit_spec(self, spec, fn_id: str, fn_bytes: bytes | None):
        from .object_ref import mark_transferred, transfer_generators
        self.flush_refs()
        with transfer_generators() as gens:
            payload = serialize(spec)
        self.send(("submit", payload, fn_id, fn_bytes))
        mark_transferred(gens)      # bytes shipped: consumption moved

    # streaming-generator CONSUMPTION from inside a worker: waits and
    # acks proxy through the raylet, so ObjectRefGenerators chain
    # through tasks (a task can consume another task's or actor's
    # stream — reference: generators are first-class task arguments)
    def stream_wait(self, task_id, index, timeout=None):
        # bounded server-side waits looped client-side (the
        # ClientRuntime pattern): the api lock releases between polls,
        # so one call consuming a slow stream cannot head-of-line-block
        # every other concurrent call's get/put/wait on this worker
        import time as _time
        deadline = None if timeout is None \
            else _time.monotonic() + timeout
        while True:
            # 15s server-side bound: long enough that the raylet's
            # blocked-worker dance (recall/add_back/re-debit) stays
            # rare churn, short enough that concurrent calls on this
            # worker wait a bounded time for the api lock
            if deadline is None:
                step = 15.0
            else:
                step = min(15.0, max(0.0, deadline - _time.monotonic()))
            with self._api_lock:
                self.send(("stream_wait", task_id.binary(), index, step))
                reply = self._recv_reply("stream_wait_reply")
            sealed, done, err_bytes = reply[1], reply[2], reply[3]
            known = reply[4] if len(reply) > 4 else True
            if sealed > index or done or not known or \
                    (deadline is not None
                     and _time.monotonic() >= deadline):
                return (sealed, done,
                        deserialize(err_bytes) if err_bytes else None,
                        known)

    def stream_ack(self, task_id, consumed) -> None:
        self.send(("stream_ack_up", task_id.binary(), consumed))

    def stream_close(self, task_id, consumed) -> None:
        self.send(("stream_close_up", task_id.binary(), consumed))

    def kv_op(self, op: str, key: bytes, value: bytes | None = None,
              namespace: str = "", overwrite: bool = True):
        """GCS KV access from inside a task (internal_kv parity)."""
        with self._api_lock:
            self.send(("kv", op, key, value, namespace, overwrite))
            reply = self._recv_reply("kv_reply")
        if reply[2] is not None:
            raise RuntimeError(f"internal_kv {op} failed: {reply[2]}")
        return reply[1]

    # -- actor API (frames handled by the driver's ActorManager) ------------
    def create_actor(self, actor_id, cls_id: str, cls_bytes: bytes | None,
                     args, kwargs, max_restarts: int, max_task_retries: int,
                     name: str | None, resources=None, strategy=None,
                     runtime_env=None, concurrency: dict | None = None,
                     namespace: str = "", lifetime: str | None = None):
        self.flush_refs()
        self.send(("actor_create", actor_id.binary(), cls_id,
                   cls_bytes, serialize(
                       (args, kwargs, max_restarts, max_task_retries,
                        name, resources, strategy, runtime_env,
                        concurrency, namespace, lifetime))))

    # -- placement groups (frames handled by the raylet) --------------------
    def create_placement_group(self, pg_id, bundles, strategy_name: str,
                               name: str | None):
        self.send(("pg_create", pg_id.binary(),
                   serialize((bundles, strategy_name, name))))

    def remove_placement_group(self, pg_id):
        self.send(("pg_remove", pg_id.binary()))

    def submit_actor_call(self, actor_id, task_id, method: str, args,
                          kwargs, num_returns: int,
                          trace_ctx: tuple | None = None,
                          concurrency_group: str | None = None):
        from .object_ref import mark_transferred, transfer_generators
        self.flush_refs()
        with transfer_generators() as gens:
            payload = serialize((args, kwargs, num_returns, trace_ctx,
                                 concurrency_group))
        self.send(("actor_submit", actor_id.binary(),
                   task_id.binary(), method, payload))
        mark_transferred(gens)

    def kill_actor(self, actor_id, no_restart: bool = True):
        self.send(("actor_kill", actor_id.binary(), no_restart))

    def get_actor_id_by_name(self, name: str, namespace: str = ""):
        with self._api_lock:
            self.send(("named_actor", name, namespace))
            return self._recv_reply("named_actor_reply")[1]

    def list_named_actors_via_head(self, namespace):
        """Named-actor listing from inside a task/actor (None = every
        namespace)."""
        with self._api_lock:
            self.send(("named_list", namespace))
            return self._recv_reply("named_list_reply")[1]


class _ActorExecutor:
    """Runs one actor's method calls under its concurrency model.

    Reference parity: async actors run coroutine methods on a dedicated
    event loop (default ``max_concurrency`` 1000); threaded actors run
    up to ``max_concurrency`` calls on a pool; ``concurrency_groups``
    bound named groups independently, with the unnamed remainder on the
    default group (core worker's ``ConcurrencyGroupManager`` /
    ``FiberStateManager`` — SURVEY.md §1 layer 7; mount empty).
    ``max_concurrency == 1`` executes inline on the main loop thread,
    preserving the strict FIFO the reference gives plain actors."""

    def __init__(self, ctx: WorkerApiContext, instance,
                 concurrency: dict | None):
        import inspect
        self._ctx = ctx
        self.instance = instance
        conc = concurrency or {}
        self._is_async = any(
            inspect.iscoroutinefunction(m)
            or inspect.isasyncgenfunction(m)
            for _n, m in inspect.getmembers(type(instance))
            if callable(m))
        default = 1000 if self._is_async else 1
        self.max_concurrency = int(conc.get("max_concurrency") or default)
        self._groups: dict[str, object] = {}
        self._loop = None
        self._loop_thread = None
        self._sem = None
        group_sizes = dict(conc.get("concurrency_groups") or {})
        if self._is_async:
            import asyncio
            self._loop = asyncio.new_event_loop()
            self._loop_thread = threading.Thread(
                target=self._loop.run_forever, daemon=True,
                name="actor-async-loop")
            self._loop_thread.start()
            self._sem = {
                None: asyncio.Semaphore(self.max_concurrency)}
            for gname, n in group_sizes.items():
                self._sem[gname] = asyncio.Semaphore(int(n))
        elif self.max_concurrency > 1 or group_sizes:
            from concurrent.futures import ThreadPoolExecutor
            self._groups[None] = ThreadPoolExecutor(
                max_workers=self.max_concurrency,
                thread_name_prefix="actor-call")
            for gname, n in group_sizes.items():
                self._groups[gname] = ThreadPoolExecutor(
                    max_workers=int(n),
                    thread_name_prefix=f"actor-{gname}")

    @property
    def inline(self) -> bool:
        return self._loop is None and not self._groups

    def dispatch(self, run, group: str | None) -> None:
        """Run ``run()`` (a fully-bound call closure) under the model."""
        if self._loop is not None:
            import asyncio
            sem = self._sem.get(group) or self._sem[None]

            async def guarded():
                async with sem:
                    await run()
            asyncio.run_coroutine_threadsafe(guarded(), self._loop)
            return
        pool = self._groups.get(group) or self._groups.get(None)
        if pool is None:
            run()
        else:
            pool.submit(run)

    def shutdown(self) -> None:
        for pool in self._groups.values():
            pool.shutdown(wait=True)
        if self._loop is not None:
            # drain ON the loop: run_coroutine_threadsafe callbacks are
            # FIFO, so every previously dispatched call has created its
            # task by the time drain() runs — counting from this thread
            # instead would race task creation (and iterate the task
            # WeakSet unsafely from outside the loop)
            import asyncio

            async def drain():
                while True:
                    others = [t for t in asyncio.all_tasks()
                              if t is not asyncio.current_task()]
                    if not others:
                        return
                    await asyncio.gather(*others,
                                         return_exceptions=True)
            fut = asyncio.run_coroutine_threadsafe(drain(), self._loop)
            try:
                fut.result(timeout=10.0)
            except Exception:   # noqa: BLE001 — wedge: stop anyway
                pass
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._loop_thread.join(timeout=5.0)


class _CallScope:
    """Shared per-call scaffolding: task context + trace span on entry;
    span exit, task reset, error frame, and ref flush on the way out."""

    def __init__(self, ctx: WorkerApiContext, task_id_bin: bytes,
                 method: str, trace_ctx):
        self._ctx = ctx
        self._tid = task_id_bin
        self._method = method
        self._trace = trace_ctx
        self._scope = None
        self._token = None

    def __enter__(self):
        self._token = self._ctx.begin_task(TaskID(self._tid))
        if self._trace is not None:
            from ..util.tracing import span_scope
            self._scope = span_scope(self._trace[0],
                                     TaskID(self._tid).hex())
            self._scope.__enter__()
        return self

    def __exit__(self, exc_type, exc, _tb):
        if exc is not None:
            self._ctx.send(("actor_error", self._tid, serialize(
                RayTaskError.from_exception(self._method, exc))))
        if self._scope is not None:
            self._scope.__exit__(None, None, None)
        self._ctx.end_task(self._token)
        try:
            self._ctx.flush_refs()
        except (OSError, BrokenPipeError):
            pass
        return True         # error already shipped as a frame


def _stream_results(ctx: WorkerApiContext, task_id_bin: bytes, out,
                    result_kind: str) -> None:
    """Drive a generator's items through the streaming protocol: each
    yield seals incrementally, the consumer's acks slide the
    backpressure window, and the terminal result frame (``result`` for
    tasks, ``actor_result`` for actor calls) closes the bookkeeping."""
    from ..common.config import get_config
    from .object_ref import serialize_collecting
    window = max(get_config().streaming_backpressure_items, 1)
    ctx.stream_begin(task_id_bin)
    idx = 0
    verdict = "ok"
    try:
        for item in out:
            idx += 1
            data, inner = serialize_collecting(item)
            ctx.send(("stream_item", task_id_bin, idx, data, inner))
            item = data = inner = None
            verdict = ctx.stream_wait_budget(task_id_bin, idx, window)
            if verdict != "ok":
                break   # consumer closed the stream / orphaned
    finally:
        if hasattr(out, "close"):
            out.close()     # GeneratorExit into user code
        ctx.stream_done(task_id_bin)
    # a STALLED end is distinguishable: the head finishes the stream
    # with an error + tears it down, so a slow-but-alive consumer gets
    # a loud failure instead of a silently truncated clean end
    ctx.send(("stream_end", task_id_bin, idx,
              verdict == "stalled"))
    ctx.send((result_kind, task_id_bin, [], []))


def _run_actor_call(ctx: WorkerApiContext, executor: _ActorExecutor,
                    task_id_bin: bytes, method: str, args, kwargs,
                    num_returns: int, trace_ctx) -> None:
    """Execute one actor method call and ship its result — runs inline
    or on a pool thread."""
    with _CallScope(ctx, task_id_bin, method, trace_ctx):
        out = getattr(executor.instance, method)(*args, **kwargs)
        if hasattr(out, "__await__"):
            raise RuntimeError("coroutine escaped the async path")
        if num_returns == -1:
            _stream_results(ctx, task_id_bin, out, "actor_result")
        else:
            _send_call_results(ctx, task_id_bin, method, out,
                               num_returns)


async def _run_actor_call_async(ctx, executor, task_id_bin, method,
                                args, kwargs, num_returns,
                                trace_ctx) -> None:
    with _CallScope(ctx, task_id_bin, method, trace_ctx):
        out = getattr(executor.instance, method)(*args, **kwargs)
        if hasattr(out, "__await__"):
            out = await out
        if num_returns == -1:
            if hasattr(out, "__aiter__"):
                # async generator: collect through the same protocol
                # with awaited iteration
                await _stream_results_async(ctx, task_id_bin, out)
            else:
                # sync generator on the LOOP thread: its backpressure
                # waits block — run it on the executor so concurrent
                # async calls keep serving
                import asyncio
                await asyncio.get_running_loop().run_in_executor(
                    None, _stream_results, ctx, task_id_bin, out,
                    "actor_result")
        else:
            _send_call_results(ctx, task_id_bin, method, out,
                               num_returns)


async def _stream_results_async(ctx, task_id_bin: bytes, out) -> None:
    import asyncio

    from ..common.config import get_config
    from .object_ref import serialize_collecting
    window = max(get_config().streaming_backpressure_items, 1)
    loop = asyncio.get_running_loop()
    ctx.stream_begin(task_id_bin)
    idx = 0
    verdict = "ok"
    try:
        async for item in out:
            idx += 1
            data, inner = serialize_collecting(item)
            ctx.send(("stream_item", task_id_bin, idx, data, inner))
            item = data = inner = None
            # backpressure wait off the loop thread (it blocks)
            verdict = await loop.run_in_executor(
                None, ctx.stream_wait_budget, task_id_bin, idx, window)
            if verdict != "ok":
                break
    finally:
        try:
            await out.aclose()      # user finally/cleanup runs NOW,
        except Exception:           # not at GC finalization
            pass
        ctx.stream_done(task_id_bin)
    ctx.send(("stream_end", task_id_bin, idx,
              verdict == "stalled"))
    ctx.send(("actor_result", task_id_bin, [], []))


def _send_call_results(ctx, task_id_bin, method, out,
                       num_returns: int) -> None:
    from .object_ref import serialize_collecting
    if num_returns == 1:
        results = [out]
    elif num_returns == 0:
        results = []
    else:
        results = list(out)
        if len(results) != num_returns:
            raise ValueError(
                f"actor method {method} declared num_returns="
                f"{num_returns} but returned {len(results)} values")
    payloads, contained = [], []
    for r in results:
        data, inner = serialize_collecting(r)
        payloads.append(data)
        contained.append(inner)
    ctx.send(("actor_result", task_id_bin, payloads, contained))


def worker_main(conn, worker_index: int,
                arena_path: str | None = None,
                runtime_env_payload: dict | None = None) -> None:
    """Entry point of a spawned worker process."""
    # workers never own the GPU: the device data plane belongs to the
    # raylet/driver process; user task code that imports torch sees no
    # CUDA device.  FORCED, not setdefault — the ambient environment may
    # already name the card (owned by the driver), and a worker claiming
    # it would contend for it.  Nothing on this import path imports torch
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # enter the staged runtime environment BEFORE any user code runs
    from .runtime_env import apply_payload
    apply_payload(runtime_env_payload)

    from .. import api

    ctx = WorkerApiContext(conn, arena_path)
    api._set_runtime(ctx)
    from .object_ref import install_counter, serialize_collecting
    install_counter(ctx.ref_counter)
    fn_table: dict[str, object] = {}
    executor: _ActorExecutor | None = None   # dedicated worker: one actor
    actor_id_bin = None
    work_q: queue.SimpleQueue = queue.SimpleQueue()
    threading.Thread(target=ctx.reader_loop, args=(work_q,),
                     daemon=True, name="rt-worker-reader").start()
    ctx.send(("ready",))

    while True:
        msg = work_q.get()
        if msg is None:
            break
        kind = msg[0]
        if kind == "fn":
            fn_table[msg[1]] = deserialize(msg[2])
        elif kind == "exec":
            if len(msg) == 6:
                _, task_id_bin, fn_id, payload, trace_ctx, extern = msg
            else:           # pre-plane frame shape
                _, task_id_bin, fn_id, payload, trace_ctx = msg
                extern = None
            args, kwargs, num_returns = deserialize(payload)
            args = tuple(ctx._materialize(a.desc, extern)
                         if isinstance(a, ArgRef) else a for a in args)
            fn = fn_table[fn_id]
            name = getattr(fn, "__qualname__", str(fn))
            token = ctx.begin_task(TaskID(task_id_bin))
            if trace_ctx is not None:
                # this task's span becomes the ambient scope, so specs
                # it submits inherit (trace_id, THIS span) as context
                from ..util.tracing import span_scope
                _scope = span_scope(trace_ctx[0], TaskID(task_id_bin).hex())
                _scope.__enter__()
            else:
                _scope = None
            try:
                out = fn(*args, **kwargs)
                if num_returns == -1:
                    # streaming generator: each yielded item seals
                    # incrementally; the consumer's acks drive
                    # backpressure (reference: streaming generator
                    # protocol, num_returns="streaming")
                    _stream_results(ctx, task_id_bin, out, "result")
                else:
                    if num_returns == 1:
                        results = [out]
                    elif num_returns == 0:
                        results = []
                    else:
                        results = list(out)
                        if len(results) != num_returns:
                            raise ValueError(
                                f"task {name} declared num_returns="
                                f"{num_returns} but returned "
                                f"{len(results)} values")
                    payloads, contained = [], []
                    for r in results:
                        data, inner = serialize_collecting(r)
                        payloads.append(data)
                        contained.append(inner)
                    ctx.send(("result", task_id_bin, payloads,
                              contained))
            except BaseException as e:  # noqa: BLE001 — any task failure
                err = RayTaskError.from_exception(name, e)
                try:
                    ctx.send(("error", task_id_bin, serialize(err)))
                except Exception:
                    ctx.send(("error", task_id_bin, serialize(
                        RayTaskError(name, err.tb, None))))
            finally:
                if _scope is not None:
                    _scope.__exit__(None, None, None)
                ctx.end_task(token)
                # task locals must die NOW, not when the next exec
                # overwrites these loop variables — their ObjectRefs'
                # decrefs ride the flush below ("r" is the serialization
                # loop variable, still bound to the last result)
                args = kwargs = out = results = payloads = r = None
        elif kind == "actor_new":
            _, actor_id_bin, cls_id, payload = msg
            ctx.actor_id_bin = actor_id_bin
            unpacked = deserialize(payload)
            if len(unpacked) == 3:
                args, kwargs, concurrency = unpacked
            else:           # pre-concurrency frame shape
                args, kwargs = unpacked
                concurrency = None
            cls = fn_table[cls_id]
            token = ctx.begin_task(TaskID.deterministic(actor_id_bin,
                                                        _nil_actor()))
            try:
                instance = cls(*args, **kwargs)
                executor = _ActorExecutor(ctx, instance, concurrency)
                ctx.send(("actor_ready", actor_id_bin))
            except BaseException as e:  # noqa: BLE001
                ctx.send(("actor_init_error", actor_id_bin, serialize(
                    RayTaskError.from_exception(
                        getattr(cls, "__name__", "actor") + ".__init__",
                        e))))
            finally:
                ctx.end_task(token)
                args = kwargs = None
        elif kind == "actor_call":
            _, task_id_bin, method, payload = msg
            unpacked = deserialize(payload)
            if len(unpacked) == 5:
                args, kwargs, num_returns, trace_ctx, group = unpacked
            else:           # pre-concurrency frame shape
                args, kwargs, num_returns, trace_ctx = unpacked
                group = None
            if method == "__ray_terminate__":
                # graceful stop: let in-flight concurrent calls finish
                if executor is not None:
                    executor.shutdown()
                ctx.send(("actor_exit", actor_id_bin))
                ctx.send(("actor_result", task_id_bin,
                          [serialize(None)], [[]]))
                break
            if executor is None:
                ctx.send(("actor_error", task_id_bin, serialize(
                    RayTaskError(method, "actor instance missing"))))
                args = kwargs = None
                continue
            if executor._loop is not None:
                coro_args = (ctx, executor, task_id_bin, method, args,
                             kwargs, num_returns, trace_ctx)
                executor.dispatch(
                    lambda a=coro_args: _run_actor_call_async(*a), group)
            elif executor.inline:
                _run_actor_call(ctx, executor, task_id_bin, method,
                                args, kwargs, num_returns, trace_ctx)
            else:
                call_args = (ctx, executor, task_id_bin, method, args,
                             kwargs, num_returns, trace_ctx)
                executor.dispatch(
                    lambda a=call_args: _run_actor_call(*a), group)
            args = kwargs = None
        elif kind == "shutdown":
            if executor is not None:
                executor.shutdown()
            break
        # ship ref events born while handling this frame (task locals
        # died, results built refs) — per-holder order rides the pipe
        try:
            ctx.flush_refs()
        except (OSError, BrokenPipeError):
            break
    sys.exit(0)


def _nil_actor():
    from ..common.ids import ActorID, JobID
    return ActorID.nil_for_job(JobID.from_int(0))
