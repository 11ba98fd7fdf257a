"""Dynamic request micro-batching inside serve replicas.

Reference parity: ``@serve.batch(max_batch_size, batch_wait_timeout_s)``
(``python/ray/serve/batching.py``) turns a method taking ONE item into a
method taking a LIST of items: concurrent calls coalesce into a batch,
the handler runs once per batch, and each caller gets its own element of
the result list (SURVEY.md §1 layer 14; mount empty).

Accelerator inference lives on batch occupancy, so the batcher must
neither starve (ship singletons while peers are in flight) nor stall
(hold a full window when no more callers can possibly arrive).  The
policy here:

- a batch ships when it reaches ``max_batch_size``,
- or when ``batch_wait_timeout_s`` expires,
- or EARLY, when every request currently executing on the replica has
  already joined the batch — the replica shell publishes its live call
  count (``_shell_ctx``), so the batch leader knows nobody else can
  join and waiting out the timeout would be pure added latency.  The
  router's per-replica in-flight cap makes this signal tight: at most
  ``max_ongoing_requests`` calls are ever in flight.

Mechanics: callers append to a shared pending list; the first becomes
the batch LEADER, collects the window, runs the user function once
OUTSIDE the lock, and distributes results.  Leadership releases at
extraction, so the next batch collects while the current one executes
(replicas are threaded actors).  A caller left behind by a full batch
promotes itself to leader of the remainder.

Every executed batch records its size into a process-local histogram
(``util.metrics``) and into GCS KV bucket counters keyed by the
deployment (``_shell_ctx``), which the driver-side metrics/status
surfaces aggregate across replicas.
"""

from __future__ import annotations

import contextvars
import threading
import time

# Set by _ReplicaShell around every __serve_call__: lets the batcher
# find the deployment's KV key (cross-process histogram) and the
# replica's live request count (early batch cut).  Created eagerly at
# import — a lazily-raced creation could hand threads DIFFERENT vars.
_shell_ctx: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "serve_shell_ctx", default=None)

# Batch-size histogram buckets; each batch lands in exactly ONE bucket
# (first `size <= le`); readers cumsum for Prometheus `le` semantics.
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

_hist_lock = threading.Lock()
_hist = None


def _record_batch(batch_size: int) -> None:
    global _hist
    with _hist_lock:
        if _hist is None:
            from ray_tpu_torch.util.metrics import Histogram
            _hist = Histogram(
                "serve_batch_size",
                "Executed micro-batch sizes in this replica process.",
                boundaries=list(BATCH_BUCKETS))
        _hist.observe(batch_size)
    ctx = _shell_ctx.get()
    base = ctx.get("kv_base") if ctx else None
    if not base:
        return
    try:
        from ray_tpu_torch.experimental.internal_kv import _internal_kv_incr
        _internal_kv_incr(f"batchcnt-{base}".encode(), 1,
                          namespace="serve")
        _internal_kv_incr(f"batchsum-{base}".encode(), batch_size,
                          namespace="serve")
        for le in BATCH_BUCKETS:
            if batch_size <= le:
                bucket = str(le)
                break
        else:
            bucket = "inf"
        _internal_kv_incr(f"batchb-{bucket}-{base}".encode(), 1,
                          namespace="serve")
    except Exception:   # noqa: BLE001 — stats must never fail a batch
        pass


def _active_calls() -> int | None:
    """Live __serve_call__ count on this replica, or None outside one."""
    ctx = _shell_ctx.get()
    if not ctx:
        return None
    getter = ctx.get("active")
    return getter() if getter is not None else None


class _Entry:
    __slots__ = ("value", "result", "error", "done")

    def __init__(self, value):
        self.value = value
        self.result = None
        self.error = None
        self.done = False


class _BatchQueue:
    __slots__ = ("cv", "pending", "leading")

    def __init__(self):
        self.cv = threading.Condition()
        self.pending: list[_Entry] = []
        self.leading = False


# Free-function wrappers keep their per-process queue here (keyed by the
# wrapper object itself — cloudpickle re-creates one per process, which
# is exactly the scope a queue must have).  Method wrappers store the
# queue ON the instance, like @multiplexed's cache.
_FREE_LOCK = threading.Lock()
_FREE_QUEUES: dict[int, _BatchQueue] = {}


def _queue_on_instance(obj, attr: str) -> _BatchQueue:
    from ray_tpu_torch.serve.batching import _FREE_LOCK
    q = getattr(obj, attr, None)
    if q is None:
        with _FREE_LOCK:
            q = getattr(obj, attr, None)
            if q is None:
                q = _BatchQueue()
                setattr(obj, attr, q)
    return q


def _free_queue(key: int) -> _BatchQueue:
    from ray_tpu_torch.serve.batching import _FREE_LOCK, _FREE_QUEUES
    with _FREE_LOCK:
        q = _FREE_QUEUES.get(key)
        if q is None:
            q = _FREE_QUEUES[key] = _BatchQueue()
        return q


def batch(fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """``@serve.batch`` — coalesce concurrent single-item calls into one
    list-in/list-out invocation of the wrapped function.

    The wrapped function must take exactly one positional argument (plus
    ``self`` for methods) and, when batched, receives a LIST of those
    arguments; it must return a list of equal length.  A returned
    element that is an ``Exception`` instance is raised for that caller
    alone.
    """
    import functools
    import inspect
    size_cap = max(int(max_batch_size), 1)
    wait_s = max(float(batch_wait_timeout_s), 0.0)

    def deco(handler):
        params = list(inspect.signature(handler).parameters)
        is_method = bool(params) and params[0] == "self"
        queue_attr = f"_serve_batch_q_{handler.__name__}"

        @functools.wraps(handler)
        def wrapper(*args, **kwargs):
            # late imports: the closure must capture only plain values
            # (cloudpickle ships the enclosing user class to replicas)
            from ray_tpu_torch.serve.batching import (_Entry, _active_calls,
                                                _free_queue,
                                                _queue_on_instance,
                                                _record_batch)
            if kwargs or len(args) != (2 if is_method else 1):
                raise TypeError(
                    f"@serve.batch handler {handler.__name__} takes "
                    "exactly one positional argument (the request item)")
            if is_method:
                self_obj, payload = args
                q = _queue_on_instance(self_obj, queue_attr)
            else:
                self_obj, payload = None, args[0]
                q = _free_queue(id(wrapper))
            e = _Entry(payload)
            with q.cv:
                q.pending.append(e)
                q.cv.notify_all()       # wake a collecting leader
            while True:
                with q.cv:
                    if e.done:
                        break
                    if q.leading or e not in q.pending:
                        # someone else leads, or our entry already rode
                        # out in a batch that is executing now — wait
                        # for its completion notify
                        q.cv.wait()
                        continue
                    q.leading = True    # we lead the next batch
                    deadline = time.monotonic() + wait_s
                    while True:
                        n = len(q.pending)
                        if n >= size_cap:
                            break
                        active = _active_calls()
                        if active is not None and n >= active:
                            break   # nobody left to join: cut early
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        q.cv.wait(left)
                    batch_entries = q.pending[:size_cap]
                    del q.pending[:len(batch_entries)]
                    # release leadership BEFORE executing so the next
                    # batch collects while this one runs; a caller left
                    # in pending promotes itself on wake
                    q.leading = False
                    q.cv.notify_all()
                if not batch_entries:
                    continue
                inputs = [en.value for en in batch_entries]
                try:
                    outs = handler(self_obj, inputs) if is_method \
                        else handler(inputs)
                    if not isinstance(outs, (list, tuple)) \
                            or len(outs) != len(inputs):
                        raise TypeError(
                            f"@serve.batch handler {handler.__name__} "
                            f"must return a list of {len(inputs)} "
                            f"results, got {type(outs).__name__}"
                            + (f" of length {len(outs)}"
                               if isinstance(outs, (list, tuple))
                               else ""))
                except BaseException as err:    # noqa: BLE001
                    for en in batch_entries:
                        en.error, en.done = err, True
                else:
                    for en, out in zip(batch_entries, outs):
                        if isinstance(out, Exception):
                            en.error = out
                        else:
                            en.result = out
                        en.done = True
                try:
                    _record_batch(len(batch_entries))
                finally:
                    with q.cv:
                        q.cv.notify_all()
                # our own entry rode in this batch unless a full window
                # formed ahead of us — then lead again for the rest
                if e.done:
                    break
            if e.error is not None:
                raise e.error
            return e.result

        wrapper._serve_batch = True
        wrapper._serve_batch_size = size_cap
        wrapper._serve_batch_wait_s = wait_s
        return wrapper
    return deco if fn is None else deco(fn)
