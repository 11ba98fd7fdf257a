"""ObjectRef — the future type returned by task submission and put.

Reference parity: ``ray.ObjectRef`` wraps the 28-byte ObjectID plus owner
metadata, and its construction/destruction drive the owner's
``ReferenceCounter`` (``python/ray/includes/object_ref.pxi`` — SURVEY.md
§1 layers 7/9; mount empty).  Resolution goes through ``ray_tpu_torch.get``.

The counter hook is process-global and installed only in the owner
(driver) process — worker processes deserialize ObjectRefs freely with no
counting (their borrows are covered by the retained TaskSpec's strong
references on the driver side).  Each instance latches the counter it
registered with so an uninstall (cluster teardown) never produces an
unbalanced decref.
"""

from __future__ import annotations

import contextlib
import threading

from ..common.ids import ObjectID

_counter = None     # the owner-process ReferenceCounter, or None
_suppress = threading.local()   # per-thread: refs built uncounted
_collect = threading.local()    # per-thread: refs pickled inside a payload


def install_counter(counter) -> None:
    """Make new ObjectRefs in this process count against ``counter``."""
    global _counter
    _counter = counter


def install_counter_if_absent(counter) -> bool:
    """Install only when no counter is active.  A ClientRuntime created
    INSIDE a process that already counts (the head, a worker) must not
    steal that process's refs — they keep their original holder and the
    embedded client rides that lifetime."""
    global _counter
    if _counter is not None:
        return False
    _counter = counter
    return True


def uninstall_counter(counter) -> None:
    global _counter
    if _counter is counter:
        _counter = None


@contextlib.contextmanager
def counter_suppressed():
    """ObjectRefs built on THIS thread inside the block are uncounted.

    The head daemon deserializes client-submitted specs/actor args under
    this: the client's own refs are outside the owner counter, so a
    counted server-side twin would eventually decref to zero (lineage
    eviction, actor death) and reclaim objects the client still holds —
    client-held objects take the worker-frame conservative-leak
    ownership instead."""
    prev = getattr(_suppress, "on", False)
    _suppress.on = True
    try:
        yield
    finally:
        _suppress.on = prev


_gen_transfer = threading.local()


@contextlib.contextmanager
def transfer_generators():
    """Collect ObjectRefGenerators pickled on THIS thread inside the
    block WITHOUT marking them transferred; the caller marks them
    (``mark_transferred``) only after the serialized bytes actually
    ship to a consumer.  Pickles outside any such block keep the
    legacy immediate one-shot side effect (see ``__reduce__``)."""
    prev = getattr(_gen_transfer, "gens", None)
    _gen_transfer.gens = []
    try:
        yield _gen_transfer.gens
    finally:
        _gen_transfer.gens = prev


def mark_transferred(gens) -> None:
    """The serialized frame containing these generators was handed to
    its consumer: consumption ownership has moved."""
    for g in gens:
        g._transferred = True


@contextlib.contextmanager
def ref_collector():
    """Record every ObjectRef pickled on THIS thread inside the block.

    Serializing a result/put payload under this yields the ids of the
    refs nested in it; the head registers them as CONTAINED in the
    enclosing object, which keeps them alive until it is reclaimed —
    closing the window where the producer's refs die before the
    consumer deserializes (upstream: ownership info travels with the
    serialized ref)."""
    prev = getattr(_collect, "refs", None)
    _collect.refs = []
    try:
        yield _collect.refs
    finally:
        _collect.refs = prev


class ObjectRefGenerator:
    """The consumer's side of a streaming-generator task
    (``num_returns="streaming"``): iterating yields ObjectRefs for the
    generator's items as they seal, with consumption acks driving the
    producer's backpressure window (reference: ``ObjectRefGenerator``,
    core worker streaming-generator protocol — SURVEY.md §1 layer 7;
    mount empty).

    The runtime must expose ``stream_wait(task_id, index, timeout)`` ->
    (sealed, done, error) and ``stream_ack(task_id, consumed)`` — the
    driver implements them on the TaskManager; the head proxies them
    for clients."""

    def __init__(self, task_id, runtime=None):
        self._task_id = task_id
        self._rt = runtime
        self._i = 0
        self._closed = False
        self._transferred = False
        # deserialized copies carry no runtime: they are the TRANSFER
        # target of a one-shot stream (see close()/__reduce__)
        self._from_wire = runtime is None

    def _runtime(self):
        if self._rt is None:    # deserialized: rebind to this process
            from .. import api
            self._rt = api._get_runtime()
        return self._rt

    @staticmethod
    def _unpack(reply):
        """(sealed, done, error, known) — older 3-field runtimes imply
        known=True."""
        if len(reply) == 4:
            return reply
        sealed, done, error = reply
        return sealed, done, error, True

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        rt = self._runtime()
        sealed, done, error, known = self._unpack(
            rt.stream_wait(self._task_id, self._i, 2.0))
        if self._i >= sealed and not done:
            # no progress in the grace window: re-ack our position (a
            # retried producer restarts with an empty ack table and
            # only this unblocks its backpressure), then wait for real
            rt.stream_ack(self._task_id, self._i)
            sealed, done, error, known = self._unpack(
                rt.stream_wait(self._task_id, self._i, None))
        if not known and self._from_wire and self._i == 0:
            # a deserialized copy against a REAPED stream: the one-shot
            # stream was consumed elsewhere (e.g. this consumer task
            # retried after already draining it) — fail loudly rather
            # than yielding a silently empty stream
            self._closed = True
            raise RuntimeError(
                "stream already consumed: ObjectRefGenerators are "
                "one-shot, and this copy arrived after the stream was "
                "drained and reaped (generator args are incompatible "
                "with task retries)")
        if self._i >= sealed:
            self.close()
            if error is not None:
                raise error.cause if getattr(error, "cause", None) \
                    else error
            raise StopIteration
        self._i += 1
        from ..common.ids import ObjectID
        ref = ObjectRef(ObjectID.for_task_return(self._task_id,
                                                 self._i))
        rt.stream_ack(self._task_id, self._i)
        return ref

    def close(self) -> None:
        """Finish with the stream: cancels a still-running producer and
        reclaims sealed-but-unconsumed items.  Called automatically at
        exhaustion and at garbage collection.  A generator that was
        SERIALIZED (shipped into a task) transferred its consumption
        ownership — the local copy's close/GC must not cancel the
        stream out from under the new consumer."""
        if self._closed:
            return
        self._closed = True
        if self._transferred:
            return
        try:
            self._runtime().stream_close(self._task_id, self._i)
        except Exception:   # noqa: BLE001 — teardown/GC: best-effort
            pass

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001
            pass

    @property
    def task_id(self):
        return self._task_id

    def __reduce__(self):
        gens = getattr(_gen_transfer, "gens", None)
        if gens is not None:
            # inside a transfer_generators() block (task/actor-call
            # serialization): the sender marks us transferred only
            # AFTER the bytes actually ship — a submit that fails after
            # arg serialization keeps the local copy's close/cancel
            gens.append(self)
        else:
            # stray pickle (deepcopy, logging, debug dumps): one-shot
            # semantics apply immediately — the copy consumes, and this
            # instance's close/cancel is permanently disabled.  If you
            # hit this from a non-transfer pickle, don't pickle
            # generators outside task submission.
            self._transferred = True
        return (ObjectRefGenerator, (self._task_id, None))


def serialize_collecting(value) -> tuple[bytes, list[bytes]]:
    """Serialize ``value`` and return (payload, binary ids of every
    ObjectRef pickled inside it) — the shared form of the
    seal-with-containment pattern used by puts and result payloads."""
    from .serialization import serialize
    with ref_collector() as got:
        data = serialize(value)
    return data, [o.binary() for o in got]


class ObjectRef:
    __slots__ = ("_id", "_ct")

    def __init__(self, object_id: ObjectID):
        self._id = object_id
        ct = None if getattr(_suppress, "on", False) else _counter
        self._ct = ct
        if ct is not None:
            ct.incref(object_id)

    def __del__(self):
        ct = self._ct
        if ct is not None:
            try:
                ct.decref(self._id)
            except Exception:
                pass        # interpreter teardown: counter may be gone

    @property
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id()

    def __reduce__(self):
        got = getattr(_collect, "refs", None)
        if got is not None:
            got.append(self._id)
        return (ObjectRef, (self._id,))

    def __await__(self):
        """``await ref`` inside an async actor resolves the object
        (reference: ObjectRefs are awaitable in async actors).  The
        blocking get runs on the loop's default executor so the event
        loop keeps serving other coroutines."""
        return self._resolve_async().__await__()

    async def _resolve_async(self):
        import asyncio
        loop = asyncio.get_running_loop()

        def blocking_get():
            from .. import api
            return api.get(self)
        return await loop.run_in_executor(None, blocking_get)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self):
        return hash(self._id)

    def __repr__(self):
        return f"ObjectRef({self._id.hex()[:16]}…)"
