"""Distributed FIFO queue backed by an actor.

Reference parity: ``ray.util.queue.Queue``
(``python/ray/util/queue.py`` — SURVEY.md §2.2 util family; mount
empty): a bounded/unbounded FIFO shared by tasks and actors, with
blocking/non-blocking put/get, batch variants, and Empty/Full
exceptions matching ``queue``'s.
"""

from __future__ import annotations

from queue import Empty, Full  # noqa: F401 — re-exported, stdlib-compatible


def _api():
    import ray_tpu_torch
    return ray_tpu_torch


class _QueueActor:
    """The queue's state lives in one actor; blocking semantics come
    from the actor being ASYNC (waiters yield the event loop instead
    of wedging the replica)."""

    def __init__(self, maxsize: int):
        import asyncio
        self._q = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout=None):
        import asyncio
        if timeout is None:
            await self._q.put(item)
            return True
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def put_nowait(self, item):
        try:
            self._q.put_nowait(item)
            return True
        except Exception:   # asyncio.QueueFull
            return False

    async def get(self, timeout=None):
        import asyncio
        if timeout is None:
            return True, await self._q.get()
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except Exception:   # asyncio.QueueEmpty
            return False, None

    def put_nowait_batch(self, items) -> bool:
        """ATOMIC: all items insert or none do (size-checked first)."""
        if self._q.maxsize and \
                self._q.qsize() + len(items) > self._q.maxsize:
            return False
        for it in items:
            self._q.put_nowait(it)
        return True

    def get_nowait_batch(self, n: int):
        """ATOMIC: returns n items or None without consuming any."""
        if self._q.qsize() < n:
            return None
        return [self._q.get_nowait() for _ in range(n)]

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()


class Queue:
    """Shareable FIFO: pass the Queue object into tasks/actors (it
    serializes to its actor handle)."""

    def __init__(self, maxsize: int = 0, *, actor_options: dict | None
                 = None, _actor=None):
        if _actor is not None:
            self._actor = _actor
            return
        ray = _api()
        cls = ray.remote(_QueueActor)
        if actor_options:
            cls = cls.options(**actor_options)
        self._actor = cls.remote(maxsize)

    # -- producer ------------------------------------------------------------
    def put(self, item, block: bool = True,
            timeout: float | None = None) -> None:
        ray = _api()
        if not block:
            if not ray.get(self._actor.put_nowait.remote(item),
                           timeout=30):
                raise Full
            return
        ok = ray.get(self._actor.put.remote(item, timeout),
                     timeout=None if timeout is None else timeout + 30)
        if not ok:
            raise Full

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items) -> None:
        """All-or-nothing (the actor size-checks before inserting)."""
        items = list(items)
        if not items:
            return
        if not _api().get(self._actor.put_nowait_batch.remote(items),
                          timeout=30):
            raise Full

    # -- consumer ------------------------------------------------------------
    def get(self, block: bool = True, timeout: float | None = None):
        ray = _api()
        if not block:
            ok, item = ray.get(self._actor.get_nowait.remote(),
                               timeout=30)
            if not ok:
                raise Empty
            return item
        ok, item = ray.get(
            self._actor.get.remote(timeout),
            timeout=None if timeout is None else timeout + 30)
        if not ok:
            raise Empty
        return item

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> list:
        """All-or-nothing: raises Empty (consuming NOTHING) when fewer
        than ``num_items`` are queued."""
        if num_items <= 0:
            return []
        out = _api().get(
            self._actor.get_nowait_batch.remote(num_items), timeout=30)
        if out is None:
            raise Empty
        return out

    # -- introspection -------------------------------------------------------
    def qsize(self) -> int:
        return _api().get(self._actor.qsize.remote(), timeout=30)

    def empty(self) -> bool:
        return _api().get(self._actor.empty.remote(), timeout=30)

    def full(self) -> bool:
        return _api().get(self._actor.full.remote(), timeout=30)

    def shutdown(self) -> None:
        _api().kill(self._actor)

    @classmethod
    def _from_handle(cls, actor) -> "Queue":
        return cls(_actor=actor)

    def __reduce__(self):
        # serialize to the ACTOR HANDLE only — reconstructing through
        # __init__ would spawn a fresh (leaked) queue actor
        return (Queue._from_handle, (self._actor,))
