"""ActorPool: spread work over a fixed set of actor handles.

Reference parity: ``ray.util.ActorPool``
(``python/ray/util/actor_pool.py`` — SURVEY.md §2.2 util family;
mount empty): submit ``fn(actor, value)`` pairs, collect results in
submission order (``get_next``) or completion order
(``get_next_unordered``); ``map``/``map_unordered`` batch the pattern;
idle actors are reusable across rounds and can be pushed/popped.
"""

from __future__ import annotations


def _api():
    import ray_tpu_torch
    return ray_tpu_torch


class ActorPool:
    def __init__(self, actors):
        self._idle = list(actors)
        self._future_to_actor: dict = {}    # ref key -> (index, actor)
        self._index_to_future: dict = {}    # submit index -> ref
        self._next_task_index = 0
        self._next_return_index = 0         # ordered get cursor
        self._pending_submits: list = []    # (fn, value) awaiting actor

    # -- submission ----------------------------------------------------------
    def submit(self, fn, value) -> None:
        """Schedule ``fn(actor, value)`` on an idle actor; queued until
        one frees otherwise."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref.binary()] = (
                self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    # -- collection ----------------------------------------------------------
    def get_next(self, timeout: float | None = None):
        """Next result in SUBMISSION order.  A timeout raises
        TimeoutError WITHOUT consuming anything (retryable: wait
        first, consume after).  The actor returns to the pool before
        the final get, so a task exception never leaks it (actors
        serialize their calls — an early re-submit just queues)."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ref = self._index_to_future.get(self._next_return_index)
        if ref is None:
            raise RuntimeError(
                "submissions are queued but the pool has no actors "
                "to run them (all popped?)")
        ready, _ = _api().wait([ref], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._return_actor(ref)
        return _api().get(ref)

    def get_next_unordered(self, timeout: float | None = None):
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        refs = list(self._index_to_future.values())
        if not refs:
            raise RuntimeError(
                "submissions are queued but the pool has no actors "
                "to run them (all popped?)")
        ready, _ = _api().wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        for idx, f in list(self._index_to_future.items()):
            if f.binary() == ref.binary():
                del self._index_to_future[idx]
                break
        self._return_actor(ref)
        return _api().get(ref)

    def _return_actor(self, ref) -> None:
        _idx, actor = self._future_to_actor.pop(ref.binary())
        self._idle.append(actor)
        self._drain_pending()

    def _drain_pending(self) -> None:
        while self._pending_submits and self._idle:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    # -- batch helpers -------------------------------------------------------
    def map(self, fn, values):
        """Results in submission order (lazy iterator)."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn, values):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # -- pool membership -----------------------------------------------------
    def push(self, actor) -> None:
        self._idle.append(actor)
        self._drain_pending()

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
