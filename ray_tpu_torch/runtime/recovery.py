"""Object recovery: reconstruct lost objects from retained lineage.

Reference parity: the core worker's ``ObjectRecoveryManager`` — when a
plasma object's last copy is lost (node death, eviction), the owner
re-submits the producing task from its pinned lineage, recursively
recovering missing dependencies first; objects with no retained lineage
(puts, exhausted retries, evicted specs) surface ``ObjectLostError``
(``src/ray/core_worker/object_recovery_manager.cc``, SURVEY.md §5.3;
mount empty).
"""

from __future__ import annotations

import threading

from ..common.ids import ObjectID
from ..common.task_spec import TaskType
from .object_ref import ObjectRef
from ..common import clock as _clk


class ObjectRecoveryManager:
    def __init__(self, cluster):
        self._cluster = cluster
        self._lock = threading.Lock()
        self.num_reconstructions = 0
        self.num_unrecoverable = 0

    def recover(self, object_id: ObjectID) -> bool:
        """Try to reconstruct ``object_id`` by re-running its producing
        task.  Returns True when a reconstruction is (already) in flight —
        the object will re-seal and waiters wake; False when the object is
        unrecoverable (caller poisons it)."""
        self._await_completion_window(object_id)     # BEFORE the lock:
        # this can wait up to 2s, and holding the manager lock through it
        # would serialize recoveries of unrelated objects behind it
        with self._lock:
            ok = self._recover_locked(object_id)
        if not ok:
            self.num_unrecoverable += 1
        return ok

    def _await_completion_window(self, object_id: ObjectID) -> None:
        """Seal-to-complete window: the producer ALREADY delivered this
        object (seal precedes complete) and the completion is mid-flight
        on a reader thread — nothing in flight will re-seal.  Wait for
        done (normally microseconds) so recovery takes the normal
        retained-lineage path; treating this as "first execution in
        flight" would delete the sealed value and strand every waiter."""
        if object_id.is_put():
            return
        rec = self._cluster.task_manager.get(object_id.task_id())
        if rec is None:
            return
        deadline = _clk.monotonic() + 2.0
        while (not rec.done and self._cluster.store.contains(object_id)
               and _clk.monotonic() < deadline):
            _clk.sleep(0.0005)

    def _recover_locked(self, object_id: ObjectID) -> bool:
        if object_id.is_put():
            return False        # puts have no producing task (reference:
            #                     put objects are not reconstructable)
        tm = self._cluster.task_manager
        rec = tm.get(object_id.task_id())
        if rec is None:         # lineage evicted or unknown owner
            return False
        if rec.spec.task_type is not TaskType.NORMAL_TASK:
            # actor-task outputs need the actor's state replayed — out of
            # scope for lineage reconstruction (reference behaves the same
            # unless the actor itself restarts and replays)
            return False
        if not rec.done:
            # first execution (or an earlier reconstruction) in flight:
            # drop the lost copy's stale entry and wait for its re-seal
            self._drop_entry(object_id)
            return True
        if rec.retries_left <= 0:
            return False
        # recursively recover missing dependencies FIRST: a failed dep
        # makes this object unrecoverable before we claim its record
        store = self._cluster.store
        for a in rec.spec.args:
            if isinstance(a, ObjectRef) and not store.contains(a.id):
                if not self._recover_locked(a.id):
                    return False
        if not tm.mark_reconstructing(rec.spec.task_id):
            return False
        # the lost copy's store entry must go away so gets block until the
        # re-execution seals a fresh value (seal-once: a stale entry would
        # shadow it)
        self._drop_entry(object_id)
        self.num_reconstructions += 1
        self._cluster.head().submit_existing(rec)
        return True

    def _drop_entry(self, object_id: ObjectID) -> None:
        self._cluster.store.delete([object_id])
        self._cluster.directory.drop([object_id])

    def stats(self) -> dict:
        return {"num_reconstructions": self.num_reconstructions,
                "num_unrecoverable": self.num_unrecoverable}
