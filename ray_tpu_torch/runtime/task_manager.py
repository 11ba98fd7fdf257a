"""Owner-side task bookkeeping: lifetimes, retries, completion, lineage.

Reference parity: the core worker's ``TaskManager`` (retry budget and
completion accounting for submitted tasks) plus its lineage pinning —
completed specs are retained for object reconstruction until the
``lineage_pinning_memory_mb`` budget evicts them oldest-first, and a
record is released early once every return object has gone out of scope
(``src/ray/core_worker/task_manager.cc``, SURVEY.md §1 layer 7, §5.3/§5.4;
mount empty).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field

from ..common.config import get_config
from ..common.ids import ObjectID, TaskID
from ..common.task_spec import TaskSpec
from ..common import clock as _clk


@dataclass
class TaskRecord:
    spec: TaskSpec
    retries_left: int
    return_ids: list[ObjectID]
    done: bool = False
    recovering: bool = False        # a reconstruction resubmit is in flight
    lineage_bytes: int = 0          # retained-spec cost while done
    dead_returns: set = field(default_factory=set)


@dataclass
class StreamState:
    """Streaming-generator progress for one producing task or actor
    call (spec/call ``num_returns == -1``): highest sealed item index,
    whether the producer finished (and its error), and whether the
    consumer closed the stream.  Lives in its OWN table so actor calls
    (which have no TaskRecord) stream through the same machinery."""
    sealed: int = 0
    done: bool = False
    error: object = None
    closed: bool = False


class TaskManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._stream_cv = threading.Condition()     # stream progress
        self._streams: dict[TaskID, StreamState] = {}
        self._records: dict[TaskID, TaskRecord] = {}
        # completed records in retention order (lineage eviction is FIFO:
        # oldest finished task loses reconstructability first)
        self._done: "OrderedDict[TaskID, TaskRecord]" = OrderedDict()
        self._lineage_bytes = 0
        self._budget = get_config().lineage_pinning_memory_mb * (1 << 20)
        self.lineage_evictions = 0

    def register(self, spec: TaskSpec) -> TaskRecord:
        # streaming generators (num_returns == -1) have no fixed return
        # set: items seal incrementally as the generator yields
        n = max(spec.num_returns, 0)
        return_ids = [ObjectID.for_task_return(spec.task_id, i + 1)
                      for i in range(n)]
        rec = TaskRecord(spec, spec.max_retries, return_ids)
        with self._lock:
            self._records[spec.task_id] = rec
        if spec.num_returns == -1:
            self.stream_open(spec.task_id)
        return rec

    def list_rows(self) -> list[dict]:
        """State-API rows for every live record (pending/running +
        lineage-retained finished) — keeps the storage layout private."""
        with self._lock:
            records = list(self._records.items()) + \
                list(self._done.items())
        rows, seen = [], set()
        for tid, rec in records:
            if tid in seen:
                continue
            seen.add(tid)
            rows.append({
                "task_id": tid.hex(),
                "name": rec.spec.function_descriptor,
                "state": "FINISHED" if rec.done
                else "PENDING_OR_RUNNING",
                "num_returns": rec.spec.num_returns,
                "retries_left": rec.retries_left,
                "resources": rec.spec.resources.to_dict()})
        return rows

    def get(self, task_id: TaskID) -> TaskRecord | None:
        with self._lock:
            return self._records.get(task_id)

    def get_many(self, task_ids) -> list:
        """Batch record lookup: one lock round-trip for a whole
        placement beat's hand-off (the fused dispatch path).  Returns
        one record-or-None per id, in order."""
        with self._lock:
            return [self._records.get(t) for t in task_ids]

    def complete(self, task_id: TaskID) -> TaskRecord | None:
        """Mark done and move the record into the lineage retention window
        (sized by ``lineage_pinning_memory_mb``); evicted records lose
        reconstructability, and their specs' strong references to argument
        ObjectRefs drop (the refcount cascade)."""
        with self._lock:
            rec = self._records.get(task_id)
            if rec is None:
                return None
            if rec.done:                # double-completion (cancel races a
                return rec              # late result): already accounted
            rec.done = True
            rec.recovering = False
            if not rec.lineage_bytes:
                # never dispatched (failed pre-dispatch): flat floor — the
                # dispatch path stamps the real serialized size
                rec.lineage_bytes = 256
            if rec.return_ids and \
                    rec.dead_returns.issuperset(rec.return_ids):
                # nothing downstream can ever need this lineage
                del self._records[task_id]
                return rec
            self._done[task_id] = rec
            self._lineage_bytes += rec.lineage_bytes
            self._evict_over_budget_locked()
            return rec

    def _evict_over_budget_locked(self) -> None:
        # records of OPEN streams are pinned: evicting one mid-iteration
        # would silently truncate the consumer's stream (wait_stream
        # reads unknown records as "ended")
        skipped = []
        while self._lineage_bytes > self._budget and self._done:
            tid, rec = self._done.popitem(last=False)
            if rec.spec.num_returns == -1 and \
                    self.stream_accepts(tid):
                skipped.append((tid, rec))
                continue
            self._lineage_bytes -= rec.lineage_bytes
            self._records.pop(tid, None)
            self.lineage_evictions += 1
        for tid, rec in reversed(skipped):
            self._done[tid] = rec
            self._done.move_to_end(tid, last=False)

    def on_return_reclaimed(self, object_id: ObjectID) -> None:
        """A return object went out of scope cluster-wide: once ALL of a
        finished task's returns are dead its lineage is released (nothing
        can ask for reconstruction — reference: lineage release on
        out-of-scope, SURVEY §5.3)."""
        tid = object_id.task_id()
        with self._lock:
            rec = self._records.get(tid)
            if rec is None:
                return
            rec.dead_returns.add(object_id)
            if rec.done and rec.return_ids and \
                    rec.dead_returns.issuperset(rec.return_ids):
                del self._records[tid]
                if self._done.pop(tid, None) is not None:
                    self._lineage_bytes -= rec.lineage_bytes

    def mark_reconstructing(self, task_id: TaskID) -> bool:
        """Claim a record for a reconstruction resubmit.  Consumes one
        retry; False when already in flight (dedupe), unknown, evicted, or
        out of retries."""
        with self._lock:
            rec = self._records.get(task_id)
            if rec is None:
                return False
            if rec.recovering or not rec.done:
                return True     # a resubmit (or first run) is in flight
            if rec.retries_left <= 0:
                return False
            rec.retries_left -= 1
            rec.spec.attempt_number += 1
            rec.done = False
            rec.recovering = True
            if self._done.pop(task_id, None) is not None:
                self._lineage_bytes -= rec.lineage_bytes
            # dead_returns is kept: already-reclaimed returns must NOT be
            # re-sealed by the reconstruction (a re-sealed dead return has
            # no refs and no pending decref — it would never be reclaimed)
            return True

    def should_retry(self, task_id: TaskID) -> bool:
        """Consume one retry if any remain (worker-crash path)."""
        with self._lock:
            rec = self._records.get(task_id)
            if rec is None or rec.done or rec.retries_left <= 0:
                return False
            rec.retries_left -= 1
            rec.spec.attempt_number += 1
            return True

    # -- streaming generators -----------------------------------------------
    def stream_open(self, task_id: TaskID) -> None:
        """Register a stream at submission time: a consumer's wait on a
        never-opened (or fully finished+closed) stream reads as ended."""
        with self._stream_cv:
            self._streams.setdefault(task_id, StreamState())

    def stream_accepts(self, task_id: TaskID) -> bool:
        """May a produced item still seal?  False once the consumer
        closed the stream (or it was never opened / already reaped)."""
        with self._stream_cv:
            st = self._streams.get(task_id)
            return st is not None and not st.closed

    def stream_item_sealed(self, task_id: TaskID, index: int) -> None:
        """Item ``index`` (1-based) sealed.  Uses max() so a retrying
        re-execution's re-seals are idempotent."""
        with self._stream_cv:
            st = self._streams.get(task_id)
            if st is not None:
                st.sealed = max(st.sealed, index)
            self._stream_cv.notify_all()

    def stream_finished(self, task_id: TaskID, error=None) -> None:
        with self._stream_cv:
            st = self._streams.get(task_id)
            if st is not None:
                st.done = True
                if error is not None and st.error is None:
                    st.error = error
                if st.closed:
                    del self._streams[task_id]  # both sides finished
            self._stream_cv.notify_all()

    def wait_stream(self, task_id: TaskID, index: int,
                    timeout: float | None = None):
        """Block until item ``index+1`` exists or the stream finished.
        Returns (sealed, done, error, known); known=False means the
        stream was never opened or already reaped (closed + done) —
        consumers distinguish a one-shot stream consumed elsewhere from
        a legitimately empty one."""
        deadline = None if timeout is None else \
            _clk.monotonic() + timeout
        with self._stream_cv:
            while True:
                st = self._streams.get(task_id)
                if st is None:
                    return 0, True, None, False
                if st.sealed > index or st.done:
                    return st.sealed, st.done, st.error, True
                if deadline is not None:
                    remaining = deadline - _clk.monotonic()
                    if remaining <= 0:
                        return st.sealed, st.done, st.error, True
                    self._stream_cv.wait(remaining)
                else:
                    self._stream_cv.wait()

    def stream_abandon(self, task_id: TaskID, error) -> list:
        """Producer-side stall teardown: finish the stream with the
        error (RETAINING the state so a slow consumer's next wait sees
        a loud failure, not a clean end) and return every sealed item
        for reclamation — the payloads must not leak even though the
        error tombstone stays until the consumer closes."""
        with self._stream_cv:
            st = self._streams.get(task_id)
            if st is None:
                return []
            st.done = True
            if st.error is None:
                st.error = error
            orphans = [ObjectID.for_task_return(task_id, i)
                       for i in range(1, st.sealed + 1)]
            rec = self._records.get(task_id)
            if rec is not None:
                rec.dead_returns.update(orphans)
            self._stream_cv.notify_all()
        return orphans

    def stream_close(self, task_id: TaskID, consumed: int) -> list:
        """The consumer is done with a stream (exhausted it or abandoned
        it): unpin lineage eviction and return the ids of sealed-but-
        unconsumed items for the caller to reclaim.  Those ids also
        become dead returns (when a task record exists) so a producer
        retry cannot re-seal them."""
        with self._stream_cv:
            st = self._streams.get(task_id)
            if st is None:
                return []
            st.closed = True
            orphans = [ObjectID.for_task_return(task_id, i)
                       for i in range(consumed + 1, st.sealed + 1)]
            rec = self._records.get(task_id)
            if rec is not None:
                rec.dead_returns.update(orphans)
            if st.done:
                del self._streams[task_id]      # both sides finished
            self._stream_cv.notify_all()
        return orphans

    def pending_count(self) -> int:
        with self._lock:
            return sum(not r.done for r in self._records.values())

    def stats(self) -> dict:
        with self._lock:
            return {"num_records": len(self._records),
                    "num_done_retained": len(self._done),
                    "lineage_bytes": self._lineage_bytes,
                    "lineage_evictions": self.lineage_evictions}
