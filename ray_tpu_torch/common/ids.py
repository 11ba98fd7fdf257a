"""Unique identifiers for every entity in the system.

Reference parity: upstream Ray defines 128-bit (and longer, structured) binary
ids in ``src/ray/common/id.h`` — ``ObjectID``/``TaskID``/``ActorID``/``JobID``/
``NodeID``/``PlacementGroupID`` — with structured derivation (an ObjectID embeds
the TaskID of its producing task plus a put/return index, a TaskID embeds the
ActorID/JobID, ...).  [Reference mount was empty; path cited per SURVEY.md §1
layer 1, unverified line numbers.]

TPU-first design notes: ids never reach the device — device-side scheduling
works on dense *indices* (node row numbers, group row numbers).  Ids exist only
on the host control plane, so a compact ``bytes``-backed value type is all we
need.  Structured derivation is kept because lineage reconstruction (SURVEY
§5.3) and ownership accounting need to map an ObjectID back to its producing
TaskID without a lookup table.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import ClassVar

_NIL = b"\xff"

# fast unique-bytes stream: one getrandom(2) syscall per TaskID
# (~30 us each) dominates the tiny-task submit path, so hot-path ids
# draw from an os.urandom-seeded PRNG instead — full 64-bit entropy
# per draw (collision odds identical to true-random bytes), reseeded
# on fork/spawn (pid check) so child processes never share a stream
_fast_rng = None
_fast_rng_pid = -1
_fast_rng_lock = threading.Lock()


def fast_random_bytes(n: int) -> bytes:
    global _fast_rng, _fast_rng_pid
    rng = _fast_rng
    if rng is None or _fast_rng_pid != os.getpid():
        import random
        with _fast_rng_lock:
            if _fast_rng is None or _fast_rng_pid != os.getpid():
                _fast_rng = random.Random(os.urandom(32))
                _fast_rng_pid = os.getpid()
            rng = _fast_rng
    # randbytes is a single C call: atomic under the GIL, so concurrent
    # threads get distinct (never interleaved/corrupted) draws
    return rng.randbytes(n)


class BaseID:
    """Immutable binary id. Subclasses fix SIZE (bytes)."""

    SIZE: ClassVar[int] = 16
    __slots__ = ("_bin",)

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, "
                f"got {binary!r}"
            )
        object.__setattr__(self, "_bin", binary)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(_NIL * cls.SIZE)

    # -- accessors ----------------------------------------------------------
    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._bin.hex()

    def is_nil(self) -> bool:
        return self._bin == _NIL * self.SIZE

    # -- dunder -------------------------------------------------------------
    def __setattr__(self, *_):
        raise AttributeError(f"{type(self).__name__} is immutable")

    def __reduce__(self):
        # default slots-state pickling would setattr on load, which the
        # immutability guard forbids; rebuild through __init__ instead
        return (type(self), (self._bin,))

    def __eq__(self, other):
        return type(other) is type(self) and other._bin == self._bin

    def __hash__(self):
        return hash((type(self).__name__, self._bin))

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]}…)" if self.SIZE > 8 \
            else f"{type(self).__name__}({self.hex()})"

    def __lt__(self, other):
        return self._bin < other._bin


class JobID(BaseID):
    SIZE = 4

    _counter = 0
    _lock = threading.Lock()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(4, "big"))

    @classmethod
    def next(cls) -> "JobID":
        with cls._lock:
            cls._counter += 1
            return cls.from_int(cls._counter)


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class ActorID(BaseID):
    """12 unique bytes + 4-byte JobID suffix."""

    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(os.urandom(12) + job_id.binary())

    def job_id(self) -> JobID:
        return JobID(self._bin[12:])

    @classmethod
    def nil_for_job(cls, job_id: JobID) -> "ActorID":
        return cls(_NIL * 12 + job_id.binary())


class PlacementGroupID(BaseID):
    SIZE = 16

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(os.urandom(12) + job_id.binary())


class TaskID(BaseID):
    """8 unique bytes + 16-byte parent ActorID (which embeds the JobID)."""

    SIZE = 24

    @classmethod
    def for_task(cls, job_id: JobID, actor_id: ActorID | None = None) -> "TaskID":
        actor = actor_id if actor_id is not None else ActorID.nil_for_job(job_id)
        return cls(fast_random_bytes(8) + actor.binary())

    @classmethod
    def deterministic(cls, seed: bytes, actor_id: ActorID) -> "TaskID":
        return cls(hashlib.sha256(seed).digest()[:8] + actor_id.binary())

    def actor_id(self) -> ActorID:
        return ActorID(self._bin[8:])

    def job_id(self) -> JobID:
        return self.actor_id().job_id()


class ObjectID(BaseID):
    """24-byte producing TaskID + 4-byte index (big endian).

    index semantics mirror the reference: return values of a task get indices
    1..n; ``put`` objects use a separate per-worker counter offset by 2**31 so
    the two namespaces never collide.
    """

    SIZE = 28
    PUT_INDEX_OFFSET = 1 << 31

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_id.binary() + index.to_bytes(4, "big"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        idx = cls.PUT_INDEX_OFFSET + put_index
        return cls(task_id.binary() + idx.to_bytes(4, "big"))

    def task_id(self) -> TaskID:
        return TaskID(self._bin[:24])

    def index(self) -> int:
        return int.from_bytes(self._bin[24:], "big")

    def is_put(self) -> bool:
        return self.index() >= self.PUT_INDEX_OFFSET


ObjectRefID = ObjectID  # alias used by the runtime layer
