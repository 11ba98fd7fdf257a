"""Object store: in-band values + shared-memory arena + spill/restore.

Reference parity: upstream splits objects between the core worker's
in-process memory store (small/in-band) and the plasma shared-memory store
(large, zero-copy mmap reads, spill to external storage past a threshold)
— ``src/ray/core_worker/store_provider/memory_store/``,
``src/ray/object_manager/plasma/``, ``LocalObjectManager`` spill
(SURVEY.md §1 layers 6-7; mount empty).

Routing: serialized payloads larger than ``max_direct_call_object_size``
live in the native arena (``ray_tpu_torch/native/arena.cc``) and are read
zero-copy by worker processes attaching the same /dev/shm file; smaller
objects are held in-band as Python values.  When arena occupancy crosses
``object_spilling_threshold`` (or allocation fails), the least-recently-
used sealed objects spill to ``object_spilling_dir`` and restore on
demand (plasma's spill/restore semantics).

Semantics carried over: objects are sealed-once immutable; ``get`` blocks
with timeout; storing a ``RayTaskError`` poisons the object — every get
raises it (task failure propagation).  Put listeners drive the dependency
manager (task args become ready) without polling.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

from ..common.ids import ObjectID
from .serialization import RayError, RayTaskError, deserialize
from ..common import clock as _clk


class GetTimeoutError(RayError, TimeoutError):
    """ray.get timed out (reference: ``ray.exceptions.GetTimeoutError``)."""


class ObjectLostError(RayError):
    """Object was freed/lost and cannot be reconstructed (reference:
    ``ray.exceptions.ObjectLostError``)."""


class ObjectStoreFullError(RayError, MemoryError):
    """Arena and spill both exhausted (reference:
    ``ray.exceptions.ObjectStoreFullError``)."""


class RemoteObjectUnavailable(KeyError):
    """A read hit a metadata-only RemoteEntry: the bytes live on another
    node's plane and were not pulled first.  Read paths are expected to
    go through the pull manager; this surfacing means a caller skipped
    it."""


@dataclass
class ShmEntry:
    """Sealed serialized payload resident in the shared arena.

    ``pins`` counts descriptors currently handed out to workers (plasma's
    in-use semantics): a pinned entry is never spilled or freed, so the
    worker's zero-copy read cannot race a reallocation of its block."""
    offset: int
    size: int
    pins: int = 0


@dataclass
class SpillEntry:
    """Payload spilled to disk; restored to the arena on access."""
    path: str
    size: int


@dataclass
class RemoteEntry:
    """Metadata-only seal: the payload lives in ANOTHER node's store
    (rows per the object directory).  The head records these for objects
    sealed on agent machines so dependency tracking (`contains`,
    `on_ready`) works without the bytes ever transiting the head —
    materialization goes through the pull manager, which replaces this
    entry with real bytes via ``begin_ingest``/``commit`` (reference:
    the local plasma store simply lacks the object and the PullManager
    fetches it; here absence-with-metadata is an explicit entry because
    one store doubles as the owner's metadata table)."""
    size: int

# plasma_info() kinds that are directory-tracked and transferable
PLASMA_KINDS = ("shm", "spill", "remote")


def _NO_RELEASE() -> None:
    """Release hook for buffers that hold no pin (spill reads)."""


class MemoryStore:
    def __init__(self, arena=None, spill_dir: str | None = None,
                 direct_call_threshold: int | None = None,
                 spill_threshold: float | None = None):
        from ..common.config import get_config
        cfg = get_config()
        self._cv = threading.Condition()
        # LRU order: least-recently-touched first (spill victims)
        self._objects: "OrderedDict[ObjectID, object]" = OrderedDict()
        self._listeners: dict[ObjectID, list[Callable[[ObjectID], None]]] = {}
        self.arena = arena
        self._spill_dir = spill_dir
        self._threshold = (direct_call_threshold
                          if direct_call_threshold is not None
                          else cfg.max_direct_call_object_size)
        self._spill_frac = (spill_threshold if spill_threshold is not None
                            else cfg.object_spilling_threshold)
        self.spilled_bytes = 0
        self.restored_bytes = 0
        # deleted-while-pinned shm entries, keyed by (oid, offset) so a
        # re-seal + re-delete of the same object id cannot overwrite an
        # older zombie; the block is freed only when the last outstanding
        # descriptor is unpinned
        self._zombies: dict[tuple[ObjectID, int], ShmEntry] = {}

    # -- write --------------------------------------------------------------
    def put(self, object_id: ObjectID, value) -> None:
        """Seal an in-band Python value (first write wins; real bytes
        upgrade a metadata-only RemoteEntry)."""
        with self._cv:
            existing = self._objects.get(object_id)
            if existing is not None and \
                    not isinstance(existing, RemoteEntry):
                return
            self._objects[object_id] = value
            listeners = self._listeners.pop(object_id, ())
            self._cv.notify_all()
        for cb in listeners:
            cb(object_id)

    def put_serialized(self, object_id: ObjectID, data) -> None:
        """Seal a serialized payload, routing by size: large payloads go
        to the shared arena (zero-copy reads), small ones are held in-band
        as the deserialized value."""
        data = memoryview(data)
        if self.arena is None or data.nbytes <= self._threshold:
            self.put(object_id, deserialize(data))
            return
        with self._cv:
            existing = self._objects.get(object_id)
            if existing is not None and \
                    not isinstance(existing, RemoteEntry):
                return
            try:
                entry = self._shm_put_locked(data)
            except ObjectStoreFullError:
                # arena exhausted even after spilling (e.g. one payload
                # larger than the arena, or everything pinned): never
                # strand waiters — spill the payload straight to disk, or
                # hold it in-band when there is no spill dir (the restore
                # path's bytes fallback, in reverse)
                entry = self._spill_direct_locked(object_id, data)
                if entry is None:
                    entry = deserialize(data)
            self._objects[object_id] = entry
            listeners = self._listeners.pop(object_id, ())
            self._cv.notify_all()
        for cb in listeners:
            cb(object_id)

    def _shm_put_locked(self, data) -> ShmEntry:
        """Allocate+copy into the arena, spilling LRU victims as needed.
        Caller holds the lock."""
        from ..native import ArenaFullError
        if data.nbytes >= self.arena.capacity():
            # can NEVER fit: fail fast instead of evicting the whole
            # arena first (an over-capacity object would otherwise turn
            # every restore attempt into a full spill storm)
            raise ObjectStoreFullError(
                f"payload of {data.nbytes} bytes exceeds arena capacity "
                f"{self.arena.capacity()}")
        self._maybe_spill_locked(data.nbytes)
        while True:
            try:
                off = self.arena.alloc(data.nbytes)
                break
            except ArenaFullError:
                if not self._spill_one_locked():
                    raise ObjectStoreFullError(
                        f"object store full: cannot place {data.nbytes} "
                        f"bytes (capacity {self.arena.capacity()})")
        self.arena.write(off, data)
        return ShmEntry(off, data.nbytes)

    def _maybe_spill_locked(self, incoming: int) -> None:
        if self.arena is None:
            return
        budget = int(self.arena.capacity() * self._spill_frac)
        while self.arena.bytes_in_use() + incoming > budget:
            if not self._spill_one_locked():
                break

    def _spill_one_locked(self) -> bool:
        """Spill the least-recently-used UNPINNED shm object to disk.
        Pinned entries are skipped: a worker may hold their (offset, size)
        descriptor and read the block at any moment."""
        victim = None
        for oid, entry in self._objects.items():      # LRU first
            if isinstance(entry, ShmEntry) and entry.pins == 0:
                victim = (oid, entry)
                break
        if victim is None or self._spill_dir is None:
            return False
        oid, entry = victim
        path = self._write_spill_file(oid, self.arena.view(entry.offset,
                                                           entry.size))
        self.arena.free(entry.offset)
        self._objects[oid] = SpillEntry(path, entry.size)
        self.spilled_bytes += entry.size
        return True

    def _write_spill_file(self, object_id: ObjectID, data) -> str:
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir, object_id.hex())
        with open(path, "wb") as f:
            f.write(data)
        return path

    def _spill_direct_locked(self, object_id: ObjectID,
                             data) -> SpillEntry | None:
        """Payload that cannot enter the arena goes straight to disk
        (sealed as a SpillEntry); None when no spill dir is configured."""
        if self._spill_dir is None:
            return None
        path = self._write_spill_file(object_id, data)
        self.spilled_bytes += data.nbytes
        return SpillEntry(path, data.nbytes)

    def _restore_locked(self, object_id: ObjectID,
                        entry: SpillEntry) -> ShmEntry | bytes:
        """Bring a spilled payload back; prefer the arena (zero-copy for
        readers), fall back to raw bytes if it cannot fit."""
        with open(entry.path, "rb") as f:
            data = f.read()
        self.restored_bytes += len(data)
        try:
            shm = self._shm_put_locked(memoryview(data))
        except ObjectStoreFullError:
            return data
        os.unlink(entry.path)
        self._objects[object_id] = shm
        return shm

    def put_remote(self, object_id: ObjectID, size: int) -> None:
        """Seal a remote-resident object's METADATA (first write wins):
        the bytes live on another node's plane; local readers go through
        the pull manager, which ingests real bytes over this entry."""
        with self._cv:
            if object_id in self._objects:
                return
            self._objects[object_id] = RemoteEntry(size)
            listeners = self._listeners.pop(object_id, ())
            self._cv.notify_all()
        for cb in listeners:
            cb(object_id)

    # -- wire-level transfer (object plane) ----------------------------------
    def read_range(self, object_id: ObjectID, offset: int,
                   length: int) -> bytes | None:
        """One chunk of a sealed payload for an arena-to-arena transfer;
        None when the object has no local bytes (absent/remote/in-band).
        Shm reads copy under a transient pin so a concurrent spill/free
        cannot reallocate the block mid-read; spill reads go straight to
        the file without restoring.  A spill file vanishing mid-read is
        re-checked against the entry — a concurrent RESTORE unlinks the
        file while moving the bytes into the arena (the object is still
        live; only a true delete returns None)."""
        for _ in range(4):
            with self._cv:
                entry = self._objects.get(object_id)
                if isinstance(entry, ShmEntry):
                    # a peer asking past the end (stale size metadata,
                    # malformed op_read) must not produce a negative-
                    # length arena view on the RPC handler thread
                    if offset < 0 or offset >= entry.size:
                        return b""
                    entry.pins += 1
                    pin = (object_id, entry.offset)
                    view = self.arena.view(entry.offset + offset,
                                           min(length,
                                               entry.size - offset))
                elif isinstance(entry, SpillEntry):
                    if offset < 0:
                        return b""      # seek would raise
                    path = entry.path
                    view = None
                else:
                    return None
            if view is not None:
                try:
                    return bytes(view)
                finally:
                    self.unpin([pin])
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    return f.read(length)
            except OSError:
                continue        # restore/delete raced: re-check entry
        return None

    def read_range_view(self, object_id: ObjectID, offset: int,
                        length: int):
        """Zero-copy variant of ``read_range`` for the raw data channel:
        ``(buffer, release)`` where the buffer is an arena memoryview
        pinned until ``release()`` runs (the RPC server calls it once
        the bytes are on the socket), or plain spill-file bytes with a
        no-op release.  ``(None, None)`` when the object has no local
        bytes."""
        for _ in range(4):
            with self._cv:
                entry = self._objects.get(object_id)
                if isinstance(entry, ShmEntry):
                    if offset < 0 or offset >= entry.size:
                        return b"", _NO_RELEASE
                    entry.pins += 1
                    pin = (object_id, entry.offset)
                    view = self.arena.view(entry.offset + offset,
                                           min(length,
                                               entry.size - offset))
                    return view, lambda: self.unpin([pin])
                if isinstance(entry, SpillEntry):
                    if offset < 0:
                        return b"", _NO_RELEASE
                    path = entry.path
                else:
                    return None, None
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    return f.read(length), _NO_RELEASE
            except OSError:
                continue        # restore/delete raced: re-check entry
        return None, None

    def begin_ingest(self, object_id: ObjectID, size: int):
        """Start receiving a remote object's bytes: returns an
        ``IngestHandle`` (write chunks, then commit — which seals over
        any RemoteEntry), or None when local bytes already exist.
        Prefers an arena block (spilling LRU victims for room); falls
        back to writing a spill file when the arena cannot take it."""
        with self._cv:
            entry = self._objects.get(object_id)
            if entry is not None and not isinstance(entry, RemoteEntry):
                return None
            if self.arena is not None and size > self._threshold:
                try:
                    shm = self._alloc_ingest_locked(size)
                    return _IngestHandle(self, object_id, shm=shm)
                except ObjectStoreFullError:
                    pass
        if self._spill_dir is None:
            # tiny object or no spill dir: buffer in memory
            return _IngestHandle(self, object_id, buf=bytearray(size))
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir,
                            object_id.hex() + ".ingest")
        return _IngestHandle(self, object_id, path=path, size=size)

    def _alloc_ingest_locked(self, size: int) -> ShmEntry:
        """Arena block for an in-flight ingest (caller holds the lock).
        Pinned from birth so the spill scan never victimizes a block
        that is still being written."""
        shm = self._shm_put_locked_alloc(size)
        shm.pins = 1
        return shm

    def _shm_put_locked_alloc(self, size: int) -> ShmEntry:
        """Allocate (no copy) with the same eviction discipline as
        ``_shm_put_locked``."""
        from ..native import ArenaFullError
        if size >= self.arena.capacity():
            raise ObjectStoreFullError(
                f"payload of {size} bytes exceeds arena capacity "
                f"{self.arena.capacity()}")
        self._maybe_spill_locked(size)
        while True:
            try:
                off = self.arena.alloc(size)
                return ShmEntry(off, size)
            except ArenaFullError:
                if not self._spill_one_locked():
                    raise ObjectStoreFullError(
                        f"object store full: cannot place {size} bytes "
                        f"(capacity {self.arena.capacity()})") from None

    def _commit_ingest(self, object_id: ObjectID, entry) -> None:
        """Seal ingested bytes over an absent or RemoteEntry slot."""
        with self._cv:
            existing = self._objects.get(object_id)
            if existing is not None and \
                    not isinstance(existing, RemoteEntry):
                # lost the race to another ingest/seal: discard ours
                self._release_entry(entry)
                return
            if isinstance(entry, ShmEntry):
                entry.pins = 0      # birth pin released at seal
            self._objects[object_id] = entry
            listeners = self._listeners.pop(object_id, ())
            self._cv.notify_all()
        for cb in listeners:
            cb(object_id)

    def drop_remote_entry(self, object_id: ObjectID) -> None:
        """Remove a metadata-only RemoteEntry (its backing copies are
        gone — node death).  Real local entries are left alone; waiters
        re-park on absence and wake at the re-seal or poison."""
        with self._cv:
            if isinstance(self._objects.get(object_id), RemoteEntry):
                del self._objects[object_id]

    def delete(self, object_ids: Iterable[ObjectID]) -> None:
        with self._cv:
            for oid in object_ids:
                entry = self._objects.pop(oid, None)
                if isinstance(entry, ShmEntry) and entry.pins > 0:
                    # a worker still holds a descriptor: defer the free
                    # until the last unpin (plasma: delete waits for the
                    # in-use count to drop)
                    self._zombies[(oid, entry.offset)] = entry
                    continue
                self._release_entry(entry)

    def inline_bytes(self, oid, desc) -> bytes:
        """Copy a PINNED shm descriptor's payload and release the pin —
        the in-band form shipped to workers that share no arena (remote
        node agents, ``raylet.inline_objects``)."""
        try:
            return bytes(self.arena.view(desc[1], desc[2]))
        finally:
            self.unpin([(oid, desc[1])])

    def unpin(self, pins: Iterable) -> None:
        """Release descriptor pins taken by ``descriptor_of`` /
        ``get_descriptors_blocking`` (one unpin per shm descriptor handed
        out).  Each pin is an ObjectID or an ``(ObjectID, offset)`` pair;
        the offset disambiguates a deleted-while-pinned block from a
        later re-seal of the same object id (the offset is unique while
        the block stays allocated).  Frees deleted-while-pinned blocks at
        pin count zero."""
        with self._cv:
            for p in pins:
                oid, off = p if isinstance(p, tuple) else (p, None)
                entry = self._objects.get(oid)
                if isinstance(entry, ShmEntry) and \
                        (off is None or entry.offset == off):
                    if entry.pins > 0:
                        entry.pins -= 1
                    continue
                if off is not None:
                    zkey = (oid, off)
                else:       # id-only unpin: any zombie of this object
                    zkey = next((k for k in self._zombies if k[0] == oid),
                                None)
                z = self._zombies.get(zkey) if zkey is not None else None
                if z is not None:
                    z.pins -= 1
                    if z.pins <= 0:
                        del self._zombies[zkey]
                        self._release_entry(z)
            self._cv.notify_all()

    def _release_entry(self, entry) -> None:
        if isinstance(entry, ShmEntry) and self.arena is not None:
            self.arena.free(entry.offset)
        elif isinstance(entry, SpillEntry):
            try:
                os.unlink(entry.path)
            except OSError:
                pass

    def routes_to_plasma(self, nbytes: int) -> bool:
        """Will a payload of this size seal into the arena (directory-
        tracked)?  Callers use this to pre-register locations BEFORE the
        seal: sealing wakes dependent-task placement, so the directory
        must already know where the bytes live or the locality probe
        races an empty entry."""
        return self.arena is not None and nbytes > self._threshold

    def plasma_info(self, object_id: ObjectID) -> tuple[str | None, int]:
        """(kind, size): kind is "shm" | "spill" (plasma-routed, has
        directory locations), "inband" (ships with specs), or None
        (absent)."""
        with self._cv:
            e = self._objects.get(object_id)
            if isinstance(e, ShmEntry):
                return "shm", e.size
            if isinstance(e, SpillEntry):
                return "spill", e.size
            if isinstance(e, RemoteEntry):
                return "remote", e.size
            return (None, 0) if e is None else ("inband", 0)

    def poison(self, object_id: ObjectID, error) -> None:
        """Replace a LOST object's entry with an in-band error value so
        every current and future reader surfaces the loss instead of
        hanging (reference: lost plasma objects raise ObjectLostError).
        The only sanctioned break of seal-once immutability; pinned
        blocks park as zombies until their descriptors release."""
        with self._cv:
            entry = self._objects.get(object_id)
            if isinstance(entry, ShmEntry) and entry.pins > 0:
                self._zombies[(object_id, entry.offset)] = entry
            else:
                self._release_entry(entry)
            self._objects[object_id] = error
            listeners = self._listeners.pop(object_id, ())
            self._cv.notify_all()
        for cb in listeners:
            cb(object_id)

    # -- materialization ----------------------------------------------------
    def _value_locked(self, object_id: ObjectID):
        """Deserialize/restore an entry into a Python value; touches LRU."""
        entry = self._objects[object_id]
        self._objects.move_to_end(object_id)
        if isinstance(entry, RemoteEntry):
            raise RemoteObjectUnavailable(
                f"object {object_id.hex()[:12]} is resident on a remote "
                "plane; pull it first")
        if isinstance(entry, SpillEntry):
            entry = self._restore_locked(object_id, entry)
            if isinstance(entry, bytes):
                return deserialize(entry)
        if isinstance(entry, ShmEntry):
            return deserialize(self.arena.view(entry.offset, entry.size))
        return entry

    def _descriptor_locked(self, object_id: ObjectID):
        """Wire form for worker replies: ("v", value) in-band, or
        ("s", offset, size) for zero-copy shm reads.  Spilled objects are
        restored first; if the arena can't take them, bytes go in-band.
        Shm descriptors PIN the entry — the caller owes one
        ``unpin([object_id])`` once the worker is done with the block."""
        entry = self._objects[object_id]
        self._objects.move_to_end(object_id)
        if isinstance(entry, RemoteEntry):
            raise RemoteObjectUnavailable(
                f"object {object_id.hex()[:12]} is resident on a remote "
                "plane; pull it first")
        if isinstance(entry, SpillEntry):
            entry = self._restore_locked(object_id, entry)
            if isinstance(entry, bytes):
                return ("b", entry)
        if isinstance(entry, ShmEntry):
            entry.pins += 1
            return ("s", entry.offset, entry.size)
        return ("v", entry)

    # -- read ---------------------------------------------------------------
    def contains(self, object_id: ObjectID) -> bool:
        with self._cv:
            return object_id in self._objects

    def _await_locked(self, object_ids: Sequence[ObjectID],
                      deadline: float | None) -> bool:
        """Wait (caller holds lock) until all ids exist. False on timeout."""
        while True:
            missing = [o for o in object_ids if o not in self._objects]
            if not missing:
                return True
            if deadline is not None:
                remaining = deadline - _clk.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            else:
                self._cv.wait()

    def get(self, object_ids: Sequence[ObjectID],
            timeout: float | None = None) -> list:
        """Blocking fetch of all ids (in order). Raises stored errors."""
        deadline = None if timeout is None else _clk.monotonic() + timeout
        with self._cv:
            if not self._await_locked(object_ids, deadline):
                missing = sum(o not in self._objects for o in object_ids)
                raise GetTimeoutError(
                    f"get timed out; {missing} of {len(object_ids)} "
                    "objects not ready")
            values = [self._value_locked(o) for o in object_ids]
        for v in values:
            if isinstance(v, RayTaskError):
                raise v.cause if v.cause is not None else v
        return values

    def wait(self, object_ids: Sequence[ObjectID], num_returns: int,
             timeout: float | None = None
             ) -> tuple[list[ObjectID], list[ObjectID]]:
        """ray.wait semantics: (ready, not_ready), order-preserving."""
        deadline = None if timeout is None else _clk.monotonic() + timeout
        with self._cv:
            while True:
                ready = [o for o in object_ids if o in self._objects]
                if len(ready) >= num_returns:
                    break
                if deadline is not None:
                    remaining = deadline - _clk.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                else:
                    self._cv.wait()
            ready_set = set(ready[:num_returns]) if len(ready) > num_returns \
                else set(ready)
            ready_list = [o for o in object_ids if o in ready_set]
            not_ready = [o for o in object_ids if o not in ready_set]
            return ready_list, not_ready

    def get_raw_presence(self, object_ids: Sequence[ObjectID],
                         timeout: float | None = None) -> bool:
        """Block until every id EXISTS (any entry kind, including
        metadata-only RemoteEntry); no materialization.  False on
        timeout."""
        deadline = None if timeout is None else _clk.monotonic() + timeout
        with self._cv:
            return self._await_locked(object_ids, deadline)

    def get_raw_blocking(self, object_ids: Sequence[ObjectID],
                         timeout: float | None = None) -> list | None:
        """Blocking fetch WITHOUT error unwrap — stored RayTaskError values
        are returned as values (the worker-side get re-raises them).
        Returns None on timeout."""
        deadline = None if timeout is None else _clk.monotonic() + timeout
        with self._cv:
            if not self._await_locked(object_ids, deadline):
                return None
            return [self._value_locked(o) for o in object_ids]

    def get_descriptors_blocking(self, object_ids: Sequence[ObjectID],
                                 timeout: float | None = None
                                 ) -> list | None:
        """Blocking fetch of wire descriptors for a worker reply: shm
        objects ship as (offset, size) for zero-copy reads, small ones as
        in-band values.  Returns None on timeout."""
        deadline = None if timeout is None else _clk.monotonic() + timeout
        with self._cv:
            if not self._await_locked(object_ids, deadline):
                return None
            return [self._descriptor_locked(o) for o in object_ids]

    def peek(self, object_id: ObjectID):
        """Non-blocking read (materializes); KeyError if absent."""
        with self._cv:
            return self._value_locked(object_id)

    def descriptor_of(self, object_id: ObjectID):
        """Non-blocking wire descriptor; KeyError if absent."""
        with self._cv:
            return self._descriptor_locked(object_id)

    def error_of(self, object_id: ObjectID):
        """Non-blocking: the stored ``RayTaskError`` if this object's
        entry is an in-band error value, else None.  Error results are
        always stored in-band (never shm/spill), so this never
        materializes a data payload — completion observers use it to
        classify a sealed result without paying a deserialize."""
        with self._cv:
            e = self._objects.get(object_id)
        return e if isinstance(e, RayTaskError) else None

    # -- listeners (dependency manager hook) --------------------------------
    def on_ready(self, object_id: ObjectID,
                 callback: Callable[[ObjectID], None]) -> None:
        """Invoke ``callback(oid)`` once the object exists (immediately if
        it already does). Callback runs without the store lock held."""
        with self._cv:
            if object_id not in self._objects:
                self._listeners.setdefault(object_id, []).append(callback)
                return
        callback(object_id)

    def cancel_on_ready(self, object_id: ObjectID, callback) -> None:
        """Deregister a pending ``on_ready`` listener (no-op if it already
        fired or was never registered) — abandoning waiters must not leak
        closures."""
        with self._cv:
            lst = self._listeners.get(object_id)
            if lst is not None:
                try:
                    lst.remove(callback)
                except ValueError:
                    return
                if not lst:
                    del self._listeners[object_id]

    # -- introspection ------------------------------------------------------
    def size(self) -> int:
        with self._cv:
            return len(self._objects)

    def list_objects(self) -> list[tuple]:
        """(object_id, size_bytes, kind) rows for the state API; size
        is known for shm/spilled entries, -1 for in-band values."""
        with self._cv:
            out = []
            for oid, entry in self._objects.items():
                if isinstance(entry, ShmEntry):
                    out.append((oid, entry.size, "shm"))
                elif isinstance(entry, SpillEntry):
                    out.append((oid, entry.size, "spilled"))
                elif isinstance(entry, RemoteEntry):
                    out.append((oid, entry.size, "remote"))
                else:
                    out.append((oid, -1, "in_band"))
            return out

    def stats(self) -> dict:
        with self._cv:
            shm = sum(isinstance(e, ShmEntry)
                      for e in self._objects.values())
            spilled = sum(isinstance(e, SpillEntry)
                          for e in self._objects.values())
            remote = sum(isinstance(e, RemoteEntry)
                         for e in self._objects.values())
            return {
                "num_objects": len(self._objects),
                "num_shm": shm,
                "num_spilled": spilled,
                "num_remote": remote,
                "num_pinned": sum(
                    isinstance(e, ShmEntry) and e.pins > 0
                    for e in self._objects.values()),
                "arena_bytes_in_use": (self.arena.bytes_in_use()
                                       if self.arena else 0),
                "arena_capacity": (self.arena.capacity()
                                   if self.arena else 0),
                "spilled_bytes": self.spilled_bytes,
                "restored_bytes": self.restored_bytes,
            }


class _IngestHandle:
    """Destination side of one arena-to-arena transfer: chunks land
    directly in their final home (arena block, spill file, or an
    in-memory buffer for sub-threshold payloads) — no whole-object
    staging copy.  ``commit`` seals; ``abort`` releases."""

    def __init__(self, store: MemoryStore, object_id: ObjectID,
                 shm: ShmEntry | None = None, path: str | None = None,
                 size: int = 0, buf: bytearray | None = None):
        self._store = store
        self._oid = object_id
        self._shm = shm
        self._path = path
        self._size = size if shm is None else shm.size
        self._buf = buf
        self._file = open(path, "wb") if path is not None else None
        self._done = False

    def prefault(self) -> None:
        """Touch one byte per page of an arena ingest block so the
        first-touch faults (tmpfs page allocation + zeroing — the bulk
        of a cold landing write's cost) are paid here, overlapped with
        the network transfer, instead of serializing into the chunk
        landings.  Native + GIL-free (``Arena.touch``) so the walk runs
        on a spare core instead of convoying the reader thread; reads
        only, safe concurrent with ``write``."""
        if self._shm is None:
            return
        try:
            self._store.arena.touch(self._shm.offset, self._size)
        except (ValueError, AttributeError):
            pass        # arena closed mid-walk: best effort

    def view(self, offset: int, length: int):
        """Writable view of ``[offset, offset+length)`` in the landing
        block, for receiving wire bytes straight into their final home
        (shm ingest only; None otherwise — callers fall back to the
        buffered receive + ``write`` path)."""
        if self._shm is None or offset + length > self._size:
            return None
        return self._store.arena.view(self._shm.offset + offset, length)

    def write(self, offset: int, data: bytes) -> None:
        if self._shm is not None:
            self._store.arena.write(self._shm.offset + offset,
                                    memoryview(data))
        elif self._buf is not None:
            self._buf[offset:offset + len(data)] = data
        else:
            self._file.seek(offset)
            self._file.write(data)

    def commit(self) -> None:
        if self._done:
            return
        self._done = True
        if self._shm is not None:
            self._store._commit_ingest(self._oid, self._shm)
        elif self._buf is not None:
            # sub-threshold payload: seal as the in-band value, like
            # put_serialized's small route
            self._store._commit_ingest(self._oid,
                                       deserialize(bytes(self._buf)))
        else:
            self._file.close()
            final = self._path[:-len(".ingest")]
            os.replace(self._path, final)
            self._store.spilled_bytes += self._size
            self._store._commit_ingest(self._oid,
                                       SpillEntry(final, self._size))

    def abort(self) -> None:
        if self._done:
            return
        self._done = True
        if self._shm is not None:
            with self._store._cv:
                self._store.arena.free(self._shm.offset)
        elif self._file is not None:
            self._file.close()
            try:
                os.unlink(self._path)
            except OSError:
                pass
