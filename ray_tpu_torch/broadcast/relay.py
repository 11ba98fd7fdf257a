"""Relay-as-you-receive: the broadcast plane's wire protocol.

A broadcast tree moves one sealed object from a root to N members over
the existing raw-frame channel.  Each member runs ONE relay session
(``bc_begin``): it pulls chunks in order from its parent and, the
moment a chunk lands in its ingest block, serves that chunk to its own
children (``bc_fetch``) — a receiver becomes a source chunk by chunk,
so the tree pipelines and time-to-all-replicas scales with tree depth
(~log N), not member count.

Wire surface (attached next to the op_* handlers on every plane):

    bc_begin(bcast_id, oid, size, sources, chunk)
        -> run the relay session INLINE on the request thread (each
           request gets its own thread); returns a result dict once the
           local replica is sealed.  ``sources`` is the parent followed
           by the ancestor fallback chain ending at the root.
    bc_fetch(bcast_id, oid, offset, length)
        -> one raw chunk.  Served from the LIVE session's ingest block
           when the chunk has landed (blocking server-side until it
           does — the relay pipeline), from the sealed store after
           commit, or from the sealed store directly when no session
           exists (the root's case).

Failure protocol: a child that loses its parent mid-broadcast (chunk
error, connection loss, stall past ``broadcast_fetch_timeout_s``)
re-parents itself to the next fallback and resumes its missing chunks
— the orphan's own children never notice (they keep fetching from the
orphan).  Only when every fallback incl. the root is gone does
``bc_begin`` fail, and the coordinator falls back to the pull manager's
striped machinery.

Commit discipline: ``commit()`` flips the arena block's birth pin off,
making it spillable — so the session counts outstanding chunk serves
and commits only once the last in-flight serve releases (bounded wait;
a wedged child must not pin the block forever).
"""

from __future__ import annotations

import queue as _queue
import threading
from collections import deque

from ..common.config import get_config
from ..common.ids import ObjectID
from ..common import clock as _clk

# payload-serving kinds, mirrored from the object plane (a "remote"
# entry has no local bytes to serve)
_SERVABLE = ("shm", "spill")


class BroadcastRelayError(RuntimeError):
    """A relay session failed (every source incl. the root is gone, or
    the local store could not stage the ingest)."""


class _RelaySession:
    """One member's side of one broadcast: ingest + relay state."""

    def __init__(self, endpoint, bcast_id: str, oid: ObjectID,
                 size: int, chunk: int, handle):
        self.ep = endpoint
        self.bcast_id = bcast_id
        self.oid = oid
        self.size = size
        self.chunk = chunk
        self.handle = handle
        self.nchunks = max(1, -(-size // chunk))
        self.cv = threading.Condition()
        self.have = [False] * self.nchunks
        self.state = "running"          # -> "committed" | "failed"
        self.serving = 0                # in-flight chunk serves (views)
        self.result: dict | None = None
        # chunk cache for non-arena ingests (spill file / in-memory
        # buffer): handle.view() is None there, so relayed chunks are
        # kept in memory until commit (children then read the sealed
        # entry).  Bounded by the object size; the common shm path
        # never populates it.
        self._cache: dict[int, bytes] = {}
        self.pulled = 0
        self.relayed = 0
        self.reparents = 0

    # -- serving side (bc_fetch) --------------------------------------------
    def serve(self, off: int, ln: int):
        """A child wants ``[off, off+ln)``: block until the covering
        chunk lands, then serve straight from the ingest block (pinned
        via the serving counter until the bytes hit the socket).
        Returns a RawResult, or None when the session has committed and
        the caller should serve the sealed entry instead."""
        from ..rpc.wire import RawResult
        k = min(off // self.chunk, self.nchunks - 1)
        deadline = _clk.monotonic() + get_config().broadcast_fetch_timeout_s
        with self.cv:
            while True:
                if self.state == "committed":
                    return None
                if self.state == "failed":
                    return RawResult((None, 0))
                if self.have[k]:
                    ln2 = max(0, min(ln, self.size - off))
                    view = self.handle.view(off, ln2) if ln2 else None
                    if view is not None:
                        self.serving += 1
                        self.relayed += 1
                        self.ep.chunks_relayed += 1
                        return RawResult(("relay", self.size), view,
                                         release=self._release)
                    data = self._cache.get(k)
                    if data is not None:
                        lo = off - k * self.chunk
                        self.relayed += 1
                        self.ep.chunks_relayed += 1
                        return RawResult(("relay", self.size),
                                         data[lo:lo + ln2])
                    return RawResult((None, 0))
                left = deadline - _clk.monotonic()
                if left <= 0:
                    return RawResult((None, 0))
                self.cv.wait(left)

    def _release(self) -> None:
        with self.cv:
            self.serving -= 1
            self.cv.notify_all()

    # -- receiving side (bc_begin) ------------------------------------------
    def run(self, sources: list[str]) -> dict:
        try:
            self._fetch_all(sources)
            self._finalize_commit()
            res = {"ok": True, "pulled": self.pulled,
                   "relayed": self.relayed, "reparents": self.reparents}
        except Exception as exc:    # noqa: BLE001 — any failure aborts
            self._finalize_abort()
            res = {"ok": False, "error": str(exc), "pulled": self.pulled,
                   "relayed": self.relayed, "reparents": self.reparents}
        with self.cv:
            self.result = res
            self.cv.notify_all()
        return res

    def wait_result(self, timeout: float) -> dict:
        """A duplicate bc_begin (coordinator retry) parks here."""
        deadline = _clk.monotonic() + timeout
        with self.cv:
            while self.result is None:
                left = deadline - _clk.monotonic()
                if left <= 0:
                    return {"ok": False, "error": "duplicate begin timed "
                            "out awaiting the original session"}
                self.cv.wait(left)
            return self.result

    def _fetch_all(self, sources: list[str]) -> None:
        """Windowed in-order chunk fetch from the current source;
        re-parent to the next fallback on failure.  In-order issue is
        deliberate: chunk k lands before k+1, so children waiting on
        the relay pipeline progress front-to-back with no holes."""
        cfg = get_config()
        plane = self.ep.plane
        window = max(1, int(cfg.broadcast_window))
        timeout = cfg.broadcast_fetch_timeout_s
        oid_bin = self.oid.binary()
        can_sink = getattr(self.handle, "view", None) is not None and \
            self.handle.view(0, min(self.chunk, self.size)) is not None
        sink_live = [True]
        done_q: _queue.Queue = _queue.Queue()
        pend: deque = deque(range(self.nchunks))
        inflight: dict[tuple, object] = {}      # (addr, k) -> fut
        si = 0                                  # current source index

        def make_sink(off: int, ln: int):
            if not can_sink:
                return None

            def sink(payload_len: int):
                if not sink_live[0] or payload_len != ln:
                    return None
                return self.handle.view(off, ln)
            return sink

        def reparent(addr: str) -> None:
            """Advance past a dead source (only if it is the CURRENT
            one — stale failures from an already-abandoned parent must
            not skip a healthy fallback)."""
            nonlocal si
            plane._drop_peer(addr)
            if si < len(sources) and sources[si] == addr:
                si += 1
                self.reparents += 1
                self.ep.reparents += 1

        def pump() -> None:
            while pend and len(inflight) < window:
                if si >= len(sources):
                    raise BroadcastRelayError(
                        f"broadcast {self.bcast_id}: every source "
                        f"gone after {self.reparents} re-parents")
                addr = sources[si]
                k = pend.popleft()
                off = k * self.chunk
                ln = min(self.chunk, self.size - off)
                token = (addr, k)
                try:
                    fut = plane._peer(addr).call_async(
                        "bc_fetch", self.bcast_id, oid_bin, off, ln,
                        on_done=lambda t=token: done_q.put(t),
                        sink=make_sink(off, ln))
                except Exception:   # noqa: BLE001 — connect/send failed
                    pend.appendleft(k)
                    reparent(addr)
                    continue
                inflight[token] = fut

        try:
            pump()
            while inflight:
                try:
                    token = done_q.get(timeout=timeout)
                except _queue.Empty:
                    # total stall: the current parent is wedged (gray
                    # link) — re-parent and re-issue its stripes
                    addr = sources[si] if si < len(sources) else None
                    if addr is None:
                        raise BroadcastRelayError(
                            f"broadcast {self.bcast_id}: stalled with "
                            "no fallback left") from None
                    for (a, k) in list(inflight):
                        if a == addr:
                            inflight.pop((a, k))
                            pend.appendleft(k)
                    reparent(addr)
                    pump()
                    continue
                fut = inflight.pop(token, None)
                if fut is None:
                    continue        # re-issued elsewhere already
                addr, k = token
                off = k * self.chunk
                ln = min(self.chunk, self.size - off)
                data = landed = None
                try:
                    rep = fut.result(0)
                    meta = rep.meta
                    if isinstance(meta, tuple) and meta and \
                            meta[0] in (*_SERVABLE, "relay"):
                        data = rep.payload
                        landed = data is None
                except Exception:   # noqa: BLE001 — chunk RPC died
                    data = None
                if self.have[k]:
                    continue        # duplicate landing (late re-issue)
                if landed or (data is not None and len(data) == ln):
                    if not landed:
                        self.handle.write(off, bytes(data))
                        if not can_sink:
                            self._cache[k] = bytes(data)
                    self.pulled += 1
                    self.ep.chunks_pulled += 1
                    with self.cv:
                        self.have[k] = True
                        self.cv.notify_all()
                else:
                    pend.appendleft(k)
                    reparent(addr)
                pump()
        finally:
            sink_live[0] = False
            if inflight:
                # sever connections still owing chunk bytes (a late
                # reply must never land into a freed ingest block) and
                # confirm in-flight receives resolved before unwinding
                for (addr, _k), fut in inflight.items():
                    if not fut.done():
                        plane._drop_peer(addr)
                deadline = _clk.monotonic() + 5.0
                for fut in inflight.values():
                    if not fut.wait(max(0.0,
                                        deadline - _clk.monotonic())):
                        break
        if not all(self.have):
            raise BroadcastRelayError(
                f"broadcast {self.bcast_id}: incomplete "
                f"({sum(self.have)}/{self.nchunks} chunks)")

    def _finalize_commit(self) -> None:
        """Seal: wait (bounded) for in-flight serves to release their
        arena views, commit, then point children at the sealed entry."""
        deadline = _clk.monotonic() + \
            get_config().broadcast_fetch_timeout_s
        with self.cv:
            while self.serving > 0:
                left = deadline - _clk.monotonic()
                if left <= 0:
                    break       # wedged child: commit anyway
                self.cv.wait(left)
        self.handle.commit()
        with self.cv:
            self.state = "committed"
            self._cache.clear()
            self.cv.notify_all()

    def _finalize_abort(self) -> None:
        with self.cv:
            self.state = "failed"
            self.cv.notify_all()
            deadline = _clk.monotonic() + 5.0
            while self.serving > 0:
                left = deadline - _clk.monotonic()
                if left <= 0:
                    break
                self.cv.wait(left)
            self._cache.clear()
        self.handle.abort()


class BroadcastEndpoint:
    """One plane's broadcast surface: live relay sessions plus the
    sealed-store serving path (how a tree's root serves — it has no
    session, just the sealed object)."""

    def __init__(self, plane):
        self.plane = plane
        self._lock = threading.Lock()
        self._sessions: dict[str, _RelaySession] = {}
        # counters (merged into the plane's stats surface)
        self.sessions_started = 0
        self.sessions_completed = 0
        self.sessions_failed = 0
        self.chunks_pulled = 0          # fetched from a parent
        self.chunks_relayed = 0         # served from a LIVE session
        self.chunks_sealed_served = 0   # served from the sealed store
        self.reparents = 0              # fallback advances, all sessions

    def handlers(self) -> dict:
        return {
            "bc_begin": self._bc_begin,
            "bc_fetch": self._bc_fetch,
        }

    def active_sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    def stats(self) -> dict:
        return {
            "bcast_sessions_started": self.sessions_started,
            "bcast_sessions_completed": self.sessions_completed,
            "bcast_sessions_failed": self.sessions_failed,
            "bcast_active_sessions": self.active_sessions(),
            "bcast_chunks_pulled": self.chunks_pulled,
            "bcast_chunks_relayed": self.chunks_relayed,
            "bcast_chunks_sealed_served": self.chunks_sealed_served,
            "bcast_reparents": self.reparents,
        }

    # -- handlers ------------------------------------------------------------
    def _bc_begin(self, bcast_id: str, oid_bin: bytes, size: int,
                  sources: tuple, chunk: int = 0) -> dict:
        """Join a broadcast tree: ingest the object chunk-by-chunk from
        ``sources[0]`` (falling back along the ancestor chain), relaying
        each landed chunk to any child that asks.  Runs inline on this
        request's thread; returns once the local replica is sealed."""
        oid = ObjectID(oid_bin)
        store = self.plane.store
        kind, _sz = store.plasma_info(oid)
        if kind in (*_SERVABLE, "inband"):
            return {"ok": True, "already": True, "pulled": 0,
                    "relayed": 0, "reparents": 0}
        cfg = get_config()
        chunk = int(chunk) or cfg.broadcast_chunk_mb * (1 << 20)
        with self._lock:
            ses = self._sessions.get(bcast_id)
            if ses is not None:
                owner = False
            else:
                handle = store.begin_ingest(oid, int(size))
                if handle is None:
                    return {"ok": True, "already": True, "pulled": 0,
                            "relayed": 0, "reparents": 0}
                ses = _RelaySession(self, bcast_id, oid, int(size),
                                    chunk, handle)
                self._sessions[bcast_id] = ses
                self.sessions_started += 1
                owner = True
        if not owner:
            return ses.wait_result(cfg.broadcast_fetch_timeout_s * 4)
        if getattr(handle, "view", None) is not None and \
                size > chunk:
            # warm the landing pages while chunks are in flight (same
            # rationale as the plane's pull path)
            threading.Thread(target=handle.prefault,
                             name="bcast-prefault", daemon=True).start()
        try:
            res = ses.run([a for a in sources
                           if a and a != self.plane.serve_address])
        finally:
            with self._lock:
                self._sessions.pop(bcast_id, None)
        if res.get("ok"):
            self.sessions_completed += 1
        else:
            self.sessions_failed += 1
        return res

    def _bc_fetch(self, bcast_id: str, oid_bin: bytes, off: int,
                  ln: int):
        """One raw chunk of an in-flight (or finished) broadcast."""
        from ..rpc.wire import RawResult
        with self._lock:
            ses = self._sessions.get(bcast_id)
        if ses is not None and ses.oid.binary() == oid_bin:
            res = ses.serve(off, ln)
            if res is not None:
                n = (res.payload.nbytes
                     if isinstance(res.payload, memoryview)
                     else len(res.payload))
                self.plane.bytes_sent += n
                self.plane.bytes_sent_raw += n
                self.plane.throttle_uplink(n)
                return res
        # no live session: the sealed-store path (the root, a member
        # that already committed, or any node that happens to hold it)
        oid = ObjectID(oid_bin)
        store = self.plane.store
        kind, size = store.plasma_info(oid)
        if kind not in _SERVABLE:
            return RawResult((kind, size))
        buf, release = store.read_range_view(oid, off, ln)
        if buf is None:
            return RawResult(store.plasma_info(oid))
        n = buf.nbytes if isinstance(buf, memoryview) else len(buf)
        self.chunks_sealed_served += 1
        self.plane.bytes_sent += n
        self.plane.bytes_sent_raw += n
        self.plane.throttle_uplink(n)
        return RawResult((kind, size), buf, release=release)
