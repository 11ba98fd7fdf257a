"""Wire-level object plane: chunked arena-to-arena transfer between nodes.

Reference parity: upstream's ``ObjectManager`` moves sealed plasma
objects between raylets directly — receiver-driven chunked pulls through
``ObjectBufferPool``, source chosen by the ``PullManager`` cost model,
with the GCS carrying only directory updates (``src/ray/object_manager/
object_manager.cc``, ``object_buffer_pool.h`` — SURVEY.md §2.1, §3.3;
mount empty).

The rebuild's shape: every machine with an arena (the head, each node
agent) exposes data-plane RPC handlers on its existing server —

    op_stat(oid)                 -> (kind, size) of the LOCAL entry
    op_fetch(oid, offset, len)   -> one RAW-channel chunk; the reply
                                    piggybacks (kind, size) so chunk 0
                                    doubles as the stat round-trip
    op_read(oid, offset, length) -> one pickled-channel chunk (fallback)
    op_pull(oid, size, src, srcs)-> fetch the object FROM src (striping
                                    over srcs) into the local store
    op_free(oids)                -> drop local copies (refcount zero)
    op_plane_stats()             -> local store + plane stats

A transfer is always driven by the RECEIVER: the pull manager (head)
tells the destination plane to ``op_pull`` from the chosen source; the
destination then issues chunk calls against the source(s) until the
payload is complete, writing each chunk straight into its final home
(arena block or spill file — ``MemoryStore.begin_ingest``).  Payload
bytes flow source→destination only; the head sees directory updates.

Throughput shape (vs the original lockstep loop):

* **Raw-frame data channel** — chunk payloads bypass the pickle codec
  in both directions (``rpc/wire.py`` raw reply frames): the source
  serves memoryview slices straight out of its shm arena / spill file,
  the receiver lands a receive-buffer view straight into the ingest
  handle.  One copy per side instead of four-plus.
* **Windowed pipelining** — up to ``object_transfer_window`` chunk
  requests ride the connection concurrently (the RpcClient demuxes by
  req_id), capped so window x chunk never exceeds the pull manager's
  in-flight quota.  Large-object throughput becomes bandwidth-bound,
  not RTT-bound.
* **Multi-source striping** — with >=2 replicas, chunk ranges stripe
  round-robin across sources; a source dying mid-transfer reassigns
  only its unfinished stripes to the survivors (and only if ALL
  sources die does the pull fail back to the PullManager's retry
  machinery).
"""

from __future__ import annotations

import queue as _queue
import threading
from collections import deque

from ..common.config import get_config
from ..common.ids import ObjectID
from ..common import clock as _clk

# payload-serving kinds (a "remote" entry has no local bytes to serve)
_SERVABLE = ("shm", "spill")
_CHUNK_TIMEOUT = 60.0


class PlaneTransferError(RuntimeError):
    """A chunked transfer failed (source lost the object mid-pull, link
    dropped, or the destination could not stage it)."""


class ObjectPlane:
    """One node's endpoint on the object plane: serves its local store
    and pulls remote objects into it.

    ``serve_address`` is the RPC address peers use to read from this
    plane (set when the owning server attaches the handlers); transfers
    TO this plane work without it."""

    def __init__(self, store):
        from ..broadcast.relay import BroadcastEndpoint
        self.store = store
        self.serve_address: str | None = None
        self._peers: dict[str, object] = {}     # address -> RpcClient
        self._peers_lock = threading.Lock()
        # broadcast plane: relay sessions + bc_* wire surface ride on
        # this plane's server and peer cache
        self.bcast = BroadcastEndpoint(self)
        # outbound pacing (plane_uplink_mbps): serialized token bucket
        # over every chunk-serving reply on this endpoint
        self._uplink_lock = threading.Lock()
        self._uplink_free = 0.0     # monotonic instant the link frees
        self._gc_q: deque = deque()             # (address, [oid_bin])
        self._gc_cv = threading.Condition()
        self._gc_thread: threading.Thread | None = None
        self._stopped = False
        # stats — serving side
        self.bytes_sent = 0
        self.bytes_sent_raw = 0
        self.bytes_sent_pickled = 0
        # stats — pulling side
        self.bytes_received = 0
        self.bytes_received_raw = 0
        self.bytes_received_pickled = 0
        self.transfers_in = 0
        self.transfers_failed = 0
        self.stripe_retries = 0         # chunk ranges reassigned after
        #                                 a source died mid-stripe
        self.window_occupancy = 0       # chunk requests in flight NOW
        self.window_peak = 0            # high-water mark of the above
        self.last_transfer_mbps = 0.0   # most recent completed transfer
        self.ewma_transfer_mbps = 0.0   # smoothed across transfers
        # source blacklist: addr -> [consecutive failures, last failure
        # monotonic].  A source that times out / short-chunks repeatedly
        # is skipped for plane_source_blacklist_s while ANY other
        # replica remains — striped pulls stop re-trying a gray link on
        # every transfer (failures also feed its peer circuit breaker)
        self._blk_lock = threading.Lock()
        self._src_fail: dict[str, list] = {}

    # -- serving side (attach to an RpcServer) ------------------------------
    def handlers(self) -> dict:
        out = {
            "op_stat": self._op_stat,
            "op_read": self._op_read,
            "op_fetch": self._op_fetch,
            "op_pull": self._op_pull,
            "op_free": self._op_free,
            "op_plane_stats": self._op_plane_stats,
        }
        out.update(self.bcast.handlers())
        return out

    def attach(self, server) -> None:
        for name, fn in self.handlers().items():
            server.add_handler(name, fn)
        self.serve_address = server.address

    def _op_stat(self, oid_bin: bytes):
        return self.store.plasma_info(ObjectID(oid_bin))

    def throttle_uplink(self, nbytes: int) -> None:
        """Outbound pacing: when ``plane_uplink_mbps`` caps this
        endpoint's serving rate, delay the reply until the modeled link
        frees.  Token-bucket over a shared next-free instant; the sleep
        runs OUTSIDE the lock, so concurrent chunk serves queue behind
        each other exactly like frames on one uplink."""
        rate = get_config().plane_uplink_mbps
        if rate <= 0 or nbytes <= 0:
            return
        cost = nbytes / (rate * (1 << 20))
        with self._uplink_lock:
            now = _clk.monotonic()
            start = max(now, self._uplink_free)
            self._uplink_free = start + cost
            wait = start + cost - now
        if wait > 0:
            _clk.sleep(wait)

    def _op_read(self, oid_bin: bytes, offset: int,
                 length: int) -> bytes | None:
        """Pickled-channel chunk (compat / raw-channel-off fallback)."""
        data = self.store.read_range(ObjectID(oid_bin), offset, length)
        if data is not None:
            self.bytes_sent += len(data)
            self.bytes_sent_pickled += len(data)
            self.throttle_uplink(len(data))
        return data

    def _op_fetch(self, oid_bin: bytes, offset: int, length: int):
        """Raw-channel chunk.  The reply's meta carries this store's
        (kind, size) for the object, so the FIRST chunk request doubles
        as the stat round-trip — small objects complete in one RTT.
        An empty payload with a non-servable kind means 'no local
        bytes' (the puller fails over to another source)."""
        from ..rpc.wire import RawResult
        oid = ObjectID(oid_bin)
        kind, size = self.store.plasma_info(oid)
        if kind not in _SERVABLE:
            return RawResult((kind, size))
        buf, release = self.store.read_range_view(oid, offset, length)
        if buf is None:
            # entry vanished between stat and read (freed mid-transfer)
            return RawResult(self.store.plasma_info(oid))
        n = buf.nbytes if isinstance(buf, memoryview) else len(buf)
        self.bytes_sent += n
        self.bytes_sent_raw += n
        self.throttle_uplink(n)
        return RawResult((kind, size), buf, release=release)

    def _op_pull(self, oid_bin: bytes, size: int, src_addr: str,
                 src_addrs: tuple = ()) -> bool:
        """Receiver-driven fetch into the LOCAL store."""
        return self.pull_into_local(ObjectID(oid_bin), size, src_addr,
                                    src_addrs)

    def _op_free(self, oid_bins: list[bytes]) -> None:
        self.store.delete([ObjectID(b) for b in oid_bins])

    def stats(self) -> dict:
        """Plane-only counters (no store stats): the observability
        surface ``PullManager.stats`` and ``ray_tpu_torch status`` merge."""
        return {
            "plane_bytes_sent": self.bytes_sent,
            "plane_bytes_received": self.bytes_received,
            "plane_raw_bytes_sent": self.bytes_sent_raw,
            "plane_pickled_bytes_sent": self.bytes_sent_pickled,
            "plane_raw_bytes_received": self.bytes_received_raw,
            "plane_pickled_bytes_received": self.bytes_received_pickled,
            "plane_transfers_in": self.transfers_in,
            "plane_transfers_failed": self.transfers_failed,
            "plane_stripe_retries": self.stripe_retries,
            "plane_window_occupancy": self.window_occupancy,
            "plane_window_peak": self.window_peak,
            "plane_last_transfer_mbps": round(self.last_transfer_mbps, 2),
            "plane_ewma_transfer_mbps": round(self.ewma_transfer_mbps, 2),
            "plane_blacklisted_sources": len(self.blacklisted_sources()),
            **self.bcast.stats(),
        }

    def _op_plane_stats(self) -> dict:
        s = self.store.stats()
        s.update(self.stats())
        return s

    # -- source blacklist (gray-failure quarantine for striped pulls) --------
    def _note_source_failure(self, addr: str) -> None:
        from ..rpc import breaker as _breaker
        _breaker.record_failure(addr)
        now = _clk.monotonic()
        ttl = get_config().plane_source_blacklist_s
        with self._blk_lock:
            row = self._src_fail.get(addr)
            if row is None or now - row[1] > ttl:
                self._src_fail[addr] = [1, now]
            else:
                row[0] += 1
                row[1] = now

    def _note_source_ok(self, addr: str) -> None:
        with self._blk_lock:
            self._src_fail.pop(addr, None)

    def _blacklisted(self, addr: str) -> bool:
        cfg = get_config()
        with self._blk_lock:
            row = self._src_fail.get(addr)
            if row is None:
                return False
            if _clk.monotonic() - row[1] > cfg.plane_source_blacklist_s:
                del self._src_fail[addr]    # decayed: forgiven
                return False
            return row[0] >= cfg.plane_source_blacklist_failures

    def blacklisted_sources(self) -> list[str]:
        return [a for a in list(self._src_fail) if self._blacklisted(a)]

    # -- pulling side --------------------------------------------------------
    def pull_into_local(self, oid: ObjectID, size: int, src_addr: str,
                        src_addrs: tuple = ()) -> bool:
        """Fetch ``oid`` from the plane at ``src_addr`` (striping across
        ``src_addrs`` replicas when profitable), landing bytes straight
        into this store (arena or spill file).  True on success OR when
        local bytes already exist."""
        kind, _local_size = self.store.plasma_info(oid)
        if kind in ("shm", "spill", "inband"):
            return True
        cfg = get_config()
        raw = cfg.object_transfer_raw_channel
        chunk = cfg.object_transfer_chunk_mb * (1 << 20)
        # candidate sources: primary first, deduped, never ourselves
        sources = []
        for a in (src_addr, *src_addrs):
            if a and a != self.serve_address and a not in sources:
                sources.append(a)
        # skip blacklisted sources while any clean replica remains (a
        # fully-blacklisted set still pulls: degraded beats impossible)
        clean = [a for a in sources if not self._blacklisted(a)]
        if clean:
            sources = clean
        # -- first round-trip: chunk 0 doubles as the stat ------------------
        # (trust the SOURCE's size: the request's size came from the
        # metadata seal and is authoritative, but the piggybacked stat
        # catches a source that lost the object before the first chunk)
        primary = first_data = None
        src_size = 0
        for addr in list(sources):
            try:
                client = self._peer(addr)
                if raw:
                    rep = client.call("op_fetch", oid.binary(), 0, chunk,
                                      timeout=_CHUNK_TIMEOUT)
                    src_kind, src_size = rep.meta
                    first_data = rep.payload
                else:
                    src_kind, src_size = client.call(
                        "op_stat", oid.binary(), timeout=30.0)
            except Exception:   # noqa: BLE001 — peer gone: try the next
                self._drop_peer(addr)
                self._note_source_failure(addr)
                sources.remove(addr)
                continue
            if src_kind in _SERVABLE and src_size > 0:
                primary = addr
                break
            sources.remove(addr)    # alive but no longer has the bytes
        if primary is None:
            self.transfers_failed += 1
            return False
        handle = self.store.begin_ingest(oid, src_size)
        if handle is None:
            return True     # raced another ingest; bytes are local
        if raw and src_size > chunk:
            # warm the landing pages while chunks are in flight: tmpfs
            # first-touch faults otherwise serialize into every chunk
            # landing (~3x the cost on a cold arena block)
            threading.Thread(target=handle.prefault,
                             name="plane-prefault", daemon=True).start()
        t0 = _clk.monotonic()
        try:
            got = 0
            if raw and first_data is not None and len(first_data) > 0:
                handle.write(0, first_data)
                got = len(first_data)
            if got < src_size:
                self._pipelined_fetch(oid, handle, got, src_size,
                                      sources, chunk, raw)
            handle.commit()
        except Exception:   # noqa: BLE001 — any failure aborts cleanly
            handle.abort()
            self.transfers_failed += 1
            return False
        dt = max(_clk.monotonic() - t0, 1e-9)
        mbps = src_size / (1 << 20) / dt
        self.last_transfer_mbps = mbps
        self.ewma_transfer_mbps = (mbps if self.ewma_transfer_mbps == 0
                                   else 0.8 * self.ewma_transfer_mbps
                                   + 0.2 * mbps)
        self.bytes_received += src_size
        if raw:
            self.bytes_received_raw += src_size
        else:
            self.bytes_received_pickled += src_size
        self.transfers_in += 1
        self._note_source_ok(primary)
        return True

    def _pipelined_fetch(self, oid: ObjectID, handle, start: int,
                         src_size: int, sources: list[str], chunk: int,
                         raw: bool) -> None:
        """Windowed, striped chunk fetch: keep up to W chunk requests in
        flight across the source set, writing completions straight into
        the ingest handle.  A failing source gets its unfinished stripes
        reassigned to the survivors; only when ALL sources are gone does
        the transfer raise (the PullManager's retry machinery takes over
        from there)."""
        cfg = get_config()
        stripe_min = cfg.object_transfer_stripe_min_mb * (1 << 20)
        if src_size < stripe_min or len(sources) < 2:
            srcs = sources[:1]
        else:
            srcs = list(sources)
        # the configured window is PER SOURCE (striping across N
        # replicas keeps each connection's pipeline at full depth), but
        # the existing pull quota still bounds receive-side memory:
        # never hold more in-flight chunk bytes than it allows
        window = max(1, int(cfg.object_transfer_window)) * len(srcs)
        quota = cfg.pull_manager_max_inflight_mb * (1 << 20)
        window = max(1, min(window, max(1, quota // chunk)))
        method = "op_fetch" if raw else "op_read"
        oid_bin = oid.binary()
        # direct landing: raw chunk payloads are received straight into
        # the ingest block (shm only; view() is None for spill/in-band
        # ingests and the buffered path takes over).  sink_live gates
        # every grant: once the transfer unwinds, no late reply may
        # write into a block that abort() is about to free.
        can_sink = raw and getattr(handle, "view", None) is not None
        sink_live = [True]

        def make_sink(off: int, ln: int):
            if not can_sink:
                return None

            def sink(payload_len: int):
                # a short reply (source lost the bytes) must NOT land:
                # drain-side length checks still gate success
                if not sink_live[0] or payload_len != ln:
                    return None
                return handle.view(off, ln)
            return sink

        # chunk ranges still to fetch, striped round-robin per source
        assign: dict[str, deque] = {a: deque() for a in srcs}
        ranges = [(off, min(chunk, src_size - off))
                  for off in range(start, src_size, chunk)]
        for j, rng in enumerate(ranges):
            assign[srcs[j % len(srcs)]].append(rng)

        done_q: _queue.Queue = _queue.Queue()
        inflight: dict[tuple, object] = {}      # (addr, off, ln) -> fut
        dead: set[str] = set()
        written = start

        def fail_source(addr: str) -> None:
            """Reassign a dead source's unfinished stripes to survivors
            (its in-flight chunks error back through done_q and are
            reassigned there, one by one)."""
            if addr in dead:
                return
            dead.add(addr)
            self._drop_peer(addr)
            self._note_source_failure(addr)
            survivors = [a for a in srcs if a not in dead]
            if not survivors:
                return      # the pump/drain loop raises
            moved = assign.pop(addr, deque())
            self.stripe_retries += len(moved)
            for j, rng in enumerate(moved):
                assign[survivors[j % len(survivors)]].append(rng)

        def pump() -> None:
            """Top up the window from the per-source stripe queues."""
            while len(inflight) < window:
                addr = next((a for a in srcs
                             if a not in dead and assign.get(a)), None)
                if addr is None:
                    return
                off, ln = assign[addr].popleft()
                token = (addr, off, ln)
                try:
                    fut = self._peer(addr).call_async(
                        method, oid_bin, off, ln,
                        on_done=lambda t=token: done_q.put(t),
                        sink=make_sink(off, ln))
                except Exception:   # noqa: BLE001 — send/connect failed
                    assign[addr].appendleft((off, ln))
                    fail_source(addr)
                    if not any(a not in dead for a in srcs):
                        raise PlaneTransferError(
                            f"all sources lost {oid.hex()[:12]} "
                            "mid-transfer") from None
                    continue
                inflight[token] = fut
                self.window_occupancy += 1
                self.window_peak = max(self.window_peak,
                                       len(inflight))

        try:
            pump()
            while inflight:
                try:
                    token = done_q.get(timeout=_CHUNK_TIMEOUT)
                except _queue.Empty:
                    raise PlaneTransferError(
                        f"transfer of {oid.hex()[:12]} stalled: no "
                        f"chunk completion in {_CHUNK_TIMEOUT}s") \
                        from None
                fut = inflight.pop(token, None)
                if fut is None:
                    continue
                self.window_occupancy -= 1
                addr, off, ln = token
                data = landed = None
                try:
                    rep = fut.result(0)
                    if raw:
                        data = rep.payload
                        # payload None = the reader thread received the
                        # bytes straight into our ingest view (the sink
                        # only accepts an exact-length payload)
                        landed = data is None
                    else:
                        data = rep
                except Exception:   # noqa: BLE001 — chunk RPC died
                    data = None
                if landed:
                    written += ln
                elif data is not None and len(data) == ln:
                    handle.write(off, data)
                    written += ln
                else:
                    # short/empty/error chunk: the source lost the
                    # object or the link — move this stripe (and the
                    # rest of its queue) to the survivors
                    fail_source(addr)
                    survivors = [a for a in srcs if a not in dead]
                    if not survivors:
                        raise PlaneTransferError(
                            f"all sources lost {oid.hex()[:12]} "
                            "mid-transfer")
                    self.stripe_retries += 1
                    assign[min(survivors,
                               key=lambda a: len(assign[a]))] \
                        .append((off, ln))
                pump()
        finally:
            # a failed transfer's block is about to be freed: stop
            # granting sinks, sever connections still owing chunk bytes
            # (a late reply must never recv_into the freed block), and
            # confirm in-flight receives resolved before unwinding
            sink_live[0] = False
            if inflight:
                for (addr, _o, _l), fut in inflight.items():
                    if not fut.done():
                        self._drop_peer(addr)
                deadline = _clk.monotonic() + 5.0
                for fut in inflight.values():
                    if not fut.wait(max(0.0,
                                        deadline - _clk.monotonic())):
                        break
                # occupancy must not leak
                self.window_occupancy -= len(inflight)
        if written != src_size:
            raise PlaneTransferError(
                f"transfer of {oid.hex()[:12]} incomplete: "
                f"{written}/{src_size} bytes")

    # -- broadcast (1->N) ----------------------------------------------------
    def broadcast(self, oid: ObjectID, member_addrs, size: int = 0,
                  fanout: int | None = None,
                  timeout: float | None = None) -> dict:
        """Distribute a locally sealed object to every plane in
        ``member_addrs`` through a relay tree rooted HERE (this plane
        must hold the bytes).  Plane-level primitive: with no bandwidth
        matrix in sight the tree is index-ordered balanced F-ary
        (``broadcast/plan.py``); the cluster-level coordinator
        (``BroadcastManager``) shapes topology-aware trees instead.
        Returns {"ok", "reached": [addr...], "failed": [addr...]}."""
        from ..broadcast.plan import balanced_plan
        kind, local_size = self.store.plasma_info(oid)
        if kind not in _SERVABLE:
            return {"ok": False, "reached": [], "failed":
                    list(member_addrs), "error": "no local bytes"}
        size = int(size) or int(local_size)
        cfg = get_config()
        chunk = cfg.broadcast_chunk_mb * (1 << 20)
        members = [a for a in dict.fromkeys(member_addrs)
                   if a and a != self.serve_address]
        plan = balanced_plan(members, self.serve_address, fanout)
        bcast_id = f"{oid.hex()[:16]}.p{id(plan) & 0xffffff:x}"
        futs = []
        failed = []
        for addr in plan.order:
            sources = [a for a in plan.fallbacks(addr) if a != addr]
            try:
                fut = self._peer(addr).call_async(
                    "bc_begin", bcast_id, oid.binary(), size,
                    tuple(sources), chunk)
            except Exception:   # noqa: BLE001 — member unreachable
                self._drop_peer(addr)
                failed.append(addr)
                continue
            futs.append((addr, fut))
        per_member = timeout if timeout is not None else \
            cfg.broadcast_fetch_timeout_s + max(60.0, size / (1 << 20))
        reached = []
        for addr, fut in futs:
            try:
                res = fut.result(per_member)
                ok = bool(res.get("ok"))
            except Exception:   # noqa: BLE001 — member died mid-session
                self._drop_peer(addr)
                ok = False
            (reached if ok else failed).append(addr)
        return {"ok": not failed, "reached": reached, "failed": failed}

    def request_remote_pull(self, dest_addr: str, oid: ObjectID,
                            size: int, src_addr: str,
                            src_addrs: tuple = ()) -> bool:
        """Tell the plane at ``dest_addr`` to pull ``oid`` from
        ``src_addr`` (payload flows source→destination directly)."""
        try:
            client = self._peer(dest_addr)
            return bool(client.call("op_pull", oid.binary(), size,
                                    src_addr, tuple(src_addrs),
                                    timeout=300.0))
        except Exception:   # noqa: BLE001 — dest gone: transfer failed
            self._drop_peer(dest_addr)
            return False

    def free_on(self, address: str, oids) -> None:
        """Queue a best-effort remote free (refcount hit zero); runs on
        the plane-gc thread so refcount processing never blocks on RPC."""
        with self._gc_cv:
            if self._stopped:
                return
            self._gc_q.append((address, [o.binary() for o in oids]))
            if self._gc_thread is None or not self._gc_thread.is_alive():
                self._gc_thread = threading.Thread(
                    target=self._gc_loop, daemon=True, name="plane-gc")
                self._gc_thread.start()
            self._gc_cv.notify_all()

    def _gc_loop(self) -> None:
        while True:
            with self._gc_cv:
                while not self._gc_q and not self._stopped:
                    self._gc_cv.wait()
                if self._stopped and not self._gc_q:
                    return
                address, oid_bins = self._gc_q.popleft()
            try:
                self._peer(address).call("op_free", oid_bins,
                                         timeout=10.0)
            except Exception:   # noqa: BLE001 — peer gone; its copies
                self._drop_peer(address)    # died with it

    # -- peer cache ----------------------------------------------------------
    def _peer(self, address: str):
        from ..rpc import transport as _transport
        with self._peers_lock:
            client = self._peers.get(address)
            if client is not None and not client._closed:
                return client
        # plane reads are idempotent: retry on timeout/conn-loss, and
        # enforce the peer's circuit breaker so a quarantined link fails
        # fast into the blacklist instead of eating a chunk timeout
        client = _transport.connect(address,
                                    retryable=frozenset({"op_stat", "op_free",
                                                         "op_plane_stats"}),
                                    breaker=True)
        with self._peers_lock:
            live = self._peers.get(address)
            if live is not None and not live._closed:
                client.close()
                return live
            self._peers[address] = client
        return client

    def _drop_peer(self, address: str) -> None:
        with self._peers_lock:
            client = self._peers.pop(address, None)
        if client is not None:
            client.close()

    def shutdown(self) -> None:
        with self._gc_cv:
            self._stopped = True
            self._gc_cv.notify_all()
        with self._peers_lock:
            peers = list(self._peers.values())
            self._peers.clear()
        for c in peers:
            c.close()
