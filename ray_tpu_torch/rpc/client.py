"""Pipelining RPC client (the retryable-gRPC-client analogue).

A single connection multiplexes concurrent calls: each call gets a
request id and parks on an event; one reader thread dispatches replies
by id.  Server-side exceptions re-raise here with the remote traceback
attached (SURVEY.md §1 layer 2).

``call_async`` exposes the same demux as explicit futures: the object
plane keeps a window of chunk requests in flight on one connection and
collects completions through ``on_done`` callbacks instead of parking
one thread per chunk.  Raw reply frames (``wire.RAW_MARKER``) resolve
to ``RawReply`` objects whose payload is a zero-copy view into the
receive buffer — no pickle pass on the bulk-data path.

Gray-failure hardening (the retryable-client part of the reference):

- **Idempotent retry** — methods named in ``retryable`` re-issue on
  timeout/connection loss with exponential backoff + FULL jitter
  (``rpc_retry_*`` knobs).  Opt-in PER METHOD: reads/stats/frees
  retry; mutations never do (an at-least-once mutation is a bug, an
  at-least-once read is a retry).
- **No hung futures** — ``close()`` and reader-thread death (clean EOF,
  network error, or an unexpected decode exception) fail every
  outstanding ``RpcFuture`` with ``RpcConnectionError``; nothing parks
  forever on a dead link.
- **Timed-out slots are reaped** — ``result(timeout)`` deregisters the
  call AND neutralizes its ``on_done``/``sink`` hooks, so a late reply
  can never fire a completion into state the caller already freed.
- **Circuit breaker** — every call outcome feeds the process-global
  per-peer breaker registry (``rpc/breaker.py``); constructing with
  ``breaker=True`` additionally fails fast (``CircuitOpenError``)
  while the peer's breaker is open, with half-open probes after the
  cooldown.
- **Chaos hooks** — when the chaos plane is armed (``rpc/chaos.py``),
  both legs consult it: requests may be dropped/duplicated/delayed at
  send, replies dropped/delayed at receive, scoped by peer address.
  One module-attribute None-check each way when chaos is off.
"""

from __future__ import annotations

import itertools
import random
import socket
import threading

from ..common import clock as _clk
from . import chaos as _chaos
from .wire import recv_reply, send_frame


class RpcConnectionError(ConnectionError):
    """The peer is gone (daemon stopped, network failure)."""


class RemoteRpcError(RuntimeError):
    """A handler raised on the server; carries the remote traceback."""

    def __init__(self, exc_type: str, message: str, remote_tb: str):
        super().__init__(f"{exc_type}: {message}")
        self.exc_type = exc_type
        self.remote_tb = remote_tb


# Sentinel distinguishing "caller said nothing" (inherit the client's
# constructor timeout) from an EXPLICIT ``timeout=None`` (block forever
# — the opt-out long gets/waits use deliberately).
_UNSET = object()


class RpcFuture:
    """One in-flight call: ``result(timeout)`` parks; ``done()`` polls.
    The ``on_done`` callback passed at issue time fires (no args, on the
    reader thread) the moment the reply — or the connection's death —
    resolves the call."""

    __slots__ = ("_client", "_req_id", "_slot", "_method")

    def __init__(self, client, req_id, slot, method):
        self._client = client
        self._req_id = req_id
        self._slot = slot
        self._method = method

    def done(self) -> bool:
        return self._slot[0].is_set()

    def wait(self, timeout=None) -> bool:
        """Park until the call resolves (reply or connection loss)
        WITHOUT raising; True when resolved.  Lets a caller that
        abandoned a call confirm no late reply is still being received
        (e.g. straight into a sink buffer it is about to free)."""
        return self._slot[0].wait(timeout)

    def result(self, timeout=None):
        slot = self._slot
        if not slot[0].wait(timeout):
            # reap: deregister AND neutralize the slot's hooks — the
            # caller is about to unwind, so a late reply must neither
            # fire on_done nor be granted a sink into freed state
            self._client._reap(self._req_id, slot)
            raise TimeoutError(
                f"rpc {self._method} timed out after {timeout}s")
        if slot[1] is None:
            raise RpcConnectionError("connection lost awaiting reply")
        if slot[1]:
            return slot[2]
        raise RemoteRpcError(*slot[2])


class RpcClient:
    def __init__(self, address: str, timeout: float = 10.0,
                 on_close=None, retryable=(), breaker: bool = False,
                 reconnect: bool = False):
        """``on_close`` fires once per connection, from the reader
        thread, when the connection drops (peer gone or local close) —
        the hook node agents/hubs use for disconnect-driven cleanup.
        ``timeout`` is both the connect deadline and the DEFAULT
        per-call deadline for ``call`` sites that don't pass their own.

        ``retryable``: method names ``call`` may transparently re-issue
        on timeout/connection loss (idempotent reads only — see module
        docstring).  ``breaker=True`` enforces the peer's circuit
        breaker (fail fast while open); outcomes are RECORDED either
        way.  ``reconnect=True`` lets a retrying ``call`` rebuild the
        underlying connection after the peer comes back."""
        self.peer_address = address
        self._default_timeout = timeout
        self._retryable = frozenset(retryable)
        self._breaker_enforce = breaker
        self._auto_reconnect = reconnect
        self._wlock = threading.Lock()
        # id -> [event, ok, payload, on_done, sink]
        self._pending: dict[int, list] = {}
        self._ids = itertools.count()
        self._closed = False
        self._user_closed = False
        self._on_close = on_close
        _chaos.ensure_env_init()
        self._sock = self._connect()
        self._reader = threading.Thread(target=self._read_loop,
                                        args=(self._sock,),
                                        daemon=True, name="rpc-reader")
        self._reader.start()

    def _connect(self) -> socket.socket:
        host, port = self.peer_address.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=self._default_timeout)
        sock.settimeout(None)       # calls manage their own deadlines
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    # -- retry policy --------------------------------------------------------
    def call(self, method: str, *args, timeout=_UNSET, **kwargs):
        # Omitted timeout falls back to the constructor default: a hung
        # or wedged peer fails the call instead of parking the caller
        # forever.  Pass ``timeout=None`` EXPLICITLY to wait unbounded
        # (long gets/waits that manage their own deadline).
        if timeout is _UNSET:
            timeout = self._default_timeout
        from . import breaker as _breaker
        peer = self.peer_address
        if method in self._retryable:
            from ..common.config import get_config
            cfg = get_config()
            attempts = max(1, cfg.rpc_retry_max_attempts)
            base = cfg.rpc_retry_base_ms / 1000.0
            cap = cfg.rpc_retry_max_ms / 1000.0
        else:
            attempts, base, cap = 1, 0.0, 0.0
        for attempt in range(attempts):
            if self._breaker_enforce and \
                    not _breaker.breaker_for(peer).allow():
                from .breaker import CircuitOpenError
                raise CircuitOpenError(
                    f"circuit open for peer {peer} (recent consecutive "
                    f"failures; half-open probe after cooldown)")
            try:
                result = self.call_async(method, *args, **kwargs) \
                    .result(timeout)
            except (TimeoutError, RpcConnectionError) as e:
                _breaker.record_failure(peer)
                if attempt + 1 >= attempts:
                    raise
                if self._closed:
                    if not (self._auto_reconnect and
                            self._try_reconnect()) and \
                            isinstance(e, RpcConnectionError):
                        # no path back to the peer: further attempts
                        # would fail identically without a reconnect
                        raise
                # exponential backoff with FULL jitter (decorrelates
                # retry storms from many clients hitting one gray peer)
                _clk.sleep(random.random() * min(cap, base * 2 ** attempt))
                continue
            _breaker.record_success(peer)
            return result

    def _try_reconnect(self) -> bool:
        """Rebuild the connection after loss (opt-in).  The dead
        reader is joined FIRST so its unwind (which fails every pending
        slot) can never race requests issued on the new connection."""
        with self._wlock:
            if self._user_closed or not self._closed:
                return not self._closed
            reader = self._reader
            if reader is not None and reader.is_alive():
                reader.join(timeout=5.0)
                if reader.is_alive():
                    return False
            try:
                sock = self._connect()
            except OSError:
                return False
            self._sock = sock
            self._closed = False
            self._reader = threading.Thread(
                target=self._read_loop, args=(sock,),
                daemon=True, name="rpc-reader")
            self._reader.start()
            return True

    def call_async(self, method: str, *args, on_done=None, sink=None,
                   **kwargs) -> RpcFuture:
        """Issue without waiting; the returned future resolves when the
        reply lands.  ``on_done()`` (if given) is invoked from the
        reader thread on completion — including connection loss, so a
        windowed caller never hangs on a dead peer.

        ``sink(payload_len)`` (if given) may return a writable buffer
        for a RAW reply's payload: the bytes are then received straight
        into it on the reader thread (kernel to final home, no frame
        buffer) and the resolved ``RawReply.payload`` is None.  Return
        None from the sink to fall back to the buffered receive (e.g.
        on an unexpected length)."""
        req_id = next(self._ids)
        slot = [threading.Event(), None, None, on_done, sink]
        self._pending[req_id] = slot
        ch = _chaos._active
        act = None
        if ch is not None:
            # seeded fault decision for the request leg; a "drop" still
            # registers the slot — the call times out exactly as a
            # frame lost on a real fabric would
            act = ch.send_action(self.peer_address)
        try:
            with self._wlock:
                if self._closed:
                    raise RpcConnectionError("client is closed")
                if act != "drop":
                    send_frame(self._sock,
                               (req_id, method, args, kwargs))
                    if act == "dup":
                        send_frame(self._sock,
                                   (req_id, method, args, kwargs))
        except (OSError, ConnectionError) as e:
            self._pending.pop(req_id, None)
            raise RpcConnectionError(str(e)) from e
        return RpcFuture(self, req_id, slot, method)

    def _reap(self, req_id: int, slot: list) -> None:
        """Abandon a timed-out call: deregister its slot and strip its
        hooks, so a reply that limps in later is dropped by the demux
        (or, if the reader already holds the slot, fires into no-ops
        instead of freed caller state)."""
        self._pending.pop(req_id, None)
        slot[3] = None      # on_done
        slot[4] = None      # sink

    def _sink_for(self, req_id: int, payload_len: int):
        """Wire-level sink lookup for ``recv_reply``: the registered
        sink of the pending call, or None (buffered receive)."""
        slot = self._pending.get(req_id)
        if slot is None or slot[4] is None:
            return None
        try:
            return slot[4](payload_len)
        except Exception:   # noqa: BLE001 — a broken sink must not
            return None     # kill the reader; fall back to buffering

    def _read_loop(self, sock) -> None:
        # The unwind runs in a finally: ANY reader death — clean EOF,
        # network error, or an unexpected exception out of the codec —
        # must fail every outstanding future instead of leaving callers
        # parked forever on a thread that no longer exists.
        try:
            while True:
                try:
                    msg = recv_reply(sock, self._sink_for)
                except (ConnectionError, OSError):
                    msg = None
                if msg is None:
                    break
                ch = _chaos._active
                if ch is not None and \
                        ch.recv_action(self.peer_address) == "drop":
                    continue    # reply lost on the (simulated) fabric
                req_id, ok, payload = msg
                slot = self._pending.pop(req_id, None)
                if slot is not None:
                    slot[1], slot[2] = ok, payload
                    slot[0].set()
                    self._fire_on_done(slot)
        finally:
            self._closed = True
            # wake every waiter; they observe the unresolved slot
            # (slot[1] is None) and raise RpcConnectionError
            for slot in list(self._pending.values()):
                slot[0].set()
                self._fire_on_done(slot)
            self._pending.clear()
            if self._on_close is not None:
                try:
                    self._on_close()
                except Exception:   # noqa: BLE001 — cleanup must not
                    pass            # kill the reader's unwind

    @staticmethod
    def _fire_on_done(slot) -> None:
        cb = slot[3]
        if cb is not None:
            try:
                cb()
            except Exception:   # noqa: BLE001 — a completion hook must
                pass            # not kill the reader thread

    def close(self) -> None:
        self._user_closed = True
        self._closed = True
        # shutdown wakes our reader thread (close alone may not
        # interrupt its blocking recv), which then runs the unwind:
        # every outstanding future resolves with RpcConnectionError
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
