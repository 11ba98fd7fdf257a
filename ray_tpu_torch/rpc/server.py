"""Threaded TCP RPC server (the GrpcServer analogue).

One reader thread per connection; each REQUEST runs on its own worker
thread so a long/blocking handler (``ray.get``) never stalls the other
requests pipelined on the same connection — the same property gRPC's
completion queues give the reference (SURVEY.md §1 layer 2).

The connection lifecycle is codec-agnostic: subclasses swap the frame
codec and request/reply shapes via the ``_decode_request`` /
``_encode_reply`` / ``_error_payload`` / ``_invoke`` hooks (the
cross-language gateway reuses everything but the pickle codec —
``rpc/xlang_gateway.py``).  Replies are encoded OUTSIDE the write lock,
and an encode failure is itself sent as a typed error reply — a payload
the codec rejects must never leave a synchronous client blocked waiting
for a reply that died on the server.
"""

from __future__ import annotations

import logging
import socket
import threading
import traceback

from . import chaos as _chaos
from .wire import (RawResult, recv_raw_frame, send_raw_frame,
                   send_raw_reply)

_LOG = logging.getLogger("ray_tpu_torch.rpc.server")


class RpcServer:
    def __init__(self, handlers: dict, host: str = "127.0.0.1",
                 port: int = 0):
        """``handlers``: method name -> callable(*args, **kwargs).
        ``port=0`` picks a free port (read it from ``self.address``)."""
        self._handlers = dict(handlers)
        # per-method wire accounting: method -> [bytes_in, bytes_out].
        # Tests use this to PROVE data-plane payloads bypass a server
        # (e.g. object transfers never transiting the head).
        self.method_bytes: dict = {}
        # per-method REQUEST counts (same proof role as the bytes:
        # e.g. asserting N local leases cost O(1) head calls)
        self.method_calls: dict = {}
        self._mb_lock = threading.Lock()
        # per-connection cleanup callbacks (registered by handlers via
        # on_conn_close while serving a request on that connection) —
        # how the head ties client-session state to connection lifetime
        self._conn_cleanups: dict = {}
        self._tls = threading.local()
        _chaos.ensure_env_init()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._stopped = False
        self._conns: set = set()
        self._lock = threading.Lock()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="rpc-accept")

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "RpcServer":
        self._accept_thread.start()
        return self

    def add_handler(self, name: str, fn) -> None:
        self._handlers[name] = fn

    def on_conn_close(self, callback) -> bool:
        """Run ``callback()`` when the CURRENT request's connection
        drops (clean close or network death).  Callable only from
        inside a handler; returns False outside one."""
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            return False
        with self._lock:
            if conn not in self._conns:
                return False    # already gone: run it now
            self._conn_cleanups.setdefault(conn, []).append(callback)
            return True

    # -- codec hooks (pickle protocol; overridden by the xlang gateway) ----
    def _recv_request(self, conn):
        """One request frame (raw bytes here; the decode hook parses),
        or None on clean EOF."""
        return recv_raw_frame(conn)

    def _decode_request(self, frame):
        """frame -> (req_id, method, args, kwargs), or None to drop the
        connection on a protocol violation."""
        from ..runtime.serialization import deserialize
        req_id, method, args, kwargs = deserialize(frame)
        return req_id, method, args, kwargs

    def _account(self, method: str, n_in: int, n_out: int) -> None:
        with self._mb_lock:
            row = self.method_bytes.get(method)
            if row is None:
                row = self.method_bytes[method] = [0, 0]
            row[0] += n_in
            row[1] += n_out
            if n_in:        # request leg only (replies re-account out)
                self.method_calls[method] = \
                    self.method_calls.get(method, 0) + 1

    def total_bytes(self, exclude: tuple = ()) -> int:
        """Sum of request+reply wire bytes across methods (minus any in
        ``exclude``)."""
        with self._mb_lock:
            return sum(b_in + b_out
                       for m, (b_in, b_out) in self.method_bytes.items()
                       if m not in exclude)

    def _encode_reply(self, req_id, ok: bool, payload) -> bytes:
        from ..runtime.serialization import serialize
        return serialize((req_id, ok, payload))

    def _error_payload(self, e: BaseException):
        return (type(e).__name__, str(e), traceback.format_exc())

    def _invoke(self, fn, args, kwargs):
        return fn(*args, **kwargs)

    # -- connection lifecycle ----------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return          # socket closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="rpc-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # replies from concurrent handler threads interleave on one
        # socket: serialize the WRITES, never the handlers
        wlock = threading.Lock()
        try:
            while True:
                try:
                    frame = self._recv_request(conn)
                except (ConnectionError, OSError, ValueError):
                    return
                if frame is None:
                    return
                try:
                    parsed = self._decode_request(frame)
                except (TypeError, ValueError):
                    return      # malformed request: drop the conn
                if parsed is None:
                    return
                req_id, method, args, kwargs = parsed
                if isinstance(frame, (bytes, bytearray)):
                    self._account(method, len(frame), 0)
                threading.Thread(
                    target=self._run_handler,
                    args=(conn, wlock, req_id, method, args, kwargs),
                    daemon=True, name=f"rpc-h-{method}").start()
        finally:
            with self._lock:
                self._conns.discard(conn)
                cleanups = self._conn_cleanups.pop(conn, ())
            try:
                conn.close()
            except OSError:
                pass
            for cb in cleanups:
                try:
                    cb()
                except Exception:   # noqa: BLE001 — cleanup must not
                    # kill the conn reaper, but a dying hook is a bug
                    # in its owner: keep the evidence
                    _LOG.debug("connection cleanup hook failed",
                               exc_info=True)

    def _run_handler(self, conn, wlock, req_id, method, args,
                     kwargs) -> None:
        self._tls.conn = conn
        try:
            fn = self._handlers.get(method)
            if fn is None:
                raise AttributeError(f"no rpc method {method!r}")
            result = self._invoke(fn, args, kwargs)
            ok, payload = True, result
        except BaseException as e:     # noqa: BLE001 — typed error reply
            ok, payload = False, self._error_payload(e)
        finally:
            self._tls.conn = None
        # chaos: the reply leg at the SERVER (link ``srv:<self>``) — a
        # "drop" here models the asymmetric gray failure where requests
        # arrive and execute but the answers vanish on the way back
        ch = _chaos._active
        act = ch.reply_action(self.address) if ch is not None else None
        if ok and isinstance(payload, RawResult):
            # data channel: the payload buffer (shm view / spill bytes)
            # is gather-written verbatim — no pickle, no concat copy.
            # The release hook (shm pin) runs once the socket has the
            # bytes, success or not.
            from ..runtime.serialization import serialize
            try:
                meta_bytes = serialize(payload.meta)
                if act != "drop":
                    with wlock:
                        n = send_raw_reply(conn, req_id, meta_bytes,
                                           payload.payload)
                        if act == "dup":
                            send_raw_reply(conn, req_id, meta_bytes,
                                           payload.payload)
                    self._account(method, 0, n)
            except (OSError, ConnectionError):
                pass            # client went away; nothing to tell it
            finally:
                if payload.release is not None:
                    try:
                        payload.release()
                    except Exception:   # noqa: BLE001 — pin cleanup
                        pass            # must not kill the handler
            return
        try:
            data = self._encode_reply(req_id, ok, payload)
        except Exception as e:          # result outside the codec's subset
            ok = False
            data = self._encode_reply(req_id, False,
                                      self._error_payload(e))
        if act == "drop":
            return              # reply lost on the (simulated) fabric
        self._account(method, 0, len(data))
        try:
            with wlock:
                send_raw_frame(conn, data)
                if act == "dup":
                    send_raw_frame(conn, data)
        except (OSError, ConnectionError):
            pass                # client went away; nothing to tell it

    def stop(self) -> None:
        self._stopped = True
        # shutdown BEFORE close here too: close() alone does not wake a
        # thread blocked in accept(), which then lingers and can steal
        # connections if the listener fd number is later reused
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            # shutdown BEFORE close: close() alone does not wake a peer
            # (or our own reader thread) blocked in recv on this socket
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
