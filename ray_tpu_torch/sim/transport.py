"""SimTransport: the in-process ``Transport`` — a call is a function call.

Address space is ``sim://<name>``; a server is a handler table in a
registry dict, a client is a thin handle that resolves the address *at
call time* (so a head restarted at the same address is reachable
through clients minted before the kill, exactly like a reconnecting
socket client).

Fault injection: every request and reply leg takes one decision from
the chaos plane's directed-link Philox stream
(``_Chaos.link_action(src, dst)``).  ``drop``/partition raises
``RpcConnectionError`` at the caller; ``dup`` invokes the handler twice
(at-least-once delivery — handlers must be idempotent, same contract as
the socket path); a drawn delay advances the *virtual* clock.  A
dropped **reply** still executes the handler — the gray failure where
work happened but the caller can't know.

Single-threaded by design: the simulator owns the event loop, so no
locks, no reader threads, no buffers — which is what makes 10k nodes'
control traffic fit in one process.
"""

from __future__ import annotations

from ..rpc.client import RemoteRpcError, RpcConnectionError
from ..rpc.transport import Transport

__all__ = ["SimTransport", "SimClient", "SimServer", "SimFuture"]


class SimFuture:
    """Parity shim for ``RpcClient.call_async``: the call already
    happened synchronously; this just holds the outcome."""

    __slots__ = ("_value", "_error")

    def __init__(self, value=None, error=None):
        self._value = value
        self._error = error

    def result(self, timeout=None):
        if self._error is not None:
            raise self._error
        return self._value

    def done(self) -> bool:
        return True


class SimServer:
    """Handler table + accounting, mirroring the ``RpcServer`` surface
    the control plane uses (``start/stop/address/add_handler/
    on_conn_close/method_calls/method_bytes``)."""

    def __init__(self, transport: "SimTransport", handlers: dict,
                 address: str):
        self._transport = transport
        self.handlers = dict(handlers)
        self._address = address
        self.alive = False
        self.method_calls: dict[str, int] = {}
        self.method_bytes: dict[str, int] = {}
        self._conn_close_cbs: list = []

    @property
    def address(self) -> str:
        return self._address

    def start(self) -> "SimServer":
        self._transport._bind(self)
        self.alive = True
        return self

    def add_handler(self, name: str, fn) -> None:
        self.handlers[name] = fn

    def on_conn_close(self, cb) -> None:
        self._conn_close_cbs.append(cb)

    def stop(self) -> None:
        self.alive = False
        self._transport._unbind(self)


class SimClient:
    """Parity shim for the ``RpcClient`` surface: ``call``,
    ``call_async``, ``close``, ``peer_address``.  ``src`` names the
    calling endpoint for chaos link identity (``src->dst``)."""

    def __init__(self, transport: "SimTransport", address: str,
                 src: str = "driver", timeout: float | None = None,
                 on_close=None, **_ignored):
        self._transport = transport
        self.peer_address = address
        self.src = src
        self._closed = False
        self._on_close = on_close

    def call(self, method: str, *args, timeout=None, **kwargs):
        if self._closed:
            raise RpcConnectionError("sim client closed")
        return self._transport.deliver(self.src, self.peer_address,
                                       method, args, kwargs)

    def call_async(self, method: str, *args, on_done=None, **kwargs):
        try:
            value = self.call(method, *args, **kwargs)
            fut = SimFuture(value=value)
        except Exception as e:        # noqa: BLE001 — future carries it
            fut = SimFuture(error=e)
        if on_done is not None:
            on_done(fut)
        return fut

    def close(self) -> None:
        self._closed = True


class SimTransport(Transport):
    """In-process registry transport.  ``chaos`` is a private
    ``rpc.chaos._Chaos`` instance (NOT the process-global one) so a
    campaign's streams never collide with real-cluster chaos state."""

    scheme = "sim"

    def __init__(self, chaos=None):
        self._servers: dict[str, SimServer] = {}
        self.chaos = chaos
        self._auto = 0
        # accounting (bench + trace summaries)
        self.calls = 0
        self.dropped = 0
        self.dup_delivered = 0
        self.unreachable = 0

    # -- Transport interface -------------------------------------------------
    def connect(self, address: str, **kwargs) -> SimClient:
        src = kwargs.pop("_sim_src", "driver")
        return SimClient(self, address, src=src, **kwargs)

    def serve(self, handlers: dict, host: str = "sim", port: int = 0
              ) -> SimServer:
        if host.startswith("sim://"):
            address = host
        else:
            self._auto += 1
            name = host if host not in ("sim", "127.0.0.1") else \
                f"ep{self._auto}"
            address = f"sim://{name}"
        return SimServer(self, handlers, address)

    # -- registry ------------------------------------------------------------
    def _bind(self, server: SimServer) -> None:
        live = self._servers.get(server.address)
        if live is not None and live.alive and live is not server:
            raise RuntimeError(f"sim address in use: {server.address}")
        self._servers[server.address] = server

    def _unbind(self, server: SimServer) -> None:
        if self._servers.get(server.address) is server:
            del self._servers[server.address]

    def kill(self, address: str) -> bool:
        """SIGKILL analogue: the endpoint vanishes mid-flight (no
        goodbye, no conn-close callbacks fire at peers)."""
        srv = self._servers.pop(address, None)
        if srv is not None:
            srv.alive = False
            return True
        return False

    # -- the wire ------------------------------------------------------------
    def deliver(self, src: str, dst: str, method: str, args, kwargs):
        self.calls += 1
        ch = self.chaos
        act = ch.link_action(src, dst) if ch is not None else None
        if act == "drop":
            self.dropped += 1
            raise RpcConnectionError(
                f"sim: request {src}->{dst}:{method} dropped")
        srv = self._servers.get(dst)
        if srv is None or not srv.alive:
            self.unreachable += 1
            raise RpcConnectionError(f"sim: {dst} is down")
        fn = srv.handlers.get(method)
        if fn is None:
            raise RemoteRpcError("KeyError",
                                 f"no handler {method!r} at {dst}", "")
        srv.method_calls[method] = srv.method_calls.get(method, 0) + 1
        if act == "dup":
            self.dup_delivered += 1
            fn(*args, **kwargs)     # first delivery; reply discarded
        result = fn(*args, **kwargs)
        # reply leg: the handler RAN either way
        ract = ch.link_action(dst, src) if ch is not None else None
        if ract == "drop":
            self.dropped += 1
            raise RpcConnectionError(
                f"sim: reply {dst}->{src}:{method} dropped")
        return result
