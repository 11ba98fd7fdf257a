"""Transport seam: how control-plane endpoints get made.

Reference parity: upstream's ``GrpcServer``/``ClientCallManager`` are
constructed inline by every daemon, which welds the control logic to
real sockets.  This module is the one place that decides what a
"connection" and a "server" are, so the same head/agent/autoscaler
state machines can run over:

- ``TcpTransport`` (default) — the real threaded socket
  ``RpcClient``/``RpcServer`` pair; production behavior unchanged.
- ``SimTransport`` (``ray_tpu_torch/sim/transport.py``) — an in-process
  registry where a "call" is a function invocation routed through the
  chaos plane's per-link Philox streams and the virtual clock, so 10k
  simulated nodes fit in one process with zero sockets.

Construction sites in ``runtime/head.py``, ``runtime/node_agent.py``
and ``scripts/cli.py`` go through :func:`connect` / :func:`serve`
rather than naming ``RpcClient``/``RpcServer`` directly; the installed
transport is a process-global with the same None-fast-path shape as
``rpc.chaos._active``.
"""

from __future__ import annotations

__all__ = ["Transport", "TcpTransport", "get_transport", "install",
           "uninstall", "connect", "serve"]


class Transport:
    """The seam: anything that can mint client and server endpoints.

    A client must provide ``call/call_async/close/peer_address``; a
    server must provide ``start/stop/address/add_handler/on_conn_close``
    plus the ``method_calls``/``method_bytes`` accounting dicts — i.e.
    the surface of ``RpcClient``/``RpcServer`` that the control plane
    actually uses.
    """

    scheme = "abstract"

    def connect(self, address: str, **kwargs):
        raise NotImplementedError

    def serve(self, handlers: dict, host: str = "127.0.0.1",
              port: int = 0):
        raise NotImplementedError


class TcpTransport(Transport):
    """The real thing: threaded sockets, length-prefixed frames."""

    scheme = "tcp"

    def connect(self, address: str, **kwargs):
        from .client import RpcClient
        return RpcClient(address, **kwargs)

    def serve(self, handlers: dict, host: str = "127.0.0.1",
              port: int = 0):
        from .server import RpcServer
        return RpcServer(handlers, host=host, port=port)


# -- process-global install --------------------------------------------------
_default = TcpTransport()
_active: Transport = _default


def get_transport() -> Transport:
    return _active


def install(transport: Transport) -> Transport:
    global _active
    _active = transport
    return transport


def uninstall() -> None:
    global _active
    _active = _default


def connect(address: str, **kwargs):
    """Mint a client endpoint for ``address`` via the installed
    transport (kwargs are the usual ``RpcClient`` knobs)."""
    return _active.connect(address, **kwargs)


def serve(handlers: dict, host: str = "127.0.0.1", port: int = 0):
    """Mint a (not-yet-started) server endpoint via the installed
    transport."""
    return _active.serve(handlers, host=host, port=port)
