"""Cross-language gateway: the TCP surface the C++ frontend talks to.

Reference parity: non-Python frontends in the reference reach the cluster
through the core worker's language-independent task submission path
(``cpp/`` frontend → C++ core worker — SURVEY.md §1 layer 8; mount
empty).  Here the equivalent boundary is a gateway listener on the head:
the connection lifecycle is ``rpc/server.py``'s with the codec swapped —
frames are ``u32 length + xlang value`` (``rpc/xlang.py``; no pickle
anywhere on this surface), requests are ``[req_id, method, args]``,
replies ``[req_id, ok, payload]`` with error payloads
``[exc_type, message]``.

Functions/actors are addressed by cross-language export name
(``ray_tpu_torch/cross_language.py``); values are restricted to the xlang
subset in both directions (a handler result outside it becomes a typed
``XlangEncodeError`` reply — the base server encodes replies before
taking the write lock precisely so that failure path answers the
client).  ObjectRefs cross the wire as raw object-id bytes and take the
client-owned conservative-leak model (the gateway builds only
counter-suppressed refs, same as the pickle client mode — see
``runtime/head.py``).
"""

from __future__ import annotations

import socket

from ..common.ids import ActorID, ObjectID
from .server import RpcServer
from .wire import recv_raw_frame, send_raw_frame
from .xlang import XlangDecodeError, decode, encode


def send_xframe(sock: socket.socket, value) -> None:
    send_raw_frame(sock, encode(value))


def recv_xframe(sock: socket.socket):
    """One decoded frame, or None on clean EOF."""
    body = recv_raw_frame(sock)
    return None if body is None else decode(body)


class XlangGateway(RpcServer):
    """Serves the cross-language method set against a driver runtime."""

    def __init__(self, runtime, host: str = "127.0.0.1", port: int = 0):
        self._rt = runtime
        super().__init__({
            "ping": self._ping,
            "put": self._put,
            "get": self._get,
            "wait": self._wait,
            "call": self._call,
            "create_actor": self._create_actor,
            "actor_call": self._actor_call,
            "kill_actor": self._kill_actor,
            "exports": self._exports,
            "cluster_resources": self._cluster_resources,
            "available_resources": self._available_resources,
        }, host=host, port=port)
        self.start()

    # -- codec hooks -------------------------------------------------------
    def _recv_request(self, conn):
        try:
            return recv_xframe(conn)
        except XlangDecodeError:
            raise ValueError("malformed xlang frame") from None

    def _decode_request(self, frame):
        if not (isinstance(frame, list) and len(frame) == 3):
            return None         # protocol violation: drop the conn
        req_id, method, args = frame
        return req_id, method, args, {}

    def _encode_reply(self, req_id, ok, payload) -> bytes:
        return encode([req_id, ok, payload])

    def _error_payload(self, e: BaseException):
        return [type(e).__name__, str(e)]

    def _invoke(self, fn, args, kwargs):
        from ..runtime.object_ref import counter_suppressed
        with counter_suppressed():  # refs built while serving a
            #                         cross-language call are
            #                         client-owned, never counted here
            return fn(*args)

    # -- method set -------------------------------------------------------
    def _ping(self):
        return {"ok": True, "exports": self._exports()}

    def _put(self, value):
        return self._rt.put_raw(value).binary()

    def _get(self, oid_bins, timeout):
        # values outside the xlang subset surface as a typed
        # XlangEncodeError reply from the base server's encode step
        return self._rt.get_raw([ObjectID(b) for b in oid_bins], timeout)

    def _wait(self, oid_bins, num_returns, timeout):
        ready, not_ready = self._rt.wait_raw(
            [ObjectID(b) for b in oid_bins], num_returns, timeout)
        return [[o.binary() for o in ready],
                [o.binary() for o in not_ready]]

    def _call(self, name, args, opts):
        fn = self._lookup(name, kind="function")
        fn = _apply_fn_opts(fn, opts or {})
        refs = fn.remote(*args)
        if not isinstance(refs, list):
            refs = [refs]
        return [r.id.binary() for r in refs]

    def _create_actor(self, name, args, opts):
        cls = self._lookup(name, kind="actor class")
        if opts:
            cls = cls.options(**_actor_opts(opts))
        handle = cls.remote(*args)
        return handle._actor_id.binary()

    def _actor_call(self, actor_bin, method, args, num_returns):
        from ..actor_api import ActorHandle, ActorMethod
        handle = ActorHandle(ActorID(actor_bin))
        n = 1 if num_returns is None else int(num_returns)
        refs = ActorMethod(handle, method, n).remote(*args)
        if not isinstance(refs, list):
            refs = [refs]
        return [r.id.binary() for r in refs]

    def _kill_actor(self, actor_bin, no_restart):
        self._rt.actor_manager.kill(ActorID(actor_bin),
                                    no_restart=bool(no_restart))

    def _exports(self):
        from .. import cross_language
        return cross_language.exports()

    def _cluster_resources(self):
        from .. import api
        return api.cluster_resources()

    def _available_resources(self):
        from .. import api
        return api.available_resources()

    def _lookup(self, name, kind):
        from .. import cross_language
        from ..actor_api import ActorClass
        from ..api import RemoteFunction
        obj = cross_language.lookup(name)
        if obj is None:
            raise KeyError(
                f"no cross-language export named {name!r} "
                f"(exports: {cross_language.exports()})")
        want = RemoteFunction if kind == "function" else ActorClass
        if not isinstance(obj, want):
            raise TypeError(f"export {name!r} is not a {kind}")
        return obj


def _apply_fn_opts(fn, opts: dict):
    kwargs = {}
    if "num_returns" in opts:
        kwargs["num_returns"] = int(opts["num_returns"])
    if "num_cpus" in opts:
        kwargs["num_cpus"] = opts["num_cpus"]
    if "resources" in opts:
        kwargs["resources"] = opts["resources"]
    if "max_retries" in opts:
        kwargs["max_retries"] = int(opts["max_retries"])
    unknown = set(opts) - {"num_returns", "num_cpus", "resources",
                           "max_retries"}
    if unknown:
        raise ValueError(f"unsupported call options: {sorted(unknown)}")
    return fn.options(**kwargs) if kwargs else fn


def _actor_opts(opts: dict) -> dict:
    allowed = {"name", "num_cpus", "resources", "max_restarts",
               "max_task_retries"}
    unknown = set(opts) - allowed
    if unknown:
        raise ValueError(f"unsupported actor options: {sorted(unknown)}")
    return dict(opts)
