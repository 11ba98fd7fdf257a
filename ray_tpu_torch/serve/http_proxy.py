"""Serve HTTP ingress: routes requests to deployment replica pools.

Reference parity: Serve's HTTP proxy is its primary surface — an HTTP
server on every node routes ``/route_prefix`` requests into deployment
replica sets, JSON in/out, with per-request timeouts
(``python/ray/serve/_private/proxy.py``, SURVEY.md §1 layer 14; mount
empty).  Here one ingress runs in the driver/head process on the shared
``BackgroundHTTPServer`` scaffolding; ``serve.run(..., route_prefix=…)``
binds a prefix to the application's handle.

Replicas see a plain ``HTTPRequest`` value (method, path, query, body)
and may return ``bytes``/``str`` (sent raw) or any JSON-serializable
value (sent as ``application/json``).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from urllib.parse import parse_qsl, urlsplit

from ..runtime.http_server import BackgroundHTTPServer


@dataclass
class HTTPRequest:
    """What a deployment's ``__call__`` receives for an HTTP request."""

    method: str
    path: str                       # full path, route prefix included
    query: dict = field(default_factory=dict)
    body: bytes = b""

    def json(self):
        return json.loads(self.body) if self.body else None


class HttpIngress(BackgroundHTTPServer):
    allowed_methods = ("GET", "POST", "PUT", "DELETE")

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 request_timeout_s: float = 30.0,
                 max_body_bytes: int = 64 * 1024 * 1024):
        self._routes: dict[str, object] = {}    # prefix -> handle
        self._rlock = threading.Lock()
        self._timeout = request_timeout_s
        self._max_body = max_body_bytes
        super().__init__(host=host, port=port, name="serve-http")

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def add_route(self, prefix: str, handle,
                  stream: bool = False) -> None:
        """``stream=True``: the deployment's handler is a GENERATOR —
        responses go out with chunked transfer encoding, one chunk per
        yielded item (reference: Serve streaming HTTP responses)."""
        prefix = _norm_prefix(prefix)
        # handle variants are cheap facades over one shared per-
        # deployment RequestRouter, so building them here or per
        # request makes no routing difference; the stream one is
        # prebuilt simply because its mode is fixed per route
        stream_handle = handle.options(stream=True) if stream else None
        with self._rlock:
            self._routes[prefix] = (handle, stream_handle)

    def remove_route(self, prefix: str, handle=None) -> None:
        """Drop a route; with ``handle`` given, only if that handle
        still owns it (a later app may have claimed the prefix)."""
        prefix = _norm_prefix(prefix)
        with self._rlock:
            entry = self._routes.get(prefix)
            if handle is None or (entry is not None
                                  and entry[0] is handle):
                self._routes.pop(prefix, None)

    def routes(self) -> list[str]:
        with self._rlock:
            return sorted(self._routes)

    # -- request path --------------------------------------------------------
    def route(self, request) -> None:
        import ray_tpu_torch
        parts = urlsplit(request.path)
        path = parts.path or "/"
        if path == "/-/routes":     # the reference's route listing
            self.reply(request, json.dumps(self.routes()).encode(),
                       "application/json")
            return
        matched = self._match(path)
        handle, stream_handle = matched if matched else (None, None)
        if handle is None:
            self.reply(request, json.dumps(
                {"error": "NotFound",
                 "message": f"no route matches {path!r}",
                 "routes": self.routes()}).encode(),
                "application/json", status=404)
            return
        try:
            n = int(request.headers.get("Content-Length") or 0)
        except ValueError:
            n = -1
        if n < 0:
            # malformed/negative Content-Length: read(-1) would buffer
            # the stream until EOF — refuse instead
            self.reply(request, json.dumps(
                {"error": "BadRequest",
                 "message": "missing or malformed Content-Length"}
                ).encode(), "application/json", status=400)
            return
        if n > self._max_body:
            # refuse before allocating: an oversized Content-Length must
            # not allocate in the ingress process before the handler runs
            self.reply(request, json.dumps(
                {"error": "PayloadTooLarge",
                 "message": f"body of {n} bytes exceeds the ingress "
                            f"limit of {self._max_body}"}).encode(),
                "application/json", status=413)
            return
        body = request.rfile.read(n) if n else b""
        req = HTTPRequest(method=request.command, path=path,
                          query=dict(parse_qsl(parts.query)), body=body)
        # deadline propagation: X-Request-Deadline carries the client's
        # remaining budget in seconds; the effective deadline (never
        # looser than the ingress timeout) rides into the router, which
        # drops the request BEFORE dispatch if it expires while queued
        timeout = self._timeout
        hdr = request.headers.get("X-Request-Deadline")
        if hdr is not None:
            try:
                timeout = min(timeout, float(hdr))
            except ValueError:
                self.reply(request, json.dumps(
                    {"error": "BadRequest",
                     "message": "malformed X-Request-Deadline header"}
                    ).encode(), "application/json", status=400)
                return
            if timeout <= 0:
                self._reply_deadline(request, "deadline already expired")
                return
        # sharded request plane: a session key (X-Session-Id header,
        # else the multiplexed model id header) consistent-hashes the
        # call onto one router shard — the in-process analogue of each
        # ingress replica owning a shard.  Sessionless requests spread
        # round-robin across shards.
        session = (request.headers.get("X-Session-Id")
                   or request.headers.get("serve_multiplexed_model_id")
                   or "")
        mux = request.headers.get("serve_multiplexed_model_id") or ""
        if session or mux:
            handle = handle.options(session_id=session,
                                    multiplexed_model_id=mux)
            if stream_handle is not None:
                stream_handle = stream_handle.options(
                    session_id=session, multiplexed_model_id=mux)
        if stream_handle is not None:
            try:
                gen = stream_handle.remote(req)
            except Exception as e:      # noqa: BLE001
                self._reply_error(request, e)
                return

            def chunks():
                for ref in gen:
                    item = ray_tpu_torch.get(ref, timeout=timeout)
                    if isinstance(item, (bytes, bytearray)):
                        yield bytes(item)
                    elif isinstance(item, str):
                        yield item.encode()
                    else:       # JSON lines for structured items
                        yield json.dumps(item).encode() + b"\n"
            self.reply_stream(request, chunks(),
                              "application/octet-stream")
            return
        try:
            result = ray_tpu_torch.get(
                handle.options(timeout_s=timeout).remote(req),
                timeout=timeout)
        except Exception as e:          # noqa: BLE001
            self._reply_error(request, e)
            return
        if isinstance(result, (bytes, bytearray)):
            self.reply(request, bytes(result), "application/octet-stream")
        elif isinstance(result, str):
            self.reply(request, result.encode(),
                       "text/plain; charset=utf-8")
        else:
            self.reply(request, json.dumps(result).encode(),
                       "application/json")

    # -- error mapping -------------------------------------------------------
    def _reply_error(self, request, exc: Exception) -> None:
        """Structured error responses: a shed request answers 503 with a
        Retry-After hint, a blown deadline answers 504, and a handler
        exception answers 500 — never a dropped connection."""
        from ..common.status import BackPressureError
        if isinstance(exc, BackPressureError):
            from ..common.config import get_config
            retry_after = max(get_config().serve_retry_after_s, 0.0)
            self.reply(request, json.dumps(
                {"error": "BackPressure", "message": str(exc)}).encode(),
                "application/json", status=503,
                headers={"Retry-After": f"{retry_after:g}"})
        elif isinstance(exc, TimeoutError):
            self._reply_deadline(request, str(exc))
        else:
            self.reply(request, json.dumps(
                {"error": type(exc).__name__,
                 "message": str(exc)}).encode(),
                "application/json", status=500)

    def _reply_deadline(self, request, message: str) -> None:
        self.reply(request, json.dumps(
            {"error": "DeadlineExceeded", "message": message}).encode(),
            "application/json", status=504)

    def _match(self, path: str):
        """Longest-prefix route match on path-segment boundaries;
        returns (handle, stream) or None."""
        with self._rlock:
            best = None
            for prefix, entry in self._routes.items():
                if path == prefix or prefix == "/" or \
                        path.startswith(prefix + "/"):
                    if best is None or len(prefix) > len(best[0]):
                        best = (prefix, entry)
            return best[1] if best else None


def _norm_prefix(prefix: str) -> str:
    if not prefix.startswith("/"):
        raise ValueError(f"route_prefix must start with '/': {prefix!r}")
    return prefix.rstrip("/") or "/"
