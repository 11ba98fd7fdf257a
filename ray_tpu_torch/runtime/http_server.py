"""Shared scaffolding for the head's background HTTP endpoints.

The metrics exporter and the dashboard are both stdlib
``ThreadingHTTPServer``s on a daemon thread; this base owns the server
lifecycle and error discipline (handler exceptions answer as JSON 500s
rather than dropping the connection) so the two surfaces cannot drift.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class BackgroundHTTPServer:
    """Subclass and implement ``route(request)``; use ``reply`` to answer.

    ``port=0`` binds an ephemeral port (read it from ``self.port``).
    Non-GET verbs answer 501 unless the subclass widens
    ``allowed_methods``.
    """

    allowed_methods: tuple = ("GET",)

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 name: str = "http"):
        owner = self

        class Handler(BaseHTTPRequestHandler):
            def _dispatch(self):
                if self.command not in owner.allowed_methods:
                    # read-only surfaces (dashboard, metrics) must not
                    # silently treat mutating verbs as GETs
                    self.send_response(501)
                    self.end_headers()
                    return
                try:
                    owner.route(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 — 500 + JSON body
                    try:
                        owner.reply(self, json.dumps(
                            {"error": type(e).__name__,
                             "message": str(e)}).encode(),
                            "application/json", status=500)
                    except OSError:
                        pass

            do_GET = _dispatch      # noqa: N815 (stdlib API names)
            do_POST = _dispatch     # noqa: N815
            do_PUT = _dispatch      # noqa: N815
            do_DELETE = _dispatch   # noqa: N815

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"{name}-{self.port}")
        self._thread.start()

    def route(self, request: BaseHTTPRequestHandler) -> None:
        raise NotImplementedError

    @staticmethod
    def reply(request, body: bytes, content_type: str,
              status: int = 200, headers: dict | None = None) -> None:
        request.send_response(status)
        request.send_header("Content-Type", content_type)
        request.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            request.send_header(k, str(v))
        request.end_headers()
        request.wfile.write(body)

    @staticmethod
    def reply_stream(request, chunks, content_type: str,
                     status: int = 200) -> None:
        """Streaming response: chunked transfer for HTTP/1.1 clients,
        close-delimited raw bytes for HTTP/1.0 (which cannot decode
        chunk framing).

        Error discipline: the FIRST chunk is produced before any header
        goes out, so a handler that fails immediately still gets a clean
        500 from the caller's error path.  A failure AFTER headers
        truncates the stream WITHOUT the chunked terminator — the client
        detects the truncation — and is swallowed here (propagating
        would let the dispatcher append a second response to the same
        socket)."""
        it = iter(chunks)
        try:        # producer errors propagate: no headers sent yet,
            first = next(it)        # so the caller's error path 500s
        except StopIteration:
            first = b""
            it = iter(())
        chunked = request.request_version != "HTTP/1.0"
        if chunked:
            request.protocol_version = "HTTP/1.1"
        request.send_response(status)
        request.send_header("Content-Type", content_type)
        if chunked:
            request.send_header("Transfer-Encoding", "chunked")
        request.end_headers()

        def write(chunk: bytes) -> None:
            if not chunk:
                return
            if chunked:
                request.wfile.write(
                    f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
            else:
                request.wfile.write(chunk)
            request.wfile.flush()
        try:
            write(first)
            for chunk in it:
                write(chunk)
            if chunked:
                request.wfile.write(b"0\r\n\r\n")
        except Exception:   # noqa: BLE001 — mid-stream failure: leave
            pass            # the stream visibly truncated (no
            #                 terminator), never a second response
        request.close_connection = True

    @staticmethod
    def not_found(request) -> None:
        request.send_response(404)
        request.end_headers()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
