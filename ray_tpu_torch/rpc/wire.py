"""Frame codec shared by the RPC server and client.

Frames are ``4-byte big-endian length + payload`` over a stream socket.
The raw layer (``send_raw_frame``/``recv_raw_frame``) is codec-agnostic
and shared with the cross-language gateway; this module's default codec
is cloudpickle.  Requests are ``(req_id, method, args, kwargs)``; replies
are ``(req_id, ok: bool, payload)`` where a non-ok payload is
``(exc_type_name, message, traceback_str)``.

Data channel: bulk payloads (object-plane chunks) bypass the pickle
codec entirely.  A handler returns a ``RawResult`` and the server emits
a *raw reply frame* instead of a pickled one: the first payload byte is
``RAW_MARKER`` (0x00) — unambiguous because every cloudpickle stream
starts with the pickle PROTO opcode 0x80 — followed by the req_id, a
small pickled meta object, and the payload bytes verbatim.  The payload
is gather-written with ``socket.sendmsg`` straight from the source
buffer (shm arena view / spill-file bytes, no serialize, no concat
copy) and the receiver hands back a ``memoryview`` into the receive
buffer, so bytes land in their final home with exactly one copy on
each side of the wire.
"""

from __future__ import annotations

import socket
import struct

from ..runtime.serialization import deserialize, serialize

_LEN = struct.Struct(">I")
MAX_FRAME = 512 * 1024 * 1024       # sanity bound, not a protocol limit

# first payload byte of a codec-bypass reply frame; pickled frames start
# with the pickle PROTO opcode (0x80), so 0x00 can never collide
RAW_MARKER = 0x00
# marker, req_id, flags (bit 0 = ok), meta length
_RAW_HDR = struct.Struct(">BQBI")
# the same header with the marker byte already consumed (the reply
# demultiplexer reads one byte to classify the frame)
_RAW_HDR_REST = struct.Struct(">QBI")

# past this size the header is gather-written alongside the payload
# instead of concatenated (the + would copy the payload to prepend a
# few bytes)
_SMALL_FRAME = 1 << 16

# chaos seam: ``rpc/chaos.py`` installs a per-connection bandwidth pacer
# (callable(sock, nbytes)) here when a cap is configured; None (the
# default) keeps the send path at a single global load + is-None test
_chaos_pacer = None


class RawResult:
    """Marker a handler returns to reply over the raw data channel:
    ``meta`` rides as a (small) pickled object, ``payload`` as raw
    bytes with no codec pass.  ``release`` (if set) runs once the bytes
    are on the socket — how the object store's shm pin is held exactly
    as long as the send needs the buffer."""

    __slots__ = ("meta", "payload", "release")

    def __init__(self, meta, payload=b"", release=None):
        self.meta = meta
        self.payload = payload
        self.release = release


class RawReply:
    """Client-side decoded raw reply: ``meta`` (unpickled small object)
    plus a zero-copy ``payload`` memoryview into the receive buffer —
    or ``payload=None`` when the bytes were received straight into a
    caller-provided sink (see ``recv_reply``)."""

    __slots__ = ("meta", "payload")

    def __init__(self, meta, payload):
        self.meta = meta
        self.payload = payload


def sendmsg_all(sock: socket.socket, buffers) -> None:
    """Gather-write every buffer completely.  ``sendmsg`` is one
    syscall for header+payload with no concatenation copy, but may
    write short — loop, advancing past what the kernel took."""
    bufs = [b if isinstance(b, memoryview) else memoryview(b)
            for b in buffers]
    total = sum(b.nbytes for b in bufs)
    sent = 0
    while sent < total:
        n = sock.sendmsg(bufs)
        sent += n
        if sent >= total:
            return
        while bufs and n >= bufs[0].nbytes:
            n -= bufs[0].nbytes
            bufs.pop(0)
        if bufs and n:
            bufs[0] = bufs[0][n:]


def send_raw_frame(sock: socket.socket, data) -> None:
    """``data`` may be bytes, bytearray, or memoryview."""
    n = data.nbytes if isinstance(data, memoryview) else len(data)
    if _chaos_pacer is not None:
        _chaos_pacer(sock, n)
    if n > _SMALL_FRAME:
        # large frame: gather-write header+payload in one syscall,
        # zero-copy from the caller's buffer
        sendmsg_all(sock, [_LEN.pack(n), data])
        return
    sock.sendall(_LEN.pack(n) + bytes(data))


def send_raw_reply(sock: socket.socket, req_id: int, meta_bytes: bytes,
                   payload, ok: bool = True) -> int:
    """One codec-bypass reply frame; returns its wire byte count.
    ``payload`` is any buffer — it is gather-written verbatim."""
    if not isinstance(payload, memoryview):
        payload = memoryview(payload)
    hdr = _RAW_HDR.pack(RAW_MARKER, req_id, 1 if ok else 0,
                        len(meta_bytes))
    n = len(hdr) + len(meta_bytes) + payload.nbytes
    if _chaos_pacer is not None:
        _chaos_pacer(sock, n)
    sendmsg_all(sock, [_LEN.pack(n), hdr, meta_bytes, payload])
    return n


def is_raw_frame(frame) -> bool:
    return len(frame) > 0 and frame[0] == RAW_MARKER


def parse_raw_reply(frame) -> tuple[int, bool, "RawReply"]:
    """(req_id, ok, RawReply) from a raw reply frame's payload buffer.
    The returned payload is a memoryview INTO ``frame`` — valid as long
    as the caller keeps the buffer alive, copied only when it lands in
    its final home."""
    _marker, req_id, flags, meta_len = _RAW_HDR.unpack_from(frame, 0)
    off = _RAW_HDR.size
    meta = (deserialize(bytes(frame[off:off + meta_len]))
            if meta_len else None)
    view = frame if isinstance(frame, memoryview) else memoryview(frame)
    return req_id, bool(flags & 1), RawReply(meta, view[off + meta_len:])


def recv_raw_frame(sock: socket.socket) -> bytes | None:
    """One frame's payload bytes, or None on clean EOF."""
    buf = recv_raw_frame_buf(sock)
    return None if buf is None else bytes(buf)


def recv_raw_frame_buf(sock: socket.socket) -> bytearray | None:
    """Buffer-returning variant: the payload lands in a fresh bytearray
    that is returned as-is — large frames skip the trailing ``bytes()``
    copy, and memoryview slices of it feed zero-copy ingest."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ConnectionError(f"frame of {n} bytes exceeds sanity bound")
    body = _recv_exact_buf(sock, n)
    if body is None:
        raise ConnectionError("connection closed mid-frame")
    return body


def recv_reply(sock: socket.socket, sink_for=None):
    """One reply frame, demultiplexed AT THE WIRE: ``(req_id, ok,
    payload)``, or None on clean EOF.

    Raw frames skip the codec; additionally, when ``sink_for(req_id,
    payload_len)`` returns a writable buffer, the payload bytes are
    received STRAIGHT into it — kernel to final home, no intermediate
    frame buffer — and the returned ``RawReply.payload`` is None to
    mean "already landed in your sink".  ``sink_for`` returning None
    (wrong length, no sink registered, non-shm ingest) falls back to
    the buffered receive.  Pickled control frames deserialize as
    before."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME:
        raise ConnectionError(f"frame of {n} bytes exceeds sanity bound")
    if n == 0:
        raise ConnectionError("empty reply frame")
    first = _recv_exact(sock, 1)
    if first is None:
        raise ConnectionError("connection closed mid-frame")
    if first[0] != RAW_MARKER:
        # pickled control frame: reassemble around the consumed byte
        buf = bytearray(n)
        buf[0] = first[0]
        if n > 1:
            _recv_into_exact(sock, memoryview(buf)[1:])
        return deserialize(buf)
    rest = _recv_exact(sock, _RAW_HDR.size - 1)
    if rest is None:
        raise ConnectionError("connection closed mid-frame")
    req_id, flags, meta_len = _RAW_HDR_REST.unpack(rest)
    ok = bool(flags & 1)
    meta = None
    if meta_len:
        meta_bytes = _recv_exact(sock, meta_len)
        if meta_bytes is None:
            raise ConnectionError("connection closed mid-frame")
        meta = deserialize(meta_bytes)
    payload_len = n - _RAW_HDR.size - meta_len
    sink = (sink_for(req_id, payload_len)
            if ok and sink_for is not None else None)
    if sink is not None:
        _recv_into_exact(sock, sink if isinstance(sink, memoryview)
                         else memoryview(sink))
        return req_id, ok, RawReply(meta, None)
    body = _recv_exact_buf(sock, payload_len)
    if body is None:
        raise ConnectionError("connection closed mid-frame")
    return req_id, ok, RawReply(meta, memoryview(body))


# -- batched submits (the lease plane's fast-path wire format) ---------------
# One framed multi-submit coalesces every worker submission drained in a
# single agent pump cycle into one upward frame: marker byte + count,
# then length-prefixed serialized entries.  0x01 cannot collide with
# either existing first byte on the channel (0x80 pickle PROTO, 0x00
# RAW_MARKER).
MULTI_SUBMIT_MARKER = 0x01
_MSUB_HDR = struct.Struct(">BI")
_MSUB_LEN = struct.Struct(">I")


def pack_multi_submit(entries) -> bytes:
    """``entries`` is a list of already-serialized frame payloads (each
    one worker ``submit`` tuple).  Returns one frame payload carrying
    them all."""
    parts = [_MSUB_HDR.pack(MULTI_SUBMIT_MARKER, len(entries))]
    for e in entries:
        parts.append(_MSUB_LEN.pack(len(e)))
        parts.append(bytes(e))
    return b"".join(parts)


def is_multi_submit(frame) -> bool:
    return len(frame) > 0 and frame[0] == MULTI_SUBMIT_MARKER


def unpack_multi_submit(frame) -> list[bytes]:
    """The individual serialized entries packed by ``pack_multi_submit``
    (round-trip exact: bytes in == bytes out, order preserved)."""
    _marker, count = _MSUB_HDR.unpack_from(frame, 0)
    off = _MSUB_HDR.size
    out = []
    for _ in range(count):
        (n,) = _MSUB_LEN.unpack_from(frame, off)
        off += _MSUB_LEN.size
        out.append(bytes(frame[off:off + n]))
        off += n
    if off != len(frame):
        raise ConnectionError(
            f"multi-submit frame has {len(frame) - off} trailing bytes")
    return out


def send_frame(sock: socket.socket, obj) -> None:
    send_raw_frame(sock, serialize(obj))


def recv_frame(sock: socket.socket):
    """One frame, or None on clean EOF."""
    body = recv_raw_frame(sock)
    return None if body is None else deserialize(body)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = _recv_exact_buf(sock, n)
    return None if buf is None else bytes(buf)


def _recv_into_exact(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` completely from the socket; a drop mid-read is
    always an error (the frame length promised these bytes)."""
    n = view.nbytes
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise ConnectionError("connection closed mid-frame")
        got += r


def _recv_exact_buf(sock: socket.socket, n: int) -> bytearray | None:
    """``n`` bytes into a fresh bytearray, None on clean EOF; a drop
    mid-read is an error — silently treating a truncated header as EOF
    would swallow a frame.

    ``recv_into`` a preallocated buffer: ``recv(n)`` with a multi-MB
    ``n`` makes CPython allocate the full request per call while the
    kernel delivers ~128KB — O(n^2) allocation across a large frame."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            if got:
                raise ConnectionError("connection closed mid-frame")
            return None
        got += r
    return buf
