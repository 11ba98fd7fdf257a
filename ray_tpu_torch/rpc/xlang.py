"""Cross-language wire codec (the msgpack analogue).

Reference parity: the reference serializes cross-language task args and
returns with msgpack so its C++/Java frontends can exchange values with
Python workers (SURVEY.md §2.1 third-party deps: "msgpack (cross-language
serialization)"; mount empty).  Here the codec is a small self-describing
tagged binary format implemented twice — this module and
``cpp/xlang.hpp`` — so the C++ frontend speaks to the head daemon without
pickle.

Value model (the cross-language subset):

    nil | bool | int64 | float64 | bytes | str(utf-8) | list | map

Encoding: one ASCII tag byte, then a fixed- or length-prefixed payload.
All integers are big-endian.  Lengths/counts are u32.

    'N'            nil
    'T' / 'F'      true / false
    'i' + 8B       int64 (two's complement)
    'd' + 8B       float64 (IEEE-754 bits)
    'b' + u32 + n  bytes
    's' + u32 + n  str (utf-8)
    'l' + u32 + v* list
    'm' + u32 + (k v)*  map (keys are themselves values)

Python tuples encode as lists (like msgpack); dict keys may be any
encodable value.  Anything outside the subset raises
``XlangEncodeError`` — the same hard boundary the reference draws at its
msgpack layer.
"""

from __future__ import annotations

import struct

_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U32 = struct.Struct(">I")

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


class XlangEncodeError(TypeError):
    """Value is outside the cross-language subset."""


class XlangDecodeError(ValueError):
    """Malformed cross-language frame."""


def encode(value) -> bytes:
    out = bytearray()
    _enc(value, out)
    return bytes(out)


def _enc(v, out: bytearray) -> None:
    if v is None:
        out += b"N"
    elif v is True:
        out += b"T"
    elif v is False:
        out += b"F"
    elif isinstance(v, int):
        if not _INT64_MIN <= v <= _INT64_MAX:
            raise XlangEncodeError(f"int out of int64 range: {v}")
        out += b"i" + _I64.pack(v)
    elif isinstance(v, float):
        out += b"d" + _F64.pack(v)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        out += b"b" + _U32.pack(len(b)) + b
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out += b"s" + _U32.pack(len(b)) + b
    elif isinstance(v, (list, tuple)):
        out += b"l" + _U32.pack(len(v))
        for item in v:
            _enc(item, out)
    elif isinstance(v, dict):
        out += b"m" + _U32.pack(len(v))
        for k, val in v.items():
            _enc(k, out)
            _enc(val, out)
    else:
        raise XlangEncodeError(
            f"{type(v).__name__} is not cross-language serializable "
            "(allowed: None, bool, int, float, bytes, str, list, dict)")


def decode(data) -> object:
    value, pos = _dec(memoryview(data), 0)
    if pos != len(data):
        raise XlangDecodeError(
            f"{len(data) - pos} trailing bytes after value")
    return value


def _dec(buf: memoryview, pos: int):
    if pos >= len(buf):
        raise XlangDecodeError("truncated frame: missing tag")
    tag = buf[pos]
    pos += 1
    if tag == 0x4E:                                     # 'N'
        return None, pos
    if tag == 0x54:                                     # 'T'
        return True, pos
    if tag == 0x46:                                     # 'F'
        return False, pos
    if tag == 0x69:                                     # 'i'
        _need(buf, pos, 8)
        return _I64.unpack_from(buf, pos)[0], pos + 8
    if tag == 0x64:                                     # 'd'
        _need(buf, pos, 8)
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag in (0x62, 0x73):                             # 'b' / 's'
        _need(buf, pos, 4)
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        _need(buf, pos, n)
        raw = bytes(buf[pos:pos + n])
        pos += n
        if tag == 0x73:
            try:
                return raw.decode("utf-8"), pos
            except UnicodeDecodeError as e:
                raise XlangDecodeError(f"bad utf-8 in str: {e}") from e
        return raw, pos
    if tag == 0x6C:                                     # 'l'
        _need(buf, pos, 4)
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        items = []
        for _ in range(n):
            item, pos = _dec(buf, pos)
            items.append(item)
        return items, pos
    if tag == 0x6D:                                     # 'm'
        _need(buf, pos, 4)
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        out = {}
        for _ in range(n):
            k, pos = _dec(buf, pos)
            if isinstance(k, (list, dict)):
                raise XlangDecodeError("unhashable map key")
            v, pos = _dec(buf, pos)
            out[k] = v
        return out, pos
    raise XlangDecodeError(f"unknown tag byte 0x{tag:02x}")


def _need(buf: memoryview, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise XlangDecodeError("truncated frame")
