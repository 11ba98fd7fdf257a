"""C++ frontend: xlang codec, gateway, and the end-to-end cpp binary.

Covers the cross-language boundary from both sides: pure-Python codec
properties, gateway semantics against a live runtime, and the real
``cpp/test_frontend.cc`` binary (built with the baked-in g++) driving
put/get/call/actors over TCP — the reference's `cpp/` frontend story
(SURVEY.md §1 layer 8; mount empty).
"""

import hashlib
import math
import os
import subprocess

import pytest

import ray_tpu_torch
from ray_tpu_torch import cross_language
from ray_tpu_torch.rpc.xlang import (XlangDecodeError, XlangEncodeError, decode,
                               encode)
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_cpp_frontend.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable);
# - the C++ sources are the reference's (``cpp/``, the same wire), and
#   the binary is compiled into ``tmp_path`` in place of the
#   reference's git-ignored ``cpp/build/``.


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(REPO, "cpp")


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

ROUNDTRIP_VALUES = [
    None, True, False, 0, 1, -1, 2**63 - 1, -(2**63), 0.0, -2.5,
    math.inf, b"", b"\x00\xff", "", "héllo ✓", [], [1, [2, [3]]],
    {}, {"a": 1, 7: "seven", b"k": None},
    {"nested": {"xs": [1.5, True, None, b"raw"]}},
]


@pytest.mark.parametrize("value", ROUNDTRIP_VALUES,
                         ids=[repr(v)[:40] for v in ROUNDTRIP_VALUES])
def test_codec_roundtrip(value):
    assert decode(encode(value)) == value


def test_codec_nan_roundtrip():
    out = decode(encode(float("nan")))
    assert math.isnan(out)


def test_codec_tuple_encodes_as_list():
    assert decode(encode((1, 2))) == [1, 2]


def test_codec_rejects_out_of_subset():
    with pytest.raises(XlangEncodeError):
        encode(object())
    with pytest.raises(XlangEncodeError):
        encode({"fn": len})
    with pytest.raises(XlangEncodeError):
        encode(2**64)           # beyond int64


def test_codec_rejects_malformed():
    with pytest.raises(XlangDecodeError):
        decode(b"")
    with pytest.raises(XlangDecodeError):
        decode(b"i\x00")        # truncated int64
    with pytest.raises(XlangDecodeError):
        decode(b"q")            # unknown tag
    with pytest.raises(XlangDecodeError):
        decode(encode(1) + b"N")    # trailing bytes


def test_codec_wire_format_is_pinned():
    """The byte layout is a cross-language ABI shared with cpp/xlang.hpp —
    pin it exactly so a drive-by refactor cannot silently fork the two."""
    assert encode(None) == b"N"
    assert encode(True) == b"T"
    assert encode(1) == b"i" + b"\x00" * 7 + b"\x01"
    assert encode(-1) == b"i" + b"\xff" * 8
    assert encode(b"ab") == b"b\x00\x00\x00\x02ab"
    assert encode("ab") == b"s\x00\x00\x00\x02ab"
    assert encode([None]) == b"l\x00\x00\x00\x01N"
    assert encode({"a": 1}) == \
        b"m\x00\x00\x00\x01s\x00\x00\x00\x01ai" + b"\x00" * 7 + b"\x01"


# ---------------------------------------------------------------------------
# exports + gateway against a live runtime
# ---------------------------------------------------------------------------

def _register_exports():
    @cross_language.export("xadd")
    @ray_tpu_torch.remote
    def xadd(a, b):
        return a + b

    @cross_language.export("xconcat")
    @ray_tpu_torch.remote
    def xconcat(s, b):
        return s + "+" + b.decode()

    @cross_language.export("xdivmod")
    def xdivmod(a, b):
        return divmod(a, b)

    @cross_language.export("xget_plus")
    def xget_plus(oid_bytes, delta):
        from ray_tpu_torch.common.ids import ObjectID
        from ray_tpu_torch.runtime.object_ref import ObjectRef
        return ray_tpu_torch.get(ObjectRef(ObjectID(oid_bytes))) + delta

    @cross_language.export("xboom")
    def xboom():
        raise ValueError("boom")

    @cross_language.export("xopaque")
    def xopaque():
        return object()     # outside the cross-language subset

    @cross_language.export("XCounter")
    @ray_tpu_torch.remote
    class XCounter:
        def __init__(self, start):
            self.n = start

        def incr(self):
            self.n += 1
            return self.n

        def total(self):
            return self.n


@pytest.fixture
def gateway():
    from ray_tpu_torch.rpc.xlang_gateway import XlangGateway
    cross_language.clear()
    ray_tpu_torch.init(resources={"CPU": 4}, num_workers=2)
    _register_exports()
    gw = XlangGateway(ray_tpu_torch.api._get_runtime())
    try:
        yield gw
    finally:
        gw.stop()
        ray_tpu_torch.shutdown()
        cross_language.clear()


class _PyXlangClient:
    """Minimal Python-side client of the gateway (same wire as cpp/)."""

    def __init__(self, address):
        import socket
        host, port = address.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)), timeout=30)
        self._ids = iter(range(1 << 30))

    def rpc(self, method, *args):
        from ray_tpu_torch.rpc.xlang_gateway import recv_xframe, send_xframe
        req_id = next(self._ids)
        send_xframe(self.sock, [req_id, method, list(args)])
        rid, ok, payload = recv_xframe(self.sock)
        assert rid == req_id
        if ok:
            return payload
        raise RuntimeError(f"{payload[0]}: {payload[1]}")

    def close(self):
        self.sock.close()


def test_gateway_put_get_call_actor(gateway):
    cl = _PyXlangClient(gateway.address)
    try:
        pong = cl.rpc("ping")
        assert pong["ok"] is True and "xadd" in pong["exports"]

        oid = cl.rpc("put", {"xs": [1, 2.5, None, b"\x01"]})
        assert cl.rpc("get", [oid], 30.0) == [{"xs": [1, 2.5, None,
                                                      b"\x01"]}]

        (ref,) = cl.rpc("call", "xadd", [20, 22], None)
        assert cl.rpc("get", [ref], 30.0) == [42]

        actor = cl.rpc("create_actor", "XCounter", [5], None)
        (r1,) = cl.rpc("actor_call", actor, "incr", [], 1)
        assert cl.rpc("get", [r1], 30.0) == [6]
        cl.rpc("kill_actor", actor, True)
    finally:
        cl.close()


def test_gateway_typed_errors(gateway):
    cl = _PyXlangClient(gateway.address)
    try:
        with pytest.raises(RuntimeError, match="KeyError"):
            cl.rpc("call", "nope", [], None)
        with pytest.raises(RuntimeError, match="boom"):
            (ref,) = cl.rpc("call", "xboom", [], None)
            cl.rpc("get", [ref], 30.0)
        with pytest.raises(RuntimeError, match="XlangEncodeError"):
            (ref,) = cl.rpc("call", "xopaque", [], None)
            cl.rpc("get", [ref], 30.0)
        with pytest.raises(RuntimeError, match="unsupported call option"):
            cl.rpc("call", "xadd", [1, 2], {"nope": 1})
    finally:
        cl.close()


def test_export_registry_guards():
    cross_language.clear()
    try:
        @cross_language.export("dup")
        def f():
            return 1

        with pytest.raises(ValueError, match="already registered"):
            @cross_language.export("dup")
            def g():
                return 2

        assert cross_language.exports() == ["dup"]
        assert cross_language.lookup("dup") is not None
    finally:
        cross_language.clear()


def _module_level_export_fn():
    return 3


def test_export_reregistration_is_idempotent():
    """Module re-import / notebook re-run decorates the SAME
    module-level function again; each pass builds a fresh wrapper, so
    identity comparison alone would always collide."""
    cross_language.clear()
    try:
        cross_language.export("re")(_module_level_export_fn)
        cross_language.export("re")(_module_level_export_fn)
        assert cross_language.exports() == ["re"]

        # factory closures share a qualname while being different
        # functions — those keep the strict collision guard
        def make(k):
            def handler():
                return k
            return handler

        cross_language.export("fac")(make(1))
        with pytest.raises(ValueError, match="already registered"):
            cross_language.export("fac")(make(2))
    finally:
        cross_language.clear()


# ---------------------------------------------------------------------------
# the real C++ binary
# ---------------------------------------------------------------------------

def _build_cpp_binary(build_dir) -> str:
    """g++-compile test_frontend.cc, cached on a source-content hash."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain (g++) on this machine")
    srcs = ["test_frontend.cc", "xlang.hpp", "client.hpp"]
    digest = hashlib.sha256()
    for name in srcs:
        with open(os.path.join(CPP, name), "rb") as f:
            digest.update(f.read())
    out = os.path.join(str(build_dir),
                       f"test_frontend_{digest.hexdigest()[:16]}")
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = ["g++", "-O2", "-std=c++17", "-Wall", "-Wextra", "-Werror",
           "-pthread", "-o", out, os.path.join(CPP, "test_frontend.cc")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, f"cpp build failed:\n{proc.stderr}"
    return out


def test_cpp_frontend_end_to_end(gateway, tmp_path):
    binary = _build_cpp_binary(tmp_path)
    proc = subprocess.run([binary, gateway.address], capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, \
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "CPP_FRONTEND_OK" in proc.stdout


def test_head_daemon_exposes_xlang_address():
    from ray_tpu_torch.runtime.head import HeadNode
    cross_language.clear()
    head = HeadNode(resources={"CPU": 2}, num_workers=1)
    try:
        status = head._status()
        assert status["xlang_address"] == head.xlang.address
        _register_exports()
        cl = _PyXlangClient(head.xlang.address)
        try:
            (ref,) = cl.rpc("call", "xadd", [1, 2], None)
            assert cl.rpc("get", [ref], 30.0) == [3]
        finally:
            cl.close()
    finally:
        head.stop()
        cross_language.clear()
