"""Wire codec: length-prefixed frames + the codec-bypass raw data
channel (``rpc/wire.py``).

The raw channel is the object plane's bulk-byte path: chunk payloads
ride as raw reply frames (marker byte 0x00 — unambiguous against the
pickle PROTO opcode 0x80), gather-written with ``sendmsg`` straight
from the source buffer and landed as memoryviews into the receive
buffer.  These tests are deliberately fast (socketpairs and loopback
RPC) so tier-1 always exercises the raw framing.
"""

import socket
import threading

import pytest

from ray_tpu_torch.rpc import RawReply, RawResult, RpcClient, RpcServer
from ray_tpu_torch.rpc.wire import (is_raw_frame, parse_raw_reply,
                                    recv_raw_frame, recv_raw_frame_buf,
                                    send_raw_frame, send_raw_reply,
                                    sendmsg_all)
from ray_tpu_torch.runtime.serialization import serialize

# Port copy of tests/test_wire.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixture below resets the port's process-global state
#   (Config, chaos, breakers, the clock and transport seams) as
#   tests/conftest.py resets the reference's, and sets
#   RT_SCHEDULER_DEVICE=cpu: the port's device programs run on the GPU
#   unless asked for the CPU (subprocesses inherit the variable).


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    from ray_tpu_torch.common import clock
    from ray_tpu_torch.common.config import Config as PortConfig
    from ray_tpu_torch.rpc import breaker, chaos, transport
    monkeypatch.setenv("RT_SCHEDULER_DEVICE", "cpu")
    PortConfig.reset()
    chaos.disable()
    breaker.reset_registry()
    yield
    clock.uninstall()
    transport.uninstall()
    chaos.disable()
    breaker.reset_registry()
    PortConfig.reset()


def _pair():
    a, b = socket.socketpair()
    return a, b


def _recv_in_thread(sock, out, buf=False):
    def run():
        out.append(recv_raw_frame_buf(sock) if buf
                   else recv_raw_frame(sock))
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


class TestRawFrames:
    def test_small_frame_roundtrip(self):
        a, b = _pair()
        send_raw_frame(a, b"hello")
        assert recv_raw_frame(b) == b"hello"
        a.close(), b.close()

    @pytest.mark.parametrize("container", [bytes, bytearray, memoryview])
    def test_large_frame_any_buffer(self, container):
        """The sendmsg gather path accepts bytes/bytearray/memoryview
        and survives partial kernel writes (socketpair buffers are far
        smaller than 4 MB)."""
        payload = bytes(range(256)) * (4 * 4096)        # 4 MiB
        a, b = _pair()
        out = []
        t = _recv_in_thread(b, out)
        send_raw_frame(a, container(payload))
        t.join(10)
        assert out and out[0] == payload
        a.close(), b.close()

    def test_buffer_variant_skips_trailing_copy(self):
        a, b = _pair()
        out = []
        t = _recv_in_thread(b, out, buf=True)
        send_raw_frame(a, b"x" * 100_000)
        t.join(10)
        assert isinstance(out[0], bytearray)
        assert bytes(out[0]) == b"x" * 100_000
        a.close(), b.close()

    def test_sendmsg_all_many_buffers(self):
        a, b = _pair()
        parts = [b"a" * 10, b"b" * 70_000, b"c" * 5, b"d" * 130_000]
        total = b"".join(parts)
        got = []

        def read():
            n = 0
            while n < len(total):
                chunk = b.recv(65536)
                got.append(chunk)
                n += len(chunk)
        t = threading.Thread(target=read, daemon=True)
        t.start()
        sendmsg_all(a, parts)
        t.join(10)
        assert b"".join(got) == total
        a.close(), b.close()


class TestRawReplies:
    def test_roundtrip_meta_and_payload(self):
        a, b = _pair()
        payload = b"\x01\x02" * 300_000
        out = []
        t = _recv_in_thread(b, out, buf=True)
        n = send_raw_reply(a, 42, serialize(("shm", 77)),
                           memoryview(payload))
        t.join(10)
        frame = out[0]
        assert n == len(frame)
        assert is_raw_frame(frame)
        req_id, ok, rep = parse_raw_reply(frame)
        assert req_id == 42 and ok
        assert isinstance(rep, RawReply)
        assert rep.meta == ("shm", 77)
        assert isinstance(rep.payload, memoryview)
        assert bytes(rep.payload) == payload
        a.close(), b.close()

    def test_pickled_frames_are_not_raw(self):
        """Every cloudpickle stream opens with the PROTO opcode 0x80 —
        the 0x00 raw marker can never collide with a pickled reply."""
        a, b = _pair()
        send_raw_frame(a, serialize((1, True, "payload")))
        frame = recv_raw_frame_buf(b)
        assert not is_raw_frame(frame)
        assert frame[0] == 0x80
        a.close(), b.close()


class TestRawRpcChannel:
    """End-to-end over a real RpcServer/RpcClient connection: a handler
    returning RawResult bypasses the codec, interleaved with ordinary
    pickled calls on the same socket."""

    @pytest.fixture
    def server(self):
        released = []
        blob = b"\xfe\xed" * 400_000

        def fetch(offset: int, length: int):
            view = memoryview(blob)[offset:offset + length]
            return RawResult(("shm", len(blob)), view,
                             release=lambda: released.append(
                                 (offset, length)))

        def echo(x):
            return x

        def boom():
            raise ValueError("kaboom")

        srv = RpcServer({"fetch": fetch, "echo": echo, "boom": boom})
        srv.start()
        srv._released = released
        srv._blob = blob
        try:
            yield srv
        finally:
            srv.stop()

    def test_raw_reply_and_release(self, server):
        client = RpcClient(server.address)
        try:
            rep = client.call("fetch", 16, 100_000)
            assert isinstance(rep, RawReply)
            assert rep.meta == ("shm", len(server._blob))
            assert bytes(rep.payload) == server._blob[16:100_016]
            # the shm-pin analogue released once the bytes were sent
            deadline = 50
            while not server._released and deadline:
                threading.Event().wait(0.02)
                deadline -= 1
            assert server._released == [(16, 100_000)]
        finally:
            client.close()

    def test_interleaved_raw_and_pickled(self, server):
        client = RpcClient(server.address)
        try:
            futs = [client.call_async("fetch", i * 1000, 1000)
                    for i in range(8)]
            assert client.call("echo", {"k": 1}) == {"k": 1}
            for i, f in enumerate(futs):
                rep = f.result(10)
                assert bytes(rep.payload) == \
                    server._blob[i * 1000:(i + 1) * 1000]
            with pytest.raises(Exception, match="kaboom"):
                client.call("boom")
        finally:
            client.close()

    def test_call_async_on_done_fires(self, server):
        client = RpcClient(server.address)
        try:
            fired = threading.Event()
            fut = client.call_async("echo", 7, on_done=fired.set)
            assert fired.wait(10)
            assert fut.done() and fut.result(0) == 7
        finally:
            client.close()

    def test_on_done_fires_on_connection_loss(self, server):
        """A windowed puller parked on completions must wake when the
        peer dies, not hang: connection loss resolves every pending
        future and fires its callback."""
        client = RpcClient(server.address)
        fired = threading.Event()
        # a method that never replies (no such handler replies fast with
        # an error; use a handler that blocks instead): simulate by
        # killing the server before the reply can land on a slow call
        ev = threading.Event()
        server.add_handler("stall", ev.wait)
        fut = client.call_async("stall", on_done=fired.set)
        server.stop()
        assert fired.wait(10)
        with pytest.raises(Exception):
            fut.result(0)
        ev.set()
        client.close()
