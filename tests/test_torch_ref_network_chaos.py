"""Deterministic network-chaos plane + gray-failure hardening.

Covers the rpc-layer failure model end to end: seeded drop/dup/delay
injection replays bit-for-bit from the same seed (the trace IS the
assertion), directed partitions block and heal, idempotent retry
exhausts its budget and stops, the per-peer circuit breaker walks
closed -> open -> half-open -> closed, a closing client fails every
outstanding future, and an open breaker on a node's plane address
quarantines the row (suspect in the CRM, soft-avoided by placement).
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.common.config import Config
from ray_tpu_torch.rpc import RpcClient, RpcServer, breaker, chaos
from ray_tpu_torch.rpc.breaker import (CLOSED, HALF_OPEN, OPEN,
                                 CircuitOpenError, PeerBreaker)
from ray_tpu_torch.rpc.client import RpcConnectionError
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_network_chaos.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


pytestmark = pytest.mark.chaos


@pytest.fixture
def echo_server():
    srv = RpcServer({"echo": lambda x: x}).start()
    try:
        yield srv
    finally:
        srv.stop()


class TestSeededDeterminism:
    def test_same_seed_same_actions_and_trace(self):
        """The per-link Philox streams are a pure function of
        (seed, link): replaying after reset_trace() reproduces the
        exact action sequence AND the recorded fault trace."""
        chaos.configure(seed=123, drop_p=0.2, dup_p=0.1,
                        delay_p=0.1, delay_ms=1.0)
        ch = chaos.active()
        peer = "203.0.113.5:7001"

        def round_():
            acts = [ch.send_action(peer) for _ in range(150)]
            acts += [ch.recv_action(peer) for _ in range(80)]
            acts += [ch.reply_action(peer) for _ in range(80)]
            return acts

        a1 = round_()
        t1 = chaos.trace()
        chaos.reset_trace()
        a2 = round_()
        t2 = chaos.trace()
        assert a1 == a2
        assert t1 == t2 and t1
        assert "drop" in a1 and "dup" in a1
        # a different seed yields a different fault schedule
        chaos.configure(seed=124, drop_p=0.2, dup_p=0.1,
                        delay_p=0.1, delay_ms=1.0)
        ch = chaos.active()
        assert [ch.send_action(peer) for _ in range(150)] != a1[:150]

    def test_end_to_end_rpc_trace_replays(self, echo_server):
        """Same seed, same call sequence, same client -> identical
        results and an identical injected-fault trace across all three
        links (out/in/srv).  dup stays off here: duplicated requests
        run on concurrent handler threads whose reply order is not part
        of the determinism contract."""
        Config.reset({"rpc_retry_max_attempts": 4,
                      "rpc_retry_base_ms": 2.0,
                      "rpc_retry_max_ms": 10.0})
        client = RpcClient(echo_server.address, timeout=5.0,
                           retryable=frozenset({"echo"}))
        try:
            chaos.configure(seed=7, drop_p=0.15, delay_p=0.5,
                            delay_ms=3.0)

            def round_():
                out = []
                for i in range(8):
                    try:
                        out.append(client.call("echo", i, timeout=0.2))
                    except (TimeoutError, ConnectionError):
                        out.append("lost")
                time.sleep(0.05)    # let delayed replies land
                return out

            r1 = round_()
            t1 = chaos.trace()
            chaos.reset_trace()
            r2 = round_()
            t2 = chaos.trace()
            assert r1 == r2
            assert t1 == t2 and t1
            st = chaos.status()
            assert st["num_dropped"] > 0 and st["num_delayed"] > 0
        finally:
            client.close()


class TestPartitions:
    def test_directed_partition_drops_requests_then_heals(
            self, echo_server):
        client = RpcClient(echo_server.address, timeout=5.0)
        try:
            chaos.add_partition("*", echo_server.address)
            with pytest.raises(TimeoutError):
                client.call("echo", 1, timeout=0.3)
            # the frame never left this process
            assert echo_server.method_calls.get("echo") is None
            assert chaos.status()["num_partitioned"] == 1
            chaos.heal("*", echo_server.address)
            assert client.call("echo", 2, timeout=5.0) == 2
        finally:
            client.close()

    def test_asymmetric_reply_partition(self, echo_server):
        """src=<server>, dst=* drops the server's REPLIES: requests
        arrive and execute, answers vanish — the classic gray failure."""
        client = RpcClient(echo_server.address, timeout=5.0)
        try:
            chaos.add_partition(echo_server.address, "*")
            with pytest.raises(TimeoutError):
                client.call("echo", 3, timeout=0.4)
            assert echo_server.method_calls.get("echo") == 1
            chaos.heal()
            assert client.call("echo", 4, timeout=5.0) == 4
        finally:
            client.close()

    def test_duplicated_request_is_at_least_once(self, echo_server):
        """dup_p=1: the handler runs twice per call (at-least-once
        delivery); the client demux drops the surplus replies and the
        call still returns exactly one result."""
        chaos.configure(seed=1, dup_p=1.0)
        client = RpcClient(echo_server.address, timeout=5.0)
        try:
            assert client.call("echo", 9, timeout=5.0) == 9
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and \
                    echo_server.method_calls.get("echo", 0) < 2:
                time.sleep(0.01)
            assert echo_server.method_calls.get("echo") == 2
            assert chaos.status()["num_duplicated"] >= 1
            assert client.call("echo", 10, timeout=5.0) == 10
        finally:
            client.close()


class TestRetryBudget:
    def test_budget_exhaustion_under_total_loss(self, echo_server):
        """drop_p=1: every attempt is lost; the retryable call makes
        exactly rpc_retry_max_attempts sends, then raises."""
        Config.reset({"rpc_retry_max_attempts": 3,
                      "rpc_retry_base_ms": 2.0,
                      "rpc_retry_max_ms": 8.0})
        chaos.configure(seed=2, drop_p=1.0)
        client = RpcClient(echo_server.address,
                           retryable=frozenset({"echo"}))
        try:
            t0 = time.monotonic()
            with pytest.raises(TimeoutError):
                client.call("echo", 1, timeout=0.15)
            assert time.monotonic() - t0 >= 3 * 0.15 - 0.01
            assert chaos.status()["num_dropped"] == 3
            assert echo_server.method_calls.get("echo") is None
        finally:
            client.close()

    def test_non_retryable_method_fails_on_first_loss(self, echo_server):
        chaos.configure(seed=2, drop_p=1.0)
        client = RpcClient(echo_server.address)
        try:
            with pytest.raises(TimeoutError):
                client.call("echo", 1, timeout=0.15)
            assert chaos.status()["num_dropped"] == 1
        finally:
            client.close()


class TestCircuitBreaker:
    def test_state_machine(self):
        b = PeerBreaker("peer:1", threshold=2, reset_s=0.05)
        assert b.allow() and b.state == CLOSED
        b.record_failure()
        assert b.state == CLOSED            # 1 < threshold
        b.record_failure()
        assert b.state == OPEN and b.opens == 1
        assert not b.allow()                # fail fast while open
        time.sleep(0.06)
        assert b.allow() and b.state == HALF_OPEN
        assert not b.allow()                # one probe at a time
        b.record_failure()                  # failed probe
        assert b.state == OPEN and b.opens == 2
        time.sleep(0.06)
        assert b.allow()
        b.record_success()
        assert b.state == CLOSED and b.allow()

    def test_client_fails_fast_while_open(self):
        Config.reset({"rpc_breaker_failure_threshold": 2,
                      "rpc_breaker_reset_s": 60.0})
        srv = RpcServer({"echo": lambda x: x}).start()
        addr = srv.address
        client = RpcClient(addr, breaker=True)
        try:
            assert client.call("echo", 1, timeout=5.0) == 1
            srv.stop()
            for _ in range(2):
                with pytest.raises((TimeoutError, ConnectionError)):
                    client.call("echo", 1, timeout=0.3)
            assert breaker.is_open(addr)
            t0 = time.monotonic()
            with pytest.raises(CircuitOpenError):
                client.call("echo", 1, timeout=5.0)
            assert time.monotonic() - t0 < 0.1      # no timeout burned
        finally:
            client.close()
            srv.stop()


class TestNoHungFutures:
    @pytest.fixture
    def stall_server(self):
        release = threading.Event()
        srv = RpcServer({"stall": lambda: release.wait(30),
                         "echo": lambda x: x}).start()
        try:
            yield srv
        finally:
            release.set()
            srv.stop()

    def test_close_fails_outstanding_futures(self, stall_server):
        client = RpcClient(stall_server.address)
        fired = threading.Event()
        fut = client.call_async("stall", on_done=fired.set)
        assert not fut.done()
        client.close()
        assert fired.wait(5), "on_done did not fire on close"
        with pytest.raises(RpcConnectionError):
            fut.result(5)

    def test_server_death_fails_outstanding_futures(self, stall_server):
        client = RpcClient(stall_server.address)
        try:
            futs = [client.call_async("stall") for _ in range(4)]
            time.sleep(0.05)
            stall_server.stop()
            for f in futs:
                assert f.wait(10), "future hung after peer death"
                with pytest.raises(RpcConnectionError):
                    f.result(0)
        finally:
            client.close()

    def test_timed_out_future_is_reaped(self, stall_server):
        client = RpcClient(stall_server.address)
        try:
            fut = client.call_async("stall")
            with pytest.raises(TimeoutError):
                fut.result(0.1)
            assert fut._req_id not in client._pending
            # the connection stays healthy for subsequent calls
            assert client.call("echo", 1, timeout=5.0) == 1
        finally:
            client.close()


class TestQuarantineWiring:
    def test_open_breaker_quarantines_row_and_soft_avoids(self):
        """An OPEN breaker on a node's object-plane address flows
        breaker -> health.check_once -> CRM suspect -> raylet snapshot
        masking, and clears when the breaker closes.  The CRM's own
        snapshot() never masks suspect rows (soft avoidance only)."""
        Config.reset({"rpc_breaker_failure_threshold": 2})
        c = Cluster()
        n1 = c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        n2 = c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        ray_tpu_torch.init(cluster=c)
        try:
            r1, r2 = c.crm.row_of(n1), c.crm.row_of(n2)
            fake = "203.0.113.7:12345"
            c.planes[r2] = fake
            for _ in range(2):
                breaker.record_failure(fake)
            assert breaker.is_open(fake)
            c.health.check_once()
            assert r2 in c.crm.suspect_rows()
            assert c.health.stats()["num_quarantined"] == 1
            assert c.crm.snapshot().node_mask[r2]       # never hard-masked
            eff = c.raylets[r1]._effective_snapshot()
            assert not eff.node_mask[r2]
            assert eff.node_mask[r1]
            assert c.raylets[r1]._suspect_softmask
            # recovery: probe succeeds, breaker closes, suspect clears
            # (poll: transient loop-lag suspicion — a ping answered
            # after the next round's probe — clears itself on a loaded
            # CI box, and must not be mistaken for quarantine)
            breaker.record_success(fake)
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                c.health.check_once()
                if not c.crm.suspect_rows():
                    break
                time.sleep(0.05)
            assert r2 not in c.crm.suspect_rows()
            assert c.raylets[r1]._effective_snapshot().node_mask[r2]
        finally:
            ray_tpu_torch.shutdown()
