"""Broadcast plane: topology-aware 1->N distribution with
relay-as-you-receive.

Covers every layer of the subsystem:

1. fan-out plan kernel — device/oracle bit-parity under randomized
   bandwidth matrices, inflight-load steering, logarithmic depth;
2. plan shapes — balanced trees, ancestor fallback chains;
3. the socket relay protocol — bit-exact replicas, live chunk relaying,
   pull-manager tree grafting (``BroadcastManager.join``);
4. chaos — SIGKILL of a mid-tree relay and of the root mid-broadcast
   (re-parenting converges, no lost chunks);
5. the simulator — deterministic 1k-node waves (bit-identical replay
   hashes) and the ``broadcast_storm`` campaign archetype.
"""

import threading
import time

import numpy as np
import pytest

from ray_tpu_torch.broadcast.plan import balanced_plan, build_plan
from ray_tpu_torch.common.config import Config
from ray_tpu_torch.common.ids import ObjectID
from ray_tpu_torch.ops.broadcast_kernel import (plan_fanout_np,
                                                plan_fanout_oracle)

# Port copy of tests/test_broadcast.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixture below resets the port's process-global state
#   (Config, chaos, breakers, the clock and transport seams) as
#   tests/conftest.py resets the reference's, and sets
#   RT_SCHEDULER_DEVICE=cpu: the port's device programs run on the GPU
#   unless asked for the CPU (subprocesses inherit the variable);
# - ``rng`` is defined here (the reference's comes from conftest.py);
# - direct calls of the fan-out program (``plan_fanout_np``,
#   ``build_plan``) pass device="cpu".


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


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _oid():
    return ObjectID.from_random()


def _payload(n: int) -> bytes:
    import hashlib
    out = bytearray()
    i = 0
    while len(out) < n:
        out += hashlib.sha256(str(i).encode()).digest()
        i += 1
    return bytes(out[:n])


# -- fan-out kernel parity ---------------------------------------------------

class TestFanoutKernel:
    def test_device_matches_oracle_random(self, rng):
        """Bit-parity across node counts, member masks, bandwidth
        matrices (zeros included), inflight loads and fan-outs."""
        for trial in range(30):
            n = int(rng.integers(2, 41))
            member = rng.random(n) < 0.7
            bw = rng.integers(0, 100_000, size=(n, n)).astype(np.int32)
            np.fill_diagonal(bw, 0)
            root = int(rng.integers(0, n))
            member[root] = True
            fanout = int(rng.integers(1, 5))
            infl = rng.integers(0, 200_000, size=n).astype(np.int32)
            want_p, want_o = plan_fanout_oracle(member, bw, root, fanout,
                                                infl)
            got_p, got_o = plan_fanout_np(member, bw, root, fanout, infl,
                                          device="cpu")
            np.testing.assert_array_equal(got_p, want_p, err_msg=f"{trial}")
            np.testing.assert_array_equal(got_o, want_o, err_msg=f"{trial}")

    def test_uniform_bandwidth_depth_logarithmic(self):
        """The depth derating keeps a uniform matrix from degenerating
        to an N-deep chain: 63 members at fanout 2 must come out
        tree-shaped (depth well under N, every member attached)."""
        n = 64
        member = np.ones(n, dtype=bool)
        bw = np.full((n, n), 1000, dtype=np.int32)
        np.fill_diagonal(bw, 0)
        parent, order = plan_fanout_oracle(member, bw, 0, 2)
        assert all(parent[c] >= 0 for c in range(1, n))
        depth = {0: 0}
        for c in sorted(range(1, n), key=lambda c: order[c]):
            depth[c] = depth[int(parent[c])] + 1
        assert max(depth.values()) <= 14    # ~2*log2(64), not 63

    def test_unreachable_member_stays_unattached(self):
        member = np.ones(4, dtype=bool)
        bw = np.full((4, 4), 100, dtype=np.int32)
        bw[:, 3] = 0                        # nobody can reach node 3
        parent, order = plan_fanout_oracle(member, bw, 0, 2)
        assert parent[3] == -1 and order[3] == -1
        assert parent[1] >= 0 and parent[2] >= 0

    def test_inflight_load_steers_parent_choice(self):
        """Satellite regression: uplink in-flight KB feeds the score.
        With an idle root the second member ties onto the root; with
        64 MB already in flight the once-attached child wins instead."""
        member = np.ones(4, dtype=bool)
        bw = np.full((4, 4), 1000, dtype=np.int32)
        np.fill_diagonal(bw, 0)
        p0, _ = plan_fanout_oracle(member, bw, 0, 3)
        assert p0[2] == 0
        infl = np.array([64 * 1024, 0, 0, 0], dtype=np.int32)
        p1, _ = plan_fanout_oracle(member, bw, 0, 3, infl)
        assert p1[2] == 1
        # the device kernel sees the same shift
        dp1, _ = plan_fanout_np(member, bw, 0, 3, infl, device="cpu")
        np.testing.assert_array_equal(dp1, p1)


# -- plan shapes -------------------------------------------------------------

class TestBroadcastPlan:
    def test_balanced_plan_shape_and_fallbacks(self):
        members = [f"m{i}" for i in range(14)]
        plan = balanced_plan(members, "root", fanout=2)
        assert plan.parent["m0"] == "root" and plan.parent["m1"] == "root"
        assert plan.parent["m2"] == "m0" and plan.parent["m3"] == "m0"
        assert plan.parent["m6"] == "m2"
        # ancestor chain ends at the root, no cycles
        fb = plan.fallbacks("m13")
        assert fb[-1] == "root" and len(fb) == len(set(fb))
        assert plan.depth() <= 5            # log2(14) + slack
        assert plan.relay_fanout() > 1.0

    def test_build_plan_backend_switch_is_invisible(self):
        """Device-batched and oracle paths emit the same plan (the
        ``broadcast_device_batch_min`` knob only moves the cutover)."""
        n = 16
        bw = np.full((n, n), 500, dtype=np.int32)
        np.fill_diagonal(bw, 0)
        members = list(range(1, n))
        Config.reset({"broadcast_device_batch_min": 1})
        dev = build_plan(members, bw, 0, fanout=2, device="cpu")
        Config.reset({"broadcast_device_batch_min": 10_000})
        orc = build_plan(members, bw, 0, fanout=2, device="cpu")
        assert dev.parent == orc.parent and dev.order == orc.order


# -- socket relay protocol ---------------------------------------------------

class _Endpoint:
    """One standalone plane endpoint: own arena + store + RPC server."""

    def __init__(self, tmp, name, arena_mb=64):
        import os
        from ray_tpu_torch.native import Arena
        from ray_tpu_torch.rpc import RpcServer
        from ray_tpu_torch.runtime.object_plane import ObjectPlane
        from ray_tpu_torch.runtime.object_store import MemoryStore
        self.arena = Arena(os.path.join(tmp, f"arena_{name}"),
                           arena_mb << 20, create=True)
        self.store = MemoryStore(
            arena=self.arena, spill_dir=os.path.join(tmp, f"sp_{name}"))
        self.plane = ObjectPlane(self.store)
        self.server = RpcServer({}).start()
        self.plane.attach(self.server)

    @property
    def address(self):
        return self.server.address

    def seal(self, oid, payload: bytes) -> int:
        from ray_tpu_torch.runtime.serialization import serialize
        self.store.put_serialized(oid, serialize(payload))
        kind, size = self.store.plasma_info(oid)
        assert kind == "shm", kind
        return size

    def stop(self):
        self.plane.shutdown()
        self.server.stop()


@pytest.fixture
def endpoints(tmp_path):
    made = []

    def make(name, arena_mb=64):
        ep = _Endpoint(str(tmp_path), name, arena_mb)
        made.append(ep)
        return ep

    try:
        yield make
    finally:
        for ep in made:
            ep.stop()


class TestRelayBroadcast:
    def test_broadcast_replicates_bit_exact(self, endpoints):
        """1->4 over the plane primitive: every member ends with the
        exact sealed bytes, reached in one call."""
        Config.reset({"broadcast_chunk_mb": 1, "broadcast_window": 4})
        payload = _payload(6 << 20)
        root = endpoints("root", arena_mb=96)
        members = [endpoints(f"m{i}", arena_mb=96) for i in range(4)]
        oid = _oid()
        size = root.seal(oid, payload)
        res = root.plane.broadcast(oid, [m.address for m in members],
                                   fanout=2)
        assert res["ok"], res
        assert sorted(res["reached"]) == sorted(m.address
                                                for m in members)
        for m in members:
            assert m.store.peek(oid) == payload
        # the wire really carried bc_* traffic, tracked in stats
        nchunks = -(-size // (1 << 20))
        total = sum(m.plane.bcast.chunks_pulled for m in members)
        assert total == 4 * nchunks
        assert all(m.plane.bcast.stats()["bcast_sessions_completed"] == 1
                   for m in members)

    def test_relay_serves_chunks_before_commit(self, endpoints):
        """Relay-as-you-receive: with the root's uplink paced, a chain
        member serves chunks to its child straight out of its LIVE
        ingest session (the ``chunks_relayed`` counter), not only after
        sealing."""
        Config.reset({"broadcast_chunk_mb": 1, "broadcast_window": 2,
                      "plane_uplink_mbps": 300})
        payload = _payload(8 << 20)
        root = endpoints("root", arena_mb=96)
        a = endpoints("a", arena_mb=96)
        b = endpoints("b", arena_mb=96)
        oid = _oid()
        root.seal(oid, payload)
        res = root.plane.broadcast(oid, [a.address, b.address], fanout=1)
        assert res["ok"], res
        assert a.store.peek(oid) == payload
        assert b.store.peek(oid) == payload
        # b is chained under a; at least part of b's chunks must have
        # been served from a's live session
        assert a.plane.bcast.chunks_relayed + \
            a.plane.bcast.chunks_sealed_served >= 8
        assert a.plane.bcast.chunks_relayed > 0

    def test_member_already_holding_short_circuits(self, endpoints):
        Config.reset({"broadcast_chunk_mb": 1})
        payload = _payload(2 << 20)
        root = endpoints("root")
        m1 = endpoints("m1")
        m2 = endpoints("m2")
        oid = _oid()
        root.seal(oid, payload)
        m1.seal(oid, payload)               # already replicated
        res = root.plane.broadcast(oid, [m1.address, m2.address])
        assert res["ok"], res
        assert m2.store.peek(oid) == payload
        # m1 never opened a session (bc_begin answered "already")
        assert m1.plane.bcast.stats()["bcast_sessions_started"] == 0


# -- cluster coordinator + pull-manager grafting -----------------------------

@pytest.fixture
def mgr_cluster(endpoints):
    """A driver-process Cluster whose three rows serve standalone
    endpoint planes (the NodeAgent shape without worker processes)."""
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.rpc import RpcServer
    c = Cluster()
    server = RpcServer({}).start()
    c.plane.attach(server)
    eps = []
    for i in range(3):
        ep = endpoints(f"node{i}", arena_mb=96)
        c.add_node(resources={"CPU": 1}, num_workers=0,
                   plane_address=ep.address)
        eps.append(ep)
    try:
        yield c, eps
    finally:
        c.stop()
        server.stop()


class TestBroadcastManager:
    def test_tree_broadcast_reaches_every_row(self, mgr_cluster):
        Config.reset({"broadcast_chunk_mb": 1})
        c, eps = mgr_cluster
        payload = _payload(3 << 20)
        oid = _oid()
        eps[0].seal(oid, payload)
        c.directory.add_location(oid, 0)
        res = c.broadcasts.broadcast(oid, node_rows=[1, 2])
        assert res["ok"], res
        assert res["members"] == 2 and res["reached"] == 2
        assert res["fallbacks"] == 0
        for row, ep in ((1, eps[1]), (2, eps[2])):
            assert c.directory.has_location(oid, row)
            assert ep.store.peek(oid) == payload
        s = c.broadcasts.stats()
        assert s["bcast_trees_completed"] == 1
        assert s["bcast_members_reached"] == 2
        assert s["bcast_time_to_all_ewma_s"] > 0

    def test_concurrent_pull_joins_active_tree(self, mgr_cluster):
        """Satellite: a pull arriving while a tree is active grafts on
        as a leaf — bytes flow over ``bc_fetch``, never ``op_fetch``,
        and the pull completes like any other."""
        from ray_tpu_torch.broadcast.manager import _ActiveTree
        from ray_tpu_torch.runtime.pull_manager import PullPriority
        Config.reset({"broadcast_chunk_mb": 1})
        c, eps = mgr_cluster
        payload = _payload(2 << 20)
        oid = _oid()
        size = eps[0].seal(oid, payload)
        c.directory.add_location(oid, 0)
        plan = balanced_plan([1, 2], 0, 2)
        tree = _ActiveTree("graft0", oid, size, 1 << 20,
                           eps[0].address, plan)
        c.broadcasts._active[oid.binary()] = tree
        try:
            done = threading.Event()
            oks = []
            c.pull_manager.request_pull(
                oid, size, 1, PullPriority.GET,
                callback=lambda ok: (oks.append(ok), done.set()))
            assert done.wait(30)
        finally:
            c.broadcasts._active.pop(oid.binary(), None)
        assert oks == [True]
        assert eps[1].store.peek(oid) == payload
        assert c.directory.has_location(oid, 1)
        assert tree.joins == 1
        assert c.broadcasts.stats()["bcast_joins"] == 0  # tallied at end
        assert eps[0].server.method_calls.get("bc_fetch", 0) > 0
        assert "op_fetch" not in eps[0].server.method_calls

    def test_pull_without_active_tree_uses_plain_path(self, mgr_cluster):
        from ray_tpu_torch.runtime.pull_manager import PullPriority
        c, eps = mgr_cluster
        payload = _payload(1 << 20)
        oid = _oid()
        size = eps[0].seal(oid, payload)
        c.directory.add_location(oid, 0)
        done = threading.Event()
        c.pull_manager.request_pull(oid, size, 2, PullPriority.GET,
                                    callback=lambda ok: done.set())
        assert done.wait(30)
        assert eps[2].store.peek(oid) == payload
        assert "bc_fetch" not in eps[0].server.method_calls
        # the inflight ledger drained with the transfer
        assert c.pull_manager.stats()["inflight_sources"] == 0
        assert not c.pull_manager.inflight_kb(
            c.bandwidth_mbps.shape[0]).any()


# -- chaos: relay/root death mid-broadcast -----------------------------------

_CHAOS_CHILD = r"""
import os, sys, time
from ray_tpu_torch.common.config import Config
Config.reset({"object_store_memory_mb": 64})
from ray_tpu_torch.common.ids import ObjectID
from ray_tpu_torch.native import Arena
from ray_tpu_torch.rpc import RpcServer
from ray_tpu_torch.runtime.object_plane import ObjectPlane
from ray_tpu_torch.runtime.object_store import MemoryStore
from ray_tpu_torch.runtime.serialization import serialize

tmp, oid_hex, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
arena = Arena(os.path.join(tmp, "child_arena"), 64 << 20, create=True)
store = MemoryStore(arena=arena, spill_dir=os.path.join(tmp, "child_sp"))
store.put_serialized(ObjectID.from_hex(oid_hex),
                     serialize(b"\xa5" * n))
plane = ObjectPlane(store)
server = RpcServer({}).start()
plane.attach(server)
print(server.address, flush=True)
time.sleep(600)
"""


def _spawn_holder(tmp_path, oid, n):
    import subprocess
    import sys
    child = subprocess.Popen(
        [sys.executable, "-c", _CHAOS_CHILD, str(tmp_path),
         oid.hex(), str(n)],
        stdout=subprocess.PIPE, text=True,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    addr = child.stdout.readline().strip()
    assert ":" in addr, "chaos child did not come up"
    return child, addr


@pytest.mark.chaos
class TestBroadcastRelayDeath:
    def test_sigkill_parent_mid_relay_reparents_to_root(
            self, endpoints, tmp_path):
        """SIGKILL the parent a member is actively ingesting from: the
        member advances to the next fallback (here the root), re-queues
        its missing chunks and seals the exact bytes."""
        import signal
        Config.reset({"broadcast_chunk_mb": 1, "broadcast_window": 2,
                      "broadcast_fetch_timeout_s": 10.0})
        n = 24 << 20
        payload = b"\xa5" * n
        oid = _oid()
        child, child_addr = _spawn_holder(tmp_path, oid, n)
        try:
            root = endpoints("root", arena_mb=96)
            size = root.seal(oid, payload)
            dest = endpoints("dest", arena_mb=96)
            # dest's ingest session: parent = the doomed child process,
            # fallback chain ends at the live root
            result = []
            t = threading.Thread(
                target=lambda: result.append(dest.plane.bcast._bc_begin(
                    "bk-relay", oid.binary(), size,
                    (child_addr, root.address), 1 << 20)),
                daemon=True)
            t.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not result:
                if dest.plane.bcast.chunks_pulled >= 2:
                    break
                time.sleep(0.002)
            child.send_signal(signal.SIGKILL)
            t.join(90)
            assert result and result[0]["ok"], result
            assert result[0]["reparents"] >= 1
            assert dest.store.peek(oid) == payload
        finally:
            if child.poll() is None:
                child.kill()
            child.wait(10)

    def test_sigkill_root_mid_broadcast_reparents_to_member(
            self, endpoints, tmp_path):
        """SIGKILL the ROOT while a second member is mid-ingest: the
        orphan re-parents to a member that already sealed its replica
        (the coordinator's graft-parent order) — no chunk is lost."""
        import signal
        Config.reset({"broadcast_chunk_mb": 1, "broadcast_window": 2,
                      "broadcast_fetch_timeout_s": 10.0})
        n = 24 << 20
        payload = b"\xa5" * n
        oid = _oid()
        root_proc, root_addr = _spawn_holder(tmp_path, oid, n)
        try:
            from ray_tpu_torch.runtime.serialization import serialize
            size = len(serialize(payload))      # the sealed extent
            a = endpoints("a", arena_mb=96)
            b = endpoints("b", arena_mb=96)
            # member A seals its replica straight from the root
            res_a = a.plane.bcast._bc_begin("bk-root", oid.binary(),
                                            size, (root_addr,), 1 << 20)
            assert res_a["ok"], res_a
            assert a.store.peek(oid) == payload
            # member B starts against the root, A as fallback
            result = []
            t = threading.Thread(
                target=lambda: result.append(b.plane.bcast._bc_begin(
                    "bk-root", oid.binary(), size,
                    (root_addr, a.address), 1 << 20)),
                daemon=True)
            t.start()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not result:
                if b.plane.bcast.chunks_pulled >= 2:
                    break
                time.sleep(0.002)
            root_proc.send_signal(signal.SIGKILL)
            t.join(90)
            assert result and result[0]["ok"], result
            assert result[0]["reparents"] >= 1
            assert b.store.peek(oid) == payload
            # the re-homed chunks really came off A's plane
            assert a.server.method_calls.get("bc_fetch", 0) > 0
        finally:
            if root_proc.poll() is None:
                root_proc.kill()
            root_proc.wait(10)


# -- simulator ---------------------------------------------------------------

class TestSimBroadcast:
    def _wave(self, num_nodes, seed, **kw):
        from ray_tpu_torch.sim.broadcast import SimBroadcastWave
        from ray_tpu_torch.sim.cluster import SimCluster
        kills = kw.pop("kills", ())
        with SimCluster(num_nodes, seed=seed) as c:
            members = [f"n{i:05d}" for i in range(num_nodes)]
            w = SimBroadcastWave(c, "w0", members, **kw)
            w.start()
            for t, nid in kills:
                c.clock.call_later(t, lambda nid=nid: (
                    c.kill_node(nid), w.on_node_killed(nid)))
            c.clock.run_until(300.0)
            return w, c.trace.hash()

    def test_1k_node_wave_replays_bit_for_bit(self):
        """Acceptance: a 1 GB broadcast to 1000 simulated relay nodes
        completes with log-depth pipelining and two runs produce
        bit-identical trace hashes."""
        kw = dict(size_mb=1024, chunk_mb=8, fanout=2,
                  uplink_mbps=1000.0)
        w1, h1 = self._wave(1000, 3, **kw)
        w2, h2 = self._wave(1000, 3, **kw)
        assert h1 == h2
        assert w1.time_to_all == w2.time_to_all
        assert len(w1.completed) == 1000 and not w1.unreachable
        assert all(w1.have[m] == w1.nchunks for m in w1.completed)
        # naive root-serial would take members * size / uplink ~ 1024 s
        naive = 1000 * 1024 / 1000.0
        assert w1.time_to_all < naive / 50

    def test_sim_mid_tree_kills_reparent_and_converge(self):
        """Killing early relays orphans whole subtrees: every LIVE
        member still seals all chunks via ancestor re-parenting."""
        w, _h = self._wave(64, 11, size_mb=256, chunk_mb=8, fanout=2,
                           kills=((0.3, "n00000"), (0.6, "n00001")))
        assert w.terminal
        assert w.reparents >= 1
        assert not w.unreached_live()
        assert all(w.have[m] == w.nchunks for m in w.completed)
        assert len(w.completed) == 62

    def test_broadcast_storm_campaign_green_and_deterministic(self):
        from ray_tpu_torch.sim import run_campaign
        kw = dict(seed=7, campaign="broadcast_storm", faults=12,
                  duration=200.0)
        r1 = run_campaign(32, **kw)
        r2 = run_campaign(32, **kw)
        assert r1.ok, r1.violations
        assert r1.trace_hash == r2.trace_hash
        assert r1.faults_injected >= 12
