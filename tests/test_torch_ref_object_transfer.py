"""Inter-node object plane: directory, pull-source cost model (device
parity), quota/priority activation, locality-aware scheduling, and the
shuffle workload of BASELINE config #4.

Scenario sources: upstream ``pull_manager_test.cc`` behavioral contract
(activation quota, get > wait > task-arg priority) and the
``shuffle_data_loader`` release workload (SURVEY.md §1 layer 6, §3.3, §4;
scenarios re-derived, not copied)."""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.common.config import Config
from ray_tpu_torch.common.ids import ObjectID
from ray_tpu_torch.ops import choose_sources_np, choose_sources_oracle
from ray_tpu_torch.runtime.object_directory import ObjectDirectory
from ray_tpu_torch.runtime.pull_manager import PullPriority

# Port copy of tests/test_object_transfer.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixture below resets the port's process-global state
#   (Config, chaos, breakers, the clock and transport seams) as
#   tests/conftest.py resets the reference's, and sets
#   RT_SCHEDULER_DEVICE=cpu: the port's device programs run on the GPU
#   unless asked for the CPU (subprocesses inherit the variable);
# - ``rng`` is defined here (the reference's comes from conftest.py);
# - direct calls of the pull program (``choose_sources_np``) pass
#   device="cpu".


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


# -- directory -------------------------------------------------------------

class TestDirectory:
    def test_locations(self):
        d = ObjectDirectory()
        a, b = _oid(), _oid()
        d.add_location(a, 0)
        d.add_location(a, 2)
        d.add_location(b, 1)
        assert d.locations(a) == (0, 2)
        assert d.has_location(a, 2) and not d.has_location(a, 1)
        assert d.is_tracked(b) and not d.is_tracked(_oid())

    def test_node_removal_reports_lost(self):
        d = ObjectDirectory()
        a, b = _oid(), _oid()
        d.add_location(a, 1)            # only copy on node 1
        d.add_location(b, 1)
        d.add_location(b, 2)            # replicated
        lost = d.on_node_removed(1)
        assert lost == [a]
        assert d.locations(b) == (2,)

    def test_location_matrix(self):
        d = ObjectDirectory()
        a, b = _oid(), _oid()
        d.add_location(a, 0)
        d.add_location(b, 3)
        m = d.location_matrix([a, b], 4)
        assert m.tolist() == [[True, False, False, False],
                              [False, False, False, True]]


# -- pull-source kernel parity ---------------------------------------------

class TestPullKernel:
    def test_device_matches_oracle_random(self, rng):
        for n, r in [(4, 3), (16, 50), (64, 200), (257, 1000)]:
            loc = rng.random((r, n)) < 0.3
            bw = rng.integers(1, 100_000, size=(n, n)).astype(np.int32)
            dest = rng.integers(0, n, size=r).astype(np.int32)
            sizes = rng.integers(1, 1 << 20, size=r).astype(np.int32)
            want_src, want_cost = choose_sources_oracle(loc, bw, dest, sizes)
            got_src, got_cost = choose_sources_np(loc, bw, dest, sizes,
                                                  device="cpu")
            np.testing.assert_array_equal(got_src, want_src)
            np.testing.assert_array_equal(got_cost, want_cost)

    def test_no_source_is_minus_one(self):
        loc = np.zeros((3, 4), dtype=bool)
        loc[1, 2] = True
        bw = np.full((4, 4), 100, dtype=np.int32)
        src, cost = choose_sources_oracle(
            loc, bw, np.zeros(3, np.int32), np.full(3, 1000, np.int32))
        assert src.tolist() == [-1, 2, -1]
        assert cost[1] == 10                        # 1000 KB // 100 MB/s

    def test_picks_highest_bandwidth_source(self):
        loc = np.array([[True, True, True, False]])
        bw = np.full((4, 4), 10, dtype=np.int32)
        bw[1, 3] = 500                              # node 1 -> dest 3 fast
        src, _ = choose_sources_oracle(
            loc, bw, np.array([3], np.int32), np.array([100], np.int32))
        assert src.tolist() == [1]

    def test_inflight_load_splits_concurrent_pulls(self):
        """Regression: per-link in-flight MB feeds the cost inputs.
        Two concurrent 64 MB pulls of a twice-replicated object must
        pick DIFFERENT sources — the first activation's bytes derate
        its replica below the runner-up."""
        n = 4
        loc = np.zeros((2, n), dtype=bool)
        loc[:, 1] = loc[:, 2] = True        # replicas on rows 1 and 2
        bw = np.ones((n, n), dtype=np.int32)
        bw[1, 3] = 10_000                   # row 1 is the clear favorite
        bw[2, 3] = 9_000
        dest = np.array([3, 3], np.int32)
        sizes = np.full(2, 64 * 1024, np.int32)     # 64 MB each
        src, _ = choose_sources_oracle(loc, bw, dest, sizes)
        assert src.tolist() == [1, 2]
        got, _ = choose_sources_np(loc, bw, dest, sizes, device="cpu")
        np.testing.assert_array_equal(got, src)

    def test_device_matches_oracle_with_inflight(self, rng):
        """Parity with a nonzero starting ledger (the pull manager's
        ``inflight_kb`` vector feeding both backends)."""
        for n, r in [(8, 6), (32, 40), (64, 128)]:
            loc = rng.random((r, n)) < 0.4
            bw = rng.integers(1, 100_000, size=(n, n)).astype(np.int32)
            dest = rng.integers(0, n, size=r).astype(np.int32)
            sizes = rng.integers(1, 1 << 17, size=r).astype(np.int32)
            infl = rng.integers(0, 1 << 18, size=n).astype(np.int32)
            want_src, want_cost = choose_sources_oracle(
                loc, bw, dest, sizes, infl)
            got_src, got_cost = choose_sources_np(
                loc, bw, dest, sizes, infl, device="cpu")
            np.testing.assert_array_equal(got_src, want_src)
            np.testing.assert_array_equal(got_cost, want_cost)


# -- pull manager ----------------------------------------------------------

@pytest.fixture
def cluster3():
    c = Cluster()
    for _ in range(3):
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
    ray_tpu_torch.init(cluster=c)
    yield c
    ray_tpu_torch.shutdown()
    c.stop()


def _seal_plasma_on(cluster, row: int, payload: bytes) -> ObjectID:
    """Seal a plasma-routed object and register it on ``row``."""
    from ray_tpu_torch.runtime.serialization import serialize
    oid = _oid()
    cluster.store.put_serialized(oid, serialize(payload))
    cluster.register_location(oid, row)
    return oid


class TestPullManager:
    def test_pull_registers_copy_and_accounts_bytes(self, cluster3):
        oid = _seal_plasma_on(cluster3, 1, b"p" * 200_000)
        done = threading.Event()
        cluster3.pull_manager.request_pull(
            oid, 200_000, 0, PullPriority.GET,
            callback=lambda ok: done.set())
        assert done.wait(5)
        assert cluster3.directory.has_location(oid, 0)
        assert cluster3.directory.has_location(oid, 1)   # source keeps copy
        s = cluster3.pull_manager.stats()
        assert s["num_pulls"] == 1 and s["bytes_pulled"] >= 200_000

    def test_local_request_is_immediate(self, cluster3):
        oid = _seal_plasma_on(cluster3, 0, b"p" * 200_000)
        hits = []
        assert cluster3.pull_manager.request_pull(
            oid, 200_000, 0, PullPriority.GET, callback=hits.append)
        assert hits == [True]
        assert cluster3.pull_manager.stats()["num_pulls"] == 0

    def test_quota_limits_inflight(self, cluster3):
        """With a simulated slow link and a quota of ~1 object, later
        pulls must queue until earlier ones complete."""
        Config.reset({"pull_manager_max_inflight_mb": 1,
                      "pull_transfer_sim_gbps": 0.02})  # 50ms per MB
        pm_cls = type(cluster3.pull_manager)
        pm = pm_cls(cluster3)       # fresh manager with the new config
        try:
            oids = [_seal_plasma_on(cluster3, 1, bytes([i]) * 900_000)
                    for i in range(4)]
            t0 = time.monotonic()
            done = threading.Semaphore(0)
            for oid in oids:
                pm.request_pull(oid, 900_000, 0, PullPriority.TASK_ARG,
                                callback=lambda ok: done.release())
            # quota 1MB + 0.9MB objects -> strictly serial transfers at
            # ~45ms each: all four need >= ~3 serialized transfers
            for _ in range(4):
                assert done.acquire(timeout=10)
            elapsed = time.monotonic() - t0
            assert elapsed >= 3 * 0.040, \
                f"transfers overlapped past quota: {elapsed:.3f}s"
            assert pm.stats()["num_pulls"] == 4
        finally:
            pm.shutdown()

    def test_get_priority_activates_before_task_arg(self, cluster3):
        """When the quota forces queueing, a later GET must activate
        before earlier TASK_ARG pulls."""
        Config.reset({"pull_manager_max_inflight_mb": 1,
                      "pull_transfer_sim_gbps": 0.05})
        pm = type(cluster3.pull_manager)(cluster3)
        try:
            order = []
            lock = threading.Lock()

            def mark(tag):
                def cb(ok):
                    with lock:
                        order.append(tag)
                return cb

            first = _seal_plasma_on(cluster3, 1, b"f" * 900_000)
            args = [_seal_plasma_on(cluster3, 1, bytes([i]) * 900_000)
                    for i in range(3)]
            geto = _seal_plasma_on(cluster3, 1, b"g" * 900_000)
            # first pull occupies the quota; the rest queue
            pm.request_pull(first, 900_000, 0, PullPriority.TASK_ARG,
                            callback=mark("first"))
            for i, oid in enumerate(args):
                pm.request_pull(oid, 900_000, 0, PullPriority.TASK_ARG,
                                callback=mark(f"arg{i}"))
            pm.request_pull(geto, 900_000, 0, PullPriority.GET,
                            callback=mark("get"))
            deadline = time.monotonic() + 20
            while len(order) < 5 and time.monotonic() < deadline:
                time.sleep(0.01)
            assert len(order) == 5, order
            assert order[0] == "first"
            assert order[1] == "get", f"GET did not jump the queue: {order}"
        finally:
            pm.shutdown()

    def test_lost_object_fails_waiters(self, cluster3):
        oid = _seal_plasma_on(cluster3, 1, b"x" * 150_000)
        Config.reset({"pull_transfer_sim_gbps": 0.001})   # slow: stays queued
        pm = type(cluster3.pull_manager)(cluster3)
        try:
            results = []
            pm.request_pull(oid, 150_000, 0, PullPriority.GET,
                            callback=results.append)
            # the real loss path (cluster.remove_node) drops directory
            # locations BEFORE notifying the pull manager — mirror it so
            # mid-transfer pulls also observe the loss
            cluster3.directory.drop([oid])
            pm.on_objects_lost([oid])
            deadline = time.monotonic() + 5
            while not results and time.monotonic() < deadline:
                time.sleep(0.01)
            assert results == [False]
            assert pm.stats()["num_failed"] == 1
        finally:
            pm.shutdown()


# -- end-to-end: locality + shuffle (BASELINE config #4) -------------------

def _row_of_pid(cluster, pid):
    for row, raylet in cluster.raylets.items():
        if pid in {h.proc.pid for h in raylet.pool._workers}:
            return row
    return None


class TestEndToEnd:
    def test_task_args_pull_to_executing_node(self, cluster3):
        """A large object born on node 2 consumed by a task pinned to
        node 1 must be pulled: directory gains the copy, stats move."""
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        rows = sorted(cluster3.raylets)
        n1, n2 = rows[1], rows[2]
        make = ray_tpu_torch.remote(lambda: b"m" * 300_000)
        src_ref = make.options(scheduling_strategy=(
            NodeAffinitySchedulingStrategy(
                cluster3.raylets[n2].node_id, soft=False))).remote()
        ray_tpu_torch.get(src_ref, timeout=30)    # pulls to driver too

        size_of = ray_tpu_torch.remote(lambda x: len(x))
        out = size_of.options(scheduling_strategy=(
            NodeAffinitySchedulingStrategy(
                cluster3.raylets[n1].node_id, soft=False))).remote(src_ref)
        assert ray_tpu_torch.get(out, timeout=30) == 300_000
        assert cluster3.directory.has_location(src_ref.id, n1)
        assert cluster3.pull_manager.stats()["num_pulls"] >= 1

    def test_locality_aware_placement(self, cluster3):
        """A default-strategy task whose big arg lives on one node should
        run THERE (locality-aware lease targeting), not wherever traversal
        order says."""
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        rows = sorted(cluster3.raylets)
        target = rows[2]                     # deliberately NOT the head
        make = ray_tpu_torch.remote(lambda: b"L" * 400_000)
        big = make.options(scheduling_strategy=(
            NodeAffinitySchedulingStrategy(
                cluster3.raylets[target].node_id, soft=False))).remote()
        ray_tpu_torch.wait([big], num_returns=1, timeout=30)

        whoami = ray_tpu_torch.remote(lambda x: __import__("os").getpid())
        pulls_before = cluster3.pull_manager.stats()["num_pulls"]
        pid = ray_tpu_torch.get(whoami.remote(big), timeout=30)
        assert _row_of_pid(cluster3, pid) == target, \
            "task did not follow its plasma arg's locality"
        # no new task-arg pull was needed: the task went to the bytes
        assert cluster3.pull_manager.stats()["num_pulls"] == pulls_before

    def test_shuffle_workload(self, cluster3):
        """Map partitions born across nodes, reducers consume all of them
        (all-to-all): exact results + real pull traffic + every reducer
        node ends holding every partition it consumed."""
        import hashlib
        n_parts = 6

        @ray_tpu_torch.remote
        def produce(i):
            return bytes([i]) * 200_000

        @ray_tpu_torch.remote
        def reduce_all(*parts):
            h = hashlib.sha256()
            for p in parts:
                h.update(p)
            return h.hexdigest()

        # SPREAD pins partitions across nodes deterministically — this
        # test exercises the pull plane, not placement timing (fast tasks
        # draining one-by-one can legally all pack onto the head)
        parts = [produce.options(num_cpus=1,
                                 scheduling_strategy="SPREAD").remote(i)
                 for i in range(n_parts)]
        ray_tpu_torch.wait(parts, num_returns=n_parts, timeout=60)
        rows_with_copies = {r for p in parts
                            for r in cluster3.directory.locations(p.id)}
        assert len(rows_with_copies) >= 2, \
            "map partitions all landed on one node — no shuffle to test"

        outs = [reduce_all.remote(*parts) for _ in range(3)]
        digests = ray_tpu_torch.get(outs, timeout=60)
        want = hashlib.sha256(
            b"".join(bytes([i]) * 200_000 for i in range(n_parts))
        ).hexdigest()
        assert digests == [want] * 3
        s = cluster3.pull_manager.stats()
        assert s["num_pulls"] >= 1 and s["bytes_pulled"] > 0

    def test_lost_object_raises_on_get(self, cluster3):
        """Kill the only node holding a plasma object: with retries
        exhausted (max_retries=0) lineage cannot reconstruct, so get must
        raise ObjectLostError (reconstruction itself is covered in
        test_refcounting.py)."""
        from ray_tpu_torch.runtime.object_store import ObjectLostError
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        rows = sorted(cluster3.raylets)
        victim = rows[2]
        make = ray_tpu_torch.remote(lambda: b"v" * 250_000)
        ref = make.options(max_retries=0, scheduling_strategy=(
            NodeAffinitySchedulingStrategy(
                cluster3.raylets[victim].node_id, soft=False))).remote()
        ray_tpu_torch.wait([ref], num_returns=1, timeout=30)
        assert cluster3.directory.locations(ref.id) == (victim,)
        cluster3.remove_node(cluster3.raylets[victim].node_id)
        with pytest.raises(ObjectLostError):
            ray_tpu_torch.get(ref, timeout=10)


# -- raw-channel striped transfers (plane-level, no full cluster) ----------

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


class TestStripedPlane:
    def _payload(self, n):
        import hashlib
        out = bytearray()
        i = 0
        while len(out) < n:
            out += hashlib.sha256(str(i).encode()).digest()
            i += 1
        return bytes(out[:n])

    def test_striped_assembly_matches_serial_pull(self, endpoints):
        """Byte-for-byte parity: a 2-source striped pull assembles the
        exact bytes a single-source serial (window=1) pull does."""
        Config.reset({"object_transfer_chunk_mb": 1,
                      "object_transfer_stripe_min_mb": 2,
                      "object_transfer_window": 4})
        payload = self._payload(6 << 20)
        src1, src2 = endpoints("src1"), endpoints("src2")
        oid = _oid()
        size = src1.seal(oid, payload)
        assert src2.seal(oid, payload) == size

        striped = endpoints("dest_striped")
        assert striped.plane.pull_into_local(
            oid, size, src1.address, (src2.address,))

        Config.reset({"object_transfer_chunk_mb": 1,
                      "object_transfer_stripe_min_mb": 2,
                      "object_transfer_window": 1})
        serial = endpoints("dest_serial")
        assert serial.plane.pull_into_local(oid, size, src1.address)

        a = striped.store.read_range(oid, 0, size)
        b = serial.store.read_range(oid, 0, size)
        assert a == b and len(a) == size
        assert striped.store.peek(oid) == payload
        # the stripes really came from BOTH sources, over the raw channel
        assert src1.plane.bytes_sent_raw > 0
        assert src2.plane.bytes_sent_raw > 0
        assert striped.plane.bytes_received_raw >= size
        s = striped.plane.stats()
        assert s["plane_last_transfer_mbps"] > 0
        assert s["plane_window_occupancy"] == 0

    def test_pickled_fallback_parity(self, endpoints):
        """object_transfer_raw_channel=False restores the pickled
        op_read channel — same bytes, different framing."""
        Config.reset({"object_transfer_chunk_mb": 1,
                      "object_transfer_raw_channel": False})
        payload = self._payload(3 << 20)
        src = endpoints("src")
        oid = _oid()
        size = src.seal(oid, payload)
        dest = endpoints("dest")
        assert dest.plane.pull_into_local(oid, size, src.address)
        assert dest.store.peek(oid) == payload
        assert dest.plane.bytes_received_pickled >= size
        assert dest.plane.bytes_received_raw == 0
        assert src.plane.bytes_sent_pickled >= size

    def test_window_respects_inflight_quota(self, endpoints):
        """The pipelining window is capped by the pull manager's
        in-flight byte quota: quota/chunk outstanding requests, never
        the configured window when that is larger."""
        Config.reset({"object_transfer_chunk_mb": 1,
                      "object_transfer_window": 32,
                      "pull_manager_max_inflight_mb": 2,
                      "object_transfer_stripe_min_mb": 1024})
        payload = self._payload(10 << 20)
        src = endpoints("src")
        oid = _oid()
        size = src.seal(oid, payload)
        dest = endpoints("dest")
        assert dest.plane.pull_into_local(oid, size, src.address)
        assert dest.store.peek(oid) == payload
        assert 1 <= dest.plane.window_peak <= 2, \
            dest.plane.window_peak

    def test_small_object_single_round_trip(self, endpoints):
        """The stat piggybacks on chunk 0: a sub-chunk object moves in
        ONE data-plane request (no separate op_stat round-trip)."""
        Config.reset({"object_transfer_chunk_mb": 4})
        payload = self._payload(300_000)
        src = endpoints("src")
        oid = _oid()
        size = src.seal(oid, payload)
        dest = endpoints("dest")
        assert dest.plane.pull_into_local(oid, size, src.address)
        assert dest.store.peek(oid) == payload
        assert src.server.method_calls.get("op_fetch") == 1
        assert "op_stat" not in src.server.method_calls

    def test_dead_primary_fails_over_before_first_chunk(self, endpoints):
        """A dead primary address must not sink the pull when another
        replica is live."""
        Config.reset({"object_transfer_chunk_mb": 1})
        payload = self._payload(2 << 20)
        src = endpoints("src")
        oid = _oid()
        size = src.seal(oid, payload)
        ghost = endpoints("ghost")
        ghost_addr = ghost.address
        ghost.stop()                    # dead before the transfer starts
        dest = endpoints("dest")
        assert dest.plane.pull_into_local(oid, size, ghost_addr,
                                          (src.address,))
        assert dest.store.peek(oid) == payload


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


@pytest.mark.chaos
class TestStripeSourceDeath:
    def test_sigkill_source_mid_stripe_converges(self, endpoints,
                                                 tmp_path):
        """SIGKILL one of two stripe sources mid-transfer: its
        unfinished stripes reassign to the survivor and the pull
        completes with zero failed transfers."""
        import signal
        import subprocess
        import sys
        import threading as _threading

        Config.reset({"object_transfer_chunk_mb": 1,
                      "object_transfer_stripe_min_mb": 2,
                      "object_transfer_window": 2})
        n = 24 << 20
        payload = b"\xa5" * n
        oid = _oid()

        child = subprocess.Popen(
            [sys.executable, "-c", _CHAOS_CHILD, str(tmp_path),
             oid.hex(), str(n)],
            stdout=subprocess.PIPE, text=True,
            env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
        try:
            child_addr = child.stdout.readline().strip()
            assert ":" in child_addr, "child did not come up"

            survivor = endpoints("survivor", arena_mb=96)
            size = survivor.seal(oid, payload)
            dest = endpoints("dest", arena_mb=96)

            result = []
            t = _threading.Thread(
                target=lambda: result.append(
                    dest.plane.pull_into_local(
                        oid, size, child_addr, (survivor.address,))),
                daemon=True)
            t.start()
            # kill the child once the window is provably occupied
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and not result:
                if dest.plane.window_occupancy > 0 or \
                        dest.plane.bytes_received:
                    break
                time.sleep(0.002)
            child.send_signal(signal.SIGKILL)
            t.join(90)
            assert result == [True], "striped pull did not converge"
            assert dest.plane.transfers_failed == 0
            # zero failed gets: the bytes are exact
            assert dest.store.peek(oid) == payload
        finally:
            if child.poll() is None:
                child.kill()
            child.wait(10)


@pytest.mark.chaos
class TestPartitionedSource:
    def test_partitioned_source_fenced_and_pull_fails_over(
            self, endpoints):
        """Directed partition dest -> src1: probes trip src1's circuit
        breaker, so the striped pull fails FAST over to the clean
        replica (the plane's breaker=True peer clients never eat the
        60s chunk timeout) and the partitioned source is noted in the
        blacklist ledger.  Healing + closing the breaker restores it."""
        from ray_tpu_torch.rpc import RpcClient, breaker, chaos
        Config.reset({"object_transfer_chunk_mb": 1,
                      "object_transfer_stripe_min_mb": 2,
                      "rpc_breaker_failure_threshold": 2,
                      "rpc_breaker_reset_s": 60.0})
        payload = b"\x5a" * (4 << 20)
        src1, src2 = endpoints("src1"), endpoints("src2")
        oid = _oid()
        size = src1.seal(oid, payload)
        assert src2.seal(oid, payload) == size

        chaos.add_partition("*", src1.address)
        # gray link: probes to src1 time out and open its breaker
        probe = RpcClient(src1.address, timeout=1.0)
        try:
            for _ in range(2):
                with pytest.raises(TimeoutError):
                    probe.call("op_stat", oid.binary(), timeout=0.2)
        finally:
            probe.close()
        assert breaker.is_open(src1.address)

        dest = endpoints("dest")
        t0 = time.monotonic()
        assert dest.plane.pull_into_local(
            oid, size, src1.address, (src2.address,))
        assert time.monotonic() - t0 < 10, "failover was not fast"
        assert dest.store.peek(oid) == payload
        # src1 was fenced: not one chunk request crossed the partition
        assert src1.server.method_calls.get("op_fetch") is None
        assert src1.address in dest.plane._src_fail
        assert dest.plane.transfers_failed == 0

        # heal + close the breaker: src1 serves again
        chaos.heal()
        breaker.record_success(src1.address)
        dest2 = endpoints("dest2")
        assert dest2.plane.pull_into_local(oid, size, src1.address)
        assert dest2.store.peek(oid) == payload
        assert src1.server.method_calls.get("op_fetch", 0) >= 1
