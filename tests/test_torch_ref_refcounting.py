"""Reference counting, lineage retention, and object reconstruction.

Scenario sources: upstream ``reference_count_test.cc`` /
``object_recovery_manager_test.cc`` behavioral contract — out-of-scope
deletion, lineage release when all returns die, reconstruction of lost
objects from retained specs, put objects unrecoverable (SURVEY.md §1
layer 7, §5.3; scenarios re-derived, not copied)."""

import gc
import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.api import _get_runtime
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.common.config import Config
from ray_tpu_torch.runtime.object_store import ObjectLostError
from ray_tpu_torch.util.placement_group import (placement_group,
                                                remove_placement_group)
from ray_tpu_torch.util.scheduling_strategies import \
    NodeAffinitySchedulingStrategy

# Port copy of tests/test_refcounting.py: the reference's file with
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


def _flush(cluster, rounds=3):
    """Deterministic fold of pending ref events (plus GC)."""
    for _ in range(rounds):
        gc.collect()
        cluster.ref_counter.flush()


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


@pytest.fixture
def driver():
    ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2)
    rt = _get_runtime()
    yield rt
    ray_tpu_torch.shutdown()


class TestRefCounting:
    def test_put_out_of_scope_reclaims(self, driver):
        c = driver.cluster
        before = c.store.size()
        ref = ray_tpu_torch.put({"k": list(range(100))})
        oid = ref.id
        assert c.store.contains(oid)
        assert c.ref_counter.count_of(oid) >= 0   # events may be queued
        del ref
        _flush(c)
        assert not c.store.contains(oid)
        assert c.store.size() <= before

    def test_live_ref_is_not_reclaimed(self, driver):
        c = driver.cluster
        ref = ray_tpu_torch.put("keep me")
        _flush(c)
        assert c.store.contains(ref.id)
        assert ray_tpu_torch.get(ref) == "keep me"

    def test_task_return_out_of_scope_after_seal(self, driver):
        c = driver.cluster

        @ray_tpu_torch.remote
        def f():
            return 41

        ref = f.remote()
        assert ray_tpu_torch.get(ref, timeout=30) == 41
        oid = ref.id
        del ref
        _flush(c)
        assert not c.store.contains(oid)

    def test_return_dropped_before_seal_reclaims_on_seal(self, driver):
        c = driver.cluster

        @ray_tpu_torch.remote
        def slow():
            time.sleep(0.3)
            return "x"

        ref = slow.remote()
        oid = ref.id
        del ref
        _flush(c)                     # folds the decref; object unsealed
        assert _wait_until(lambda: c.store.contains(oid) or True)
        # once the task seals, the deferred reclaim fires
        assert _wait_until(
            lambda: (_flush(c) or not c.store.contains(oid)), timeout=15)

    def test_sustained_workload_steady_store(self, driver):
        c = driver.cluster

        @ray_tpu_torch.remote
        def step(i):
            return i * 3

        for i in range(40):
            assert ray_tpu_torch.get(step.remote(i), timeout=30) == i * 3
        _flush(c)
        # every return went out of scope: the store does not accumulate
        assert c.store.size() <= 4
        # lineage released too (all returns dead)
        assert c.task_manager.stats()["num_records"] <= 4

    def test_shm_object_reclaims_arena_bytes(self, driver):
        c = driver.cluster
        payload = os.urandom(512 * 1024)          # > direct-call threshold
        ref = ray_tpu_torch.put(payload)
        _flush(c)
        assert c.store.plasma_info(ref.id)[0] == "shm"
        used_with = c.arena.bytes_in_use()
        oid = ref.id
        del ref
        _flush(c)
        assert not c.store.contains(oid)
        assert c.arena.bytes_in_use() < used_with
        assert not c.directory.is_tracked(oid)

    def test_pg_ready_marker_survives_transient_refs(self, driver):
        pg = placement_group([{"CPU": 1}])
        ray_tpu_torch.get(pg.ready(), timeout=30)       # transient ready refs
        _flush(driver.cluster)
        # marker must still exist
        ray_tpu_torch.get(pg.ready(), timeout=30)
        remove_placement_group(pg)


class TestLineage:
    def test_lineage_budget_evicts_oldest(self):
        Config.reset({"lineage_pinning_memory_mb": 1})
        ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2)
        try:
            c = _get_runtime().cluster

            # lineage cost is the retained SPEC size: pad the args
            @ray_tpu_torch.remote
            def padded(data, i):
                return i

            keep = []
            for i in range(12):
                keep.append(padded.remote(bytes(200_000), i))
            assert ray_tpu_torch.get(keep, timeout=60) == list(range(12))
            stats = c.task_manager.stats()
            # 12 × ~200KB specs ≫ 1MB budget: evictions must have fired
            assert stats["lineage_evictions"] > 0
            assert stats["lineage_bytes"] <= 1 << 20
        finally:
            ray_tpu_torch.shutdown()


class TestReconstruction:
    def _two_node_cluster(self):
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
        doomed = c.add_node(resources={"CPU": 2, "memory": 2},
                            num_workers=2)
        return c, doomed

    def test_lost_object_reconstructs(self, tmp_path):
        marker = tmp_path / "runs"
        c, doomed = self._two_node_cluster()
        ray_tpu_torch.init(cluster=c)
        try:
            @ray_tpu_torch.remote(max_retries=2)
            def produce(path):
                with open(path, "a") as f:
                    f.write("x")
                return os.urandom(300_000)        # shm-routed

            ref = produce.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=doomed, soft=True)).remote(str(marker))
            # wait (presence only), NOT get: a driver get would pull a
            # copy to the head at GET priority, and then removing the
            # producer node would lose nothing
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=30)
            assert ready == [ref]
            assert marker.read_text() == "x"
            row = c.crm.row_of(doomed)
            assert c.directory.locations(ref.id) == (row,)
            c.remove_node(doomed)
            # the only copy lived on the dead node: lineage re-executes
            again = ray_tpu_torch.get(ref, timeout=60)
            assert len(again) == 300_000
            assert _wait_until(lambda: marker.read_text() == "xx")
            assert c.recovery.num_reconstructions == 1
        finally:
            ray_tpu_torch.shutdown()
            c.stop()

    def test_lost_put_object_poisons(self, tmp_path):
        c, doomed = self._two_node_cluster()
        ray_tpu_torch.init(cluster=c)
        try:
            # a put born on the doomed node: fabricate by registering its
            # location there (driver puts are born on the head in the API;
            # the directory is the source of truth for loss)
            ref = ray_tpu_torch.put(os.urandom(300_000))
            row = c.crm.row_of(doomed)
            head_row = c.head().row
            c.directory.drop([ref.id])
            c.directory.add_location(ref.id, row)
            c.remove_node(doomed)
            with pytest.raises(ObjectLostError):
                ray_tpu_torch.get(ref, timeout=10)
            assert c.recovery.num_unrecoverable >= 1
            assert head_row != row
        finally:
            ray_tpu_torch.shutdown()
            c.stop()

    def test_recursive_reconstruction(self, tmp_path):
        marker = tmp_path / "runs"
        c, doomed = self._two_node_cluster()
        ray_tpu_torch.init(cluster=c)
        try:
            aff = NodeAffinitySchedulingStrategy(node_id=doomed, soft=True)

            @ray_tpu_torch.remote(max_retries=2)
            def stage_a(path):
                with open(path, "a") as f:
                    f.write("a")
                return os.urandom(200_000)

            @ray_tpu_torch.remote(max_retries=2)
            def stage_b(data, path):
                with open(path, "a") as f:
                    f.write("b")
                return data + os.urandom(100_000)     # shm-routed output

            a_ref = stage_a.options(scheduling_strategy=aff).remote(
                str(marker))
            b_ref = stage_b.options(scheduling_strategy=aff).remote(
                a_ref, str(marker))
            # wait, not get (a get would pull a head copy — see above)
            ready, _ = ray_tpu_torch.wait([b_ref], num_returns=1, timeout=30)
            assert ready == [b_ref]
            # both outputs' only copies live on the doomed node: removing
            # it must recursively re-run a then b from lineage
            c.remove_node(doomed)
            assert len(ray_tpu_torch.get(b_ref, timeout=60)) == 300_000
            assert _wait_until(
                lambda: marker.read_text().count("a") == 2 and
                marker.read_text().count("b") == 2)
            assert c.recovery.num_reconstructions >= 2
        finally:
            ray_tpu_torch.shutdown()
            c.stop()


class TestConcurrentFlush:
    def test_concurrent_flush_folds_every_event_exactly_once(self):
        """Regression: two threads folding at once (the reclaimer loop
        plus a direct flush() from a test/teardown barrier) used to
        race the batch pop — len() was read by both, each popped "its"
        count, and the second popper hit an empty deque mid-batch,
        losing the rest of its fold.  flush() now serializes poppers,
        so balanced +/- traffic from many holders folds to exactly
        zero no matter how many flushers overlap the producers."""
        import threading as _threading
        from ray_tpu_torch.common.ids import ObjectID
        from ray_tpu_torch.runtime.reference_counter import ReferenceCounter

        rc = ReferenceCounter()
        reclaimed = []
        rc._reclaim = reclaimed.append
        oids = [ObjectID.from_random() for _ in range(32)]
        n_producers, rounds = 4, 400
        start = _threading.Barrier(n_producers + 2)
        stop_flushing = _threading.Event()
        errors = []

        def produce(k):
            holder = ("w", k)
            try:
                start.wait()
                for i in range(rounds):
                    oid = oids[(k + i) % len(oids)]
                    rc.incref(oid, holder)
                    rc.decref(oid, holder)
            except Exception as e:  # noqa: BLE001 — surface in main
                errors.append(e)

        def flusher():
            try:
                start.wait()
                while not stop_flushing.is_set():
                    rc.flush()
            except Exception as e:  # noqa: BLE001 — surface in main
                errors.append(e)

        producers = [_threading.Thread(target=produce, args=(k,))
                     for k in range(n_producers)]
        flushers = [_threading.Thread(target=flusher) for _ in range(2)]
        for t in producers + flushers:
            t.start()
        for t in producers:
            t.join(60)
            assert not t.is_alive(), "producer hung"
        stop_flushing.set()
        for t in flushers:
            t.join(60)
            assert not t.is_alive(), "flusher hung"
        assert not errors, errors
        rc.flush()      # drain whatever the racing flushers left queued
        s = rc.stats()
        assert s["queued_events"] == 0
        assert s["num_tracked"] == 0, "lost decrefs left phantom counts"
        assert s["num_holders"] == 0
        for oid in oids:
            assert rc.count_of(oid) == 0
