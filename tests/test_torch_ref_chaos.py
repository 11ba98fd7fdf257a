"""Chaos suite: kill things mid-flight and assert the runtime heals.

Scenario sources: upstream's ``test_failure*.py`` + chaos-kill pattern —
SIGKILL workers mid-task (with and without retries), kill agents holding
leases and sole-copy objects, placement pressure during node death,
spill storms under load (SURVEY.md §4 fault-injection tier; re-derived,
not copied).
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime.serialization import (ActorDiedError,
                                           WorkerCrashedError)
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_chaos.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def driver():
    from ray_tpu_torch.api import _get_runtime
    ray_tpu_torch.init(resources={"CPU": 8, "memory": 8}, num_workers=4)
    try:
        yield _get_runtime()
    finally:
        ray_tpu_torch.shutdown()


def _worker_pids(rt) -> list[int]:
    pool = rt.raylet.pool
    with pool._lock:
        return [h.proc.pid for h in pool._workers
                if not h.dead and h.proc.pid]


def _kill_busy_worker(rt, deadline=10.0) -> int:
    """SIGKILL a worker that is currently executing a task."""
    pool = rt.raylet.pool
    end = time.monotonic() + deadline
    while time.monotonic() < end:
        with pool._lock:
            busy = [h for h in pool._workers
                    if not h.dead and h.leased_task is not None]
        if busy:
            pid = busy[0].proc.pid
            os.kill(pid, signal.SIGKILL)
            return pid
        time.sleep(0.02)
    raise AssertionError("no busy worker appeared")


@pytest.mark.chaos
class TestWorkerKills:
    def test_sigkill_midtask_retries_and_completes(self, driver):
        @ray_tpu_torch.remote(max_retries=2)
        def slow(x):
            time.sleep(1.0)
            return x * 3

        ref = slow.remote(14)
        _kill_busy_worker(driver)
        assert ray_tpu_torch.get(ref, timeout=90) == 42

    def test_sigkill_midtask_without_retries_errors(self, driver):
        @ray_tpu_torch.remote(max_retries=0)
        def doomed():
            time.sleep(5.0)

        ref = doomed.remote()
        _kill_busy_worker(driver)
        with pytest.raises(WorkerCrashedError):
            ray_tpu_torch.get(ref, timeout=60)

    def test_sigkill_worker_blocked_in_get(self, driver):
        """Killing a worker parked in a blocking ray.get must fail only
        ITS task; the dependency task it awaited stays valid."""
        @ray_tpu_torch.remote(max_retries=0)
        def dep():
            time.sleep(1.5)
            return "dep-done"

        @ray_tpu_torch.remote(max_retries=0)
        def waiter(refs):
            return ray_tpu_torch.get(refs[0], timeout=60)

        d = dep.remote()
        w = waiter.remote([d])
        time.sleep(0.5)     # waiter is now blocked in its get
        pool = driver.raylet.pool
        with pool._lock:
            blocked = [h for h in pool._workers
                       if not h.dead and h.blocked]
        if blocked:
            os.kill(blocked[0].proc.pid, signal.SIGKILL)
            with pytest.raises(WorkerCrashedError):
                ray_tpu_torch.get(w, timeout=60)
        assert ray_tpu_torch.get(d, timeout=60) == "dep-done"

    def test_kill_storm_with_retries_all_complete(self, driver):
        """Random kill storm: every task completes despite three rounds
        of worker murder."""
        @ray_tpu_torch.remote(max_retries=5)
        def work(i):
            time.sleep(0.15)
            return i

        refs = [work.remote(i) for i in range(40)]
        for _ in range(3):
            time.sleep(0.4)
            try:
                _kill_busy_worker(driver, deadline=2.0)
            except AssertionError:
                break       # backlog already drained
        assert sorted(ray_tpu_torch.get(refs, timeout=180)) == list(range(40))


@pytest.mark.chaos
class TestActorKills:
    def test_actor_sigkill_restarts_and_serves(self, driver):
        @ray_tpu_torch.remote(max_restarts=2)
        class Counter:
            def __init__(self):
                self.n = 0

            def incr(self):
                self.n += 1
                return self.n

            def pid(self):
                return os.getpid()

        c = Counter.remote()
        assert ray_tpu_torch.get(c.incr.remote(), timeout=60) == 1
        pid = ray_tpu_torch.get(c.pid.remote(), timeout=60)
        os.kill(pid, signal.SIGKILL)
        # restarted incarnation: ctor re-ran (state reset, fresh pid)
        deadline = time.monotonic() + 60
        out = None
        while time.monotonic() < deadline:
            try:
                out = ray_tpu_torch.get(c.incr.remote(), timeout=30)
                break
            except Exception:   # noqa: BLE001 — calls racing the
                time.sleep(0.3)  # restart may fail with various errors
        assert out == 1, "actor never served after restart"
        assert ray_tpu_torch.get(c.pid.remote(), timeout=30) != pid
        ray_tpu_torch.kill(c)

    def test_actor_sigkill_no_restarts_dies(self, driver):
        @ray_tpu_torch.remote(max_restarts=0)
        class Frail:
            def pid(self):
                return os.getpid()

        f = Frail.remote()
        pid = ray_tpu_torch.get(f.pid.remote(), timeout=60)
        os.kill(pid, signal.SIGKILL)
        with pytest.raises(ActorDiedError):
            ray_tpu_torch.get(f.pid.remote(), timeout=60)


@pytest.mark.chaos
class TestAgentChaos:
    def _spawn_agent(self, address, resources):
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "agent",
             "--address", address,
             "--resources", json.dumps(resources),
             "--num-workers", "1"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": REPO})
        return proc

    def test_agent_sigkill_with_leases_and_objects(self):
        """SIGKILL an agent process that is running tasks AND holds the
        only copies of plasma objects: leased tasks retry on a second
        agent, lost objects reconstruct via lineage."""
        from ray_tpu_torch.runtime.head import HeadNode

        head = HeadNode(resources={"CPU": 2, "memory": 2},
                        num_workers=1)
        a1 = a2 = None
        try:
            a1 = self._spawn_agent(head.address, {"CPU": 2, "slot": 2})
            deadline = time.monotonic() + 90
            while len(ray_tpu_torch.nodes()) != 2:
                assert time.monotonic() < deadline
                time.sleep(0.2)

            @ray_tpu_torch.remote(resources={"slot": 1}, max_retries=3)
            def produce(i):
                return bytes([i]) * 300_000

            @ray_tpu_torch.remote(resources={"slot": 1}, max_retries=3)
            def slow(x):
                time.sleep(30.0)
                return x

            obj_refs = [produce.remote(i) for i in range(2)]
            ray_tpu_torch.wait(obj_refs, num_returns=2, timeout=90)
            lease_ref = slow.remote(7)      # running when the axe falls
            time.sleep(1.0)
            os.kill(a1.pid, signal.SIGKILL)
            a1.wait(timeout=30)
            # a second agent provides the resources again
            a2 = self._spawn_agent(head.address, {"CPU": 2, "slot": 2})
            deadline = time.monotonic() + 90
            while len(ray_tpu_torch.nodes()) != 2:
                assert time.monotonic() < deadline
                time.sleep(0.2)
            # objects whose only copies died reconstruct via lineage
            for i, r in enumerate(obj_refs):
                assert ray_tpu_torch.get(r, timeout=180) == bytes([i]) * 300_000
        finally:
            for p in (a1, a2):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            head.stop()


@pytest.mark.chaos
class TestPlacementChaos:
    def test_pg_prepare_race_rolls_back_and_retries(self, driver):
        """A task racing the 2-phase prepare steals the resources: the
        manager rolls back cleanly and the pending retry succeeds once
        capacity frees."""
        from ray_tpu_torch.util.placement_group import (placement_group,
                                                  remove_placement_group)

        @ray_tpu_torch.remote(num_cpus=7)
        def hog():
            time.sleep(2.0)
            return "done"

        h = hog.remote()
        time.sleep(0.3)     # hog holds 7 of 8 CPUs
        pg = placement_group([{"CPU": 4}, {"CPU": 4}], strategy="PACK")
        assert not pg.wait(timeout_seconds=0.5)     # cannot fit yet
        assert ray_tpu_torch.get(h, timeout=60) == "done"
        assert pg.wait(timeout_seconds=60)          # retried + placed
        remove_placement_group(pg)

    def test_pg_node_death_reschedules_bundles(self, driver):
        from ray_tpu_torch.util.placement_group import (placement_group,
                                                  remove_placement_group)
        cluster = driver.cluster
        node = cluster.add_node(resources={"CPU": 4, "memory": 2},
                                num_workers=1)
        pg = placement_group([{"CPU": 3}, {"CPU": 3}],
                             strategy="STRICT_SPREAD")
        assert pg.wait(timeout_seconds=60)
        cluster.remove_node(node)       # one bundle's node dies
        # group re-pends; a replacement node lets it re-reserve
        node2 = cluster.add_node(resources={"CPU": 4, "memory": 2},
                                 num_workers=1)
        assert pg.wait(timeout_seconds=60)
        remove_placement_group(pg)
        cluster.remove_node(node2)


@pytest.mark.chaos
class TestSpillStorm:
    def test_spill_storm_during_load(self):
        """A tiny arena forces continuous spill/restore while tasks
        churn big objects — everything stays correct."""
        ray_tpu_torch.init(resources={"CPU": 8, "memory": 8}, num_workers=4,
                     system_config={"object_store_memory_mb": 4})
        try:
            @ray_tpu_torch.remote
            def make(i):
                return bytes([i % 251]) * 400_000

            @ray_tpu_torch.remote
            def check(b, i):
                assert b == bytes([i % 251]) * 400_000
                return len(b)

            refs = [make.remote(i) for i in range(24)]   # ~10MB >> 4MB
            outs = ray_tpu_torch.get([check.remote(r, i)
                                for i, r in enumerate(refs)],
                               timeout=180)
            assert outs == [400_000] * 24
            from ray_tpu_torch.api import _get_runtime
            stats = _get_runtime().store.stats()
            assert stats["spilled_bytes"] > 0, stats
        finally:
            ray_tpu_torch.shutdown()


class TestHeadRestore:
    def test_snapshot_restore_after_load(self, tmp_path):
        """GCS snapshot under load restores into a fresh cluster: KV
        survives, named actors re-create (ctor re-runs)."""
        ray_tpu_torch.init(resources={"CPU": 4}, num_workers=2)
        snap = str(tmp_path / "gcs.snap")
        try:
            from ray_tpu_torch.api import _get_runtime
            from ray_tpu_torch.experimental.internal_kv import (
                _internal_kv_get, _internal_kv_put)

            @ray_tpu_torch.remote
            class Keeper:
                def __init__(self):
                    self.v = "fresh"

                def get(self):
                    return self.v

            k = Keeper.options(name="keeper").remote()
            assert ray_tpu_torch.get(k.get.remote(), timeout=60) == "fresh"
            _internal_kv_put(b"chaos-key", b"chaos-value")
            _get_runtime().cluster.save_gcs_snapshot(snap)
        finally:
            ray_tpu_torch.shutdown()

        ray_tpu_torch.init(resources={"CPU": 4}, num_workers=2)
        try:
            from ray_tpu_torch.api import _get_runtime
            from ray_tpu_torch.experimental.internal_kv import _internal_kv_get
            _get_runtime().cluster.restore_gcs_snapshot(snap)
            assert _internal_kv_get(b"chaos-key") == b"chaos-value"
            k2 = ray_tpu_torch.get_actor("keeper")
            assert ray_tpu_torch.get(k2.get.remote(), timeout=60) == "fresh"
        finally:
            ray_tpu_torch.shutdown()


@pytest.mark.chaos
class TestAutonomyChaos:
    """Agent death while AUTONOMOUS dispatch is mid-flight: callers
    must fail or retry — never hang on tasks only the dead agent knew
    about (agent-leased records drain exactly like node death)."""

    def test_agent_sigkill_mid_local_fanout(self):
        from ray_tpu_torch.runtime.head import HeadNode
        from ray_tpu_torch.runtime.node_agent import NodeAgent

        head = HeadNode(resources={"CPU": 2, "memory": 2},
                        num_workers=1)
        agent = None
        try:
            # in-process agent: its workers are real subprocesses, and
            # stopping the RPC server + link simulates machine loss
            agent = NodeAgent(head.address,
                              resources={"CPU": 4, "memory": 4,
                                         "aslot": 2},
                              num_workers=2)
            deadline = time.monotonic() + 60
            while len(ray_tpu_torch.nodes()) != 2:
                assert time.monotonic() < deadline
                time.sleep(0.1)

            @ray_tpu_torch.remote(resources={"CPU": 1, "aslot": 1},
                            max_retries=0)
            def fanout_slow(n):
                @ray_tpu_torch.remote
                def slow(i):
                    time.sleep(20)
                    return i

                refs = [slow.remote(i) for i in range(n)]
                return sum(ray_tpu_torch.get(refs, timeout=120))

            ref = fanout_slow.remote(6)
            # let the agent accept + lease children locally, then die
            rt = ray_tpu_torch.api._get_runtime()
            deadline = time.monotonic() + 30
            got_leases = False
            while time.monotonic() < deadline:
                for r in rt.cluster.raylets.values():
                    if r.agent_inflight:
                        got_leases = True
                        break
                if got_leases:
                    break
                time.sleep(0.1)
            assert got_leases, "no autonomous leases observed"
            # abrupt loss: kill the worker procs + drop the link
            for _i, (proc, _c) in list(agent._workers.items()):
                try:
                    os.kill(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            agent.server.stop()
            agent._head.close()
            # the caller UNBLOCKS: parent dies with the node
            # (max_retries=0 -> WorkerCrashedError surface), and no
            # agent-leased child leaves a dangling inflight record
            with pytest.raises(Exception):
                ray_tpu_torch.get(ref, timeout=60)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                if all(not r.agent_inflight
                       for r in rt.cluster.raylets.values()):
                    break
                time.sleep(0.2)
            assert all(not r.agent_inflight
                       for r in rt.cluster.raylets.values())
        finally:
            if agent is not None:
                try:
                    agent.stop()
                except Exception:
                    pass
            head.stop()
