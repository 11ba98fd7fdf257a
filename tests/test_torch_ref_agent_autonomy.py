"""Raylet-per-host: agent-autonomous local dispatch.

A worker on an agent machine submitting ``f.remote()`` leases and
dispatches ON that machine with no head round-trip; ownership/lineage
metadata folds up on the batched ``agent_sync`` (SURVEY.md §7 step 8 /
§1 layer 4 — the reference runs ``ClusterTaskManager`` dispatch inside
every node's raylet, ``src/ray/raylet/node_manager.cc``; mount empty).
The proof technique is the head's per-method RPC counters, the same
instrument ``test_object_plane.py`` uses for the data plane.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime.head import HeadNode
from ray_tpu_torch.runtime.node_agent import NodeAgent
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_agent_autonomy.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


REMOTE_RES = {"CPU": 4, "memory": 4, "remote_slot": 2}


def _wait_nodes(n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(ray_tpu_torch.nodes()) == n:
            return
        time.sleep(0.1)
    raise AssertionError(
        f"expected {n} nodes, have {len(ray_tpu_torch.nodes())}")


@pytest.fixture
def head():
    node = HeadNode(resources={"CPU": 2, "memory": 2}, num_workers=1)
    try:
        yield node
    finally:
        node.stop()


@pytest.fixture
def agent(head):
    a = NodeAgent(head.address, resources=REMOTE_RES, num_workers=2,
                  labels={"zone": "remote"})
    _wait_nodes(2)
    try:
        yield a
    finally:
        a.stop()


@ray_tpu_torch.remote
def _double(x):
    return 2 * x


@ray_tpu_torch.remote
def _fanout(n):
    refs = [_double.remote(i) for i in range(n)]
    return sum(ray_tpu_torch.get(refs, timeout=120))


@ray_tpu_torch.remote
def _fanout_pids(n):
    @ray_tpu_torch.remote
    def pid():
        return os.getpid()

    return list(set(ray_tpu_torch.get([pid.remote() for _ in range(n)],
                                timeout=120)))


class TestAgentLocalDispatch:
    def test_fanout_correct_and_runs_on_agent(self, head, agent):
        parent = _fanout_pids.options(
            resources={"CPU": 1, "remote_slot": 1})
        pids = ray_tpu_torch.get(parent.remote(8), timeout=120)
        # children ran in the agent's worker processes (children of
        # THIS test process via the in-process agent spawner), and the
        # sync path registered them at the head
        assert pids and all(p != os.getpid() for p in pids)

    def test_local_leases_cost_no_per_task_head_calls(self, head, agent):
        parent = _fanout.options(resources={"CPU": 1, "remote_slot": 1})
        # warm: function registration, worker boot, first sync
        assert ray_tpu_torch.get(parent.remote(3), timeout=120) == 6
        time.sleep(0.3)     # let trailing syncs/acks drain
        calls0 = dict(head.server.method_calls)
        n = 40
        assert ray_tpu_torch.get(parent.remote(n), timeout=120) \
            == n * (n - 1)
        time.sleep(0.3)
        calls1 = dict(head.server.method_calls)

        def delta(m):
            return calls1.get(m, 0) - calls0.get(m, 0)

        # relay path would cost >= 2 agent_frame calls per child
        # (submit + result); the autonomy path keeps per-child frames
        # at ZERO — only the parent's own frames remain
        assert delta("agent_frame") <= 8, (
            delta("agent_frame"), {k: calls1.get(k, 0) - v
                                   for k, v in calls0.items()})
        # the metadata folds up in a handful of amortized syncs
        assert 1 <= delta("agent_sync") <= 20, delta("agent_sync")

    def test_results_visible_to_driver_and_lineage_registered(
            self, head, agent):
        @ray_tpu_torch.remote
        def fanout_tids(n):
            refs = [_double.remote(i) for i in range(n)]
            vals = ray_tpu_torch.get(refs, timeout=120)
            return vals, [r.task_id().binary() for r in refs]

        parent = fanout_tids.options(
            resources={"CPU": 1, "remote_slot": 1})
        vals, tids = ray_tpu_torch.get(parent.remote(5), timeout=120)
        assert vals == [0, 2, 4, 6, 8]
        # every child spec reached the head's TaskManager (ownership +
        # lineage authority) even though the head never dispatched them
        from ray_tpu_torch.common.ids import TaskID
        rt = ray_tpu_torch.api._get_runtime()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            recs = [rt.cluster.task_manager.get(TaskID(t))
                    for t in tids]
            if all(r is not None and r.done for r in recs):
                break
            time.sleep(0.05)
        assert all(r is not None and r.done for r in recs)

    def test_local_worker_death_hands_task_back_to_head(self, head,
                                                        agent):
        @ray_tpu_torch.remote
        def parent_kill_child():
            @ray_tpu_torch.remote(max_retries=2)
            def die_once(path):
                if not os.path.exists(path):
                    open(path, "w").close()
                    os._exit(1)     # simulated crash mid-task
                return "survived"

            import tempfile
            marker = os.path.join(tempfile.gettempdir(),
                                  f"rt_die_{os.getpid()}_{time.time()}")
            try:
                return ray_tpu_torch.get(die_once.remote(marker), timeout=120)
            finally:
                if os.path.exists(marker):
                    os.remove(marker)

        p = parent_kill_child.options(
            resources={"CPU": 1, "remote_slot": 1})
        assert ray_tpu_torch.get(p.remote(), timeout=120) == "survived"

    def test_job_env_gates_fast_path_off(self, head):
        a = NodeAgent(head.address, resources=REMOTE_RES, num_workers=2)
        _wait_nodes(2)
        try:
            assert a._fast_enabled
            head._rt.cluster.set_job_runtime_env(
                {"env_vars": {"X": "1"}})
            deadline = time.monotonic() + 10
            while a._fast_enabled and time.monotonic() < deadline:
                time.sleep(0.05)
            assert not a._fast_enabled
            head._rt.cluster.set_job_runtime_env(None)
            deadline = time.monotonic() + 10
            while not a._fast_enabled and time.monotonic() < deadline:
                time.sleep(0.05)
            assert a._fast_enabled
        finally:
            a.stop()


class TestAgentCancel:
    def test_cancel_reaches_agent_leased_task(self, head, agent):
        """ray.cancel on an agent-leased task's return: the head seals
        the cancellation (callers unblock with TaskCancelledError) and
        the agent drops/kills the local work."""
        @ray_tpu_torch.remote
        def submit_slow_child():
            @ray_tpu_torch.remote
            def slow():
                time.sleep(30)
                return "never"

            r = slow.remote()
            return r.id.binary(), r.task_id().binary()

        parent = submit_slow_child.options(
            resources={"CPU": 1, "remote_slot": 1})
        oid_bin, tid_bin = ray_tpu_torch.get(parent.remote(), timeout=120)
        from ray_tpu_torch.common.ids import ObjectID, TaskID
        from ray_tpu_torch.runtime.object_ref import ObjectRef
        # wait until the head learns of the lease (started sync)
        rt = ray_tpu_torch.api._get_runtime()
        tid = TaskID(tid_bin)
        deadline = time.monotonic() + 15
        while rt.cluster.task_manager.get(tid) is None:
            assert time.monotonic() < deadline, "started sync missing"
            time.sleep(0.05)
        ref = ObjectRef(ObjectID(oid_bin))
        ray_tpu_torch.cancel(ref, force=True)
        from ray_tpu_torch.runtime.serialization import TaskCancelledError
        with pytest.raises(TaskCancelledError):
            ray_tpu_torch.get(ref, timeout=30)
