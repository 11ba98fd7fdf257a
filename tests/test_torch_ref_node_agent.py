"""Worker-node agents: remote workers joining a head over RPC.

Scenario sources: ``ray start --address=<head>`` semantics — a worker
node registers with the head and its workers execute cluster tasks; node
death drains and retries (SURVEY.md §1 layers 2-4, §3.1, §5.3;
re-derived, not copied).  The agent here runs either in-process (its
workers are still real subprocesses and frames still cross a real TCP
link) or as the actual CLI daemon subprocess.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime.head import HeadNode
from ray_tpu_torch.runtime.node_agent import NodeAgent
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_node_agent.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


REMOTE_RES = {"CPU": 2, "memory": 2, "remote_slot": 2}


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
def _pids():
    return os.getpid(), os.getppid()


class TestRemoteExecution:
    def test_tasks_run_in_agent_workers(self, head, agent):
        # pin to the remote node via its exclusive custom resource
        f = _pids.options(resources={"CPU": 1, "remote_slot": 1})
        pids = ray_tpu_torch.get([f.remote() for _ in range(4)], timeout=60)
        me = os.getpid()
        for wpid, wppid in pids:
            assert wpid != me
            assert wppid == me      # in-process agent spawned them
        # two workers on the remote node: at least two distinct pids
        assert len({p for p, _ in pids}) >= 1

    def test_head_and_remote_mix(self, head, agent):
        @ray_tpu_torch.remote
        def double(x):
            return 2 * x

        refs = [double.options(
            resources={"CPU": 1, "remote_slot": 1} if i % 2
            else {"CPU": 1}).remote(i) for i in range(8)]
        assert ray_tpu_torch.get(refs, timeout=60) == [2 * i for i in range(8)]

    def test_large_objects_cross_the_boundary(self, head, agent):
        # head-side arena object as a remote task arg (inline path)
        blob = os.urandom(300_000)
        ref = ray_tpu_torch.put(blob)

        @ray_tpu_torch.remote(resources={"CPU": 1, "remote_slot": 1})
        def length(b):
            return len(b)

        assert ray_tpu_torch.get(length.remote(ref), timeout=60) == 300_000

        # large remote result seals into the head arena and reads back
        @ray_tpu_torch.remote(resources={"CPU": 1, "remote_slot": 1})
        def produce(n):
            return b"\x07" * n

        out = ray_tpu_torch.get(produce.remote(400_000), timeout=60)
        assert len(out) == 400_000 and out[:2] == b"\x07\x07"

    def test_remote_get_of_head_object(self, head, agent):
        blob_ref = ray_tpu_torch.put(os.urandom(200_000))

        @ray_tpu_torch.remote(resources={"CPU": 1, "remote_slot": 1})
        def peek(refs):
            return len(ray_tpu_torch.get(refs[0]))

        # ship the REF (worker gets it via an in-band get reply)
        assert ray_tpu_torch.get(peek.remote([blob_ref]), timeout=60) \
            == 200_000

    def test_nested_submission_from_remote_worker(self, head, agent):
        @ray_tpu_torch.remote
        def child(x):
            return x + 1

        @ray_tpu_torch.remote(resources={"CPU": 1, "remote_slot": 1})
        def parent(x):
            return ray_tpu_torch.get(child.remote(x)) + 10

        assert ray_tpu_torch.get(parent.remote(5), timeout=60) == 16

    def test_actor_on_remote_node(self, head, agent):
        @ray_tpu_torch.remote(resources={"remote_slot": 1})
        class Counter:
            def __init__(self):
                self.n = 0
                self.pid = os.getpid()

            def incr(self):
                self.n += 1
                return self.n

            def where(self):
                return self.pid

        c = Counter.remote()
        assert ray_tpu_torch.get([c.incr.remote() for _ in range(3)],
                           timeout=60) == [1, 2, 3]
        assert ray_tpu_torch.get(c.where.remote(), timeout=60) != os.getpid()
        ray_tpu_torch.kill(c)

    def test_node_labels_from_agent(self, head, agent):
        rows = {n["NodeID"]: n for n in ray_tpu_torch.nodes()}
        assert any(n["Labels"] == {"zone": "remote"}
                   for n in rows.values())
        assert agent.node_id_hex in rows


class TestAgentLifecycle:
    def test_graceful_stop_removes_node(self, head):
        a = NodeAgent(head.address, resources=REMOTE_RES, num_workers=1)
        _wait_nodes(2)
        a.stop()
        _wait_nodes(1)
        # cluster still healthy for head-local work
        @ray_tpu_torch.remote
        def ping():
            return "ok"

        assert ray_tpu_torch.get(ping.remote(), timeout=60) == "ok"

    def test_running_task_retries_when_agent_dies(self, head):
        a = NodeAgent(head.address, resources=REMOTE_RES, num_workers=1)
        _wait_nodes(2)

        @ray_tpu_torch.remote(max_retries=2)
        def flaky_slow(path):
            # first run parks on the remote node until the agent dies;
            # the retry (anywhere) completes immediately
            import os as _os
            import time as _time
            if not _os.path.exists(path):
                open(path, "w").close()
                _time.sleep(600)    # >> the get timeout: only a RETRY
                #                      can produce the result in time
            return "done"

        marker = os.path.join(head._rt.cluster.session_dir,
                              "agent_died_marker")
        # SOFT affinity: the first attempt lands on the (live) remote
        # node, the retry falls back to the head once it is gone
        from ray_tpu_torch.common.ids import NodeID
        from ray_tpu_torch.util.scheduling_strategies import \
            NodeAffinitySchedulingStrategy
        ref = flaky_slow.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                node_id=NodeID.from_hex(a.node_id_hex),
                soft=True)).remote(marker)
        deadline = time.monotonic() + 30
        while not os.path.exists(marker):
            assert time.monotonic() < deadline, "task never started"
            time.sleep(0.05)
        # hard death: the agent's RPC server vanishes (no goodbye) —
        # the head's spawner link drops and the disconnect drain runs
        a.server.stop()
        assert ray_tpu_torch.get(ref, timeout=90) == "done"
        _wait_nodes(1)
        a._a_stop()             # reap the orphaned worker processes


class TestCliAgent:
    def test_cli_agent_subprocess(self, head):
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "agent",
             "--address", head.address,
             "--resources", json.dumps(REMOTE_RES),
             "--num-workers", "1"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            _wait_nodes(2, timeout=90)

            @ray_tpu_torch.remote(resources={"CPU": 1, "remote_slot": 1})
            def where():
                return os.getppid()

            agent_pid = ray_tpu_torch.get(where.remote(), timeout=90)
            assert agent_pid == proc.pid        # worker is the agent's
            #                                     child, not ours
            # agent SIGKILL == node death: head notices and drains
            os.kill(proc.pid, signal.SIGKILL)
            _wait_nodes(1, timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)


class TestMultiAgentTopology:
    def test_two_agents_and_strict_spread_pg(self, head):
        """Two worker machines join; a STRICT_SPREAD placement group
        lands one bundle per node and pinned tasks run in the right
        agent's workers."""
        a1 = NodeAgent(head.address,
                       resources={"CPU": 2, "memory": 2}, num_workers=1)
        a2 = NodeAgent(head.address,
                       resources={"CPU": 2, "memory": 2}, num_workers=1)
        _wait_nodes(3)
        try:
            from ray_tpu_torch.util.placement_group import (placement_group,
                                                      remove_placement_group)
            pg = placement_group([{"CPU": 1}, {"CPU": 1}, {"CPU": 1}],
                                 strategy="STRICT_SPREAD")
            assert pg.wait(timeout_seconds=60)

            @ray_tpu_torch.remote(num_cpus=1)
            def who():
                return os.getpid()

            pids = ray_tpu_torch.get(
                [who.options(placement_group=pg,
                             placement_group_bundle_index=i).remote()
                 for i in range(3)], timeout=90)
            # STRICT_SPREAD: one bundle per node; each node has ONE
            # worker, so three distinct worker pids == three nodes
            assert len(set(pids)) == 3, pids
            from ray_tpu_torch.util.placement_group import placement_group_table
            entry = placement_group_table()[pg.id.hex()]
            assert len(set(entry["node_rows"])) == 3, entry
            remove_placement_group(pg)
        finally:
            a1.stop()
            a2.stop()
            _wait_nodes(1)

    def test_cross_agent_task_chain(self, head):
        """An object produced in one agent's worker feeds a task in the
        other agent's worker, through head ownership."""
        a1 = NodeAgent(head.address, resources={"CPU": 2, "one": 1},
                       num_workers=1)
        a2 = NodeAgent(head.address, resources={"CPU": 2, "two": 1},
                       num_workers=1)
        _wait_nodes(3)
        try:
            @ray_tpu_torch.remote(resources={"CPU": 1, "one": 1})
            def produce():
                return (os.getppid(), b"\x05" * 150_000)

            @ray_tpu_torch.remote(resources={"CPU": 1, "two": 1})
            def consume(pair):
                src, blob = pair
                return (src, os.getppid(), len(blob))

            src, dst, n = ray_tpu_torch.get(consume.remote(produce.remote()),
                                      timeout=90)
            assert n == 150_000
            me = os.getpid()
            assert src == me and dst == me    # in-process agents share
            #   our pid as parent; the REAL check is distinct workers:
            @ray_tpu_torch.remote(resources={"CPU": 1, "one": 1})
            def pid_one():
                return os.getpid()

            @ray_tpu_torch.remote(resources={"CPU": 1, "two": 1})
            def pid_two():
                return os.getpid()

            p1 = ray_tpu_torch.get(pid_one.remote(), timeout=60)
            p2 = ray_tpu_torch.get(pid_two.remote(), timeout=60)
            assert len({p1, p2, me}) == 3
        finally:
            a1.stop()
            a2.stop()
            _wait_nodes(1)


class TestAgentStreaming:
    def test_generator_on_agent_streams_big_items(self, head, agent):
        """A streaming-generator task RUNNING ON THE AGENT: big yielded
        items seal into the agent arena (stream_item_x metadata rides
        up), the driver's ObjectRefGenerator pulls them over the object
        plane, and backpressure acks flow back through the relay."""
        @ray_tpu_torch.remote(num_returns="streaming",
                        resources={"CPU": 1, "remote_slot": 1})
        def produce(n, size):
            for i in range(n):
                yield bytes([i % 251]) * size

        n, size = 6, 300_000        # plasma-routed items
        gen = produce.remote(n, size)
        got = []
        for ref in gen:
            got.append(ray_tpu_torch.get(ref, timeout=120))
        assert [len(b) for b in got] == [size] * n
        assert [b[0] for b in got] == [i % 251 for i in range(n)]

    def test_generator_on_agent_small_items(self, head, agent):
        @ray_tpu_torch.remote(num_returns="streaming",
                        resources={"CPU": 1, "remote_slot": 1})
        def counts(n):
            for i in range(n):
                yield i * 3

        vals = [ray_tpu_torch.get(r, timeout=60) for r in counts.remote(10)]
        assert vals == [i * 3 for i in range(10)]
