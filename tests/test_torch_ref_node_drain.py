"""Graceful node drain: ALIVE -> DRAINING -> removed.

The drain contract under test: after ``drain_node`` returns, the node
accepts ZERO new leases; running tasks finish; queued/pipelined work
re-places elsewhere; sole-copy objects migrate off; placement-group
bundles re-place atomically; the node is removed once empty or at the
deadline; and a node that DIES mid-drain converges through the health
manager's dead path instead of hanging the monitor.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.api import _get_runtime
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_node_drain.py: the reference's file with
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
    ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2)
    try:
        yield _get_runtime()
    finally:
        ray_tpu_torch.shutdown()


class TestGracefulDrain:
    def test_clean_drain_no_task_failures(self, driver):
        """Acceptance: a busy node (running + queued tasks + sole-copy
        objects) drains cleanly — zero new leases after the call, every
        task completes without a worker/node-death error, every
        sole-copy migrates, and the node is removed by the deadline."""
        cluster = driver.cluster
        node = cluster.add_node(resources={"CPU": 4, "memory": 4},
                                num_workers=2)
        row = cluster.crm.row_of(node)

        @ray_tpu_torch.remote(num_cpus=1)
        def work(i):
            time.sleep(0.3)
            return i

        @ray_tpu_torch.remote(num_cpus=1)
        def big(i):
            return bytes([i]) * 300_000     # plasma-sized output

        refs = [work.remote(i) for i in range(16)]
        bigs = [big.remote(i) for i in range(4)]
        time.sleep(0.5)                     # some land on the new node

        st = cluster.drain_node(node, reason="test", deadline_s=30.0)
        assert st["state"] == "DRAINING"
        # masked from EVERY placement view immediately
        assert not cluster.crm.snapshot().node_mask[row]
        assert cluster.crm.is_draining(row)
        # zero NEW leases: the running set only shrinks from here on
        raylet = cluster.raylets[row]
        with raylet._cv:
            at_drain = set(raylet._running)
        for _ in range(20):
            with raylet._cv:
                now = set(raylet._running)
            assert now <= at_drain, "draining node accepted a new lease"
            time.sleep(0.02)

        # no task fails with a worker/node-death error during the drain
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(16))
        assert [b[0] for b in ray_tpu_torch.get(bigs, timeout=120)] == \
            [0, 1, 2, 3]

        fin = cluster.wait_for_drain(node, timeout=60)
        assert fin["outcome"] == "drained", fin
        assert fin["state"] == "REMOVED"
        assert cluster.crm.row_of(node) is None
        # post-drain work still schedules (on the surviving node)
        assert ray_tpu_torch.get([work.remote(9)], timeout=60) == [9]

    def test_drain_status_surfaces_everywhere(self, driver):
        cluster = driver.cluster
        node = cluster.add_node(
            resources={"CPU": 2, "memory": 2, "hold": 1}, num_workers=1)
        row = cluster.crm.row_of(node)

        @ray_tpu_torch.remote(resources={"hold": 1})
        def hold():
            time.sleep(1.5)
            return "ok"

        ref = hold.remote()
        time.sleep(0.4)
        st = cluster.drain_node(node, reason="surface", deadline_s=30.0)
        # idempotent: a second call reports the drain in flight
        again = ray_tpu_torch.drain_node(node.hex(), reason="dup")
        assert again["state"] == "DRAINING"
        assert again["reason"] == "surface"     # first call wins
        assert cluster.is_draining(node)
        assert cluster.drain_status(node)["row"] == row
        # api.nodes() / state list surface DRAINING
        by_row = {n["Row"]: n["Status"] for n in ray_tpu_torch.nodes()}
        if row in by_row:       # node may already have emptied
            assert by_row[row] == "DRAINING"
            from ray_tpu_torch.util import state
            states = {r["row"]: r["state"] for r in state.list_nodes()}
            assert states[row] == "DRAINING"
        assert ray_tpu_torch.get(ref, timeout=60) == "ok"
        fin = cluster.wait_for_drain(node, timeout=60)
        assert fin["outcome"] == "drained"
        assert st["node_id"] == fin["node_id"]

    def test_drain_deadline_forces_removal(self, driver):
        """A task outliving the grace period rides the forced removal:
        the node goes away at the deadline and the task retries
        elsewhere."""
        cluster = driver.cluster
        node = cluster.add_node(
            resources={"CPU": 2, "memory": 2, "pin": 1}, num_workers=1)

        @ray_tpu_torch.remote(resources={"pin": 1}, max_retries=2)
        def stubborn():
            time.sleep(30.0)
            return "late"

        ref = stubborn.remote()
        time.sleep(0.4)         # it is running on the pinned node
        cluster.drain_node(node, reason="deadline", deadline_s=1.0)
        fin = cluster.wait_for_drain(node, timeout=60)
        assert fin["outcome"] == "deadline", fin
        assert cluster.crm.row_of(node) is None
        # a replacement provides the resource; the retry completes
        node2 = cluster.add_node(
            resources={"CPU": 2, "memory": 2, "pin": 1}, num_workers=1)

        @ray_tpu_torch.remote(resources={"pin": 1}, max_retries=2)
        def quick():
            return "quick"

        assert ray_tpu_torch.get(quick.remote(), timeout=60) == "quick"
        cluster.remove_node(node2)
        del ref

    def test_drain_head_or_unknown_raises(self, driver):
        from ray_tpu_torch.common.ids import NodeID
        cluster = driver.cluster
        head_id = cluster.crm.id_of(cluster._head_row)
        with pytest.raises(ValueError):
            cluster.drain_node(head_id)
        with pytest.raises(ValueError):
            cluster.drain_node(NodeID.from_random())

    def test_queued_backlog_resubmits_elsewhere(self, driver):
        """Work queued (not yet running) on the draining node re-enters
        global scheduling and completes on surviving nodes."""
        cluster = driver.cluster
        node = cluster.add_node(resources={"CPU": 4, "memory": 4},
                                num_workers=2)

        @ray_tpu_torch.remote(num_cpus=1)
        def step(i):
            time.sleep(0.2)
            return i

        # 8 CPUs total, 24 tasks: a deep backlog spans both nodes
        refs = [step.remote(i) for i in range(24)]
        time.sleep(0.3)
        cluster.drain_node(node, reason="backlog", deadline_s=30.0)
        assert ray_tpu_torch.get(refs, timeout=120) == list(range(24))
        fin = cluster.wait_for_drain(node, timeout=60)
        assert fin["outcome"] == "drained", fin


@pytest.mark.chaos
class TestDrainChaos:
    def test_sigkill_mid_drain_converges_via_dead_path(self):
        """A node SIGKILLed mid-drain must converge through the health
        manager's dead path — outcome 'dead', monitor exits — not hang
        until the deadline."""
        from ray_tpu_torch.runtime.head import HeadNode

        head = HeadNode(resources={"CPU": 2, "memory": 2},
                        num_workers=1)
        agent = None
        try:
            agent = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch", "agent",
                 "--address", head.address,
                 "--resources", json.dumps({"CPU": 2, "slot": 2}),
                 "--num-workers", "1"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, env={**os.environ, "PYTHONPATH": REPO})
            deadline = time.monotonic() + 90
            while len(ray_tpu_torch.nodes()) != 2:
                assert time.monotonic() < deadline
                time.sleep(0.2)

            @ray_tpu_torch.remote(resources={"slot": 1}, max_retries=0)
            def slow():
                time.sleep(60.0)
                return "never"

            ref = slow.remote()     # keeps the drain from emptying
            time.sleep(1.0)
            cluster = _get_runtime().cluster
            rows = {n["Row"]: n["NodeID"] for n in ray_tpu_torch.nodes()}
            agent_row = max(rows)
            from ray_tpu_torch.common.ids import NodeID
            nid = NodeID.from_hex(rows[agent_row])
            st = cluster.drain_node(nid, reason="preempt",
                                    deadline_s=120.0)
            assert st["state"] == "DRAINING"
            os.kill(agent.pid, signal.SIGKILL)
            agent.wait(timeout=30)
            # well under the 120s deadline: the dead path must win
            fin = cluster.wait_for_drain(nid, timeout=60)
            assert fin is not None and fin["outcome"] == "dead", fin
            assert fin["state"] == "DEAD"
            del ref
        finally:
            if agent is not None and agent.poll() is None:
                agent.kill()
                agent.wait(timeout=30)
            head.stop()

    def test_drain_node_hosting_strict_pack_group(self, driver):
        """Draining the node that hosts a STRICT_PACK group displaces
        the WHOLE group atomically: it re-places on one surviving node,
        never splits, and never lands back on the draining row."""
        from ray_tpu_torch.util.placement_group import (placement_group,
                                                  remove_placement_group)
        cluster = driver.cluster
        node = cluster.add_node(resources={"CPU": 6, "memory": 4},
                                num_workers=1)
        row = cluster.crm.row_of(node)
        # only the 6-CPU node fits both bundles together
        pg = placement_group([{"CPU": 3}, {"CPU": 3}],
                             strategy="STRICT_PACK")
        assert pg.wait(timeout_seconds=60)
        rec = cluster.pg_manager.get(pg.id)
        assert set(rec.rows) == {row}

        node2 = cluster.add_node(resources={"CPU": 8, "memory": 4},
                                 num_workers=1)
        row2 = cluster.crm.row_of(node2)
        st = cluster.drain_node(node, reason="pg", deadline_s=30.0)
        assert st["displaced_groups"] == 1
        assert pg.wait(timeout_seconds=60)      # re-placed elsewhere
        rec = cluster.pg_manager.get(pg.id)
        assert set(rec.rows) == {row2}          # atomic, off the row
        fin = cluster.wait_for_drain(node, timeout=60)
        assert fin["outcome"] == "drained", fin
        remove_placement_group(pg)
        cluster.remove_node(node2)


class TestTrainerDrain:
    def test_drain_notice_restarts_without_burning_failures(self, driver):
        """A drain notice for the gang's node is a PLANNED handoff: the
        trainer kills its actors, resumes from the checkpoint on a
        replacement node, and does NOT count it toward max_failures
        (max_failures=0 here — a real failure would raise)."""
        import tempfile

        from ray_tpu_torch import train

        cluster = driver.cluster
        node = cluster.add_node(
            resources={"CPU": 4, "memory": 4, "gang": 2}, num_workers=2)
        spare = cluster.add_node(
            resources={"CPU": 4, "memory": 4, "gang": 2}, num_workers=2)

        def loop(config):
            ctx = train.get_context()
            ckpt = train.get_checkpoint()
            start = ckpt.to_dict()["step"] if ckpt is not None else 0
            marker = config["marker"]
            for step in range(start, 6):
                if step == 2 and ctx.get_world_rank() == 0 \
                        and not os.path.exists(marker):
                    open(marker, "w").close()   # signal: drain me now
                time.sleep(0.25)
                train.report({"step": step, "resumed_from": start},
                             checkpoint=train.Checkpoint(
                                 {"step": step + 1}))

        with tempfile.TemporaryDirectory() as td:
            marker = os.path.join(td, "drain-now")
            out: dict = {}

            def run():
                try:
                    out["result"] = train.JaxTrainer(
                        loop,
                        train_loop_config={"marker": marker},
                        scaling_config=train.ScalingConfig(
                            num_workers=2,
                            resources_per_worker={"CPU": 1, "gang": 1}),
                        failure_config=train.FailureConfig(
                            max_failures=0),
                    ).fit(timeout=120)
                except Exception as e:      # noqa: BLE001
                    out["error"] = e

            t = threading.Thread(target=run)
            t.start()
            deadline = time.monotonic() + 60
            while not os.path.exists(marker):
                assert time.monotonic() < deadline, "gang never started"
                time.sleep(0.05)
            # find which gang-node actually hosts the group and drain it
            gidx = cluster.crm.resource_index.get("gang")
            assert gidx is not None
            gang_row = None
            for cand in (node, spare):
                r = cluster.crm.row_of(cand)
                if r is not None and cluster.crm.avail[r, gidx] < 2:
                    gang_row = cand
                    break
            assert gang_row is not None
            cluster.drain_node(gang_row, reason="preempt",
                               deadline_s=30.0)
            t.join(timeout=180)
            assert not t.is_alive()
            assert "error" not in out, out.get("error")
            result = out["result"]
            assert result.metrics["step"] == 5
            assert result.metrics["resumed_from"] >= 1  # from checkpoint
            fin = cluster.wait_for_drain(gang_row, timeout=60)
            assert fin["outcome"] in ("drained", "deadline")
        for n in (node, spare):
            if cluster.crm.row_of(n) is not None:
                cluster.remove_node(n)
