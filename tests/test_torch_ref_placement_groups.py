"""Placement groups end-to-end: public API, gang actors, pending retry,
removal, node death rescheduling.

Scenario sources: upstream ``python/ray/tests/test_placement_group*.py``
behavioral contract (SURVEY.md §3.5 / §4; scenarios re-derived, not
copied)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import (placement_group, placement_group_table,
                          remove_placement_group)
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_placement_groups.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


@pytest.fixture
def cluster3():
    c = Cluster()
    c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
    c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
    c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
    ray_tpu_torch.init(cluster=c)
    yield c
    ray_tpu_torch.shutdown()
    c.stop()


def _actor_row(handle):
    from ray_tpu_torch import api
    return api._get_runtime().actor_manager._actors[handle._actor_id].row


@ray_tpu_torch.remote
class Member:
    def pid(self):
        import os
        return os.getpid()


class TestPlacementGroups:
    def test_strict_spread_gang_actors_on_distinct_nodes(self, cluster3):
        pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
        assert pg.wait(timeout_seconds=10)
        table = placement_group_table()[pg.id.hex()]
        assert table["state"] == "CREATED"
        rows = table["node_rows"]
        assert len(set(rows)) == 3

        handles = [Member.options(
            placement_group=pg, placement_group_bundle_index=i).remote()
            for i in range(3)]
        pids = ray_tpu_torch.get([h.pid.remote() for h in handles], timeout=30)
        assert len(set(pids)) == 3
        actor_rows = [_actor_row(h) for h in handles]
        assert actor_rows == rows
        for h in handles:
            ray_tpu_torch.kill(h)
        remove_placement_group(pg)

    def test_strict_pack_single_node(self, cluster3):
        pg = placement_group([{"CPU": 1}, {"CPU": 1}],
                             strategy="STRICT_PACK")
        assert pg.wait(timeout_seconds=10)
        rows = placement_group_table()[pg.id.hex()]["node_rows"]
        assert len(set(rows)) == 1
        remove_placement_group(pg)

    def test_task_pinned_to_bundle(self, cluster3):
        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=10)
        row = placement_group_table()[pg.id.hex()]["node_rows"][0]

        @ray_tpu_torch.remote
        def where():
            import os
            return os.getpid()

        pid = ray_tpu_torch.get(
            where.options(placement_group=pg,
                          placement_group_bundle_index=0).remote(),
            timeout=30)
        target = cluster3.raylet_of_row(row)
        pool_pids = {h.proc.pid for h in target.pool._workers}
        assert pid in pool_pids
        remove_placement_group(pg)

    def test_pending_pg_places_after_capacity_release(self, cluster3):
        # each node has CPU:2 -> a 3x{CPU:2} STRICT_SPREAD takes everything
        pg1 = placement_group([{"CPU": 2}] * 3, strategy="STRICT_SPREAD")
        assert pg1.wait(timeout_seconds=10)
        pg2 = placement_group([{"CPU": 2}], strategy="PACK")
        assert not pg2.wait(timeout_seconds=0.5)        # no capacity left
        assert placement_group_table()[pg2.id.hex()]["state"] == "PENDING"
        remove_placement_group(pg1)                     # frees capacity
        assert pg2.wait(timeout_seconds=10)
        assert placement_group_table()[pg2.id.hex()]["state"] == "CREATED"
        remove_placement_group(pg2)

    def test_remove_returns_resources(self, cluster3):
        before = ray_tpu_torch.available_resources().get("CPU", 0)
        pg = placement_group([{"CPU": 1}] * 2, strategy="SPREAD")
        assert pg.wait(timeout_seconds=10)
        during = ray_tpu_torch.available_resources().get("CPU", 0)
        assert during == before - 2
        remove_placement_group(pg)
        deadline = time.time() + 5
        while time.time() < deadline:
            if ray_tpu_torch.available_resources().get("CPU", 0) == before:
                break
            time.sleep(0.05)
        assert ray_tpu_torch.available_resources().get("CPU", 0) == before

    def test_pg_created_inside_task(self, cluster3):
        @ray_tpu_torch.remote
        def maker():
            from ray_tpu_torch.util import placement_group as make_pg
            pg = make_pg([{"CPU": 1}], strategy="PACK")
            ok = pg.wait(timeout_seconds=10)
            return ok, pg.id.binary()

        ok, pg_bin = ray_tpu_torch.get(maker.remote(), timeout=30)
        assert ok
        from ray_tpu_torch.common.ids import PlacementGroupID
        table = placement_group_table()
        assert PlacementGroupID(pg_bin).hex() in table

    def test_node_death_reschedules_pg(self, cluster3):
        # occupy the head node first so the probe group lands off-head
        # (hybrid tie-break prefers row 0 on an empty cluster)
        blocker = placement_group([{"CPU": 2}], strategy="PACK")
        assert blocker.wait(timeout_seconds=10)
        head_row = cluster3.crm.row_of(cluster3.head().node_id)
        assert placement_group_table()[
            blocker.id.hex()]["node_rows"] == [head_row]
        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=10)
        row = placement_group_table()[pg.id.hex()]["node_rows"][0]
        assert row != head_row
        victim = cluster3.crm.id_of(row)
        cluster3.remove_node(victim)
        deadline = time.time() + 10
        state = None
        while time.time() < deadline:
            state = placement_group_table()[pg.id.hex()]
            if state["state"] == "CREATED" and state["node_rows"] and \
                    state["node_rows"][0] != row:
                break
            time.sleep(0.1)
        assert state["state"] == "CREATED"
        assert state["node_rows"][0] != row
        remove_placement_group(pg)

    def test_bad_strategy_and_bundles_rejected(self, cluster3):
        with pytest.raises(ValueError):
            placement_group([{"CPU": 1}], strategy="DIAGONAL")
        with pytest.raises(ValueError):
            placement_group([])
        with pytest.raises(ValueError):
            placement_group([{}])


class TestPlacementGroupEdges:
    def test_task_to_removed_pg_fails(self, cluster3):
        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=10)
        remove_placement_group(pg)

        @ray_tpu_torch.remote
        def f():
            return 1

        ref = f.options(placement_group=pg,
                        placement_group_bundle_index=0).remote()
        with pytest.raises(Exception):
            ray_tpu_torch.get(ref, timeout=20)

    def test_actor_to_removed_pg_fails(self, cluster3):
        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=10)
        remove_placement_group(pg)
        h = Member.options(placement_group=pg).remote()
        with pytest.raises(Exception):
            ray_tpu_torch.get(h.pid.remote(), timeout=20)

    def test_bad_bundle_index_rejected_at_options(self, cluster3):
        pg = placement_group([{"CPU": 1}] * 2, strategy="PACK")

        @ray_tpu_torch.remote
        def f():
            return 1

        with pytest.raises(ValueError):
            f.options(placement_group=pg, placement_group_bundle_index=5)
        with pytest.raises(ValueError):
            f.options(placement_group=pg, placement_group_bundle_index=-2)
        remove_placement_group(pg)

    def test_wait_blocks_again_after_node_death(self, cluster3):
        blocker = placement_group([{"CPU": 2}], strategy="PACK")
        assert blocker.wait(timeout_seconds=10)
        # pg needs a full node: only one of the two non-head nodes fits it
        pg = placement_group([{"CPU": 2}] * 2, strategy="STRICT_SPREAD")
        assert pg.wait(timeout_seconds=10)
        rows = placement_group_table()[pg.id.hex()]["node_rows"]
        head_row = cluster3.crm.row_of(cluster3.head().node_id)
        victim_row = [r for r in rows if r != head_row][0]
        cluster3.remove_node(cluster3.crm.id_of(victim_row))
        # with one node gone there is no second node for the gang:
        # the retracted ready marker must make wait() block again
        assert not pg.wait(timeout_seconds=1.0)
        assert placement_group_table()[pg.id.hex()]["state"] == "PENDING"
        # capacity returns (new node) -> group re-places, wait unblocks
        cluster3.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        assert pg.wait(timeout_seconds=10)

    def test_indexed_and_wildcard_tasks_share_one_reservation(self,
                                                              cluster3):
        """An indexed task consumes the wildcard column too, so a 1-CPU
        bundle cannot run an indexed and a wildcard task concurrently."""
        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(timeout_seconds=10)

        @ray_tpu_torch.remote
        def stamp():
            import time as t
            start = t.time()
            t.sleep(0.8)
            return start, t.time()

        a = stamp.options(placement_group=pg,
                          placement_group_bundle_index=0).remote()
        b = stamp.options(placement_group=pg).remote()
        (sa, ea), (sb, eb) = ray_tpu_torch.get([a, b], timeout=30)
        # serialized: one must start after the other ends (within jitter)
        assert sb >= ea - 0.05 or sa >= eb - 0.05
        remove_placement_group(pg)

    def test_actor_parked_on_pending_pg_fails_on_remove(self, cluster3):
        """Removing a still-PENDING group must wake actors parked on its
        ready marker and fail them (reference: actor creation fails when
        its placement group is removed) — they used to hang forever."""
        from ray_tpu_torch.runtime.serialization import ActorDiedError, RayError
        blocker = placement_group([{"CPU": 2}] * 3,
                                  strategy="STRICT_SPREAD")
        assert blocker.wait(timeout_seconds=10)
        pg = placement_group([{"CPU": 2}], strategy="PACK")
        assert not pg.wait(timeout_seconds=0.3)         # pending
        h = Member.options(placement_group=pg).remote()
        ref = h.pid.remote()                            # parked with actor
        remove_placement_group(pg)                      # while PENDING
        with pytest.raises((ActorDiedError, RayError)):
            ray_tpu_torch.get(ref, timeout=5)
        # pg.ready() must raise, not hang
        with pytest.raises(RayError):
            ray_tpu_torch.get(pg.ready(), timeout=5)
        remove_placement_group(blocker)
