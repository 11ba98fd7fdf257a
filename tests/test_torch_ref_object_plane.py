"""Wire-level object plane: arena-to-arena transfer between node agents.

Scenario sources: upstream's ``ObjectManager`` chunked pull protocol —
payloads move raylet-to-raylet with the GCS carrying only directory
updates (``src/ray/object_manager/object_manager.cc``,
``object_buffer_pool.h`` — SURVEY.md §2.1, §3.3; re-derived, not
copied).  The defining assertions here: payload bytes provably never
transit the head (its RPC byte counters stay far below the payload
volume), agent arenas spill/restore locally, and agent death mid-
workload recovers via lineage.
"""

import os
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime.head import HeadNode
from ray_tpu_torch.runtime.node_agent import NodeAgent

# Port copy of tests/test_object_plane.py: the reference's file with
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


PAYLOAD = 1 << 20       # 1 MiB — far above max_direct_call_object_size


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
def two_agents(head):
    a1 = NodeAgent(head.address, resources={"CPU": 2, "one": 2},
                   num_workers=2)
    a2 = NodeAgent(head.address, resources={"CPU": 2, "two": 2},
                   num_workers=2)
    _wait_nodes(3)
    try:
        yield head, a1, a2
    finally:
        a1.stop()
        a2.stop()
        _wait_nodes(1)


@ray_tpu_torch.remote(resources={"one": 1})
def _produce(i: int):
    return bytes([i]) * PAYLOAD


@ray_tpu_torch.remote(resources={"two": 1})
def _consume(blob, i: int):
    assert blob == bytes([i]) * PAYLOAD
    return len(blob)


@ray_tpu_torch.remote(resources={"two": 1})
def _reduce(*blobs):
    return sum(len(b) for b in blobs)


class TestPayloadsBypassHead:
    def test_shuffle_bytes_never_transit_head(self, two_agents):
        """Map on agent one, reduce on agent two: ~8 MiB of payload
        moves agent-to-agent while the head's RPC plane carries only
        control frames + directory metadata."""
        head, a1, a2 = two_agents
        n = 8
        refs = [_produce.remote(i) for i in range(n)]
        outs = ray_tpu_torch.get([_consume.remote(r, i)
                            for i, r in enumerate(refs)], timeout=120)
        assert outs == [PAYLOAD] * n

        moved = n * PAYLOAD
        head_bytes = head.server.total_bytes()
        # the head saw registration, leases, metadata frames — but NOT
        # the payloads.  Generous bound: a tenth of the moved volume.
        assert head_bytes < moved / 10, (
            f"head carried {head_bytes} wire bytes for {moved} payload "
            f"bytes: {head.server.method_bytes}")
        # the payloads really crossed the plane: agent two received them
        stats2 = a2.plane._op_plane_stats()
        assert stats2["plane_bytes_received"] >= moved
        # and agent one served them (direct source->dest chunks)
        stats1 = a1.plane._op_plane_stats()
        assert stats1["plane_bytes_sent"] >= moved

    def test_fan_in_reduce_across_agents(self, two_agents):
        head, a1, a2 = two_agents
        refs = [_produce.remote(i) for i in range(4)]
        total = ray_tpu_torch.get(_reduce.remote(*refs), timeout=120)
        assert total == 4 * PAYLOAD

    def test_driver_get_pulls_from_agent(self, two_agents):
        """A driver-side get of an agent-born object ingests it into the
        head store over the plane."""
        head, a1, a2 = two_agents
        ref = _produce.remote(7)
        blob = ray_tpu_torch.get(ref, timeout=90)
        assert blob == bytes([7]) * PAYLOAD
        # the head now holds a real local copy (ingested, not remote)
        from ray_tpu_torch.api import _get_runtime
        kind, size = _get_runtime().store.plasma_info(ref.id)
        assert kind in ("shm", "spill") and size >= PAYLOAD

    def test_worker_put_seals_on_agent(self, two_agents):
        """ray.put inside an agent worker seals into the agent arena;
        the head records metadata only."""
        head, a1, a2 = two_agents

        @ray_tpu_torch.remote(resources={"one": 1})
        def putter():
            ref = ray_tpu_torch.put(b"\xab" * PAYLOAD)
            return ref

        @ray_tpu_torch.remote(resources={"two": 1})
        def getter(refs):
            return len(ray_tpu_torch.get(refs[0]))

        ref = ray_tpu_torch.get(putter.remote(), timeout=90)
        assert ray_tpu_torch.get(getter.remote([ref]), timeout=90) == PAYLOAD


class TestAgentSpill:
    def test_agent_arena_spills_and_restores(self, head):
        """An agent whose arena is smaller than the working set spills
        to ITS OWN disk and restores on demand."""
        from ray_tpu_torch.common.config import get_config
        # shrink only the agent's arena: config is process-global, so
        # patch it around the agent's boot (the head cluster already
        # built its own arena at full size)
        cfg = get_config()
        old = cfg.object_store_memory_mb
        cfg.object_store_memory_mb = 8
        try:
            agent = NodeAgent(head.address,
                              resources={"CPU": 2, "one": 2},
                              num_workers=1)
        finally:
            cfg.object_store_memory_mb = old
        _wait_nodes(2)
        try:
            # 12 x 1MiB > 8 MiB arena: spill must kick in on the agent
            refs = [_produce.remote(i) for i in range(12)]
            ray_tpu_torch.wait(refs, num_returns=12, timeout=120)
            stats = agent.store.stats()
            assert stats["spilled_bytes"] > 0, stats
            # every payload still reads back correctly (restore path)
            for i, r in enumerate(refs):
                assert ray_tpu_torch.get(r, timeout=90) == bytes([i]) * PAYLOAD
        finally:
            agent.stop()
            _wait_nodes(1)


class TestAgentLossRecovery:
    def test_agent_death_recovers_objects_via_lineage(self, head):
        """Objects whose only copy died with an agent reconstruct from
        lineage and a dependent get still completes."""
        a1 = NodeAgent(head.address, resources={"CPU": 2, "one": 2},
                       num_workers=1)
        _wait_nodes(2)
        refs = [_produce.remote(i) for i in range(3)]
        ray_tpu_torch.wait(refs, num_returns=3, timeout=90)
        a1.stop()
        _wait_nodes(1)
        # the only copies died with the agent; lineage re-runs _produce,
        # which needs a node with the "one" resource again
        a2 = NodeAgent(head.address, resources={"CPU": 2, "one": 2},
                       num_workers=1)
        _wait_nodes(2)
        try:
            for i, r in enumerate(refs):
                assert ray_tpu_torch.get(r, timeout=120) == \
                    bytes([i]) * PAYLOAD
        finally:
            a2.stop()
            _wait_nodes(1)
