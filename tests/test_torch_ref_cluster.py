"""Simulated multi-node cluster: spillback, routing, node death, device
batch path.

Scenario sources: upstream multi-node scheduling tests against
``cluster_utils.Cluster`` (SURVEY.md §4; scenarios re-derived, not
copied)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_cluster.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable);
# - ``TestShardedKernelParity`` runs on JAX devices in the reference
#   (the virtual 8-device CPU mesh, through ``Raylet._schedule_sharded``).
#   Its counterpart here is the port's sharded wrapper on 8 CPU ranks
#   (``schedule_grouped_sharded_np``, the flat plane that
#   ``_schedule_sharded`` builds) against the single-device call, with
#   the same seed and the same 27 rows that do not divide the ranks:
#   the port's raylet resolves its ranks from the cluster's device, and
#   on the CPU that is one rank, so the raylet's own call would not
#   shard.


@pytest.fixture(scope="module")
def cluster():
    c = Cluster()
    # head: small CPU; two workers nodes with custom resources
    c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
    c.add_node(resources={"CPU": 2, "memory": 2, "custom": 1},
               num_workers=2)
    c.add_node(resources={"CPU": 4, "memory": 2}, num_workers=2)
    ray_tpu_torch.init(cluster=c)
    yield c
    ray_tpu_torch.shutdown()
    c.stop()


@ray_tpu_torch.remote
def whoami():
    import os
    return os.getpid()


@ray_tpu_torch.remote
def padded(x):
    return x + 1


class TestMultiNode:
    def test_cluster_resources_aggregate(self, cluster):
        res = ray_tpu_torch.cluster_resources()
        assert res["CPU"] == 8.0
        assert res["custom"] == 1.0
        assert len(ray_tpu_torch.nodes()) == 3

    def test_tasks_spill_across_nodes(self, cluster):
        # 8 concurrent 1-CPU holds need all three nodes
        @ray_tpu_torch.remote
        def hold():
            time.sleep(0.6)
            import os
            return os.getpid()

        t0 = time.time()
        pids = ray_tpu_torch.get([hold.remote() for _ in range(8)])
        elapsed = time.time() - t0
        assert elapsed < 2.4, elapsed          # ran in parallel across nodes
        assert len(set(pids)) >= 4             # multiple worker processes

    def test_custom_resource_routes_to_owner(self, cluster):
        @ray_tpu_torch.remote(resources={"custom": 1}, num_cpus=1)
        def custom_task():
            import os
            return os.getpid()

        # runs (only node 1 has 'custom'); infeasible elsewhere
        assert isinstance(ray_tpu_torch.get(custom_task.remote(), timeout=30), int)

    def test_infeasible_task_parks(self, cluster):
        @ray_tpu_torch.remote(resources={"no_such_resource": 1})
        def impossible():
            return 1

        ref = impossible.remote()
        ready, not_ready = ray_tpu_torch.wait([ref], num_returns=1, timeout=1.0)
        assert not ready and not_ready == [ref]

    def test_actor_placement_with_resources(self, cluster):
        @ray_tpu_torch.remote
        class Pinned:
            def where(self):
                import os
                return os.getpid()

        h = Pinned.options(resources={"custom": 1}).remote()
        assert isinstance(ray_tpu_torch.get(h.where.remote(), timeout=30), int)
        ray_tpu_torch.kill(h)

    def test_device_batch_path_places_all(self, cluster):
        from ray_tpu_torch.common.config import Config
        # push the batch through the TPU/XLA kernel path
        cfg = Config.instance()
        old = cfg.scheduler_device_batch_min
        cfg.scheduler_device_batch_min = 8
        try:
            refs = [padded.remote(i) for i in range(64)]
            assert ray_tpu_torch.get(refs, timeout=60) == [i + 1 for i in range(64)]
        finally:
            cfg.scheduler_device_batch_min = old

    def test_sharded_state_live_path(self, cluster):
        """The live scheduler with cluster-state rows sharded over the
        8-device virtual mesh (scheduler_sharded_state): placements
        run as one sharded XLA program and every task completes."""
        from ray_tpu_torch.common.config import Config
        cfg = Config.instance()
        old_min = cfg.scheduler_device_batch_min
        cfg.scheduler_device_batch_min = 8
        cfg.scheduler_sharded_state = True
        try:
            refs = [padded.remote(i) for i in range(64)]
            assert ray_tpu_torch.get(refs, timeout=60) == \
                [i + 1 for i in range(64)]
        finally:
            cfg.scheduler_device_batch_min = old_min
            cfg.scheduler_sharded_state = False


class TestShardedKernelParity:
    def test_sharded_counts_match_single_device(self):
        """The sharded layout (rows over the mesh, pad rows masked off)
        returns bit-identical counts to the single-device call — the
        live-path analogue of dryrun_multichip's oracle check, with a
        node count that does NOT divide the mesh (pad rows exercised)."""
        import numpy as np

        from ray_tpu_torch.ops import (schedule_grouped_np,
                                       schedule_grouped_sharded_np)
        from ray_tpu_torch.ops.shard_reduce import gspmd_plane
        from ray_tpu_torch.scheduling.contract import threshold_fp

        rng = np.random.default_rng(0)
        n, width, gp = 27, 4, 8           # 27 % 8 devices != 0
        totals = rng.integers(400, 6400, size=(n, width)).astype(np.int32)
        avail = (totals * rng.random((n, width))).astype(np.int32)
        mask = np.ones(n, dtype=bool)
        req = rng.integers(0, 300, size=(gp, width)).astype(np.int32)
        cnt = rng.integers(0, 50, size=gp).astype(np.int32)
        gmask = np.ones((gp, n), dtype=bool)

        single, _ = schedule_grouped_np(
            totals, avail, mask, req, cnt, gmask,
            thr_fp=threshold_fp(None), device="cpu")

        ranks = ["cpu"] * 8               # the virtual mesh's 8 devices
        sharded, _ = schedule_grouped_sharded_np(
            totals, avail, mask, req, cnt, gmask,
            thr_fp=threshold_fp(None), reduce_mode="flat", devices=ranks)
        np.testing.assert_array_equal(np.asarray(single),
                                      np.asarray(sharded))
        # the mesh must really have been multi-shard for this to prove
        # anything (exact count depends on the backend)
        assert gspmd_plane(0, "flat", ranks).n_shards >= 2


class TestNodeArrival:
    def test_add_node_wakes_parked_infeasible_tasks(self):
        """A task parked as infeasible must run once a node with the
        required resource joins (reference: node arrival triggers
        rescheduling on every raylet)."""
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(cluster=c)
        try:
            @ray_tpu_torch.remote(resources={"GPU": 1})
            def needs_gpu():
                return "ran"

            ref = needs_gpu.remote()
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0.5)
            assert not ready                     # parked: no GPU anywhere
            c.add_node(resources={"CPU": 1, "GPU": 1}, num_workers=1)
            assert ray_tpu_torch.get(ref, timeout=30) == "ran"
        finally:
            ray_tpu_torch.shutdown()
            c.stop()
