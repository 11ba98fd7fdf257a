"""Node-label scheduling, top-k sampling, and lease-timeout spillback.

Scenario sources: upstream ``NodeLabelSchedulingStrategy`` hard/soft
semantics, ``scheduler_top_k_fraction`` sampling, and worker-lease
retry/spillback (SURVEY.md §1 layer 5; scenarios re-derived, not
copied)."""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.common.config import Config
from ray_tpu_torch.scheduling.contract import threshold_fp
from ray_tpu_torch.scheduling.oracle import ClusterState
from ray_tpu_torch.scheduling.policy import (CompositeSchedulingPolicy,
                                       SchedulingOptions, SchedulingType)
from ray_tpu_torch.util.scheduling_strategies import NodeLabelSchedulingStrategy
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_label_scheduling.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


def _row_of_pid(cluster, pid):
    for row, raylet in cluster.raylets.items():
        with raylet.pool._lock:
            if any(h.proc.pid == pid for h in raylet.pool._workers):
                return row
    return None


class TestNodeLabelPolicy:
    def _state(self):
        totals = np.full((4, 2), 400, dtype=np.int32)
        return ClusterState(totals, totals.copy())

    def test_hard_selector_restricts(self):
        policy = CompositeSchedulingPolicy()
        state = self._state()
        mask = np.array([False, False, True, False])
        req = np.array([100, 0], dtype=np.int32)
        opts = SchedulingOptions(scheduling_type=SchedulingType.NODE_LABEL,
                                 node_mask=mask)
        assert policy.schedule(state, req, opts) == 2

    def test_hard_selector_no_match_parks(self):
        policy = CompositeSchedulingPolicy()
        state = self._state()
        opts = SchedulingOptions(scheduling_type=SchedulingType.NODE_LABEL,
                                 node_mask=np.zeros(4, dtype=bool))
        assert policy.schedule(state, req=np.array([100, 0],
                                                   dtype=np.int32),
                               options=opts) == -1

    def test_soft_selector_falls_back(self):
        policy = CompositeSchedulingPolicy()
        state = self._state()
        opts = SchedulingOptions(scheduling_type=SchedulingType.NODE_LABEL,
                                 node_mask=np.zeros(4, dtype=bool),
                                 soft=True)
        node = policy.schedule(state, np.array([100, 0], dtype=np.int32),
                               opts)
        assert node >= 0


class TestLabelEndToEnd:
    def test_task_lands_on_labeled_node(self):
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2,
                   labels={"zone": "us-east", "accel": "v5e"})
        ray_tpu_torch.init(cluster=c)
        try:
            labeled_row = next(
                row for row in c.raylets
                if c.crm.labels_of(row).get("accel") == "v5e")

            @ray_tpu_torch.remote
            def whoami():
                return os.getpid()

            strat = NodeLabelSchedulingStrategy(hard={"accel": "v5e"})
            pids = ray_tpu_torch.get(
                [whoami.options(scheduling_strategy=strat).remote()
                 for _ in range(4)], timeout=30)
            for pid in pids:
                assert _row_of_pid(c, pid) == labeled_row
        finally:
            ray_tpu_torch.shutdown()
            c.stop()

    def test_unmatched_hard_selector_parks_until_node_arrives(self):
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
        ray_tpu_torch.init(cluster=c)
        try:
            @ray_tpu_torch.remote
            def f():
                return "ran"

            strat = NodeLabelSchedulingStrategy(hard={"pool": "gold"})
            ref = f.options(scheduling_strategy=strat).remote()
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=0.5)
            assert ready == []          # parked: no gold node exists
            c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1,
                       labels={"pool": "gold"})
            assert ray_tpu_torch.get(ref, timeout=30) == "ran"
        finally:
            ray_tpu_torch.shutdown()
            c.stop()


class TestTopKSampling:
    def test_disabled_is_argmin_parity(self):
        Config.reset({"scheduler_top_k_fraction": 0.0})
        policy = CompositeSchedulingPolicy()
        totals = np.full((8, 1), 800, dtype=np.int32)
        state = ClusterState(totals, totals.copy())
        req = np.array([100], dtype=np.int32)
        rows = [policy.schedule(
            ClusterState(totals, totals.copy()), req, SchedulingOptions())
            for _ in range(8)]
        assert rows == [0] * 8          # deterministic argmin

    def test_sampling_spreads_and_replays(self):
        totals = np.full((8, 1), 800, dtype=np.int32)
        req = np.array([100], dtype=np.int32)

        def run():
            Config.reset({"scheduler_top_k_fraction": 0.5})
            policy = CompositeSchedulingPolicy()
            state = ClusterState(totals, totals.copy())
            return [policy.schedule(state, req, SchedulingOptions())
                    for _ in range(32)]

        a, b = run(), run()
        assert a == b                   # pinned Philox stream replays
        assert len(set(a)) > 1          # sampling actually spreads
        assert all(r >= 0 for r in a)

    def test_top_k_routes_batches_to_host_policy(self):
        Config.reset({"scheduler_top_k_fraction": 0.5,
                      "scheduler_device_batch_min": 1})
        c = Cluster()
        c.add_node(resources={"CPU": 4, "memory": 4}, num_workers=2)
        ray_tpu_torch.init(cluster=c)
        try:
            @ray_tpu_torch.remote
            def f(i):
                return i + 1

            assert sorted(ray_tpu_torch.get([f.remote(i) for i in range(6)],
                                      timeout=30)) == list(range(1, 7))
        finally:
            ray_tpu_torch.shutdown()
            c.stop()


class TestLeaseTimeoutSpillback:
    def test_stale_lease_spills_to_other_node(self):
        """Node A has spare RESOURCES but a wedged worker pool; past the
        lease timeout its placed tasks must re-place onto node B."""
        Config.reset({"worker_lease_timeout_ms": 300,
                      "locality_aware_scheduling": False})
        c = Cluster()
        a = c.add_node(resources={"CPU": 8, "memory": 8}, num_workers=1)
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
        ray_tpu_torch.init(cluster=c)
        try:
            raylet_a = c.raylets[c.crm.row_of(a)]

            @ray_tpu_torch.remote
            def block(path):
                import os
                import time as _t
                while not os.path.exists(path):
                    _t.sleep(0.05)
                return "done"

            @ray_tpu_torch.remote
            def quick(i):
                return i * 2

            import tempfile
            gate = os.path.join(tempfile.mkdtemp(), "gate")
            # A's single worker wedges on the gate; A (row 0, most free
            # CPU) keeps winning default placement for the quick tasks
            from ray_tpu_torch.util.scheduling_strategies import (
                NodeAffinitySchedulingStrategy)
            blocker = block.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=a, soft=False)).remote(gate)
            time.sleep(0.2)
            refs = [quick.remote(i) for i in range(4)]
            # the lease timeout must spill them AWAY from A (avoid-local
            # re-placement) onto B, where they finish while A's worker is
            # still wedged
            assert sorted(ray_tpu_torch.get(refs, timeout=30)) == \
                [0, 2, 4, 6]
            open(gate, "w").close()
            assert ray_tpu_torch.get(blocker, timeout=30) == "done"
        finally:
            ray_tpu_torch.shutdown()
            c.stop()
