"""Node-death recovery on the simulated cluster (own module: needs a
fresh runtime, and test_cluster.py holds a module-scoped one)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_cluster_failure.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


class TestNodeFailure:
    def test_remove_node_retries_elsewhere(self):
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
        doomed = c.add_node(resources={"CPU": 2, "memory": 2},
                            num_workers=2)
        ray_tpu_torch.init(cluster=c)
        try:
            @ray_tpu_torch.remote(max_retries=2)
            def slowish(x):
                time.sleep(0.4)
                return x * 2

            refs = [slowish.remote(i) for i in range(8)]
            time.sleep(0.1)
            c.remove_node(doomed)
            assert ray_tpu_torch.get(refs, timeout=60) == \
                [i * 2 for i in range(8)]
            assert len(ray_tpu_torch.nodes()) == 1
        finally:
            ray_tpu_torch.shutdown()
            c.stop()


class TestHardAffinityToDeadNode:
    def test_fails_fast_instead_of_parking(self):
        """A HARD NodeAffinity task whose target node no longer exists
        fails loudly as unschedulable (reference semantics) — both a
        fresh submit and a lineage-recovery resubmit; parking forever
        would hang every waiter."""
        from ray_tpu_torch.cluster_utils import Cluster
        from ray_tpu_torch.runtime.serialization import RayTaskError
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        n2 = c.add_node(resources={"CPU": 2, "memory": 2},
                        num_workers=1)
        ray_tpu_torch.init(cluster=c)
        try:
            @ray_tpu_torch.remote
            def produce():
                return bytes(300_000)

            pinned = produce.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    n2, soft=False))
            ref = pinned.remote()
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=60)
            assert ready, "producer never sealed on n2"
            c.remove_node(n2)
            # the sole copy died with the node; recovery resubmits the
            # retryable task, whose hard pin now names a dead node
            with pytest.raises(Exception) as ei:
                ray_tpu_torch.get(ref, timeout=30)
            assert "dead or unknown node" in str(ei.value) \
                or "lost" in str(ei.value), ei.value
            # a FRESH submit pinned to the dead node fails fast too
            ref2 = pinned.remote()
            with pytest.raises(RayTaskError, match="dead or unknown"):
                ray_tpu_torch.get(ref2, timeout=30)
        finally:
            ray_tpu_torch.shutdown()
            c.stop()

    def test_parked_pin_fails_when_target_dies_later(self):
        """A hard-pinned task parked because its target node is FULL
        must fail fast when that node later DIES — node removal wakes
        surviving raylets so parked queues re-reach placement."""
        import time as _time

        from ray_tpu_torch.cluster_utils import Cluster
        from ray_tpu_torch.runtime.serialization import RayTaskError
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy)
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        n2 = c.add_node(resources={"CPU": 1, "memory": 1},
                        num_workers=1)
        ray_tpu_torch.init(cluster=c)
        try:
            @ray_tpu_torch.remote
            def hold(dt):
                _time.sleep(dt)
                return "held"

            @ray_tpu_torch.remote(resources={"CPU": 1, "memory": 1})
            def wants_n2():
                return "ran"

            # fill n2 completely so the pinned task parks infeasible
            blocker = hold.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    n2, soft=False)).remote(3600)
            _time.sleep(0.5)
            parked = wants_n2.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    n2, soft=False)).remote()
            _time.sleep(0.5)        # let it park behind the full node
            c.remove_node(n2)
            with pytest.raises(Exception) as ei:
                ray_tpu_torch.get(parked, timeout=30)
            assert "dead or unknown" in str(ei.value) \
                or "node" in str(ei.value), ei.value
            del blocker
        finally:
            ray_tpu_torch.shutdown()
            c.stop()
