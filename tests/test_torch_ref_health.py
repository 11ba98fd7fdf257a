"""Automatic failure detection: the health-check manager detects dead
nodes and drives the drain without anyone calling remove_node.

Scenario sources: upstream ``gcs_health_check_manager_test.cc``
behavioral contract — consecutive miss counting, threshold-driven death
declaration, recovery of in-flight work (SURVEY.md §5.3; scenarios
re-derived, not copied)."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.common.config import Config
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_health.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


def _wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


class TestHealthChecks:
    def test_wiped_worker_pool_detected_and_drained(self):
        """Chaos: SIGKILL every worker process on a node AND break its
        respawn.  The health loop must declare the node dead, drain it,
        and the cluster must finish the workload elsewhere — the test
        never calls remove_node."""
        Config.reset({"health_check_period_ms": 100,
                      "health_check_failure_threshold": 3})
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
        doomed = c.add_node(resources={"CPU": 2, "memory": 2},
                            num_workers=2)
        ray_tpu_torch.init(cluster=c)
        try:
            victim = c.raylets[c.crm.row_of(doomed)]

            @ray_tpu_torch.remote(max_retries=3)
            def job(i):
                time.sleep(0.3)
                return i * 5

            refs = [job.remote(i) for i in range(8)]
            time.sleep(0.15)            # let some land on the victim
            # chaos: break respawn, then kill every worker process
            victim.pool._spawn_one = lambda *a, **k: None
            with victim.pool._lock:
                handles = list(victim.pool._workers)
            for h in handles:
                if h.proc.is_alive():
                    h.proc.kill()
            # detection + drain, no remove_node call anywhere
            assert _wait_until(lambda: doomed not in
                               [r.node_id for r in c.raylets.values()],
                               timeout=20), "health loop never drained"
            assert c.health.num_detected == 1
            assert ray_tpu_torch.get(refs, timeout=60) == \
                [i * 5 for i in range(8)]
        finally:
            ray_tpu_torch.shutdown()
            c.stop()

    def test_healthy_idle_node_is_never_flagged(self):
        """An idle raylet (loop parked in cv.wait) must pass every probe:
        pong-vs-ping comparison, not wall-clock age."""
        Config.reset({"health_check_period_ms": 50,
                      "health_check_failure_threshold": 2})
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        try:
            time.sleep(1.0)             # ~20 probe rounds while fully idle
            assert len(c.raylets) == 2
            assert c.health.num_detected == 0
        finally:
            c.stop()

    def test_transient_worker_death_is_not_fatal(self):
        """One worker dying (pool respawns) must not count far enough to
        declare the node dead."""
        Config.reset({"health_check_period_ms": 50,
                      "health_check_failure_threshold": 3})
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=2)
        second = c.add_node(resources={"CPU": 2, "memory": 2},
                            num_workers=2)
        ray_tpu_torch.init(cluster=c)
        try:
            raylet = c.raylets[c.crm.row_of(second)]
            with raylet.pool._lock:
                h = raylet.pool._workers[0]
            h.proc.kill()               # respawn path stays intact
            time.sleep(0.6)
            assert len(c.raylets) == 2
            assert c.health.num_detected == 0
        finally:
            ray_tpu_torch.shutdown()
            c.stop()

    def test_suspect_tracking_for_unresponsive_loop(self):
        """A wedged scheduling loop turns the node 'suspect' in stats but
        is not removed (in-process a long jit compile is
        indistinguishable from a hang — see health.py docstring)."""
        Config.reset({"health_check_period_ms": 50,
                      "health_check_failure_threshold": 2})
        c = Cluster()
        c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=1)
        second = c.add_node(resources={"CPU": 2, "memory": 2},
                            num_workers=1)
        ray_tpu_torch.init(cluster=c)
        try:
            victim = c.raylets[c.crm.row_of(second)]
            gate = time.sleep
            victim._place_batch = lambda batch: gate(3600) or []
            victim._enqueue(None)       # wakes the loop into the wedge
            assert _wait_until(
                lambda: (c.health.check_once() is not None and
                         c.health.stats()["num_suspect"] >= 1), timeout=10)
            assert len(c.raylets) == 2  # suspect, not removed
        finally:
            ray_tpu_torch.shutdown()
            c.stop()
