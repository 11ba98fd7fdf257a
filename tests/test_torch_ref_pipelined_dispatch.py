"""Pipelined worker leases: throughput path + recall correctness.

Scenario sources: upstream lease reuse — submitters pipeline tasks onto
cached worker leases (SURVEY.md §3.2); committed-but-unsent tasks must
be recallable on blocking gets (deadlock avoidance), cancellation, and
worker death (scenarios re-derived, not copied)."""

import time

import pytest

import ray_tpu_torch
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_pipelined_dispatch.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


class TestPipelining:
    def test_throughput_batch(self):
        ray_tpu_torch.init(resources={"CPU": 8, "memory": 8}, num_workers=4)
        try:
            @ray_tpu_torch.remote
            def noop(i):
                return i

            out = ray_tpu_torch.get([noop.remote(i) for i in range(500)],
                              timeout=60)
            assert out == list(range(500))
        finally:
            ray_tpu_torch.shutdown()

    def test_blocked_parent_does_not_deadlock_child(self):
        # ONE worker: the child must not stay parked behind its blocked
        # parent in the pipelined queue — entering a blocking get
        # recalls queued tasks and the pool grows a replacement
        ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=1)
        try:
            @ray_tpu_torch.remote
            def child():
                return "child-ran"

            @ray_tpu_torch.remote
            def parent():
                return ray_tpu_torch.get(child.remote(), timeout=30)

            assert ray_tpu_torch.get([parent.remote() for _ in range(3)],
                               timeout=60) == ["child-ran"] * 3
        finally:
            ray_tpu_torch.shutdown()

    def test_cancel_assigned_task(self):
        ray_tpu_torch.init(resources={"CPU": 2, "memory": 2}, num_workers=1)
        try:
            from ray_tpu_torch.runtime.serialization import TaskCancelledError

            @ray_tpu_torch.remote
            def slow():
                time.sleep(1.0)
                return "slow-done"

            @ray_tpu_torch.remote
            def queued():
                return "queued-ran"

            slow_ref = slow.remote()
            time.sleep(0.1)             # slow occupies the one worker
            victim = queued.remote()    # committed to the soft queue
            time.sleep(0.1)
            ray_tpu_torch.cancel(victim)
            with pytest.raises(TaskCancelledError):
                ray_tpu_torch.get(victim, timeout=30)
            assert ray_tpu_torch.get(slow_ref, timeout=30) == "slow-done"
        finally:
            ray_tpu_torch.shutdown()

    def test_worker_death_requeues_assigned(self):
        ray_tpu_torch.init(resources={"CPU": 2, "memory": 2}, num_workers=1)
        try:
            import os

            @ray_tpu_torch.remote(max_retries=1)
            def die():
                os._exit(1)

            @ray_tpu_torch.remote
            def after():
                return "survived"

            dead = die.remote()
            time.sleep(0.05)
            ref = after.remote()        # likely queued behind the dying
            from ray_tpu_torch.runtime.serialization import WorkerCrashedError
            with pytest.raises(Exception):
                ray_tpu_torch.get(dead, timeout=60)
            assert ray_tpu_torch.get(ref, timeout=60) == "survived"
        finally:
            ray_tpu_torch.shutdown()

    def test_depth_one_disables(self):
        ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2,
                     system_config={"worker_pipeline_depth": 1})
        try:
            @ray_tpu_torch.remote
            def f(i):
                return i * 3

            assert ray_tpu_torch.get([f.remote(i) for i in range(50)],
                               timeout=60) == [i * 3 for i in range(50)]
        finally:
            ray_tpu_torch.shutdown()
