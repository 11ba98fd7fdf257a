"""Unit tests for ray_tpu_torch.common (ids, resources, config, task spec)."""

import numpy as np
import pytest

from ray_tpu_torch.common import (ActorID, Config, JobID, NodeID, ObjectID, TaskID,
                            NodeResources, ResourceIndex, ResourceRequest,
                            SchedulingStrategy, SchedulingStrategyKind,
                            TaskSpec, TaskType, to_cu, from_cu)
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_common.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


class TestIds:
    def test_roundtrip_and_equality(self):
        n = NodeID.from_random()
        assert NodeID.from_hex(n.hex()) == n
        assert len(n.binary()) == 16
        assert n != NodeID.from_random()

    def test_structured_derivation(self):
        job = JobID.from_int(7)
        actor = ActorID.of(job)
        assert actor.job_id() == job
        task = TaskID.for_task(job, actor)
        assert task.actor_id() == actor
        assert task.job_id() == job
        ref = ObjectID.for_task_return(task, 1)
        assert ref.task_id() == task
        assert ref.index() == 1
        assert not ref.is_put()
        put = ObjectID.for_put(task, 3)
        assert put.is_put()

    def test_nil(self):
        assert NodeID.nil().is_nil()
        assert not NodeID.from_random().is_nil()

    def test_immutability_and_hash(self):
        n = NodeID.from_random()
        with pytest.raises(AttributeError):
            n._bin = b"x" * 16
        assert len({n, NodeID(n.binary())}) == 1


class TestResources:
    def test_cu_quantization(self):
        assert to_cu(1) == 100
        assert to_cu(0.5) == 50
        assert to_cu(0.004) == 0      # below granularity rounds to 0
        assert to_cu(0.005) == 1
        assert from_cu(150) == 1.5
        with pytest.raises(ValueError):
            to_cu(-1)
        with pytest.raises(ValueError):
            to_cu(10_000_000)          # over the int32-safety cap

    def test_request_identity_is_scheduling_class(self):
        a = ResourceRequest({"CPU": 1, "GPU": 0.5})
        b = ResourceRequest({"GPU": 0.5, "CPU": 1.0})
        c = ResourceRequest({"CPU": 1})
        assert a == b and hash(a) == hash(b)
        assert a != c
        # zero entries are dropped
        assert ResourceRequest({"CPU": 1, "GPU": 0}) == c

    def test_dense_vector(self):
        idx = ResourceIndex()
        req = ResourceRequest({"CPU": 2, "custom": 1})
        vec = req.dense(idx)
        assert vec[idx.get("CPU")] == 200
        assert vec[idx.get("custom")] == 100

    def test_node_resources_alloc_free(self):
        nr = NodeResources({"CPU": 4, "memory": 8})
        req = ResourceRequest({"CPU": 2})
        assert nr.is_feasible(req) and nr.is_available(req)
        assert nr.allocate(req) and nr.allocate(req)
        assert not nr.allocate(req)
        assert nr.is_feasible(req) and not nr.is_available(req)
        nr.free(req)
        assert nr.is_available(req)
        # free never exceeds total
        nr.free(req)
        nr.free(req)
        assert nr.available_cu["CPU"] == nr.total_cu["CPU"]


class TestConfig:
    def test_defaults_and_overrides(self):
        c = Config.reset()
        assert c.scheduler_spread_threshold == 0.5
        c = Config.reset({"scheduler_spread_threshold": 0.7,
                          "scheduler_top_k_absolute": "4"})
        assert c.scheduler_spread_threshold == 0.7
        assert c.scheduler_top_k_absolute == 4

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("RT_SCHEDULER_SPREAD_THRESHOLD", "0.25")
        c = Config.reset()
        assert c.scheduler_spread_threshold == 0.25
        # explicit system_config wins over env
        c = Config.reset({"scheduler_spread_threshold": 0.9})
        assert c.scheduler_spread_threshold == 0.9

    def test_unknown_key_rejected(self):
        with pytest.raises(ValueError):
            Config.reset({"no_such_knob": 1})


class TestTaskSpec:
    def test_scheduling_class_groups_equal_specs(self):
        job = JobID.from_int(1)
        mk = lambda cpus: TaskSpec(
            task_id=TaskID.for_task(job), job_id=job,
            task_type=TaskType.NORMAL_TASK, function_descriptor="m:f",
            resources=ResourceRequest({"CPU": cpus}))
        assert mk(1).scheduling_class() == mk(1).scheduling_class()
        assert mk(1).scheduling_class() != mk(2).scheduling_class()

    def test_strategy_in_class(self):
        job = JobID.from_int(1)
        s1 = SchedulingStrategy(SchedulingStrategyKind.SPREAD)
        a = TaskSpec(task_id=TaskID.for_task(job), job_id=job,
                     task_type=TaskType.NORMAL_TASK, function_descriptor="m:f",
                     strategy=s1)
        b = TaskSpec(task_id=TaskID.for_task(job), job_id=job,
                     task_type=TaskType.NORMAL_TASK, function_descriptor="m:f")
        assert a.scheduling_class() != b.scheduling_class()
