"""The port's runtime on one host: init/remote/get/put/wait and actors.

Scenario sources: ``tests/test_runtime.py`` and ``tests/test_actors.py``
(the JAX package's), run against ``ray_tpu_torch`` with the raylet's
placement programs on the CPU (``scheduler_device="cpu"``) and every
round on the device path (``scheduler_device_batch_min=1``).  Then: the
GPU is required unless the caller asks for the CPU; workers import no
torch and see no GPU; locality lands on the data node; and the raylet's
placement of one seeded batch equals the JAX package's raylet's, row for
row, on the same cluster.

Both packages' ``Config`` read ``RT_*`` environment variables and the
worker pool exports them while it spawns, so the two runtimes never run
at once here: each test class starts and stops its own.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.common.config import Config as PortConfig
from ray_tpu_torch.runtime.object_store import GetTimeoutError
from ray_tpu_torch.runtime.serialization import ActorDiedError

CPU_CONFIG = {"scheduler_device": "cpu", "scheduler_device_batch_min": 1}


@pytest.fixture(scope="class")
def runtime():
    rt.init(resources={"CPU": 4, "memory": 4}, num_workers=4,
            system_config=dict(CPU_CONFIG))
    yield
    rt.shutdown()
    PortConfig.reset()


@rt.remote
def add(a, b):
    return a + b


@rt.remote
def echo(x):
    return x


@rt.remote
def fail():
    raise ValueError("boom")


@rt.remote(num_returns=2)
def two():
    return 1, 2


@rt.remote
def nested(n):
    if n <= 0:
        return 0
    return rt.get(nested.remote(n - 1)) + 1


@rt.remote
def worker_view():
    import os
    import sys
    return "torch" in sys.modules, os.environ.get("CUDA_VISIBLE_DEVICES")


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def value(self):
        return self.n

    def boom(self):
        raise RuntimeError("actor boom")

    def crash(self):
        import os
        os._exit(1)


@pytest.mark.usefixtures("runtime")
class TestBasics:
    def test_put_get_roundtrip(self):
        assert rt.get(rt.put([1, 2, 3])) == [1, 2, 3]

    def test_remote_call(self):
        assert rt.get(add.remote(2, 3)) == 5

    def test_many_tasks(self):
        refs = [add.remote(i, i) for i in range(200)]
        assert rt.get(refs) == [2 * i for i in range(200)]

    def test_numpy_payload(self):
        x = np.arange(1000).reshape(10, 100)
        np.testing.assert_array_equal(rt.get(echo.remote(x)), x)

    def test_ref_as_arg_resolves(self):
        assert rt.get(add.remote(add.remote(1, 2), 10)) == 13

    def test_num_returns(self):
        r1, r2 = two.remote()
        assert rt.get([r1, r2]) == [1, 2]

    def test_task_error_propagates(self):
        with pytest.raises(ValueError, match="boom"):
            rt.get(fail.remote())

    def test_error_propagates_through_deps(self):
        with pytest.raises(ValueError, match="boom"):
            rt.get(add.remote(fail.remote(), 1))

    def test_wait(self):
        @rt.remote
        def slow():
            time.sleep(5)
            return 1

        fast_ref, slow_ref = add.remote(0, 1), slow.remote()
        ready, not_ready = rt.wait([fast_ref, slow_ref], num_returns=1,
                                   timeout=3)
        assert ready == [fast_ref] and not_ready == [slow_ref]

    def test_get_timeout(self):
        @rt.remote
        def slow2():
            time.sleep(10)

        with pytest.raises(GetTimeoutError):
            rt.get(slow2.remote(), timeout=0.2)

    def test_nested_tasks(self):
        assert rt.get(nested.remote(3)) == 3

    def test_cluster_resources(self):
        assert rt.cluster_resources()["CPU"] == 4.0
        assert len(rt.nodes()) == 1

    def test_rounds_took_the_device_path(self):
        from ray_tpu_torch.api import _get_runtime
        head = _get_runtime().raylet
        d0 = head.delta_rounds
        rt.get([add.remote(i, 1) for i in range(50)])
        assert head.device_rounds > 0
        assert head.delta_rounds > d0          # uniform: the delta beat
        assert _get_runtime().cluster.scheduler_device.type == "cpu"

    def test_workers_import_no_torch_and_see_no_gpu(self):
        has_torch, visible = rt.get(worker_view.remote())
        assert not has_torch
        assert visible == ""


@pytest.mark.usefixtures("runtime")
class TestActors:
    def test_create_and_call(self):
        c = Counter.remote()
        assert rt.get(c.incr.remote()) == 1
        assert rt.get(c.incr.remote(5)) == 6

    def test_ordering_is_fifo(self):
        c = Counter.remote()
        assert rt.get([c.incr.remote() for _ in range(50)]) == \
            list(range(1, 51))

    def test_method_error_propagates(self):
        c = Counter.remote()
        with pytest.raises(RuntimeError, match="actor boom"):
            rt.get(c.boom.remote())
        assert rt.get(c.incr.remote()) == 1

    def test_ref_args_to_actor(self):
        c = Counter.remote()
        assert rt.get(c.incr.remote(rt.put(7))) == 7

    def test_actor_death_fails_calls(self):
        c = Counter.remote()
        rt.get(c.incr.remote())
        with pytest.raises((ActorDiedError, Exception)):
            rt.get(c.crash.remote(), timeout=20)
        with pytest.raises(Exception):
            rt.get(c.incr.remote(), timeout=20)


def test_init_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            rt.init(resources={"CPU": 1, "memory": 1}, num_workers=0)
        assert not rt.is_initialized()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            rt.init(address="127.0.0.1:1")
    finally:
        PortConfig.reset()


def test_locality_lands_on_the_data_node():
    """A device-path batch with plasma args runs in the data-holding
    node's workers (tests/test_device_scheduling.py's scenario)."""
    rt.init(resources={"CPU": 4, "memory": 4}, num_workers=2,
            system_config=dict(CPU_CONFIG))
    try:
        from ray_tpu_torch.api import _get_runtime
        from ray_tpu_torch.ops import locality_kernel
        runtime = _get_runtime()
        cluster = runtime.cluster
        n2 = cluster.add_node(resources={"CPU": 4, "memory": 4},
                              num_workers=2)
        blob = rt.put(bytes(300_000))
        home = runtime.raylet.row        # driver puts are born on the head

        @rt.remote
        def consume(b):
            import os
            return os.getpid()

        calls = []
        real = locality_kernel.schedule_grouped_localized

        def spy(*a, **k):
            calls.append(1)
            return real(*a, **k)

        locality_kernel.schedule_grouped_localized = spy
        try:
            pids = set(rt.get([consume.remote(blob) for _ in range(6)],
                              timeout=90))
        finally:
            locality_kernel.schedule_grouped_localized = real
        home_pool = cluster.raylets[home].pool
        with home_pool._lock:
            home_pids = {h.proc.pid for h in home_pool._workers}
        assert pids <= home_pids, (pids, home_pids)
        assert calls, "the localized program never ran"
        cluster.remove_node(n2)
    finally:
        rt.shutdown()
        PortConfig.reset()


# -- the raylet's placement, port vs reference ------------------------------

def _specs(pkg, rng, n_specs, n_classes):
    """Seeded default-strategy specs of ``pkg`` (either package) over
    ``n_classes`` resource classes."""
    ids = pkg.common.ids
    ts = pkg.common.task_spec
    res = pkg.common.resources
    job = ids.JobID.from_int(7)
    classes = [res.ResourceRequest({"CPU": int(rng.integers(1, 4)),
                                    "memory": int(rng.integers(0, 3))})
               for _ in range(n_classes)]
    picks = rng.integers(0, n_classes, size=n_specs)
    return [ts.TaskSpec(task_id=ids.TaskID.for_task(job),
                        job_id=job, task_type=ts.TaskType.NORMAL_TASK,
                        function_descriptor="m:f",
                        resources=classes[int(c)]) for c in picks]


class _Rec:
    def __init__(self, spec):
        self.spec = spec


def _raylet_rows(pkg, cluster_mod, node_res, batches_of):
    """Build ``pkg``'s Cluster with ``node_res`` (no workers), run each
    seeded batch through the head raylet's ``_schedule_rows_soft``, and
    return the rows of every batch."""
    cluster = cluster_mod.Cluster()
    try:
        for r in node_res:
            cluster.add_node(resources=r, num_workers=0)
        head = cluster.head()
        out = []
        for specs, prefs, avoids in batches_of(pkg):
            by_id = {s.task_id: p for s, p in zip(specs, prefs)}
            head._locality_row = lambda spec, by_id=by_id: by_id[spec.task_id]
            head._avoid_local.update(s.task_id for s, a in zip(specs, avoids)
                                     if a)
            out.append(head._schedule_rows_soft([_Rec(s) for s in specs]))
        return out, head
    finally:
        cluster.stop()


def test_raylet_rows_equal_the_reference_raylet():
    import ray_tpu
    import ray_tpu.cluster_utils as ref_cluster
    import ray_tpu_torch.cluster_utils as port_cluster
    from ray_tpu.common.config import Config as RefConfig
    from ray_tpu_torch.ops import locality_kernel

    rng = np.random.default_rng(0)
    node_res = [{"CPU": int(rng.integers(2, 16)),
                 "memory": int(rng.integers(2, 16))} for _ in range(12)]
    n_specs = 600

    def batches_of(pkg):
        brng = np.random.default_rng(1)
        plain = _specs(pkg, brng, n_specs, 6)
        loc = _specs(pkg, brng, n_specs, 6)
        prefs = [int(p) if p >= 0 else None
                 for p in brng.integers(-6, 12, size=n_specs)]
        avoids = list(brng.random(n_specs) < 0.1)
        return [(plain, [None] * n_specs, [False] * n_specs),
                (loc, prefs, avoids)]

    calls = []
    real = locality_kernel.schedule_grouped_localized

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    PortConfig.reset(dict(CPU_CONFIG))
    locality_kernel.schedule_grouped_localized = spy
    try:
        got, head = _raylet_rows(rt, port_cluster, node_res, batches_of)
    finally:
        locality_kernel.schedule_grouped_localized = real
        PortConfig.reset()
    assert head.device_rounds == 2 and head.host_rounds == 0
    assert head.delta_rounds == 1      # the plain batch, on the delta beat
    assert calls == [1]                # the locality batch, localized
    assert head._delta_engine is not None and head._delta_engine.stats["beats"] >= 1

    RefConfig.reset({"scheduler_device_batch_min": 1})
    try:
        want, _ = _raylet_rows(ray_tpu, ref_cluster, node_res, batches_of)
    finally:
        RefConfig.reset()
    assert got == want
    assert all(r >= 0 for r in got[0]) and all(r >= 0 for r in got[1])
