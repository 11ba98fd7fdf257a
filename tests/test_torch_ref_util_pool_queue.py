"""ray_tpu_torch.util.ActorPool + ray_tpu_torch.util.queue.Queue.

Scenario sources: upstream ``ray.util.ActorPool`` /
``ray.util.queue.Queue`` API contracts (``python/ray/util/`` —
SURVEY.md §2.2; scenarios re-derived, not copied).
"""

import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import ActorPool
from ray_tpu_torch.util.queue import Empty, Full, Queue
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_util_pool_queue.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


@pytest.fixture(scope="module", autouse=True)
def driver():
    ray_tpu_torch.init(resources={"CPU": 8, "memory": 8}, num_workers=4)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Worker:
    def __init__(self):
        import os
        self.pid = os.getpid()

    def double(self, x):
        return 2 * x

    def slow_id(self, x):
        time.sleep(0.4 if x == 0 else 0.05)
        return x


class TestActorPool:
    def test_map_ordered(self):
        pool = ActorPool([_Worker.remote() for _ in range(2)])
        out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
        assert out == [2 * v for v in range(8)]

    def test_map_unordered_yields_by_completion(self):
        pool = ActorPool([_Worker.remote() for _ in range(2)])
        out = list(pool.map_unordered(
            lambda a, v: a.slow_id.remote(v), [0, 1, 2, 3]))
        assert sorted(out) == [0, 1, 2, 3]
        # the slow task (0) must NOT be first out
        assert out[0] != 0

    def test_submit_queues_past_pool_size_and_push(self):
        actors = [_Worker.remote()]
        pool = ActorPool(actors)
        for v in range(4):
            pool.submit(lambda a, v: a.double.remote(v), v)
        assert not pool.has_free()
        pool.push(_Worker.remote())     # second actor drains backlog
        got = [pool.get_next(timeout=60) for _ in range(4)]
        assert got == [0, 2, 4, 6]
        assert not pool.has_next()
        assert pool.pop_idle() is not None


class TestQueue:
    def test_fifo_across_processes(self):
        q = Queue()
        try:
            @ray_tpu_torch.remote
            def producer(q, n):
                for i in range(n):
                    q.put(i)
                return "done"

            @ray_tpu_torch.remote
            def consumer(q, n):
                return [q.get(timeout=30) for _ in range(n)]

            p = producer.remote(q, 5)
            c = consumer.remote(q, 5)
            assert ray_tpu_torch.get(p, timeout=60) == "done"
            assert ray_tpu_torch.get(c, timeout=60) == [0, 1, 2, 3, 4]
        finally:
            q.shutdown()

    def test_nowait_and_exceptions(self):
        q = Queue(maxsize=1)
        try:
            q.put_nowait("a")
            with pytest.raises(Full):
                q.put_nowait("b")
            assert q.full() and q.qsize() == 1
            assert q.get_nowait() == "a"
            assert q.empty()
            with pytest.raises(Empty):
                q.get_nowait()
        finally:
            q.shutdown()

    def test_blocking_get_wakes_on_put(self):
        q = Queue()
        try:
            got = []

            def consume():
                got.append(q.get(timeout=30))
            t = threading.Thread(target=consume)
            t.start()
            time.sleep(0.3)
            q.put("wake")
            t.join(timeout=30)
            assert got == ["wake"]
        finally:
            q.shutdown()

    def test_get_timeout_raises_empty(self):
        q = Queue()
        try:
            t0 = time.monotonic()
            with pytest.raises(Empty):
                q.get(timeout=0.5)
            assert time.monotonic() - t0 < 10
        finally:
            q.shutdown()


class TestReviewRegressions:
    def test_pool_survives_task_exception(self):
        @ray_tpu_torch.remote
        class Flaky:
            def work(self, x):
                if x == 1:
                    raise ValueError("boom")
                return x

        pool = ActorPool([Flaky.remote()])
        for v in [0, 1, 2]:
            pool.submit(lambda a, v: a.work.remote(v), v)
        assert pool.get_next(timeout=60) == 0
        with pytest.raises(Exception):
            pool.get_next(timeout=60)
        # the actor returned to the pool despite the exception: the
        # remaining (queued) submit still runs
        assert pool.get_next(timeout=60) == 2
        assert not pool.has_next()

    def test_queue_batches_are_atomic(self):
        q = Queue(maxsize=3)
        try:
            q.put_nowait("x")
            with pytest.raises(Full):
                q.put_nowait_batch(["a", "b", "c"])   # 1+3 > 3
            assert q.qsize() == 1       # nothing partially inserted
            q.put_nowait_batch(["a", "b"])
            assert q.qsize() == 3
            with pytest.raises(Empty):
                q.get_nowait_batch(4)
            assert q.qsize() == 3       # nothing partially consumed
            assert q.get_nowait_batch(3) == ["x", "a", "b"]
        finally:
            q.shutdown()
