"""Actor concurrency: async actors, max_concurrency, concurrency groups.

Scenario sources: upstream's async actors (coroutine methods on an
event loop, awaitable ObjectRefs), threaded actors bounded by
``max_concurrency``, and named ``concurrency_groups`` with per-group
limits (core worker async actor scheduling — SURVEY.md §1 layer 7;
re-derived, not copied).
"""

import time

import pytest

import ray_tpu_torch
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_actor_concurrency.py: the reference's file with
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
def driver():
    ray_tpu_torch.init(resources={"CPU": 8}, num_workers=2)
    try:
        yield
    finally:
        ray_tpu_torch.shutdown()


class TestThreadedActors:
    def test_max_concurrency_overlaps_calls(self, driver):
        """N slow calls on a max_concurrency=N actor finish in ~1 slot
        of wall time — they genuinely overlap."""
        @ray_tpu_torch.remote(max_concurrency=4)
        class Slow:
            def work(self, dt):
                time.sleep(dt)
                return time.monotonic()

        a = Slow.remote()
        t0 = time.monotonic()
        outs = ray_tpu_torch.get([a.work.remote(1.5) for _ in range(4)],
                           timeout=60)
        elapsed = time.monotonic() - t0
        assert elapsed < 4.5, elapsed       # serial would be >= 6.0
        ray_tpu_torch.kill(a)

    def test_default_actor_stays_serial(self, driver):
        """Without max_concurrency, calls execute strictly one at a
        time in submission order (the reference's plain-actor FIFO)."""
        @ray_tpu_torch.remote
        class Serial:
            def __init__(self):
                self.active = 0
                self.max_active = 0
                self.order = []

            def work(self, i):
                self.active += 1
                self.max_active = max(self.max_active, self.active)
                time.sleep(0.05)
                self.order.append(i)
                self.active -= 1
                return i

            def report(self):
                return self.max_active, self.order

        a = Serial.remote()
        ray_tpu_torch.get([a.work.remote(i) for i in range(6)], timeout=60)
        max_active, order = ray_tpu_torch.get(a.report.remote(), timeout=30)
        assert max_active == 1
        assert order == list(range(6))
        ray_tpu_torch.kill(a)

    def test_concurrency_groups_bound_independently(self, driver):
        """A saturated group must not block calls routed to another."""
        @ray_tpu_torch.remote(max_concurrency=1,
                        concurrency_groups={"io": 2})
        class Grouped:
            def __init__(self):
                self.seen = []

            def blocked(self, dt):
                time.sleep(dt)
                return "blocked-done"

            def quick(self):
                return "quick-done"

        a = Grouped.remote()
        slow = a.blocked.remote(6.0)    # occupies the DEFAULT group
        t0 = time.monotonic()
        out = ray_tpu_torch.get(
            a.quick.options(concurrency_group="io").remote(),
            timeout=30)
        dt = time.monotonic() - t0
        assert out == "quick-done"
        assert dt < 4.0, dt     # did not wait behind the slow default call
        assert ray_tpu_torch.get(slow, timeout=30) == "blocked-done"
        ray_tpu_torch.kill(a)

    def test_blocking_get_inside_concurrent_calls(self, driver):
        """Concurrent calls each do their own ray.get without
        deadlocking the shared pipe (reader-thread reply routing)."""
        @ray_tpu_torch.remote(max_concurrency=3)
        class Getter:
            def fetch(self, ref_list):
                return len(ray_tpu_torch.get(ref_list[0]))

        blobs = [ray_tpu_torch.put(bytes(200_000)) for _ in range(3)]
        g = Getter.remote()
        outs = ray_tpu_torch.get([g.fetch.remote([b]) for b in blobs],
                           timeout=60)
        assert outs == [200_000] * 3
        ray_tpu_torch.kill(g)


class TestAsyncActors:
    def test_async_methods_overlap(self, driver):
        import asyncio

        @ray_tpu_torch.remote
        class Async:
            async def work(self, dt):
                await asyncio.sleep(dt)
                return "ok"

        a = Async.remote()
        t0 = time.monotonic()
        outs = ray_tpu_torch.get([a.work.remote(0.8) for _ in range(8)],
                           timeout=60)
        elapsed = time.monotonic() - t0
        assert outs == ["ok"] * 8
        assert elapsed < 5.0, elapsed       # serial would be >= 6.4
        ray_tpu_torch.kill(a)

    def test_async_max_concurrency_bounds(self, driver):
        import asyncio

        @ray_tpu_torch.remote(max_concurrency=2)
        class Bounded:
            def __init__(self):
                self.active = 0
                self.max_active = 0

            async def work(self):
                self.active += 1
                self.max_active = max(self.max_active, self.active)
                await asyncio.sleep(0.2)
                self.active -= 1
                return self.max_active

            async def peak(self):
                return self.max_active

        a = Bounded.remote()
        ray_tpu_torch.get([a.work.remote() for _ in range(6)], timeout=60)
        peak = ray_tpu_torch.get(a.peak.remote(), timeout=30)
        assert peak <= 2, peak
        ray_tpu_torch.kill(a)

    def test_await_object_ref(self, driver):
        """``await ref`` resolves inside an async actor method."""
        @ray_tpu_torch.remote
        def produce():
            return 41

        @ray_tpu_torch.remote
        class Awaiter:
            async def plus_one(self, refs):
                return await refs[0] + 1

        a = Awaiter.remote()
        out = ray_tpu_torch.get(a.plus_one.remote([produce.remote()]),
                          timeout=60)
        assert out == 42
        ray_tpu_torch.kill(a)

    def test_async_errors_propagate(self, driver):
        @ray_tpu_torch.remote
        class Boom:
            async def go(self):
                raise ValueError("async boom")

        a = Boom.remote()
        with pytest.raises(ValueError, match="async boom"):
            ray_tpu_torch.get(a.go.remote(), timeout=30)
        ray_tpu_torch.kill(a)

    def test_graceful_terminate_drains_inflight(self, driver):
        import asyncio

        @ray_tpu_torch.remote
        class Draining:
            async def slow(self):
                await asyncio.sleep(0.5)
                return "done"

        a = Draining.remote()
        refs = [a.slow.remote() for _ in range(3)]
        a.__ray_terminate__()
        # in-flight calls complete before the exit
        assert ray_tpu_torch.get(refs, timeout=60) == ["done"] * 3
