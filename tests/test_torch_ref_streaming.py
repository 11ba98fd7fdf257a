"""Streaming generators + bounded-memory data pipelines.

Scenario sources: upstream's streaming-generator protocol
(``num_returns="streaming"`` -> ObjectRefGenerator with consumer-driven
backpressure) and Data's streaming executor keeping block pipelines at
O(in-flight) store occupancy (core worker streaming generators +
``python/ray/data/_internal/execution/`` — SURVEY.md §1 layers 7/14;
re-derived, not copied).
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime.object_ref import ObjectRefGenerator
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_streaming.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


BLOCK = 200_000     # bytes per streamed payload: arena-routed


@pytest.fixture
def driver():
    from ray_tpu_torch.api import _get_runtime
    ray_tpu_torch.init(resources={"CPU": 4}, num_workers=2)
    try:
        yield _get_runtime()
    finally:
        ray_tpu_torch.shutdown()


class TestGeneratorBasics:
    def test_stream_yields_in_order(self, driver):
        @ray_tpu_torch.remote(num_returns="streaming")
        def gen(n):
            for i in range(n):
                yield i * 10

        out = [ray_tpu_torch.get(ref, timeout=30)
               for ref in gen.remote(7)]
        assert out == [0, 10, 20, 30, 40, 50, 60]

    def test_returns_generator_object(self, driver):
        @ray_tpu_torch.remote(num_returns="streaming")
        def gen():
            yield 1

        g = gen.remote()
        assert isinstance(g, ObjectRefGenerator)
        assert [ray_tpu_torch.get(r, timeout=30) for r in g] == [1]

    def test_empty_stream(self, driver):
        @ray_tpu_torch.remote(num_returns="streaming")
        def gen():
            if False:
                yield 0

        assert list(gen.remote()) == []

    def test_mid_stream_error_raises_at_consumer(self, driver):
        @ray_tpu_torch.remote(num_returns="streaming")
        def gen():
            yield 1
            yield 2
            raise RuntimeError("stream boom")

        g = gen.remote()
        got = []
        with pytest.raises(RuntimeError, match="stream boom"):
            for ref in g:
                got.append(ray_tpu_torch.get(ref, timeout=30))
        assert got == [1, 2]

    def test_consumer_can_lag_then_drain(self, driver):
        """The producer finishes ahead (within its window); a late
        consumer still reads every item."""
        @ray_tpu_torch.remote(num_returns="streaming")
        def gen(n):
            for i in range(n):
                yield i

        g = gen.remote(10)
        time.sleep(1.0)     # producer runs ahead
        assert [ray_tpu_torch.get(r, timeout=30) for r in g] == list(range(10))


class TestBackpressure:
    def test_producer_pauses_behind_window(self, driver):
        """An unconsumed stream seals at most ~window items: the store
        holds O(window) payloads, not O(total)."""
        from ray_tpu_torch.common.config import get_config
        window = get_config().streaming_backpressure_items

        @ray_tpu_torch.remote(num_returns="streaming")
        def gen(n):
            for i in range(n):
                yield bytes([i % 251]) * BLOCK

        g = gen.remote(64)
        time.sleep(2.0)     # no consumption: the producer must pause
        sealed, done, _err, _known = driver.stream_wait(g.task_id, 0, timeout=5)
        assert not done
        assert sealed <= window + 1, (sealed, window)
        # now drain; everything arrives
        n = sum(1 for _ in g)
        assert n == 64


class TestAbandonment:
    def test_abandoned_stream_cancels_and_reclaims(self, driver):
        """Closing a partially-consumed generator cancels the producer
        cooperatively and reclaims the sealed-but-unconsumed items —
        nothing leaks for the session's lifetime."""
        @ray_tpu_torch.remote(num_returns="streaming")
        def gen():
            for i in range(40):
                yield bytes([i % 251]) * BLOCK

        store = driver.cluster.store
        base = store.stats()["arena_bytes_in_use"]
        g = gen.remote()
        r1 = next(g)
        assert len(ray_tpu_torch.get(r1, timeout=30)) == BLOCK
        g.close()
        del r1, g
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            driver.cluster.ref_counter.flush()
            now = store.stats()["arena_bytes_in_use"]
            if now <= base + 2 * BLOCK:
                break
            time.sleep(0.2)
        assert store.stats()["arena_bytes_in_use"] <= base + 2 * BLOCK, \
            store.stats()


class TestActorStreaming:
    def test_actor_method_streams(self, driver):
        @ray_tpu_torch.remote
        class Gen:
            def produce(self, n):
                for i in range(n):
                    yield i * 3

        a = Gen.remote()
        g = a.produce.options(num_returns="streaming").remote(6)
        assert isinstance(g, ObjectRefGenerator)
        out = [ray_tpu_torch.get(r, timeout=30) for r in g]
        assert out == [0, 3, 6, 9, 12, 15]
        ray_tpu_torch.kill(a)

    def test_concurrent_actor_streams(self, driver):
        @ray_tpu_torch.remote(max_concurrency=3)
        class Gen:
            def produce(self, base, n):
                for i in range(n):
                    yield base + i

        a = Gen.remote()
        gens = [a.produce.options(num_returns="streaming")
                .remote(base, 4) for base in (100, 200, 300)]
        outs = [[ray_tpu_torch.get(r, timeout=30) for r in g] for g in gens]
        assert outs == [[100, 101, 102, 103], [200, 201, 202, 203],
                        [300, 301, 302, 303]]
        ray_tpu_torch.kill(a)

    def test_async_actor_streams(self, driver):
        @ray_tpu_torch.remote
        class AsyncGen:
            async def produce(self, n):
                import asyncio
                for i in range(n):
                    await asyncio.sleep(0.01)
                    yield i + 50

        a = AsyncGen.remote()
        g = a.produce.options(num_returns="streaming").remote(5)
        out = [ray_tpu_torch.get(r, timeout=30) for r in g]
        assert out == [50, 51, 52, 53, 54]
        ray_tpu_torch.kill(a)

    def test_actor_stream_error_propagates(self, driver):
        @ray_tpu_torch.remote
        class Boom:
            def produce(self):
                yield 1
                raise RuntimeError("actor stream boom")

        a = Boom.remote()
        g = a.produce.options(num_returns="streaming").remote()
        got = []
        with pytest.raises(RuntimeError, match="actor stream boom"):
            for r in g:
                got.append(ray_tpu_torch.get(r, timeout=30))
        assert got == [1]
        ray_tpu_torch.kill(a)

    def test_actor_death_ends_stream(self, driver):
        import os
        import signal

        @ray_tpu_torch.remote(max_restarts=0)
        class Slow:
            def produce(self):
                import time as _t
                for i in range(1000):
                    _t.sleep(0.05)
                    yield i

            def pid(self):
                return os.getpid()

        a = Slow.remote()
        pid = ray_tpu_torch.get(a.pid.remote(), timeout=60)
        g = a.produce.options(num_returns="streaming").remote()
        next(g)     # stream is live
        os.kill(pid, signal.SIGKILL)
        with pytest.raises(Exception):
            for _ in range(2000):
                next(g)


class TestWorkerStreamConsumption:
    def test_task_consumes_another_tasks_stream(self, driver):
        """ObjectRefGenerators chain through tasks: a consumer task
        iterates a producer task's stream via its raylet proxy."""
        @ray_tpu_torch.remote(num_returns="streaming")
        def producer(n):
            for i in range(n):
                yield i * 2

        @ray_tpu_torch.remote
        def consumer(gen):
            return sum(ray_tpu_torch.get(r, timeout=30) for r in gen)

        g = producer.remote(10)
        assert ray_tpu_torch.get(consumer.remote(g), timeout=90) == 90

    def test_task_consumes_actor_stream(self, driver):
        @ray_tpu_torch.remote
        class Gen:
            def produce(self, n):
                for i in range(n):
                    yield i + 1

        @ray_tpu_torch.remote
        def total(gen):
            return sum(ray_tpu_torch.get(r, timeout=30) for r in gen)

        a = Gen.remote()
        g = a.produce.options(num_returns="streaming").remote(5)
        assert ray_tpu_torch.get(total.remote(g), timeout=90) == 15
        ray_tpu_torch.kill(a)


class TestServeStreaming:
    def test_serve_handle_streams(self, driver):
        from ray_tpu_torch import serve

        @serve.deployment(num_replicas=1)
        class Chunker:
            def __call__(self, n):
                for i in range(n):
                    yield f"chunk-{i}"

            def plain(self, x):
                return x * 2

        handle = serve.run(Chunker.bind())
        try:
            g = handle.options(stream=True).remote(4)
            out = [ray_tpu_torch.get(r, timeout=30) for r in g]
            assert out == ["chunk-0", "chunk-1", "chunk-2", "chunk-3"]
            g2 = handle.options(stream=True).remote(2)
            assert [ray_tpu_torch.get(r, timeout=30) for r in g2] == \
                ["chunk-0", "chunk-1"]
            # the NON-streaming surface still works on the same app
            assert ray_tpu_torch.get(
                handle.options(method_name="plain").remote(21),
                timeout=30) == 42
        finally:
            serve.shutdown()

    def test_http_route_streams_chunked(self, driver):
        """A generator __call__ on a routed deployment streams over
        HTTP with chunked transfer encoding."""
        import urllib.request

        from ray_tpu_torch import serve

        @serve.deployment(num_replicas=1)
        class Streamer:
            def __call__(self, request):
                n = int(request.query.get("n", 3))
                for i in range(n):
                    yield f"part-{i}|"

        serve.run(Streamer.bind(), route_prefix="/stream")
        try:
            base = serve.http_address()
            with urllib.request.urlopen(f"{base}/stream?n=4",
                                        timeout=60) as r:
                assert r.headers.get("Transfer-Encoding") == "chunked"
                body = r.read()
            assert body == b"part-0|part-1|part-2|part-3|"
        finally:
            serve.shutdown()


class TestStreamingDataPipeline:
    def test_100_block_pipeline_bounded_occupancy(self, driver):
        """The VERDICT criterion: a 100-block map pipeline whose peak
        store occupancy is O(inflight), not O(total)."""
        from ray_tpu_torch import data

        blocks = 200
        peak = {"bytes": 0, "objects": 0}
        store = driver.cluster.store

        row_bytes = 150_000     # ABOVE the plasma threshold: blocks
        #                         genuinely occupy the arena

        def big_row(i):
            return bytes([i % 251]) * row_bytes

        src = data.stream_blocks(
            lambda: ([big_row(i)] for i in range(blocks)), window=4)
        total = 0
        for block in src.map(lambda b: b[:1] + b"!").iter_blocks():
            total += 1
            # a consumer that does SOME work per block (reclamation is
            # asynchronous; a zero-work drain loop outruns the
            # reclaimer thread and measures lag, not steady state)
            time.sleep(0.02)
            s = store.stats()
            peak["bytes"] = max(peak["bytes"], s["arena_bytes_in_use"])
            peak["objects"] = max(peak["objects"], s["num_objects"])
        assert total == blocks
        # O(inflight): window(4) + backpressure(16) + reclaim slack
        # settles around ~40 blocks INDEPENDENT of the total — bound at
        # 60 blocks' worth vs the 200-block/30MB total the pipeline
        # moved (the property VERDICT r03 item 4 asks for)
        assert 0 < peak["bytes"] < 60 * row_bytes, peak
        driver.cluster.ref_counter.flush()

    def test_stream_range_map_filter(self, driver):
        from ray_tpu_torch import data
        out = (data.stream_range(100, block_size=10)
               .map(lambda x: x * 2)
               .filter(lambda x: x % 40 == 0)
               .take_all())
        assert out == [x * 2 for x in range(100) if (x * 2) % 40 == 0]

    def test_stream_count(self, driver):
        from ray_tpu_torch import data
        assert data.stream_range(57, block_size=8).count() == 57


_CLIENT_STREAM_SCRIPT = r"""
import sys
import ray_tpu_torch

ray_tpu_torch.init(address=sys.argv[1])

@ray_tpu_torch.remote(num_returns="streaming")
def gen(n):
    for i in range(n):
        yield i + 100

out = [ray_tpu_torch.get(r, timeout=30) for r in gen.remote(5)]
assert out == [100, 101, 102, 103, 104], out
ray_tpu_torch.shutdown()
print("CLIENT_STREAM_OK")
"""


class TestStreamingClientMode:
    def test_client_consumes_stream(self):
        """A client-mode driver PROCESS consumes an ObjectRefGenerator
        through the head's stream_wait/stream_ack proxy."""
        import os
        import subprocess
        import sys

        from ray_tpu_torch.runtime.head import HeadNode

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        head = HeadNode(resources={"CPU": 2}, num_workers=1)
        try:
            proc = subprocess.run(
                [sys.executable, "-c", _CLIENT_STREAM_SCRIPT,
                 head.address],
                capture_output=True, text=True, timeout=120,
                env={**os.environ, "PYTHONPATH": repo})
            assert proc.returncode == 0, proc.stderr
            assert "CLIENT_STREAM_OK" in proc.stdout
        finally:
            head.stop()
