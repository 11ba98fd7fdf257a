"""State API, user metrics, GCS snapshot/restore.

Scenario sources: upstream ``ray.util.state`` (list_* with filters,
summaries), ``ray.util.metrics`` (Counter/Gauge/Histogram with tags on
the Prometheus endpoint), and Redis-backed GCS fault tolerance
(metadata survives a head restart; detached/named actors restart) —
SURVEY.md §1 layer 12, §2.2, §5.4; scenarios re-derived, not copied."""

import time
import urllib.request

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import metrics as umetrics
from ray_tpu_torch.util import state as ustate
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_state_and_persistence.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


class TestStateApi:
    @pytest.fixture(scope="class", autouse=True)
    def driver(self):
        ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2)
        yield
        ray_tpu_torch.shutdown()

    def test_list_nodes(self):
        rows = ustate.list_nodes()
        assert len(rows) == 1 and rows[0]["state"] == "ALIVE"

    def test_list_tasks_and_summary(self):
        @ray_tpu_torch.remote
        def probe():
            return 1

        ray_tpu_torch.get([probe.remote() for _ in range(3)], timeout=30)
        rows = ustate.list_tasks()
        assert len(rows) >= 3
        finished = ustate.list_tasks(
            filters=[("state", "=", "FINISHED")])
        assert len(finished) >= 3
        s = ustate.summarize_tasks()
        assert s["total"] >= 3 and "FINISHED" in s["by_state"]

    def test_list_actors_with_filter(self):
        @ray_tpu_torch.remote
        class Probe:
            def ping(self):
                return "pong"

        a = Probe.options(name="state-probe").remote()
        assert ray_tpu_torch.get(a.ping.remote(), timeout=30) == "pong"
        rows = ustate.list_actors(filters=[("name", "=", "state-probe")])
        assert len(rows) == 1 and rows[0]["state"] == "ALIVE"
        assert ustate.summarize_actors()["total"] >= 1

    def test_list_objects(self):
        ref = ray_tpu_torch.put(b"x" * 200_000)       # large: shm-routed
        small = ray_tpu_torch.put({"k": 1})
        rows = ustate.list_objects()
        by_id = {r["object_id"]: r for r in rows}
        assert by_id[ref.hex()]["kind"] == "shm"
        assert by_id[ref.hex()]["size_bytes"] >= 200_000
        assert by_id[small.hex()]["kind"] == "in_band"

    def test_bad_filter_op(self):
        with pytest.raises(ValueError, match="unsupported filter"):
            ustate.list_nodes(filters=[("state", ">", "ALIVE")])


class TestUserMetrics:
    @pytest.fixture(autouse=True)
    def fresh_registry(self):
        umetrics._reset_registry()
        yield
        umetrics._reset_registry()

    def test_counter_gauge_histogram_render(self):
        c = umetrics.Counter("requests_total", "reqs",
                             tag_keys=("route",))
        c.inc(tags={"route": "/a"})
        c.inc(2, tags={"route": "/a"})
        g = umetrics.Gauge("queue_depth", "depth")
        g.set(7)
        h = umetrics.Histogram("latency_s", "lat",
                               boundaries=[0.1, 1.0])
        h.observe(0.05)
        h.observe(0.5)
        h.observe(5.0)
        text = "\n".join(umetrics.render_user_metrics())
        assert 'ray_tpu_user_requests_total{route="/a"} 3.0' in text
        assert "ray_tpu_user_queue_depth 7.0" in text
        assert 'ray_tpu_user_latency_s_bucket{le="0.1"} 1' in text
        assert 'ray_tpu_user_latency_s_bucket{le="+Inf"} 3' in text
        assert "ray_tpu_user_latency_s_count 3" in text

    def test_recreated_metric_shares_series(self):
        umetrics.Counter("recreate_total", "n").inc(2)
        # re-creation (module reload pattern) adopts the same series:
        # ONE metric block in the exposition, cumulative value kept
        umetrics.Counter("recreate_total", "n").inc(3)
        text = "\n".join(umetrics.render_user_metrics())
        assert text.count("# TYPE ray_tpu_user_recreate_total") == 1
        assert "ray_tpu_user_recreate_total 5.0" in text
        with pytest.raises(ValueError, match="already registered"):
            umetrics.Gauge("recreate_total")

    def test_label_values_escaped(self):
        c = umetrics.Counter("esc_total", tag_keys=("p",))
        c.inc(tags={"p": 'a"b\\c\nd'})
        text = "\n".join(umetrics.render_user_metrics())
        assert '{p="a\\"b\\\\c\\nd"}' in text

    def test_tag_validation(self):
        c = umetrics.Counter("strict_total", tag_keys=("a",))
        with pytest.raises(ValueError, match="not in declared"):
            c.inc(tags={"b": "1"})
        with pytest.raises(ValueError, match="only go up"):
            c.inc(-1)

    def test_endpoint_serves_user_metrics(self):
        ray_tpu_torch.init(resources={"CPU": 2, "memory": 2}, num_workers=1)
        exporter = None
        try:
            from ray_tpu_torch.api import _get_runtime
            from ray_tpu_torch.runtime.metrics import MetricsExporter
            exporter = MetricsExporter(_get_runtime().cluster, 0)
            umetrics.Counter("scraped_total", "n").inc(5)
            url = f"http://127.0.0.1:{exporter.port}/metrics"
            body = urllib.request.urlopen(url, timeout=10).read()
            assert b"ray_tpu_user_scraped_total 5.0" in body
            assert b"ray_tpu_" in body              # core metrics too
        finally:
            if exporter is not None:
                exporter.shutdown()
            ray_tpu_torch.shutdown()


class TestGcsSnapshot:
    def test_metadata_survives_head_restart(self, tmp_path):
        snap = str(tmp_path / "gcs.snap")
        ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2)
        try:
            from ray_tpu_torch.api import _get_runtime
            from ray_tpu_torch.experimental import internal_kv as kv
            kv._internal_kv_put(b"persist-me", b"v1", namespace="app")

            @ray_tpu_torch.remote
            class CounterActor:
                def __init__(self, start):
                    self.n = start

                def incr(self):
                    self.n += 1
                    return self.n

            a = CounterActor.options(name="survivor").remote(100)
            assert ray_tpu_torch.get(a.incr.remote(), timeout=30) == 101
            _get_runtime().cluster.save_gcs_snapshot(snap)
        finally:
            ray_tpu_torch.shutdown()

        # "restarted head": a brand-new cluster restores the snapshot
        ray_tpu_torch.init(resources={"CPU": 4, "memory": 4}, num_workers=2)
        try:
            from ray_tpu_torch.api import _get_runtime
            from ray_tpu_torch.experimental import internal_kv as kv
            _get_runtime().cluster.restore_gcs_snapshot(snap)
            assert kv._internal_kv_get(b"persist-me",
                                       namespace="app") == b"v1"
            # the named actor RESTARTED: fresh incarnation, ctor re-ran
            h = ray_tpu_torch.get_actor("survivor")
            deadline = time.monotonic() + 30
            while True:
                try:
                    assert ray_tpu_torch.get(h.incr.remote(),
                                       timeout=30) == 101
                    break
                except Exception:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.1)
        finally:
            ray_tpu_torch.shutdown()
