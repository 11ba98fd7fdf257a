"""The port's observability surfaces against the JAX package's: the
Prometheus endpoint (``runtime/metrics.py``), the dashboard's HTML and
JSON APIs (``runtime/dashboard.py``) and user metrics
(``util/metrics.py``).

Scenario sources: ``tests/test_observability.py``,
``tests/test_dashboard.py`` and the user-metrics cases of
``tests/test_state_and_persistence.py``.  One cluster layout (a head and
two added nodes, a few tasks, a named actor, a two-replica deployment)
runs once through each package's runtime (the port with
``scheduler_device="cpu"``), one after the other.  Held equal: the set of
metric names ``/metrics`` serves, the values of the gauges that the
layout fixes, the serve gauges against ``serve.status()``, the key sets
of every JSON API, the status codes of the HTTP surface, and the text of
user metrics for the same operations.
"""

import importlib
import json
import socket
import urllib.error
import urllib.request

import pytest

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")
APIS = ("summary", "nodes", "actors", "tasks", "objects",
        "placement_groups", "serve", "versions", "leases", "broadcasts",
        "health", "timeline", "jobs", "stacks")
# gauges whose values the layout fixes (the rest move with timing)
FIXED = ("num_nodes", "num_workers_expected", "scheduler_pending_tasks",
         "object_store_arena_capacity_bytes",
         "health_nodes_declared_dead_total", "reconstructions_total",
         "rpc_breakers_open", "serve_replicas", "serve_router_shards",
         "serve_completed_requests_total", "serve_shed_requests_total",
         "serve_queued_requests", "serve_model_version")


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _get(port, path, data=None, method=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _values(text):
    """{name{labels}: value} of every sample line."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out[key] = float(value)
    return out


def _shape(payload):
    """What a JSON API answers, without its run-dependent values."""
    if isinstance(payload, dict):
        return "dict", sorted(payload)
    rows = sorted({k for row in payload for k in row}) \
        if payload and isinstance(payload[0], dict) else []
    return "list", rows


def _layout(name):
    """The shared scenario under package ``name``; what both must show."""
    rt = importlib.import_module(name)
    serve = importlib.import_module(f"{name}.serve")
    api = importlib.import_module(f"{name}.api")
    metrics = importlib.import_module(f"{name}.runtime.metrics")
    dashboard = importlib.import_module(f"{name}.runtime.dashboard")
    port = name == "ray_tpu_torch"
    rt.init(resources={"CPU": 8, "memory": 8}, num_workers=2,
            system_config={"scheduler_device": "cpu"} if port else None)
    exporter = dash = None
    try:
        cluster = api._get_runtime().cluster
        for _ in range(2):
            cluster.add_node(resources={"CPU": 2, "memory": 2},
                             num_workers=1)
        exporter = metrics.MetricsExporter(cluster, 0)
        dash = dashboard.Dashboard(cluster, 0)

        @rt.remote
        def f(i):
            return i + 1

        @rt.remote
        class A:
            def ping(self):
                return "pong"

        refs = [f.remote(i) for i in range(6)]
        tasks = rt.get(refs, timeout=60)
        actor = A.options(name="dash_actor").remote()
        pong = rt.get(actor.ping.remote(), timeout=60)

        @serve.deployment(num_replicas=2)
        class Obs:
            def __call__(self, x):
                return x * 3

        handle = serve.run(Obs.bind())
        served = rt.get([handle.remote(i) for i in range(5)], timeout=60)
        plane = serve.status()["request_plane"]

        status, ctype, body = _get(exporter.port, "/metrics")
        text = body.decode()
        names = sorted(line.split()[2] for line in text.splitlines()
                       if line.startswith("# TYPE "))
        values = _values(text)
        fixed = {k: v for k, v in values.items()
                 if k.split("{")[0].removeprefix("ray_tpu_") in FIXED}
        serve_gauges = {k.split("{")[0]: v for k, v in values.items()
                        if 'deployment="Obs"' in k}

        apis = {}
        for api_name in APIS:
            code, _, payload = _get(dash.port, f"/api/{api_name}")
            apis[api_name] = code, _shape(json.loads(payload))
        summary = json.loads(_get(dash.port, "/api/summary")[2])
        index = _get(dash.port, "/")[2].decode()
        codes = [_get(dash.port, "/api/nope")[0],
                 _get(dash.port, "/whatever")[0],
                 _get(dash.port, "/api/summary", data=b"{}",
                      method="POST")[0]]
        passthrough = _get(dash.port, "/metrics")
        return {
            "work": (tasks, pong, served),
            "metrics_http": (status, ctype.split(";")[0]),
            "names": names,
            "fixed": fixed,
            "serve_vs_status": (
                serve_gauges["ray_tpu_serve_replicas"] == plane["replicas"],
                serve_gauges["ray_tpu_serve_completed_requests_total"]
                == plane["completed"],
                serve_gauges["ray_tpu_serve_queued_requests"]
                == plane["queued"]),
            "apis": apis,
            "summary": (summary["nodes"], summary["cluster_resources"],
                        summary["actors"]["total"],
                        summary["tasks"]["total"] >= 6),
            "index": ("Nodes" in index, "Actors" in index),
            "codes": codes,
            "passthrough": (passthrough[0],
                            "ray_tpu_num_nodes 3" in passthrough[2].decode()),
        }
    finally:
        if dash is not None:
            dash.shutdown()
        if exporter is not None:
            exporter.shutdown()
        serve.shutdown()
        rt.shutdown()
        (PortConfig if port else RefConfig).reset()


def _reset_user_metrics():
    """Both packages' user-metric state as a fresh process holds it: the
    registry and serve's batch-size histogram, which other tests of this
    worker may have filled (the ``names`` surface lists them)."""
    for name in PKGS:
        importlib.import_module(f"{name}.util.metrics")._reset_registry()
        importlib.import_module(f"{name}.serve.batching")._hist = None


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name in PKGS:
        _reset_user_metrics()
        out[name] = _layout(name)
    return out


@pytest.mark.parametrize("surface", [
    "work", "metrics_http", "names", "fixed", "serve_vs_status", "apis",
    "summary", "index", "codes", "passthrough"])
def test_same_as_reference(runs, surface):
    assert runs["ray_tpu_torch"][surface] == runs["ray_tpu"][surface]


def test_what_the_layout_shows(runs):
    got = runs["ray_tpu_torch"]
    assert got["fixed"]["ray_tpu_num_nodes"] == 3
    assert got["fixed"]['ray_tpu_serve_replicas{deployment="Obs"}'] == 2
    assert got["serve_vs_status"] == (True, True, True)
    assert got["codes"] == [404, 404, 501]
    assert all(code == 200 for code, _ in got["apis"].values())
    assert got["passthrough"] == (200, True)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_config_ports_start_the_exporter_and_the_dashboard():
    from ray_tpu_torch.cluster_utils import Cluster
    mport, dport = _free_port(), _free_port()
    PortConfig.reset({"scheduler_device": "cpu",
                      "metrics_export_port": mport,
                      "dashboard_port": dport})
    c = Cluster()
    c.add_node(resources={"CPU": 2, "memory": 2}, num_workers=0)
    try:
        assert c.metrics is not None and c.dashboard is not None
        assert b"ray_tpu_num_nodes 1" in _get(mport, "/metrics")[2]
        assert _get(dport, "/api/health")[0] == 200
    finally:
        c.stop()


def _user_metrics(name):
    """The user-metrics cases of the reference's tests, under ``name``;
    the exposition lines of the metrics made here."""
    um = importlib.import_module(f"{name}.util.metrics")
    c = um.Counter("obs_requests_total", "Requests",
                   tag_keys=("route",))
    c.inc(tags={"route": "/a"})
    c.inc(2, tags={"route": "/a"})
    c.inc(tags={"route": "/b"})
    g = um.Gauge("obs_queue_depth", "Depth")
    g.set(7)
    h = um.Histogram("obs_latency_s", "Latency",
                     boundaries=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    um.Counter("obs_recreate_total", "n").inc(2)
    um.Counter("obs_recreate_total", "n").inc(3)
    um.Counter("obs_esc_total", tag_keys=("p",)).inc(
        tags={"p": 'a"b\\c\nd'})
    errors = []
    for bad in (lambda: um.Gauge("obs_recreate_total"),
                lambda: c.inc(tags={"nope": "1"}),
                lambda: c.inc(-1)):
        try:
            bad()
        except ValueError as e:
            errors.append(str(e))
    lines = [line for line in um.render_user_metrics()
             if "_obs_" in line]
    return lines, errors


def test_user_metrics_render_as_the_reference():
    got, got_err = _user_metrics("ray_tpu_torch")
    want, want_err = _user_metrics("ray_tpu")
    assert got == want and got_err == want_err
    text = "\n".join(got)
    assert 'ray_tpu_user_obs_requests_total{route="/a"} 3.0' in text
    assert 'ray_tpu_user_obs_latency_s_bucket{le="+Inf"} 3' in text
    assert len(got_err) == 3
