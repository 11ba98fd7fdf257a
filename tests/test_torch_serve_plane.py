"""The port's serve request plane against the JAX package's: the
``@serve.batch`` batcher, admission control, deadlines and the HTTP
ingress's status codes.

Scenario sources: ``tests/test_serve_plane.py`` and the ingress cases of
``tests/test_serve.py``.  The batcher is driven directly by threads, as
``TestBatcherUnit`` drives it, with every call queued before a leader
runs, so the partition into batches is fixed.  The rest runs once
through each package's runtime (the port with ``scheduler_device=
"cpu"``), one package after the other, and the port must return exactly
what the reference returns: responses, error types and messages, the
queue bound at which ``BackPressureError`` sheds, HTTP status codes,
bodies and ``Retry-After``.
"""

import importlib
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


class _Pkg:
    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.serve = importlib.import_module(f"{name}.serve")
        self.batching = importlib.import_module(f"{name}.serve.batching")


# -- the batcher, no cluster -------------------------------------------------

def _partition(p, n, cap, handler_kind):
    """Queue ``n`` calls behind a held leadership, one thread at a time
    (so the queue order is the call order), release, and return what
    each caller got and the batches the handler saw."""
    batches = []

    def handler(items):
        batches.append(list(items))
        if handler_kind == "raise":
            raise RuntimeError("nope")
        if handler_kind == "short":
            return items[:-1]
        return [KeyError(x) if x % 5 == 1 else x * 2 for x in items]

    fn = p.serve.batch(max_batch_size=cap,
                       batch_wait_timeout_s=0.05)(handler)
    q = p.batching._free_queue(id(fn))
    with q.cv:
        q.leading = True            # nobody leads until all are queued
    out = {}

    def call(i):
        try:
            out[i] = ("ok", fn(i))
        except Exception as e:      # noqa: BLE001 — compared
            out[i] = (type(e).__name__, str(e))

    threads = []
    for i in range(n):
        t = threading.Thread(target=call, args=(i,), daemon=True)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 10
        while True:
            with q.cv:
                if len(q.pending) == i + 1:
                    break
            assert time.monotonic() < deadline
            time.sleep(0.001)
    with q.cv:
        q.leading = False
        q.cv.notify_all()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    return sorted(batches), [out[i] for i in range(n)]


@pytest.mark.parametrize("n,cap,kind", [
    (10, 4, "mixed"), (16, 16, "mixed"), (7, 1, "mixed"), (5, 8, "mixed"),
    (6, 4, "raise"), (5, 2, "short")])
def test_batch_partitions_equal_the_reference(n, cap, kind):
    want = _partition(_Pkg("ray_tpu"), n, cap, kind)
    got = _partition(_Pkg("ray_tpu_torch"), n, cap, kind)
    assert got == want
    # calls queued first ship as FIFO windows of the size cap
    assert got[0] == [list(range(i, min(i + cap, n)))
                      for i in range(0, n, cap)]


def test_handler_contract_errors_equal_the_reference():
    def errors(p):
        out = []
        for bad in ({"kw": 1}, ()):
            fn = p.serve.batch(lambda items: items)
            try:
                fn(1, **bad) if bad else fn()
            except TypeError as e:
                out.append(str(e))
        return out

    assert errors(_Pkg("ray_tpu_torch")) == errors(_Pkg("ray_tpu"))


# -- the plane on a runtime ----------------------------------------------------

def _drive(scenarios, **init_kw):
    out = {}
    for name in PKGS:
        p = _Pkg(name)
        port = name == "ray_tpu_torch"
        p.rt.init(**init_kw, system_config={"scheduler_device": "cpu"}
                  if port else None)
        res = out[name] = {}
        try:
            for sc in scenarios:
                try:
                    res[sc.__name__] = sc(p)
                except Exception as e:      # noqa: BLE001 — compared
                    res[sc.__name__] = e
                finally:
                    p.serve.shutdown()
        finally:
            p.rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


def _plane(p):
    return p.serve.status().get("request_plane", {})


def backpressure_bound(p):
    """One slot and a queue of two: the fourth request sheds."""
    @p.serve.deployment(num_replicas=1, max_ongoing_requests=1,
                        max_queued_requests=2)
    class Slow:
        def __call__(self):
            time.sleep(0.4)
            return "done"

    handle = p.serve.run(Slow.bind())
    refs = []
    try:
        for _ in range(8):
            refs.append(handle.remote())
        shed = None
    except p.serve.BackPressureError as e:
        shed = str(e)
    plane = _plane(p)
    return (len(refs), shed, plane.get("shed"), plane.get("queued"),
            p.rt.get(refs, timeout=60))


def promises_resolve(p):
    """Queued requests' results and errors arrive through promises."""
    @p.serve.deployment(num_replicas=1, max_ongoing_requests=1)
    class Picky:
        def __call__(self, x):
            time.sleep(0.02)
            if x % 3 == 0:
                raise ValueError(f"rejected {x}")
            return x * 10

    handle = p.serve.run(Picky.bind())
    refs = [handle.remote(x) for x in range(7)]
    out = []
    for ref in refs:
        try:
            out.append(p.rt.get(ref, timeout=60))
        except ValueError as e:
            out.append(f"ValueError: {e}")
    plane = _plane(p)
    return out, plane["completed"], plane["user_errors"], sorted(plane)


def deadlines(p):
    """A queued request expires before dispatch; an expired budget fails
    at the call."""
    @p.serve.deployment(num_replicas=1, max_ongoing_requests=1)
    class Wedge:
        def __call__(self, dt):
            time.sleep(dt)
            return "ok"

    handle = p.serve.run(Wedge.bind())
    wedge = handle.remote(0.8)
    time.sleep(0.1)
    doomed = handle.options(timeout_s=0.2).remote(0.0)
    try:
        p.rt.get(doomed, timeout=10)
        queued = None
    except TimeoutError as e:
        queued = type(e).__name__, "expired" in str(e)
    try:
        handle.options(timeout_s=0).remote()
        at_call = None
    except TimeoutError as e:
        at_call = type(e).__name__, str(e)
    return queued, at_call, _plane(p)["expired"], \
        p.rt.get(wedge, timeout=60)


def _http(url, data=None, method=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, hdrs, body = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, body = e.code, e.headers, e.read()
    ctype = (hdrs.get("Content-Type") or "").split(";")[0]
    if ctype == "application/json":
        body = json.loads(body)
    return status, ctype, body, hdrs.get("Retry-After")


def _raw(base, request: bytes) -> bytes:
    host, port = base.removeprefix("http://").rsplit(":", 1)
    with socket.create_connection((host, int(port)), timeout=30) as s:
        s.sendall(request)
        return int(s.recv(4096).split(b"\r\n", 1)[0].split(b" ", 2)[1])


def ingress(p):
    """200 (JSON, text, bytes), 400, 404, 413, 500, 504 and the route
    table, through the HTTP proxy."""
    @p.serve.deployment
    class Echo:
        def __call__(self, request):
            kind = request.query.get("kind", "json")
            if kind == "text":
                return "hello"
            if kind == "bytes":
                return b"\x01\x02"
            if kind == "boom":
                raise ValueError("kaboom")
            if kind == "sleep":
                time.sleep(0.6)
            return {"method": request.method, "path": request.path,
                    "q": request.query, "payload": request.json()}

    p.serve.run(Echo.bind(), route_prefix="/echo")
    base = p.serve.http_address()
    body = json.dumps({"x": [1, 2]}).encode()
    out = [
        _http(f"{base}/echo/sub?a=1&kind=json", data=body, method="POST"),
        _http(f"{base}/echo?kind=text"),
        _http(f"{base}/echo?kind=bytes"),
        _http(f"{base}/echo?kind=boom"),
        _http(f"{base}/-/routes"),
        _http(f"{base}/nope"),
        _http(f"{base}/echo", headers={"X-Request-Deadline": "soon"}),
        _http(f"{base}/echo", headers={"X-Request-Deadline": "0"})[:2],
    ]
    status, ctype, err, _ = _http(f"{base}/echo?kind=sleep",
                                  headers={"X-Request-Deadline": "0.3"})
    out.append((status, ctype, err["error"]))
    out.append(_raw(base, b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                          b"Content-Length: 999999999999\r\n\r\n"))
    out.append(_raw(base, b"POST /echo HTTP/1.1\r\nHost: x\r\n"
                          b"Content-Length: abc\r\n\r\n"))
    return out


def ingress_sheds(p):
    """One slot, a queue of one: the third concurrent request answers
    503 with Retry-After, and the two accepted ones are served."""
    @p.serve.deployment(num_replicas=1, max_ongoing_requests=1,
                        max_queued_requests=1)
    class Busy:
        def __call__(self, request):
            time.sleep(0.4)
            return "served"

    p.serve.run(Busy.bind(), route_prefix="/busy")
    base = p.serve.http_address()
    results = {}

    def hit(i):
        results[i] = _http(f"{base}/busy")

    threads = []
    for i, field in enumerate(("inflight", "queued")):
        t = threading.Thread(target=hit, args=(i,), daemon=True)
        t.start()
        threads.append(t)
        deadline = time.monotonic() + 10
        while _plane(p).get(field, 0) < 1:
            assert time.monotonic() < deadline, field
            time.sleep(0.01)
    shed = _http(f"{base}/busy")
    for t in threads:
        t.join(30)
    return [results[0], results[1], shed], _plane(p)["shed"]


SCENARIOS = [backpressure_bound, promises_resolve, deadlines, ingress,
             ingress_sheds]


@pytest.fixture(scope="module")
def runs():
    return _drive(SCENARIOS, resources={"CPU": 8, "memory": 8},
                  num_workers=2)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_same_as_reference(runs, scenario):
    want = runs["ray_tpu"][scenario.__name__]
    got = runs["ray_tpu_torch"][scenario.__name__]
    if isinstance(want, Exception):
        raise want
    if isinstance(got, Exception):
        raise got
    assert got == want


def test_the_scenarios_exercise_each_code(runs):
    got = runs["ray_tpu_torch"]
    assert got["backpressure_bound"][0] == 3         # 1 running + 2 queued
    assert "queue is full" in got["backpressure_bound"][1]
    codes = [r[0] if isinstance(r, tuple) else r for r in got["ingress"]]
    assert codes == [200, 200, 200, 500, 200, 404, 400, 504, 504, 413, 400]
    (first, second, shed), n_shed = got["ingress_sheds"]
    assert (first[0], second[0], shed[0]) == (200, 200, 503)
    assert float(shed[3]) > 0 and shed[2]["error"] == "BackPressure"
    assert n_shed == 1
