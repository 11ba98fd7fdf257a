"""The port's serve against the JAX package's: deployments, composition,
multiplexing, autoscaling from zero and ``serve.status()``.

Scenario sources: ``tests/test_serve.py``.  Every scenario runs once
through ``ray_tpu`` and once through ``ray_tpu_torch`` (placement on the
CPU, ``scheduler_device="cpu"``), each package in its own runtime, one
after the other (both packages' ``Config`` read ``RT_*`` variables and
the worker pool exports them, so the two never run at once).  What the
scenarios return is deterministic (responses, status keys, counts), and
the port must return exactly what the reference returns.
"""

import importlib
import os

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
    """One package's public modules, reached by name."""

    def __init__(self, name):
        self.name = name
        self.rt = importlib.import_module(name)
        self.serve = importlib.import_module(f"{name}.serve")
        self.deployment_mod = importlib.import_module(
            f"{name}.serve.deployment")


def _drive(scenarios, **init_kw):
    """Each scenario's result (or the exception it raised) under each
    package, keyed by package name then scenario name."""
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
                    for app in ("default", "composed", "mux"):
                        p.serve.delete(app)
        finally:
            p.rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


# -- scenarios (each takes a _Pkg, returns what both must agree on) ----------

def class_deployment(p):
    """A class with init args over two replicas: calls, a named method,
    load on both replicas, status keys, and status around a delete."""
    @p.serve.deployment(num_replicas=2)
    class Scaler:
        def __init__(self, factor):
            self.factor = factor

        def __call__(self, x):
            return x * self.factor, os.getpid()

        def describe(self):
            return f"factor={self.factor}"

    handle = p.serve.run(Scaler.bind(7))
    out = p.rt.get([handle.remote(i) for i in range(8)], timeout=60)
    described = p.rt.get(handle.options(method_name="describe").remote(),
                         timeout=60)
    st = p.serve.status()
    p.serve.delete()
    return ([o[0] for o in out], len({o[1] for o in out}), described,
            sorted(st), st["status"], st["num_replicas"],
            st["deployment"], sorted(st["request_plane"]),
            p.serve.status(), p.serve.status("absent"))


def composed_graph(p):
    """A function deployment bound into a class deployment's graph, a
    second app reached by handle, and lookups by app name."""
    rt = p.rt

    @p.serve.deployment
    def embed(x):
        return [x, x + 1]

    @p.serve.deployment
    class Model:
        def __init__(self, embed_handle, other):
            self.embed, self.other = embed_handle, other

        def __call__(self, x):
            return sum(rt.get(self.embed.remote(x), timeout=30)) + \
                rt.get(self.other.remote(x), timeout=30)

    @p.serve.deployment
    def negate(x):
        return -x

    other = p.serve.run(negate.bind(), name="composed")
    handle = p.serve.run(Model.bind(embed.bind(), other))
    running = p.deployment_mod._apps["default"]
    by_name = p.serve.get_deployment_handle("composed")
    try:
        p.serve.get_deployment_handle("absent")
        missing = "no error"
    except Exception as e:      # noqa: BLE001 — compared by type
        missing = type(e).__name__
    return (rt.get(handle.remote(10), timeout=60),
            len(running.child_controllers),
            rt.get(by_name.remote(5), timeout=60), missing)


def graph_cycle(p):
    @p.serve.deployment
    class A:
        def __call__(self, x):
            return x

    a = A.bind()
    a.args = (a,)
    try:
        p.serve.run(a)
    except ValueError as e:
        return "ValueError", str(e)
    return "no error"


def multiplexed_sticky(p):
    serve = p.serve

    @serve.deployment(num_replicas=2)
    class MuxModel:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            self.loads.append(model_id)
            return f"model:{model_id}"

        def __call__(self, x):
            mid = serve.get_multiplexed_model_id()
            return self.get_model(mid), mid, len(self.loads), id(self), x

    handle = serve.run(MuxModel.bind(), name="mux")
    h = handle.options(multiplexed_model_id="m-a")
    outs = [p.rt.get(h.remote(i), timeout=60) for i in range(6)]
    return [(o[0], o[1], o[2], o[4]) for o in outs], \
        len({o[3] for o in outs})


def scale_from_zero(p):
    @p.serve.deployment(autoscaling_config={
        "min_replicas": 0, "max_replicas": 2,
        "target_ongoing_requests": 2})
    class Cold:
        def __call__(self, x):
            return x + 1

    handle = p.serve.run(Cold.bind())
    before = p.serve.status()["num_replicas"]
    got = p.rt.get(handle.remote(41), timeout=60)
    return before, got, p.serve.status()["num_replicas"] >= 1


SCENARIOS = [class_deployment, composed_graph, graph_cycle,
             multiplexed_sticky, scale_from_zero]


@pytest.fixture(scope="module")
def runs():
    return _drive(SCENARIOS, resources={"CPU": 12, "memory": 8},
                  num_workers=4)


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_same_as_reference(runs, scenario):
    want = runs["ray_tpu"][scenario.__name__]
    got = runs["ray_tpu_torch"][scenario.__name__]
    if isinstance(want, Exception):
        raise want
    if isinstance(got, Exception):
        raise got
    assert got == want


@pytest.mark.parametrize("module", [
    "serve", "serve.batching", "serve.router", "serve.http_proxy",
    "serve.deployment", "versioning", "versioning.registry",
    "versioning.rollout", "versioning.phases", "workflow",
    "workflow.execution", "util.queue", "util.metrics", "runtime.metrics",
    "runtime.dashboard", "common.lockorder"])
def test_public_names_match_the_reference(module):
    ref = importlib.import_module(f"ray_tpu.{module}")
    port = importlib.import_module(f"ray_tpu_torch.{module}")

    def public(m):
        names = getattr(m, "__all__", None)
        if names is None:
            names = [n for n, v in vars(m).items()
                     if not n.startswith("_") and
                     getattr(v, "__module__", None) == m.__name__]
        return set(names)

    assert public(ref) <= public(port)
    for name in public(ref):
        value = getattr(port, name)
        if hasattr(value, "__module__") and callable(value):
            assert value.__module__.startswith("ray_tpu_torch"), name
