"""The port's workflows against the JAX package's: a DAG in dependency
order, a shared step that runs once, a failed run resumed from its
stored steps, and the status of an unknown workflow.

Scenario sources: ``tests/test_workflow.py``.  Each scenario runs once
through each package's runtime (the port with ``scheduler_device=
"cpu"``), one after the other, with storage of its own; the port must
return exactly what the reference returns: outputs, statuses, the
workflow listing, how often each step ran and the errors.
"""

import importlib

import pytest

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def dag_in_dependency_order(wf, d):
    storage = str(d / "wf")

    @wf.step
    def load():
        return [1, 2, 3]

    @wf.step
    def double(xs):
        return [x * 2 for x in xs]

    @wf.step
    def total(xs, extra):
        return sum(xs) + extra

    out = wf.run(total.bind(double.bind(load.bind()), 100),
                 workflow_id="w1", storage=storage)
    return (out, wf.get_status("w1", storage=storage),
            wf.get_output("w1", storage=storage),
            [(m["workflow_id"], m["status"])
             for m in wf.list_all(storage=storage)])


def shared_step_runs_once(wf, d):
    marker = d / "count.txt"

    @wf.step
    def base():
        with open(marker, "a") as f:
            f.write("x")
        return 10

    @wf.step
    def left(b):
        return b + 1

    @wf.step
    def right(b):
        return b + 2

    @wf.step
    def join(a, b):
        return a * b

    shared = base.bind()
    out = wf.run(join.bind(left.bind(shared), right.bind(shared)),
                 workflow_id="w2", storage=str(d / "wf"))
    return out, marker.read_text()


def resume_skips_completed_steps(wf, d):
    storage, ran = str(d / "wf"), d / "ran.txt"

    @wf.step
    def first():
        with open(ran, "a") as f:
            f.write("first\n")
        return 5

    @wf.step
    def flaky(x):
        with open(ran, "a") as f:
            f.write("flaky\n")
        if not (d / "healed").exists():
            raise RuntimeError("transient failure")
        return x * 10

    dag = flaky.bind(first.bind())
    try:
        wf.run(dag, workflow_id="w3", storage=storage)
        failed = None
    except Exception as e:      # noqa: BLE001 — compared
        failed = "transient failure" in str(e)
    status = wf.get_status("w3", storage=storage)
    (d / "healed").write_text("1")
    out = wf.resume(dag, workflow_id="w3", storage=storage)
    return (failed, status, out, wf.get_status("w3", storage=storage),
            ran.read_text().splitlines())


def unknown_workflow(wf, d):
    storage = str(d / "wf")
    try:
        wf.get_output("nope", storage=storage)
        err = None
    except ValueError as e:
        err = str(e)
    return wf.get_status("nope", storage=storage), err


SCENARIOS = [dag_in_dependency_order, shared_step_runs_once,
             resume_skips_completed_steps, unknown_workflow]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name in PKGS:
        rt = importlib.import_module(name)
        wf = importlib.import_module(f"{name}.workflow")
        port = name == "ray_tpu_torch"
        rt.init(resources={"CPU": 4, "memory": 4}, num_workers=2,
                system_config={"scheduler_device": "cpu"} if port else None)
        res = out[name] = {}
        try:
            for sc in SCENARIOS:
                d = tmp_path_factory.mktemp(f"{name}-{sc.__name__}")
                try:
                    res[sc.__name__] = sc(wf, d)
                except Exception as e:      # noqa: BLE001 — compared
                    res[sc.__name__] = e
        finally:
            rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda s: s.__name__)
def test_same_as_reference(runs, scenario):
    want = runs["ray_tpu"][scenario.__name__]
    got = runs["ray_tpu_torch"][scenario.__name__]
    if isinstance(want, Exception):
        raise want
    if isinstance(got, Exception):
        raise got
    assert got == want


def test_what_the_runs_show(runs):
    got = runs["ray_tpu_torch"]
    assert got["dag_in_dependency_order"] == (
        112, "SUCCEEDED", 112, [("w1", "SUCCEEDED")])
    assert got["shared_step_runs_once"] == (132, "x")
    failed, status, out, after, lines = got["resume_skips_completed_steps"]
    assert (failed, status, out, after) == (True, "FAILED", 50, "SUCCEEDED")
    assert lines.count("first") == 1 and lines.count("flaky") == 2
    assert got["unknown_workflow"][0] == "NOT_FOUND"


def test_default_storage_is_apart_from_the_reference():
    from ray_tpu.workflow import execution as ref
    from ray_tpu_torch.workflow import execution as port
    assert port._DEFAULT_STORAGE != ref._DEFAULT_STORAGE
