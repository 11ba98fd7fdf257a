"""The port's model-version plane against the JAX package's: the
KV-journaled registry, and live rollouts that seal, roll back on a
failed probe, and stop when an operator aborts.

Scenario sources: ``tests/test_versioning.py``.  Each scenario runs once
through each package's runtime (the port with ``scheduler_device=
"cpu"``), one after the other; the port must return exactly what the
reference returns: the rollout summaries, the phase sequences and the
journal records (wall-clock stamps taken out), the responses before and
after, the controller's version counts, the head's version lines and the
``/metrics`` gauges of the version plane.
"""

import importlib

import pytest

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")
_STAMPS = ("t", "t_start", "t_phase")


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
        self.versioning = importlib.import_module(f"{name}.versioning")
        self.phases = importlib.import_module(f"{name}.versioning.phases")
        self.head = importlib.import_module(f"{name}.runtime.head")
        self.metrics = importlib.import_module(f"{name}.runtime.metrics")
        self.api = importlib.import_module(f"{name}.api")


def _unstamped(rec):
    """A journal record without its wall-clock stamps."""
    if isinstance(rec, dict):
        return {k: _unstamped(v) for k, v in rec.items()
                if k not in _STAMPS}
    if isinstance(rec, list):
        if len(rec) == 2 and isinstance(rec[0], str) and \
                isinstance(rec[1], float):
            return rec[0]                   # a [phase, t] transition
        return [_unstamped(v) for v in rec]
    return rec


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
                    p.serve.delete()
        finally:
            p.rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


# -- scenarios -------------------------------------------------------------------

def registry_journal(p):
    """The registry's state machine, as ``TestRegistry`` drives it."""
    ph, reg = p.phases, p.versioning.VersionRegistry()
    out = [reg.ensure("depA"), reg.ensure("depA")]
    reg.stage("depB", "weights-2")
    reg.set_phase("depB", ph.BROADCASTING)
    reg.set_phase("depB", ph.FLIPPING, replicas=3)
    reg.set_phase("depB", ph.FLIPPING, flipped=2)
    out += [reg.seal("depB"), reg.current("depB")]
    errors = []
    reg.stage("depC", "w2")
    for bad in (lambda: reg.set_phase("depC", ph.SEALED),
                lambda: reg.stage("depC", "w3"),
                lambda: reg.set_control("depC", "bogus")):
        try:
            bad()
        except (RuntimeError, ValueError) as e:
            errors.append((type(e).__name__, str(e)))
    reg.set_phase("depC", ph.BROADCASTING)
    reg.set_phase("depC", ph.FLIPPING)
    reg.set_phase("depC", ph.PAUSED)
    reg.set_phase("depC", ph.FLIPPING)
    out.append(reg.rollback("depC", "probe failed"))
    out.append(reg.stage("depC", "w3"))
    for i in (2, 3, 4):
        reg.stage("depF", f"w{i}")
        reg.set_phase("depF", ph.BROADCASTING)
        reg.set_phase("depF", ph.FLIPPING)
        out.append(reg.seal("depF"))
    reg.set_control("depG", "pause")
    controls = [reg.control("depG")]
    reg.stage("depG", "w2")
    controls.append(reg.control("depG"))
    return _unstamped(out), errors, controls, sorted(reg.all())


def _model(p, name, num_replicas):
    @p.serve.deployment(name=name, num_replicas=num_replicas)
    class Model:
        def __init__(self):
            self.weights = "initial"

        def __call__(self, x):
            return self.weights, x

        def reload(self, artifact):
            blob = bytes(artifact)
            if blob == b"poison":
                raise ValueError("bad weights")
            self.weights = blob.decode()

    return p.serve.run(Model.bind())


def _summary(s):
    return {k: v for k, v in s.items()
            if k not in ("seconds", "max_flip_downtime_s")}


def rollout_seals(p):
    """v1 -> v2 over three replicas, then what every surface reads."""
    handle = _model(p, "Sealed", 3)
    before = {p.rt.get(handle.remote(i), timeout=60)[0] for i in range(3)}
    summary = p.versioning.rollout(b"weights-2", artifact_label="w2")
    after = {p.rt.get(handle.remote(i), timeout=60)[0] for i in range(6)}
    dep = summary["deployment"]
    ctl = p.serve.get_deployment_handle()._controller
    counts = p.rt.get(ctl.version_counts.remote(), timeout=30)
    text = p.metrics.render_metrics(p.api._get_runtime().cluster)
    gauges = sorted(line for line in text.splitlines()
                    if f'deployment="{dep}"' in line and
                    ("model_version" in line or "rollout_phase" in line))
    return (before, _summary(summary), after, counts,
            _unstamped(p.versioning.rollout_status(dep)),
            p.head.HeadNode._version_stats()[dep], gauges)


def rollout_rolls_back_on_a_failed_probe(p):
    handle = _model(p, "Probed", 2)
    ok = p.versioning.rollout(b"good-weights", artifact_label="g")
    bad = p.versioning.rollout(b"poison", artifact_label="p")
    out = {p.rt.get(handle.remote(i), timeout=60)[0] for i in range(4)}
    return (_summary(ok), _summary(bad), out,
            _unstamped(p.versioning.rollout_status(bad["deployment"])))


def rollout_aborted_by_the_operator(p):
    """The probe after the first flip aborts; the controller stops
    before the second flip and rolls the first back."""
    versioning = p.versioning
    handle = _model(p, "Aborted", 3)

    def probe(_replica_handle):
        versioning.abort_rollout("Aborted")
        return True

    summary = versioning.rollout(b"weights-2", artifact_label="w2",
                                 probe=probe)
    served = [p.rt.get(handle.remote(i), timeout=60)[1] for i in range(6)]
    # the replicas' version tags; which replica answers a call is not
    # fixed, and the flipped one keeps the new weights (with no retained
    # v1 artifact the rollback only re-tags it, in both packages)
    ctl = p.serve.get_deployment_handle()._controller
    return (_summary(summary), served,
            p.rt.get(ctl.version_counts.remote(), timeout=30),
            _unstamped(versioning.rollout_status("Aborted")),
            versioning.VersionRegistry().control("Aborted"))


SCENARIOS = [registry_journal, rollout_seals,
             rollout_rolls_back_on_a_failed_probe,
             rollout_aborted_by_the_operator]


@pytest.fixture(scope="module")
def runs():
    return _drive(SCENARIOS, resources={"CPU": 12, "memory": 8},
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


def test_phase_sequences(runs):
    got = runs["ray_tpu_torch"]
    sealed = got["rollout_seals"][4]["rollout"]
    assert sealed["transitions"] == ["STAGING", "BROADCASTING",
                                     "FLIPPING", "SEALED"]
    assert got["rollout_seals"][2] == {"weights-2"}
    aborted = got["rollout_aborted_by_the_operator"]
    assert aborted[0]["phase"] == "ROLLED_BACK"
    assert aborted[0]["error"] == "aborted by operator"
    assert aborted[0]["flipped"] == 1 and aborted[2] == {"v1": 3}
    assert aborted[3]["rollout"]["transitions"] == [
        "STAGING", "BROADCASTING", "FLIPPING", "ROLLED_BACK"]
