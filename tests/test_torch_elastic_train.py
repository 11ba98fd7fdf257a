"""The port's elastic trainer against the JAX package's.

Scenario sources: ``tests/test_elastic_train.py``.  Each scenario runs
once through each package's runtime (the port with
``scheduler_device="cpu"``), one after the other, with
``train_collective_timeout_s`` at 4 s as the reference test sets it, and
must show the same results: the journal and checkpoint retired on
completion, a run inherited by name, a member SIGKILLed mid-allreduce
re-formed without burning ``max_failures`` (``chaos``), and a sole-copy
checkpoint replicated off its writer.  Then the wiring: a run in
progress shows its gauges on ``/metrics`` and in the head's
``status["train"]`` as the reference's modules produce them.
"""

from __future__ import annotations

import importlib
import os
import signal
import threading
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from ray_tpu.common.config import Config as RefConfig
from ray_tpu_torch.common.config import Config as PortConfig

PKGS = ("ray_tpu", "ray_tpu_torch")
KNOBS = {"train_collective_timeout_s": 4.0}


@pytest.fixture(autouse=True)
def _fresh_port_config():
    PortConfig.reset()
    yield
    PortConfig.reset()


def _epoch_loop(pkg, last_epoch, sleep_s=0.0):
    """A closure (shipped by value: a worker never imports this file)."""
    def loop(config):
        rtrain = importlib.import_module(f"{pkg}.train")
        ctx = rtrain.get_context()
        ck = rtrain.get_checkpoint()
        start = ck.to_dict()["epoch"] + 1 if ck is not None else 0
        for epoch in range(start, last_epoch + 1):
            ctx.allreduce({"g": np.ones(8)})
            if sleep_s:
                time.sleep(sleep_s)
            rtrain.report({"epoch": epoch, "resumed_from": start},
                          checkpoint=rtrain.Checkpoint({"epoch": epoch}))
    return loop


def _package(name):
    return SimpleNamespace(
        pkg=name, rt=importlib.import_module(name),
        api=importlib.import_module(f"{name}.api"),
        train=importlib.import_module(f"{name}.train"),
        elastic=importlib.import_module(f"{name}.train.elastic"),
        kv=importlib.import_module(f"{name}.experimental.internal_kv"),
        ser=importlib.import_module(f"{name}.runtime.serialization"))


def _run_all(scenarios):
    """{package: {scenario: result or exception}}, each package in its
    own runtime, one after the other."""
    out = {}
    for name in PKGS:
        m = _package(name)
        port = name == "ray_tpu_torch"
        m.rt.init(resources={"CPU": 8, "memory": 8}, num_workers=4,
                  system_config={**KNOBS, "scheduler_device": "cpu"}
                  if port else dict(KNOBS))
        res = out[name] = {}
        try:
            for sc in scenarios:
                try:
                    res[sc.__name__] = sc(m)
                except Exception as e:      # noqa: BLE001 — compared
                    res[sc.__name__] = e
        finally:
            m.rt.shutdown()
            (PortConfig if port else RefConfig).reset()
    return out


def _both(runs, scenario):
    want, got = runs["ray_tpu"][scenario], runs["ray_tpu_torch"][scenario]
    for v in (want, got):
        if isinstance(v, Exception):
            raise v
    return want, got


# -- scenarios ----------------------------------------------------------------

def completion_retires_journal_and_checkpoint(m):
    t = m.train.ElasticTrainer(
        _epoch_loop(m.pkg, 2),
        scaling_config=m.train.ScalingConfig(num_workers=2),
        run_name="retire-on-done")
    res = t.fit(timeout=120)
    st = t.stats()
    return (res.metrics["epoch"], st["state"], st["failures"],
            st["gang_losses"],
            m.kv._internal_kv_get("journal-retire-on-done",
                                  namespace="train"),
            m.kv._internal_kv_get("ckpt-retire-on-done",
                                  namespace="train"))


def same_run_name_inherits_journal_mid_run(m):
    m.elastic._journal_update("journal-inherit-me", epoch=1, step=2,
                              attempt=2)
    m.kv._internal_kv_put("ckpt-inherit-me", m.ser.serialize({"epoch": 1}),
                          namespace="train")
    t = m.train.ElasticTrainer(
        _epoch_loop(m.pkg, 3),
        scaling_config=m.train.ScalingConfig(num_workers=2),
        run_name="inherit-me")
    res = t.fit(timeout=120)
    return (res.metrics["epoch"], res.metrics["resumed_from"],
            res.history[0]["epoch"])


def sole_copy_replicated_off_writer_survives_node_death(m):
    sched = importlib.import_module(f"{m.pkg}.util.scheduling_strategies")
    cluster = m.api._get_runtime().cluster
    nid = cluster.add_node(resources={"CPU": 2, "memory": 2},
                           num_workers=1)
    row = cluster.crm.row_of(nid)
    try:
        make = m.rt.remote(lambda: {"w": bytes(250_000), "epoch": 7})
        ref = make.options(
            max_retries=0,
            scheduling_strategy=sched.NodeAffinitySchedulingStrategy(
                nid, soft=False)).remote()
        m.rt.wait([ref], num_returns=1, timeout=30)
        sole = cluster.directory.locations(ref.id) == (row,)
        t = m.train.ElasticTrainer(lambda config: None)
        t._replicate_off_writer(cluster, ref.id)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and \
                len(cluster.directory.locations(ref.id)) < 2:
            time.sleep(0.1)
        copies = len(cluster.directory.locations(ref.id)) >= 2
        cluster.remove_node(nid)
        out = m.rt.get(ref, timeout=60)
        return (sole, t._stats["ckpt_replications"], copies, out["epoch"],
                out["w"] == bytes(250_000))
    finally:
        if cluster.crm.row_of(nid) is not None:
            cluster.remove_node(nid)


def sigkill_mid_allreduce_reforms_without_failure_burn(m):
    killed = threading.Event()

    def killer():
        pool = m.api._get_runtime().raylet.pool
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with pool._lock:
                busy = [h for h in pool._workers
                        if not h.dead and h.dedicated]
            if len(busy) >= 2:
                time.sleep(1.0)     # let the gang get into an epoch
                try:
                    os.kill(busy[0].proc.pid, signal.SIGKILL)
                    killed.set()
                except OSError:     # won the race with completion
                    pass
                return
            time.sleep(0.1)

    th = threading.Thread(target=killer, daemon=True)
    th.start()
    t = m.train.ElasticTrainer(
        _epoch_loop(m.pkg, 3, sleep_s=0.5),
        scaling_config=m.train.ScalingConfig(num_workers=2, min_workers=1),
        failure_config=m.train.FailureConfig(max_failures=0),
        run_name="sigkill-reform")
    res = t.fit(timeout=120)
    th.join(timeout=30)
    st = t.stats()
    epochs = [r["epoch"] for r in res.history]
    # which error reaches the driver first (the survivor's typed
    # GangMemberLost or the dead rank's ActorDiedError) is a race, so
    # the count of losses is >= 1 in both packages, not equal
    return (killed.is_set(), res.metrics["epoch"], st["gang_losses"] >= 1,
            st["failures"], all(r["resumed_from"] >= 0
                                for r in res.history),
            epochs == sorted(epochs))


@pytest.fixture(scope="module")
def runs():
    return _run_all([completion_retires_journal_and_checkpoint,
                     same_run_name_inherits_journal_mid_run,
                     sole_copy_replicated_off_writer_survives_node_death])


@pytest.mark.parametrize("scenario", [
    "completion_retires_journal_and_checkpoint",
    "same_run_name_inherits_journal_mid_run",
    "sole_copy_replicated_off_writer_survives_node_death"])
def test_same_as_reference(runs, scenario):
    want, got = _both(runs, scenario)
    assert got == want


def test_what_the_runs_show(runs):
    got = runs["ray_tpu_torch"]
    assert got["completion_retires_journal_and_checkpoint"] == \
        (2, "complete", 0, 0, None, None)
    # started from the inherited checkpoint (epoch 1), not scratch
    assert got["same_run_name_inherits_journal_mid_run"] == (3, 2, 2)
    assert got["sole_copy_replicated_off_writer_survives_node_death"] == \
        (True, 1, True, 7, True)


@pytest.mark.chaos
def test_sigkill_mid_allreduce_reforms_without_failure_burn():
    out = _run_all([sigkill_mid_allreduce_reforms_without_failure_burn])
    want, got = _both(
        out, "sigkill_mid_allreduce_reforms_without_failure_burn")
    assert got == want
    # the kill landed, the run finished at epoch 3, the loss surfaced as
    # a gang event, max_failures=0 held, acked epochs are monotone
    assert got == (True, 3, True, 0, True, True)


# -- the wiring: /metrics and the head's status carry a live run --------------

def _live_gauges(m):
    """Start an elastic run, and while it is in progress scrape the
    exporter's ``train_*`` lines and the head's ``status["train"]``."""
    metrics = importlib.import_module(f"{m.pkg}.runtime.metrics")
    head = importlib.import_module(f"{m.pkg}.runtime.head")
    cluster = m.api._get_runtime().cluster
    exporter = metrics.MetricsExporter(cluster, 0)
    t = m.train.ElasticTrainer(
        _epoch_loop(m.pkg, 3, sleep_s=0.4),
        scaling_config=m.train.ScalingConfig(num_workers=2),
        run_name="wired")
    done = {}
    th = threading.Thread(
        target=lambda: done.update(res=t.fit(timeout=120)), daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 60
        lines, status, run = [], {}, {}
        while time.monotonic() < deadline and th.is_alive():
            status = head.HeadNode._train_stats(cluster)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{exporter.port}/metrics",
                    timeout=30) as r:
                text = r.read().decode()
            # this run's lines and entry (an earlier test's trainer may
            # still be alive and listed beside it)
            lines = [ln for ln in text.splitlines()
                     if ln.startswith("ray_tpu_train_")
                     and 'run="wired"' in ln]
            run = next((r for r in status.get("runs", [])
                        if r.get("run") == "wired"), {})
            if run.get("epoch") is not None and any(
                    ln.startswith("ray_tpu_train_epoch{") for ln in lines):
                break
            time.sleep(0.1)
        in_progress = th.is_alive()
    finally:
        th.join(timeout=120)
        exporter.shutdown()
    return {"in_progress": in_progress,
            "names": sorted(ln.split("{")[0] for ln in lines),
            "labels": sorted({ln.split("{")[1].split("}")[0]
                              for ln in lines}),
            "run_keys": sorted(run), "run": run.get("run"),
            "state": run.get("state"),
            "finished": done["res"].metrics["epoch"]}


def test_a_live_run_shows_on_metrics_and_in_the_head_status():
    out = _run_all([_live_gauges])
    want, got = _both(out, "_live_gauges")
    assert got["in_progress"] and got["finished"] == 3
    assert got["run"] == "wired" and got["state"] == "running"
    assert "ray_tpu_train_epoch" in got["names"]
    assert got["labels"] == ['run="wired"']
    assert (got["names"], got["labels"], got["run_keys"]) == \
        (want["names"], want["labels"], want["run_keys"])
